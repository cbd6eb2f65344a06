"""The benchmark imports neither JAX nor the JAX package, its reference
nothing of the program, and nothing reads the JAX package's benchmarks."""

import ast
import os

import pytest

from portbench import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "closed_loop_seeg_speech_synthesis_tpu"}
PORT = "closed_loop_seeg_speech_synthesis_tpu_torch"


def sources(sub=""):
    top = os.path.join(manifest.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module a file imports, wherever it imports it."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, manifest.HERE))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, manifest.HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert PORT not in names and "portbench" not in names or names <= {"torch", "numpy", "math",
                                                                       "fractions", "dataclasses",
                                                                       "__future__"}
    assert PORT not in open(path).read()


def test_nothing_reads_the_jax_benchmarks():
    for path in sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        text = open(path).read()
        for name in ("bench.py", "benchmarks/", "BENCH_r0", "MULTICHIP_r0", "BENCHMARKS.md"):
            assert name not in text, (path, name)


def test_loaded_modules_compared_by_whole_top_level_name():
    assert harness.forbidden_modules({PORT: 1, f"{PORT}.ops": 1, "numpy": 1}) == []
    assert harness.forbidden_modules({"jax.numpy": 1, "closed_loop_seeg_speech_synthesis_tpu.ops": 1}) == \
        ["closed_loop_seeg_speech_synthesis_tpu", "jax"]
