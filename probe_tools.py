"""What the kernel probes share (``gl_kernel_probe.py``,
``frontend_kernel_probe.py``): edited copies of a CUDA source made by text
anchors, built with the package's nvcc flags into ``build/kernels/``, a
reader of the clock64 stamps such a copy records, and the card's name and
power limit.  The package's own build is untouched.
"""

import concurrent.futures
import ctypes
import subprocess


def swap(text: str, old: str, new: str) -> str:
    """``text`` with ``old`` replaced by ``new``; raises unless ``old`` is
    found exactly once (the anchor moved with an edit of the source)."""
    if text.count(old) != 1:
        raise ValueError(f"anchor not found once in the source: {old[:70]!r}")
    return text.replace(old, new)


def reader(symbol: str, fn: str) -> str:
    """C source of ``extern "C" int fn(void* out)``: copies the device array
    ``symbol`` (the stamps) to host memory ``out``; returns the CUDA error."""
    return (f'\nextern "C" int {fn}(void* out) {{\n'
            f"  return (int)cudaMemcpyFromSymbol(out, {symbol}, sizeof({symbol}));\n}}\n")


def build(name: str, files: dict) -> ctypes.CDLL:
    """Write ``files`` (file name -> text; the first is compiled, the others
    are headers it includes) into ``build/kernels/probe_<name>/``, compile
    with the package's flags and load the library."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build

    d = _build.BUILD_DIR / f"probe_{name.replace(' ', '_')}"
    d.mkdir(parents=True, exist_ok=True)
    for fname, text in files.items():
        (d / fname).write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                           str(d / next(iter(files)))], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the probe's {name!r} copy:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(d / "lib.so"))


def build_all(builds: dict) -> dict:
    """name -> library for name -> files, one nvcc each, all at once."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(builds))) as pool:
        done = {name: pool.submit(build, name, files) for name, files in builds.items()}
        return {name: f.result() for name, f in done.items()}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
