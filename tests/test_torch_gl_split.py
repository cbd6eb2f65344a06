"""The Griffin-Lim kernels' DFT operands (K2/K4), the choice of regime, the
TF32 rounding helpers (``ops/tf32.py``, K1's), and the ctypes bindings of
the kernels' C entries against the entries' parameters in their ``.cu``
files.  Also the text anchors by
which gl_kernel_probe.py builds its variants of the kernel source (the bf16
wgmma kernel with a fresh accumulator every 4 k-steps or libdevice's atan2f,
the clock64 stamps).  The large-B float32 kernel's FFT plan is held in
tests/test_torch_gl_fft.py.
"""

import ast
import ctypes
import importlib.util
import inspect
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_frontend, cuda_gl, cuda_prng
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import tf32


@pytest.fixture(scope="module")
def ops():
    return cuda_gl.make_gl_audio_ops(t_gl.make_streaming_gl_ops(40, 16000.0, torch.float64),
                                     t_iir.sos_to_statespace(t_fd.gl_output_lowpass_sos()),
                                     torch.float64)


def test_dft_operands_are_not_symmetric_in_f32(ops):
    """Why the cluster kernel and the plain version take all 256 rows of the
    forward operand: make_rdft's f32 cos and sin columns are not
    (anti)symmetric in n -> 256 - n (the f64 angles round differently before
    the cos), so folding x[n] + x[256 - n] would change the result on
    hundreds of elements.  The large-B float32 kernel no longer takes these
    bytes: its FFT's twiddles are the exact angles rounded once, as the
    benchmark's float64 reference's are (tests/test_torch_gl_fft.py)."""
    fm = ops.gl_f32[1].numpy()
    n = np.arange(1, 256)
    cos, sin = fm[:, :128], fm[:, 128:]
    assert (cos[n] != cos[256 - n]).sum() > 100 and (sin[n] != -sin[256 - n]).sum() > 100
    np.testing.assert_allclose(cos[n], cos[256 - n], atol=1e-6)


def test_tf32_round_is_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, -(1.0 + 2.0**-11),
                  1.0 + 2.0**-12, 0.0], np.float32)
    expected = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 0.0],
                        np.float32)
    np.testing.assert_array_equal(tf32.tf32_round(torch.as_tensor(x)).numpy(), expected)
    hi, lo = (p.numpy() for p in tf32.tf32_split(torch.as_tensor(x)))
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x.astype(np.float64))


@pytest.mark.parametrize("B,expected", [(1, "cluster"), (4, "cluster"), (8, "cluster"),
                                        (cuda_gl.CLUSTER_MAX_B, "cluster"),
                                        (cuda_gl.CLUSTER_MAX_B + 1, "fft"), (180_000, "fft")])
def test_regime_by_number_of_blocks(B, expected):
    """The online step's 1-4 blocks, and up to 8, stay in the cluster regime."""
    assert cuda_gl.CLUSTER_MAX_B >= 8
    assert cuda_gl.regime(B) == expected


def test_regime_threshold_is_read_at_each_call(monkeypatch):
    """CLUSTER_MAX_B forces a float32 regime; bf16 launches run the wgmma
    kernel whatever it is."""
    monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B", 0)
    assert cuda_gl.regime(1) == "fft"
    monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B", 10**9)
    assert cuda_gl.regime(180_000) == "cluster"
    assert cuda_gl.regime(1, bf16=True) == cuda_gl.regime(180_000, bf16=True) == "wgmma"


# The C type of each parameter of an extern "C" entry, as ctypes declares it
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
           "uint32_t": ctypes.c_uint32, "cudaStream_t": ctypes.c_void_p}


def _c_entries(src):
    """name -> ctypes types of the parameters of each extern "C" entry."""
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append(ctypes.c_void_p if "*" in p
                         else C_TYPES[p.rsplit(" ", 1)[0].removeprefix("const ")])
        entries[name] = kinds
    return entries


# entry -> the module that binds it, the source that defines it
ENTRIES = {"gl_blocks": (cuda_gl, "gl_audio.cu"), "gl_audio": (cuda_gl, "gl_audio.cu"),
           "frontend_logpower": (cuda_frontend, "frontend_decode.cu"),
           "frontend_decode_mels": (cuda_frontend, "frontend_decode.cu"),
           "block_inits": (cuda_prng, "prng.cu")}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_kernel_bindings_match_the_c_entries(monkeypatch, entry):
    """The argument types each wrapper declares for its C entry (the counts
    of pointers, ints and floats it hands ``_build.bind``, or cuda_prng's own
    ``argtypes``) are the entry's parameters in its .cu file, in order, and
    every extern "C" entry of that file is bound by the module: a launch
    through a stale binding would pass its arguments to the wrong
    parameters, which no CPU run would show."""
    module, source = ENTRIES[entry]
    entries = _c_entries((_build.CSRC / source).read_text())
    fake = types.SimpleNamespace(**{entry: types.SimpleNamespace()})
    if module is cuda_prng:
        monkeypatch.setattr(_build, "load", lambda name: fake)
        fn = cuda_prng._entry.__wrapped__()
        bound = {"block_inits"}
    else:
        calls = {node.args[1].value: node for node in ast.walk(ast.parse(inspect.getsource(module)))
                 if isinstance(node, ast.Call) and ast.unparse(node.func) == "_build.bind"}
        bound = set(calls)
        fn = _build.bind(fake, entry, *(a.value for a in calls[entry].args[2:]))
    assert bound == set(entries)
    assert fn.argtypes == entries[entry] and fn.restype is ctypes.c_int


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("gl_kernel_probe", ROOT / "gl_kernel_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_grouped_variant_matches_the_source(probe):
    """The variant differs from csrc/gl_audio.cu only in the wgmma kernel's
    products: a fresh accumulator every 4 k-steps, added in fp32."""
    src = (ROOT / probe.SRC).read_text()
    grouped = probe.variants(src)["grouped"]
    assert grouped != src and grouped.replace(probe.GROUPED[1], probe.GROUPED[0]) == src
    assert "wg::mma_rs<TRANS_B>(\n          part, a[s]," in grouped


def test_probe_atan2f_variant_matches_the_source(probe):
    """The variant differs from csrc/gl_audio.cu only in the wgmma kernel's
    exp(angle) phase step: libdevice's atan2f for the Cephes atan2."""
    src = (ROOT / probe.SRC).read_text()
    libdevice = probe.variants(src)["atan2f"]
    assert libdevice != src and libdevice.replace(probe.ATAN2F[1], probe.ATAN2F[0]) == src
    assert src.count("atan2_cephes(xi, xr)") == 1


@pytest.mark.parametrize("kernel", ["gl_fft_kernel", "gl_cluster_kernel", "gl_wgmma_kernel"])
def test_probe_stamps_every_phase_of_the_kernel(probe, kernel):
    """Each Griffin-Lim kernel of csrc/gl_audio.cu gets its launch stamp and
    one stamp after each of its phase anchors, inside its own body."""
    timed = probe.variants((ROOT / probe.SRC).read_text())["stamps"]
    start = timed.index(f" {kernel}(")
    body = timed[start : timed.index("\n}\n", start)]
    stamps = {"gl_fft_kernel": probe.FFT_STAMPS, "gl_cluster_kernel": probe.CLUSTER_STAMPS,
              "gl_wgmma_kernel": probe.WGMMA_STAMPS}[kernel]
    assert body.count("STAMP(127);") == 1
    for _, k in stamps:
        assert body.count(f"STAMP(8 * it + {k});") == 1
    assert 'extern "C" int probe_stamps_read(' in timed


def test_probe_refuses_a_source_without_its_anchors(probe):
    src = (ROOT / probe.SRC).read_text()
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.FFT_STAMPS[2][0], ""))
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.CLUSTER_STAMPS[0][0], "  {\n"))
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.GROUPED[0], ""))
