"""The system under test, as the drivers build it: the PyTorch and CUDA port.

Only this module and the traffic drivers import the port
(``closed_loop_seeg_speech_synthesis_tpu_torch``); nothing here imports
JAX or the JAX package.  The decoder is built from a configuration file's
settings and the seed's weights, through ``pipeline.build_decoder_params``
as the decode CLI builds it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import time

import torch

from . import inputs


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(run, name: str):
    """Host seconds of a set-up step, the device synchronized, into ``run.timings``."""
    sync(run.device)
    t0 = time.perf_counter()
    yield
    sync(run.device)
    run.timings[name] = time.perf_counter() - t0


def load_kernels(run, sources) -> None:
    """Build (on a checkout's first run) and load the port's CUDA sources,
    one nvcc a source at once; the libraries land in the checkout's
    ``build/kernels/``."""
    if run.device.type != "cuda":
        return
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load, sources))


def decoder(run):
    """(DecoderConfig, DecoderParams) of the run's configuration, weights
    drawn into ``run.weights``; the host build's seconds into ``run.timings``."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline

    c = run.cfg
    run.weights = w = inputs.weights(c, run.seed, run.device)
    loaded = params.from_arrays(w["coef"], w["intercept"], w["classes"], w["valid"],
                                w["medians"], w["select"], [], dtype=run.dtype, device=run.device)
    pcfg = pipeline.DecoderConfig(
        sr=float(c["sr"]), n_channels=int(c["n_channels"]), packet_size=int(c["packet_size"]),
        line_noise=int(c["line_noise"]), frame_len_ms=float(c["frame_len_ms"]),
        frame_shift_ms=float(c["frame_shift_ms"]), model_order=int(c["model_order"]),
        step_size=int(c["step_size"]), n_mel=int(c["n_mel"]),
        gl_iterations=int(c["gl_iterations"]), gl_norm=float(c["gl_norm"]),
        phase_bug=bool(c["phase_bug"]), audio_sr=int(c["audio_sr"]), dtype=run.dtype,
        gl_bf16=bool(c["gl_bf16"]))
    sync(run.device)
    t0 = time.perf_counter()
    dec = pipeline.build_decoder_params(pcfg, loaded["lda"], loaded["medians"], loaded["select"],
                                        device=run.device)
    sync(run.device)
    run.timings["build_params_s"] = time.perf_counter() - t0
    return pcfg, dec
