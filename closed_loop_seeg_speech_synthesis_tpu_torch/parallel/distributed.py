"""Several processes: data-parallel replay and multi-session training over
one process group, and dryruns that spawn the processes.

Port of ``closed_loop_seeg_speech_synthesis_tpu/parallel/distributed.py``.
The heaviest workloads of the reference (exp1's 10 folds x 100 chance runs,
exp2's chance decodes, sweeps over sessions) are embarrassingly parallel
over sessions.  Sessions split over the mesh's ``data`` axis, channels over
``model``; the decode moves no data between data ranks, training gathers
the features once (``sharded``).

One rank is one device.  The backend is always the caller's choice:
NCCL takes one rank per card (more ranks than cards raise), gloo any number
of ranks on any device, two ranks on one card included (its collectives
stage CUDA tensors through the host, ``mesh._host_staged``).

``dryrun_dcn`` / ``dryrun_dcn_train`` spawn N processes with ``subprocess``
(each runs ``_worker``: it imports only this package), connect them with a
``file://`` rendezvous in a private directory, and return what each rank
wrote.  The JAX dryruns' ``n_local_devices`` (virtual devices per process)
has no counterpart here.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

from ..ops import framing
from ..ops import griffinlim as gl
from ..runtime import pipeline
from . import mesh as mesh_lib
from . import sharded

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LDA_ARRAYS = ("lda_coef", "lda_intercept", "lda_classes", "lda_valid", "medians", "select")
WORKER_THREADS = 2  # torch threads a dryrun rank: several ranks share the host's cores


def _check_backend(backend: str, num_processes: int) -> None:
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl'; got {backend!r}")
    if backend == "nccl" and num_processes > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank per card: {num_processes} ranks, "
                         f"{torch.cuda.device_count()} card(s) visible; several ranks on one "
                         "card use backend='gloo'")


def initialize(init_method: str, num_processes: int, process_id: int, *, backend: str,
               timeout: float = 600.0) -> None:
    """Join this process to the process group as rank ``process_id`` of
    ``num_processes``.  ``init_method`` is ``tcp://host:port`` (rank 0
    listens there) or ``file:///path`` (a file that does not exist yet, on a
    file system every rank sees).  Where a card is visible the rank's
    current device becomes card ``process_id`` modulo the cards."""
    if not init_method.startswith(("tcp://", "file://")):
        raise ValueError(f"init_method must be tcp://host:port or file:///path; got "
                         f"{init_method!r}")
    _check_backend(backend, num_processes)
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                             rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def global_mesh(model_axis: int = 1):
    """The (data, model) mesh over every rank of the process group, data
    outermost: consecutive ranks share a data index and split its channels."""
    return mesh_lib.make_mesh(None, model_axis)


def _n_frames(cfg: pipeline.DecoderConfig, n_samples: int) -> int:
    return framing.frame_count(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr,
                               n_samples + cfg.prefill)


def distributed_replay(mesh, cfg: pipeline.DecoderConfig, params: pipeline.DecoderParams,
                       local_eeg, local_rand, timings: dict | None = None):
    """Offline decode of this rank's sessions, ``local_eeg`` (B_local, T, C)
    with their Griffin-Lim inits ``local_rand`` (B_local, N - 1, 480); the
    global batch is the data ranks' sessions in rank order.  Returns this
    rank's (spec (B_local, N, n_mel), audio (B_local, (N - 1) * 160)) as host
    numpy arrays.  ``timings`` receives the collectives' milliseconds."""
    n_frames = _n_frames(cfg, local_eeg.shape[1])
    replay = sharded.make_batched_replay(mesh, cfg, n_frames)
    spec, audio = replay(params, local_eeg, local_rand, timings)
    return spec.cpu().numpy(), audio.cpu().numpy()


def distributed_train(mesh, cfg: sharded.ShardedTrainConfig, local_eeg, local_audio,
                      device=None, timings: dict | None = None):
    """Fit one model from a multi-session batch, this rank holding
    ``local_eeg`` (B_local, T, C) and ``local_audio`` (B_local, Ta) at
    ``cfg.audio_sr``; the global batch is the data ranks' sessions in rank
    order (the reference trains on the concatenation of the recordings,
    train.py:284-311).  Returns (LDAParams of host tensors, select, medians
    as numpy), the same on every rank.  ``device``: default the card."""
    _, T, C = local_eeg.shape
    step = sharded.make_sharded_train_step(mesh, cfg, T, local_audio.shape[1], C, device)
    params, select, medians = step(local_eeg, local_audio, timings)
    return params.to(device="cpu"), select.cpu().numpy(), medians.cpu().numpy()


# --------------------------------------------------------------------------
# Dryruns: N processes on this host
# --------------------------------------------------------------------------


def replay_inputs(n_sessions: int) -> dict:
    """The replay dryrun's inputs from seed 0, at the JAX dryrun's size (8
    channels, 2,048 samples at 1024 Hz): a random model with 20 of the 40
    stacked features (the ``from_arrays`` arrays), sEEG (B, T, C) float32,
    the rate, and session i's Griffin-Lim inits, the float32 draws of
    ``PRNGKey(i)`` as the JAX dryrun draws them."""
    rng = np.random.RandomState(0)
    T, C, sr = 2048, 8, 1024.0
    arrays = dict(lda_coef=rng.randn(40, 9, 20) * 0.1, lda_intercept=rng.randn(40, 9),
                  lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                  lda_valid=np.ones((40, 9), bool), medians=np.sort(rng.randn(40, 9), axis=1),
                  select=rng.permutation(5 * C)[:20])
    arrays["eeg"] = rng.randn(n_sessions, T, C).astype(np.float32)
    arrays["sr"] = np.float64(sr)
    nf = _n_frames(pipeline.DecoderConfig(sr=sr, n_channels=C), T)
    arrays["rand"] = np.stack([gl.default_rand_init(nf - 1, 0, i, torch.float32).numpy()
                               for i in range(n_sessions)])
    return arrays


def train_inputs(n_sessions: int) -> dict:
    """The training dryrun's inputs from seed 7, at the JAX dryrun's size:
    sEEG (B, 2048, 8) at 1024 Hz and 16 kHz audio (B, 32000), float32."""
    rng = np.random.RandomState(7)
    return {"eeg": rng.randn(n_sessions, 2048, 8).astype(np.float32),
            "audio": (rng.randn(n_sessions, 32000) * 0.1).astype(np.float32)}


def write_inputs(path: str, **arrays) -> str:
    """Write a dryrun's inputs, one ``<name>.npy`` each, into the directory
    ``path``; every worker maps them and takes its own sessions."""
    os.makedirs(path, exist_ok=True)
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), np.asarray(a))
    return path


def _read_inputs(spec: dict) -> dict:
    if spec["inputs"] is None:
        make = replay_inputs if spec["kind"] == "replay" else train_inputs
        return make(spec["n_sessions"])
    return {f[:-4]: np.load(os.path.join(spec["inputs"], f), mmap_mode="r")
            for f in os.listdir(spec["inputs"]) if f.endswith(".npy")}


def _launch_counts() -> dict:
    from ..ops import cuda_frontend, cuda_gl

    return {fn.__name__: fn.launches for fn in (
        cuda_frontend.frontend_decode_mels, cuda_frontend.frontend_logpower,
        cuda_gl.gl_audio, cuda_gl.gl_blocks)}


def _worker(spec_json: str, pid: int) -> None:
    """One rank of a dryrun: join the group, take this rank's sessions of the
    inputs, run the replay or the training, write the result, the launch
    counts and the times to ``<out>_<pid>.npz``."""
    spec = json.loads(spec_json)
    torch.set_num_threads(WORKER_THREADS)
    initialize(spec["init_method"], spec["n_processes"], pid, backend=spec["backend"])
    dev = pipeline.resolve_device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dtype = pipeline.default_compute_dtype(dev)
    mesh = global_mesh(spec["model_axis"])
    inputs = _read_inputs(spec)
    B, T, C = inputs["eeg"].shape
    sessions, _ = mesh_lib.session_sharding(mesh, B, C)
    eeg = np.array(inputs["eeg"][sessions])
    timings = {"collectives": 0.0}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tdist.barrier()
    ready = time.time()
    before = _launch_counts()
    if spec["kind"] == "replay":
        from ..runtime import params as params_mod

        loaded = params_mod.from_arrays(*(np.array(inputs[k]) for k in LDA_ARRAYS), [],
                                        dtype, dev)
        cfg = pipeline.DecoderConfig(sr=float(inputs["sr"]), n_channels=C, dtype=dtype)
        dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                            loaded["select"], device=dev)
        spec_out, audio = distributed_replay(mesh, cfg, dec, eeg,
                                             np.array(inputs["rand"][sessions]), timings)
        out = {"spec": spec_out, "audio": audio}
    else:
        cfg = sharded.ShardedTrainConfig(dtype=dtype, **spec["config"])
        params, select, medians = distributed_train(
            mesh, cfg, eeg, np.array(inputs["audio"][sessions]), dev, timings)
        out = {"coef": params.coef.numpy(), "intercept": params.intercept.numpy(),
               "classes": params.classes.numpy(), "valid": params.valid.numpy(),
               "select": select, "medians": medians}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    done = time.time()
    after = _launch_counts()
    meta = {"rank": pid, "mesh": list(mesh.shape), "sessions": [sessions.start, sessions.stop],
            "launches": {k: after[k] - before[k] for k in after},
            "ready_s": ready - spec["spawned_at"], "compute_ms": (done - ready) * 1e3,
            "collectives_ms": timings["collectives"]}
    np.savez(f"{spec['out']}_{pid}.npz", meta=np.array(json.dumps(meta)), **out)
    tdist.destroy_process_group()


_WORKER = ("import sys; from closed_loop_seeg_speech_synthesis_tpu_torch.parallel.distributed "
           "import _worker; _worker(sys.argv[1], int(sys.argv[2]))")


def _spawn(kind: str, n_processes: int, backend: str, device, model_axis: int, inputs,
           config: dict | None, workdir, timeout: float):
    """Start the N ranks, wait for all of them (killing the rest as soon as
    one fails or the time runs out), and return (each rank's result dict,
    each rank's log)."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        spec = {"kind": kind, "backend": backend, "device": device, "model_axis": model_axis,
                "n_processes": n_processes, "config": config,
                "n_sessions": 2 * (n_processes // model_axis),  # seeded inputs: 2 a data rank
                "inputs": inputs and os.path.abspath(inputs),
                "init_method": "file://" + os.path.join(tmp, f"rendezvous-{uuid.uuid4().hex}"),
                "out": os.path.join(tmp, kind)}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
        logs = [os.path.join(tmp, f"{kind}_{pid}.log") for pid in range(n_processes)]
        procs = []
        try:
            spec["spawned_at"] = time.time()
            for pid in range(n_processes):
                with open(logs[pid], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _WORKER, json.dumps(spec), str(pid)],
                        env=env, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs) and all(p.returncode in (None, 0)
                                                               for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun {kind}: ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = [Path(path).read_text() for path in logs]
        for pid, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun {kind}: rank {pid} failed (exit {p.returncode}):\n"
                                   + texts[pid][-4000:])
        results = []
        for pid in range(n_processes):
            with np.load(f"{spec['out']}_{pid}.npz") as z:
                r = {k: z[k] for k in z.files if k != "meta"}
                r.update(json.loads(str(z["meta"])))
            results.append(r)
    return results, texts


def dryrun_dcn(n_processes: int = 2, *, backend: str, device=None, model_axis: int = 1,
               inputs: str | None = None, workdir: str | None = None, timeout: float = 600.0):
    """Spawn ``n_processes`` ranks on this host and run ``distributed_replay``
    over ``global_mesh(model_axis)``.  Inputs: the directory ``inputs``
    (``write_inputs`` of the ``replay_inputs`` arrays), else every rank
    regenerates ``replay_inputs`` of 2 sessions a data rank.  ``device``:
    default the card (each rank on card rank modulo the cards).  Returns
    (per rank in rank order: a dict of its "spec" and "audio" shard, its
    "launches" of each kernel, its "mesh" shape, "sessions" range and times
    "ready_s", "compute_ms", "collectives_ms"; the ranks' logs)."""
    _check_backend(backend, n_processes)
    device = str(pipeline.resolve_device(device))
    return _spawn("replay", n_processes, backend, device, model_axis, inputs, None, workdir,
                  timeout)


def dryrun_dcn_train(n_processes: int = 2, *, backend: str, device=None, model_axis: int = 1,
                     inputs: str | None = None, config: dict | None = None,
                     workdir: str | None = None, timeout: float = 600.0):
    """Spawn ``n_processes`` ranks on this host and fit one model with
    ``distributed_train`` over ``global_mesh(model_axis)``.  Inputs: the
    directory ``inputs`` (``eeg.npy`` (B, T, C), ``audio.npy`` (B, Ta) at
    ``config``'s audio rate), else every rank regenerates ``train_inputs``
    of 2 sessions a data rank.  ``config``: ``ShardedTrainConfig`` fields
    other than dtype (default nb_feats 16, iir_block 128); the dtype
    is float32 on the card, float64 on the CPU.  Returns (per rank: its
    replica's "coef", "intercept", "classes", "valid", "select", "medians",
    its "launches" and times as ``dryrun_dcn``'s; the ranks' logs)."""
    _check_backend(backend, n_processes)
    device = str(pipeline.resolve_device(device))
    config = config or {"nb_feats": 16, "iir_block": 128}
    return _spawn("train", n_processes, backend, device, model_axis, inputs, config, workdir,
                  timeout)
