"""The (data, model) mesh over a process group, each rank's block of a
batch, and the two collectives the parallel paths use.

Port of ``closed_loop_seeg_speech_synthesis_tpu/parallel/mesh.py``.  One
rank is one device.  The system scales two ways:

* ``data``: sessions (exp1's folds and chance runs, exp2's chance decodes,
  the sessions of a multi-session training) are independent, so each data
  rank decodes or featurizes its own;
* ``model``: sEEG channels.  The filter chain, the log-power and the
  context stack are channel-local, and the stacked features are
  channel-major, so a block of channels owns a contiguous block of features.
  The one edge between channel blocks is the gather of the stacked features
  before selection (training) or the sum of the LDA products (decode).

Where the JAX package annotates shardings and lets XLA insert the
collectives, each rank here takes its slice (``session_sharding``,
``feature_sharding``) and calls ``all_gather`` / ``all_reduce_sum`` itself.
A replicated result (the fitted model, a channel-sharded decode's output)
is whole on every rank, so it needs no helper.  ``mesh=None`` everywhere
means one process and no collective: the single-device reference, which
needs no process group.

gloo runs its collectives in host memory: a CUDA tensor is staged through
the host in ``_host_staged``, which is also what gloo's own CUDA path does.
NCCL takes CUDA tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..runtime.trainer import StageClock

AXES = ("data", "model")


def make_mesh(n_devices: int | None = None, model_axis: int | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` of shape (n_devices / model_axis, model_axis) with
    dims ("data", "model") over ranks 0 .. n_devices-1 of the initialized
    process group (default: all of them).  Rank r sits at (r // model_axis,
    r % model_axis), so the data axis is process-major.  model_axis
    defaults to 2 when n_devices is even and > 1, else 1.  Every rank of
    the group calls it, as it creates the axes' groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialized; call "
                           "parallel.distributed.initialize first (mesh=None runs one "
                           "process with no collective)")
    world = dist.get_world_size()
    n = n_devices or world
    if world < n:
        raise ValueError(f"make_mesh: requested {n} devices but only {world} exist "
                         f"(backend={dist.get_backend()!r}): one rank is one device; start "
                         "more processes (parallel.distributed.initialize)")
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n % model_axis != 0:
        raise ValueError(f"make_mesh: model_axis={model_axis} does not divide n={n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model_axis, model_axis),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh | None, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_block(mesh: DeviceMesh | None, axis: str, n: int, what: str) -> slice:
    """This rank's contiguous block of ``n`` items split over ``axis``."""
    parts = axis_size(mesh, axis)
    if n % parts:
        raise ValueError(f"{what}: {n} does not divide over the {parts} ranks of the "
                         f"{axis!r} axis")
    k = n // parts
    i = axis_index(mesh, axis)
    return slice(i * k, (i + 1) * k)


def session_sharding(mesh: DeviceMesh | None, n_sessions: int, n_channels: int):
    """This rank's block of a (B, T, C) session batch: (sessions, channels)
    slices, sessions over data, channels over model."""
    return (axis_block(mesh, "data", n_sessions, "sessions"),
            axis_block(mesh, "model", n_channels, "channels"))


def feature_sharding(mesh: DeviceMesh | None, n_features: int) -> slice:
    """This rank's block of the last axis of channel-major stacked features
    (and of the LDA weights over them): the stacked context of its
    ``session_sharding`` channels."""
    return axis_block(mesh, "model", n_features, "features")


def _host_staged(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def all_gather(t: torch.Tensor, mesh: DeviceMesh | None, axis: str, dim: int = 0,
               timings: dict | None = None) -> torch.Tensor:
    """The ``axis`` ranks' tensors (of one shape) concatenated along ``dim``
    in their order on the axis; t itself where the axis has one rank.
    ``timings``, when given, receives the milliseconds under "collectives"."""
    if axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    with StageClock(timings, t.device)("collectives", host=True):
        x = _host_staged(t.contiguous(), group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim).to(t.device)


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh | None, axis: str,
                   timings: dict | None = None) -> torch.Tensor:
    """The sum over the ``axis`` ranks of their tensors (of one shape), on
    every one of them; t itself where the axis has one rank."""
    if axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    with StageClock(timings, t.device)("collectives", host=True):
        x = _host_staged(t, group).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x.to(t.device)
