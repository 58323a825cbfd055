"""The ('tracks', 'frames') mesh of ranks for sharded rendering.

Counterpart of ``whitebox_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over the devices of one controller; here every rank
of a ``torch.distributed`` world runs the same program (SPMD), and the
ranks form a ``torch.distributed.device_mesh.DeviceMesh`` with the same
axis names. Rank ``r`` sits at ``(r // frames, r % frames)``, as the JAX
grid ``devices.reshape(tracks, frames)`` places device ``r``.

Each rank computes on its own device: ``cuda:<LOCAL_RANK>`` when every
rank has its own card, ``cuda:0`` when the ranks share one card, or the
CPU when the caller asks for it by name. The backend follows the device:
NCCL when each rank has its own card, gloo on the CPU, and gloo with
explicit host staging (``parallel/collectives.py``) when ranks share a
card. :func:`make_render_mesh` with no process group initialised starts a
world of one, so a plain script on one card works as the JAX call with
the default devices does.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from whitebox_tpu_torch.device import resolve_device

AXES = ("tracks", "frames")
#: collective timeout of the world of one :func:`make_render_mesh` starts
DEFAULT_TIMEOUT_S = 120.0


@dataclass
class Axis:
    """One axis of the mesh as this rank sees it: the process group of the
    ranks that share its other coordinate, this rank's index along the
    axis, the axis size, and whether collectives stage through host memory
    (a gloo group carrying tensors that live on the card)."""

    name: str
    group: object
    index: int
    size: int
    staged: bool


class RenderMesh:
    """A ('tracks', 'frames') grid over the ranks of the default process
    group. ``shape`` maps the axis names to their sizes, as
    ``jax.sharding.Mesh.shape`` does; ``device`` is this rank's device;
    ``axis(name)`` its :class:`Axis`. ``with mesh:`` makes the axis names
    resolve for the ``*_shard`` functions, as ``shard_map`` binds them."""

    def __init__(self, tracks_parallel: int, frames_parallel: int, device: torch.device):
        self.shape = {"tracks": int(tracks_parallel), "frames": int(frames_parallel)}
        self.device = device
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend()).lower()
        self.staged = device.type == "cuda" and self.backend != "nccl"
        grid = torch.arange(dist.get_world_size()).reshape(tracks_parallel, frames_parallel)
        # the mesh of the collectives: the card's under NCCL, the host's under gloo
        mesh_type = "cuda" if self.backend == "nccl" else "cpu"
        self.device_mesh = DeviceMesh(mesh_type, grid, mesh_dim_names=AXES)
        ti, fi = divmod(self.rank, frames_parallel)
        self.coords = {"tracks": ti, "frames": fi}
        self._axes = {name: Axis(name, self.device_mesh.get_group(name), self.coords[name],
                                 self.shape[name], self.staged) for name in AXES}

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __enter__(self):
        from whitebox_tpu_torch.parallel import collectives

        collectives._ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        from whitebox_tpu_torch.parallel import collectives

        collectives._ACTIVE.pop()
        return False

    def __repr__(self) -> str:
        return (f"RenderMesh(tracks={self.shape['tracks']}, frames={self.shape['frames']}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend}, staged={self.staged})")


def rank_device(devices=None) -> torch.device:
    """This rank's device: the CPU when asked for by name; otherwise the
    card ``cuda:<LOCAL_RANK>`` (its index modulo the cards present, so
    ranks beyond the card count share them)."""
    dev = resolve_device(devices)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def default_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (the CPU,
    or ranks that share a card and exchange through host memory)."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_render_mesh(tracks_parallel: int | None = None, frames_parallel: int | None = None,
                     devices=None) -> RenderMesh:
    """Build a ('tracks', 'frames') mesh over the ranks of the world.

    ``devices`` names the per-rank device type ("cuda", the default, or
    "cpu"). Defaults split the world as the JAX package does: a tracks
    axis of 2 or 4 when the count allows a 2-D mesh, the frames axis the
    rest (frame shards exchange only summaries; the tracks axis pays the
    ordered sum). Raises ``ValueError`` when the mesh does not match the
    world. Without an initialised process group, starts a world of one on
    the resolved device (NCCL on the card, gloo on the CPU)."""
    if not dist.is_initialized():
        dev = rank_device(devices)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(default_backend(dev, 1), store=dist.HashStore(), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    dev = rank_device(devices)
    n = dist.get_world_size()
    if tracks_parallel is None and frames_parallel is None:
        tracks_parallel = 1
        frames_parallel = n
        # prefer a modest tracks axis when the rank count allows a 2-D mesh
        for tp in (2, 4):
            if n % tp == 0 and n // tp >= 2:
                tracks_parallel, frames_parallel = tp, n // tp
                break
    elif tracks_parallel is None:
        tracks_parallel = n // frames_parallel
    elif frames_parallel is None:
        frames_parallel = n // tracks_parallel
    if tracks_parallel * frames_parallel != n:
        raise ValueError(f"mesh {tracks_parallel}x{frames_parallel} != {n} devices")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif str(dist.get_backend()).lower() == "nccl":
        raise ValueError("a CPU mesh needs a gloo process group, the world runs NCCL")
    return RenderMesh(tracks_parallel, frames_parallel, dev)
