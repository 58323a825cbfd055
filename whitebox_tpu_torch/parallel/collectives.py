"""The collectives of the sharded render, over one axis of a
:class:`~whitebox_tpu_torch.parallel.mesh.RenderMesh`.

What ``shard_map`` gives the JAX package, written out for
``torch.distributed``:

- :func:`ordered_sum`, the track sum over the tracks axis: the partial
  sums are gathered and added in rank order, deterministic on every
  backend (a ring ``all_reduce`` is not). Within a rank the tracks add in
  index order (``render/effects_pipeline.py::_ordered_sum``). This stands
  in for ``jax.lax.psum`` at ``whitebox_tpu/parallel/render_sharded.py:93``;
- :func:`all_gather` over the frames axis, of the O(summary) state each
  frame shard hands on (``jax.lax.all_gather`` at
  ``biquad_sharded.py:30-31`` and ``effects_sharded.py:61-62,71-72``); the
  shard's own position is ``axis(...).index`` (``jax.lax.axis_index``);
- :func:`shift`, the tails of the shards ``hops`` places back, zeros
  flowing into the first shards (the ``ppermute`` at
  ``effects_sharded.py:42-46``).

An axis names its group directly (an :class:`Axis`) or by name inside
``with mesh:``. When the group is gloo and the tensor lives on the card
(ranks sharing one card), each collective copies to page-locked host
memory and back, explicitly; :data:`staging` counts those copies, their
bytes and their seconds. A collective that fails raises; nothing falls
back to another path.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from whitebox_tpu_torch.parallel.mesh import Axis

#: meshes entered with ``with mesh:`` (innermost last)
_ACTIVE: list = []
#: host staging of gloo collectives on card tensors in this process:
#: copies (each direction counted), bytes moved and seconds spent copying;
#: nothing else touches it (callers may reset it with :func:`reset_staging`)
staging = {"copies": 0, "bytes": 0, "seconds": 0.0}


def reset_staging() -> None:
    staging.update(copies=0, bytes=0, seconds=0.0)


def axis(axis_name) -> Axis:
    """The :class:`Axis` of ``axis_name``: itself, or the named axis of the
    innermost mesh entered with ``with mesh:``."""
    if isinstance(axis_name, Axis):
        return axis_name
    if not _ACTIVE:
        raise ValueError(f"axis {axis_name!r} outside a mesh: pass the mesh's Axis "
                         f"(mesh.axis({axis_name!r})) or call inside `with mesh:`")
    return _ACTIVE[-1].axis(axis_name)


def _count(nbytes: int, t0: float) -> None:
    staging["copies"] += 1
    staging["bytes"] += nbytes
    staging["seconds"] += time.perf_counter() - t0


def _to_host(x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    _count(x.numel() * x.element_size(), t0)
    return h


def _to_device(parts: list, device) -> torch.Tensor:
    """Page-locked host tensors -> one stacked tensor on ``device``."""
    t0 = time.perf_counter()
    x = torch.stack([h.to(device, non_blocking=True) for h in parts])
    torch.cuda.synchronize(device)
    _count(sum(h.numel() * h.element_size() for h in parts), t0)
    return x


def all_gather(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Every shard's ``x`` along the axis -> ``[size, *x.shape]`` in axis
    order, on ``x``'s device."""
    ax = axis(axis_name)
    if ax.size == 1:
        return x[None]
    x = x.contiguous()
    send = _to_host(x) if ax.staged else x
    parts = [torch.empty(send.shape, dtype=send.dtype, device=send.device, pin_memory=ax.staged)
             for _ in range(ax.size)]
    dist.all_gather(parts, send, group=ax.group)
    return _to_device(parts, x.device) if ax.staged else torch.stack(parts)


def ordered_sum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum of every shard's ``x`` along the axis, added in rank order
    (``x_0 + x_1 + ...``), the same on every shard; ``x`` itself on an axis
    of one."""
    ax = axis(axis_name)
    if ax.size == 1:
        return x
    parts = all_gather(x, ax)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def shift(x: torch.Tensor, axis_name, hops: int = 1) -> torch.Tensor:
    """The ``x`` of the shard ``hops`` places back along the axis; zeros on
    the first ``hops`` shards (stream start)."""
    ax = axis(axis_name)
    if ax.size == 1 or hops >= ax.size:
        return torch.zeros_like(x)
    parts = all_gather(x, ax)
    return parts[ax.index - hops] if ax.index >= hops else torch.zeros_like(x)


def gather_frames(local: torch.Tensor, axis_name) -> torch.Tensor:
    """The frame shards ``[..., F_local]`` of the axis joined in order ->
    ``[..., size * F_local]`` on every shard."""
    parts = all_gather(local, axis_name)
    return torch.cat(list(parts.unbind(0)), dim=-1)
