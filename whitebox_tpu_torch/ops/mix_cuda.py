"""The timeline mix on the card: CUDA kernel wrapper, plain twin, renderer.

Counterpart of the kernel half of ``whitebox_tpu/ops/mix_pallas.py``
(``_mix_call`` at :603-648, ``PallasMixRenderer`` and
``render_timeline_pallas`` at :651-786). One launch of the hand-written
kernel in ``csrc/mix_kernel.cu`` renders the whole timeline ``[C, F]``:
ordered track sum, linear resampling, fades, clip gain, track volume*pan
and the hard clip.

- :func:`mix_cuda` launches the kernel on CUDA tensors (or raises).
- :func:`mix_reference` is the same function in plain PyTorch: the same
  f32 operations in the same order, so on any device it is bit-identical
  to the kernel. The CPU tests run it; ``chip_smoke.py`` holds the kernel
  against it on the card.
- :func:`mix` picks by the pool's device: the CPU gets the plain version,
  a CUDA device gets the kernel. Nothing hands CUDA work to the plain
  version or to the CPU.

``render_device_looped`` of the JAX renderer (a timing fence for a
relay-attached TPU) has no counterpart: time with CUDA events.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu.session.session import Session
from whitebox_tpu.timeline.carve import SegmentTable
from whitebox_tpu.timeline.pool import SamplePool
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.dsarith import phase_eval
from whitebox_tpu_torch.ops.mix_plan import (
    SLOT_FIELDS, MixPlan, build_plan, check_pool_bounds,
)

#: launches of the CUDA mix kernel in this process; :func:`mix_cuda` adds
#: one per launch and nothing else touches it (callers may reset it to 0)
mix_kernel_launches = 0

#: plan tables in the kernel's argument order
TABLE_FIELDS = ("src_start",) + SLOT_FIELDS + ("track_gain",)
_INT_FIELDS = frozenset(("src_start", "ms", "me", "clampf", "fin_start", "fout_end", "is_slow"))


def _check_args(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int) -> None:
    if pool.dtype != torch.float32 or pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous 1-D float32 tensor")
    nt, T, K = tables["ms"].shape
    if nt != n_tiles or tile <= 0 or channels <= 0:
        raise ValueError(f"tables hold {nt} tiles, expected {n_tiles} (tile {tile}, C {channels})")
    for f in TABLE_FIELDS:
        x = tables[f]
        want = (nt, T, K, channels) if f == "src_start" else (T, channels) if f == "track_gain" else (nt, T, K)
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        if tuple(x.shape) != want or x.dtype != dtype or x.device != pool.device or not x.is_contiguous():
            raise ValueError(f"table {f}: want contiguous {dtype} {want} on {pool.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def mix_cuda(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int) -> torch.Tensor:
    """Launch the CUDA mix kernel -> ``[C, n_tiles*tile]`` f32 on the pool's card.

    Launches on the current stream and does not synchronise. Raises on a
    non-CUDA tensor, a malformed table, or a refused launch.
    """
    global mix_kernel_launches
    if pool.device.type != "cuda":
        raise ValueError(f"mix_cuda needs CUDA tensors, got {pool.device}")
    _check_args(pool, tables, n_tiles, tile, channels)
    _, T, K = tables["ms"].shape
    lib = cuda_build.load()
    out = torch.empty((channels, n_tiles * tile), dtype=torch.float32, device=pool.device)
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = lib.wb_mix_linear(pool.data_ptr(), *[tables[f].data_ptr() for f in TABLE_FIELDS],
                               out.data_ptr(), n_tiles, T, K, channels, tile, stream)
    if rc != 0:
        raise RuntimeError(f"mix kernel launch failed: cudaError_t {rc}")
    mix_kernel_launches += 1
    return out


def mix_reference(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int) -> torch.Tensor:
    """The CUDA kernel's function in plain PyTorch -> ``[C, n_tiles*tile]`` f32.

    Vectorised over ``[n_tiles, K, C, tile]`` per track, with a Python loop
    over tracks (index order) and slots (slot order) for the sum: every
    slot is added into the accumulator in the kernel's order, each f32
    multiply and add as its own op (no lerp, addcmul or alpha, which fuse
    or reorder).
    """
    _check_args(pool, tables, n_tiles, tile, channels)
    dev = pool.device
    _, T, K = tables["ms"].shape
    pos = torch.arange(tile, dtype=torch.int32, device=dev)
    pos64 = pos.to(torch.int64)
    acc = torch.zeros((n_tiles, channels, tile), dtype=torch.float32, device=dev)
    for t in range(T):
        col = {f: tables[f][:, t] for f in SLOT_FIELDS}  # each [nt, K]
        ms, me = col["ms"][..., None], col["me"][..., None]  # [nt, K, 1]
        mask = (pos >= ms) & (pos < me)  # [nt, K, tile]; empty for inactive slots
        slow = (col["is_slow"] == 1)[..., None]
        start = tables["src_start"][:, t].to(torch.int64)[..., None]  # [nt, K, C, 1]

        fast_m = (mask & ~slow)[:, :, None, :]
        v = pool[torch.where(fast_m, start + pos64, 0)]  # [nt, K, C, tile]
        clamped = torch.where(v < -1.0, -1.0, v)
        clamped = torch.where(clamped > 1.0, 1.0, clamped)
        v = torch.where((col["clampf"] == 1)[..., None, None], clamped, v)
        if bool(slow.any()):
            j = torch.clamp(pos - ms, min=0)
            ix, fx = phase_eval(j, col["sfrac_hi"][..., None], col["sfrac_lo"][..., None],
                                col["sspeed_hi"][..., None], col["sspeed_lo"][..., None])
            slow_m = (mask & slow)[:, :, None, :]
            at = start + ix.to(torch.int64)[:, :, None, :]
            a = pool[torch.where(slow_m, at, 0)]
            b = pool[torch.where(slow_m, at + 1, 0)]
            lerp = a + fx[:, :, None, :] * (b - a)  # sampler.cpp:55
            v = torch.where(slow[..., None], lerp, v)

        env = torch.clamp((pos - col["fin_start"][..., None]).to(torch.float32)
                          * col["fin_inv"][..., None], 0.0, 1.0)
        env = env * torch.clamp((col["fout_end"][..., None] - pos).to(torch.float32)
                                * col["fout_inv"][..., None], 0.0, 1.0)
        scaled = (v * col["gain"][..., None, None]) * env[:, :, None, :]
        scaled = scaled * tables["track_gain"][t][:, None]
        contrib = torch.where(mask[:, :, None, :], scaled, 0.0)
        # the kernel skips inactive slots; here they add +0.0, which never
        # changes an accumulator that starts at +0.0 and only grows by adds
        for k in range(K):
            acc += contrib[:, k]
    acc = torch.where(acc > 1.0, 1.0, acc)
    acc = torch.where(acc < -1.0, -1.0, acc)
    return acc.permute(1, 0, 2).reshape(channels, n_tiles * tile)


def mix(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int) -> torch.Tensor:
    """The mix on the pool's device: the kernel on CUDA, the plain version on the CPU."""
    if pool.device.type == "cuda":
        return mix_cuda(pool, tables, n_tiles, tile, channels)
    if pool.device.type == "cpu":
        return mix_reference(pool, tables, n_tiles, tile, channels)
    raise ValueError(f"no mix for device {pool.device}")


class CudaMixRenderer:
    """Holds the plan tables and the pool on the device; renders in one launch."""

    def __init__(self, table: SegmentTable, pool: SamplePool, session: Session, *,
                 device=None, channels: int = 2, tile: int | None = None,
                 plan: MixPlan | None = None, pool_device: torch.Tensor | None = None) -> None:
        self.device = resolve_device(device)
        self.plan = plan or build_plan(table, pool, session, channels=channels, tile=tile)
        if pool_device is None:
            pool_device = torch.from_numpy(np.ascontiguousarray(pool.data, dtype=np.float32)).to(self.device)
        elif pool_device.device.type != self.device.type:
            raise ValueError(f"pool_device lies on {pool_device.device}, renderer on {self.device}")
        check_pool_bounds(self.plan, pool_device.shape[0])
        # repeated renders of one session: samples stay device-resident
        self.pool_device = pool_device
        self.tables = {f: torch.from_numpy(np.ascontiguousarray(getattr(self.plan, f))).to(self.device)
                       for f in TABLE_FIELDS}

    def render_device(self) -> torch.Tensor:
        """Full render, output stays on the device: ``[C, n_tiles*tile]`` f32."""
        p = self.plan
        return mix(self.pool_device, self.tables, p.n_tiles, p.tile, p.channels)

    def render(self) -> np.ndarray:
        """``[C, total_frames]`` f32 on the host."""
        return self.render_device()[:, : self.plan.total_frames].cpu().numpy()


def render_timeline_cuda(
    table: SegmentTable,
    pool: SamplePool,
    session: Session,
    channels: int = 2,
    tile: int | None = None,
    plan: MixPlan | None = None,
    device=None,
) -> np.ndarray:
    """Render the carved timeline -> ``[C, F]`` f32 NumPy (linear resampling)."""
    r = CudaMixRenderer(table, pool, session, device=device, channels=channels,
                        tile=tile, plan=plan)
    return r.render()
