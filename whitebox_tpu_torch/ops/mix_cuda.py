"""The timeline mix on the card: CUDA kernel wrappers, plain twins, renderer.

Counterpart of the kernel half of ``whitebox_tpu/ops/mix_pallas.py``
(``_mix_call`` at :603-648, ``PallasMixRenderer`` and
``render_timeline_pallas`` at :651-786). One launch of the hand-written
kernel in ``csrc/mix_kernel.cu`` renders the whole timeline ``[C, F]``:
ordered track sum, resampling, fades, clip gain, track volume*pan and the
hard clip. The kernel has three variants:

- ``mix`` (K1 + K2): constant track gains;
- ``mix_auto`` (+ K3): per-frame volume/pan from the tracks' automation
  lanes, where a track has any;
- ``mix_per_track`` (K4): each track's pre-gain sum ``[T, C, F]``, no
  gain and no clip, for the effect finishers;

each in three interpolation modes for resampled slots (``interp``):
``"linear"`` (K2-linear, the reference's parity mode), ``"catmull"``
(K2-catmull, 4-point Catmull-Rom) and ``("poly", coeffs)`` (K2-poly, the
LS-optimal polynomial taps of ``ops/resample.design_poly_interp`` over an
oversampled pool). A sinc bounce that rides the prerender launches the
same kernel over a pool that ``timeline/prerender.py`` extended on the
card.

- :func:`mix_cuda` / :func:`mix_auto_cuda` / :func:`mix_per_track_cuda`
  launch a variant on CUDA tensors (or raise), each counting its launches.
- :func:`mix_reference` / :func:`mix_auto_reference` /
  :func:`mix_per_track_reference` are the same functions in plain
  PyTorch: the same f32 operations in the same order.
  The CPU tests run them; ``chip_smoke.py`` holds the kernels against them
  on the card.
- :func:`mix` picks by the pool's device: the CPU gets the plain version,
  a CUDA device gets the kernel. Nothing hands CUDA work to the plain
  version or to the CPU.

``render_device_looped`` of the JAX renderer (a timing fence for a
relay-attached TPU) has no counterpart: time with CUDA events.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.automation import eval_lanes, pan_coef
from whitebox_tpu_torch.ops.dsarith import phase_eval
from whitebox_tpu_torch.ops.mix_plan import (
    SLOT_FIELDS, MixPlan, build_plan, check_pool_bounds, interp_taps,
)
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import SegmentTable
from whitebox_tpu_torch.timeline.pool import SamplePool

#: launches of the CUDA mix kernel without automation in this process;
#: :func:`mix_cuda` adds one per launch and nothing else touches it
#: (callers may reset it to 0)
mix_kernel_launches = 0
#: launches of the automation variant; :func:`mix_auto_cuda` adds one per
#: launch and nothing else touches it
mix_auto_launches = 0
#: launches of the per-track kernel (K4); :func:`mix_per_track_cuda` adds
#: one per launch and nothing else touches it
mix_per_track_launches = 0
#: launches of any variant by interpolation mode ("linear", "catmull",
#: "poly"); :func:`_launch` adds one where it launches and nothing else
#: touches it
interp_launches = {"linear": 0, "catmull": 0, "poly": 0}
_INTERP_CODES = {"linear": 0, "catmull": 1, "poly": 2}

#: plan tables in the kernel's argument order
TABLE_FIELDS = ("src_start",) + SLOT_FIELDS + ("track_gain",)
_INT_FIELDS = frozenset(("src_start", "ms", "me", "clampf", "fin_start", "fout_end", "is_slow"))
#: lane tables in the automation kernel's argument order: volume lane
#: xs/ys/cv/tn [T, P], pan lane xs/ys/cv/tn [T, P], mute [T], use [T]
AUTO_FIELDS = ("vxs", "vys", "vcv", "vtn", "pxs", "pys", "pcv", "ptn", "mute", "use")
_AUTO_INT = frozenset(("vxs", "vcv", "pxs", "pcv", "use"))


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


def _check_auto(pool: torch.Tensor, tables: dict, auto: dict) -> int:
    """Validate the lane tables against the plan's T -> points per lane P."""
    T = tables["ms"].shape[1]
    P = auto["vxs"].shape[-1] if auto["vxs"].dim() == 2 else 0
    for f in AUTO_FIELDS:
        x = auto[f]
        want = (T,) if f in ("mute", "use") else (T, P)
        dtype = torch.int32 if f in _AUTO_INT else torch.float32
        if P < 1 or tuple(x.shape) != want or x.dtype != dtype or x.device != pool.device \
                or not x.is_contiguous():
            raise ValueError(f"lane table {f}: want contiguous {dtype} {want} on {pool.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return P


def interp_mode(interp) -> str:
    """``"linear"``, ``"catmull"`` or ``"poly"`` for a valid ``interp``;
    raises ValueError otherwise (``mix_plan.interp_taps`` checks it)."""
    interp_taps(interp)
    return interp if isinstance(interp, str) else "poly"


def _launch(entry, pool, tables, n_tiles, tile, channels, interp, extra=(), per_track=False):
    mode = interp_mode(interp)
    taps = ncoef = 0
    table = None  # the host coefficient table; the entry reads it before returning
    if mode == "poly":
        coeffs = interp[1]
        taps, ncoef = len(coeffs), len(coeffs[0])
        table = (ctypes.c_float * (taps * ncoef))(*[float(c) for row in coeffs for c in row])
    _, T, K = tables["ms"].shape
    shape = (T, channels, n_tiles * tile) if per_track else (channels, n_tiles * tile)
    out = torch.empty(shape, dtype=torch.float32, device=pool.device)
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = entry(pool.data_ptr(), *[tables[f].data_ptr() for f in TABLE_FIELDS],
                   out.data_ptr(), n_tiles, T, K, channels, tile, *extra,
                   _INTERP_CODES[mode], None if table is None else ctypes.addressof(table),
                   taps, ncoef, stream)
    if rc != 0:
        raise RuntimeError(f"mix kernel launch failed: cudaError_t {rc}")
    interp_launches[mode] += 1
    return out


def mix_cuda(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int,
             interp="linear") -> torch.Tensor:
    """Launch the CUDA mix kernel -> ``[C, n_tiles*tile]`` f32 on the pool's card.

    Launches on the current stream and does not synchronise: one kernel
    launch per pair of channels (and one for a last odd channel), counted
    as one. Raises on a non-CUDA tensor, a malformed table, an unknown
    ``interp`` or a refused launch.
    """
    global mix_kernel_launches
    if pool.device.type != "cuda":
        raise ValueError(f"mix_cuda needs CUDA tensors, got {pool.device}")
    _check_args(pool, tables, n_tiles, tile, channels)
    out = _launch(cuda_build.load().wb_mix, pool, tables, n_tiles, tile, channels, interp)
    mix_kernel_launches += 1
    return out


def mix_auto_cuda(pool: torch.Tensor, tables: dict, auto: dict, n_tiles: int, tile: int,
                  channels: int, interp="linear") -> torch.Tensor:
    """Launch the automation variant of the CUDA mix kernel (K3) ->
    ``[C, n_tiles*tile]`` f32. ``auto`` holds the :data:`AUTO_FIELDS`
    tensors on the pool's card. Same contract as :func:`mix_cuda`."""
    global mix_auto_launches
    if pool.device.type != "cuda":
        raise ValueError(f"mix_auto_cuda needs CUDA tensors, got {pool.device}")
    _check_args(pool, tables, n_tiles, tile, channels)
    P = _check_auto(pool, tables, auto)
    out = _launch(cuda_build.load().wb_mix_auto, pool, tables, n_tiles, tile, channels, interp,
                  extra=(*[auto[f].data_ptr() for f in AUTO_FIELDS], P))
    mix_auto_launches += 1
    return out


def mix_per_track_cuda(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int,
                       channels: int, interp="linear") -> torch.Tensor:
    """Launch the per-track kernel (K4) -> ``[T, C, n_tiles*tile]`` f32:
    each track's pre-gain slot sum, for the effect finishers. Same
    contract as :func:`mix_cuda`."""
    global mix_per_track_launches
    if pool.device.type != "cuda":
        raise ValueError(f"mix_per_track_cuda needs CUDA tensors, got {pool.device}")
    _check_args(pool, tables, n_tiles, tile, channels)
    out = _launch(cuda_build.load().wb_mix_per_track, pool, tables, n_tiles, tile, channels,
                  interp, per_track=True)
    mix_per_track_launches += 1
    return out


def _interpolate(tap, fx: torch.Tensor, interp) -> torch.Tensor:
    """A resampled slot's sample from ``tap(j)``, the pool at ``ix + j``,
    and the phase fraction ``fx``: the kernel's ``interpolate`` one f32
    operation at a time (no ``lerp``, ``addcmul`` or ``polyval``, which
    fuse or reorder), in the order of ``mix_pallas.py:549-566``."""
    if interp == "catmull":
        pm1, a, b, p2 = tap(-1), tap(0), tap(1), tap(2)
        c1 = 0.5 * (b - pm1)
        c2 = pm1 - 2.5 * a + 2.0 * b - 0.5 * p2
        c3 = 0.5 * (p2 - pm1) + 1.5 * (a - b)
        return a + fx * (c1 + fx * (c2 + fx * c3))
    if interp == "linear":
        a, b = tap(0), tap(1)
        return a + fx * (b - a)  # sampler.cpp:55
    coeffs = interp[1]
    first = interp_taps(interp)[0]
    res = torch.zeros_like(fx)
    for k, krow in enumerate(coeffs):
        wk = torch.full_like(fx, float(krow[-1]))
        for m in range(len(krow) - 2, -1, -1):
            wk = wk * fx + float(krow[m])
        res = res + wk * tap(first + k)
    return res


def _slot_samples(pool: torch.Tensor, tables: dict, t: int, tile: int, interp="linear"):
    """Track ``t``'s slots in plain PyTorch: ``(v*gain)*env`` of every slot
    at every tile-relative frame -> ``(scaled [n_tiles, K, C, tile], mask
    [n_tiles, K, tile])``, the slot's span mask (empty for inactive slots).

    Each f32 multiply as its own op, in the kernel's order."""
    dev = pool.device
    pos = torch.arange(tile, dtype=torch.int32, device=dev)
    pos64 = pos.to(torch.int64)
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
        resampled = _interpolate(lambda j: pool[torch.where(slow_m, at + j, 0)],
                                 fx[:, :, None, :].expand(at.shape), interp)
        v = torch.where(slow[..., None], resampled, v)

    env = torch.clamp((pos - col["fin_start"][..., None]).to(torch.float32)
                      * col["fin_inv"][..., None], 0.0, 1.0)
    env = env * torch.clamp((col["fout_end"][..., None] - pos).to(torch.float32)
                            * col["fout_inv"][..., None], 0.0, 1.0)
    return (v * col["gain"][..., None, None]) * env[:, :, None, :], mask


def _slot_sum(acc: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Add ``contrib`` ``[nt, K, C, tile]`` into ``acc`` ``[nt, C, tile]``
    slot by slot, in slot order. The kernels skip slots that miss a frame;
    here those add +0.0, which never changes an accumulator that starts at
    +0.0 and only grows by adds."""
    for k in range(contrib.shape[1]):
        acc += contrib[:, k]
    return acc


def _mix_plain(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int,
               track_gain, interp="linear") -> torch.Tensor:
    """Both mix kernels' function in plain PyTorch; ``track_gain(t, g)``
    gives track t's gain, broadcastable to ``[n_tiles, K, C, tile]``, at
    global frames ``g`` ``[n_tiles, tile]``.

    Vectorised over ``[n_tiles, K, C, tile]`` per track, with a Python loop
    over tracks (index order) and slots (slot order) for the sum, each f32
    op as its own op.
    """
    dev = pool.device
    _, T, _ = tables["ms"].shape
    g = (torch.arange(n_tiles, dtype=torch.int64, device=dev)[:, None] * tile
         + torch.arange(tile, dtype=torch.int64, device=dev))
    acc = torch.zeros((n_tiles, channels, tile), dtype=torch.float32, device=dev)
    for t in range(T):
        scaled, mask = _slot_samples(pool, tables, t, tile, interp)
        scaled = scaled * track_gain(t, g)
        _slot_sum(acc, torch.where(mask[:, :, None, :], scaled, 0.0))
    acc = torch.where(acc > 1.0, 1.0, acc)
    acc = torch.where(acc < -1.0, -1.0, acc)
    return acc.permute(1, 0, 2).reshape(channels, n_tiles * tile)


def mix_per_track_reference(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int,
                            channels: int, interp="linear") -> torch.Tensor:
    """The per-track kernel's (K4) function in plain PyTorch -> ``[T, C,
    n_tiles*tile]`` f32: each track's slots summed in slot order from
    +0.0, no track gain, no clip. Bit-identical to
    :func:`mix_per_track_cuda` on any device."""
    _check_args(pool, tables, n_tiles, tile, channels)
    interp_mode(interp)
    _, T, _ = tables["ms"].shape
    out = torch.empty((T, channels, n_tiles * tile), dtype=torch.float32, device=pool.device)
    for t in range(T):
        scaled, mask = _slot_samples(pool, tables, t, tile, interp)
        acc = torch.zeros((n_tiles, channels, tile), dtype=torch.float32, device=pool.device)
        _slot_sum(acc, torch.where(mask[:, :, None, :], scaled, 0.0))
        out[t] = acc.permute(1, 0, 2).reshape(channels, n_tiles * tile)
    return out


def mix_reference(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int,
                  interp="linear") -> torch.Tensor:
    """The CUDA kernel's function in plain PyTorch -> ``[C, n_tiles*tile]`` f32.
    Bit-identical to :func:`mix_cuda` on any device."""
    _check_args(pool, tables, n_tiles, tile, channels)
    interp_mode(interp)
    return _mix_plain(pool, tables, n_tiles, tile, channels,
                      lambda t, g: tables["track_gain"][t][:, None], interp)


def auto_gains(auto: dict, t: int, g: torch.Tensor, channels: int) -> torch.Tensor:
    """Track ``t``'s per-frame gains ``[..., C, F]`` at global frames ``g``
    ``[..., F]``: ``(vol * coef_ch) * mute`` (``mix_pallas.py:443-460``)."""
    vol = eval_lanes({k: auto["v" + k][t] for k in ("xs", "ys", "cv", "tn")}, g)
    pan = eval_lanes({k: auto["p" + k][t] for k in ("xs", "ys", "cv", "tn")}, g)
    return torch.stack([(vol * pan_coef(pan, ch)) * auto["mute"][t] for ch in range(channels)],
                       dim=-2)


def mix_auto_reference(pool: torch.Tensor, tables: dict, auto: dict, n_tiles: int, tile: int,
                       channels: int, interp="linear") -> torch.Tensor:
    """The automation kernel's function in plain PyTorch -> ``[C, n_tiles*tile]``.

    Tracks with ``use[t] == 0`` take the constant ``track_gain`` exactly
    as :func:`mix_reference` does (bit-equal); the others take
    :func:`auto_gains`. Against the kernel on the card the lane values
    agree to the ulps of ``sin``/``exp``/``pow`` (``chip_smoke.py``)."""
    _check_args(pool, tables, n_tiles, tile, channels)
    _check_auto(pool, tables, auto)
    interp_mode(interp)
    use = auto["use"].tolist()

    def track_gain(t, g):
        if not use[t]:
            return tables["track_gain"][t][:, None]
        return auto_gains(auto, t, g, channels)[:, None]  # [nt, 1, C, tile]

    return _mix_plain(pool, tables, n_tiles, tile, channels, track_gain, interp)


def mix(pool: torch.Tensor, tables: dict, n_tiles: int, tile: int, channels: int,
        auto: dict | None = None, per_track: bool = False, interp="linear") -> torch.Tensor:
    """The mix on the pool's device: the kernel on CUDA, the plain version
    on the CPU; the automation variant when ``auto`` lane tables are given;
    with ``per_track`` the per-track pre-gain buffers ``[T, C, F]`` (K4),
    which leave the lanes to the finisher. ``interp``: ``"linear"``,
    ``"catmull"`` or ``("poly", coeffs)`` for the resampled slots."""
    if pool.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no mix for device {pool.device}")
    on_card = pool.device.type == "cuda"
    args = (pool, tables, n_tiles, tile, channels)
    if per_track:
        if auto is not None:
            raise ValueError("per-track mode takes no lane tables (the finisher applies the gains)")
        return (mix_per_track_cuda if on_card else mix_per_track_reference)(*args, interp=interp)
    if auto is None:
        return (mix_cuda if on_card else mix_reference)(*args, interp=interp)
    return (mix_auto_cuda if on_card else mix_auto_reference)(pool, tables, auto, *args[2:],
                                                              interp=interp)


def auto_tables_to_device(auto_tables, device: torch.device) -> dict:
    """Host lane tables ``(vol, pan, mute, use)`` (``render/effects_pipeline.
    prepare_automation_tables_host``) -> the :data:`AUTO_FIELDS` tensors."""
    vol, pan, mute, use = auto_tables
    host = {**{"v" + k: vol[k] for k in ("xs", "ys", "cv", "tn")},
            **{"p" + k: pan[k] for k in ("xs", "ys", "cv", "tn")},
            "mute": mute, "use": use}
    return {f: torch.from_numpy(np.ascontiguousarray(
                host[f], dtype=np.int32 if f in _AUTO_INT else np.float32)).to(device)
            for f in AUTO_FIELDS}


#: the pool last uploaded to each device by :func:`resident_pool`:
#: ``str(device) -> (pool, tensor)``, at most one a device. The entry holds
#: the host ``SamplePool`` strongly and a hit checks it by ``is``, so a
#: freed pool's id can never alias a live one. ``timeline/pool.py``'s cache
#: returns the same ``SamplePool`` for every edit that keeps the asset set,
#: so such an edit uploads nothing. Exact because nothing writes a pool in
#: place: ``pool.data`` is never written after it is built (extensions
#: concatenate into fresh arrays) and the kernels read the device pool
#: through ``const float*``.
_RESIDENT_POOLS: dict = {}
#: hits and misses of :func:`resident_pool` in this process; it adds one to
#: either per call and nothing else touches them (callers may reset them to 0)
resident_pool_hits = 0
resident_pool_misses = 0


def resident_pool(pool: SamplePool, device) -> torch.Tensor:
    """``pool.data`` as a 1-D f32 tensor on ``device``, uploaded once for as
    long as the same ``SamplePool`` object comes back. A miss drops the
    device's previous entry before it uploads, so the card never holds two
    resident pools (a caller still holding the old tensor keeps it alive).
    Counts each call in ``resident_pool_hits`` or ``resident_pool_misses``."""
    global resident_pool_hits, resident_pool_misses
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if key in _RESIDENT_POOLS and _RESIDENT_POOLS[key][0] is pool:
        resident_pool_hits += 1
        return _RESIDENT_POOLS[key][1]
    resident_pool_misses += 1
    _RESIDENT_POOLS.pop(key, None)
    data = torch.from_numpy(np.ascontiguousarray(pool.data, dtype=np.float32)).to(dev)
    _RESIDENT_POOLS[key] = (pool, data)
    return data


class CudaMixRenderer:
    """Holds the plan tables and the pool on the device; renders in one launch.

    ``auto_tables`` (host lane tables from ``prepare_automation_tables_host``)
    selects the automation variant: volume/pan lanes evaluate per frame
    inside the one launch, as the JAX package's fused single pass does.
    ``interp`` is the resampled slots' interpolation. ``pool_device`` may
    be longer than ``pool.data`` (a pool extended on the card): the bounds
    check runs against its length. Without it the renderer takes the
    device's resident copy of ``pool`` (:func:`resident_pool`).
    """

    def __init__(self, table: SegmentTable, pool: SamplePool, session: Session, *,
                 device=None, channels: int = 2, tile: int | None = None,
                 plan: MixPlan | None = None, pool_device: torch.Tensor | None = None,
                 auto_tables=None, interp="linear") -> None:
        self.device = resolve_device(device)
        interp_mode(interp)  # linear, catmull or ("poly", coeffs); anything else raises
        self.interp = interp
        self.plan = plan or build_plan(table, pool, session, channels=channels, tile=tile)
        from whitebox_tpu_torch.render.metrics import span  # render imports this module

        with span("wb.upload"):
            if pool_device is None:
                pool_device = resident_pool(pool, self.device)
            elif pool_device.device.type != self.device.type:
                raise ValueError(f"pool_device lies on {pool_device.device}, renderer on {self.device}")
            check_pool_bounds(self.plan, pool_device.shape[0], interp)
            self.pool_device = pool_device
            self.tables = {f: torch.from_numpy(np.ascontiguousarray(getattr(self.plan, f))).to(self.device)
                           for f in TABLE_FIELDS}
            self.auto = None if auto_tables is None else auto_tables_to_device(auto_tables, self.device)

    def render_device(self) -> torch.Tensor:
        """Full render, output stays on the device: ``[C, n_tiles*tile]`` f32."""
        p = self.plan
        return mix(self.pool_device, self.tables, p.n_tiles, p.tile, p.channels, auto=self.auto,
                   interp=self.interp)

    def render_device_per_track(self) -> torch.Tensor:
        """Per-track pre-gain buffers on the device: ``[T, C, n_tiles*tile]``
        f32 (K4). Track volume/pan is not applied (chains run pre-gain);
        ``render/effects_pipeline.py`` finishes the mix."""
        p = self.plan
        return mix(self.pool_device, self.tables, p.n_tiles, p.tile, p.channels, per_track=True,
                   interp=self.interp)

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
    interp="linear",
) -> np.ndarray:
    """Render the carved timeline -> ``[C, F]`` f32 NumPy; ``interp`` applies
    to the resampled rows."""
    r = CudaMixRenderer(table, pool, session, device=device, channels=channels,
                        tile=tile, plan=plan, interp=interp)
    return r.render()
