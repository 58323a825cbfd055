"""The dynamics stage on the card: a hand CUDA kernel, its plain twin, and
the host model of its tiles and look-back.

The compressor, limiter and gate (``ops/dynamics.py``) are, per row and
frame: a detector level (peak or RMS), a gain computer (soft knee,
ceiling with a lookahead window, gate target), two recurrences that smooth
its output ``v`` -

- the release, a max-decay ``e[n] = max(v[n], rho[n] * e[n-1])``, then for
  the gate ``h[n] = max(e[n], floor[n])`` (else ``h = e``);
- the attack, a one-pole ``y[n] = a[n] * y[n-1] + (1 - a[n]) * h[n]`` -

and a gain on every channel; the RMS detector averages with the one-pole.
Coefficients are one value per row (``[..., 1]``, a scalar) or one per
frame (``[..., F]``: automation lanes); states have the leading shape.

- :func:`compressor`, :func:`limiter` and :func:`gate` run a whole stage:
  on a CUDA tensor one launch of ``csrc/dynamics_scan.cu`` in its fused
  kinds (counted in :data:`dynamics_fused_launches`), on a CPU tensor the
  torch ops of ``ops/dynamics.py`` (``*_torch`` with the plain scans).
- :func:`ballistics` (release then attack) and :func:`onepole` run the
  recurrences alone, the same kernel in its unfused kinds on CUDA
  (:data:`dynamics_scan_launches`), for the frame-sharded stages of
  ``parallel/effects_sharded.py``; with ``products=True`` they also return
  the coefficients' products over the frames in f64 (``prod rho``,
  ``prod a``): a shard's summary.
- Any other device, a malformed argument or a refused launch raises; a
  CUDA tensor never falls back to torch ops.
- :func:`ballistics_reference` / :func:`onepole_reference` are the plain
  versions (``ops/dynamics.py::maxdecay_scan`` / ``::onepole_scan``, the
  Hillis-scan torch ops); :func:`ballistics_f64` is the oracle, the same
  scans in f64.
- :func:`ballistics_model` is the host model of the kernel's recurrences
  in torch: tiles of ``32 l`` frames, each lane's walk from zero, the
  warp's Kogge-Stone scan in the kernel's order, the look-back that
  applies the aggregates after the inclusive prefix it stops at, at any
  depth; :func:`model_scans` puts it in place of the plain scans of the
  processors' torch form (``dyn.compressor_torch(..., scans=...)``), which
  is then the model of the fused kinds: their prologue and epilogue are
  the plain version's f32 ops in its order.

Not a TPU kernel: the JAX package runs the same processors as XLA programs
(``whitebox_tpu/ops/dynamics.py:167,190,229``; the scans ``:53,79``). The
kernel walks frames in order with f64 states where the Hillis scan groups
them in a tree of f32 products and sums, so the two agree to a tolerance,
not to the bit: the kernel is within relative RMS 5e-6 per row of the f64
oracle (about 1e-7 measured), and within 5e-6 plus the plain version's own
distance from the oracle of the plain version (that distance reaches
~6e-6 over a 2^18-frame chunk at the compressor's 5 ms / 100 ms, ~2e-5 at
50 ms / 500 ms).
"""

from __future__ import annotations

import ctypes

import torch

from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops import dynamics as dyn
from whitebox_tpu_torch.ops.scan_util import hillis_scan

#: launches of the unfused kinds (:func:`ballistics`, :func:`onepole`) in
#: this process; nothing else touches it (callers may reset it to 0)
dynamics_scan_launches = 0
#: launches of the fused kinds (:func:`compressor`, :func:`limiter`,
#: :func:`gate`) in this process
dynamics_fused_launches = 0
#: sub-blocks of a tile, one a lane (the kernel's ``kLanes``)
LANES = 32
#: floats after each sub-block in shared memory (``kPad``)
PAD = 4
#: the sub-block lengths the kernel takes
SUB_FRAMES = (32, 64, 128)
#: shared memory a block may use, bytes (``kSmemBytes``)
SMEM_BYTES = 232448
#: the kernel's kinds (``kOnePole`` .. ``kGate``)
KINDS = {"onepole": 0, "ballistics": 1, "compressor": 2, "limiter": 3, "gate": 4}
#: the kernel's parameter slots, in ``WbDynArgs.prm`` order
PARAM_SLOTS = ("release", "attack", "floor", "det_avg", "threshold_db", "ratio", "knee_db", "makeup_db",
               "ceiling_db", "range_db", "hyst_db")
#: f32 operations per frame of the ballistics (the max-decay's multiply and
#: max, the floor's max, the one-pole's subtract, two multiplies and add)
OPS_PER_FRAME = 7
#: f32 operations per frame of a fused stage beyond the ballistics, and
#: per channel (the detector's abs and max, or square and add; the gain's
#: multiply): level in dB 3 (clamp, log, multiply); soft knee 16; RMS
#: average 4 + sqrt and clamp + the mean's divide; ceiling 2 (+ a max per
#: doubling pass of the lookahead window); gate target and floor 14; gain 3
FUSED_OPS = {"compressor": 22, "compressor_rms": 29, "limiter": 8, "gate": 17}


def sub_frames(B: int, F: int, fused: bool = False) -> int:
    """The sub-block length ``l`` for ``B`` rows of ``F`` frames: 32 for the
    fused kinds (their tiles hold x in shared memory, so a short tile keeps
    more warps on an SM) and for calls with few tiles (a one-row 2^18-frame
    call gets 256), else 128 (fewer look-backs a frame)."""
    if fused or B * -(-F // (LANES * 128)) < 2048:
        return 32
    return 128


def _lead(x: torch.Tensor, channels: bool):
    """-> (leading shape, rows, frames) of ``x`` [..., F] or [..., C, F]."""
    lead = x.shape[:-2] if channels else x.shape[:-1]
    B = 1
    for d in lead:
        B *= int(d)
    return lead, B, int(x.shape[-1])


def _ready(t, shape, device) -> bool:
    """Whether ``t`` is already an f32 contiguous tensor of ``shape`` on
    ``device`` (the finishers' per-row parameters and states are)."""
    return (torch.is_tensor(t) and t.dtype == torch.float32 and t.device == device and t.shape == shape
            and t.is_contiguous())


def _coef(c, lead, F: int, device, name: str):
    """A coefficient against ``lead + (F,)`` -> (``[B, 1]`` or ``[B, F]`` f32
    contiguous on ``device``, frame-wise?)."""
    B = 1
    for d in lead:
        B *= int(d)
    for width in (1, F):
        if _ready(c, tuple(lead) + (width,), device):
            return c.view(B, width), width == F and F > 1
    t = torch.as_tensor(c, dtype=torch.float32, device=device)
    framewise = t.dim() > 0 and t.shape[-1] == F and F > 1
    try:
        t = torch.broadcast_to(t, tuple(lead) + ((F,) if framewise else (1,)))
    except RuntimeError as err:
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not broadcast against "
                         f"{tuple(lead) + (F,)}") from err
    return t.reshape(B, -1).contiguous(), framewise


def _state(s, lead, device, name: str, tail=()) -> torch.Tensor:
    """A state against ``lead + tail`` -> ``[B, *tail]`` f32 contiguous on ``device``."""
    if _ready(s, tuple(lead) + tuple(tail), device):
        return s.view((-1,) + tuple(tail))
    t = torch.as_tensor(s, dtype=torch.float32, device=device)
    try:
        t = torch.broadcast_to(t, tuple(lead) + tuple(tail))
    except RuntimeError as err:
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not broadcast against "
                         f"{tuple(lead) + tuple(tail)}") from err
    return t.reshape((-1,) + tuple(tail)).contiguous()


def _product(c, v: torch.Tensor) -> torch.Tensor:
    """prod over the frames of ``c`` against ``v`` in f64 -> the leading shape."""
    lead, _, F = _lead(v, False)
    t, framewise = _coef(c, lead, F, v.device, "coefficient")
    t = t.double()
    p = t.prod(dim=-1) if framewise else t[:, 0] ** F
    return p.reshape(lead)


# ------------------------------------------------------------------ plain versions


def ballistics_reference(v, rho, a, e0, y0, floor=None, products: bool = False):
    """The plain version: ``maxdecay_scan``, the floor, ``onepole_scan`` (torch
    ops) -> ``(y, e_last, y_last)`` (+ ``(prod rho, prod a)`` f64)."""
    e, e_last = dyn.maxdecay_scan(v, rho, e0)
    h = e if floor is None else torch.maximum(e, torch.as_tensor(floor, dtype=torch.float32, device=e.device))
    y, y_last = dyn.onepole_scan(h, a, y0)
    if products:
        return y, e_last, y_last, (_product(rho, v), _product(a, v))
    return y, e_last, y_last


def onepole_reference(x, a, y0, products: bool = False):
    """The plain version: ``onepole_scan`` -> ``(y, y_last)`` (+ ``prod a`` f64)."""
    y, y_last = dyn.onepole_scan(x, a, y0)
    if products:
        return y, y_last, _product(a, x)
    return y, y_last


def ballistics_f64(v, rho, a, e0, y0, floor=None, max_decay: bool = True):
    """The oracle both are held to: the plain version's Hillis scans in f64
    (``(1 - a) * h`` formed in f32 from ``h = max(f32(e), floor)``, as both
    form it) -> ``(y, e_last, y_last)`` in f64 (``max_decay=False``: the
    one-pole over ``h = v``; ``e_last`` None). The f32 scans drift from it
    by up to ~1e-5 relative over 2^18 frames at slow time constants (their
    products and sums round at every level of the tree); the kernel's f64
    walk stays within ~1e-7."""
    f64 = torch.float64
    a32 = torch.broadcast_to(torch.as_tensor(a, dtype=torch.float32, device=v.device), v.shape)
    h, e_last = v, None
    if max_decay:
        d = torch.broadcast_to(torch.as_tensor(rho, dtype=torch.float32, device=v.device), v.shape).to(f64)
        m, dd = hillis_scan(lambda l, r: (torch.maximum(l[0] * r[1], r[0]), l[1] * r[1]), (v.to(f64), d),
                            (-1.0, 1.0))
        e = torch.maximum(m, torch.as_tensor(e0, dtype=f64, device=v.device)[..., None] * dd)
        e_last = e[..., -1]
        h = e.float()
        if floor is not None:
            h = torch.maximum(h, torch.as_tensor(floor, dtype=torch.float32, device=v.device))
    b = ((1.0 - a32) * h).to(f64)
    m, bb = hillis_scan(lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (a32.to(f64), b), (1.0, 0.0))
    y = m * torch.as_tensor(y0, dtype=f64, device=v.device)[..., None] + bb
    return y, e_last, y[..., -1]


# ------------------------------------------------------------------ the kernel


class WbParam(ctypes.Structure):
    """``csrc/dynamics_scan.cu::WbParam``: ``p[row * rs + n * fs]``, or ``val``."""
    _fields_ = [("p", ctypes.c_void_p), ("rs", ctypes.c_longlong), ("fs", ctypes.c_int), ("val", ctypes.c_float)]


class WbDynArgs(ctypes.Structure):
    """``csrc/dynamics_scan.cu::WbDynArgs``, field for field."""
    _fields_ = [(n, ctypes.c_int) for n in ("kind", "detector", "key_mode", "floor_on", "B", "C", "F", "l", "look")] + [
        ("x", ctypes.c_void_p), ("x_rs", ctypes.c_longlong), ("x_cs", ctypes.c_longlong),
        ("key", ctypes.c_void_p), ("key_rs", ctypes.c_longlong), ("key_cs", ctypes.c_longlong),
        ("y", ctypes.c_void_p), ("prm", WbParam * len(PARAM_SLOTS)),
    ] + [(n, ctypes.c_void_p) for n in ("e0", "y0", "d0", "e_out", "y_out", "d_out", "look_in", "look_out",
                                         "xdel_in", "xdel_out", "totals", "ints", "doubles")]


def warp_bytes(kind: str, C: int, l: int, look: int = 0, streams: int = 0) -> int:
    """Shared memory of one tile (one warp), bytes, as the kernel lays it out:
    the values and ``streams`` frame-wise walk coefficients in the sub-block
    layout, the tile's x (with the limiter's ``look`` frames before it), the
    limiter's reductions over both."""
    T, sub = LANES * l, LANES * (l + PAD)
    H = -(-look // 4) * 4 if kind == "limiter" else 0
    floats = sub * (1 + streams)
    if KINDS[kind] >= KINDS["compressor"]:
        floats += C * (H + T)
    if kind == "limiter" and look > 0:
        floats += H + T
    return 4 * floats


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


class DynamicsCall:
    """One prepared launch: arguments checked, outputs and scratch allocated.
    Calling it launches the kernel on the current stream (it does not
    synchronise), counts the launch and returns the results; calling it
    again launches again into the same outputs (the kernel's own time,
    without the wrapper's host work, for a timing)."""

    def __init__(self, args: WbDynArgs, keep: list, fused: bool, results):
        self.args, self._keep, self.fused, self.results = args, keep, fused, results
        self.device = keep[0].device

    def __call__(self):
        global dynamics_scan_launches, dynamics_fused_launches
        lib = cuda_build.load()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = lib.wb_dynamics(ctypes.addressof(self.args), stream)
        if rc != 0:
            raise RuntimeError(f"dynamics kernel launch failed: cudaError_t {rc}")
        if self.fused:
            dynamics_fused_launches += 1
        else:
            dynamics_scan_launches += 1
        return self.results


def _param(c, lead, F: int, device, name: str, keep: list) -> WbParam:
    """A parameter as the kernel takes it: a Python number or a one-element
    CPU tensor as a value (no copy to the card), else a ``[B, 1]`` / ``[B, F]``
    tensor on the card."""
    if isinstance(c, (int, float)) or (torch.is_tensor(c) and c.device.type == "cpu" and c.numel() == 1):
        return WbParam(None, 0, 0, float(c))
    t, framewise = _coef(c, lead, F, device, name)
    keep.append(t)
    return WbParam(t.data_ptr(), F if framewise else 1, int(framewise), 0.0)


def _scratch(B: int, F: int, l: int, device, keep: list):
    """The ticket and flags (int32) and the look-back's f64 records, one buffer."""
    n_tiles = B * -(-F // (LANES * l))
    doubles = 3 * n_tiles * 4
    buf = torch.empty(8 * doubles + 4 * (1 + 3 * n_tiles), dtype=torch.uint8, device=device)
    keep.append(buf)
    return buf.data_ptr() + 8 * doubles, buf.data_ptr()


def _check_smem(kind: str, C: int, l: int, look: int, streams: int) -> None:
    need = warp_bytes(kind, C, l, look, streams)
    if need > SMEM_BYTES:
        raise ValueError(f"the dynamics kernel's {kind} tile needs {need} bytes of shared memory "
                         f"({C} channels, lookahead {look} frames); a block has {SMEM_BYTES}")


def _args(kind: str, B: int, F: int, l: int, C: int = 0, look: int = 0) -> WbDynArgs:
    if l not in SUB_FRAMES:
        raise ValueError(f"sub-block length {l} not in {SUB_FRAMES}")
    a = WbDynArgs()
    a.kind, a.B, a.C, a.F, a.l, a.look = KINDS[kind], B, C, F, l, look
    return a


def prepare_scan(v, rho, a, e0, y0, floor=None, products: bool = False, *, max_decay: bool = True) -> DynamicsCall:
    """The unfused kinds on a CUDA ``v`` [..., F]: the ballistics (``max_decay``;
    results ``(y, e_last, y_last)`` + ``(prod rho, prod a)``) or the one-pole
    over ``v`` (``(y, y_last)`` + ``prod a``)."""
    if v.dtype != torch.float32 or v.dim() < 1 or v.shape[-1] < 1:
        raise ValueError(f"v must be a float32 [..., F] tensor with F >= 1, got {v.dtype} {tuple(v.shape)}")
    lead, B, F = _lead(v, False)
    if B < 1:
        raise ValueError(f"v has no rows: {tuple(v.shape)}")
    dev = v.device
    v2 = v.reshape(B, F)
    if v2.stride(1) != 1 or (B > 1 and v2.stride(0) < F):
        v2 = v2.contiguous()
    l = sub_frames(B, F)
    kind = "ballistics" if max_decay else "onepole"
    keep = [v2]
    args = _args(kind, B, F, l)
    args.x, args.x_rs = v2.data_ptr(), v2.stride(0) if B > 1 else F
    args.prm[1] = _param(a, lead, F, dev, "a", keep)
    streams = int(args.prm[1].fs)
    states = torch.empty((2, B), dtype=torch.float32, device=dev)
    y = torch.empty((B, F), dtype=torch.float32, device=dev)
    ys = _state(y0, lead, dev, "y0")
    keep += [states, y, ys]
    args.y, args.y0, args.y_out = y.data_ptr(), ys.data_ptr(), states[1].data_ptr()
    if max_decay:
        args.prm[0] = _param(rho, lead, F, dev, "rho", keep)
        es = _state(e0, lead, dev, "e0")
        keep.append(es)
        args.e0, args.e_out = es.data_ptr(), states[0].data_ptr()
        streams += args.prm[0].fs
        if floor is not None:
            args.floor_on = 1
            args.prm[2] = _param(floor, lead, F, dev, "floor", keep)
            streams += args.prm[2].fs
    _check_smem(kind, 0, l, 0, streams)
    totals = None
    if products:
        totals = torch.empty((2, B), dtype=torch.float64, device=dev)
        keep.append(totals)
        args.totals = totals.data_ptr()
    args.ints, args.doubles = _scratch(B, F, l, dev, keep)
    yv = y.reshape(v.shape)
    if max_decay:
        out = (yv, states[0].reshape(lead), states[1].reshape(lead))
        if products:
            out = out + ((totals[0].reshape(lead), totals[1].reshape(lead)),)
    else:
        out = (yv, states[1].reshape(lead))
        if products:
            out = out + (totals[1].reshape(lead),)
    return DynamicsCall(args, keep, False, out)


def prepare_stage(kind: str, x, params, state, *, detector: str = "peak", key=None, silent_key: bool = False,
                  lookahead: int = 0) -> DynamicsCall:
    """A fused stage (``kind`` "compressor", "limiter" or "gate") on a CUDA
    ``x`` [..., C, F] with the processors' ``params`` and ``state`` (see
    ``ops/dynamics.py``) -> a call whose results are ``(y, new_state)``."""
    if kind not in ("compressor", "limiter", "gate"):
        raise ValueError(f"no fused dynamics stage {kind!r}")
    if x.dtype != torch.float32 or x.dim() < 2 or x.shape[-1] < 1 or x.shape[-2] < 1:
        raise ValueError(f"x must be a float32 [..., C, F] tensor with C, F >= 1, got {x.dtype} {tuple(x.shape)}")
    if detector not in ("peak", "rms"):
        raise ValueError(f"detector mode {detector!r}")
    if silent_key and key is not None:
        raise ValueError("a silent key and a key tensor at once")
    lead, B, F = _lead(x, True)
    C = int(x.shape[-2])
    if B < 1:
        raise ValueError(f"x has no rows: {tuple(x.shape)}")
    dev = x.device
    x3 = x.reshape(B, C, F)
    if x3.stride(2) != 1:
        x3 = x3.contiguous()
    L = int(lookahead) if kind == "limiter" else 0
    l = sub_frames(B, F, fused=True)
    keep = [x3]
    args = _args(kind, B, F, l, C, L)
    args.x, args.x_rs, args.x_cs = x3.data_ptr(), x3.stride(0), x3.stride(1)
    rms = kind == "compressor" and detector == "rms"
    args.detector = int(rms)
    if key is not None:
        try:
            k3 = torch.broadcast_to(torch.as_tensor(key, dtype=torch.float32, device=dev), x.shape).reshape(B, C, F)
        except RuntimeError as err:
            raise ValueError(f"key of shape {tuple(key.shape)} does not broadcast against {tuple(x.shape)}") from err
        if k3.stride(2) != 1:
            k3 = k3.contiguous()
        keep.append(k3)
        args.key_mode, args.key, args.key_rs, args.key_cs = 1, k3.data_ptr(), k3.stride(0), k3.stride(1)
    elif silent_key:
        args.key_mode = 2
    names = {"compressor": ("release", "attack", "threshold_db", "ratio", "knee_db", "makeup_db"),
             "limiter": ("release", "attack", "ceiling_db"),
             "gate": ("release", "attack", "threshold_db", "range_db", "hyst_db")}[kind]
    defaults = {"hyst_db": 0.0, "det_avg": 0.0}
    for name in names + (("det_avg",) if rms else ()):
        value = params.get(name, defaults.get(name)) if name in defaults else params[name]
        args.prm[PARAM_SLOTS.index(name)] = _param(value, lead, F, dev, name, keep)
    streams = int(args.prm[0].fs) + int(args.prm[1].fs) + (int(args.prm[9].fs) if kind == "gate" else 0) + \
        (int(args.prm[3].fs) if rms else 0)
    _check_smem(kind, C, l, L, streams)
    y = torch.empty((B, C, F), dtype=torch.float32, device=dev)
    states = torch.empty((3, B), dtype=torch.float32, device=dev)
    keep += [y, states]
    args.y, args.e_out, args.y_out, args.d_out = y.data_ptr(), states[0].data_ptr(), states[1].data_ptr(), \
        states[2].data_ptr()
    e_name = "open" if kind == "gate" else "red"
    es, ys = _state(state[e_name], lead, dev, e_name), _state(state["att"], lead, dev, "att")
    keep += [es, ys]
    args.e0, args.y0 = es.data_ptr(), ys.data_ptr()
    new_state = {e_name: states[0].reshape(lead), "att": states[1].reshape(lead)}
    if kind == "compressor":
        if rms:
            ds = _state(state["det"], lead, dev, "det")
            keep.append(ds)
            args.d0 = ds.data_ptr()
            new_state["det"] = states[2].reshape(lead)
        else:
            new_state["det"] = state["det"]
    if kind == "limiter":
        if L > 0:
            look_in = _state(state["look"], lead, dev, "look", (L,))
            xdel_in = _state(state["xdelay"], lead, dev, "xdelay", (C, L))
            look_out = torch.empty((B, L), dtype=torch.float32, device=dev)
            xdel_out = torch.empty((B, C, L), dtype=torch.float32, device=dev)
            keep += [look_in, xdel_in, look_out, xdel_out]
            args.look_in, args.look_out = look_in.data_ptr(), look_out.data_ptr()
            args.xdel_in, args.xdel_out = xdel_in.data_ptr(), xdel_out.data_ptr()
            new_state["look"] = look_out.reshape(tuple(lead) + (L,))
            new_state["xdelay"] = xdel_out.reshape(tuple(lead) + (C, L))
        else:
            new_state["look"], new_state["xdelay"] = state["look"], state["xdelay"]
    args.ints, args.doubles = _scratch(B, F, l, dev, keep)
    return DynamicsCall(args, keep, True, (y.reshape(x.shape), new_state))


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dynamics kernel for device {t.device}")
    return t.device.type


def ballistics(v, rho, a, e0, y0, floor=None, products: bool = False):
    """Release then attack on ``v``'s device: the kernel on CUDA, the plain
    version on the CPU (same arguments and results as
    :func:`ballistics_reference`). On CUDA it launches on the current stream
    and does not synchronise."""
    if _device(v) == "cpu":
        return ballistics_reference(v, rho, a, e0, y0, floor, products)
    return prepare_scan(v, rho, a, e0, y0, floor, products)()


def onepole(x, a, y0, products: bool = False):
    """The one-pole average on ``x``'s device (see :func:`ballistics`) ->
    ``(y, y_last)`` (+ ``prod a`` f64)."""
    if _device(x) == "cpu":
        return onepole_reference(x, a, y0, products)
    return prepare_scan(x, None, a, None, y0, None, products, max_decay=False)()


def compressor(x, params, state, *, detector: str = "peak", key=None, silent_key: bool = False):
    """``ops/dynamics.py::compressor_process`` on ``x``'s device: one fused
    launch on CUDA, the torch ops on the CPU."""
    if _device(x) == "cpu":
        return dyn.compressor_torch(x, params, state, detector=detector, key=key, silent_key=silent_key)
    return prepare_stage("compressor", x, params, state, detector=detector, key=key, silent_key=silent_key)()


def limiter(x, params, state, *, lookahead: int = 0):
    """``ops/dynamics.py::limiter_process`` on ``x``'s device (see :func:`compressor`)."""
    if _device(x) == "cpu":
        return dyn.limiter_torch(x, params, state, lookahead=lookahead)
    return prepare_stage("limiter", x, params, state, lookahead=lookahead)()


def gate(x, params, state, *, key=None, silent_key: bool = False):
    """``ops/dynamics.py::gate_process`` on ``x``'s device (see :func:`compressor`)."""
    if _device(x) == "cpu":
        return dyn.gate_torch(x, params, state, key=key, silent_key=silent_key)
    return prepare_stage("gate", x, params, state, key=key, silent_key=silent_key)()


# ------------------------------------------------------------------ host model


def _kogge_stone(val, prod, op):
    """The warp's inclusive scan over the lanes (dim 2, 32 of them) in the
    kernel's order: at step ``b`` lane ``j >= 2^b`` applies its own summary
    to lane ``j - 2^b``'s."""
    lanes = torch.arange(LANES, device=val.device)
    for b in range(5):
        off = 1 << b
        ov = torch.cat([val[:, :, :off], val[:, :, :-off]], dim=2)
        opr = torch.cat([prod[:, :, :off], prod[:, :, :-off]], dim=2)
        live = lanes >= off
        val, prod = torch.where(live, op(val, prod, ov), val), torch.where(live, opr * prod, prod)
    return val, prod


def _max_decay(val, prod, s):
    return torch.maximum(prod * s, val)


def _affine(val, prod, s):
    return prod * s + val


def _resolve(val, prod, init, op, depth):
    """Each lane's start state from the lanes' summaries from zero
    ``[B, nk, 32]``: the warp scan, the tiles' aggregates, the row's chain of
    inclusive prefixes (a tile's incoming state from the prefix of the tile
    ``depth`` before it, or tile 0's, with the aggregates between applied
    one at a time; ``depth`` an int or one per tile) -> (starts, the
    products over each row)."""
    B, nk, _ = val.shape
    val, prod = _kogge_stone(val, prod, op)
    agg_v, agg_p = val[:, :, -1], prod[:, :, -1]
    incl_s, incl_p, s_in = [], [], []
    for k in range(nk):
        if k == 0:
            s, P = init.double(), torch.ones_like(init, dtype=torch.float64)
        else:
            d = depth if isinstance(depth, int) else depth[k]
            m = max(k - max(int(d), 1), 0)
            s, P = incl_s[m], incl_p[m]
            for q in range(m + 1, k):
                s, P = op(agg_v[:, q], agg_p[:, q], s), P * agg_p[:, q]
        s_in.append(s)
        incl_s.append(op(agg_v[:, k], agg_p[:, k], s))
        incl_p.append(P * agg_p[:, k])
    s_w = torch.stack(s_in, dim=1)[:, :, None]
    starts = op(val[:, :, :-1], prod[:, :, :-1], s_w)
    return torch.cat([s_w, starts], dim=2), incl_p[-1]


def ballistics_model(v, rho, a, e0, y0, floor=None, *, l: int | None = None, depth=1, max_decay: bool = True):
    """Host model of the kernel's recurrences in torch on ``v``'s device:
    ``v`` ``[B, F]`` f32 in tiles of ``32 l`` frames (the last one ragged),
    lane ``j`` of a tile its sub-block of ``l``; every operation the
    kernel's in its order: the states in f64 (``e = max(rho e, v)``,
    ``y = a y + b``), ``h = max(f32(e), floor)`` and ``b = (1 - a) h`` in f32;

    1. each lane's release from ``e = 0``: ``(M, D = prod rho)``; the warp's
       Kogge-Stone scan, the row's chain (:func:`_resolve`): its start;
    2. each lane's release from its start, ``b``, the attack from ``y = 0``:
       ``(Y, A = prod a)``; the scan and chain: its start;
    3. the attack from its start, ``y`` rounded to f32.

    -> ``(y, e_last, y_last, (prod rho, prod a))`` (``max_decay=False``: the
    one-pole alone over ``h = v``; ``e_last`` and ``prod rho`` None).
    Coefficients ``[B, 1]`` or ``[B, F]``; states ``[B]``. ``depth``: where
    the look-back stops (the result does not depend on it)."""
    B, F = v.shape
    l = l or sub_frames(B, F)
    T = LANES * l
    nk = -(-F // T)
    f64 = torch.float64

    def tiles(c, name):  # -> [B, nk, 32, l], or [B, 1, 1, 1] for one value a row
        t, framewise = _coef(c, (B,), F, v.device, name)
        if not framewise:
            return t.reshape(B, 1, 1, 1)
        return torch.nn.functional.pad(t, (0, nk * T - F)).reshape(B, nk, LANES, l)

    def col(t, n):
        return t[..., n if t.shape[-1] > 1 else 0].expand(B, nk, LANES)

    vt = tiles(v, "v")
    at = tiles(a, "a")
    rt = tiles(rho, "rho") if max_decay else None
    ft = tiles(floor, "floor") if (max_decay and floor is not None) else None
    live = (torch.arange(nk * T, device=v.device) < F).reshape(1, nk, LANES, l).expand(B, nk, LANES, l)
    zeros = torch.zeros((B, nk, LANES), dtype=f64, device=v.device)
    e = zeros
    prod_rho = None
    if max_decay:
        D = torch.ones_like(zeros)
        for n in range(l):
            lv, r = live[..., n], col(rt, n).double()
            e = torch.where(lv, torch.maximum(r * e, col(vt, n).double()), e)
            D = torch.where(lv, D * r, D)
        e, prod_rho = _resolve(e, D, _state(e0, (B,), v.device, "e0"), _max_decay, depth)
    y, P = zeros, torch.ones_like(zeros)
    bt = torch.empty((B, nk, LANES, l), dtype=torch.float32, device=v.device)
    for n in range(l):
        lv, h = live[..., n], col(vt, n)
        if max_decay:
            e = torch.where(lv, torch.maximum(col(rt, n).double() * e, h.double()), e)
            h = e.float()
            if ft is not None:
                h = torch.maximum(h, col(ft, n))
        aa = col(at, n)
        b = (1.0 - aa) * h
        bt[..., n] = b
        y = torch.where(lv, aa.double() * y + b.double(), y)
        P = torch.where(lv, P * aa.double(), P)
    y, prod_a = _resolve(y, P, _state(y0, (B,), v.device, "y0"), _affine, depth)
    out = torch.empty_like(bt)
    for n in range(l):
        lv = live[..., n]
        y = torch.where(lv, col(at, n).double() * y + bt[..., n].double(), y)
        out[..., n] = y.float()
    last = (F - (nk - 1) * T - 1) // l  # the lane that holds the row's last frame
    e_last = e[:, -1, last].float() if max_decay else None
    return out.reshape(B, nk * T)[:, :F], e_last, y[:, -1, last].float(), (prod_rho, prod_a)


def model_scans(l: int | None = None, depth=1):
    """(ballistics, onepole) with the plain versions' signatures on
    :func:`ballistics_model`: the processors' torch form with these in place
    of the plain scans is the host model of the fused kinds."""
    def ballistics_fn(v, rho, a, e0, y0, floor=None, products: bool = False):
        lead, B, F = _lead(v, False)
        rows = (lambda c, nm: None if c is None else _coef(c, lead, F, v.device, nm)[0])
        y, e, yl, prods = ballistics_model(v.reshape(B, F), rows(rho, "rho"), rows(a, "a"), _state(e0, lead, v.device, "e0"),
                                           _state(y0, lead, v.device, "y0"), rows(floor, "floor"), l=l, depth=depth)
        out = (y.reshape(v.shape), e.reshape(lead), yl.reshape(lead))
        return out + ((prods[0].reshape(lead), prods[1].reshape(lead)),) if products else out

    def onepole_fn(x, a, y0, products: bool = False):
        lead, B, F = _lead(x, False)
        y, _, yl, (_, pa) = ballistics_model(x.reshape(B, F), None, _coef(a, lead, F, x.device, "a")[0], 0.0,
                                             _state(y0, lead, x.device, "y0"), None, l=l, depth=depth,
                                             max_decay=False)
        out = (y.reshape(x.shape), yl.reshape(lead))
        return out + (pa.reshape(lead),) if products else out
    return ballistics_fn, onepole_fn


def oracle_scans():
    """(ballistics, onepole) on :func:`ballistics_f64`, rounded to f32: with
    these the processors' torch form is their oracle (the recurrences exact
    to f64, the elementwise ops the plain version's)."""
    def ballistics_fn(v, rho, a, e0, y0, floor=None, products: bool = False):
        y, e, yl = ballistics_f64(v, rho, a, e0, y0, floor)
        return y.float(), e.float(), yl.float()

    def onepole_fn(x, a, y0, products: bool = False):
        y, _, yl = ballistics_f64(x, None, a, 0.0, y0, max_decay=False)
        return y.float(), yl.float()
    return ballistics_fn, onepole_fn


def stage_torch(kind: str, x, params, state, scans=None, **kw):
    """``ops/dynamics.py``'s torch form of the stage ``kind`` with ``scans``
    (None: the plain scans) -> ``(y, new_state)``."""
    fn = {"compressor": dyn.compressor_torch, "limiter": dyn.limiter_torch, "gate": dyn.gate_torch}[kind]
    return fn(x, params, state, scans=scans, **kw)


def stage_model(kind: str, x, params, state, *, l: int | None = None, depth=1, **kw):
    """The host model of a fused stage: its torch form with :func:`model_scans`
    (``l`` default: the kernel's choice for ``x``'s rows and frames)."""
    if l is None:
        _, B, F = _lead(x, True)
        l = sub_frames(B, F, fused=True)
    return stage_torch(kind, x, params, state, model_scans(l, depth), **kw)
