"""The dynamics ballistics on the card: a hand CUDA kernel, its plain twin,
and the host model of its blocked recurrences.

The compressor, limiter and gate (``ops/dynamics.py``) smooth their gain
computers' targets with two recurrences per row, frames on the last axis:

- the release, a max-decay ``e[n] = max(v[n], rho[n] * e[n-1])``, then for
  the gate ``h[n] = max(e[n], floor[n])`` (else ``h = e``);
- the attack, a one-pole ``y[n] = a[n] * y[n-1] + (1 - a[n]) * h[n]``;

and the RMS detector averages with the one-pole alone. Coefficients are one
value per row (``[..., 1]`` or a scalar) or one per frame (``[..., F]``:
automation lanes); states ``e0``, ``y0`` have the leading shape.

- :func:`ballistics` (both recurrences) and :func:`onepole` launch
  ``csrc/dynamics_scan.cu`` on a CUDA tensor and run their plain versions
  on a CPU tensor; any other device, a malformed argument or a refused
  launch raises. They count their calls in :data:`dynamics_scan_launches`
  (five kernel launches for the ballistics, three for the one-pole,
  counted as one).
- :func:`ballistics_reference` and :func:`onepole_reference` are the plain
  versions: ``ops/dynamics.py::maxdecay_scan`` and ``::onepole_scan``, the
  Hillis-scan torch ops, as the processors ran them before the kernel.
- :func:`ballistics_f64` is the oracle: the same scans in f64.
- :func:`ballistics_blocked` is the host model of the kernel's blocks and
  carries in torch: blocks of ``L`` frames walked in order with the
  states in f64 and ``(1 - a) * h`` formed in f32, the carries between
  blocks in f64, as the kernel runs them.

With ``products=True`` each also returns the coefficients' products over
the frames in f64 (``prod rho``, ``prod a``): a frame shard's summary for
the state handoff of ``parallel/effects_sharded.py``.

Not a TPU kernel: the JAX package runs the same recurrences as XLA prefix
scans (``whitebox_tpu/ops/dynamics.py:53,79``). The kernel walks each
block in order with f64 states where the Hillis scan groups frames in a
tree of f32 products and sums, so the two agree to a tolerance, not to the
bit: the kernel is within relative RMS 5e-6 per row of the f64 oracle
(about 1e-7 measured), and within 5e-6 plus the plain version's own
distance from the oracle of the plain version (that distance reaches
~6e-6 over a 2^18-frame chunk at the compressor's 5 ms / 100 ms, ~2e-5 at
50 ms / 500 ms).
"""

from __future__ import annotations

import torch

from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops import dynamics as dyn
from whitebox_tpu_torch.ops.scan_util import hillis_scan

#: calls of :func:`ballistics` / :func:`onepole` that launched the kernel in
#: this process; nothing else touches it (callers may reset it to 0)
dynamics_scan_launches = 0
#: frames per block of the blocked recurrences (a multiple of ``kTile``,
#: 32, in the source): a thread walks one block, a row's blocks are
#: carried in order by one warp
BLOCK_FRAMES = 1024
#: f32 operations per frame of the ballistics (the max-decay's multiply and
#: max, the floor's max, the one-pole's subtract, two multiplies and add)
OPS_PER_FRAME = 7


def _leading(v: torch.Tensor):
    return v.shape[:-1], int(v.shape[-1])


def _coef(c, v: torch.Tensor, name: str):
    """A coefficient against ``v`` ``[..., F]`` -> (``[B, 1]`` or ``[B, F]``
    f32 contiguous on v's device, frame-wise?)."""
    lead, F = _leading(v)
    B = v.numel() // F
    t = torch.as_tensor(c, dtype=torch.float32, device=v.device)
    framewise = t.dim() > 0 and t.shape[-1] == F and F > 1
    try:
        t = torch.broadcast_to(t, lead + ((F,) if framewise else (1,)))
    except RuntimeError as err:
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not broadcast against {tuple(v.shape)}") from err
    return t.reshape(B, -1).contiguous(), framewise


def _state(s, v: torch.Tensor, name: str) -> torch.Tensor:
    lead, F = _leading(v)
    t = torch.as_tensor(s, dtype=torch.float32, device=v.device)
    try:
        return torch.broadcast_to(t, lead).reshape(-1).contiguous()
    except RuntimeError as err:
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not broadcast against {tuple(lead)}") from err


def _product(c, v: torch.Tensor) -> torch.Tensor:
    """prod over the frames of ``c`` against ``v`` in f64 -> the leading shape."""
    lead, F = _leading(v)
    t, framewise = _coef(c, v, "coefficient")
    t = t.double()
    p = t.prod(dim=-1) if framewise else t[:, 0] ** F
    return p.reshape(lead)


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


def _launch(mode: int, v, rho, a, e0, y0, floor, products: bool):
    global dynamics_scan_launches
    if v.dtype != torch.float32 or v.dim() < 1 or v.shape[-1] < 1:
        raise ValueError(f"v must be a float32 [..., F] tensor with F >= 1, got {v.dtype} {tuple(v.shape)}")
    lead, F = _leading(v)
    B = v.numel() // F
    if B < 1:
        raise ValueError(f"v has no rows: {tuple(v.shape)}")
    v2 = v.reshape(B, F)
    if v2.stride(1) != 1 or (B > 1 and v2.stride(0) < F):
        v2 = v2.contiguous()
    dev = v.device
    ca, a_fw = _coef(a, v, "a")
    ys = _state(y0, v, "y0")
    if mode == 1:
        cr, r_fw = _coef(rho, v, "rho")
        es = _state(e0, v, "e0")
        cf, f_fw = _coef(floor, v, "floor") if floor is not None else (None, False)
    else:
        cr, r_fw, es, cf, f_fw = None, False, None, None, False
    L = BLOCK_FRAMES
    nb = -(-F // L)
    y = torch.empty((B, F), dtype=torch.float32, device=dev)
    y_last = torch.empty(B, dtype=torch.float32, device=dev)
    e_last = torch.empty(B, dtype=torch.float32, device=dev) if mode == 1 else None
    totals = torch.empty((2, B), dtype=torch.float64, device=dev) if products else None
    scratch = torch.empty((6, B, nb), dtype=torch.float64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def rs(t, fw):  # row stride of a [B, 1] / [B, F] coefficient
        return 0 if t is None else (F if fw else 1)

    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wb_dynamics_scan(mode, v2.data_ptr(), v2.stride(0) if B > 1 else F, B, F, L,
                                  ptr(cr), rs(cr, r_fw), int(r_fw), ca.data_ptr(), rs(ca, a_fw), int(a_fw),
                                  ptr(cf), rs(cf, f_fw), int(f_fw), ptr(es), ys.data_ptr(), y.data_ptr(),
                                  ptr(e_last), y_last.data_ptr(), ptr(totals), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dynamics scan launch failed: cudaError_t {rc}")
    dynamics_scan_launches += 1
    y = y.reshape(v.shape)
    out = (y, e_last.reshape(lead), y_last.reshape(lead)) if mode == 1 else (y, y_last.reshape(lead))
    if products:
        prods = (totals[0].reshape(lead), totals[1].reshape(lead)) if mode == 1 else totals[1].reshape(lead)
        out = out + (prods,)
    return out


def ballistics(v, rho, a, e0, y0, floor=None, products: bool = False):
    """Release then attack on ``v``'s device: the kernel on CUDA, the plain
    version on the CPU (same arguments and results as
    :func:`ballistics_reference`). On CUDA it launches on the current stream
    and does not synchronise."""
    if v.device.type == "cpu":
        return ballistics_reference(v, rho, a, e0, y0, floor, products)
    if v.device.type != "cuda":
        raise ValueError(f"no dynamics scan for device {v.device}")
    return _launch(1, v, rho, a, e0, y0, floor, products)


def onepole(x, a, y0, products: bool = False):
    """The one-pole average on ``x``'s device (see :func:`ballistics`) ->
    ``(y, y_last)`` (+ ``prod a`` f64)."""
    if x.device.type == "cpu":
        return onepole_reference(x, a, y0, products)
    if x.device.type != "cuda":
        raise ValueError(f"no dynamics scan for device {x.device}")
    return _launch(0, x, None, a, None, y0, None, products)


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


# ------------------------------------------------------------------ host model


def ballistics_blocked(v, rho, a, e0, y0, floor=None, L: int = BLOCK_FRAMES, max_decay: bool = True):
    """Host model of the kernel in torch on ``v``'s device: ``v`` ``[B, F]``
    f32 split into blocks of ``L`` frames (the last one ragged), every
    operation the kernel's in its order: the states ``e``, ``y`` in f64
    (``e = max(rho * e, v)``, ``y = a * y + b``), ``h = max(f32(e), floor)``
    and ``b = (1 - a) * h`` in f32;

    1. each block from ``e = 0``: its max ``M_b`` and ``D_b = prod rho``;
    2. ``e_start[b+1] = max(M_b, D_b * e_start[b])`` from ``e0``;
    3. each block: ``e`` from its start, ``y`` from 0: ``Y_b``, ``A_b = prod a``;
    4. ``y_start[b+1] = A_b * y_start[b] + Y_b`` from ``y0``;
    5. each block from its starts, writing ``y`` rounded to f32.

    -> ``(y, e_last, y_last, (prod rho, prod a))`` (``max_decay=False``: the
    one-pole alone over ``h = v``; ``e_last`` and ``prod rho`` None).
    Coefficients ``[B, 1]`` or ``[B, F]``; states ``[B]``."""
    B, F = v.shape
    nb = -(-F // L)
    pad = nb * L - F

    def blocks(c, name):  # -> [B, nb, L], or [B, 1, 1] for one value a row
        t, framewise = _coef(c, v, name)
        return torch.nn.functional.pad(t, (0, pad)).reshape(B, nb, L) if framewise else t[:, :, None]

    vb, ab = torch.nn.functional.pad(v, (0, pad)).reshape(B, nb, L), blocks(a, "a")
    rb = blocks(rho, "rho") if max_decay else None
    fb = blocks(floor, "floor") if (max_decay and floor is not None) else None
    n_in = (torch.arange(nb * L, device=v.device).reshape(nb, L) < F)[None].expand(B, nb, L)  # real frames

    def col(t, k):
        return t[:, :, k] if t.shape[-1] > 1 else t[:, :, 0].expand(B, nb)

    f64 = torch.float64

    def walk(phase, e_start, y_start):
        e = torch.zeros((B, nb), dtype=f64, device=v.device) if e_start is None else e_start.clone()
        y = torch.zeros((B, nb), dtype=f64, device=v.device) if y_start is None else y_start.clone()
        prod = torch.ones((B, nb), dtype=f64, device=v.device)
        out = torch.empty((B, nb, L), dtype=torch.float32, device=v.device)
        for k in range(L):
            live = n_in[:, :, k]
            h = vb[:, :, k]
            if max_decay:
                r = col(rb, k)
                e_new = torch.maximum(r.double() * e, h.double())
                if phase == 1:
                    prod = torch.where(live, prod * r.double(), prod)
                e = torch.where(live, e_new, e)
                h = e.float() if fb is None else torch.maximum(e.float(), col(fb, k))
            if phase >= 2:
                aa = col(ab, k)
                y_new = aa.double() * y + ((1.0 - aa) * h).double()
                if phase == 2:
                    prod = torch.where(live, prod * aa.double(), prod)
                y = torch.where(live, y_new, y)
                out[:, :, k] = y.float()
        return e, y, prod, out

    def carry(init, summ, prod, kind):
        s = _state(init, v, "state").double()
        starts = torch.empty((B, nb), dtype=f64, device=v.device)
        total = torch.ones(B, dtype=f64, device=v.device)
        for b in range(nb):
            starts[:, b] = s
            d, m = prod[:, b], summ[:, b]
            s = torch.maximum(m, d * s) if kind == 0 else d * s + m
            total = total * d
        return starts, total

    e_start, prod_rho = None, None
    if max_decay:
        M, _, D, _ = walk(1, None, None)
        e_start, prod_rho = carry(e0, M, D, 0)
    _, Y, A, _ = walk(2, e_start, None)
    y_start, prod_a = carry(y0, Y, A, 1)
    e_end, y_end, _, out = walk(3, e_start, y_start)
    y = out.reshape(B, nb * L)[:, :F]
    return y, (e_end[:, -1].float() if max_decay else None), y_end[:, -1].float(), (prod_rho, prod_a)
