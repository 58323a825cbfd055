"""FFT-FIR effects finishing: the high-throughput alternative to the scan
cascade (``render/effects_pipeline.py``).

Counterpart of ``whitebox_tpu/render/effects_fir.py``. Every chain this
finisher takes is LTI, so the host collapses each one into one impulse
response (closed-form biquad impulses in f64, truncated where the tail
falls below -120 dBFS) and the device convolves the per-track buffers with
it by overlap-save FFT. The host half (IR construction and the tables) is
NumPy and gives the JAX package's arrays bit for bit; the device half is
``torch.fft``, a library call as ``jnp.fft`` is in the JAX package (it
stands in for an XLA op, not for a Pallas kernel).

Accuracy: the truncation is bounded by the tail threshold (1e-6, about
-120 dB); f32 FFT rounding is ~1e-6 relative. ``bounce`` takes this path
with ``effects_mode="fir"``; the scan stays the default.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.effects import Biquad, EffectChain, Gain, ParametricEQ
from whitebox_tpu_torch.ops.biquad import biquad_sequential
from whitebox_tpu_torch.ops.mix import _clip, _ordered_sum
from whitebox_tpu_torch.render.effects_pipeline import _chains_of, _frame_gains, prepare_automation_tables


def _biquad_impulse(c, length: int) -> np.ndarray:
    """Length-``length`` impulse response of one biquad section, f64.

    Closed form by the denominator poles: for 1/(1 + a1 z^-1 + a2 z^-2)
    with poles p1, p2, g[n] = (p1^{n+1} - p2^{n+1}) / (p1 - p2) (repeated
    pole: (n+1) p^n), then the numerator [b0 b1 b2] as a 3-tap
    convolution."""
    a1, a2 = float(c.a1), float(c.a2)
    disc = complex(a1 * a1 - 4.0 * a2) ** 0.5
    p1 = (-a1 + disc) / 2.0
    p2 = (-a1 - disc) / 2.0
    if max(abs(p1), abs(p2)) >= 1.0 + 1e-12:
        # unstable section: the literal recursion
        x = np.zeros((1, length), dtype=np.float64)
        x[0, 0] = 1.0
        y, _ = biquad_sequential(x, c)
        return y[0]
    n = np.arange(length, dtype=np.float64)
    if abs(p1 - p2) > 1e-10 * max(abs(p1), abs(p2), 1.0):
        g = ((p1 ** (n + 1) - p2 ** (n + 1)) / (p1 - p2)).real
    else:
        g = ((n + 1) * p1**n).real
    h = float(c.b0) * g
    h[1:] += float(c.b1) * g[:-1]
    h[2:] += float(c.b2) * g[:-2]
    return h


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _fftconv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = a.shape[0] + b.shape[0] - 1
    nf = _next_pow2(n)
    return np.fft.irfft(np.fft.rfft(a, nf) * np.fft.rfft(b, nf), nf)[:n]


def chain_impulse_response(chain, sample_rate: float, tail_thresh: float = 1e-6,
                           max_len: int = 1 << 16) -> np.ndarray:
    """Combined IR of a prepared LTI chain (f64, truncated at the tail
    threshold) -> f32. Memoized on the chain, keyed by its coefficients."""
    gain = 1.0
    sections = []
    effs = chain.effects if isinstance(chain, EffectChain) else list(chain or [])
    for e in effs:
        if isinstance(e, Gain):
            gain *= float(e.gain_linear)
        elif isinstance(e, Biquad):
            assert e.coeffs is not None, "effect not prepared"
            sections.append(e.coeffs)
        elif isinstance(e, ParametricEQ):
            assert e.coeffs, "effect not prepared"
            sections.extend(e.coeffs)
        else:
            raise TypeError(f"effect {e!r} has no LTI form")

    key = (float(sample_rate), float(tail_thresh), gain,
           tuple((float(c.b0), float(c.b1), float(c.b2), float(c.a1), float(c.a2)) for c in sections))
    cached = getattr(chain, "_ir_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    length = 1024
    while True:
        h = np.zeros(length, dtype=np.float64)
        h[0] = gain
        for c in sections:
            h = _fftconv(h, _biquad_impulse(c, length))[:length]
        tail = np.abs(h[-length // 8:]).max()
        if tail < tail_thresh or length >= max_len:
            break
        length *= 2
    # trim to the last sample above threshold
    nz = np.nonzero(np.abs(h) >= tail_thresh)[0]
    n = int(nz[-1]) + 1 if nz.size else 1
    h32 = h[:n].astype(np.float32)
    try:
        chain._ir_cache = (key, h32)
    except AttributeError:
        pass  # plain lists of effects can't carry the cache
    return h32


def _prepared_irs(session, sample_rate: float, channels: int):
    """(per-track IRs f64, one per track (``[1.0]`` without a chain),
    master IR f64 or None)."""
    chains, master = _chains_of(session)
    irs = []
    for c in chains:
        if c is None:
            irs.append(np.ones(1, dtype=np.float64))
        else:
            c.prepare(sample_rate, channels)
            irs.append(chain_impulse_response(c, sample_rate).astype(np.float64))
    master_h = None
    if master is not None:
        master.prepare(sample_rate, channels)
        master_h = chain_impulse_response(master, sample_rate).astype(np.float64)
    return irs, master_h


def prepare_fir_tables(session, sample_rate: float, channels: int = 2):
    """Per-track + master IRs -> ``(h_rows [T*C, Lh] f32, master_h [Lm] f32
    or None)``."""
    irs, master_h = _prepared_irs(session, sample_rate, channels)
    T = len(irs)
    Lh = max(h.shape[0] for h in irs)
    h_rows = np.zeros((T * channels, Lh), dtype=np.float32)
    for t, h in enumerate(irs):
        for c in range(channels):
            h_rows[t * channels + c, : h.shape[0]] = h
    return h_rows, None if master_h is None else master_h.astype(np.float32)


def prepare_fir_tables_spectral(session, sample_rate: float, track_gain, channels: int = 2) -> np.ndarray:
    """Fold the master IR and the constant per-(track, channel) gains into
    the per-track IRs: conv(sum_t g_t x_t * h_t, h_m) == sum_t x_t * (g_t
    h_t * h_m), everything being LTI. ``track_gain`` ``[T, C]``. Returns
    h_rows ``[T*C, Lh]`` f32."""
    if isinstance(track_gain, torch.Tensor):
        track_gain = track_gain.cpu().numpy()
    tg = np.asarray(track_gain, dtype=np.float64)
    irs, master_h = _prepared_irs(session, sample_rate, channels)
    T = len(irs)
    Lt = max(h.shape[0] for h in irs)
    hs = np.zeros((T, Lt), dtype=np.float64)
    for t, h in enumerate(irs):
        hs[t, : h.shape[0]] = h
    if master_h is not None:
        # the master IR into every track IR in one batched FFT conv
        n = Lt + master_h.shape[0] - 1
        nf = _next_pow2(n)
        hs = np.fft.irfft(np.fft.rfft(hs, nf, axis=1) * np.fft.rfft(master_h, nf), nf, axis=1)[:, :n]
        keep = np.abs(hs).max(axis=0) >= 1e-6
        nz = np.nonzero(keep)[0]
        hs = hs[:, : int(nz[-1]) + 1] if nz.size else hs[:, :1]
    h_rows = (hs[:, None, :] * tg[:, :channels, None]).astype(np.float32)
    return h_rows.reshape(T * channels, hs.shape[1])


#: f32 elements of one batch of overlap-save windows (~256 MB)
_WINDOW_BATCH = 64 << 20


def _overlap_save(x: torch.Tensor, h: torch.Tensor, B: int) -> torch.Tensor:
    """Causal linear convolution of x ``[R, F]`` with h ``[R, Lh]`` by
    overlap-save rFFT windows of ``B`` frames -> ``[R, F]``. The JAX
    package scans the windows one by one; here they go in batches of
    ``_WINDOW_BATCH`` elements."""
    R, F = x.shape
    Lh = h.shape[1]
    H = B - (Lh - 1)
    n_blocks = -(-F // H)
    xp = torch.nn.functional.pad(x, (Lh - 1, n_blocks * H - F))
    Hf = torch.fft.rfft(torch.nn.functional.pad(h, (0, B - Lh)), dim=1)[:, None, :]
    wins = xp.unfold(1, B, H)  # [R, n_blocks, B], window i = xp[:, i*H : i*H + B]
    G = max(1, _WINDOW_BATCH // max(R * B, 1))
    ys = []
    for g0 in range(0, n_blocks, G):
        Y = torch.fft.rfft(wins[:, g0:g0 + G], dim=-1) * Hf
        ys.append(torch.fft.irfft(Y, n=B, dim=-1)[:, :, Lh - 1:])
    return torch.cat(ys, dim=1).reshape(R, n_blocks * H)[:, :F]


def finish_mix_fir_spectral(per_track, h_rows, *, T, C, B, G):
    """per_track ``[T, C, F]`` -> ``[C, F]`` in one overlap-save sweep.

    Windows go G at a time as one batched rFFT, and the track sum happens
    in the frequency domain (in track order), so only ``[C, G, B]`` comes
    back through the inverse FFT and the filtered ``[T, C, F]`` never
    exists. Needs the master IR and constant gains folded into ``h_rows``
    (:func:`prepare_fir_tables_spectral`)."""
    F = per_track.shape[-1]
    R = T * C
    Lh = h_rows.shape[1]
    H = B - (Lh - 1)
    assert Lh - 1 <= H, "IR longer than hop; raise B"
    n_blocks = -(-F // H)
    n_groups = -(-n_blocks // G)
    x = per_track.reshape(R, F)
    # window j = xp[j*H : j*H + B] = chunk j (H wide) ++ the head of chunk
    # j+1 (Lh-1 wide); its valid circular-conv samples are frames
    # [j*H, (j+1)*H). One trailing chunk so the last head exists.
    n_chunks = n_groups * G + 1
    xp = torch.nn.functional.pad(x, (Lh - 1, n_chunks * H - F - (Lh - 1)))
    Hf = torch.fft.rfft(torch.nn.functional.pad(h_rows, (0, B - Lh)), dim=1)  # [R, K]
    chunks = xp.reshape(R, n_chunks, H)
    ys = []
    for gi in range(n_groups):
        cur = chunks[:, gi * G:(gi + 1) * G]  # [R, G, H]
        nxt = chunks[:, gi * G + 1:(gi + 1) * G + 1, : Lh - 1]
        segs = torch.cat([cur, nxt], dim=-1)  # [R, G, B]
        Yf = torch.fft.rfft(segs, dim=-1) * Hf[:, None, :]
        Ys = _ordered_sum(Yf.reshape(T, C, G, -1))  # [C, G, K], the spectral track sum
        ys.append(torch.fft.irfft(Ys, n=B, dim=-1)[:, :, Lh - 1:])  # [C, G, H]
    total = torch.cat(ys, dim=1).reshape(C, n_groups * G * H)[:, :F]
    return _clip(total)


def finish_mix_fir(per_track, h_rows, master_h, track_gain, auto=None, *, T, C, B, Bm):
    """per_track ``[T, C, F]`` -> ``[C, F]``: per-track IR convolution,
    per-frame gains, ordered sum, master IR convolution, hard clip."""
    F = per_track.shape[-1]
    y = _overlap_save(per_track.reshape(T * C, F), h_rows, B).reshape(T, C, F)
    g = torch.arange(F, dtype=torch.int32, device=per_track.device)
    total = _ordered_sum(y * _frame_gains(auto, track_gain, g, T, C))
    if master_h is not None:
        total = _overlap_save(total, torch.broadcast_to(master_h, (C, master_h.shape[-1])), Bm)
    return _clip(total)


def prepare_fir_finish(session, sample_rate: float, track_gain, auto, channels: int = 2, device="cpu"):
    """One-time host preparation (chain IRs -> tensors on ``device``);
    returns ``finish(per_track) -> [C, F]``, whose calls are device work.

    Constant-gain sessions take the spectral path (master and gains folded
    into the IRs, batched windows, frequency-domain track sum); per-frame
    gains (automation lanes) take the general path. ``track_gain`` is the
    plan's ``[T, C]`` f32 gains, as a tensor on ``device``."""
    T = len(session.tracks)
    if auto is None:
        h_rows = prepare_fir_tables_spectral(session, sample_rate, track_gain, channels)
        Lh = h_rows.shape[1]
        B = max(4096, _next_pow2(4 * Lh))
        R = T * channels
        # bound the [R, G, B] window batch to ~256 MB of f32
        G = int(max(1, min((64 << 20) // max(R * B, 1), 64)))
        hj = torch.from_numpy(h_rows).to(device)
        return lambda per_track: finish_mix_fir_spectral(per_track, hj, T=T, C=channels, B=B, G=G)

    h_rows, master_h = prepare_fir_tables(session, sample_rate, channels)
    B = max(_next_pow2(2 * h_rows.shape[1]), 4096)
    Bm, mh = 4096, None
    if master_h is not None:
        Bm = max(_next_pow2(2 * master_h.shape[0]), 4096)
        mh = torch.from_numpy(master_h).to(device)
    hj = torch.from_numpy(h_rows).to(device)
    return lambda per_track: finish_mix_fir(per_track, hj, mh, track_gain, auto, T=T, C=channels,
                                            B=B, Bm=Bm)


class FirFinisher:
    """The FIR family (``render/finisher.py`` sets out the shape): a whole
    buffer in one step (``chunk`` None) through :func:`prepare_fir_finish`;
    the mix form only, without meters (the spectral sum never holds
    per-track audio) and without PDC (its chains have no latency)."""

    chunk = None
    fixed = False
    trim = 0
    ahead = ()

    def __init__(self, session, sample_rate: float, track_gain, *, form="mix", meters=False, pdc=False,
                 chunk=None, max_chunk=None, device="cpu"):
        if form != "mix" or meters:
            raise ValueError("the FIR finisher renders the mix of a whole buffer, without meters")
        auto = prepare_automation_tables(session, sample_rate, device=device)
        self._finish = prepare_fir_finish(session, sample_rate, track_gain, auto, track_gain.shape[1], device=device)

    def init(self):
        return ()

    def step(self, x, states, start: int, valid=None):
        return self._finish(x), states, None
