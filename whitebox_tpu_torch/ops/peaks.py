"""Waveform min/max peak mipmaps — replaces gfx/waveform_visual.cpp.

Counterpart of ``whitebox_tpu/ops/peaks.py``. The reference builds, per
channel, a pyramid of (min, max) pairs over non-overlapping chunks, one
level per odd mip (block = 2^(mip-1), chunk = 2 blocks), quantized to int8
(Low) or int16 (High) with asymmetric positive/negative scaling, pairs
ordered by *occurrence* (whichever of min/max appears first in the chunk
comes first) — waveform_visual.cpp:9-248. Levels step x4 until the sample
count falls to <= 64.

Three implementations:
- ``reference_mipmaps``: NumPy scalar-faithful port (the parity oracle);
- ``io/native.py::peaks_level``: the same scalar walk in C++
  (``csrc/host/wb_peaks.cpp``), fast enough to check a long sample;
- ``build_mipmaps``: the pyramid in torch ops on a device (default: the
  CUDA card). One quantize pass, then each sample's code packed with its
  index into one int64 key per extremum, so a plain ``amin``/``amax`` over
  a chunk yields the extremum and its first occurrence together (no
  ``argmin`` tie rule is relied on); each level reduces groups of 4 keys
  of the level below, O(N * 4/3) in all. Bit-identical to the oracle.

Semantics notes (faithfully kept):
- per level, out_count = floor(N / block) rounded UP to even; chunks cover
  [0, out_count*block) — a sub-block tail is *dropped* when floor(N/block)
  is even and *included* (partial chunk) when odd;
- quantization truncates toward zero (C cast);
- first occurrence wins ties (strict < / > scans).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.session.sample import Sample

_I32_MAX = np.int32(2**31 - 1)


def _conv_ratios(src_fmt: AudioFormat, tmax: int, tmin: int, as_double: bool):
    """The reference's per-format positive/negative scale constants."""
    if src_fmt == AudioFormat.I8:
        return np.float32(tmax / 127.0), np.float32(tmin / -128.0)
    if src_fmt == AudioFormat.I16:
        return np.float32(tmax / 32767.0), np.float32(tmin / -32768.0)
    if src_fmt in (AudioFormat.I24, AudioFormat.I24_X8, AudioFormat.I32):
        # waveform_visual.cpp treats I24-in-int32 via the I32 branch (double)
        return np.float64(tmax / 2147483647.0), np.float64(tmin / -2147483648.0)
    if src_fmt == AudioFormat.F32:
        return np.float32(tmax), np.float32(-tmin)
    raise ValueError(f"unsupported peak source format {src_fmt!r}")


def _target_range(quality: str) -> tuple[int, int]:
    if quality == "low":
        return 127, -128
    if quality == "high":
        return 32767, -32768
    raise ValueError("quality must be 'low' or 'high'")


def quantize_codes(data: np.ndarray, src_fmt: AudioFormat, quality: str) -> np.ndarray:
    """Native channel data -> int32 codes in the target range (trunc toward 0).

    quality 'low' -> int8 range, 'high' -> int16 range
    (waveform_visual.cpp:188-192).
    """
    tmax, tmin = _target_range(quality)
    pos, neg = _conv_ratios(src_fmt, tmax, tmin, False)
    if src_fmt == AudioFormat.F32:
        x = np.asarray(data, dtype=np.float32)
        conv = np.where(x >= 0.0, x * pos, x * neg)
    elif src_fmt in (AudioFormat.I24, AudioFormat.I24_X8, AudioFormat.I32):
        x = np.asarray(data)
        conv = np.where(x >= 0, x.astype(np.float64) * pos, x.astype(np.float64) * neg)
    else:
        x = np.asarray(data)
        conv = np.where(x >= 0, x.astype(np.float32) * pos, x.astype(np.float32) * neg)
    # C-style trunc-toward-zero; saturate instead of UB on out-of-range floats
    return np.clip(np.trunc(conv), tmin, tmax).astype(np.int32)


def mip_levels_for(count: int) -> list[int]:
    """waveform_visual.cpp:194-243 — odd mips 1,3,5,... while count > 64."""
    levels = []
    mip = 1
    c = count
    while c > 64:
        levels.append(mip)
        c //= 4
        mip += 2
    return levels


def level_out_count(count: int, mip: int) -> int:
    block = 1 << (mip - 1)
    out = count // block
    return out + (out % 2)


@dataclass
class MipLevel:
    mip_level: int
    #: [channels, out_count] interleaved (first, second) occurrence-ordered
    #: min/max codes, int8 (low) or int16 (high)
    data: np.ndarray


@dataclass
class WaveformMipmaps:
    sample_count: int
    channels: int
    sample_rate: int
    quality: str
    levels: list[MipLevel]


def _reference_level(codes: np.ndarray, count: int, mip: int) -> np.ndarray:
    """Scalar-faithful single-level port of summarize_for_mipmaps_impl."""
    block = 1 << (mip - 1)
    chunk = 1 << mip
    out_count = level_out_count(count, mip)
    out = np.zeros(out_count, dtype=np.int32)
    for i in range(0, out_count, 2):
        idx = i * block
        chunk_length = min(chunk, count - idx)
        min_val, max_val = _I32_MAX, -_I32_MAX - 1
        min_idx = max_idx = 0
        for j in range(chunk_length):
            v = codes[idx + j]
            if v < min_val:
                min_val, min_idx = v, j
            if v > max_val:
                max_val, max_idx = v, j
        if max_idx < min_idx:
            out[i], out[i + 1] = max_val, min_val
        else:
            out[i], out[i + 1] = min_val, max_val
    return out


def reference_mipmaps(sample: Sample, quality: str = "high") -> WaveformMipmaps:
    """NumPy parity oracle (slow, scalar-faithful)."""
    out_dtype = np.int8 if quality == "low" else np.int16
    levels = []
    for mip in mip_levels_for(sample.count):
        per_ch = []
        for c in range(sample.channels):
            codes = quantize_codes(sample.data[c], sample.format, quality)
            per_ch.append(_reference_level(codes, sample.count, mip))
        levels.append(MipLevel(mip, np.stack(per_ch).astype(out_dtype)))
    return WaveformMipmaps(sample.count, sample.channels, sample.sample_rate, quality, levels)


# ---------------------------------------------------------------------------
# The pyramid in torch ops
#
# A code v at global index i packs as v * 2^IDX_BITS + i for the minimum
# and v * 2^IDX_BITS + (2^IDX_BITS - 1 - i) for the maximum: keys order
# by value first, then the earlier index wins (the smaller key for the
# minimum, the larger for the maximum). Codes are within int16, so the keys
# fit int64 for any index below 2^IDX_BITS. Past the sample's end the keys
# are sentinels that never win.
# ---------------------------------------------------------------------------

IDX_BITS = 40
_IDX_MASK = (1 << IDX_BITS) - 1
_SENT_MIN = torch.iinfo(torch.int64).max
_SENT_MAX = torch.iinfo(torch.int64).min


def quantize_codes_torch(data: torch.Tensor, src_fmt: AudioFormat, quality: str) -> torch.Tensor:
    """:func:`quantize_codes` in torch ops on ``data``'s device (the same
    f32 or f64 products, so the same codes) -> int32."""
    tmax, tmin = _target_range(quality)
    pos, neg = _conv_ratios(src_fmt, tmax, tmin, False)
    dt = torch.float64 if isinstance(pos, np.float64) else torch.float32
    x = data.to(dt)
    conv = torch.where(data >= 0, x * torch.tensor(pos, dtype=dt, device=x.device),
                       x * torch.tensor(neg, dtype=dt, device=x.device))
    return torch.clamp(torch.trunc(conv), tmin, tmax).to(torch.int32)


def _fold(keys: torch.Tensor, group: int, sentinel: int, reduce) -> torch.Tensor:
    """``keys`` [C, n] -> [C, ceil(n / group)]: ``reduce`` over each group of
    ``group`` consecutive keys, the last one padded with ``sentinel``."""
    C, n = keys.shape
    pad = -n % group
    if pad:
        keys = torch.cat([keys, keys.new_full((C, pad), sentinel)], dim=1)
    return reduce(keys.reshape(C, -1, group), dim=-1)


def _pyramid(codes: torch.Tensor, count: int, mips: list[int]) -> list[torch.Tensor]:
    """``codes`` [C, count] int32 -> per level of ``mips`` the interleaved
    occurrence-ordered pairs [C, out_count] int32."""
    C = codes.shape[0]
    idx = torch.arange(count, dtype=torch.int64, device=codes.device)
    v = codes.to(torch.int64) * (1 << IDX_BITS)
    kmin, kmax = v + idx, v + (_IDX_MASK - idx)
    outs = []
    for li, mip in enumerate(mips):
        # mip 1 folds pairs of samples, each later level 4 chunks of the one below
        group = 2 if li == 0 else 4
        kmin = _fold(kmin, group, _SENT_MIN, torch.amin)
        kmax = _fold(kmax, group, _SENT_MAX, torch.amax)
        n = level_out_count(count, mip) // 2  # chunks this level keeps (all start < count)
        lo, hi = kmin[:, :n], kmax[:, :n]
        vmin = torch.div(lo, 1 << IDX_BITS, rounding_mode="floor")
        vmax = torch.div(hi, 1 << IDX_BITS, rounding_mode="floor")
        mi = lo - vmin * (1 << IDX_BITS)
        Mi = _IDX_MASK - (hi - vmax * (1 << IDX_BITS))
        max_first = Mi < mi
        first = torch.where(max_first, vmax, vmin)
        second = torch.where(max_first, vmin, vmax)
        outs.append(torch.stack([first, second], dim=-1).reshape(C, 2 * n).to(torch.int32))
    return outs


def build_mipmaps(sample: Sample, quality: str = "high", *, device=None) -> WaveformMipmaps:
    """The peak pyramid on ``device`` (default: the CUDA card; ``"cpu"``
    runs the same torch ops), bit-identical to :func:`reference_mipmaps`."""
    dev = resolve_device(device)
    _target_range(quality)
    # the codes fit the quality's type: narrowed on the device, they cross
    # to the host in 1 or 2 bytes each
    out_dtype = torch.int8 if quality == "low" else torch.int16
    mips = mip_levels_for(sample.count)
    if not mips:
        return WaveformMipmaps(sample.count, sample.channels, sample.sample_rate, quality, [])
    data = torch.from_numpy(np.ascontiguousarray(np.stack(sample.data))).to(dev)
    codes = quantize_codes_torch(data, sample.format, quality)
    levels = [MipLevel(mip, lvl.to(out_dtype).cpu().numpy())
              for mip, lvl in zip(mips, _pyramid(codes, sample.count, mips))]
    return WaveformMipmaps(sample.count, sample.channels, sample.sample_rate, quality, levels)


def peaks_f32(data: np.ndarray, block: int) -> np.ndarray:
    """Extension: unquantized f32 (min, max) pairs over `block`-sized windows
    for display/export pipelines; [channels, n_blocks, 2]."""
    data = np.atleast_2d(np.asarray(data, dtype=np.float32))
    C, N = data.shape
    nb = -(-N // block)
    padded = np.pad(data, ((0, 0), (0, nb * block - N)), constant_values=0.0)
    r = padded.reshape(C, nb, block)
    return np.stack([r.min(axis=2), r.max(axis=2)], axis=-1)
