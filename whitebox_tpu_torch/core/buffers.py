"""Planar audio buffers and interleaved PCM conversion.

The reference's ``AudioBuffer<float>`` (src/core/audio_buffer.h) is a planar
per-channel f32 buffer; here a "buffer" is simply an ndarray shaped
``[channels, frames]`` (or ``[tracks, channels, frames]`` session-wide).
``mix`` = elementwise add (audio_buffer.h:73-82), ``clear`` = zeros.

The f32 <-> interleaved-integer converters mirror
src/core/audio_format_conv.cpp bit-for-bit (asymmetric positive/negative
scaling, C-style truncation toward zero) — they are used by the WAV codec
at the export boundary, exactly where the reference uses them at the audio
device boundary.
"""

from __future__ import annotations

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat


def make_buffer(channels: int, frames: int, tracks: int | None = None) -> np.ndarray:
    shape = (channels, frames) if tracks is None else (tracks, channels, frames)
    return np.zeros(shape, dtype=np.float32)


def interleave(planar: np.ndarray) -> np.ndarray:
    """[channels, frames] -> [frames, channels] (audio_buffer.h:143)."""
    return np.ascontiguousarray(planar.T)


def deinterleave(interleaved: np.ndarray) -> np.ndarray:
    """[frames, channels] -> [channels, frames]."""
    return np.ascontiguousarray(interleaved.T)


def tpdf_dither(x: np.ndarray, bits: int, *, highpass: bool = True,
                seed: int = 0) -> np.ndarray:
    """Add ±1 LSB TPDF dither before integer quantization (extension — the
    reference truncates, audio_format_conv.cpp:5-20, which correlates the
    quantization error with the signal at low levels).

    ``highpass=True`` uses high-passed TPDF (first difference of uniform
    noise): the same triangular amplitude density per sample, but with a
    +6 dB/oct tilt that pushes dither energy toward inaudible highs and
    guarantees zero DC. Deterministic per ``seed`` (reproducible exports).
    Returns f32; the result still needs the engine's exact converter.
    """
    x = np.asarray(x, dtype=np.float32)
    lsb = np.float32(2.0 ** (1 - bits))  # full-scale ±1.0 -> 1 LSB
    rng = np.random.default_rng(seed)
    if highpass:
        u = rng.random(size=(x.shape[0], x.shape[-1] + 1), dtype=np.float32)
        d = u[:, 1:] - u[:, :-1]  # TPDF in (-1, 1), zero mean, HF-tilted
    else:
        d = (rng.random(size=x.shape, dtype=np.float32)
             + rng.random(size=x.shape, dtype=np.float32) - np.float32(1.0))
    return x + d * lsb


def quantize_round(x: np.ndarray, bits: int) -> np.ndarray:
    """Round-to-nearest quantization with the engine's asymmetric ± scale.

    The reference converters truncate toward zero (audio_format_conv.cpp) —
    correct for parity, but truncation's signal-correlated ±0.5 LSB offset
    (a square wave in phase with the signal) defeats TPDF dither, so the
    dithered export path quantizes by rounding instead. Returns int32
    codes in the target bit depth's range (int16-ranged for bits=16)."""
    x = np.asarray(x, dtype=np.float32).astype(np.float64)
    # f64 scales: float32(2**31-1) would round UP to 2**31 and overflow
    # int32 at full scale (a +1.0 sample must quantize to +2^31-1, not wrap)
    pos = float(2 ** (bits - 1) - 1)
    neg = float(2 ** (bits - 1))
    scaled = np.where(x > 0.0, x * pos, x * neg)
    return np.clip(np.rint(scaled), -neg, pos).astype(np.int64).astype(np.int32)


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    """audio_format_conv.cpp:5-20 — f32 * (pos ? 32767 : 32768), trunc."""
    x = np.asarray(x, dtype=np.float32)
    scaled = np.where(x > 0.0, x * np.float32(32767.0), x * np.float32(32768.0))
    return np.trunc(scaled).astype(np.int64).astype(np.int16)


def f32_to_i24(x: np.ndarray) -> np.ndarray:
    """audio_format_conv.cpp:22-43 — returns int32 codes in [-2^23, 2^23-1]."""
    x = np.asarray(x, dtype=np.float32)
    scaled = np.where(x > 0.0, x * np.float32(8388607.0), x * np.float32(8388608.0))
    return np.trunc(scaled).astype(np.int64).astype(np.int32)


def f32_to_i32(x: np.ndarray) -> np.ndarray:
    """audio_format_conv.cpp:64-79 — f64 scaling, trunc to int32."""
    x = np.asarray(x, dtype=np.float32)
    xd = x.astype(np.float64)
    scaled = np.where(x > 0.0, xd * 2147483647.0, xd * 2147483648.0)
    # C cast of out-of-range double->int32 is UB; the engine hard-clips to
    # [-1, 1] before export so codes stay in range. Saturate for safety.
    return np.clip(np.trunc(scaled), -2147483648.0, 2147483647.0).astype(np.int64).astype(np.int32)


def to_pcm(x: np.ndarray, fmt: AudioFormat) -> np.ndarray:
    if fmt == AudioFormat.I16:
        return f32_to_i16(x)
    if fmt in (AudioFormat.I24, AudioFormat.I24_X8):
        return f32_to_i24(x)
    if fmt == AudioFormat.I32:
        return f32_to_i32(x)
    if fmt == AudioFormat.F32:
        return np.asarray(x, dtype=np.float32)
    raise ValueError(f"unsupported PCM export format {fmt!r}")


def i24_codes_to_bytes(codes: np.ndarray) -> bytes:
    """Pack int32 24-bit codes into little-endian 3-byte triplets."""
    codes = codes.astype(np.int32)
    flat = codes.reshape(-1)
    out = np.empty((flat.size, 3), dtype=np.uint8)
    u = flat.view(np.uint32) if flat.dtype == np.int32 else flat.astype(np.uint32)
    out[:, 0] = (u & 0xFF).astype(np.uint8)
    out[:, 1] = ((u >> 8) & 0xFF).astype(np.uint8)
    out[:, 2] = ((u >> 16) & 0xFF).astype(np.uint8)
    return out.tobytes()


def i24_bytes_to_codes(raw: bytes | np.ndarray) -> np.ndarray:
    """Unpack little-endian 3-byte triplets into sign-extended int32 codes."""
    b = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    b = b.reshape(-1, 3).astype(np.uint32)
    u = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    signed = u.astype(np.int32)
    signed = np.where(signed >= (1 << 23), signed - (1 << 24), signed)
    return signed.astype(np.int32)
