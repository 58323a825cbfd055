"""RIFF/WAVE codec: PCM 16/24/32-bit and IEEE float32, read & write.

The reference decodes via libsndfile (src/dsp/sample.cpp:112-197) keeping
samples in their *native* format (no up-front f32 conversion) — we do the
same so the playback path can reproduce the engine's on-the-fly
normalization semantics exactly. Writing uses the engine's own f32->PCM
converters (src/core/audio_format_conv.cpp, see core.buffers).
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass

import numpy as np

from whitebox_tpu_torch.core import buffers
from whitebox_tpu_torch.core.formats import AudioFormat

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    channels: int
    sample_rate: int
    count: int  # frames per channel
    format: AudioFormat


def _parse_chunks(data: bytes):
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        yield cid, body
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _decode_fmt(body: bytes):
    tag, channels, rate, _, block_align, bits = struct.unpack_from("<HHIIHH", body, 0)
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        if len(body) < 40:
            raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        (sub_tag,) = struct.unpack_from("<H", body, 24)
        tag = sub_tag
    return tag, channels, rate, block_align, bits


def read_wav(path_or_bytes) -> tuple[np.ndarray, WavInfo]:
    """Read a WAV file -> (planar native-format array [channels, frames], info)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    fmt_info = None
    pcm = None
    for cid, body in _parse_chunks(data):
        if cid == b"fmt ":
            fmt_info = _decode_fmt(body)
        elif cid == b"data":
            pcm = body
    if fmt_info is None or pcm is None:
        raise ValueError("WAV missing fmt/data chunk")

    tag, channels, rate, block_align, bits = fmt_info
    if channels <= 0:
        raise ValueError("invalid channel count")

    if tag == _WAVE_FORMAT_PCM and bits == 16:
        fmt = AudioFormat.I16
        flat = np.frombuffer(pcm, dtype="<i2", count=len(pcm) // 2)
    elif tag == _WAVE_FORMAT_PCM and bits == 24:
        fmt = AudioFormat.I24
        usable = (len(pcm) // 3) * 3
        flat = buffers.i24_bytes_to_codes(pcm[:usable])
    elif tag == _WAVE_FORMAT_PCM and bits == 32:
        fmt = AudioFormat.I32
        flat = np.frombuffer(pcm, dtype="<i4", count=len(pcm) // 4)
    elif tag == _WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        fmt = AudioFormat.F32
        flat = np.frombuffer(pcm, dtype="<f4", count=len(pcm) // 4)
    elif tag == _WAVE_FORMAT_IEEE_FLOAT and bits == 64:
        fmt = AudioFormat.F64
        flat = np.frombuffer(pcm, dtype="<f8", count=len(pcm) // 8)
    else:
        raise ValueError(f"unsupported WAV encoding: tag={tag:#x} bits={bits}")

    frames = flat.size // channels
    planar = np.ascontiguousarray(flat[: frames * channels].reshape(frames, channels).T)
    return planar, WavInfo(channels=channels, sample_rate=rate, count=frames, format=fmt)


def write_wav(path, planar: np.ndarray, sample_rate: int, fmt: AudioFormat = AudioFormat.F32,
              *, dither: str | None = None) -> None:
    """Write planar audio [channels, frames] to a WAV file.

    f32 input is converted with the engine's exact converters
    (audio_format_conv.cpp semantics) when an integer format is requested.
    Native integer input of the matching format passes through untouched.

    ``dither``: None (reference truncation), "tpdf" (white ±1 LSB TPDF) or
    "tpdf-hp" (high-passed TPDF, recommended for 16-bit masters) — applied
    to float input before integer conversion, hard-clipped back to ±1.
    """
    planar = np.atleast_2d(np.asarray(planar))
    channels, frames = planar.shape

    if dither and fmt != AudioFormat.F32 and planar.dtype.kind == "f":
        from whitebox_tpu_torch.core.buffers import quantize_round, tpdf_dither

        bits = {AudioFormat.I16: 16, AudioFormat.I24: 24, AudioFormat.I24_X8: 24,
                AudioFormat.I32: 32}[fmt]
        if dither not in ("tpdf", "tpdf-hp"):
            raise ValueError(f"dither {dither!r} (want 'tpdf' or 'tpdf-hp')")
        dithered = np.clip(tpdf_dither(planar, bits, highpass=dither == "tpdf-hp"),
                           -1.0, 1.0).astype(np.float32)
        # rounding quantization: truncation would re-correlate the error
        # with the signal and defeat the dither (see quantize_round)
        codes = quantize_round(dithered, bits)
        planar = codes.astype(np.int16) if fmt == AudioFormat.I16 else codes

    if fmt == AudioFormat.F32:
        inter = buffers.interleave(planar.astype(np.float32, copy=False))
        body = inter.astype("<f4").tobytes()
        tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    elif fmt == AudioFormat.I16:
        if planar.dtype == np.int16:
            inter = buffers.interleave(planar)
        else:
            inter = buffers.interleave(buffers.f32_to_i16(planar))
        body = inter.astype("<i2").tobytes()
        tag, bits = _WAVE_FORMAT_PCM, 16
    elif fmt in (AudioFormat.I24, AudioFormat.I24_X8):
        codes = planar if planar.dtype == np.int32 else buffers.f32_to_i24(planar)
        body = buffers.i24_codes_to_bytes(buffers.interleave(codes))
        tag, bits = _WAVE_FORMAT_PCM, 24
    elif fmt == AudioFormat.I32:
        if planar.dtype == np.int32:
            inter = buffers.interleave(planar)
        else:
            inter = buffers.interleave(buffers.f32_to_i32(planar))
        body = inter.astype("<i4").tobytes()
        tag, bits = _WAVE_FORMAT_PCM, 32
    else:
        raise ValueError(f"unsupported WAV export format {fmt!r}")

    byte_rate = sample_rate * channels * (bits // 8)
    block_align = channels * (bits // 8)
    out = _io.BytesIO()
    out.write(b"RIFF")
    out.write(struct.pack("<I", 4 + 8 + 16 + 8 + len(body) + (len(body) & 1)))
    out.write(b"WAVE")
    out.write(b"fmt " + struct.pack("<IHHIIHH", 16, tag, channels, sample_rate, byte_rate, block_align, bits))
    out.write(b"data" + struct.pack("<I", len(body)))
    out.write(body)
    if len(body) & 1:
        out.write(b"\x00")

    blob = out.getvalue()
    if hasattr(path, "write"):
        path.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


def load_audio_file(path) -> tuple[np.ndarray, WavInfo]:
    """Load an audio file by container sniffing.

    Mirrors Sample::load_file's format dispatch (sample.cpp:112): WAV and
    AIFF/AIFC decode in Python (``io/aiff.py``); MP3, Ogg Vorbis and FLAC
    through the codec runtime (``io/codec.py``; the reference decodes MP3
    and Vorbis with dr_mp3 and stb_vorbis, sample.cpp:207-320, and stubs
    FLAC, sample.cpp:263).
    """
    p = str(path)
    with open(p, "rb") as f:
        head = f.read(12)
    low = p.lower()
    if low.endswith((".wav", ".wave")) or (head[:4] == b"RIFF" and head[8:12] == b"WAVE"):
        return read_wav(p)
    if low.endswith((".aif", ".aiff", ".aifc")) or (head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC")):
        from whitebox_tpu_torch.io.aiff import read_aiff

        return read_aiff(p)
    if (
        low.endswith((".mp3", ".ogg", ".oga", ".flac", ".m4a", ".opus"))
        or head[:3] == b"ID3"
        or head[:4] in (b"OggS", b"fLaC")
        or (len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0)
    ):
        from whitebox_tpu_torch.io.codec import read_compressed

        return read_compressed(p)
    raise ValueError(f"unsupported audio container: {p}")
