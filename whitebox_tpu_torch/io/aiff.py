"""AIFF / AIFF-C reader — big-endian PCM containers.

Covers the container breadth the reference gets from libsndfile
(sample.cpp:112-197): AIFF PCM 8/16/24/32-bit, and AIFC with 'NONE'
(big-endian PCM), 'sowt' (little-endian PCM, the classic Mac variant),
'fl32'/'FL32' (big-endian float32). The COMM sample rate is an 80-bit
IEEE 754 extended float, decoded exactly.

Returns the same (planar native array, WavInfo) shape as io.wav so
Sample.load_file treats every container uniformly.
"""

from __future__ import annotations

import struct

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io.wav import WavInfo


def _decode_extended80(b: bytes) -> float:
    """80-bit IEEE extended float (sign:1 exp:15 mantissa:64, explicit
    integer bit) -> Python float."""
    if len(b) != 10:
        raise ValueError("extended float must be 10 bytes")
    (se,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    if exp == 0x7FFF:
        return sign * (float("nan") if mant << 1 else float("inf"))
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


def _parse_iff_chunks(data: bytes):
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        yield cid, data[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_aiff(path_or_bytes) -> tuple[np.ndarray, WavInfo]:
    """Read an AIFF/AIFC file -> (planar native array [channels, frames], info)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if len(data) < 12 or data[0:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF/AIFC file")
    is_aifc = data[8:12] == b"AIFC"

    comm = None
    ssnd = None
    for cid, body in _parse_iff_chunks(data):
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
    if comm is None or ssnd is None:
        raise ValueError("AIFF missing COMM/SSND chunk")

    channels, frames, bits = struct.unpack_from(">hLh", comm, 0)
    rate = _decode_extended80(comm[8:18])
    compression = b"NONE"
    if is_aifc and len(comm) >= 22:
        compression = comm[18:22]

    if channels <= 0 or bits <= 0:
        raise ValueError("invalid AIFF COMM chunk")

    offset, _block = struct.unpack_from(">LL", ssnd, 0)
    pcm = ssnd[8 + offset :]

    le = compression == b"sowt"
    if compression in (b"NONE", b"sowt"):
        if bits == 8:
            # AIFF 8-bit is SIGNED (unlike WAV); widen to the i16 slot
            flat = np.frombuffer(pcm, dtype=np.int8, count=len(pcm)).astype(np.int16) << 8
            fmt = AudioFormat.I16
        elif bits == 16:
            flat = np.frombuffer(pcm, dtype="<i2" if le else ">i2", count=len(pcm) // 2).astype(np.int16)
            fmt = AudioFormat.I16
        elif bits == 24:
            raw = np.frombuffer(pcm[: (len(pcm) // 3) * 3], dtype=np.uint8).reshape(-1, 3)
            b0, b1, b2 = (raw[:, 2], raw[:, 1], raw[:, 0]) if le else (raw[:, 0], raw[:, 1], raw[:, 2])
            val = (b0.astype(np.int32) << 16) | (b1.astype(np.int32) << 8) | b2.astype(np.int32)
            flat = (val << 8) >> 8  # sign-extend 24 -> 32
            fmt = AudioFormat.I24
        elif bits == 32:
            flat = np.frombuffer(pcm, dtype="<i4" if le else ">i4", count=len(pcm) // 4).astype(np.int32)
            fmt = AudioFormat.I32
        else:
            raise ValueError(f"unsupported AIFF PCM bit depth: {bits}")
    elif compression in (b"fl32", b"FL32"):
        flat = np.frombuffer(pcm, dtype=">f4", count=len(pcm) // 4).astype(np.float32)
        fmt = AudioFormat.F32
    elif compression in (b"fl64", b"FL64"):
        flat = np.frombuffer(pcm, dtype=">f8", count=len(pcm) // 8).astype(np.float64)
        fmt = AudioFormat.F64
    else:
        raise ValueError(f"unsupported AIFC compression: {compression!r}")

    n = min(frames, flat.size // channels)
    planar = np.ascontiguousarray(flat[: n * channels].reshape(n, channels).T)
    return planar, WavInfo(channels=channels, sample_rate=int(round(rate)), count=n, format=fmt)
