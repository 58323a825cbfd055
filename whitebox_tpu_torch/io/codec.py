"""Compressed audio decode/encode through the codec runtime.

Counterpart of ``whitebox_tpu/io/codec.py``. Parity: Sample::load_mp3_file /
load_ogg_vorbis_file (the reference's src/dsp/sample.cpp:207-320) decode
MP3 via dr_mp3 and Ogg Vorbis via stb_vorbis into f32 PCM. The runtime
(``csrc/host/codec/wb_codec.cpp``, a copy of the JAX package's
``native/wb_codec.cpp``) links the system codec stack
(libavformat/libavcodec/libswresample) for the same breadth — MP3, Ogg
Vorbis and FLAC — returning planar f32.

The port builds it at first use with ``g++`` into
``build/host/<hash>/`` (``buildlib``) and never loads the JAX package's
``native/libwbcodec.so``. Where the build or the load fails (no ``g++``,
no libav headers or libraries), :func:`load` returns None and
:func:`read_compressed` / :func:`write_compressed` raise ``RuntimeError``
naming what is missing; WAV and AIFF do not need the runtime.

Encode (`write_compressed`) extends the reference's export stub to
compressed containers chosen by extension.
"""

from __future__ import annotations

import ctypes
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from whitebox_tpu_torch import buildlib
from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io.wav import WavInfo


@dataclass(frozen=True)
class EncodeOptions:
    """Compressed-export properties (ExportAudioProperties parity,
    the reference's src/engine/export_prop.h:8-45).

    ``bitrate_mode``: "cbr" | "abr" | "vbr" (ExportBitrateMode).
    ``bitrate``: kbps target for CBR/ABR (mp3_bitrate / vorbis_bitrate).
    ``min_bitrate`` / ``max_bitrate``: ABR bounds in kbps. NOTE: for mp3
    these are honored by Vorbis managed mode only — FFmpeg's libmp3lame
    wrapper doesn't expose LAME's ABR min/max bounds (it reads bit_rate +
    the "abr" priv option), so the bounds are best-effort there.
    ``vbr_quality``: 0..100, 100 = best (mp3_vbr_quality semantics).
    ``flac_compression_level``: 0..12, -1 = encoder default.
    ``bit_depth``: 0 = reference default (FLAC: 16-bit, export_prop.h:43);
    16/24/32 select the FLAC stored depth (24 = s32 input with
    bits_per_raw_sample=24).
    ``title``/``artist``/``comment``: container tags (export_metadata).
    """

    bitrate_mode: str = "cbr"
    bitrate: int = 192
    min_bitrate: int = 0
    max_bitrate: int = 0
    vbr_quality: float = 100.0
    flac_compression_level: int = -1
    bit_depth: int = 0
    title: str | None = None
    artist: str | None = None
    comment: str | None = None

    MODES = ("cbr", "abr", "vbr")

    def __post_init__(self):
        if self.bitrate_mode not in self.MODES:
            raise ValueError(f"bitrate_mode {self.bitrate_mode!r} (want cbr/abr/vbr)")
        if not (0.0 <= self.vbr_quality <= 100.0):
            raise ValueError(f"vbr_quality {self.vbr_quality} (want 0..100)")
        if not (-1 <= self.flac_compression_level <= 12):
            raise ValueError(
                f"flac_compression_level {self.flac_compression_level} (want -1..12)")
        for name in ("bitrate", "min_bitrate", "max_bitrate"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"{name} {v} kbps (want >= 0)")
        if self.bit_depth not in (0, 16, 24, 32):
            raise ValueError(f"bit_depth {self.bit_depth} (want 0/16/24/32)")


class _WbEncodeOpts(ctypes.Structure):
    _fields_ = [
        ("bitrate_mode", ctypes.c_int32),
        ("bitrate_kbps", ctypes.c_int32),
        ("min_bitrate_kbps", ctypes.c_int32),
        ("max_bitrate_kbps", ctypes.c_int32),
        ("vbr_quality", ctypes.c_float),
        ("flac_compression_level", ctypes.c_int32),
        ("bit_depth", ctypes.c_int32),
        ("title", ctypes.c_char_p),
        ("artist", ctypes.c_char_p),
        ("comment", ctypes.c_char_p),
    ]


CODEC_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "codec" / "wb_codec.cpp"
LIB_NAME = "libwbtorch_codec.so"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
#: the system libraries the runtime links (its headers come with them)
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")

_LIB: ctypes.CDLL | None = None
_TRIED = False
#: why :func:`load` found no runtime (None while it has not failed)
load_error: str | None = None


def load() -> ctypes.CDLL | None:
    """Build (if needed) and load the codec runtime once per process; None
    when it is unavailable (:data:`load_error` says why)."""
    global _LIB, _TRIED, load_error
    if _TRIED:
        return _LIB
    _TRIED = True
    cxx = shutil.which("g++")
    if cxx is None:
        load_error = "no g++ to build csrc/host/codec/wb_codec.cpp"
        return None
    try:
        so, _ = buildlib.build_shared(cxx, CXX_FLAGS, [CODEC_SOURCE], "host", LIB_NAME, libs=LIBS)
        lib = ctypes.CDLL(str(so))
    except (RuntimeError, OSError) as e:
        detail = next((ln.strip() for ln in str(e).splitlines() if "error" in ln.lower()),
                      str(e).splitlines()[0] if str(e) else type(e).__name__)
        load_error = ("building or loading csrc/host/codec/wb_codec.cpp against libavformat, "
                      f"libavcodec, libavutil and libswresample failed: {detail}")
        return None

    lib.wb_codec_decode_f32.restype = ctypes.c_int32
    lib.wb_codec_decode_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wb_codec_free.restype = None
    lib.wb_codec_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.wb_codec_encode_f32.restype = ctypes.c_int32
    lib.wb_codec_encode_f32.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.wb_codec_encode_f32_opts.restype = ctypes.c_int32
    lib.wb_codec_encode_f32_opts.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_WbEncodeOpts),
    ]
    _LIB = lib
    return _LIB


def _require(what: str) -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"compressed audio {what} needs the codec runtime: {load_error}")
    return lib


def read_compressed(path) -> tuple[np.ndarray, WavInfo]:
    """Decode MP3/Ogg/FLAC/... -> (planar f32 [channels, frames], info)."""
    lib = _require("decode")
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    rc = lib.wb_codec_decode_f32(str(path).encode(), ctypes.byref(out),
                                 ctypes.byref(frames), ctypes.byref(channels), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"failed to decode {path!s} (native codec rc={rc})")
    try:
        n = frames.value * channels.value
        flat = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.wb_codec_free(out)
    planar = np.ascontiguousarray(flat.reshape(frames.value, channels.value).T)
    return planar, WavInfo(channels=channels.value, sample_rate=rate.value,
                           count=frames.value, format=AudioFormat.F32)


def write_compressed(path, planar: np.ndarray, sample_rate: int,
                     options: EncodeOptions | None = None) -> None:
    """Encode planar f32 [C, F] to .mp3/.ogg/.flac (by extension).

    ``options`` carries the reference's export properties (bitrate modes,
    VBR quality, FLAC depth/level, metadata tags — export_prop.h:14-45);
    None keeps the historical default (CBR 192 kbps, no tags).
    """
    lib = _require("encode")
    planar = np.atleast_2d(np.asarray(planar, dtype=np.float32))
    inter = np.ascontiguousarray(planar.T).reshape(-1)
    if options is None:
        rc = lib.wb_codec_encode_f32(str(path).encode(), inter,
                                     planar.shape[1], planar.shape[0], int(sample_rate))
    else:
        c = _WbEncodeOpts(
            bitrate_mode=EncodeOptions.MODES.index(options.bitrate_mode),
            bitrate_kbps=int(options.bitrate),
            min_bitrate_kbps=int(options.min_bitrate),
            max_bitrate_kbps=int(options.max_bitrate),
            vbr_quality=float(options.vbr_quality),
            flac_compression_level=int(options.flac_compression_level),
            bit_depth=int(options.bit_depth),
            title=None if options.title is None else options.title.encode(),
            artist=None if options.artist is None else options.artist.encode(),
            comment=None if options.comment is None else options.comment.encode(),
        )
        rc = lib.wb_codec_encode_f32_opts(str(path).encode(), inter,
                                          planar.shape[1], planar.shape[0], int(sample_rate),
                                          ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"failed to encode {path!s} (native codec rc={rc})")


def read_mp3(path) -> tuple[np.ndarray, WavInfo]:
    """MP3 decode (Sample::load_mp3_file parity, sample.cpp:207-261)."""
    return read_compressed(path)
