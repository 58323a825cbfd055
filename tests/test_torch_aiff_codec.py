"""The port's ``io/aiff.py`` and ``io/codec.py`` against the JAX package's
(CPU).

The cases of ``tests/test_codec.py`` on the port. AIFF/AIFC decode
bit-equal to the JAX package's reader (16-bit through the generic loader
and ``Sample``, little-endian ``sowt``, ``fl32``, 24-bit, the 80-bit
rates). The codec runtime is built from ``csrc/host/codec/wb_codec.cpp``;
its cases skip only where that build fails (no libav headers or
libraries). A FLAC it writes is the JAX package's file byte for byte (same
source, same libraries; Ogg streams carry a random serial, so lossy files
are held by what they decode to), decodes to what the JAX package's
decoder gives, and the encode options (CBR/VBR/ABR, Vorbis quality, FLAC
level and depth, tags) act as there. Where the runtime cannot load, the
codec raises an error naming the libraries and WAV/AIFF still load.
"""

import struct
import warnings

import numpy as np
import pytest

from whitebox_tpu.io import aiff as jax_aiff
from whitebox_tpu.io import codec as jax_codec
from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io import codec as codec_mod
from whitebox_tpu_torch.io.aiff import _decode_extended80, read_aiff
from whitebox_tpu_torch.io.wav import load_audio_file
from whitebox_tpu_torch.session.sample import Sample


def _aiff(comm_fields, rate_hex, ssnd_body, compression=None):
    comm = struct.pack(">hLh", *comm_fields) + bytes.fromhex(rate_hex)
    if compression is not None:
        comm += compression + b"\x00\x00"
    ssnd = struct.pack(">LL", 0, 0) + ssnd_body
    kind = b"AIFC" if compression is not None else b"AIFF"
    body = kind + b"COMM" + struct.pack(">I", len(comm)) + comm + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    return b"FORM" + struct.pack(">I", len(body)) + body


def _both(data):
    got, info = read_aiff(data)
    want, winfo = jax_aiff.read_aiff(data)
    assert (info.channels, info.sample_rate, info.count, info.format.name) == \
        (winfo.channels, winfo.sample_rate, winfo.count, winfo.format.name)
    np.testing.assert_array_equal(got, want)
    return got, info


def test_extended80_sample_rates():
    for rate, b in [(44100, "400EAC44000000000000"), (48000, "400EBB80000000000000"),
                    (22050, "400DAC44000000000000")]:
        assert _decode_extended80(bytes.fromhex(b)) == float(rate) == jax_aiff._decode_extended80(bytes.fromhex(b))


def test_round_trip_16bit_through_loader_and_sample(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc

    planar = np.random.default_rng(0).integers(-32768, 32768, size=(2, 5000)).astype(np.int16)
    p = tmp_path / "x.aiff"
    f = aifc.open(str(p), "wb")
    f.setnchannels(2)
    f.setsampwidth(2)
    f.setframerate(44100)
    f.writeframes(np.ascontiguousarray(planar.T).astype(">i2").tobytes())
    f.close()
    got, info = _both(p.read_bytes())
    assert info.format == AudioFormat.I16 and info.sample_rate == 44100
    np.testing.assert_array_equal(got, planar)
    np.testing.assert_array_equal(load_audio_file(p)[0], planar)
    s = Sample.load_file(p)
    assert s.count == 5000 and s.channels == 2


@pytest.mark.parametrize("kind", ["sowt", "fl32", "i24"])
def test_aifc_variants(kind):
    if kind == "sowt":  # little-endian PCM, the classic Mac variant
        planar = np.array([[100, -200, 30000, -30000]], dtype=np.int16)
        data = _aiff((1, 4, 16), "400EAC44000000000000", planar.T.astype("<i2").tobytes(), b"sowt")
        fmt = AudioFormat.I16
    elif kind == "fl32":
        planar = np.array([[0.5, -0.25, 1.0, -1.0]], dtype=np.float32)
        data = _aiff((1, 4, 32), "400EBB80000000000000", planar.T.astype(">f4").tobytes(), b"fl32")
        fmt = AudioFormat.F32
    else:
        planar = np.array([[1, -1, (1 << 23) - 1, -(1 << 23)]], dtype=np.int32)
        raw = b"".join(int(v).to_bytes(3, "big", signed=True) for v in planar[0])
        data = _aiff((1, 4, 24), "400EAC44000000000000", raw)
        fmt = AudioFormat.I24
    got, info = _both(data)
    assert info.format == fmt
    np.testing.assert_array_equal(got, planar)


@pytest.fixture(scope="module")
def codec():
    if codec_mod.load() is None:
        pytest.skip(f"codec runtime unavailable: {codec_mod.load_error}")
    return codec_mod


def _sine(rate=44100, seconds=1.5, channels=2):
    t = np.arange(int(rate * seconds)) / rate
    return np.stack([np.sin(2 * np.pi * (440.0 + 220.0 * c) * t) * 0.5 for c in range(channels)]).astype(np.float32)


def _noise(rate=44100, seconds=2.0, channels=2, seed=3):
    sig = np.random.default_rng(seed).standard_normal((channels, int(rate * seconds))) * 0.3
    return np.clip(sig, -0.95, 0.95).astype(np.float32)


def test_flac_is_the_jax_packages_file(codec, tmp_path):
    sig = _sine()
    ours, theirs = tmp_path / "port.flac", tmp_path / "jax.flac"
    codec.write_compressed(ours, sig, 44100)
    jax_codec.write_compressed(theirs, sig, 44100)
    assert ours.read_bytes() == theirs.read_bytes()
    dec, info = codec.read_compressed(ours)
    assert (info.channels, info.sample_rate, info.format) == (2, 44100, AudioFormat.F32)
    np.testing.assert_array_equal(dec, jax_codec.read_compressed(ours)[0])
    assert dec.shape == sig.shape and np.abs(dec - sig).max() < 2e-4


@pytest.mark.parametrize("ext,tol", [("mp3", 0.05), ("ogg", 0.05)])
def test_lossy_round_trip(codec, tmp_path, ext, tol):
    sig = _sine()
    p = tmp_path / f"x.{ext}"
    codec.write_compressed(p, sig, 44100)
    dec, info = codec.read_compressed(p)
    assert info.channels == 2 and info.sample_rate == 44100
    np.testing.assert_array_equal(dec, jax_codec.read_compressed(p)[0])
    # align for codec delay, compare rms error
    lag = int(np.argmax(np.correlate(dec[0][:44100], sig[0][:42000], mode="valid")))
    n = min(sig.shape[1] - 2000, dec.shape[1] - lag)
    assert np.sqrt(np.mean((dec[0][lag:lag + n] - sig[0][:n]) ** 2)) < tol


def test_load_audio_file_dispatch_and_session_render(codec, tmp_path):
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.timeline.oracle import OracleRenderer

    p = tmp_path / "clip.mp3"
    codec.write_compressed(p, _sine(channels=1), 44100)
    planar, info = load_audio_file(p)
    assert info.format == AudioFormat.F32 and info.sample_rate == 44100
    s = Sample.load_file(p)
    assert s.format == AudioFormat.F32 and s.channels == 1
    pad = tmp_path / "pad.mp3"
    codec.write_compressed(pad, _sine(rate=48000), 48000)
    ses = Session(bpm=120.0)
    ses.add_audio_clip(ses.add_track("pad"), "c", 0.0, 2.0, asset=ses.sample_table.load_from_file(pad))
    assert np.abs(OracleRenderer(ses, 48000.0, buffer_size=512).render()).max() > 0.01


def _sizes(codec, tmp_path, ext, sig, options):
    sizes = []
    for i, opt in enumerate(options):
        p = tmp_path / f"o{i}.{ext}"
        codec.write_compressed(p, sig, 44100, options=opt)
        assert codec.read_compressed(p)[0].shape[0] == sig.shape[0]
        sizes.append(p.stat().st_size)
    return sizes


@pytest.mark.parametrize("case", ["cbr", "vbr_mp3", "vbr_vorbis", "abr"])
def test_encode_options_scale_the_stream(codec, tmp_path, case):
    E = codec.EncodeOptions
    sig = _noise(seconds=1.0 if case == "abr" else 2.0)
    if case == "cbr":
        small, big = _sizes(codec, tmp_path, "mp3", sig, [E(bitrate=64), E(bitrate=320)])
        assert big > 3.5 * small
    elif case == "vbr_mp3":
        small, big = _sizes(codec, tmp_path, "mp3", sig, [E(bitrate_mode="vbr", vbr_quality=q) for q in (0.0, 100.0)])
        assert big > 1.5 * small
    elif case == "vbr_vorbis":
        small, big = _sizes(codec, tmp_path, "ogg", sig, [E(bitrate_mode="vbr", vbr_quality=q) for q in (10.0, 95.0)])
        assert big > 1.3 * small
    else:
        _sizes(codec, tmp_path, "mp3", sig, [E(bitrate_mode="abr", bitrate=128, min_bitrate=64, max_bitrate=192)])


def test_flac_level_depth_and_tags(codec, tmp_path):
    E = codec.EncodeOptions
    sig = _sine(seconds=1.0)
    l0, l8, d24, tagged = (tmp_path / f"{n}.flac" for n in ("l0", "l8", "d24", "tagged"))
    codec.write_compressed(l0, sig, 44100, options=E(flac_compression_level=0, bit_depth=16))
    codec.write_compressed(l8, sig, 44100, options=E(flac_compression_level=8, bit_depth=16))
    assert l0.stat().st_size > l8.stat().st_size  # higher level = smaller
    assert np.abs(codec.read_compressed(l8)[0] - sig).max() < 1.5 / 32768.0
    codec.write_compressed(d24, sig, 44100, options=E(bit_depth=24))
    assert np.abs(codec.read_compressed(d24)[0] - sig).max() < 1.5 / 8388608.0  # a 24-bit step, not 16
    opts = dict(title="My Song", artist="WB", comment="bounced", flac_compression_level=5)
    codec.write_compressed(tagged, sig, 44100, options=E(**opts))
    jax_codec.write_compressed(tmp_path / "jax.flac", sig, 44100, options=jax_codec.EncodeOptions(**opts))
    blob = tagged.read_bytes()
    assert b"My Song" in blob and b"WB" in blob and b"bounced" in blob
    assert blob == (tmp_path / "jax.flac").read_bytes()


def test_encode_options_validation():
    E = codec_mod.EncodeOptions
    for kw, name in [({"vbr_quality": 120.0}, "vbr_quality"), ({"flac_compression_level": 13}, "flac_compression_level"),
                     ({"bitrate": -1}, "bitrate"), ({"bit_depth": 20}, "bit_depth"), ({"bitrate_mode": "x"}, "bitrate_mode")]:
        with pytest.raises(ValueError, match=name):
            E(**kw)


def test_missing_runtime_names_the_libraries(monkeypatch, tmp_path):
    """A failed build is an error naming libav, raised where the codec is
    used; WAV and AIFF do not need it."""
    from whitebox_tpu_torch import buildlib
    from whitebox_tpu_torch.core.formats import AudioFormat as Fmt
    from whitebox_tpu_torch.io.wav import write_wav

    def fail(*a, **k):
        raise RuntimeError("g++ failed (1): fatal error: libavcodec/avcodec.h: No such file or directory")

    monkeypatch.setattr(buildlib, "build_shared", fail)
    monkeypatch.setattr(codec_mod, "_TRIED", False)
    monkeypatch.setattr(codec_mod, "_LIB", None)
    monkeypatch.setattr(codec_mod, "load_error", None)
    assert codec_mod.load() is None and "libavcodec/avcodec.h" in codec_mod.load_error
    with pytest.raises(RuntimeError, match="libavformat, libavcodec, libavutil and libswresample"):
        codec_mod.write_compressed(tmp_path / "x.flac", _sine(seconds=0.1), 44100)
    with pytest.raises(RuntimeError, match="codec runtime"):
        codec_mod.read_compressed(tmp_path / "x.flac")
    write_wav(tmp_path / "x.wav", _sine(seconds=0.1), 44100, Fmt.F32)
    assert load_audio_file(tmp_path / "x.wav")[1].count == 4410
