"""The port's ``config.py``, ``log.py`` and the CLI's ``convert``, encode
flags, ``render --profile`` and ``-v`` against the JAX package's (CPU).

``Settings`` round-trips and falls back to its defaults as in
``tests/test_aux.py``, and gives the CLI's render defaults; the loggers live under the port's namespace and
``configure`` attaches one stderr handler. ``convert`` writes what the JAX
CLI's ``convert`` writes from the same file (WAV and FLAC byte for byte;
a rate change within 1e-5 of the JAX package's windowed sinc);
``render`` to .flac with the encode flags and the project's tags writes
the JAX CLI's file byte for byte; ``render --profile DIR`` leaves a
``torch.profiler`` Chrome trace in DIR. Cases that encode skip only where
the codec runtime cannot be built (``io/codec.py``).
"""

import importlib
import json
import logging

import numpy as np
import pytest

from tests.test_carve import random_session
from whitebox_tpu import cli as jax_cli
from whitebox_tpu.session.project import write_project
from whitebox_tpu_torch import cli, log
from whitebox_tpu_torch.config import Settings, default_settings_path
from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io import codec, wav


def test_settings_roundtrip(tmp_path):
    st = Settings(sample_rate=44100, engine="xla", interpolation="sinc", strict_order=False)
    back = Settings.load(st.save(tmp_path / "settings.json"))
    assert back == st
    assert not hasattr(Settings, "enable_compilation_cache")


@pytest.mark.parametrize("content", [None, "{not json"], ids=["missing", "corrupt"])
def test_settings_fall_back_to_defaults(tmp_path, content):
    p = tmp_path / "settings.json"
    if content is not None:
        p.write_text(content)
    st = Settings.load(p)
    assert st == Settings() and (st.sample_rate, st.buffer_size, st.engine) == (48000, 512, "auto")


def test_default_settings_path_is_the_ports(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert default_settings_path() == tmp_path / "whitebox_tpu_torch" / "settings.json"


def test_settings_give_the_cli_render_defaults(monkeypatch, tmp_path):
    """A settings file written by the JAX package's shape (its unread keys
    included) sets ``render``'s defaults; a flag on the command line wins."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.session.project import read_project

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    st = Settings(sample_rate=44100, buffer_size=256, engine="xla", chunk_frames=4096, strict_order=False)
    path = st.save()
    doc = json.loads(path.read_text())
    path.write_text(json.dumps({**doc, "output_channels": 2, "user_dirs": ["/samples"]}))
    js = random_session(23, rate=44100, bpm=120.0, n_tracks=2, n_clips=3)
    wb = tmp_path / "p.wb"
    write_project(js, wb)
    assert cli.main(["render", str(wb), str(tmp_path / "set.wav"), "--device", "cpu"]) == 0
    got, info = wav.read_wav(tmp_path / "set.wav")
    want = bounce(read_project(wb), 44100.0, buffer_size=256, engine="xla", chunk_frames=4096,
                  strict_order=False, device="cpu").audio
    assert info.sample_rate == 44100 and np.array_equal(got, want)
    assert cli.main(["render", str(wb), str(tmp_path / "flag.wav"), "--rate", "48000", "--device", "cpu"]) == 0
    assert wav.read_wav(tmp_path / "flag.wav")[1].sample_rate == 48000


def test_loggers_and_configure():
    assert log.get_logger().name == "whitebox_tpu_torch"
    assert log.get_logger("bounce").name == "whitebox_tpu_torch.bounce"
    from whitebox_tpu_torch.effects import registry
    bounce = importlib.import_module("whitebox_tpu_torch.render.bounce")
    from whitebox_tpu_torch.session import project

    assert {m._log.name for m in (registry, bounce, project)} == {
        "whitebox_tpu_torch.effects.registry", "whitebox_tpu_torch.bounce", "whitebox_tpu_torch.project"}
    before = list(log.logger.handlers)
    try:
        log.configure(verbose=True)
        log.configure(verbose=False)
        added = [h for h in log.logger.handlers if h not in before]
        assert len(added) <= 1 and log.logger.level == logging.INFO
    finally:
        log.logger.handlers[:] = before
        log.logger.setLevel(logging.NOTSET)


def _tone(path, rate=44100, seconds=0.5):
    t = np.arange(int(rate * seconds)) / rate
    wav.write_wav(path, (np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)]) * 0.5)
                  .astype(np.float32), rate, AudioFormat.F32)
    return path


def _need_codec():
    if codec.load() is None:
        pytest.skip(f"codec runtime unavailable: {codec.load_error}")


@pytest.mark.parametrize("case", ["wav_i16", "flac", "resample"])
def test_convert_matches_jax_cli(tmp_path, capsys, case):
    src = _tone(tmp_path / "src.wav")
    ext, flags = {"wav_i16": ("wav", ["--format", "i16"]), "flac": ("flac", ["--flac-level", "5"]),
                  "resample": ("wav", ["--rate", "48000"])}[case]
    if ext == "flac":
        _need_codec()
    ours, theirs = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
    assert jax_cli.main(["convert", str(src), str(theirs), *flags]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["convert", str(src), str(ours), *flags, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.replace("port.", "jax.") == jout
    if case != "resample":
        assert ours.read_bytes() == theirs.read_bytes()
        return
    got, info = wav.read_wav(ours)
    want, winfo = wav.read_wav(theirs)
    assert info.sample_rate == winfo.sample_rate == 48000 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_convert_reads_aiff(tmp_path):
    from tests.test_torch_host import _aiff_bytes

    planar = np.random.default_rng(2).integers(-32768, 32768, (2, 999)).astype(np.int16)
    (tmp_path / "x.aiff").write_bytes(_aiff_bytes(planar))
    for main, out in ((cli.main, "port.wav"), (jax_cli.main, "jax.wav")):
        assert main(["convert", str(tmp_path / "x.aiff"), str(tmp_path / out), "--format", "i16"]) == 0
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, info = wav.read_wav(tmp_path / "port.wav")
    assert info.sample_rate == 44100 and np.abs(got.astype(np.int32) - planar).max() <= 1


def test_render_flac_with_tags_matches_jax_cli(tmp_path):
    """The project's title and author fill the tags (export_metadata), the
    flags set the level; the file is the JAX CLI's."""
    _need_codec()
    js = random_session(21, rate=48000, bpm=120.0, n_tracks=2, n_clips=2)
    js.project_info.title, js.project_info.author = "Tagged Project", "Author X"
    wb = tmp_path / "p.wb"
    write_project(js, wb)
    flags = ["--rate", "48000", "--flac-level", "5", "--tag-comment", "bounced"]
    assert jax_cli.main(["render", str(wb), str(tmp_path / "jax.flac"), *flags]) == 0
    assert cli.main(["render", str(wb), str(tmp_path / "port.flac"), *flags, "--device", "cpu"]) == 0
    blob = (tmp_path / "port.flac").read_bytes()
    assert b"Tagged Project" in blob and b"Author X" in blob and b"bounced" in blob
    assert blob == (tmp_path / "jax.flac").read_bytes()
    assert cli.main(["render", str(wb), str(tmp_path / "bare.flac"), "--no-tags", "--device", "cpu"]) == 0
    assert b"Tagged Project" not in (tmp_path / "bare.flac").read_bytes()


def test_render_profile_and_verbose(tmp_path, caplog):
    js = random_session(22, rate=48000, bpm=120.0, n_tracks=1, n_clips=1)
    wb = tmp_path / "p.wb"
    write_project(js, wb)
    before = list(log.logger.handlers)
    try:
        with caplog.at_level(logging.DEBUG):
            assert cli.main(["-v", "render", str(wb), str(tmp_path / "o.wav"), "--device", "cpu",
                             "--profile", str(tmp_path / "trace")]) == 0
        assert log.logger.level == logging.DEBUG  # -v
    finally:
        log.logger.handlers[:] = before
        log.logger.setLevel(logging.NOTSET)
    port = [r.getMessage() for r in caplog.records if r.name.startswith("whitebox_tpu_torch.")]
    assert any(m.startswith("loaded") for m in port) and any(m.startswith("profiling to") for m in port)
    assert any(m.startswith("carved") for m in port)  # bounce's debug record
    trace = json.loads((tmp_path / "trace" / "render.pt.trace.json").read_text())
    assert trace["traceEvents"]
