"""The port's feature checks (``whitebox_tpu_torch/tools/verify.py``), the
counterpart of the JAX package's ``tools/tpu_verify.py``, on the CPU.

Each of the eleven checks runs at ``tpu_verify.py``'s sizes and bars with
``device="cpu"`` (the plain PyTorch versions of the kernels). The module's
copies of the JAX package's session helpers (``random_session``,
``mono_asset``) build, for a seed, a session whose carve equals that of
``from_reference`` of the JAX helpers' session. The checks' own launch
requirements (a mix-kernel and a cascade launch) apply on the card only:
see ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

from tests.test_carve import random_session as jax_random_session
from tests.test_tempo_session import _mono_asset as jax_mono_asset
from whitebox_tpu.core.formats import AudioFormat as JaxFormat
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.tools import verify

RATE = 48000.0
NAMES = ["routed_sidechain", "routed_pdc", "tempo_step_ramp", "tempo_resampled", "loudness_r128",
         "linphase_eq", "freeze", "stretch", "sinc_partial", "sinc_reverse", "record_ingest"]


def test_checks_are_the_jax_scripts_in_its_order():
    assert [n for n, _ in verify.CHECKS] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_check_passes_on_cpu(name):
    """The check at its bar, with ``device="cpu"``; its result names its
    value, bar and kernels (none launch on the CPU)."""
    res = dict(verify.CHECKS)[name]("cpu")
    assert res["ok"], res
    assert {"metric", "value", "bar", "kernels"} <= set(res)
    assert res["kernels"] == {}


def _carve_equal(s, js, **kw):
    a, pa = carve_session(s, RATE, buffer_size=512, **kw)
    b, pb = jax_carve_session(js, RATE, buffer_size=512, **kw)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    np.testing.assert_array_equal(pa.data, pb.data)
    assert len(a) > 0


@pytest.mark.parametrize("seed", [11, 15, 31])
def test_session_helpers_build_the_jax_helpers_session(seed):
    """For a seed, ``random_session`` (mixed formats, speeds and source
    rates) and ``mono_asset`` on a track of their own give the carve, pool
    and faders of ``from_reference`` of the JAX helpers' session."""
    fmts = ("F32", "I16", "I24", "I32")
    kw = dict(rate=RATE, bpm=120.0, n_tracks=4, speeds=(1.0, 0.5, float(2 ** (1 / 12))),
              src_rates=(44100.0, 48000.0), n_clips=2)
    s = verify.random_session(seed, formats=tuple(AudioFormat[f] for f in fmts), **kw)
    js = jax_random_session(seed, formats=tuple(JaxFormat[f] for f in fmts), **kw)
    for sess, helper in ((s, verify.mono_asset), (js, jax_mono_asset)):
        a = helper(sess, 9000, seed=seed, src_rate=44100)
        sess.add_audio_clip(sess.add_track("mono"), "m", 0.5, 3.0, asset=a, speed=1.25)
    ref = from_reference(js)
    for t, u in zip(s.tracks, ref.tracks, strict=True):
        assert (t.volume_linear, tuple(t.pan_coeffs), t.mute) == (u.volume_linear, tuple(u.pan_coeffs), u.mute)
    _carve_equal(s, ref)
    _carve_equal(s, js, slow_emit="runs")


def test_main_only_and_json(tmp_path, capsys):
    """``main`` runs the named checks, prints a line each and writes the
    summary; an unknown name is refused."""
    import json

    out = tmp_path / "v.json"
    assert verify.main(["--device", "cpu", "--only", "record_ingest,stretch", "--json", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines if ln.startswith(("PASS", "FAIL"))] == [
        ["PASS", "record_ingest"], ["PASS", "stretch"]]
    summary = json.loads(out.read_text())
    assert summary["n_pass"] == summary["n_checks"] == 2 and summary["failed"] == []
    with pytest.raises(SystemExit):
        verify.main(["--device", "cpu", "--only", "nope"])


def test_a_miss_and_a_fault_are_failures(monkeypatch):
    """A value past its bar, a missing kernel launch on the card and an
    exception inside a check each come back ``ok: False``."""
    import torch

    with verify.Launches() as n:
        pass
    with pytest.raises(verify.CheckFailed):
        verify._result("x", 2.0, 1.0, False, torch.device("cpu"), n)
    with pytest.raises(verify.CheckFailed, match="no mix-kernel launch"):
        verify._result("x", 0.0, 1.0, True, torch.device("cuda"), n, mix=True)
    with pytest.raises(verify.CheckFailed, match="no biquad cascade launch"):
        verify._result("x", 0.0, 1.0, True, torch.device("cuda"), n, cascade=True)

    def boom(device=None):
        raise ValueError("boom")

    monkeypatch.setattr(verify, "CHECKS", [("stretch", boom)])
    res = verify.run_check("stretch", "cpu")
    assert res["ok"] is False and "boom" in res["error"]
