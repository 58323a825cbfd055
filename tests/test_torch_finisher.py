"""The finisher seam (``whitebox_tpu_torch/render/finisher.py``) on the CPU.

- ``run`` fed a per-track buffer and ``run`` fed a ``chunk(start, n[,
  rows])`` callable over slices of the same buffer give the same bits, in
  every family (scan, generic, routed), form (mix, stems), with meters and
  PDC where the family has them: the fetch-ahead rows, the head trim and
  the meter window are ``run``'s, whatever feeds it;
- ``choose_finisher`` names each family by the rules ``bounce`` keeps;
- the scan step gains the cascade's output in place and writes nothing of
  its input.
"""

import numpy as np
import pytest
import torch

from whitebox_tpu_torch import effects as fx
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade
from whitebox_tpu_torch.render.demo import make_demo_session
from whitebox_tpu_torch.render.finisher import _window, choose_finisher, make_finisher, run

RATE = 48000.0
CHUNK = 2048
FRAMES = 4 * CHUNK


def _eq(tracks=3):
    s = make_demo_session(n_tracks=tracks, duration_seconds=0.5, sample_rate=48000, seed=3)
    for i, tr in enumerate(s.tracks):
        tr.effects = fx.EffectChain([fx.ParametricEQ([("lowshelf", 100.0, 0.707, 2.0),
                                                      ("peak", 1000.0 + 37.0 * i, 1.0, -1.5)])])
    s.master_effects = fx.EffectChain([fx.Biquad("highpass", 25.0)])
    return s


def _generic():
    s = _eq()
    s.tracks[0].effects = fx.EffectChain([fx.Compressor(-20.0, 4.0, attack_s=0.004, release_s=0.09)])
    s.tracks[1].effects = fx.EffectChain([fx.Limiter(-4.0, lookahead_s=0.002)])
    s.master_effects = fx.EffectChain([fx.Biquad("highpass", 30.0), fx.Limiter(-1.0, lookahead_s=0.001)])
    return s


def _routed():
    s = _generic()
    bus = s.add_bus("lim", volume_db=-2.0)
    bus.effects = fx.EffectChain([fx.Limiter(-3.0, lookahead_s=0.003)])
    duck = s.add_bus("duck")
    duck.effects = fx.EffectChain([fx.Compressor(-30.0, 8.0, sidechain=True)])
    s.set_track_output(0, 0)
    s.add_send(2, 1, gain_db=0.0, sidechain=True)
    s.add_send(1, 1, gain_db=-3.0)
    return s


SESSIONS = {"scan": _eq, "generic": _generic, "routed": _routed}
CASES = [(family, form, meters, pdc)
         for family in ("scan", "generic", "routed")
         for form in ("mix", "stems")
         for meters in ((False, True) if form == "mix" else (False,))
         for pdc in ((False, True) if form == "mix" and family != "scan" else (False,))]


def _ids(case):
    family, form, meters, pdc = case
    return f"{family}-{form}" + ("-meters" if meters else "") + ("-pdc" if pdc else "")


def _bits(out):
    return [o.numpy().tobytes() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_buffer_and_chunk_source_give_the_same_bits(case):
    family, form, meters, pdc = case
    s = SESSIONS[family]()
    T = len(s.tracks)
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((T, 2, FRAMES)) * 0.4).astype(np.float32))
    tg = torch.from_numpy(rng.uniform(0.3, 1.2, (T, 2)).astype(np.float32))
    fin = make_finisher(family, s, RATE, tg, form=form, meters=meters, pdc=pdc, chunk=CHUNK)
    assert fin.chunk == CHUNK and fin.fixed == (family != "scan")
    if pdc:
        # a latent track chain read ahead, a master (and, routed, a bus) latency trimmed
        assert fin.ahead and fin.trim > 0 and (family != "routed" or fin.bus_pdc is not None)
    calls = []

    def chunk(start, n, rows=None):
        calls.append((start, n, rows))
        return _window(x, start, n, True, rows)

    valid = FRAMES - 1000 if meters else None
    a = run(fin, x, FRAMES, valid_frames=valid)
    b = run(fin, chunk, FRAMES, valid_frames=valid)
    assert _bits(a.out) == _bits(b.out) and a.chunks == b.chunks == -(-(FRAMES + fin.trim) // CHUNK)
    assert {n for _, n, _ in calls} == {CHUNK} and calls[0][:2] == (0, CHUNK)
    assert any(r is not None for *_, r in calls) == bool(pdc)
    if meters:
        assert [m.numpy().tobytes() for m in a.meters] == [m.numpy().tobytes() for m in b.meters]
        assert a.meters[0].shape == (T, 2) and a.meters[2].shape == (2,)
    else:
        assert a.meters is None and b.meters is None
    out = a.out if isinstance(a.out, tuple) else (a.out,)
    assert all(o.shape[-1] == FRAMES for o in out) and float(out[0].abs().max()) > 1e-3
    if form == "stems" and family != "routed":
        assert out[0].shape == (T, 2, FRAMES)


@pytest.mark.parametrize("track_chains", [True, False], ids=["eq", "identity"])
def test_scan_step_writes_no_input_and_gains_the_cascade_output(track_chains):
    """The gains go into the cascade's output in place: the step's input is
    left as it was (also where the tracks have no chain and the cascade
    runs their identity section), and the stems are the bits of the
    cascade's output times the gains."""
    s = _eq()
    if not track_chains:
        for tr in s.tracks:
            tr.effects = fx.EffectChain([])
    T = len(s.tracks)
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal((T, 2, CHUNK)) * 0.4).astype(np.float32))
    keep = x.clone()
    tg = torch.from_numpy(rng.uniform(0.3, 1.2, (T, 2)).astype(np.float32))
    fin = make_finisher("scan", s, RATE, tg, form="stems", chunk=CHUNK)
    assert fin.S == (2 if track_chains else 1)
    out, _, _ = fin.step(x, fin.init(), 0)
    assert torch.equal(x, keep)
    y, _ = biquad_cascade(keep.reshape(T * 2, CHUNK), fin.coeffs, fin.init()[0])
    assert out.numpy().tobytes() == (y.reshape(T, 2, CHUNK) * tg[:, :, None]).numpy().tobytes()


def test_chooser_names_each_family():
    eq, generic, routed = _eq(), _generic(), _routed()
    assert choose_finisher(eq) == "scan"
    assert choose_finisher(eq, "fir") == "fir"
    assert choose_finisher(eq, "generic") == "generic"
    assert choose_finisher(eq, "routed") == "routed"  # asked for by name, buses or not
    assert choose_finisher(eq, "fir", meters=True) == "scan"  # meters read per-track audio
    assert choose_finisher(eq, "generic", meters=True) == "scan"
    assert choose_finisher(generic, "fir") == "generic"  # a chain the linear finishers cannot pack
    assert choose_finisher(generic, meters=True) == "generic"
    assert choose_finisher(routed, "fir", meters=True) == "routed"  # routing forces routed
    # per-track stems are taken before the routing; the bus stems are routed
    assert choose_finisher(routed, form="stems") == "generic"
    assert choose_finisher(eq, form="stems") == "scan"
    assert choose_finisher(routed, "routed", form="stems") == "routed"
