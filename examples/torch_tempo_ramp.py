"""Tempo-mapped arrangement on whitebox_tpu_torch (the PyTorch/CUDA port).

Builds a session whose timeline the reference DAW cannot express at all
(it has exactly ONE session-wide BPM, engine.cpp:24): a drum pattern that
accelerates through a linear tempo ramp into a half-time drop, under a
4/4 -> 3/4 meter change, with a tempo-following automation sweep — then
verifies the mapped positions against the exact closed forms and renders
a bar-addressed excerpt.

The same program as ``examples/tempo_ramp.py`` on the port: the bounce
runs on ``--device`` (default: the CUDA card; ``--device cpu`` runs the
plain PyTorch versions of the kernels).

Run:  python examples/torch_tempo_ramp.py [OUT.wav] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

# the checkout's package when run as a script from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from whitebox_tpu_torch.core.formats import AudioFormat  # noqa: E402
from whitebox_tpu_torch.effects import Biquad, EffectChain  # noqa: E402
from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation  # noqa: E402
from whitebox_tpu_torch.render.bounce import bounce  # noqa: E402
from whitebox_tpu_torch.session import Session  # noqa: E402
from whitebox_tpu_torch.session.sample import Sample  # noqa: E402

RATE = 48000


def kick(seconds=0.25):
    t = np.arange(int(RATE * seconds)) / RATE
    f = 150.0 * np.exp(-t * 18.0) + 45.0
    return (np.sin(2 * np.pi * np.cumsum(f) / RATE) * np.exp(-t * 9.0) * 0.8
            ).astype(np.float32)[None]


def hat(seconds=0.06):
    rng = np.random.default_rng(7)
    n = int(RATE * seconds)
    return (rng.standard_normal((1, n)) * np.exp(-np.arange(n) / (0.01 * RATE)) * 0.25
            ).astype(np.float32)


def main(out_path=None, device=None):
    out_path = out_path or os.path.join(tempfile.gettempdir(), "ramp.wav")
    s = Session(bpm=110.0)

    # tempo: hold 110, ramp linearly 110 -> 150 over beats [8, 16)
    # (bpm_end = explicit ramp target), then DROP to 75 at beat 16 —
    # a discontinuity no continuous ramp could express
    s.set_tempo_point(8.0, 110.0, curve="linear", bpm_end=150.0)
    s.set_tempo_point(16.0, 75.0)
    # meter: 4/4 for 2 bars, then 3/4
    s.set_meter(2, 3, 4)

    k = s.sample_table.add_sample(Sample.from_planar(kick(), RATE, AudioFormat.F32,
                                                     name="kick"), key="kick")
    h = s.sample_table.add_sample(Sample.from_planar(hat(), RATE, AudioFormat.F32,
                                                     name="hat"), key="hat")

    drums = s.add_track("drums", volume_db=-2.0)
    hats = s.add_track("hats", volume_db=-8.0, pan=0.3)
    for b in range(20):
        s.add_audio_clip(drums, f"k{b}", float(b), b + 0.5, asset=k)
        s.add_audio_clip(hats, f"h{b}", b + 0.5, b + 0.75, asset=h)

    # a filter sweep whose breakpoints are BEATS: under the map they land
    # at the exact integrated frame positions (accelerating with the ramp)
    hats.effects = EffectChain([Biquad("lowpass", 2000.0, 0.9)])
    hats.automation = TrackAutomation(effects={
        (0, "freq_hz"): AutomationLane().add(8.0, 2000.0).add(16.0, 9000.0)})

    # exact closed-form positions (what the render is built on)
    tm = s.tempo_map
    print("tempo map:", tm)
    print("meter map:", s.meter_map)
    for beat in (8.0, 12.0, 16.0):
        print(f"  beat {beat:4.1f} -> {tm.beats_to_seconds(beat):7.4f} s "
              f"(bar|beat {s.meter_map.label(beat)})")

    res = bounce(s, float(RATE), device=device, engine="auto", tail_seconds=0.25,
                 out_path=out_path)
    print(res.stats.summary())

    # the drop: beat 16 starts exactly at the integrated time of the ramp
    drop_s = float(tm.beats_to_seconds(16.0))
    drop_frame = int(round(drop_s * RATE))
    print(f"drop lands at {drop_s:.4f} s (frame {drop_frame}) -> "
          f"kick onset energy {float(np.abs(res.audio[:, drop_frame:drop_frame + 256]).max()):.3f}")
    print(f"wrote {out_path}")
    assert np.isfinite(res.audio).all() and drop_frame < res.audio.shape[1], "the drop is past the render"
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_path", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.out_path, args.device)
    sys.exit(0)
