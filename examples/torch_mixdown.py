"""End-to-end production mixdown on whitebox_tpu_torch (the PyTorch/CUDA port).

Builds a small session exercising the mixer surface the reference DAW
lacks — buses, sends, sidechain ducking, automation on tracks/buses/
effect params, a linear-phase master EQ under PDC — then renders with
loudness normalization and dithered 16-bit export.

The same program as ``examples/mixdown.py`` on the port: the bounce runs
on ``--device`` (default: the CUDA card; ``--device cpu`` runs the plain
PyTorch versions of the kernels).

Run:  python examples/torch_mixdown.py [OUT.wav] [--device cpu]
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
from whitebox_tpu_torch.effects import (  # noqa: E402
    Biquad, Compressor, Delay, EffectChain, LinearPhaseEQ, Limiter,
)
from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation  # noqa: E402
from whitebox_tpu_torch.render.bounce import bounce  # noqa: E402
from whitebox_tpu_torch.session import Session  # noqa: E402
from whitebox_tpu_torch.session.sample import Sample  # noqa: E402

RATE = 48000


def tone(freq, seconds, amp=0.5, decay=0.0):
    t = np.arange(int(seconds * RATE)) / RATE
    env = np.exp(-t * decay) if decay else 1.0
    return (amp * env * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None, :]


def main(out_path: str, device=None):
    s = Session(bpm=120.0)
    kick = s.sample_table.add_sample(
        Sample.from_planar(tone(55.0, 0.4, 0.9, decay=9.0), RATE, AudioFormat.F32,
                           name="kick"), key="kick")
    bass = s.sample_table.add_sample(
        Sample.from_planar(tone(110.0, 4.0, 0.4), RATE, AudioFormat.F32,
                           name="bass"), key="bass")
    keys = s.sample_table.add_sample(
        Sample.from_planar(tone(440.0, 4.0, 0.25) + tone(554.37, 4.0, 0.2),
                           RATE, AudioFormat.F32, name="keys"), key="keys")

    t_kick = s.add_track("kick", volume_db=-2.0)
    t_bass = s.add_track("bass", volume_db=-6.0)
    t_keys = s.add_track("keys", volume_db=-8.0, pan=0.25)
    for beat in range(8):
        s.add_audio_clip(t_kick, f"k{beat}", float(beat), beat + 0.8, asset=kick)
    s.add_audio_clip(t_bass, "bassline", 0.0, 8.0, asset=bass)
    s.add_audio_clip(t_keys, "keys", 0.0, 8.0, asset=keys)

    # sidechain ducking: bass grouped to a bus whose compressor is keyed
    # by the kick (the kick itself still goes straight to the master)
    duck = s.add_bus("duck")
    duck.effects = EffectChain([
        Compressor(-32.0, 8.0, attack_s=0.002, release_s=0.12, sidechain=True)])
    s.set_track_output(1, 0)                 # bass -> duck bus
    s.add_send(0, 0, gain_db=0.0, sidechain=True)  # kick -> KEY input

    # an FX bus fed by a post-fader send, with an automated fader ride
    fxb = s.add_bus("space", volume_db=-9.0)
    fxb.effects = EffectChain([Delay(0.25, 0.45, wet=1.0, dry=0.0)])
    s.add_send(2, 1, gain_db=-6.0)           # keys -> delay bus
    fxb.automation = TrackAutomation(
        volume=AutomationLane().add(0.0, 0.1).add(8.0, 1.0))

    # timed effect-param lane: keys brighten over the first 4 beats
    t_keys.effects = EffectChain([Biquad("lowpass", 800.0)])
    t_keys.automation = TrackAutomation(effects={
        (0, "freq_hz"): AutomationLane().add(0.0, 800.0).add(4.0, 9000.0)})

    # mastering chain: linear-phase EQ + lookahead limiter, PDC-aligned
    s.master_effects = EffectChain([
        LinearPhaseEQ([("lowshelf", 90.0, 0.707, 1.5),
                       ("highshelf", 9000.0, 0.707, 1.0)], taps=1023),
        Limiter(-1.0, lookahead_s=0.003),
    ])

    res = bounce(
        s, float(RATE),
        device=device,
        pdc=True,                        # compensate the EQ/limiter latency
        loudness=True,                   # EBU R128 measurement
        normalize=("lufs", -14.0),       # streaming-delivery target
        out_path=out_path,
        out_format=AudioFormat.I16,
        out_dither="tpdf-hp",            # 16-bit master dither
    )
    lu = res.stats.loudness
    print(f"rendered {res.frames} frames -> {out_path}")
    print(f"loudness: I {lu.integrated_lufs:+.2f} LUFS  LRA {lu.lra_lu:.1f} LU  "
          f"TP {lu.true_peak_dbtp:+.2f} dBTP  (RTF {res.stats.rtf:.0f}x)")
    assert np.isfinite(res.audio).all() and os.path.getsize(out_path) > 44, "no finite mix written"
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_path", nargs="?", default=os.path.join(tempfile.gettempdir(), "mixdown.wav"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.out_path, args.device)
    sys.exit(0)
