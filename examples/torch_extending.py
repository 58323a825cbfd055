"""Extending whitebox_tpu_torch (the PyTorch/CUDA port): custom effects + streaming record.

The same program as ``examples/extending.py`` on the port, with the custom
effect written in torch ops. It walks the two extensibility surfaces end to
end:

1. A user-defined effect (`register_effect`, effects/registry.py — the
   analogue of the reference's persisted plugin registry,
   plugin_manager.cpp:39-68): a tilt filter written out-of-package that
   persists through ``.wb`` by type name + state blob, renders inside a
   chain, and — because it implements the *stage protocol* on torch
   tensors — joins the batched generic pipeline with the built-ins.

2. Streaming record ingestion (`RecordingTake`, session/record.py — the
   audio_record.h lifecycle): blocks append under bounded allocation
   while a preview of the same session plays (the punch-in workflow),
   and ``finalize`` registers the take as an asset + clip.

The renders run on ``--device`` (default: the CUDA card; ``--device cpu``
runs the plain PyTorch versions of the kernels).

Run: python examples/torch_extending.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

# the checkout's package when run as a script from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(device=None):
    import torch

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.effects import Effect, EffectChain, register_effect
    from whitebox_tpu_torch.io import wav
    from whitebox_tpu_torch.ops.dynamics import onepole_scan
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.preview import PreviewStream
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.project import read_project, write_project
    from whitebox_tpu_torch.session.record import RecordingTake

    rate = 48000.0

    # ------------------------------------------------------------------
    # 1. a custom effect: one-pole "tilt" (lowpass + complementary boost)
    # ------------------------------------------------------------------
    @register_effect("example.tilt")
    class Tilt(Effect):
        """y[n] = x[n] + amount * (lp[n] - x[n]); lp = one-pole at `coef`."""

        def __init__(self, coef: float = 0.9, amount: float = 0.5) -> None:
            super().__init__()
            self.coef = float(coef)
            self.amount = float(amount)

        # --- persistence (the .wb state blob)
        def as_dict(self):
            return {"coef": self.coef, "amount": self.amount}

        @classmethod
        def from_dict(cls, d):
            return cls(float(d["coef"]), float(d["amount"]))

        # --- [C, F] one-shot processing
        def init_state(self, channels: int):
            return torch.zeros((channels,), dtype=torch.float32)

        def process(self, x, state):
            x = torch.as_tensor(x, dtype=torch.float32)
            # lp[n] = coef * lp[n-1] + (1 - coef) * x[n], carried in `state`
            lp, lp1 = onepole_scan(x, self.coef, state.to(x.device))
            return x + self.amount * (lp - x), lp1

        # --- stage protocol: joins the batched generic pipeline
        def static_config(self):
            return ()

        def param_arrays(self):
            return {"a": np.float32(self.coef), "k": np.float32(self.amount)}

        @classmethod
        def stage_init_state(cls, static, params, B: int, C: int):
            return torch.zeros((B, C), dtype=torch.float32)

        @classmethod
        def stage_apply(cls, static, params, x, state, n0, sample_rate, key=None, lanes=None):
            a = params["a"][:, None, None]  # [B] -> broadcast over [B, C, Fc]
            k = params["k"][:, None, None]
            lp, lp1 = onepole_scan(x, a, state.to(x.device))
            return x + k * (lp - x), lp1

    tmp = tempfile.mkdtemp(prefix="wb_extending_")
    t = np.arange(int(rate * 2)) / rate
    kick = (np.sin(2 * np.pi * 60 * t) * np.exp(-t * 8) * 0.8).astype(np.float32)
    wav.write_wav(os.path.join(tmp, "kick.wav"), kick[None], int(rate), AudioFormat.F32)

    s = Session(bpm=120.0)
    asset = s.sample_table.load_from_file(os.path.join(tmp, "kick.wav"))
    drums = s.add_track("drums", volume_db=-3.0)
    for b in range(8):
        s.add_audio_clip(drums, f"k{b}", float(b), b + 0.9, asset=asset)
    drums.effects = EffectChain([Tilt(coef=0.92, amount=0.6)])

    proj = os.path.join(tmp, "tilted.wb")
    write_project(s, proj)
    s2 = read_project(proj)  # the custom effect round-trips by type name
    fx = s2.tracks[0].effects.effects[0]
    assert type(fx).__name__ == "Tilt" and abs(fx.amount - 0.6) < 1e-9
    r = bounce(s2, rate, device=device)
    print(f"custom-effect render: {r.audio.shape[1]} frames, "
          f"peak {float(np.max(np.abs(np.asarray(r.audio)))):.3f}")

    # ------------------------------------------------------------------
    # 2. punch-in: record a take while the session previews
    # ------------------------------------------------------------------
    vox = s2.add_track("vox", volume_db=0.0)
    stream = PreviewStream(s2, rate, buffer_size=512, device=device)
    take = RecordingTake(s2, vox, rate, at_beat=2.0, channels=1, name="take 1")
    rng = np.random.default_rng(7)
    for _ in range(20):                       # "device blocks" arriving
        stream.next_block()                   # preview keeps playing
        take.append(rng.standard_normal((1, 512)).astype(np.float32) * 0.1)
    clip = take.finalize()                    # truncate + register + place
    print(f"recorded take: {take.frames_written} frames -> clip "
          f"[{clip.min_time:.2f}, {clip.max_time:.2f}) beats on 'vox'")

    r2 = bounce(s2, rate, device=device)
    print(f"post-punch-in render: {r2.audio.shape[1]} frames — done")
    assert np.isfinite(r.audio).all() and np.isfinite(r2.audio).all()
    return r, r2


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
    sys.exit(0)
