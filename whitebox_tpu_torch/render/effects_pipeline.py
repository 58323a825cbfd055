"""Mix finishing: the part the automation lanes (K3) need.

Counterpart of ``whitebox_tpu/render/effects_pipeline.py``:

- :func:`session_has_effects` and :func:`prepare_automation_tables_host`
  (the host lane tables the CUDA mix kernel's automation variant reads);
- :func:`reference_finish_mix`, the f64 host reference of the finish
  stage (``effects_pipeline.py:158-207``) without effect chains: per-frame
  volume/pan gains, the ordered track sum and the hard clip.

``finish_mix`` (the per-track finisher with effect chains) arrives with
the per-track kernel mode K4, ROADMAP.md queue 1, item 3.
"""

from __future__ import annotations

import numpy as np

from whitebox_tpu_torch.ops.automation import (
    HALF_PI, SQRT2, eval_lane_numpy, pack_session_automation, session_has_automation,
)


def session_has_effects(session) -> bool:
    return bool(session.master_effects) or any(t.effects for t in session.tracks)


def prepare_automation_tables_host(session, sample_rate: float):
    """Host lane tables ``(vol, pan, mute, use)`` for the automation kernel,
    or None when no track has automation. ``vol``/``pan`` are dicts of
    ``[T, P]`` arrays (``xs`` i32, ``ys`` f32, ``cv`` i32, ``tn`` f32),
    ``mute`` ``[T]`` f32 and ``use`` ``[T]`` bool: only tracks with a
    volume or pan lane take per-frame gains, the rest keep their constant
    fader gains bit for bit."""
    if not session_has_automation(session):
        return None
    vol, pan, mute = pack_session_automation(session, sample_rate)
    use = np.array([t.automation is not None and t.automation.has_track_lanes()
                    for t in session.tracks], dtype=bool)
    return (vol, pan, mute, use)


def reference_finish_mix(per_track: np.ndarray, session, sample_rate: float) -> np.ndarray:
    """f64 host reference: per-track buffers ``[T, C, F]`` -> mix ``[C, F]``.

    Automated tracks take the f32 lane values (``eval_lane_numpy``) and
    the f32 pan law per frame; the others their constant f32 fader gain.
    The sum runs in f64, then the hard clip and one rounding to f32."""
    if session_has_effects(session):
        raise NotImplementedError("effect chains: ROADMAP.md queue 1, items 3 and 6")
    T, C, F = per_track.shape
    g = np.arange(F, dtype=np.int64)
    auto_tables = pack_session_automation(session, sample_rate) if session_has_automation(session) else None
    total = np.zeros((C, F), dtype=np.float64)
    for t, track in enumerate(session.tracks):
        buf = per_track[t].astype(np.float64)
        if track.automation is not None and track.automation.has_track_lanes():
            vol_t, pan_t, mute = auto_tables
            volv = eval_lane_numpy(vol_t["xs"][t], vol_t["ys"][t], vol_t["cv"][t], vol_t["tn"][t], g)
            panv = eval_lane_numpy(pan_t["xs"][t], pan_t["ys"][t], pan_t["cv"][t], pan_t["tn"][t], g)
            for ch in range(C):
                x = np.float32(0.5) * (panv + np.float32(1.0))
                arg = (np.float32(1.0) - x) if ch % 2 == 0 else x
                coef = (np.sin(HALF_PI * arg) * SQRT2).astype(np.float32)
                total[ch] += buf[ch] * ((volv * coef) * mute[t]).astype(np.float64)
        else:
            vol = np.float32(0.0) if track.mute else track.volume_linear
            pan = track.pan_coeffs
            for ch in range(C):
                total[ch] += buf[ch] * float(np.float32(vol * np.float32(pan[ch % 2])))
    return np.clip(total, -1.0, 1.0).astype(np.float32)
