"""The program's side of the ``clips`` kind of session: the ``Session`` of a
description (``sessions/clips.py``), built through the program's public API,
and an edit made on it as a user makes it."""

from __future__ import annotations

import numpy as np

from wbbench.lib.spec import part


def effect_chain(chain) -> list:
    """The program's effects of a resolved chain (``lib/chains.py``), in an
    ``EffectChain`` (an empty list without one)."""
    if not chain:
        return []
    from whitebox_tpu_torch.effects import EffectChain

    return EffectChain([part("program/fx", kind).build(params) for kind, params in chain])


def build(desc):
    """The program's ``Session`` of ``desc``."""
    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.sample import Sample

    s = Session(bpm=desc.bpm)
    assets = [s.sample_table.add_sample(Sample.from_planar(a, desc.sample_rate, AudioFormat.F32, name=f"a{i}"),
                                        key=f"a{i}") for i, a in enumerate(desc.assets)]
    for t, tr in enumerate(desc.tracks):
        track = s.add_track(f"track{t}", volume_db=float(tr.volume_db), pan=float(tr.pan))
        for i in np.argsort(tr.min_beat, kind="stable"):
            s.add_audio_clip(track, f"c{t}.{i}", float(tr.min_beat[i]), float(tr.max_beat[i]),
                             start_offset=float(tr.offset[i]), asset=assets[int(tr.asset[i])],
                             gain=float(tr.gain[i]), fade_start=float(tr.fade_in[i]),
                             fade_end=float(tr.fade_out[i]))
        track.effects = effect_chain(tr.chain)
    s.master_effects = effect_chain(desc.master_chain)
    return s


def edit(session, base, previous, variant) -> None:
    """Undo ``previous`` (a ``Variant``, or None), then make ``variant`` on
    ``session``: the track's fader, and ``move_clip``."""
    if previous is not None:
        t, clip = previous.track, previous.moved_clip
        tr = session.tracks[t]
        tr.volume_db = base.tracks[t].volume_db
        c = tr.clips[clip]
        c.min_time, c.max_time = float(base.tracks[t].min_beat[clip]), float(base.tracks[t].max_beat[clip])
        c.internal_state_changed = True
    want = variant.desc.tracks[variant.track]
    tr = session.tracks[variant.track]
    tr.volume_db = want.volume_db
    c = tr.clips[variant.moved_clip]
    session.move_clip(tr, c, variant.move_beats)
    if (c.min_time, c.max_time) != (want.min_beat[variant.moved_clip], want.max_beat[variant.moved_clip]):
        raise RuntimeError(f"the session's clip moved to {(c.min_time, c.max_time)}, the description's to "
                           f"{(want.min_beat[variant.moved_clip], want.max_beat[variant.moved_clip])}")
