"""Session model: samples, clips, tracks, the session graph, project I/O.

Copies of the JAX package's ``whitebox_tpu/session`` modules (they hold no
JAX) with imports pointed at this package; ``convert.from_reference``
carries a JAX-package session across.

This layer replaces the reference's ``src/engine`` *editing* half (clip.h,
clip_edit.h, track.h CRUD, engine.h edit API, assets_table, project.cpp) as
plain Python data + pure edit math. The *rendering* half (engine.cpp:1576,
track.cpp:587) lives in :mod:`whitebox_tpu_torch.timeline` / :mod:`whitebox_tpu_torch.ops`.
"""

from whitebox_tpu_torch.session.clip import AudioClipData, Clip, ClipMode, ClipType, MidiClipData  # noqa: F401
from whitebox_tpu_torch.session.sample import Sample  # noqa: F401
from whitebox_tpu_torch.session.track import Track  # noqa: F401
from whitebox_tpu_torch.session.session import Session  # noqa: F401
from whitebox_tpu_torch.session.record import RecordingTake  # noqa: F401
