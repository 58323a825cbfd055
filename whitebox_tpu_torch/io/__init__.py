"""Host-side IO: the WAV codec (``wav``, a copy of ``whitebox_tpu/io/wav.py``),
AIFF (``aiff``), MP3, Ogg Vorbis and FLAC through the system's libav
(``codec``, built from ``csrc/host/codec``), and the native host
library's bindings (``native``: the carve walk, the plan row expansion
and the peak walk, built from ``csrc/host``).
"""

from whitebox_tpu_torch.io import wav  # noqa: F401
