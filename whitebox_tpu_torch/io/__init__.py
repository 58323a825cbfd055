"""Host-side IO: the WAV codec (``wav``, a copy of ``whitebox_tpu/io/wav.py``
that decodes WAV only) and the native host library's bindings (``native``:
the carve walk and the plan row expansion, built from ``csrc/host``).
"""
