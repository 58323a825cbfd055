"""Offline render drivers. Counterpart of ``whitebox_tpu/render``.

- ``bounce``  : session -> mixed audio (+ WAV) through the CUDA mix kernel.
- ``metrics`` : ``RenderStats``, ``Stopwatch``, ``DeviceTimer`` (CUDA events).
- ``demo``    : ``make_demo_session``, the synthetic benchmark sessions.

Unlike the JAX package, importing this package imports none of its
modules, so ``demo`` and ``metrics`` load without the renderer.
"""
