"""Offline render drivers. Counterpart of ``whitebox_tpu/render``.

- ``bounce``           : session -> mixed audio (+ WAV) through the CUDA mix
                         kernel: automation lanes in the kernel; effect
                         chains and meters through its per-track mode and
                         a finisher.
- ``effects_pipeline`` : the scan finisher (chains, gains, ordered sum,
                         master, clip, meters), the lane tables, and the
                         f64 host reference of the finish stage.
- ``effects_fir``      : the FFT-FIR finisher (chain impulse responses,
                         overlap-save in ``torch.fft``).
- ``effects_generic``  : which chains the linear finishers take.
- ``metrics``          : ``RenderStats``, ``Stopwatch``, ``DeviceTimer`` (CUDA events).
- ``demo``             : ``make_demo_session``, the synthetic benchmark sessions.

Unlike the JAX package, importing this package imports none of its
modules, so ``demo`` and ``metrics`` load without the renderer.
"""
