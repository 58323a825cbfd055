"""Offline render drivers. Counterpart of ``whitebox_tpu/render``.

- ``bounce``           : session -> mixed audio (+ WAV) through the CUDA mix
                         kernel: automation lanes in the kernel; effect
                         chains and meters through its per-track mode and
                         a finisher; the gather mix where the plan cannot
                         hold the session.
- ``effects_pipeline`` : the scan finisher (chains, gains, ordered sum,
                         master, clip, meters), the lane tables, and the
                         f64 host reference of the finish stage.
- ``effects_fir``      : the FFT-FIR finisher (chain impulse responses,
                         overlap-save in ``torch.fft``).
- ``effects_generic``  : the generic finisher (dynamics, delays, reverb,
                         shaping, effect lanes) and which chains the
                         linear finishers take.
- ``routing``          : the routed finisher (buses, sends, sidechain keys,
                         bus lanes, bus PDC).
- ``stems``            : per-track and per-bus stems.
- ``cached``           : ``SessionRenderCache``, re-renders of an edited session.
- ``preview``          : ``PreviewStream``, block-pull playback.
- ``stream_pool``      : ``bounce_streamed``, a pool past the card's cap in windows.
- ``roofline``         : the cost model (least bytes and operations of a render).
- ``metrics``          : ``RenderStats``, ``Stopwatch``, ``DeviceTimer`` (CUDA events).
- ``demo``             : ``make_demo_session``, the synthetic benchmark sessions.

As in the JAX package, the package imports ``bounce`` and ``RenderStats``;
the function ``bounce`` shadows its module, which callers reach as
``sys.modules["whitebox_tpu_torch.render.bounce"]`` or
``importlib.import_module``.
"""

from whitebox_tpu_torch.render.bounce import bounce  # noqa: F401
from whitebox_tpu_torch.render.metrics import RenderStats  # noqa: F401
