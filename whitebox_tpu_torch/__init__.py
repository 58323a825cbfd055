"""whitebox_tpu_torch — the PyTorch/CUDA port of ``whitebox_tpu``.

Counterpart of ``whitebox_tpu/__init__.py``. The JAX package stays the
reference; this package renders the same sessions to the same audio on an
NVIDIA Hopper card (H100), with its one TPU kernel (the fused timeline
mix, ``whitebox_tpu/ops/mix_pallas.py``) rewritten by hand in CUDA C++.

The package stands alone: it imports ``torch`` and never ``jax``, and
nothing of ``whitebox_tpu``. It keeps its own copies of the JAX-free host
modules under the same sub-paths (``core``, ``session``, ``midi``,
``timeline``, ``io``); ``session.convert.from_reference`` carries a session
built with the JAX package across.

- ``device``   : device policy (``resolve_device``: CUDA unless the caller
                 asks for the CPU; never a silent fallback).
- ``core``, ``session``, ``timeline``, ``io`` : the host layer
                 (session model, buses and sends, projects, carve, sample
                 pool, NumPy oracle, WAV, the native carve and plan
                 library).
- ``midi``     : notes, Standard MIDI Files, voice carving, controller
                 lanes and the built-in synth (its render in torch ops).
- ``effects``  : the effect family (EQ, dynamics, delays, reverb,
                 shaping, linear-phase EQ), ``EffectChain`` and the
                 registry of user effects.
- ``ops``      : automation lanes, biquad design and scan (and the
                 cascade kernel's binding), dynamics and delay ops,
                 double-single phase arithmetic, sinc resampling design
                 and ``resample_audio``, the gather mix, the GPU mix plan,
                 the CUDA mix kernel's build, binding and plain PyTorch
                 twins.
- ``render``   : the offline bounce, the effect finishers (biquad scan,
                 FFT-FIR, generic, routed over buses and sends) with their
                 f64 references, stems, the render cache, preview and the
                 streamed bounce, the roofline cost model, render metrics,
                 the demo sessions.
- ``parallel`` : the render over a ('tracks', 'frames') mesh of ranks on
                 ``torch.distributed``: the sharded mix with an ordered
                 track sum, frame-sharded chains with exact state handoff.
- ``cli``      : ``python -m whitebox_tpu_torch.cli render in.wb out.wav``,
                 ``stems``, ``convert``, ``stretch``, ``loudness``,
                 ``freeze``, ``peaks``, ``inspect`` and ``tempo``.
- ``buildlib`` : content-keyed builds of the native sources into ``build/``.
- ``csrc``     : CUDA C++ sources (``nvcc``) and ``csrc/host`` C++ (``g++``),
                 built at first use.
"""

__version__ = "0.1.0"

from whitebox_tpu_torch.core import formats, math, panning  # noqa: F401
