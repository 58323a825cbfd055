"""Effect chains on torch tensors. Counterpart of ``whitebox_tpu/effects``.

Per-track chains run on the track buffer before volume/pan
(track.cpp:600,648-662); a master-bus chain runs after the track sum,
before the hard clip. The linear time-invariant family (``Gain``,
``Biquad``, ``ParametricEQ``) collapses to biquad sections or impulse
responses in the linear finishers; the rest (``LinearPhaseEQ``, dynamics,
delays, convolution reverb, shaping, registered user effects) finishes in
the generic pipeline (``render/effects_generic.py``). An effect class that
exists only in the JAX package arrives as an ``UnportedEffect``, which
``bounce`` refuses by name.
"""

from whitebox_tpu_torch.effects.base import Effect, EffectChain, UnportedEffect  # noqa: F401
from whitebox_tpu_torch.effects.gain import Gain  # noqa: F401
from whitebox_tpu_torch.effects.eq import (  # noqa: F401
    Biquad, LinearPhaseEQ, ParametricEQ, cascade_magnitude, design_linear_phase_fir,
)
from whitebox_tpu_torch.effects.dynamics import Compressor, Limiter, NoiseGate  # noqa: F401
from whitebox_tpu_torch.effects.delay import Chorus, Delay, Flanger  # noqa: F401
from whitebox_tpu_torch.effects.reverb import ConvolutionReverb, design_room_ir  # noqa: F401
from whitebox_tpu_torch.effects.shape import Saturator, StereoWidth  # noqa: F401
from whitebox_tpu_torch.effects.registry import (  # noqa: F401
    UnknownEffect, lookup_effect, register_effect, unregister_effect,
)
