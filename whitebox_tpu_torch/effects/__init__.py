"""Effect chains on torch tensors. Counterpart of ``whitebox_tpu/effects``.

Per-track chains run on the track buffer before volume/pan
(track.cpp:600,648-662); a master-bus chain runs after the track sum,
before the hard clip. Ported so far: the linear time-invariant family
(``Gain``, ``Biquad``, ``ParametricEQ``), which the finishers collapse to
biquad sections or impulse responses. Every other type arrives from the
JAX package as an ``UnportedEffect`` and is refused by ``bounce``
(``LinearPhaseEQ``, dynamics, delays, reverb, shaping and the registry:
ROADMAP.md queue 1, item 6).
"""

from whitebox_tpu_torch.effects.base import Effect, EffectChain, UnportedEffect  # noqa: F401
from whitebox_tpu_torch.effects.eq import Biquad, ParametricEQ, cascade_magnitude  # noqa: F401
from whitebox_tpu_torch.effects.gain import Gain  # noqa: F401
