"""Effect module API.

Counterpart of ``whitebox_tpu/effects/base.py``. An Effect is configured
against a sample rate (``PluginInterface::init_processing``,
plugin_interface.h:142) and then processes ``[channels, frames]`` f32
tensors with the state threaded explicitly:

    eff = Biquad("lowpass", 1000.0)
    eff.prepare(48000.0, channels=2)
    y, state = eff.process(x, eff.init_state(2))

Chunked processing with carried state equals one-shot processing up to
f32 rounding (``tests/test_torch_effects.py``).

:class:`UnportedEffect` stands in for an effect class that exists only in
the JAX package (a user effect registered there: its stage runs ``jnp``
code the port cannot call). It keeps the type's name and its attributes
as plain values; ``bounce`` refuses a session that holds one and names
it. Register a port class under the same name
(``effects/registry.py::register_effect``) to render it.
"""

from __future__ import annotations

import torch

#: what refuses an effect class that exists only in the JAX package
UNPORTED_EFFECT_TODO = ("it is registered only in the JAX package; register a port class "
                        "under the same name with whitebox_tpu_torch.effects.register_effect")


class Effect:
    """Base class; subclasses implement init_state/process."""

    name = "effect"

    def __init__(self) -> None:
        self.sample_rate: float | None = None

    def prepare(self, sample_rate: float, channels: int = 2) -> "Effect":
        self.sample_rate = float(sample_rate)
        return self

    def init_state(self, channels: int):
        return None

    def process(self, x, state):
        raise NotImplementedError

    def tail_frames(self) -> int:
        """Ring-out length hint (PluginInterface tail queries)."""
        return 0

    # --- the generic pipeline's stage protocol (see effects/registry.py)
    def static_config(self) -> tuple:
        """Hashable static config, part of the chain-grouping signature."""
        return ()

    def param_arrays(self) -> dict:
        """Per-instance numeric params, stacked [B, ...] across a group."""
        return {}

    def latency_frames(self) -> int:
        """Processing latency (PluginInterface latency query); nonzero for
        lookahead effects, it drives ``bounce(pdc=True)``."""
        return 0


class EffectChain(Effect):
    """Sequential composition of effects (the track's effect slots)."""

    name = "chain"

    def __init__(self, effects: list[Effect] | None = None) -> None:
        super().__init__()
        self.effects: list[Effect] = list(effects or [])

    def append(self, effect: Effect) -> "EffectChain":
        self.effects.append(effect)
        return self

    def prepare(self, sample_rate: float, channels: int = 2) -> "EffectChain":
        super().prepare(sample_rate, channels)
        for e in self.effects:
            e.prepare(sample_rate, channels)
        return self

    def init_state(self, channels: int):
        return [e.init_state(channels) for e in self.effects]

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x))
        new_states = []
        for e, st in zip(self.effects, state):
            x, ns = e.process(x, st)
            new_states.append(ns)
        return x, new_states

    def tail_frames(self) -> int:
        return sum(e.tail_frames() for e in self.effects)

    def latency_frames(self) -> int:
        return sum(e.latency_frames() for e in self.effects)

    def __len__(self) -> int:
        return len(self.effects)

    def __iter__(self):
        return iter(self.effects)


class UnportedEffect(Effect):
    """An effect class without a port counterpart: its type name
    (``type_name``, the class name), its stage kind (``name``) and its
    attributes as plain values (``attrs``)."""

    def __init__(self, type_name: str, name: str, attrs: dict | None = None) -> None:
        super().__init__()
        self.type_name = type_name
        self.name = name
        self.attrs = dict(attrs or {})

    def process(self, x, state):
        raise NotImplementedError(
            f"whitebox_tpu_torch cannot run the {self.type_name} effect: {UNPORTED_EFFECT_TODO}")

    def __repr__(self) -> str:
        return f"UnportedEffect({self.type_name!r})"
