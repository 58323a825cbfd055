"""User-effect registry, the plughost plugin-manager analogue.

Counterpart of ``whitebox_tpu/effects/registry.py``. Any ``Effect``
subclass that can serialize itself (``as_dict``/``from_dict``) registers
under a type name and then round-trips through ``.wb`` like the built-in
family::

    @register_effect("myfx")
    class MyFx(Effect):
        def as_dict(self): return {"amount": self.amount}
        @classmethod
        def from_dict(cls, d): return cls(float(d["amount"]))

The persisted form is ``{"type": <name>, "state": <as_dict blob>}``. An
unknown type on load becomes an :class:`UnknownEffect`, which processes as
a bypass and re-serializes its document verbatim.

To ride the batched generic pipeline (``render/effects_generic.py``), a
registered class implements the stage protocol on torch tensors:

- ``static_config() -> tuple``: hashable config, part of the group
  signature;
- ``param_arrays() -> dict``: per-instance numeric params, stacked across
  the group into ``[B, ...]`` tensors;
- ``stage_init_state(static, params, B, C)`` classmethod -> state;
- ``stage_apply(static, params, x, state, n0, sample_rate, key=None,
  lanes=None)`` classmethod: ``x [B, C, Fc] -> (y, new_state)``, chunked
  equal to one-shot. ``lanes`` holds per-frame automation values
  ``{name: [B, Fc]}`` for the params listed in an ``automatable`` class
  attribute.

Optionally ``reference_process(x_f64, lanes=None) -> y_f64``, the f64
host reference ``reference_run_chain`` uses; without it the effect's own
``process`` serves. A class registered only in the JAX package cannot
cross to the port (its stage runs ``jnp`` code): ``session/convert.py``
keeps it as an ``UnportedEffect`` and ``bounce`` names it.
"""

from __future__ import annotations

from whitebox_tpu_torch.effects.base import Effect
from whitebox_tpu_torch.log import get_logger

_log = get_logger("effects.registry")

#: .wb type tags owned by the built-in family; registrations may not shadow them
BUILTIN_TYPES = frozenset({
    "gain", "biquad", "eq", "linphase", "compressor", "limiter", "gate",
    "delay", "chorus", "flanger", "convreverb", "saturator", "width",
})

_REGISTRY: dict[str, type[Effect]] = {}
_BY_CLASS: dict[type, str] = {}


def register_effect(type_name: str, cls: type[Effect] | None = None):
    """Register ``cls`` under ``type_name`` for ``.wb`` persistence and the
    generic pipeline; usable directly or as a class decorator.

    ``cls`` must subclass :class:`Effect` and define ``as_dict`` and
    ``from_dict``; ``type_name`` must not be a built-in tag. Registration
    sets ``cls.name = type_name`` (the stage kind). The same class again is
    a no-op; another class under a taken name replaces it with a warning."""
    if cls is None:
        return lambda c: register_effect(type_name, c)
    if not isinstance(type_name, str) or not type_name:
        raise ValueError(f"effect type name must be a non-empty str, got {type_name!r}")
    if type_name in BUILTIN_TYPES:
        raise ValueError(f"effect type {type_name!r} is a built-in; pick another name")
    if not (isinstance(cls, type) and issubclass(cls, Effect)):
        raise TypeError(f"{cls!r} must be an Effect subclass")
    if not callable(getattr(cls, "as_dict", None)) or not callable(getattr(cls, "from_dict", None)):
        raise TypeError(f"{cls.__name__} must define as_dict(self) and from_dict(cls, d) "
                        f"to persist through .wb")
    prev = _REGISTRY.get(type_name)
    if prev is not None and prev is not cls:
        _log.warning("effect type %r re-registered: %s -> %s", type_name, prev.__name__, cls.__name__)
        _BY_CLASS.pop(prev, None)
    cls.name = type_name
    _REGISTRY[type_name] = cls
    _BY_CLASS[cls] = type_name
    return cls


def unregister_effect(type_name: str) -> None:
    cls = _REGISTRY.pop(type_name, None)
    if cls is not None:
        _BY_CLASS.pop(cls, None)


def lookup_effect(type_name: str):
    """Registered class for a .wb type tag, or None."""
    return _REGISTRY.get(type_name)


def type_name_of(cls: type) -> str | None:
    """Registry name of a class (the exact class only)."""
    return _BY_CLASS.get(cls)


class UnknownEffect(Effect):
    """A persisted effect whose type is not registered: a bypass (latency
    and tail 0) that re-serializes the original document verbatim."""

    name = "unknown"

    def __init__(self, type_name: str, state: dict | None = None) -> None:
        super().__init__()
        self.type_name = str(type_name)
        self.state = dict(state or {})

    def init_state(self, channels: int):
        return ()

    def process(self, x, state):
        return x, state

    def static_config(self) -> tuple:
        return (self.type_name,)

    @classmethod
    def stage_init_state(cls, static, params, B: int, C: int):
        return ()

    @classmethod
    def stage_apply(cls, static, params, x, state, n0, sample_rate, key=None, lanes=None):
        return x, state

    def as_dict(self) -> dict:
        return dict(self.state)

    @classmethod
    def from_dict(cls, d: dict) -> "UnknownEffect":  # pragma: no cover
        raise TypeError("UnknownEffect is constructed by the loader, not from_dict")

    def __repr__(self) -> str:
        return f"UnknownEffect({self.type_name!r})"
