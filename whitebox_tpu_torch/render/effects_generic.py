"""Which sessions the linear finishers can take.

Counterpart of ``whitebox_tpu/render/effects_generic.py:35,96-145``: the
predicates that decide between the linear time-invariant finishers
(``effects_pipeline.finish_mix``, ``effects_fir``) and the generic
pipeline. The generic pipeline itself (chain grouping, the nonlinear and
long-memory stages, effect-parameter lanes) is ROADMAP.md queue 1,
item 6; ``bounce`` refuses what only it could finish.
"""

from __future__ import annotations

from whitebox_tpu_torch.effects import Biquad, EffectChain, Gain, ParametricEQ
from whitebox_tpu_torch.ops.automation import session_has_effect_automation
from whitebox_tpu_torch.render.effects_pipeline import _chains_of

_PACKABLE = ("gain", "biquad", "eq")


def _kind_of(e) -> str:
    """Stage kind alone, safe on unprepared effects."""
    if isinstance(e, Gain):
        return "gain"
    if isinstance(e, Biquad):
        return "biquad"
    if isinstance(e, ParametricEQ):
        return "eq"
    return e.name


def chain_is_packable(chain) -> bool:
    """True if every effect reduces to biquad sections (the LTI paths)."""
    if chain is None:
        return True
    effs = chain.effects if isinstance(chain, EffectChain) else list(chain)
    return all(_kind_of(e) in _PACKABLE for e in effs)


def session_fx_packable(session) -> bool:
    if session_has_effect_automation(session):
        return False  # timed effect params run in the generic pipeline
    chains, master = _chains_of(session)
    return all(chain_is_packable(c) for c in chains) and chain_is_packable(master)
