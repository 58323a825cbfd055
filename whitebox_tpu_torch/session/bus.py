"""Aux buses, track groups, and sends — a routing extension.

The reference mixes a flat track list straight into one output
(engine.cpp:1600-1617; SURVEY §2.9 notes "No master-bus effects/sends/
groups"). This module adds the routing surface every production mixer
has and the reference lacks:

- **Bus**: a named mix destination with its own effect chain and
  volume/pan/mute fader, summed into the master bus after processing.
- **Group routing**: ``Track.output_bus = b`` sends the track's finished
  signal (post chain, post fader) to bus ``b`` instead of the master.
- **Sends**: ``Track.sends`` taps a copy of the track signal into a bus,
  either **post-fader** (after volume/pan/mute — the default) or
  **pre-fader** (straight off the track chain output, before the fader).

Signal flow (one level of buses; buses sum to master in index order):

    track chain -> [pre tap] -> volume*pan*mute -> [post tap] -> destination
    bus_in[b]  = sum(group-routed post) + sum(send taps * send gain)
    bus_out[b] = bus chain(bus_in[b]) * bus volume*pan*mute
    master_in  = sum(master-routed post) + sum(bus_out, index order)
    master     = master chain(master_in) -> hard clip

Because the whole flow is linear up to the bus chains, the device
pipelines evaluate it as two small routing matrices ([1+B, T] post /
[B, T] pre) applied with an MXU einsum — see render pipelines. The f64
host ground truth is ``render.routing.reference_routed_finish``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from whitebox_tpu_torch.core.math import db_to_linear_f32
from whitebox_tpu_torch.core.panning import PanningLaw, calculate_panning_coefs


@dataclass
class Send:
    """One aux send: tap this track into ``bus`` at ``gain_db``.

    ``pre_fader=False`` taps post volume/pan/mute (the classic FX send);
    ``pre_fader=True`` taps the track-chain output before the fader
    (monitor/cue-style). Gains use the engine's dB mapping (−72 dB floor
    maps to 0 == send off, core_math.h:84 semantics).

    ``sidechain=True`` routes the tap into the bus's KEY input instead of
    its audio input: sidechain-flagged dynamics stages on the bus chain
    (``Compressor(sidechain=True)`` / ``NoiseGate(sidechain=True)``) use
    it as their detector signal (classic kick-ducks-bass compression).
    The key never reaches the bus audio.
    """

    bus: int
    gain_db: float = 0.0
    pre_fader: bool = False
    sidechain: bool = False

    @property
    def gain_linear(self) -> np.float32:
        return np.float32(db_to_linear_f32(self.gain_db))


@dataclass
class Bus:
    """A mix bus: effect chain + fader, summed into the master bus."""

    name: str = ""
    volume_db: float = 0.0
    pan: float = 0.0
    mute: bool = False
    #: effect chain (list of effects.base.Effect / EffectChain), same
    #: surface as Track.effects.
    effects: list = field(default_factory=list)
    #: ops.automation.TrackAutomation: volume/pan lanes ride the bus fader
    #: per frame; ``effects`` lanes target the bus chain's params (same
    #: machinery as track chains). None == static fader.
    automation: object = None

    @property
    def volume_linear(self) -> np.float32:
        return np.float32(db_to_linear_f32(self.volume_db))

    @property
    def pan_coeffs(self) -> tuple[np.float32, np.float32]:
        return calculate_panning_coefs(self.pan, PanningLaw.CONSTANT_POWER_3DB)

    def gain(self, channels: int = 2) -> np.ndarray:
        """Constant fader gain per channel, f32 (track.cpp:728 op order)."""
        vol = np.float32(0.0) if self.mute else self.volume_linear
        pan = self.pan_coeffs
        return np.array([np.float32(vol * np.float32(pan[c % 2])) for c in range(channels)],
                        dtype=np.float32)


def session_has_routing(session) -> bool:
    """True when any bus routing exists (buses defined AND referenced, or
    any send) — the render must then take a routed finishing path."""
    buses = getattr(session, "buses", None)
    if not buses:
        return False
    return any(t.output_bus is not None or t.sends for t in session.tracks) or any(
        b.effects for b in buses
    )


class RoutingMatrices(NamedTuple):
    """Host-side routing constants for the device pipelines.

    ``r_post [1+B, T]``: row 0 is the master-direct mask, rows 1..B are
    per-bus accumulation weights over the post-fader track signals.
    ``r_pre [B, T]``: pre-fader send weights (track-chain output).
    ``bus_gain [B, C]``: per-bus fader gains.
    ``k_post/k_pre [B, T]``: sidechain KEY send weights (post/pre fader) —
    they feed the detector input of sidechain-flagged dynamics stages on
    the bus chain, never the bus audio.
    """

    r_post: np.ndarray
    r_pre: np.ndarray
    bus_gain: np.ndarray
    k_post: np.ndarray
    k_pre: np.ndarray


def build_routing_matrices(session, channels: int = 2) -> RoutingMatrices:
    """Build :class:`RoutingMatrices` from the session's routing fields.

    A track routed to an out-of-range bus raises (the edit API keeps
    indices valid; direct mutation is caught here).
    """
    buses = getattr(session, "buses", [])
    B, T = len(buses), len(session.tracks)
    r_post = np.zeros((1 + B, T), dtype=np.float32)
    r_pre = np.zeros((B, T), dtype=np.float32)
    k_post = np.zeros((B, T), dtype=np.float32)
    k_pre = np.zeros((B, T), dtype=np.float32)
    for t, tr in enumerate(session.tracks):
        dest = tr.output_bus
        if dest is None:
            r_post[0, t] += np.float32(1.0)
        else:
            if not (0 <= dest < B):
                raise IndexError(f"track {t} routed to bus {dest}, have {B}")
            r_post[1 + dest, t] += np.float32(1.0)
        for s in tr.sends:
            if not (0 <= s.bus < B):
                raise IndexError(f"track {t} sends to bus {s.bus}, have {B}")
            g = s.gain_linear
            if s.sidechain:
                (k_pre if s.pre_fader else k_post)[s.bus, t] += g
            elif s.pre_fader:
                r_pre[s.bus, t] += g
            else:
                r_post[1 + s.bus, t] += g
    bus_gain = np.stack([b.gain(channels) for b in buses]) if B else np.zeros((0, channels), np.float32)
    return RoutingMatrices(r_post, r_pre, bus_gain, k_post, k_pre)
