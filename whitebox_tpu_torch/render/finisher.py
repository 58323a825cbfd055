"""The finisher seam: which finisher, and the one loop that feeds it.

A finisher is the stage after the per-track mix: the effect chains, the
track gains, the ordered track sum (or the routing), the master chain, the
hard clip and the meters. Four families implement it, each in its own
module:

- ``"scan"`` (``effects_pipeline.ScanFinisher``): linear chains through
  the biquad cascade kernel;
- ``"fir"`` (``effects_fir.FirFinisher``): linear chains by FFT
  convolution, a whole buffer in one step;
- ``"generic"`` (``effects_generic.GenericFinisher``): every other chain,
  and effect-parameter lanes;
- ``"routed"`` (``routing.RoutedFinisher``): sessions with buses.

:func:`choose_finisher` names the family, :func:`make_finisher` builds it
from the session (the host preparation: chain tables, lane tables, stage
groups, routing matrices, on the device), and :func:`run` takes its
chunks. Every finisher has one shape:

- ``chunk``: frames a step (None: the whole buffer in one step);
- ``fixed``: it reads chunks of exactly ``chunk`` frames (its impulse
  response spectra are sized to the chunk), so the last chunk of a buffer
  is padded with silence; otherwise the last chunk is a short view;
- ``trim``: frames rendered past the end and trimmed off the head (the
  master chain's latency, plus the buses' under routing, with ``pdc``);
- ``ahead``: ``(rows, lat)`` pairs, the tracks whose chains have ``lat``
  frames of latency, read that far ahead under ``pdc``;
- ``init()``: its zero states;
- ``step(x, states, start, valid=None) -> (out, states, partials)``: one
  chunk ``x`` ``[T, C, n]`` at global frame ``start``. ``out`` is the mix
  ``[C, n]`` in the ``"mix"`` form; in the ``"stems"`` form the step stops
  before the sum: the post-gain tracks ``[T, C, n]``, or for the routed
  family the master-direct sum and the post-fader buses. ``partials`` are
  the meter partials over frames before ``valid`` (None without meters).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tF

from whitebox_tpu_torch.render.effects_fir import FirFinisher
from whitebox_tpu_torch.render.effects_generic import GenericFinisher, session_fx_packable
from whitebox_tpu_torch.render.effects_pipeline import ScanFinisher, meters_from_partials
from whitebox_tpu_torch.render.routing import RoutedFinisher
from whitebox_tpu_torch.session.bus import session_has_routing

FAMILIES = {"scan": ScanFinisher, "fir": FirFinisher, "generic": GenericFinisher, "routed": RoutedFinisher}


def choose_finisher(session, effects_mode: str = "scan", meters: bool = False, form: str = "mix") -> str:
    """The family that finishes ``session``: ``"routed"``, ``"generic"``,
    ``"fir"`` or ``"scan"``.

    Routing forces the routed family (buses replace the flat track sum);
    meters force the scan, which holds the per-track audio the meters read
    (a routed session stays routed); a chain the linear finishers cannot
    pack, or an effect lane, or ``effects_mode="generic"`` gives the
    generic family; else ``effects_mode`` names it. In the ``"stems"`` form
    routing forces nothing (per-track stems are taken before it), and
    ``effects_mode="routed"`` names the bus stems."""
    if form == "mix" and session_has_routing(session):
        return "routed"
    if meters:
        effects_mode = "scan"
    if effects_mode == "routed":
        return "routed"
    if effects_mode == "generic" or not session_fx_packable(session):
        return "generic"
    return effects_mode


def make_finisher(name: str, session, sample_rate: float, track_gain: torch.Tensor, *, form: str = "mix",
                  meters: bool = False, pdc: bool = False, chunk: int | None = None,
                  max_chunk: int | None = None, device="cpu"):
    """The finisher of family ``name`` for ``session``, its tables on
    ``device``. ``track_gain`` ``[T, C]`` f32 are the constant fader gains
    (the lanes come from the session); ``form`` ``"mix"`` or ``"stems"``;
    ``meters``: the steps return meter partials; ``pdc``: plugin-delay
    compensation (fetch-ahead rows and a head trim). ``chunk`` frames a
    step as given; else the family's rule picks one, up to ``max_chunk``
    where the caller's pieces bound it."""
    return FAMILIES[name](session, sample_rate, track_gain, form=form, meters=meters, pdc=pdc, chunk=chunk,
                          max_chunk=max_chunk, device=device)


@dataclass
class Run:
    """What :func:`run` returns: ``out`` the finished frames (a tuple for
    the routed stems), ``states`` after the last chunk, ``meters``
    ``(track_peak, track_rms, output_peak, output_rms)`` or None, and the
    number of chunks."""

    out: object
    states: object
    meters: tuple | None
    chunks: int


def _window(buf: torch.Tensor, a: int, n: int, pad: bool, rows=None) -> torch.Tensor:
    """Frames ``[a, a + n)`` of ``buf`` ``[T, C, F]`` (its ``rows`` only),
    a view; with ``pad`` zero past its end to ``n`` frames."""
    w = buf[..., a:a + n]
    if rows is not None:
        w = w[rows]
    return tF.pad(w, (0, n - w.shape[-1])) if pad and w.shape[-1] < n else w


def _put(dests, out, at: int, frames: int, host: bool):
    """Write a step's output (a tensor, or a tuple of them) whose first
    frame is frame ``at`` of the destinations into their frames in ``[0,
    frames)``; at the first output the destinations are allocated like it
    (``frames`` long; a host array with ``host``). -> the destinations."""
    outs = out if isinstance(out, tuple) else (out,)
    if dests is None:
        dests = [np.empty((*o.shape[:-1], frames), dtype=np.float32) if host
                 else torch.empty((*o.shape[:-1], frames), dtype=o.dtype, device=o.device) for o in outs]
    lo, hi = max(at, 0), min(at + outs[0].shape[-1], frames)
    for d, o in zip(dests, outs if hi > lo else ()):
        d[..., lo:hi] = o[..., lo - at:hi - at].cpu().numpy() if host else o[..., lo - at:hi - at]
    return dests


def run(fin, source, frames: int, *, start: int = 0, states=None, valid_frames: int | None = None,
        host: bool = False) -> Run:
    """Finish ``frames`` frames from ``source`` chunk by chunk, the states
    carried from ``states`` (default ``fin.init()``).

    ``source`` is a ``[T, C, >= frames]`` buffer whose frame 0 is global
    frame ``start``, or a callable ``chunk(start, n[, rows])`` that renders
    ``n`` frames of every track (of ``rows``) from a global frame; it is
    asked for whole chunks, past ``frames`` too. A buffer's chunks are
    views, the last padded for a ``fixed`` finisher. Under ``fin.ahead``
    the latent rows are read ahead; ``fin.trim`` frames are rendered past
    the end and trimmed off the head. Each chunk's output is written into
    one preallocated destination: on the output's device, or with ``host``
    a NumPy array on the host. The meters count frames before
    ``valid_frames`` (every frame of every chunk when None) and take their
    RMS over ``valid_frames`` (default ``frames``)."""
    from_buffer = not callable(source)
    chunk = fin.chunk or frames + fin.trim
    states = fin.init() if states is None else states
    ahead = [(torch.as_tensor(rows, device=fin.device), rows, lat) for rows, lat in fin.ahead]
    dests, parts = None, []
    starts = range(0, frames + fin.trim, chunk)
    for a in starts:
        if from_buffer:
            xc = _window(source, a, chunk, fin.fixed)
            if ahead:
                xc = xc.clone()  # a view of the caller's buffer: not written
        else:
            xc = source(start + a, chunk)
        for idx, rows, lat in ahead:
            xc[idx] = (_window(source, a + lat, chunk, True, idx) if from_buffer
                       else source(start + a + lat, chunk, rows))
        out, states, partials = fin.step(xc, states, start + a, valid_frames)
        dests = _put(dests, out, a - fin.trim, frames, host)
        parts.append(partials)
        del xc, out  # the next chunk's step runs without this chunk's input and output
    meters = None
    if parts and parts[0] is not None:
        meters = meters_from_partials(parts, frames if valid_frames is None else valid_frames)
    return Run(out=tuple(dests) if len(dests) > 1 else dests[0], states=states, meters=meters,
               chunks=len(starts))
