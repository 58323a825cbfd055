"""What the loops (``loops/<loop>.py``) share: the timed units and the
window, the cell's context, and the closed export loop that ``bounce`` and
``stems`` both run.

A loop module has ``Loop(ctx)``, whose object has ``warm()`` (set-up: the
shapes the window uses, once), ``run(seconds, tracer) -> Window`` (the
measured window; a traced run profiles its first ``trace_seconds``),
``release()`` (drops the program's state before the reference runs),
``check(window, keys, control=False)`` (the compared numbers ``keys`` of
each checked output, one dict each, against the plain reference, or
against the bfloat16 control in its place), ``desc_of(unit)`` (the session
description a unit rendered) and ``deliverable`` (``"mix"`` or
``"stems"``, for the roofline's count).

The export loop (``"bounce"`` and ``"stems"``): a closed loop of one user
editing and exporting. Set-up builds the configuration's session and makes
``warm`` exports. Before each export one edit is made by the session kind's
edits (``clips``: on one of ``variants`` tracks drawn from the seed, in
turn, the fader moved by ``fader_db`` dB either way, drawn afresh each
time, and the track's movable clip moved by ``clip_move_beats``; the
previous edit is undone first), so every export renders a session state
that no export before it rendered: a cache across calls has to handle the
edit. Each call is timed by the host clock from the call to the returned
array. The window starts at the first timed export and ends when the first
export completes after ``seconds``. The outputs of ``check_exports``
exports drawn from the seed among the window's first ``check_among`` are
kept for the check (the rest are dropped as they come, as a user's would
be).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from wbbench.lib.spec import part


@dataclass
class Unit:
    """One timed export or pull."""

    index: int
    start: float
    end: float
    audio_seconds: float
    stats: object = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    units: list
    start: float
    end: float
    #: what the check reads: export index -> output, or the pulled blocks
    kept: dict = field(default_factory=dict)
    blocks: list = field(default_factory=list)
    trace: object = None
    traced: list = field(default_factory=list)


@dataclass
class Context:
    """One cell's configuration and traffic parameters, the run's seed and
    device, and the modules of the configuration's kind of session."""

    config: dict
    traffic: dict
    seed: int
    device: str = "cuda"

    @property
    def sessions(self):
        """``sessions/<kind>.py``: the description from the seed, and its edits."""
        return part("sessions", self.config["session"])

    @property
    def program(self):
        """``program/<kind>.py``: the program's session of a description, and an edit on it."""
        return part("program", self.config["session"])

    @property
    def reference(self):
        """``reference/<kind>.py``: the plain per-track render of a description."""
        return part("reference", self.config["session"])


def check_rng(seed: int):
    """The seed's generator for what the check samples (independent of the session's)."""
    return np.random.default_rng(np.random.SeedSequence(abs(int(seed))).spawn(4)[3])


def span(tracer, name):
    """A benchmark span (``record_function``) in a traced run; nothing otherwise."""
    if tracer is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class ExportLoop:
    """The closed edit-then-export loop; a loop module subclasses it with
    its ``export()`` and ``check()``."""

    deliverable = "mix"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        traffic = ctx.traffic
        self.base = ctx.sessions.generate(ctx.config, ctx.seed)
        self.rate = float(ctx.config["sample_rate"])
        self.session = ctx.program.build(self.base)
        self.warm_units = int(traffic.get("warm", 1))
        self.edits = ctx.sessions.edits(self.base, ctx.seed, traffic)
        self._edited = None
        rng = check_rng(ctx.seed)
        among = int(traffic.get("check_among", 1))
        picks = rng.choice(among, size=min(int(traffic.get("check_exports", among)), among), replace=False)
        self.keep = {int(i) for i in picks}

    def export(self):
        """One export of ``self.session`` -> ``(audio in host memory, stats or None)``."""
        raise NotImplementedError

    def variant(self, index: int):
        """The edit before the window's export ``index``."""
        return self.edits[self.warm_units + index]

    def desc_of(self, unit):
        return self.variant(unit.index).desc

    def _edit(self, k: int) -> None:
        v = self.edits[k]
        self.ctx.program.edit(self.session, self.base, self._edited, v)
        self._edited = v

    def warm(self) -> None:
        for k in range(self.warm_units):
            self._edit(k)
            out, _ = self.export()
            del out

    def run(self, seconds: float, tracer=None) -> Window:
        trace_seconds = float(self.ctx.traffic.get("trace_seconds", seconds))
        units, kept = [], {}
        trace, traced = None, []
        if tracer is not None:
            tracer.start()
        t_start = time.perf_counter()
        i = 0
        while True:
            with span(tracer, "export.edit"):
                self._edit(self.warm_units + i)
            t0 = time.perf_counter()
            with span(tracer, "export.call"):
                out, st = self.export()
            t1 = time.perf_counter()
            units.append(Unit(i, t0, t1, out.shape[-1] / self.rate, st))
            with span(tracer, "export.harness"):
                if i in self.keep:
                    kept[i] = out
                del out
            if tracer is not None and t1 - t_start >= trace_seconds:
                trace, traced = tracer.stop(), list(units)
                tracer = None
            i += 1
            if t1 - t_start >= seconds:
                break
        if tracer is not None:
            trace, traced = tracer.stop(), list(units)
        return Window(units, units[0].start, units[-1].end, kept=kept, trace=trace, traced=traced)

    def release(self) -> None:
        self.session = None
