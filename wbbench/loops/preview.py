"""The ``preview`` loop: a ``PreviewStream`` of the base session, pulled on
the block clock.

Traffic parameters: ``lookahead_blocks`` (the stream's), ``warm`` (pulls of
another stream of the same session in set-up: a pull advances the effects'
state, so the window's stream is a fresh one), ``trace_seconds``. Pulls are
issued on the block clock (``buffer_size / sample_rate``) from the start of
the song, and after a pull that overruns, at the next period boundary after
it returns. The check compares every pulled block, in order, with the same
frames of the reference mix.
"""

from __future__ import annotations

import time

import numpy as np

from wbbench.lib import stats
from wbbench.lib.check import Reference, compare
from wbbench.lib.loop import Context, Unit, Window, span


def stream(session, sample_rate: float, buffer_size: int, lookahead_blocks: int, device: str):
    """A ``PreviewStream`` of ``session``; ``next_block()`` is the timed pull."""
    from whitebox_tpu_torch.render.preview import PreviewStream

    return PreviewStream(session, sample_rate=sample_rate, buffer_size=buffer_size,
                         lookahead_blocks=lookahead_blocks, device=device)


class Loop:
    deliverable = "mix"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.base = ctx.sessions.generate(ctx.config, ctx.seed)
        self.rate = float(ctx.config["sample_rate"])
        self.session = ctx.program.build(self.base)
        self.stream = None

    def _stream(self):
        return stream(self.session, self.rate, int(self.ctx.config["buffer_size"]),
                      int(self.ctx.traffic["lookahead_blocks"]), self.ctx.device)

    def desc_of(self, unit):
        return self.base

    def warm(self) -> None:
        s = self._stream()
        for _ in range(int(self.ctx.traffic.get("warm", 1))):
            s.next_block()
        del s
        self.stream = self._stream()

    def run(self, seconds: float, tracer=None) -> Window:
        trace_seconds = float(self.ctx.traffic.get("trace_seconds", seconds))
        bs = int(self.ctx.config["buffer_size"])
        period = bs / self.rate
        units, blocks = [], []
        trace, traced = None, []
        if tracer is not None:
            tracer.start()
        t_start = time.perf_counter()
        due = t_start
        i = 0
        while True:
            wait = due - time.perf_counter()
            if wait > 0:
                with span(tracer, "preview.wait"):
                    time.sleep(wait)
            t0 = time.perf_counter()
            with span(tracer, "preview.pull"):
                block = self.stream.next_block()
            t1 = time.perf_counter()
            if block is None:
                break
            blocks.append(block)
            units.append(Unit(i, t0, t1, bs / self.rate))
            if tracer is not None and t1 - t_start >= trace_seconds:
                trace, traced = tracer.stop(), list(units)
                tracer = None
            i += 1
            if t1 - t_start >= seconds:
                break
            due = stats.next_issue(t_start, period, t1)
        if tracer is not None:
            trace, traced = tracer.stop(), list(units)
        self.stream = None
        return Window(units, units[0].start, units[-1].end, blocks=blocks, trace=trace, traced=traced)

    def release(self) -> None:
        self.session = None
        self.stream = None

    def check(self, window, keys, control: bool = False) -> list:
        if not window.blocks:
            return []
        out = np.concatenate(window.blocks, axis=1)
        return [compare(out, Reference(self.base, self.ctx.reference, control).prefix(out.shape[1]), keys)]
