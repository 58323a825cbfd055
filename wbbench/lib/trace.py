"""The traced run: ``torch.profiler`` over part of the window, reduced to
device operations, the benchmark's spans, busy time and idle gaps.

The benchmark's spans are ``record_function`` ranges it opens itself around
the calls it makes (``export.call``, ``preview.pull``, ``preview.wait``,
...): the program has none on these paths yet. The profiler's Chrome trace
is read back from a file in the temporary directory and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the outermost span, which the traced window is
WINDOW_SPAN = "wb.window"


@dataclass
class TraceData:
    #: (name, start_us, end_us, category) of every device operation in the window
    ops: list = field(default_factory=list)
    #: (name, start_us, end_us) of the benchmark's spans
    spans: list = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the window."""
        iv = sorted((max(s, self.start_us), min(e, self.end_us)) for _, s, e, _ in self.ops)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def op_seconds(self, pred) -> float:
        """Device seconds of the operations whose name satisfies ``pred``."""
        return sum(e - s for n, s, e, _ in self.ops if pred(n)) * 1e-6

    def _innermost(self, t: float) -> str:
        best = None
        for name, s, e in self.spans:
            if s <= t < e and name != WINDOW_SPAN and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "harness"

    def idle_gaps(self) -> list:
        """Idle time inside the window by label, longest first: the innermost
        benchmark span open at the gap, and the device operations before and
        after it (what the host was finishing and preparing)."""
        total = defaultdict(float)
        busy = self.busy_intervals()
        ends = sorted(self.ops, key=lambda o: o[2])
        starts = sorted(self.ops, key=lambda o: o[1])
        i = j = 0
        prev = "window start"
        cursor = self.start_us
        for s, e in busy + [[self.end_us, self.end_us]]:
            if s > cursor:
                while j < len(ends) and ends[j][2] <= cursor:
                    prev = ends[j][0]
                    j += 1
                while i < len(starts) and starts[i][1] < s:
                    i += 1
                nxt = starts[i][0] if i < len(starts) else "window end"
                label = f"{self._innermost(0.5 * (cursor + s))}: {prev[:48]} -> {nxt[:48]}"
                total[label] += (s - cursor) * 1e-6
            cursor = max(cursor, e)
        return sorted(total.items(), key=lambda kv: -kv[1])

    def top_ops(self) -> list:
        """Device seconds by operation name, largest first."""
        total = defaultdict(float)
        for n, s, e, _ in self.ops:
            total[n[:120]] += (e - s) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def breakdown(self, n: int = 10) -> dict:
        return {"device_ops": [[k, v] for k, v in self.top_ops()[:n]],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps()[:n]]}


def parse_chrome_trace(events: list) -> TraceData:
    """Reduce a Chrome trace's events to :class:`TraceData` over the
    ``wb.window`` span (the whole trace without one)."""
    spans, ops = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, s, e, cat))
        elif cat == "user_annotation" and (name.startswith("wb.") or "." in name):
            spans.append((name, s, e))
    win = [sp for sp in spans if sp[0] == WINDOW_SPAN]
    if win:
        start, end = win[0][1], win[0][2]
    else:
        times = [o[1] for o in ops] + [o[2] for o in ops]
        start, end = (min(times), max(times)) if times else (0.0, 0.0)
    ops = [o for o in ops if o[2] > start and o[1] < end]
    spans.sort(key=lambda sp: sp[1])
    return TraceData(ops=ops, spans=spans, start_us=start, end_us=end)


class Tracer:
    """``torch.profiler`` with CPU and CUDA activities around a ``wb.window`` span."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._torch.cuda.is_available() else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> TraceData:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="wbbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return parse_chrome_trace(events)
