"""The program's own spans in a traced run, read as host legs.

The program opens a ``record_function`` range named ``wb.<leg>`` around
each host leg of an export while the profiler records
(``whitebox_tpu_torch/render/metrics.py::span``): ``wb.bounce`` or
``wb.stems`` around the call, and inside it ``wb.carve`` (with
``wb.pool.flatten`` nested on a pool-cache miss), ``wb.plan``,
``wb.upload``, ``wb.fx.prepare``, ``wb.mix``, ``wb.finish`` and
``wb.readback``. ``lib/trace.py`` keeps them among ``TraceData.spans``,
on the device trace's clock. A program without them (before it had
spans) gives nothing to read.
"""

from __future__ import annotations


def self_seconds(spans, name: str, minus=()) -> float:
    """Seconds of the spans named ``name``, each less the part of it that
    the spans named in ``minus`` cover (their union, clipped to it)."""
    total = 0.0
    for n, s, e in spans:
        if n != name:
            continue
        covered, cursor = 0.0, s
        for _n, cs, ce in sorted((sp for sp in spans if sp[0] in minus), key=lambda sp: sp[1]):
            cs, ce = max(cs, cursor), min(ce, e)
            if ce > cs:
                covered += ce - cs
                cursor = ce
        total += (e - s) - covered
    return total * 1e-6


def per_export_ms(run, name: str, minus=(), present: str | None = None):
    """Mean self time of span ``name`` per traced export, in ms (0 where an
    export opened none); None without a trace, or where the trace holds no
    span named ``present`` (default ``name``): the program has no such span."""
    if run.trace is None or not run.traced:
        return None
    spans = run.trace.spans
    if not any(n == (present or name) for n, _s, _e in spans):
        return None
    return self_seconds(spans, name, minus) / len(run.traced) * 1e3
