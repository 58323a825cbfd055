"""The render's share of its roofline, in %: the benchmark's least time for the
traced exports (``lib/roofline.py``: bytes over 3.35 TB/s or f32 operations
over 67 TFLOP/s, the larger, counted from each export's session description)
over their device time: the CUDA-event ``RenderStats.device_seconds`` of
``bounce``, or the profiler's kernel time where the entry keeps no stats
(stems)."""

from wbbench.lib import roofline


def read(run):
    if not run.traced:
        return None
    least = sum(roofline.least_seconds(*roofline.count(run.desc_of(u), run.deliverable, run.kind)) for u in run.traced)
    if all(u.stats is not None for u in run.traced):
        device = sum(u.stats.device_seconds for u in run.traced)
    elif run.trace is not None:
        device = sum(e - s for _n, s, e, cat in run.trace.ops if cat == "kernel") * 1e-6
    else:
        return None
    return 100.0 * least / device if device > 0 else None
