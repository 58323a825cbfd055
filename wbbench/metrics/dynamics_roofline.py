"""The dynamics stage's share of its roofline, in %: the benchmark's least time
for the traced exports' compressor and limiter stages (``lib/dynamics_count.py``:
bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s, the larger, counted
from each export's session description) over the profiler's device time of
the ``dyn_kernel`` kernels; nothing to read where the trace holds none."""

from wbbench.lib import dynamics_count, roofline

KERNEL = "dyn_kernel"


def read(run):
    if run.trace is None or not run.traced:
        return None
    device = run.trace.op_seconds(lambda name: KERNEL in name)
    if device <= 0:
        return None
    least = sum(roofline.least_seconds(*dynamics_count.count(run.desc_of(u), run.kind)) for u in run.traced)
    return 100.0 * least / device if least > 0 else None
