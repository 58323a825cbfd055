"""Device time of the preview's kernels (the gather mix and the finisher's
step) per window fetch in the traced pulls, in ms (``torch.profiler``). A
pull fetches a window when its block index is a multiple of the stream's
``lookahead_blocks``."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    per = int(run.traffic["lookahead_blocks"])
    fetches = sum(1 for u in run.traced if u.index % per == 0)
    seconds = sum(e - s for _n, s, e, cat in run.trace.ops if cat == "kernel") * 1e-6
    return seconds / fetches * 1e3 if fetches and seconds > 0 else None
