"""Mean device time of a traced export's effects finisher, in ms (``RenderStats.finish_seconds``,
CUDA events); nothing to read on an export without one."""


def read(run):
    legs = [u.stats.finish_seconds for u in run.traced if u.stats is not None]
    return sum(legs) / len(legs) * 1e3 if legs and any(v > 0 for v in legs) else None
