"""Audio seconds of the whole exports in the window per second of the window."""

from wbbench.lib import stats


def read(run):
    return stats.window_rate(run.units) if run.units else None
