"""Median service time of the traced ``next_block`` pulls, in ms (benchmark clock)."""

from wbbench.lib import stats


def read(run):
    return stats.median([u.seconds for u in run.traced]) * 1e3 if run.traced else None
