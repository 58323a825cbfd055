"""99th percentile (nearest rank) of the service times of the window's ``next_block`` pulls, in ms."""

from wbbench.lib import stats


def read(run):
    return stats.percentile([u.seconds for u in run.units], 99) * 1e3 if run.units else None
