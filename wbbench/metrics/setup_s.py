"""Seconds from the process's start to the first timed export or pull."""


def read(run):
    return run.setup_s
