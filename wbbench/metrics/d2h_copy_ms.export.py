"""Device time of device-to-host copies per traced export, in ms (``torch.profiler``)."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    seconds = run.trace.op_seconds(lambda name: "DtoH" in name)
    return seconds / len(run.traced) * 1e3 if seconds > 0 else None
