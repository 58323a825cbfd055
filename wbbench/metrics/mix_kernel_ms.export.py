"""Mean device time of a traced export's mix kernel, in ms: ``RenderStats``'
CUDA-event ``device_seconds`` less its ``finish_seconds``."""


def read(run):
    legs = [u.stats.device_seconds - u.stats.finish_seconds for u in run.traced if u.stats is not None]
    return sum(legs) / len(legs) * 1e3 if legs else None
