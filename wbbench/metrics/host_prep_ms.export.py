"""Mean host legs of a traced export, in ms: ``RenderStats.carve_seconds`` as
``bounce`` fills it (carve with the pool flatten, resolve, plan, the table,
pool and chain uploads)."""


def read(run):
    legs = [u.stats.carve_seconds for u in run.traced if u.stats is not None]
    return sum(legs) / len(legs) * 1e3 if legs else None
