"""Mean host time of a traced export's carve, in ms: the program's span
``wb.carve`` less its nested ``wb.pool.flatten`` (the edit stamp, the
transport grids, the clip flatten and walk)."""

from wbbench.lib.spans import per_export_ms


def read(run):
    return per_export_ms(run, "wb.carve", minus=("wb.pool.flatten",))
