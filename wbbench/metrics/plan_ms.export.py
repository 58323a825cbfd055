"""Mean host time of a traced export's plan, in ms: the program's span
``wb.plan`` (interpolation resolve, cost estimate, slot plan, the per-track
limit)."""

from wbbench.lib.spans import per_export_ms


def read(run):
    return per_export_ms(run, "wb.plan")
