"""Mean host time of a traced export's upload, in ms: the program's span
``wb.upload`` (the pool and the plan tables copied to the card from
pageable memory, so the host waits for them)."""

from wbbench.lib.spans import per_export_ms


def read(run):
    return per_export_ms(run, "wb.upload")
