"""Mean host time of a traced export's chain preparation, in ms: the
program's span ``wb.fx.prepare`` (chain and lane tables, track gains, the
finisher's set-up)."""

from wbbench.lib.spans import per_export_ms


def read(run):
    return per_export_ms(run, "wb.fx.prepare")
