"""Mean host time of a traced export's pool flatten, in ms: the program's
span ``wb.pool.flatten`` (0 for an export whose pool came from the
program's cache); nothing to read where the program opens no ``wb.carve``."""

from wbbench.lib.spans import per_export_ms


def read(run):
    return per_export_ms(run, "wb.pool.flatten", present="wb.carve")
