"""Framework logging — replaces the reference's Log::info/error macros
(core/debug.h). Standard `logging` under the "whitebox_tpu_torch" namespace;
silent by default (NullHandler), `configure(verbose=...)` attaches a
stderr handler for CLI runs.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("whitebox_tpu_torch")
logger.addHandler(logging.NullHandler())


def get_logger(name: str | None = None) -> logging.Logger:
    return logger if not name else logger.getChild(name)


def configure(verbose: bool = False, level: int | None = None) -> None:
    """Attach a stderr handler (idempotent); -v selects DEBUG."""
    if level is None:
        level = logging.DEBUG if verbose else logging.INFO
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.NullHandler)
               for h in logger.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
