"""What a metric reader reads: the window's units, the traced part, the
trace, the set-up time, and the loop that ran them."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RunData:
    cell: str
    config: dict
    traffic: dict
    #: every timed unit of the window (``lib/loop.py::Unit``)
    units: list
    setup_s: float
    #: the units inside the traced part of the window, and its trace (traced runs only)
    traced: list = field(default_factory=list)
    trace: object = None
    #: the cell's loop object (``loops/<loop>.py::Loop``)
    loop: object = None

    def desc_of(self, unit):
        """The session description a unit rendered."""
        return self.loop.desc_of(unit)

    @property
    def deliverable(self) -> str:
        return self.loop.deliverable

    @property
    def kind(self):
        """The reference module of the configuration's kind of session (``reference/<kind>.py``)."""
        return self.loop.ctx.reference
