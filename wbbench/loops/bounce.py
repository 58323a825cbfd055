"""The ``bounce`` loop: edit, then export the mix by the program's ``bounce``
(the closed export loop of ``lib/loop.py``).

Traffic parameters: ``variants``, ``fader_db``, ``clip_move_beats`` (the
edits), ``warm``, ``check_exports``, ``check_among``, ``trace_seconds``.
The check compares each kept export with the reference mix of the session
state it rendered (its own edit).
"""

from __future__ import annotations

from wbbench.lib.check import Reference, compare
from wbbench.lib.loop import ExportLoop


def export(session, sample_rate: float, device: str):
    """The whole export: ``bounce`` from a session in host memory to the mix in host memory."""
    from whitebox_tpu_torch.render.bounce import bounce

    res = bounce(session, sample_rate, device=device)
    return res.audio, res.stats


class Loop(ExportLoop):
    deliverable = "mix"

    def export(self):
        return export(self.session, self.rate, self.ctx.device)

    def check(self, window, keys, control: bool = False) -> list:
        items = sorted(window.kept.items())
        ref = Reference(self.base, self.ctx.reference, control)
        refs = ref.mixes([self.variant(i).desc for i, _ in items])
        return [compare(out, r, keys) for (_, out), r in zip(items, refs)]
