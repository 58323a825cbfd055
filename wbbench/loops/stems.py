"""The ``stems`` loop: edit, then export every track's stem by the program's
``render_stems`` (the closed export loop of ``lib/loop.py``).

Traffic parameters: as ``bounce``'s. The check compares every stem of each
kept export with the reference stem of the session state it rendered: the
edited track's against its edit's, every other track's against the base's
(an edit changes one track), each reference stem made once, the tracks on
a thread pool.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from wbbench.lib.check import Reference, compare, threads
from wbbench.lib.loop import ExportLoop


def export(session, sample_rate: float, device: str):
    """The stems export: ``render_stems`` -> ``[T, C, F]`` in host memory."""
    from whitebox_tpu_torch.render.stems import render_stems

    out, _names = render_stems(session, sample_rate, device=device)
    return out, None


class Loop(ExportLoop):
    deliverable = "stems"

    def export(self):
        return export(self.session, self.rate, self.ctx.device)

    def check(self, window, keys, control: bool = False) -> list:
        items = sorted(window.kept.items())
        if not items:
            return []
        variants = {i: self.variant(i) for i, _ in items}
        ref = Reference(self.base, self.ctx.reference, control)

        def track(t):
            base_stem = None
            rows = []
            for i, out in items:
                v = variants[i]
                if t == v.track:
                    stem = ref.stem(v.desc, t)
                else:
                    if base_stem is None:
                        base_stem = ref.stem(self.base, t)
                    stem = base_stem
                rows.append(compare(out[t], stem, keys) if t < out.shape[0] else {k: float("inf") for k in keys})
            return rows

        with ThreadPoolExecutor(threads()) as ex:
            return [r for rows in ex.map(track, range(len(self.base.tracks))) for r in rows]
