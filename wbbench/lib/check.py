"""What decides ``correct``: the program's outputs from the window against the
plain reference (``reference/``), each compared number beside its limit
(``limits/<cell>.json``).

Each cell compares the numbers its limits file names, each the worst over
the checked outputs:

- ``max_abs_err``: the largest ``|program - reference|`` of any sample, in
  full-scale units;
- ``rel_rms_err``: ``||program - reference|| / ||reference||`` of one output;
- ``max_ulp_err``: the largest ``|program - reference|`` in units in the
  last place of the f32 reference sample (the configuration's own
  guarantee for a mix without chains: within 1 ulp of the engine's f32 mix).

The per-track signals come from the reference of the configuration's kind
of session (``reference/<kind>.py``, its ``Render``), the chains from each
entry's reference (``reference/fx/<type>.py``, by ``lib/chains.py``). The
reference of a session without chains is the engine's exact f32 mix (the
ordered track sum); with chains it is computed in f64 (the f32 per-track
signal through each chain entry, the track gains, the sum, the master
chain, the clip). ``control=True`` computes the same in bfloat16 (each
stored signal and each elementwise result rounded to bfloat16; each chain
entry in f64 between a bfloat16 input and a bfloat16 output), the
precision below the configuration's f32: the control that has to come out
not correct.

Which outputs of the window are compared, and against which of these
renders, is the loop's to say (``loops/<loop>.py``, its ``check``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wbbench.lib import chains

#: frames a worker takes at once on the exact (chain-free) path, and through a chain
EXACT_CHUNK = 1 << 16
CHAIN_CHUNK = 1 << 18


def to_bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), returned as f32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


#: every number a limits file may name
NUMBERS = ("max_abs_err", "rel_rms_err", "max_ulp_err")


def threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def compare(out: np.ndarray, ref: np.ndarray, keys=NUMBERS) -> dict:
    """The compared numbers ``keys`` of one output against its reference."""
    if out.shape != ref.shape:
        return {k: float("inf") for k in keys}
    d = np.asarray(out, dtype=np.float64) - np.asarray(ref, dtype=np.float64)
    r = {}
    ad = np.abs(d) if {"max_abs_err", "max_ulp_err"} & set(keys) else None
    if "max_abs_err" in keys:
        r["max_abs_err"] = float(ad.max()) if d.size else 0.0
    if "rel_rms_err" in keys:
        den = float(np.sqrt(np.sum(np.square(ref, dtype=np.float64))))
        num = float(np.sqrt(np.sum(d * d)))
        r["rel_rms_err"] = num / den if den > 0 else num
    if "max_ulp_err" in keys:
        ulp = np.spacing(np.abs(ref.astype(np.float32))).astype(np.float64)
        r["max_ulp_err"] = float((ad / ulp).max()) if d.size else 0.0
    return r


class Reference:
    """The reference renders of one description (and of variants that differ
    from it on single tracks); ``kind`` is the reference module of its kind
    of session (``reference/<kind>.py``)."""

    def __init__(self, desc, kind, control: bool = False):
        self.desc = desc
        self.control = control
        self.render = kind.Render(desc)
        self.F = self.render.frames
        self.C = desc.channels
        self.assets = [to_bf16(a) for a in desc.assets] if control else None
        self.has_chains = bool(desc.master_chain) or any(tr.chain for tr in desc.tracks)
        self._after = (lambda y: to_bf16(y.astype(np.float32))) if control else None

    # ---- per track -------------------------------------------------------

    def _signal(self, desc, t, f0, f1):
        x = self.render.signal(desc, t, f0, f1, self.assets)
        return to_bf16(x) if self.control else x

    def _gain(self, desc, t):
        g = self.render.gain(desc, t)
        return to_bf16(g) if self.control else g

    def _scaled_into(self, desc, t, acc, sign=1.0, f1=None):
        """``acc[:, :f1] += sign * track t post chain and gain`` (f64), the
        chain run chunk by chunk with its state carried, so that no
        full-length temporary is made."""
        f1 = self.F if f1 is None else f1
        chain = desc.tracks[t].chain
        g = self._gain(desc, t).astype(np.float64)[:, None] * sign
        states = None
        for f0 in range(0, f1, CHAIN_CHUNK):
            f2 = min(f0 + CHAIN_CHUNK, f1)
            x = self._signal(desc, t, f0, f2)
            if chain:
                x, states = chains.process(chain, x.astype(np.float64), states, desc.sample_rate, self._after)
            y = x * g
            if self.control:
                y = to_bf16(y.astype(np.float32))
            acc[:, f0:f2] += y

    def stem(self, desc, t):
        """Track ``t`` post chain and gain, ``[C, F]`` f64."""
        acc = np.zeros((self.C, self.F), dtype=np.float64)
        self._scaled_into(desc, t, acc)
        return acc

    # ---- the mix ---------------------------------------------------------

    def _master(self, total):
        chain = self.desc.master_chain
        if chain:
            x = to_bf16(total.astype(np.float32)) if self.control else total
            total, _ = chains.process(chain, np.asarray(x, dtype=np.float64), None, self.desc.sample_rate,
                                      self._after)
        return self.render.output(total)

    def _exact_mixes(self, descs: list) -> list:
        """The exact f32 ordered sums of ``descs`` (variants of the base that
        differ on single tracks), frame chunk by frame chunk on a thread
        pool: the base's running sum is shared up to each description's
        first differing track, then its own tracks are added in order."""
        outs = [np.empty((self.C, self.F), dtype=np.float32) for _ in descs]
        base = self.desc
        T = len(base.tracks)
        first = [next((t for t in range(T) if d.tracks[t] is not base.tracks[t]), T) for d in descs]

        def scaled(d, t, f0, f1):
            x = self._signal(d, t, f0, f1) * self._gain(d, t)[:, None]
            return to_bf16(x) if self.control else x

        def add(total, x):
            np.add(total, x, out=total)
            if self.control:
                total[:] = to_bf16(total)

        def chunk(f0):
            f1 = min(f0 + EXACT_CHUNK, self.F)
            rows = [scaled(base, t, f0, f1) for t in range(T)]
            running = np.zeros((self.C, f1 - f0), dtype=np.float32)
            at = {}
            for t in range(T + 1):
                for i, e in enumerate(first):
                    if e == t:
                        at[i] = running.copy()
                if t < T:
                    add(running, rows[t])
            for i, (d, out) in enumerate(zip(descs, outs)):
                total = at[i]
                for t in range(first[i], T):
                    add(total, rows[t] if d.tracks[t] is base.tracks[t] else scaled(d, t, f0, f1))
                out[:, f0:f1] = self.render.output(total)

        with ThreadPoolExecutor(threads()) as ex:
            list(ex.map(chunk, range(0, self.F, EXACT_CHUNK)))
        return outs

    def _sum(self, desc, tracks, f1=None) -> np.ndarray:
        """The f64 sum of ``tracks`` post chain and gain, on a thread pool."""
        f1 = self.F if f1 is None else f1
        n = threads()
        accs = [np.zeros((self.C, f1), dtype=np.float64) for _ in range(min(n, len(tracks)))]

        def part(i):
            for t in tracks[i::len(accs)]:
                self._scaled_into(desc, t, accs[i], f1=f1)

        with ThreadPoolExecutor(len(accs)) as ex:
            list(ex.map(part, range(len(accs))))
        total = accs[0]
        for a in accs[1:]:
            total += a
        return total

    def _chain_mixes(self, descs: list) -> list:
        """The f64 mixes of ``descs``: the base's track sum once, then each
        description's differing tracks swapped in."""
        base = self.desc
        T = len(base.tracks)
        total = self._sum(base, list(range(T)))

        def one(d):
            tot = total.copy()
            for t in range(T):
                if d.tracks[t] is not base.tracks[t]:
                    self._scaled_into(base, t, tot, sign=-1.0)
                    self._scaled_into(d, t, tot)
            if self.control:
                tot = to_bf16(tot.astype(np.float32)).astype(np.float64)
            return self._master(tot)

        with ThreadPoolExecutor(min(threads(), len(descs))) as ex:
            return list(ex.map(one, descs))

    def mixes(self, descs: list) -> list:
        """The reference exports of ``descs`` (the base or variants of it)."""
        return self._chain_mixes(descs) if self.has_chains else self._exact_mixes(descs)

    def prefix(self, frames: int) -> np.ndarray:
        """The first ``frames`` of the base's mix (the chains run from rest, so
        a prefix is exact)."""
        frames = min(frames, self.F)
        T = len(self.desc.tracks)
        if not self.has_chains:
            total = np.zeros((self.C, frames), dtype=np.float32)
            for t in range(T):
                x = self._signal(self.desc, t, 0, frames) * self._gain(self.desc, t)[:, None]
                total = total + (to_bf16(x) if self.control else x)
                if self.control:
                    total = to_bf16(total)
            return self.render.output(total)
        total = self._sum(self.desc, list(range(T)), frames)
        if self.control:
            total = to_bf16(total.astype(np.float32)).astype(np.float64)
        return self._master(total)


def judge(readings: list, limits: dict) -> tuple:
    """``readings``: one dict of numbers per checked output. -> (worst of each
    number, how many outputs broke a limit). Every limited number has to be
    there."""
    worst = {k: max(r[k] for r in readings) if readings else float("inf") for k in limits}
    failed = sum(1 for r in readings if any(not (r[k] <= lim) for k, lim in limits.items()))
    return worst, failed
