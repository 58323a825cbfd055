"""The benchmark's own count of a render's least work, from the session
description (never from the program's plan, tables or kernels), and the
least time on the card by the data-sheet peaks.

- Bytes: every asset sample that some clip plays, read once (f32), and the
  deliverable written once: ``[C, F]`` for a mix, ``[T, C, F]`` for stems.
  The per-track ``[T, C, F]`` buffers a renderer may write between the mix
  and the finisher are not charged: a fused render would not write them.
- f32 operations: each track's work before its chain, as its kind's
  reference counts it (``Render.work``: clip gains and fade envelopes on the
  played frames); then per (track, channel, frame) of the track's rows the
  track gain and the ordered sum, 1 each (stems: no sum), over the played
  frames without a chain and over every frame with one (a filter's output
  rings on); each chain entry's ``ops_per_frame`` per row and frame
  (``reference/fx/``), the master's per output channel and frame.
"""

from __future__ import annotations

from wbbench.lib import chains

#: NVIDIA H100 SXM data sheet: HBM3 bytes/s and f32 (non-tensor) operations/s at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def _union_length(spans) -> int:
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def count(desc, deliverable: str, kind) -> tuple:
    """``(bytes, f32 operations)`` of rendering ``desc`` as ``"mix"`` or
    ``"stems"``; ``kind`` is its kind's reference module (``reference/<kind>.py``)."""
    if deliverable not in ("mix", "stems"):
        raise ValueError(f"deliverable must be 'mix' or 'stems', got {deliverable!r}")
    render = kind.Render(desc)
    F, C, T = render.frames, desc.channels, len(desc.tracks)
    spans = {}
    ops = 0
    for t, tr in enumerate(desc.tracks):
        reads, played, clip_ops = render.work(desc, t)
        for asset, first, end in reads:
            spans.setdefault(asset, []).append((first, end))
        per_frame = chains.ops_per_frame(tr.chain)
        rows_frames = F if tr.chain else played
        ops += clip_ops + C * F * per_frame + C * rows_frames * (1 if deliverable == "stems" else 2)
    if deliverable == "mix":
        ops += C * F * chains.ops_per_frame(desc.master_chain)
    read = sum(_union_length(sp) * desc.assets[a].shape[0] for a, sp in spans.items()) * 4
    written = (C * F if deliverable == "mix" else T * C * F) * 4
    return int(read + written), int(ops)


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time by the data-sheet peaks: the larger of bytes over HBM
    bandwidth and operations over the f32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S)
