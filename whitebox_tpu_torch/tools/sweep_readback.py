"""Time the readback of a render's result on one card: the pageable
``.cpu().numpy()`` against ``ops/readback.py::to_host`` at each ring shape.

    python -m whitebox_tpu_torch.tools.sweep_readback [--tracks 128] [--frames 8640000]
        [--pieces-mib 16,32,64] [--slots 2,3,4] [--threads 1,2,4,8]

On f32 tensors of the stems' shape ``[tracks, 2, frames]`` (8.85 GB at the
defaults) and the mix's ``[2, frames]`` (69 MB) it prints, by the host
clock after a synchronise, median of 3 unless said:

- ``pageable``: ``.cpu().numpy()`` of each;
- ``staged``: ``to_host`` at each piece size and slot count whose ring holds
  at most 256 MiB (the ring allocated anew, its allocation apart), each
  result dropped before the next call, so its host buffer is taken again
  (``ms``), and once with no free buffer (``fresh_ms``), checked bit-equal
  to the pageable one;
- ``dma``: the card's copies alone, every piece into one page-locked slot;
  ``host_copy``: the host's copies alone, a page-locked slot into a fresh
  ``np.empty`` array (and into one already written), at each intra-op
  thread count;
- ``threads``: ``to_host`` at the module's ring shape at each thread count;
- ``threshold``: pageable against staged at 4 to 64 MiB (median of 5,
  each result dropped before the next call).

Prints one JSON line per measurement, the card's name and power limit and
the host's CPU count and transparent huge page mode. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
RING_CAP = 256 << 20


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _timed(torch, fn, n=3):
    """``n`` synchronised calls -> (median ms, all ms, the last result)."""
    ms, out = [], None
    for _ in range(n):
        out = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms, out


def _same_bits(torch, a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        torch.from_numpy(a).view(torch.int32), torch.from_numpy(b).view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tracks", type=int, default=128)
    ap.add_argument("--frames", type=int, default=8_640_000)
    ap.add_argument("--pieces-mib", default="16,32,64")
    ap.add_argument("--slots", default="2,3,4")
    ap.add_argument("--threads", default="1,2,4,8")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from whitebox_tpu_torch.ops import readback

    if not torch.cuda.is_available():
        print("sweep_readback: needs a CUDA card", file=sys.stderr)
        return 2
    thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")
    _emit(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip(),
          cpu_count=os.cpu_count(), intra_op_threads=torch.get_num_threads(),
          thp=thp.read_text().strip() if thp.exists() else None, torch=torch.__version__)
    threads0 = torch.get_num_threads()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(7)
    stems = torch.randn((args.tracks, 2, args.frames), device=dev, generator=gen)
    mix = stems[0, :, :].clone()
    shapes = {"stems": stems, "mix": mix}
    defaults = (readback.PIECE_BYTES, readback.RING_SLOTS)

    def ring(piece, slots):
        readback.PIECE_BYTES, readback.RING_SLOTS = piece, slots
        readback._RINGS.clear()
        t0 = time.perf_counter()
        readback._ring(dev)
        return (time.perf_counter() - t0) * 1e3

    refs = {}
    for name, t in shapes.items():
        ms, all_ms, refs[name] = _timed(torch, lambda t=t: t.cpu().numpy())
        _emit(kind="pageable", shape=name, bytes=t.numel() * 4, ms=ms, ms_all=all_ms,
              gb_per_s=t.numel() * 4 / 1e6 / ms)
    grid = [(p << 20, r) for p in map(int, args.pieces_mib.split(",")) for r in map(int, args.slots.split(","))
            if (p << 20) * r <= RING_CAP]
    try:
        for piece, slots in grid:
            alloc_ms = ring(piece, slots)
            for name, t in shapes.items():
                readback._FREE.clear()
                fresh_ms, _, out = _timed(torch, lambda t=t: readback.to_host(t), n=1)
                ok = _same_bits(torch, out, refs[name])
                del out
                ms, all_ms, _ = _timed(torch, lambda t=t: readback.to_host(t).shape)
                _emit(kind="staged", shape=name, piece_mib=piece >> 20, slots=slots, alloc_ms=alloc_ms,
                      fresh_ms=fresh_ms, ms=ms, ms_all=all_ms, gb_per_s=t.numel() * 4 / 1e6 / ms, bit_equal=ok)
                alloc_ms = None
        ring(*defaults)
        src = readback._flat_bytes(stems)
        slot = readback._RINGS[dev].slots[0]
        size, n = slot.numel(), src.numel()

        def dma():
            for lo in range(0, n, size):
                hi = min(lo + size, n)
                slot[: hi - lo].copy_(src[lo:hi], non_blocking=True)

        ms, all_ms, _ = _timed(torch, dma)
        _emit(kind="dma", bytes=n, piece_mib=size >> 20, ms=ms, ms_all=all_ms, gb_per_s=n / 1e6 / ms)
        warm = np.empty(n, dtype=np.uint8)
        for threads in map(int, args.threads.split(",")):
            torch.set_num_threads(threads)
            for pages in ("fresh", "written"):
                def host_copy(pages=pages):
                    dst = torch.from_numpy(np.empty(n, dtype=np.uint8) if pages == "fresh" else warm)
                    for lo in range(0, n, size):
                        hi = min(lo + size, n)
                        dst[lo:hi].copy_(slot[: hi - lo])

                ms, all_ms, _ = _timed(torch, host_copy)
                _emit(kind="host_copy", pages=pages, threads=threads, ms=ms, ms_all=all_ms, gb_per_s=n / 1e6 / ms)
            ms, all_ms, _ = _timed(torch, lambda: readback.to_host(stems).shape)
            _emit(kind="threads", threads=threads, shape="stems", ms=ms, ms_all=all_ms, gb_per_s=n / 1e6 / ms)
        del warm
        torch.set_num_threads(threads0)
        flat = stems.reshape(-1)
        for mib in (4, 8, 16, 32, 64):
            t = flat[: (mib << 20) // 4]
            plain_ms, plain_all, _ = _timed(torch, lambda t=t: t.cpu().numpy().shape, n=5)
            staged_ms, staged_all, _ = _timed(torch, lambda t=t: readback._staged(t).shape, n=5)
            _emit(kind="threshold", mib=mib, pageable_ms=plain_ms, staged_ms=staged_ms, pageable_all=plain_all,
                  staged_all=staged_all)
    finally:
        readback.PIECE_BYTES, readback.RING_SLOTS = defaults
    _emit(kind="counters", staged_readbacks=readback.staged_readbacks, staged_bytes=readback.staged_bytes,
          staging_allocations=readback.staging_allocations, host_allocations=readback.host_allocations)
    return 0


if __name__ == "__main__":
    sys.exit(main())
