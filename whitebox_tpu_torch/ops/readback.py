"""The copy of a render's result out of the card: :func:`to_host`.

``to_host(t)`` returns ``t``'s values as a NumPy array that the caller
owns, equal to ``t.cpu().numpy()`` in dtype, shape and every byte. A CUDA
tensor of at least :data:`STAGE_MIN_BYTES` is read as flat pieces of
:data:`PIECE_BYTES` through a ring of :data:`RING_SLOTS` page-locked
staging slots, allocated once per device and kept for the process. The
card copies piece ``k + RING_SLOTS`` into a slot (on the current stream,
so after the kernels that made ``t``) once the host has copied piece
``k`` out of it into the array, on torch's intra-op threads. A pageable
``.cpu()`` goes through CUDA's own staging on one thread, and a
page-locked block allocated per call pays its allocation every time. The
call returns when the last piece is in the array. A smaller tensor, or
one on the CPU, takes ``.cpu().numpy()``.

The array's memory is a host buffer whose pages were written before,
where one is free: on the H100's host the copy into fresh pages ran at
2.6-4.4 GB/s, bound by the page faults, and into written pages at 13-19
GB/s. The array (through a :class:`_Lease`, its base) holds its buffer
for as long as it or any view of it lives; then the buffer joins a free
list of at most :data:`FREE_BUFFERS`, kept for the process, and a later
readback of more than half its size and at most its size takes it in
place of a fresh ``np.empty``. So no readback writes into memory that an
earlier result still uses.

One ring serves every caller of a device; its lock keeps two threads from
staging through it at once. Counters, to which only this module adds
(callers may reset them to 0): :data:`staged_readbacks`,
:data:`staged_bytes`, :data:`staging_allocations` (one per device in the
life of the process) and :data:`host_allocations` (fresh host buffers).
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

#: bytes of one staging slot, and the slots of a device's ring: 64 MiB
#: page-locked a device (on an H100 host, 16 MiB pieces read the stems'
#: 8.85 GB in 0.46-0.49 s at 2 to 4 slots, 64 MiB pieces in 0.55-0.65 s)
PIECE_BYTES = 16 << 20
RING_SLOTS = 4
#: CUDA tensors smaller than this take ``.cpu().numpy()`` (both paths take
#: under 2 ms there; at 32 MiB the ring took 3.2 ms, the pageable copy 13)
STAGE_MIN_BYTES = 16 << 20
#: host buffers that no array uses any more, kept for later readbacks
FREE_BUFFERS = 2

#: readbacks through a ring, their bytes, the rings and the fresh host
#: buffers allocated
staged_readbacks = 0
staged_bytes = 0
staging_allocations = 0
host_allocations = 0

_FREE: collections.deque = collections.deque(maxlen=FREE_BUFFERS)

_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


class _Ring:
    """The staging slots of one device: views of one block (page-locked on
    a CUDA device, ordinary memory elsewhere), the event of each slot's
    last copy from the device, and the lock of their use."""

    def __init__(self, device: torch.device):
        global staging_allocations
        self.on_card = device.type == "cuda"
        block = torch.empty(RING_SLOTS * PIECE_BYTES, dtype=torch.uint8, pin_memory=self.on_card)
        staging_allocations += 1
        self.slots = block.split(PIECE_BYTES)
        self.events = [torch.cuda.Event() for _ in self.slots] if self.on_card else []
        self.device = device
        self.lock = threading.Lock()

    def read(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy the flat bytes ``src`` (on the ring's device) into the flat
        host bytes ``dst``; returns when ``dst`` holds them all. The caller
        holds :attr:`lock`."""
        n = src.numel()
        size = self.slots[0].numel()
        ring = len(self.slots)
        pieces = -(-n // size)
        stream = torch.cuda.current_stream(self.device) if self.on_card else None

        def start(k: int) -> None:
            lo = k * size
            hi = min(lo + size, n)
            self.slots[k % ring][: hi - lo].copy_(src[lo:hi], non_blocking=True)
            if self.on_card:
                self.events[k % ring].record(stream)

        for k in range(min(ring, pieces)):
            start(k)
        for k in range(pieces):
            if self.on_card:
                self.events[k % ring].synchronize()
            lo = k * size
            hi = min(lo + size, n)
            dst[lo:hi].copy_(self.slots[k % ring][: hi - lo])
            if k + ring < pieces:
                start(k + ring)


def _ring(device: torch.device) -> _Ring:
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = _Ring(device)
        return ring


class _Lease:
    """The base of the array of one readback: shows NumPy the head of a host
    buffer as ``shape`` and ``dtype``, and gives the buffer back to the
    free list when the last array that uses it is gone."""

    def __init__(self, raw: np.ndarray, shape: tuple, dtype: np.dtype):
        self.raw = raw
        self.free = _FREE
        self.__array_interface__ = {"version": 3, "shape": shape, "typestr": dtype.str,
                                    "data": (raw.ctypes.data, False)}

    def __del__(self):
        self.free.append(self.raw)


def _host_array(shape: tuple, dtype: np.dtype) -> np.ndarray:
    """An array of ``shape`` and ``dtype`` that the caller owns, on a free
    buffer that fits it or else on a fresh one. The free list is changed
    only by single deque operations, so a buffer given back while this
    runs (from any thread) never goes to two arrays."""
    global host_allocations
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    raw = None
    for _ in range(len(_FREE)):
        try:
            cand = _FREE.popleft()
        except IndexError:
            break
        if cand.nbytes // 2 < nbytes <= cand.nbytes:
            raw = cand
            break
        _FREE.append(cand)
    if raw is None:
        raw = np.empty(nbytes, dtype=np.uint8)
        host_allocations += 1
    return np.asarray(_Lease(raw, shape, dtype))


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _staged(t: torch.Tensor) -> np.ndarray:
    """``t`` through its device's ring into a host array of its own."""
    global staged_readbacks, staged_bytes
    out = _host_array(tuple(t.shape), torch.empty(0, dtype=t.dtype).numpy().dtype)
    src = _flat_bytes(t.contiguous())
    ring = _ring(t.device)
    with ring.lock:
        ring.read(src, _flat_bytes(torch.from_numpy(out)))
        staged_readbacks += 1
        staged_bytes += src.numel()
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a NumPy array in host memory that the caller owns (see the
    module's docstring for the path it takes)."""
    if t.device.type != "cuda" or t.numel() * t.element_size() < STAGE_MIN_BYTES:
        return t.cpu().numpy()
    return _staged(t)
