"""The staged readback (``ops/readback.py``) on the CPU: the piece loop of
``_staged`` through a ring of ordinary memory (the ring is page-locked only
on a CUDA device), bit-equal to ``.numpy()``; the arrays it returns are the
caller's own, and a host buffer is taken again only when no array uses it;
``to_host`` keeps ``.cpu().numpy()`` for a CPU tensor. The CUDA path runs in
``tests/test_torch_cuda.py`` (marker ``cuda``)."""

from __future__ import annotations

import collections
import gc

import numpy as np
import pytest
import torch

from whitebox_tpu_torch.ops import readback

PIECE = 256  # bytes: 64 f32 a piece
SLOTS = 3


@pytest.fixture
def ring(monkeypatch):
    """``readback`` with no ring yet, a CPU ring of 3 pieces of 256 bytes,
    and no free host buffer."""
    monkeypatch.setattr(readback, "_RINGS", {})
    monkeypatch.setattr(readback, "_FREE", collections.deque(maxlen=readback.FREE_BUFFERS))
    monkeypatch.setattr(readback, "PIECE_BYTES", PIECE)
    monkeypatch.setattr(readback, "RING_SLOTS", SLOTS)
    return readback


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8)


@pytest.mark.parametrize("elems", [1, 40, SLOTS * PIECE // 4, 7 * PIECE // 4 + 13],
                         ids=["one", "below_a_piece", "the_ring_exactly", "ragged_last_piece"])
def test_staged_bytes_equal_numpy(ring, elems):
    g = torch.Generator().manual_seed(elems)
    t = torch.randn(elems, generator=g)
    t[0] = -0.0
    before = (ring.staged_readbacks, ring.staged_bytes)
    got = ring._staged(t)
    assert got.dtype == np.float32 and got.shape == (elems,)
    np.testing.assert_array_equal(_bits(got), _bits(t.numpy()))
    assert (ring.staged_readbacks, ring.staged_bytes) == (before[0] + 1, before[1] + elems * 4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int16, torch.bool])
def test_staged_keeps_dtype_and_shape(ring, dtype):
    t = (torch.arange(3 * 5 * 41) % 7).reshape(3, 5, 41).to(dtype)
    got = ring._staged(t)
    want = t.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_non_contiguous_column_slice(ring):
    """Bounce's readback: the mix's first frames of a wider buffer."""
    buf = torch.randn(2, 1000, generator=torch.Generator().manual_seed(3))
    cols = buf[:, :777]
    assert not cols.is_contiguous()
    got = ring._staged(cols)
    assert got.shape == (2, 777) and got.flags.c_contiguous
    np.testing.assert_array_equal(_bits(got), _bits(cols.numpy().copy()))


def test_two_calls_return_independent_arrays(ring):
    a_src = torch.randn(2, 500, generator=torch.Generator().manual_seed(1))
    b_src = torch.randn(2, 500, generator=torch.Generator().manual_seed(2))
    a = ring._staged(a_src)
    kept = a.copy()
    b = ring._staged(b_src)
    np.testing.assert_array_equal(_bits(a), _bits(kept))
    np.testing.assert_array_equal(_bits(b), _bits(b_src.numpy()))
    (r,) = ring._RINGS.values()
    assert a.flags.writeable and b.flags.writeable
    assert not np.shares_memory(a, b)
    for slot in r.slots:
        assert not np.shares_memory(a, slot.numpy()) and not np.shares_memory(b, slot.numpy())
    a_src.zero_()
    np.testing.assert_array_equal(_bits(a), _bits(kept))


def test_a_buffer_is_taken_again_only_when_no_array_uses_it(ring):
    g = torch.Generator().manual_seed(5)
    first, second, third = (torch.randn(3, 100, generator=g) for _ in range(3))
    a = ring._staged(first)
    view = a[1:, 50:]
    kept = view.copy()
    held = torch.from_numpy(a)
    del a
    gc.collect()
    before = ring.host_allocations
    b = ring._staged(second)  # the first array's buffer is still in use
    assert ring.host_allocations == before + 1 and not np.shares_memory(b, view)
    np.testing.assert_array_equal(_bits(view), _bits(kept))
    del view, held
    gc.collect()
    c = ring._staged(third)  # the first array's buffer, now free
    assert ring.host_allocations == before + 1
    np.testing.assert_array_equal(_bits(c), _bits(third.numpy()))
    np.testing.assert_array_equal(_bits(b), _bits(second.numpy()))
    assert not np.shares_memory(b, c)


def test_a_free_buffer_serves_sizes_above_half_of_it(ring):
    ring._staged(torch.ones(1000))
    before = ring.host_allocations
    ring._staged(torch.ones(400))  # 1600 of 4000 bytes: a fresh buffer
    assert ring.host_allocations == before + 1
    ring._staged(torch.ones(600))  # 2400 of 4000 bytes: the first buffer
    assert ring.host_allocations == before + 1
    assert len(ring._FREE) <= ring.FREE_BUFFERS


def test_one_ring_a_device_for_the_process(ring):
    before = ring.staging_allocations
    for seed in range(3):
        ring._staged(torch.randn(1000, generator=torch.Generator().manual_seed(seed)))
    assert ring.staging_allocations == before + 1
    (r,) = ring._RINGS.values()
    assert len(r.slots) == SLOTS and all(s.numel() == PIECE for s in r.slots)
    assert not r.on_card and not r.slots[0].is_pinned()


@pytest.mark.parametrize("elems", [10, (readback.STAGE_MIN_BYTES // 4) + 1])
def test_cpu_tensors_take_the_plain_path(ring, elems):
    """On the CPU, below or above the threshold: ``.cpu().numpy()``, a
    view of the tensor as before, and no ring."""
    t = torch.ones(elems)
    before = (ring.staged_readbacks, ring.staged_bytes, ring.staging_allocations)
    got = ring.to_host(t)
    assert np.shares_memory(got, t.numpy())
    assert (ring.staged_readbacks, ring.staged_bytes, ring.staging_allocations) == before
    assert not ring._RINGS


def test_module_ring_fits_its_cap():
    assert readback.RING_SLOTS * readback.PIECE_BYTES <= 256 << 20
    assert readback.STAGE_MIN_BYTES > 0
