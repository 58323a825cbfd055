"""The gather kernel's dispatch, plain version, host model and binding (CPU).

``ops/mix.py::render_chunk`` / ``render_chunk_per_track`` dispatch by the
pool's device: on a CUDA tensor one launch of ``csrc/gather_mix.cu``
(``ops/gather_cuda.py``), on the CPU the plain torch ops
(``mix.gather_plain``). The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``gather_kernel``
phase); here:

- the dispatcher takes the plain version on the CPU, which is bit-equal to
  the JAX package's ``render_chunk`` / ``render_chunk_per_track`` at speed 1
  and within the resampling contract (2 ulp or 2.4e-7 linear, 3e-6
  Catmull-Rom) otherwise;
- the forms agree with each other: the unclipped sum plus the clip is the
  clipped sum, which is the per-track form times track gain summed in
  index order;
- ``gather_cuda.block_rows_model``, the kernel's row search, equals
  ``searchsorted(right=True) - 1`` before the first row, across gaps, on
  the padding, past the end, on an empty table and on row subsets;
- the wrapper refuses malformed arguments before any launch;
- the ``.cu``'s argument struct and constants are the wrapper's.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_carve import random_session
from tests.test_torch_mix import assert_ulp_contract
from tests.test_torch_mix_plan import make_case
from whitebox_tpu.ops import mix as jmix
from whitebox_tpu.timeline.carve import carve_session as jax_carve
from whitebox_tpu.timeline.oversample import resolve_interpolation as jax_resolve
from whitebox_tpu_torch.ops import cuda_build, gather_cuda, mix
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oversample import resolve_interpolation

RATE = 48000.0
CSRC = Path(cuda_build.__file__).resolve().parent.parent / "csrc"
SRC = CSRC / "gather_mix.cu"
SENTINEL = np.int32(2**31 - 1)
START = 20480  # the speed-1 chunk holds two clips


def _tables(js, rate, interpolation="linear"):
    """(JAX tables, pool, interp) and the port's of the blocks carve."""
    s = from_reference(js)
    jt, jp = jax_carve(js, rate, buffer_size=512, slow_emit="blocks")
    pt, pp = carve_session(s, rate, buffer_size=512, slow_emit="blocks")
    jinterp = pinterp = "linear"
    if interpolation != "linear":
        jt, jp, jinterp = jax_resolve(jt, jp, interpolation)
        pt, pp, pinterp = resolve_interpolation(pt, pp, interpolation)
    return ((jmix.pack_device_tables(jt, jp, js), jp, jinterp),
            (mix.pack_device_tables(pt, pp, s), pp, pinterp))


@pytest.fixture(scope="module")
def speed1():
    """One speed-1 session through the JAX package once: its chunk and its
    per-track chunk from frame START."""
    (jd, jp, _), (pd, pp, _) = _tables(random_session(1, rate=48000, bpm=120.0, n_tracks=4), RATE)
    jt, jpool = jd.as_jax(), jnp.asarray(jp.data)
    n = 1 << 14
    want = np.asarray(jmix.render_chunk(jpool, jt, jnp.int32(START), frames=n))
    want_pt = np.asarray(jmix.render_chunk_per_track(jpool, jt, jnp.int32(START), frames=n))
    return pd.as_torch(), torch.from_numpy(pp.data), n, want, want_pt


@pytest.fixture(scope="module")
def resampled():
    """The mixed-speeds case in linear and Catmull-Rom through the JAX package once."""
    js, rate, _ = make_case("mixed_speeds")
    out = {}
    for mode in ("linear", "catmull"):
        (jd, jp, jinterp), (pd, pp, pinterp) = _tables(js, rate, mode)
        assert not pd.fast.all()
        jt, jpool = jd.as_jax(), jnp.asarray(jp.data)
        n = 1 << 13
        out[mode] = (pd.as_torch(), torch.from_numpy(pp.data), pinterp, n,
                     np.asarray(jmix.render_chunk(jpool, jt, jnp.int32(n), frames=n, interp=jinterp)),
                     np.asarray(jmix.render_chunk_per_track(jpool, jt, jnp.int32(n), frames=n, interp=jinterp)))
    return out


@pytest.fixture
def no_kernel(monkeypatch):
    """Any call of the kernel's wrapper fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path called the CUDA kernel's wrapper")
    monkeypatch.setattr(gather_cuda, "gather_mix_cuda", refuse)


# ------------------------------------------------------------- the dispatcher


def test_dispatch_on_the_cpu_is_the_plain_version_bit_equal_to_jax(speed1, no_kernel):
    tables, pool, n, want, want_pt = speed1
    got = mix.render_chunk(pool, tables, START, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mix.render_chunk_per_track(pool, tables, START, n).numpy(), want_pt)
    assert torch.equal(got, mix.gather_plain(pool, tables, START, n, "sum"))
    assert float(np.abs(want).max()) > 0.01


@pytest.mark.parametrize("mode", ["linear", "catmull"])
def test_dispatch_resampled_within_the_contract(resampled, mode, no_kernel):
    tables, pool, interp, n, want, want_pt = resampled[mode]
    got = mix.render_chunk(pool, tables, n, n, interp=interp).numpy()
    got_pt = mix.render_chunk_per_track(pool, tables, n, n, interp=interp).numpy()
    if mode == "linear":
        assert_ulp_contract(got, want)
        np.testing.assert_allclose(got_pt, want_pt, atol=2.4e-7, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=3e-6, rtol=0)
        np.testing.assert_allclose(got_pt, want_pt, atol=3e-6, rtol=0)


def test_forms_agree(speed1, no_kernel):
    """unclipped + clip == clipped == clip of the per-track form times track
    gain summed in index order from +0.0, bit for bit."""
    tables, pool, n, _, _ = speed1
    summed = mix.render_chunk(pool, tables, START, n)
    unclipped = mix.render_chunk(pool, tables, START, n, clip=False)
    assert torch.equal(mix._clip(unclipped), summed)
    pt = mix.render_chunk_per_track(pool, tables, START, n)
    assert torch.equal(mix._ordered_sum(pt * tables["track_gain"][:, :, None]), unclipped)


def test_plain_pieces_do_not_change_the_result(speed1, monkeypatch):
    """The plain version renders ``PLAIN_FRAMES`` at a time; pieces of any
    length give the same bits (every frame is independent)."""
    tables, pool, n, _, _ = speed1
    whole = {f: mix.gather_plain(pool, tables, START, n, f) for f in gather_cuda.FORMS}
    monkeypatch.setattr(mix, "PLAIN_FRAMES", 1000)
    for f, want in whole.items():
        assert torch.equal(mix.gather_plain(pool, tables, START, n, f), want), f


def test_frames_past_the_end_and_empty_chunks_are_zero(speed1):
    tables, pool, _, _, _ = speed1
    T, _, C = tables["src_base"].shape
    past = mix.render_chunk_per_track(pool, tables, 1 << 24, 300)
    assert past.shape == (T, C, 300) and not torch.any(past.view(torch.int32) != 0)  # +0.0, not -0.0
    assert mix.render_chunk(pool, tables, 0, 0).shape == (C, 0)
    assert mix.render_chunk_per_track(pool, tables, 0, 0).shape == (T, C, 0)


def test_fast_sum_is_one_torch_sum_within_1e6(speed1):
    tables, pool, n, _, _ = speed1
    a = mix.render_chunk(pool, tables, START, n)
    b = mix.render_chunk(pool, tables, START, n, strict_order=False)
    assert float((a - b).abs().max()) <= 1e-6


def test_dispatch_refuses_other_devices():
    pool = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no gather mix for device meta"):
        mix.gather(pool, {}, 0, 8)
    with pytest.raises(ValueError, match="unknown form"):
        mix.gather_plain(torch.zeros(16), {}, 0, 8, "partial")


def test_bounce_counts_its_gather_chunks():
    s = from_reference(random_session(5, rate=48000, bpm=120.0, n_tracks=2))
    res = bounce(s, RATE, device="cpu", engine="xla", chunk_frames=10007)
    F = carve_session(s, RATE, buffer_size=512)[0].total_frames
    assert res.stats.mix_path == "gather" and res.stats.gather_chunks == -(-F // 10007)
    assert bounce(s, RATE, device="cpu").stats.gather_chunks == 0


# ------------------------------------------------------- the row search model


def _searchsorted(ds, g0, n):
    g = g0 + np.arange(n)
    return np.stack([np.searchsorted(row, g, side="right") - 1 for row in ds]).astype(np.int64)


ROWS = np.array([[100, 100, 356, 700, 701, 5000, SENTINEL, SENTINEL],  # a duplicate start, rows inside a block
                 [0, 9000, SENTINEL, SENTINEL, SENTINEL, SENTINEL, SENTINEL, SENTINEL],  # a long gap
                 [SENTINEL] * 8], dtype=np.int32)  # a track with no rows: all padding


@pytest.mark.parametrize("g0,n,block", [
    (0, 1100, 256),  # before the first row, rows starting inside blocks
    (-300, 700, 256),  # frames before the timeline
    (4900, 5000, 256),  # across the gap, onto the padding
    (1 << 20, 513, 256),  # a chunk wholly past the end
    (95, 40, 7),  # blocks of 7 frames: a row start on a block's inside
    (0, 64, 1),  # a block a frame
])
def test_block_rows_model_is_searchsorted(g0, n, block):
    got = gather_cuda.block_rows_model(ROWS, g0, n, block)
    np.testing.assert_array_equal(got, _searchsorted(ROWS, g0, n))


def test_block_rows_model_on_an_empty_table_and_row_subsets():
    empty = mix.pack_device_tables(*carve_session(from_reference(
        random_session(2, rate=48000, bpm=120.0, n_tracks=1, n_clips=0)), RATE, buffer_size=512),
        from_reference(random_session(2, rate=48000, bpm=120.0, n_tracks=1, n_clips=0)))
    assert empty.dst_start.shape[1] == 1  # an empty table packs to S = 1
    assert (gather_cuda.block_rows_model(empty.dst_start, 0, 600) == -1).all()
    sub = ROWS[[2, 0]]  # the PDC fetch-ahead's rows, in any order
    np.testing.assert_array_equal(gather_cuda.block_rows_model(sub, 50, 900), _searchsorted(sub, 50, 900))


# ---------------------------------------------------------------- the wrapper


def _cpu_tables(speed1):
    tables, pool, _, _, _ = speed1
    return dict(tables), pool


def test_check_tables_accepts_the_packed_tables(speed1):
    tables, pool = _cpu_tables(speed1)
    T, S, C = gather_cuda.check_tables(pool, tables)
    assert (T, C) == (4, 2) and tables["fast"].dtype == torch.bool and tables["fast"].element_size() == 1


@pytest.mark.parametrize("fault", ["pool_f64", "pool_2d", "length_i64", "gain_noncontiguous", "fast_u8",
                                   "track_gain_shape", "src_base_i32"])
def test_wrapper_refuses_malformed_tables(speed1, fault):
    tables, pool = _cpu_tables(speed1)
    if fault == "pool_f64":
        pool = pool.double()
    elif fault == "pool_2d":
        pool = pool[: pool.numel() // 2 * 2].reshape(2, -1)
    elif fault == "length_i64":
        tables["length"] = tables["length"].long()
    elif fault == "gain_noncontiguous":
        tables["gain"] = tables["gain"].t().contiguous().t()
        assert not tables["gain"].is_contiguous()
    elif fault == "fast_u8":
        tables["fast"] = tables["fast"].to(torch.uint8)
    elif fault == "track_gain_shape":
        tables["track_gain"] = tables["track_gain"][:, :1].contiguous()
    else:
        tables["src_base"] = tables["src_base"].int()
    with pytest.raises(ValueError):
        gather_cuda.check_tables(pool, tables)


@pytest.mark.parametrize("interp", ["cubic", ("poly",), ("poly", [[0.0] * 9] * 2), ("poly", [[0.0] * 2] * 9), 3])
def test_wrapper_refuses_unknown_interpolation(interp):
    with pytest.raises(ValueError):
        gather_cuda.interp_args(interp, None, torch.device("cpu"))


def test_wrapper_refuses_cpu_tensors_and_unknown_forms(speed1):
    tables, pool = _cpu_tables(speed1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gather_cuda.gather_mix_cuda(pool, tables, 0, 256)
    with pytest.raises(ValueError, match="2-D float32"):
        gather_cuda.interp_args("linear", torch.zeros(3, 4, dtype=torch.float64), torch.device("cpu"))
    with pytest.raises(ValueError, match="2-D float32"):
        gather_cuda.interp_args("linear", torch.zeros(4, 3).t(), torch.device("cpu"))


def test_interpolation_arguments():
    cpu = torch.device("cpu")
    assert gather_cuda.interp_args("catmull", None, cpu)[:4] == ("catmull", 0, 0, 0)
    coeffs = np.arange(36, dtype=np.float64).reshape(6, 6) / 7.0
    mode, _, taps, ncoef, values, _ = gather_cuda.interp_args(("poly", coeffs), None, cpu)
    assert (mode, taps, ncoef) == ("poly", 6, 6)
    assert values == [float(np.float32(c)) for c in coeffs.ravel()]  # the plain version's constants
    bank = torch.linspace(0, 1, 33 * 4).reshape(33, 4)
    mode, phases, taps, _, _, got = gather_cuda.interp_args("linear", bank, cpu)  # a bank wins
    assert (mode, phases, taps) == ("sinc", 32, 4) and got is bank  # used as it is, no copy
    with pytest.raises(ValueError, match="sinc_bank"):
        gather_cuda.interp_args("linear", bank.numpy(), cpu)  # a host array: the caller uploads it


# ------------------------------------------------------- the source and its ABI


def test_struct_and_constants_are_the_wrappers():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kFrames") == gather_cuda.FRAMES_PER_BLOCK and const("kChanPair") == gather_cuda.CHAN_PAIR
    assert [const(k) for k in ("kLinear", "kCatmull", "kPoly", "kSinc")] == list(gather_cuda.INTERP.values())
    assert [const(k) for k in ("kPerTrack", "kSum", "kSumNoClip")] == list(gather_cuda.FORMS.values())
    assert const("kMaxPolyTaps") == gather_cuda.MAX_POLY_TAPS and const("kMaxPolyCoeffs") == gather_cuda.MAX_POLY_COEFFS
    body = re.search(r"struct WbGatherArgs \{(.*?)\n\};", src, re.S)[1]
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        m = re.match(r"(const float\*|const int\*|const long long\*|const unsigned char\*|float\*|long long|int|float)"
                     r" (\w+)(\[(\d+)\])?$", decl)
        assert m, decl
        fields.append((m[2], m[1], m[4]))
    assert [n for n, _, _ in fields] == [n for n, _ in gather_cuda.WbGatherArgs._fields_]
    for (_, c, length), (_, t) in zip(fields, gather_cuda.WbGatherArgs._fields_):
        if length:
            assert t._type_ is ctypes.c_float and t._length_ == int(length) == gather_cuda.POLY_SLOTS
        else:
            assert t is {"int": ctypes.c_int, "long long": ctypes.c_longlong}.get(c, ctypes.c_void_p)
    assert gather_cuda.MAX_POLY_TAPS * gather_cuda.MAX_POLY_COEFFS == gather_cuda.POLY_SLOTS
    # the C entry is the one cuda_build declares, with its two arguments
    entry = re.search(r'extern "C" int (wb_\w+)\(([^)]*)\)', src)
    assert entry[1] == "wb_gather_mix" and len(entry[2].split(",")) == 2
    assert "lib.wb_gather_mix.argtypes = [vp, vp]" in Path(cuda_build.__file__).read_text()
    # the table pointers come in the wrapper's table order
    assert [n for n, _, _ in fields][2:2 + len(gather_cuda.TABLE_DTYPES)] == list(gather_cuda.TABLE_DTYPES)


def test_the_phase_is_shared_not_copied():
    """Both mix kernels take the double-single phase from one header."""
    header = (CSRC / "ds_phase.cuh").read_text()
    assert header.count("void phase_eval(") == 1
    for name in ("gather_mix.cu", "mix_kernel.cu"):
        text = (CSRC / name).read_text()
        assert '#include "ds_phase.cuh"' in text and "void phase_eval(" not in text, name
    assert (CSRC / "ds_phase.cuh") in cuda_build._sources()[1]  # a header: its edit rebuilds
