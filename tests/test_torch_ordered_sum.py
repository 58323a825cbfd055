"""The ordered track sum (``ops/mix.py::_ordered_sum``) and the wrapper of its
CUDA kernel (``ops/sum_cuda.py``, ``csrc/ordered_sum.cu``) on the CPU: the
sum in track order from +0.0, the wrapper's refusals before any build, and
the kernel's C entry point as ``ops/cuda_build.py`` declares it. The kernel
itself runs in ``tests/test_torch_cuda.py`` (marker ``cuda``)."""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from whitebox_tpu_torch.ops import cuda_build, sum_cuda
from whitebox_tpu_torch.ops.mix import _ordered_sum

SRC = cuda_build.CSRC_DIR / "ordered_sum.cu"


@pytest.mark.parametrize("shape", [(1, 3), (5, 2, 17), (128, 2, 64)])
def test_sum_is_in_track_order_from_positive_zero(shape):
    g = torch.Generator().manual_seed(len(shape))
    y = torch.randn(shape, generator=g) * 10.0 ** torch.randint(-6, 6, shape, generator=g)
    y.view(shape[0], -1)[:, 0] = -0.0
    want = torch.zeros(shape[1:])
    for t in range(shape[0]):
        want = want + y[t]
    got = _ordered_sum(y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.signbit(got.view(-1)[0])  # -0.0 summed from +0.0 is +0.0


def test_other_dtypes_keep_the_adds():
    y = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    assert torch.equal(_ordered_sum(y), y.sum(0))
    z = torch.complex(y, -y).to(torch.complex64)
    assert torch.equal(_ordered_sum(z), (z[0] + z[1]) + z[2])


@pytest.mark.parametrize("bad", [torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.float64), torch.zeros(())],
                         ids=["cpu", "f64", "scalar"])
def test_wrapper_refuses_before_building(bad, monkeypatch):
    monkeypatch.setattr(cuda_build, "load", lambda: pytest.fail("built for a malformed argument"))
    before = sum_cuda.ordered_sum_launches
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        sum_cuda.ordered_sum_cuda(bad)
    assert sum_cuda.ordered_sum_launches == before


def test_entry_point_matches_its_declaration():
    src = SRC.read_text()
    m = re.search(r'extern "C" int (wb_ordered_sum)\(([^)]*)\)', src)
    assert m is not None
    params = [p.strip() for p in m[2].split(",")]
    assert [" ".join(p.split()[:-1]) for p in params] == \
        ["const float*", "float*", "long long", "long long", "long long", "void*"]
    assert "lib.wb_ordered_sum.argtypes = [vp, vp] + [ctypes.c_longlong] * 3 + [vp]" in \
        Path(cuda_build.__file__).read_text()
    assert SRC in cuda_build._sources()[0]
    assert "--fmad=false" in cuda_build.NVCC_FLAGS  # the adds stay unfused
