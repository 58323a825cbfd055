"""The CUDA mix kernel on the card (marker ``cuda``; skipped without one).

Run on a machine with an NVIDIA card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which such a
machine need not have; nothing here imports JAX.) The checks are
``chip_smoke.py``'s: the kernel bit-equal to its plain PyTorch version on
the card, and to the NumPy references under the repo's contract.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from whitebox_tpu.timeline.carve import carve_session
from whitebox_tpu.timeline.oracle import OracleRenderer
from whitebox_tpu_torch.ops import mix_cuda
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.demo import make_demo_session

pytestmark = pytest.mark.cuda

SESSIONS = {
    "speed1_int_formats_fades": lambda: chip_smoke.int_formats_session(n_tracks=4),
    "mixed_speeds_fades": lambda: make_demo_session(
        n_tracks=4, duration_seconds=4.0, seed=3, fades=True, clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37)),
    "reverse_bidirectional": chip_smoke.reverse_session,
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("tile", [None, 1024])
@pytest.mark.parametrize("name", list(SESSIONS))
def test_kernel_matches_plain_and_reference(card, name, tile):
    chip_smoke.kernel_vs_plain(name, SESSIONS[name](), tile=tile)


def test_bounce_counts_one_launch_and_matches_oracle(card):
    s = make_demo_session(n_tracks=4, duration_seconds=4.0, seed=5)
    before = mix_cuda.mix_kernel_launches
    got = bounce(s, 48000.0, device=card).audio
    assert mix_cuda.mix_kernel_launches == before + 1
    ref = OracleRenderer(s, 48000.0, buffer_size=512).render()
    n = min(ref.shape[1], got.shape[1])
    np.testing.assert_array_equal(got[:, :n], ref[:, :n])


def test_kernel_rejects_malformed_tables(card):
    s = make_demo_session(n_tracks=2, duration_seconds=2.0, seed=6)
    table, pool = carve_session(s, 48000.0, buffer_size=512)
    r = mix_cuda.CudaMixRenderer(table, pool, s, device=card)
    p = r.plan
    before = mix_cuda.mix_kernel_launches
    with pytest.raises(ValueError):
        mix_cuda.mix_cuda(r.pool_device, dict(r.tables, ms=r.tables["ms"].cpu()), p.n_tiles, p.tile, p.channels)
    with pytest.raises(ValueError):
        mix_cuda.mix_cuda(r.pool_device.cpu(), r.tables, p.n_tiles, p.tile, p.channels)
    assert mix_cuda.mix_kernel_launches == before
