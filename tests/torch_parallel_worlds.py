"""Rank programs for the sharded-render tests (``tests/test_torch_parallel.py``,
``tests/test_torch_effects_sharded.py``, ``tests/test_torch_cuda.py``).

``run_jobs`` is what each rank of a ``parallel/launch.py::run_world`` world
runs: a list of jobs, each evaluated on the same inputs by every rank, each
result (or the exception's type and message) returned. The module imports
no JAX, so the spawned ranks start quickly; the tests build their sessions
with the JAX package, carry them across with ``from_reference`` and hand
the port's sessions to the world.
"""

from __future__ import annotations

import numpy as np


def _job(kind: str, payload: dict, device: str):
    import torch

    from whitebox_tpu_torch.parallel import collectives, effects_sharded, make_render_mesh
    from whitebox_tpu_torch.parallel.render_sharded import (
        bounce_sharded, render_chunk_sharded, shard_tables,
    )

    if kind == "mesh":
        m = make_render_mesh(payload.get("tp"), payload.get("fp"), devices=device)
        return dict(m.shape), dict(m.coords)
    tp, fp = payload["tp"], payload["fp"]
    mesh = make_render_mesh(tp, fp, devices=device)
    if kind == "bounce":
        return bounce_sharded(payload["session"], payload.get("rate", 48000.0), mesh,
                              **payload.get("kw", {}))
    if kind == "render_chunk":
        from whitebox_tpu_torch.ops.mix import pack_device_tables
        from whitebox_tpu_torch.timeline.carve import carve_session

        s = payload["session"]
        table, pool = carve_session(s, 48000.0, buffer_size=512)
        packed = pack_device_tables(table, pool, s, pad_tracks_to=payload["pad_to"])
        pool_dev = torch.from_numpy(pool.data).to(mesh.device)
        local = render_chunk_sharded(pool_dev, shard_tables(packed.as_torch(), mesh), 0,
                                     payload["frames"], mesh)
        return dict(mesh.coords), local.cpu().numpy()
    if kind == "biquad":
        from whitebox_tpu_torch.parallel.biquad_sharded import biquad_shard_framewise

        x = torch.from_numpy(payload["x"]).to(mesh.device)
        n = x.shape[1] // fp
        ax = mesh.axis("frames")
        xl = x[:, ax.index * n:(ax.index + 1) * n]
        params = [torch.full((x.shape[0], 1), float(v), device=mesh.device) for v in payload["pa"]]
        y = biquad_shard_framewise(xl, params, ax, fp)
        return collectives.gather_frames(y, ax).cpu().numpy()
    if kind == "cascade":
        from whitebox_tpu_torch.parallel.biquad_sharded import cascade_shard_framewise

        x = torch.from_numpy(payload["x"]).to(mesh.device)
        n = x.shape[1] // fp
        ax = mesh.axis("frames")
        y = cascade_shard_framewise(x[:, ax.index * n:(ax.index + 1) * n].contiguous(),
                                    torch.from_numpy(payload["coeffs"]).to(mesh.device), ax, fp)
        return collectives.gather_frames(y, ax).cpu().numpy()
    if kind == "chain":
        x = torch.from_numpy(payload["x"])
        return effects_sharded.apply_chain_sharded(payload["effects"], x, mesh, 48000.0).cpu().numpy()
    raise ValueError(f"unknown job {kind!r}")


def run_jobs(rank: int, jobs: list, device: str = "cpu", threads: int | None = 2) -> list:
    """Every job of ``jobs`` (``(kind, payload)``) on this rank -> a list of
    ``("ok", result)`` or ``("error", type name, message)``."""
    import torch

    if threads:
        torch.set_num_threads(threads)
    from whitebox_tpu_torch.parallel import effects_sharded

    out = []
    for kind, payload in jobs:
        # "chunk": the frames a shard's recurrences run at a time (the card's
        # chunked form, on this device)
        old = dict(effects_sharded.SHARD_CHUNK)
        if payload.get("chunk"):
            effects_sharded.SHARD_CHUNK[device] = payload["chunk"]
        try:
            out.append(("ok", _job(kind, payload, device)))
        except (ValueError, NotImplementedError) as e:
            out.append(("error", type(e).__name__, str(e)))
        finally:
            effects_sharded.SHARD_CHUNK.update(old)
    return out


def same_on_every_rank(results: list) -> list:
    """The ranks' result lists -> rank 0's, after checking that every rank
    returned the same arrays for every job whose result is an array."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        for i, (a, b) in enumerate(zip(first, res)):
            if a[0] == "ok" and isinstance(a[1], np.ndarray):
                assert np.array_equal(a[1], b[1]), f"job {i}: rank {r} returned other audio than rank 0"
    return first
