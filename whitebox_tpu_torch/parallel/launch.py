"""Start a world of ranks on this host and collect what each returns.

``run_world(fn, world_size, device=..., backend=..., timeout=...)`` spawns
``world_size`` processes (``torch.multiprocessing``, start method
``spawn``), joins them in one ``torch.distributed`` process group over a
TCP store on a free local port, calls ``fn(rank, *args)`` in each and
returns the results in rank order. It raises if any rank raises, exits or
outlives ``timeout`` seconds, and stops every process it started. Every
``init_process_group`` takes ``timeout``, so a rank blocked in a
collective fails within it.

Under ``torchrun`` the same entry points run without this module:
``make_render_mesh`` finds the process group torchrun's environment
initialises.

``fn`` must be importable by its module path (the children import it),
and its arguments and result picklable.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp

from whitebox_tpu_torch.parallel.mesh import default_backend


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, port: int, device: str, backend: str, timeout: float,
               tasks, results) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        fn, args = tasks.get(timeout=timeout)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent re-raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size: int, *, device: str = "cuda", backend: str | None = None,
              timeout: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks -> their results in
    rank order. ``device``: "cuda" (rank r on card ``r % count``, so ranks
    beyond the card count share cards) or "cpu". ``backend`` defaults to
    NCCL when every rank has a card of its own, gloo otherwise."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_world(device='cuda') needs CUDA; pass device='cpu'")
    if backend is None:
        backend = default_backend(torch.device(device), world_size)
    ctx = mp.get_context("spawn")
    tasks, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, device, backend, timeout, tasks, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    # the work goes through a queue, not the process arguments: a large
    # argument would hold each start until its child reads it
    for _ in procs:
        tasks.put((fn, args))
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_world: ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"did not finish within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"run_world: rank(s) {dead} exited "
                                       f"(codes {[procs[r].exitcode for r in dead]}) without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_world: rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(out) == world_size else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
