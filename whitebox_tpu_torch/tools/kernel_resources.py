"""Registers, shared memory and spills of every CUDA kernel of the port.

    python -m whitebox_tpu_torch.tools.kernel_resources

Compiles ``csrc/*.cu`` once more with the build's own flags plus
``--resource-usage`` (to a cubin that is thrown away) and prints what
``ptxas`` reports per kernel, each named by its template arguments, with
the resident blocks per SM that registers and static shared memory allow
on an H100 (65,536 registers, 227 KB of shared memory, 2,048 threads per
SM; the cascade's and the dynamics kernel's tiles are dynamic shared
memory, sized at the launch, and not counted here: the dynamics kernel's
per tile is printed for its kinds at the paths' shapes from
``ops/dynamics_cuda.py::warp_bytes``). Needs ``nvcc``; no card.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

from whitebox_tpu_torch.ops import cuda_build

_INTERP = ("kLinear", "kCatmull", "kPoly", "kPoly6")
_GATHER_INTERP = ("kLinear", "kCatmull", "kPoly", "kSinc")
_DYN_KINDS = ("kOnePole", "kBallistics", "kCompressor", "kLimiter", "kGate")


def kernel_name(mangled: str) -> str:
    m = re.search(r"mix_kernelILb([01])ELi(\d)ELi(\d)E", mangled)
    if m:
        return f"mix_kernel<kAuto={m[1]}, {_INTERP[int(m[2])]}, kCh={m[3]}>"
    m = re.search(r"mix_per_track_kernelILi(\d)ELi(\d)E", mangled)
    if m:
        return f"mix_per_track_kernel<{_INTERP[int(m[1])]}, kCh={m[2]}>"
    m = re.search(r"cascade_kernelILi(\d)E", mangled)
    if m:
        return f"cascade_kernel<S={m[1]}>"
    m = re.search(r"gather_per_trackILi(\d)E", mangled)
    if m:
        return f"gather_per_track<{_GATHER_INTERP[int(m[1])]}>"
    m = re.search(r"gather_sumILi(\d)ELb([01])E", mangled)
    if m:
        return f"gather_sum<{_GATHER_INTERP[int(m[1])]}, kClip={m[2]}>"
    if "ordered_sum_kernel" in mangled:
        return "ordered_sum_kernel"
    m = re.search(r"dyn_kernelILi(\d)ELb([01])E", mangled)
    return f"dyn_kernel<{_DYN_KINDS[int(m[1])]}, kFw={m[2]}>" if m else mangled


def block_threads(src) -> int:
    """Threads per block of the kernels in ``src`` (each source launches
    all its kernels with one block size)."""
    text = src.read_text()
    m = re.search(r"constexpr int (?:kFrames(?:PerBlock)?|kThreads) = (\d+);", text)
    if m:
        return int(m[1])
    return 32 * int(re.search(r"constexpr int kWarps(?:PerBlock)? = (\d+);", text)[1])


def main() -> int:
    srcs, _ = cuda_build._sources()
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        for src in srcs:
            threads = block_threads(src)
            r = subprocess.run([cuda_build.find_nvcc(), *flags, "--resource-usage", "-cubin", "-o",
                                str(Path(tmp) / (src.stem + ".cubin")), str(src)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stderr, file=sys.stderr)
                return r.returncode
            name = None
            for line in r.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    name = kernel_name(m[1])
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    smem = re.search(r"(\d+) bytes smem", line)
                    regs, smem = int(m[1]), int(smem[1]) if smem else 0
                    blocks = min(65536 // (regs * threads), 2048 // threads,
                                 (227 * 1024) // (smem + 1024) if smem else 32)
                    print(f"{name}: {regs} registers, {smem} B static shared, {threads} threads -> "
                          f"{blocks} blocks/SM ({blocks * threads * 100 // 2048} % of 2048 threads) | {line.strip()}")
                elif "spill" in line and name:
                    print(f"{name}: {line.strip()}")
    print(dynamic_shared())
    return 0


def dynamic_shared() -> str:
    """The dynamics kernel's shared memory a tile (a warp) at the paths'
    shapes, and the warps an SM that it leaves room for."""
    from whitebox_tpu_torch.ops import dynamics_cuda as dc

    rows = []
    for label, kind, B, C, F, look in (("compressor [64, 2, 2^18]", "compressor", 64, 2, 1 << 18, 0),
                                       ("master limiter [1, 2, 2^18], lookahead 240", "limiter", 1, 2, 1 << 18, 240),
                                       ("ballistics [64, 2^18]", "ballistics", 64, 0, 1 << 18, 0)):
        l = dc.sub_frames(B, F, fused=kind != "ballistics")
        b = dc.warp_bytes(kind, C, l, look)
        rows.append(f"{label}: l = {l}, {b} B a tile -> {min(dc.SMEM_BYTES // b, 64)} tiles an SM by shared memory")
    return "dyn_kernel dynamic shared memory: " + "; ".join(rows)


if __name__ == "__main__":
    sys.exit(main())
