"""Registers, shared memory and spills of every CUDA kernel of the port.

    python -m whitebox_tpu_torch.tools.kernel_resources

Compiles ``csrc/*.cu`` once more with the build's own flags plus
``--resource-usage`` (to a cubin that is thrown away) and prints what
``ptxas`` reports per kernel, each named by its template arguments, with
the resident blocks per SM that registers and shared
memory allow on an H100 (65,536 registers, 227 KB of shared memory, 2,048
threads per SM). Needs ``nvcc``; no card.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

from whitebox_tpu_torch.ops import cuda_build

_INTERP = ("kLinear", "kCatmull", "kPoly", "kPoly6")


def kernel_name(mangled: str) -> str:
    m = re.search(r"mix_kernelILb([01])ELi(\d)ELi(\d)E", mangled)
    if m:
        return f"mix_kernel<kAuto={m[1]}, {_INTERP[int(m[2])]}, kCh={m[3]}>"
    m = re.search(r"mix_per_track_kernelILi(\d)ELi(\d)E", mangled)
    if m:
        return f"mix_per_track_kernel<{_INTERP[int(m[1])]}, kCh={m[2]}>"
    m = re.search(r"cascade_blocksILi(\d)ELb([01])E", mangled)
    if m:
        return f"cascade_blocks<S={m[1]}, kWrite={m[2]}>"
    m = re.search(r"cascade_carryILi(\d)E", mangled)
    return f"cascade_carry<S={m[1]}>" if m else mangled


def block_threads(src) -> int:
    """Threads per block of the kernels in ``src`` (each source launches
    all its kernels with one block size)."""
    text = src.read_text()
    m = re.search(r"constexpr int kFramesPerBlock = (\d+);", text)
    if m:
        return int(m[1])
    return 32 * int(re.search(r"constexpr int kWarpsPerBlock = (\d+);", text)[1])


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
