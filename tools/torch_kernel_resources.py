#!/usr/bin/env python3
"""Registers, spills, shared memory and occupancy of each kernel in CUDA
sources of the PyTorch/CUDA port, and whether its code runs on the tensor
cores, read from the compiled cubin.

    python3 tools/torch_kernel_resources.py [source.cu ...]

Default: every ``classifying_vae_lstm_tpu_torch/csrc/*.cu``. Each source is
compiled for sm_90a as ``ops/_build.py`` compiles it (``-cubin`` in place of
``-shared``); ``cuobjdump --dump-resource-usage`` gives each kernel's
registers, stack, local memory (spills) and static shared memory, and
``cuobjdump -sass`` counts its instructions, its ``HMMA`` / ``HGMMA``
(tensor-core) and its ``LDG`` (global load) instructions. Occupancy
is the H100's arithmetic limit from registers (65,536 a SM), threads (2,048)
and shared memory (228 KB a SM, 227 KB a block) at the block size given in
``--threads`` (kernel-name substring=threads; unnamed kernels are listed
without it) and the dynamic shared memory given in ``--smem``. Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit); runs no kernel.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "classifying_vae_lstm_tpu_torch" / "csrc"
SM_REGS, SM_THREADS, SM_SMEM, SM_BLOCKS = 65536, 2048, 233472, 32


def _tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", name)
    return cand if os.path.exists(cand) else name


def demangle(names: list[str]) -> dict[str, str]:
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines() if out.returncode == 0 else names
    return dict(zip(names, lines))


def resources(cubin: str) -> dict[str, dict]:
    """Per mangled kernel name: REG, STACK, SHARED, LOCAL from cuobjdump."""
    txt = subprocess.run([_tool("cuobjdump"), "--dump-resource-usage", cubin],
                         capture_output=True, text=True, check=True).stdout
    res, name = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and name:
            res[name] = dict(zip(("regs", "stack", "shared", "local"), map(int, m.groups())))
    return res


def sass_counts(cubin: str) -> dict[str, dict]:
    """Per mangled kernel name: its SASS instructions, and among them the
    HMMA / HGMMA (tensor-core) and LDG (global load) instructions."""
    txt = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"sass": 0, "hmma": 0, "ldg": 0}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            c = counts[name]
            c["sass"] += 1
            c["hmma"] += bool(re.search(r"\bH(G)?MMA\b", line))
            c["ldg"] += bool(re.search(r"\bLDG\b", line))
    return counts


def occupancy(regs: int, threads: int, smem: int) -> int:
    """Blocks a SM holds, from registers (allocated per warp in units of 256),
    threads and shared memory (cuobjdump's static figure includes the 1 KB
    the card reserves a block)."""
    warps = -(-threads // 32)
    regs_warp = -(-max(regs, 1) * 32 // 256) * 256
    by_regs = SM_REGS // (regs_warp * warps)
    by_threads = SM_THREADS // threads
    by_smem = SM_SMEM // smem if smem else SM_BLOCKS
    return min(by_regs, by_threads, by_smem, SM_BLOCKS)


def report(src: Path, threads: dict[str, int], smem: dict[str, int]) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, src.stem + ".cubin")
        subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-cubin", "-I", str(src.parent), "-o", cubin, str(src)],
                       check=True)
        res, sass = resources(cubin), sass_counts(cubin)
    names = demangle(sorted(res))
    print(f"--- {src}")
    for mangled in sorted(res):
        r, pretty = res[mangled], names[mangled]
        c = sass.get(mangled, {"sass": 0, "hmma": 0, "ldg": 0})
        line = (f"{pretty}: registers {r['regs']}, stack {r['stack']} B, local (spills) "
                f"{r['local']} B, static shared {r['shared']} B; SASS {c['sass']} instructions, "
                f"HMMA/HGMMA {c['hmma']}, LDG {c['ldg']}")
        nt = next((n for k, n in threads.items() if k in pretty), None)
        if nt:
            dyn = next((n for k, n in smem.items() if k in pretty), 0)
            blocks = occupancy(r["regs"], nt, r["shared"] + dyn)
            line += (f"; at {nt} threads and {dyn} B dynamic shared: {blocks} blocks a SM, "
                     f"occupancy {blocks * nt / SM_THREADS:.3f}")
        print(line)


def _pairs(items):
    out = {}
    for item in items or ():
        key, _, val = item.rpartition("=")
        out[key] = int(val)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--threads", nargs="*", help="kernel-name substring=threads per block")
    ap.add_argument("--smem", nargs="*", help="kernel-name substring=dynamic shared bytes")
    a = ap.parse_args(argv)
    for src in a.sources or sorted(CSRC.glob("*.cu")):
        report(src.resolve(), _pairs(a.threads), _pairs(a.smem))
    return 0


if __name__ == "__main__":
    sys.exit(main())
