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
(tensor-core), ``IMMA`` (int8 tensor-core), ``IDP`` (``__dp4a``) and
``LDG`` (global load) instructions. Occupancy
is the H100's arithmetic limit from registers (65,536 a SM), threads (2,048)
and shared memory (228 KB a SM, 227 KB a block) at the block size given in
``--threads`` (kernel-name substring=threads; ``THREADS`` below gives
some; unnamed kernels are listed without it) and the dynamic shared memory
given in ``--smem`` (``SMEM``). Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit); runs no kernel.

    python3 tools/torch_kernel_resources.py --clusters 8 16 [--cluster_smem B]

asks the card instead (``cudaOccupancyMaxActiveClusters``, needs the card)
how many thread-block clusters of each size it can hold at once, for a
probe kernel of 256 threads with B bytes of dynamic shared memory a block
(131,072 by default: a 16-block cluster's slice of 2 MiB of f32 weights);
sizes above 8 ask for the non-portable cluster sizes.
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
# block sizes (and dynamic shared memory at the seq-concat cl_vae's K=13,
# L=16, H=1,024, of the int8 cl_vrnn kernel at H=1,536, 64 songs, of the int8
# cl_vae kernel at H=5,120, 64 songs, no x_prev, every slice resident, and
# below) of the kernels whose occupancy is listed without --threads / --smem
# (the first key a kernel's name holds is taken: wgrad_kernel<lstm_bwd_wgrad>
# runs 256 threads)
THREADS = {"generate_cluster_kernel<float, true>": 384,
           "generate_cluster_kernel<__nv_bfloat16, true>": 384, "generate_cluster_kernel": 512,
           "wgrad_": 256, "lstm_bwd_": 128, "generate_int8_kernel": 512, "vae_tc_product": 128,
           "vae_tc_dw": 128, "vae_tc_head": 256, "vae_tc_latent": 256, "vae_tc_key": 256,
           "vae_tc_fwd_rows": 512, "generate_vae_coop_kernel": 512, "generate_kernel": 512,
           "two_cell_step": 128, "two_cell_layout": 256, "lstm_fwd_kernel": 256}
# the cluster cl_vae kernel's plan (cuda_generate_vae.cluster_plan) at 64
# songs: its register path at jsball_vae's width (D=H=88, L=4, x_prev; 384
# threads) in f32 and bf16, f32 at H=256 (two blocks a cluster) and bf16 at
# H=256 (one), 512 threads; the f32 / bf16 generation kernel at jsball_vrnn4's shape (H=256, L=8, 64
# songs, f32 slices resident; the bf16 one at H=1,024, L=2, resident:
# 226,048 B at 256 songs), the two-cell forward's steps at L=8 / L=2, the
# cooperative cl_vae kernel in bf16 at H=5,120 (x rows resident, head
# streamed) and in f32 at D=88, H=256, and the f32 LSTM forward at the
# training (1 row a thread) and the evaluation shape (4)
SMEM = {"generate_cluster_kernel<float, true>": 129104,
        "generate_cluster_kernel<__nv_bfloat16, true>": 59984,
        "generate_cluster_kernel<float": 172032, "generate_cluster_kernel<__nv_bfloat16": 182832,
        "vae_tc_latent": 4688, "vae_tc_key": 2256, "vae_tc_fwd_rows": 25936,
        "generate_int8_kernel": 122496, "generate_vae_coop_kernel<signed char>": 220224,
        "generate_vae_coop_kernel<__nv_bfloat16>": 195648,
        "generate_vae_coop_kernel<float>": 87488, "lstm_fwd_kernel<1,": 203520,
        "lstm_fwd_kernel<4,": 224256,
        "generate_kernelIf": 91392, "generate_kernelI13": 226048, "two_cell_step_f32": 27648,
        "two_cell_step_tc": 46080}


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
    HMMA / HGMMA (tensor-core), IMMA (int8 tensor-core), IDP (``__dp4a``)
    and LDG (global load) instructions."""
    txt = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"sass": 0, "hmma": 0, "imma": 0, "idp": 0, "ldg": 0}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            c = counts[name]
            c["sass"] += 1
            c["hmma"] += bool(re.search(r"\bH(G)?MMA\b", line))
            c["imma"] += bool(re.search(r"\bIMMA\b", line))
            c["idp"] += bool(re.search(r"\bIDP\b", line))
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
        c = sass.get(mangled, {"sass": 0, "hmma": 0, "imma": 0, "idp": 0, "ldg": 0})
        line = (f"{pretty}: registers {r['regs']}, stack {r['stack']} B, local (spills) "
                f"{r['local']} B, static shared {r['shared']} B; SASS {c['sass']} instructions, "
                f"HMMA/HGMMA {c['hmma']}, IMMA {c['imma']}, IDP {c['idp']}, LDG {c['ldg']}")
        nt = next((n for k, n in threads.items() if k in pretty), None)
        if nt:
            dyn = next((n for k, n in smem.items() if k in pretty), 0)
            blocks = occupancy(r["regs"], nt, r["shared"] + dyn)
            line += (f"; at {nt} threads and {dyn} B dynamic shared: {blocks} blocks a SM, "
                     f"occupancy {blocks * nt / SM_THREADS:.3f}")
        print(line)


CLUSTER_PROBE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) cluster_probe(float* out) {
  extern __shared__ float s[];
  s[threadIdx.x] = (float)threadIdx.x;
  __syncthreads();
  if (out) out[blockIdx.x] = s[0];
}
extern "C" int cvl_max_clusters(int cluster, int smem, int* result) {
  cudaError_t e = cudaFuncSetAttribute(cluster_probe,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!e && cluster > 8)
    e = cudaFuncSetAttribute(cluster_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 132);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(result, (void*)cluster_probe, &cfg);
}
"""


def max_clusters(sizes: list[int], smem: int) -> None:
    """Print how many clusters of each size the card holds at once."""
    import ctypes

    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "libprobe.so")
        Path(src).write_text(CLUSTER_PROBE)
        subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
        fn = ctypes.CDLL(lib).cvl_max_clusters
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        for size in sizes:
            n = ctypes.c_int(-1)
            err = fn(size, smem, ctypes.byref(n))
            print(f"clusters of {size} blocks (256 threads, {smem} B dynamic shared each): "
                  + (f"{n.value} at once ({n.value * size} blocks)" if err == 0
                     else f"refused, CUDA error {err}"))


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
    ap.add_argument("--clusters", nargs="*", type=int, help="cluster sizes to ask the card for")
    ap.add_argument("--cluster_smem", type=int, default=131072)
    a = ap.parse_args(argv)
    if a.clusters:
        max_clusters(a.clusters, a.cluster_smem)
        return 0
    for src in a.sources or sorted(CSRC.glob("*.cu")):
        report(src.resolve(), {**THREADS, **_pairs(a.threads)}, {**SMEM, **_pairs(a.smem)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
