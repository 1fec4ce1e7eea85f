"""The port's CUDA library of the main path: csrc/listtrace.cu (the list
kernels, ops/kernels/listtrace.py), csrc/hier_build.cu (the fused
supercluster candidate build, ops/cluster.py) and csrc/row_scatter.cu (the
backward's row sums, ops/kernels/rows.py), built by nvcc for sm_90a into
one library at first use and loaded with ctypes, and the two helpers
every launcher of the port's kernels shares: the current stream of a
tensor's device and a built kernel's registers and occupancy.

It sits below all of its users, so the candidate build never imports the
list tracer to reach its kernel.  Nothing here touches CUDA at import.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
CSRC = CSRC_DIR / "listtrace.cu"
HIER_CSRC = CSRC_DIR / "hier_build.cu"
ROW_CSRC = CSRC_DIR / "row_scatter.cu"
HEADERS = [CSRC_DIR / "mt8.cuh"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_cuda_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def load_cuda_library() -> ctypes.CDLL:
    """Build csrc/listtrace.cu, csrc/hier_build.cu and csrc/row_scatter.cu
    with nvcc (at first use, into the package's build/ directory) into one
    library and load it.  Raises if the build fails."""
    global _cuda_lib
    if _cuda_lib is None:
        from sycl_ray_tracing_tpu_torch.native import build_shared_library

        path = build_shared_library([CSRC, HIER_CSRC, ROW_CSRC],
                                    "liblisttrace",
                                    [nvcc_path()], NVCC_FLAGS, HEADERS)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (("srt_block_tiles", [p] * 8 + [i] * 3 + [p]),
                           ("srt_list_tiles", [p] * 7 + [i] * 4 + [p]),
                           ("srt_block_tiles_info", [p]),
                           ("srt_list_tiles_info", [i, p]),
                           ("srt_hier_build",
                            [p, p] + [p, i] * 3 + [p] * 4 + [i] * 8 + [p]),
                           ("srt_hier_build_info", [i, p]),
                           ("srt_row_sum", [p, p] + [i] * 4 + [p] * 3),
                           ("srt_row_sum_info", [i] * 3 + [p])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _cuda_lib = lib
    return _cuda_lib


def stream_of(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_info(name: str, fn, *args) -> dict:
    """A built kernel's registers and local (spill) bytes per thread,
    threads per block and resident blocks and warps per SM, from its C
    entry point ``fn(*args, int[5])``."""
    info = (ctypes.c_int * 5)()
    rc = fn(*args, info)
    if rc != 0:
        raise RuntimeError(f"{name}_info failed: CUDA error {rc}")
    regs, local, blocks, threads, shared = info
    return dict(registers=regs, local_bytes=local, threads=threads,
                blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
                shared_bytes=shared)
