"""Builds and loads the port's hand-written CUDA kernels.

Every ``ops/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into one
object each (all started together), and the objects link into one shared
library with a plain C interface under ``ray_tpu_torch/_build/``. The
build runs at the first launch, never at import, and again when any
source is newer than the library. The library is bound with ``ctypes``:
every pointer and the stream are ``c_void_p``, and every C entry returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into
an exception.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libray_tpu_torch_kernels.so")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
# C entry points and their argument types (see ops/csrc/*.cu).
_SIGNATURES: Dict[str, List] = {
    # x, w, out, rows, d, eps, dtype (0 f32, 1 bf16, 2 fp16), the launch
    # plan (threads per row, slots per thread, vector path, chunks),
    # stream
    "rt_rms_norm": [_P, _P, _P, _I, _I, _F] + [ctypes.c_int] * 5 + [_P],
    # q, k, v, o, lse, B, H, KVH, Sq, Sk, D, q strides (b, s, h),
    # k strides, v strides, causal, sm_scale, the launch plan (blocks,
    # first query tile, tile step), stream
    "rt_flash_attention_fwd": [_P] * 5 + [_I] * 15
                              + [ctypes.c_int, _F, _I, ctypes.c_int,
                                 ctypes.c_int, _P],
    # q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, D, q / k / v /
    # dout strides (b, s, h), causal, sm_scale, stream
    "rt_flash_attention_bwd_dq": [_P] * 7 + [_I] * 18
                                 + [ctypes.c_int, _F, _P],
    # as above with dk, dv and the f32 scratch pk, pv (null when H ==
    # KVH) in place of dq
    "rt_flash_attention_bwd_dkv": [_P] * 10 + [_I] * 18
                                  + [ctypes.c_int, _F, _P],
    # x, w8, scale, out, workspace, M, K, N, block_m, splits,
    # k_per_split, vec_ok, stream
    "rt_int8_matmul": [_P] * 5 + [_I] * 6 + [ctypes.c_int, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _headers() -> List[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "port's kernels build on the machine with the GPU")
    return found


def _fresh(out: str, deps: List[str]) -> bool:
    if not os.path.exists(out):
        return False
    built = os.path.getmtime(out)
    return all(os.path.getmtime(d) <= built for d in deps)


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands side by side; return their outputs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors, outs = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out.strip()[-4000:]}")
    if errors:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
    return outs


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; return
    its path. With ``verbose``, a build that runs prints what the
    assembler reports (registers, shared memory, spills) to stderr;
    delete ``_build/`` to force one."""
    srcs = _sources()
    if _fresh(_LIB_PATH, srcs + _headers()):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [os.path.join(_BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in srcs]
    try:
        outs = _run_all([[nvcc, *_ARCH, *_FLAGS, "-Xptxas", "-v",
                          "-I", _SRC_DIR, "-c", s, "-o", o]
                         for s, o in zip(srcs, objs)])
        if verbose:
            print("".join(outs), file=sys.stderr, flush=True)
        tmp = f"{_LIB_PATH}.tmp.{tag}"
        _run_all([[nvcc, *_ARCH, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, _LIB_PATH)  # atomic: concurrent builds are benign
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return _LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error from its launch."""
    if rc != 0:
        raise KernelLaunchError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, which must be the current
    CUDA device (the C entries launch there). Reads the raw handle
    without building a ``torch.cuda.Stream`` (a few microseconds a
    call)."""
    import torch
    current = torch._C._cuda_getDevice()
    if device.index is not None and device.index != current:
        raise ValueError(f"tensor on {device} but the current CUDA device "
                         f"is {current}")
    return torch._C._cuda_getCurrentRawStream(current)
