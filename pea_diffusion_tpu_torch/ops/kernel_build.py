"""Builds the CUDA source ``csrc/attention_fwd.cu`` and loads it with ctypes.

The source compiles with nvcc for ``sm_90a`` into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library goes to ``build/kernels/`` at the root of the checkout, named by a
hash of the source and flags, so an edited source builds anew and an
unchanged one is reused. Nothing is built when a module is imported: the
wrappers build on their first CUDA call, or ``build()`` builds ahead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "attention_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_functions: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def library_path() -> Path:
    """Where the source builds to under the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libattention_fwd-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compiles the library unless it is built already. Returns nvcc's
    output (register and shared-memory use from ptxas; empty if nothing was
    compiled) and raises with that output if the build fails."""
    target = library_path()
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def launch(symbol: str, argtypes: Sequence, *args) -> None:
    """Calls the launcher `symbol` of the library, built and loaded on first
    use, and raises if the launch failed (the launcher returns
    cudaGetLastError())."""
    fn = _functions.get(symbol)
    if fn is None:
        build()
        fn = getattr(ctypes.CDLL(str(library_path())), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{symbol}: kernel launch failed with CUDA error {rc}")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def half_dtype_code(*tensors) -> int:
    """Checks what the 16-bit attention kernels take (CUDA tensors on one
    device, one dtype of bfloat16 or float16, contiguous, 16-byte aligned)
    and returns the kernels' dtype code: 0 for bfloat16, 1 for float16."""
    import torch
    codes = {torch.bfloat16: 0, torch.float16: 1}
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError("kernel inputs must be CUDA tensors on one device")
        if t.dtype != first.dtype:
            raise TypeError(f"kernel inputs differ in dtype: {t.dtype} vs {first.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
    if first.dtype not in codes:
        raise TypeError(f"the attention kernels take bfloat16 or float16, not {first.dtype}")
    return codes[first.dtype]
