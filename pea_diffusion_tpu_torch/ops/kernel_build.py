"""Builds the CUDA sources ``csrc/*.cu`` into one library and loads it with
ctypes.

Each source compiles with nvcc for ``sm_90a`` into an object, all of them at
once in parallel processes, and the objects link into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library goes to ``build/kernels/`` at the root of the checkout, named by
a hash of every source and header and of the flags, so an edited source
builds anew and an unchanged one is reused. Nothing is built when a module
is imported: the wrappers build on their first CUDA call, or ``build()``
builds ahead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# A launcher's return code at or above this is a failed tensor-map encode
# plus the CUDA driver API's CUresult (kTensorMapError in
# csrc/attention_fwd_sm90.cuh).
TENSOR_MAP_ERROR = 1000

_functions: Dict[str, Callable[..., int]] = {}
# The library this process loaded: every later symbol comes from it, wherever
# the compile cache points afterwards (utils/startup.py).
_library: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def sources() -> List[Path]:
    """The kernels' sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the sources build to under the current sources, headers and
    flags."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpea_kernels-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compiles the library unless it is built already: one nvcc process per
    source, all started together, then one link. Returns nvcc's output
    (register and shared-memory use from ptxas; empty if nothing was
    compiled) and raises with that output if a step fails."""
    target = library_path()
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objects)]
    log, failed = [], []
    for src, proc in zip(sources(), procs):
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {target.name}:\n{link.stdout}")
    os.replace(tmp, target)
    for obj in objects:
        obj.unlink()
    return "".join(log)


def function(symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> Callable:
    """The C function `symbol` of the library, built and loaded on first use."""
    global _library
    fn = _functions.get(symbol)
    if fn is None:
        if _library is None:
            build()
            _library = ctypes.CDLL(str(library_path()))
        fn = getattr(_library, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _functions[symbol] = fn
    return fn


def launch(symbol: str, argtypes: Sequence, *args) -> None:
    """Calls the launcher `symbol` of the library and raises if the launch
    failed (the launcher returns cudaGetLastError(), or a tensor-map encode
    error)."""
    rc = function(symbol, argtypes)(*args)
    if rc >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{symbol}: encoding a TMA tensor map failed with CUresult "
                           f"{rc - TENSOR_MAP_ERROR}")
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
