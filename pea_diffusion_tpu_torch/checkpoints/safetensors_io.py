"""Dependency-free safetensors reader and writer (the port's own copy of the
JAX package's ``checkpoints/safetensors_io.py``, plus a torch reader).

Format: 8-byte little-endian header length, a JSON header {name: {dtype,
shape, data_offsets}}, then the raw tensor bytes. Covers F64/F32/F16/BF16/
I64/I32/I16/I8/U8/BOOL.

- ``load_safetensors`` gives numpy arrays, BF16 upcast to float32 by
  default (numpy has no bfloat16), as the JAX package reads them.
- ``load_safetensors_torch`` gives ``torch.Tensor``s that view a private
  memory map of the file: no second copy of it is made (an SDXL UNet is
  ~5.1 GB in bf16). BF16 stays bfloat16 unless `upcast_bf16`; the values
  are those of ``load_safetensors``.
- ``save_safetensors`` writes numpy arrays or torch tensors (bfloat16
  tensors as BF16); a dict of numpy arrays gives the bytes the JAX
  package's writer gives.
"""
from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_INV = {np.dtype(v).name: k for k, v in _DTYPES.items()}
_TORCH = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_TORCH_INV = {v: k for k, v in _TORCH.items()}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    u = raw.view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32)


def _header(buf) -> tuple:
    n = struct.unpack("<Q", buf[:8])[0]
    return json.loads(bytes(buf[8:8 + n])), 8 + n


def load_safetensors(path: str, upcast_bf16: bool = True) -> Dict[str, np.ndarray]:
    """{name: numpy array}; BF16 as float32 (or its raw uint16 bits)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        buf = data[lo:hi]
        if meta["dtype"] == "BF16":
            arr = np.frombuffer(buf, np.uint16)
            arr = _bf16_to_f32(arr) if upcast_bf16 else arr
        else:
            arr = np.frombuffer(buf, _DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def load_safetensors_torch(path: str, upcast_bf16: bool = False) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} viewing a copy-on-write memory map of the file:
    the pages are read when a tensor is first used, and writing to a tensor
    never reaches the file. With `upcast_bf16`, BF16 tensors come as float32
    copies (exact)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, start = _header(mm)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _TORCH[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        t = (torch.frombuffer(mm, dtype=dtype, count=count, offset=start + lo) if count
             else torch.empty(0, dtype=dtype))
        t = t.reshape(meta["shape"])
        out[name] = t.float() if upcast_bf16 and dtype == torch.bfloat16 else t
    return out


def _entry(arr) -> tuple:
    """(dtype name, shape, byte count, a function giving the bytes) of a
    numpy array or a torch tensor (on any device)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        n = t.numel() * t.element_size()

        def data():
            c = t.cpu().contiguous()
            return (c.view(torch.int16) if c.dtype == torch.bfloat16 else c).numpy().tobytes()

        return _TORCH_INV[t.dtype], list(t.shape), n, data
    arr = np.ascontiguousarray(arr)
    return _INV[arr.dtype.name], list(arr.shape), arr.nbytes, arr.tobytes


def save_safetensors(path: str, tensors: Mapping, metadata: Dict[str, str] | None = None
                     ) -> None:
    """Writes the header, then one tensor's bytes at a time (a large state
    dict is never held twice in host memory)."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = metadata
    entries = []
    offset = 0
    for name, arr in tensors.items():
        dtype, shape, n, data = _entry(arr)
        header[name] = {
            "dtype": dtype,
            "shape": shape,
            "data_offsets": [offset, offset + n],
        }
        entries.append(data)
        offset += n
    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for data in entries:
            f.write(data())
