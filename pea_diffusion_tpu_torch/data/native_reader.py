"""ctypes binding for the native C++ tar shard reader ``native/wds_tar.cc``
(the port's own loader; the ABI and signatures of the JAX package's
``data/native_reader.py``).

C++ threads stream and parse the shards (no GIL) into a bounded queue;
``iter_native_samples`` yields the same raw-sample dicts as
``wds_reader.iter_tar_samples``. The library builds with g++ from the
checkout's ``native/wds_tar.cc`` on first use, into ``build/native/`` at
the root of the checkout (or `build_dir`), named by a hash of the source and
flags: an edited source builds anew, an unchanged one is reused. The build
writes a temporary file and renames it, so processes that build at once do
not read a half-written library. Nothing is built when the module is
imported, nothing is written into ``native/``, and no library built
elsewhere is loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wds_tar.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_libs: Dict[Path, ctypes.CDLL] = {}


class _WdsEntry(ctypes.Structure):
    _fields_ = [
        ("ext", ctypes.c_char_p),
        ("key", ctypes.c_char_p),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("size", ctypes.c_int64),
    ]


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the source builds to under the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libwds_tar-{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compiles the library unless it is built already; returns its path.
    Raises OSError when the source is absent or g++ fails."""
    if not SOURCE.is_file():
        raise OSError(f"no native reader source at {SOURCE}")
    target = library_path(build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise OSError(f"g++ not found: {e}") from e
    if proc.returncode != 0:
        raise OSError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def load(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The library, built and loaded on first use, its functions typed."""
    path = build(build_dir)
    lib = _libs.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(path))
    lib.wds_open.restype = ctypes.c_void_p
    lib.wds_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]
    lib.wds_next.restype = ctypes.c_long
    lib.wds_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.POINTER(_WdsEntry)),
                             ctypes.POINTER(ctypes.c_int)]
    lib.wds_free_sample.restype = None
    lib.wds_free_sample.argtypes = [ctypes.POINTER(_WdsEntry), ctypes.c_int]
    lib.wds_close.restype = None
    lib.wds_close.argtypes = [ctypes.c_void_p]
    lib.wds_samples_read.restype = ctypes.c_long
    lib.wds_samples_read.argtypes = [ctypes.c_void_p]
    lib.wds_errors.restype = ctypes.c_long
    lib.wds_errors.argtypes = [ctypes.c_void_p]
    _libs[path] = lib
    return lib


def available(build_dir: Optional[Path] = None) -> bool:
    try:
        load(build_dir)
        return True
    except OSError as e:
        print(f"[native_reader] unavailable: {e}")
        return False


def iter_native_samples(
    shards: Sequence[str],
    num_threads: int = 4,
    queue_capacity: int = 128,
    build_dir: Optional[Path] = None,
) -> Iterator[Dict[str, bytes]]:
    """Yield raw samples {__key__, ext: bytes} from many shards, read and
    parsed concurrently by C++ threads (in shard order with one thread)."""
    lib = load(build_dir)
    arr = (ctypes.c_char_p * len(shards))(*[s.encode() for s in shards])
    h = lib.wds_open(arr, len(shards), num_threads, queue_capacity)
    try:
        entries = ctypes.POINTER(_WdsEntry)()
        n = ctypes.c_int()
        while lib.wds_next(h, ctypes.byref(entries), ctypes.byref(n)):
            sample: Dict[str, bytes] = {}
            for i in range(n.value):
                e = entries[i]
                if not sample:
                    sample["__key__"] = e.key.decode(errors="replace")
                sample[e.ext.decode(errors="replace")] = ctypes.string_at(e.data, e.size)
            lib.wds_free_sample(entries, n.value)
            if len(sample) > 1:
                yield sample
    finally:
        lib.wds_close(h)
