"""Serving start-up: the build cache of the compiled libraries, the
``--aot-cache`` directory and streamed weight placement (port of
``pea_diffusion_tpu/utils/startup.py``).

What a process start recompiles differs between the two packages. The JAX
package traces and compiles one XLA program; its persistent compile cache
and its ``jax.export`` artifacts keep that work across restarts. The port
runs eager: its only compiled artifacts are two libraries, the CUDA kernel
library that ``ops/kernel_build.py`` builds with nvcc (keyed by a hash of
the sources and flags) and the native tar reader that
``data/native_reader.py`` builds with g++. So here:

- `enable_compile_cache` points both builds at one directory, which keeps
  them across process starts (the checkout's ``build/`` by default);
- `AOTCache` (``--aot-cache DIR``) keeps them under DIR in a subdirectory
  keyed by `aot_key` of the sources' hashes, the torch and CUDA versions
  and the card's compute capability, since the library is specific to the
  architecture;
- ``StableDiffusionXLPEAPipeline.prefetch`` loads the kernel library
  (building it if cold) and resolves every launcher an operating point
  calls, from shapes alone, so that it can run while `device_put_streamed`
  places the weights.

The JAX module's ``export_program``, ``save_program``, ``load_program`` and
``_abstractify`` serialize a traced program; eager PyTorch traces none, so
they have no counterpart here.
"""
from __future__ import annotations

import atexit
import hashlib
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

from ..data import native_reader
from ..ops import kernel_build

CHECKOUT_BUILD = Path(kernel_build.__file__).resolve().parents[2] / "build"
USER_CACHE = Path("~/.cache/pea_diffusion_tpu_torch")


def default_cache_dir() -> Path:
    """The checkout's ``build/`` when it can be written, else
    ``~/.cache/pea_diffusion_tpu_torch/`` (an installed package cannot write
    into its own tree)."""
    probe = CHECKOUT_BUILD if CHECKOUT_BUILD.exists() else CHECKOUT_BUILD.parent
    if os.access(probe, os.W_OK):
        return CHECKOUT_BUILD
    return USER_CACHE.expanduser()


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Points the kernel library's build (``<cache_dir>/kernels``) and the
    native reader's (``<cache_dir>/native``) at `cache_dir`, by default
    `default_cache_dir()`; returns it. Safe to call more than once. It
    leaves a library this process has loaded alone: the kernel library
    loaded first keeps serving every launcher, and an open reader keeps its
    library; the directory takes the builds and loads that come after."""
    root = Path(cache_dir).expanduser().resolve() if cache_dir else default_cache_dir()
    kernel_build.BUILD_DIR = root / "kernels"
    native_reader.BUILD_DIR = root / "native"
    return str(root)


def temporary_compile_cache() -> str:
    """``--no-compile-cache``: builds into a fresh temporary directory,
    removed at exit, so every process start compiles."""
    root = tempfile.mkdtemp(prefix="pea_compile_")
    atexit.register(shutil.rmtree, root, True)
    return enable_compile_cache(root)


def aot_key(*parts) -> str:
    """A stable key of `parts` (their reprs), the torch and CUDA versions
    and the card's compute capability ("cpu" without a card)."""
    import torch

    arch = "cpu"
    if torch.cuda.is_available():
        arch = "sm_%d%d" % torch.cuda.get_device_capability()
    src = repr(parts) + torch.__version__ + str(torch.version.cuda) + arch
    return hashlib.sha256(src.encode()).hexdigest()[:24]


class AOTCache:
    """``--aot-cache DIR``: what a restarted process would otherwise redo,
    kept under DIR/<key>, the key `aot_key` of the kernel library's and the
    reader's source hashes (their file names). Making one points the
    compile cache there (`enable_compile_cache`); the builds write a
    temporary file and rename it, so two servers starting at once never
    read a torn library."""

    def __init__(self, directory: str):
        self.dir = str(directory)
        self.key = aot_key("pea_diffusion_tpu_torch", kernel_build.library_path().name,
                           native_reader.library_path().name)
        self.root = enable_compile_cache(os.path.join(self.dir, self.key))

    def warm(self) -> bool:
        """Whether the kernel library is already built here."""
        return kernel_build.library_path().exists()


def unet_attention_routes(unet, latent_h: int, latent_w: int, skv: int) -> set:
    """The attention routes ("onepass", "flash", "plain") that one forward
    of `unet` (or of a ControlNet: down and mid blocks only) on a CUDA
    tensor takes at latents of (latent_h, latent_w) with `skv` text tokens:
    each attention module's dispatch at its level's sequence length."""
    from ..models.layers import attention_route

    n = len(unet.down_blocks)
    levels = ([(blk, i) for i, blk in enumerate(unet.down_blocks)] + [(unet.mid_block, n - 1)]
              + [(blk, n - 1 - i) for i, blk in enumerate(getattr(unet, "up_blocks", []))])
    routes = set()
    for block, level in levels:
        sq = (latent_h >> level) * (latent_w >> level)
        for tr in getattr(block, "attentions", []):
            for tb in tr.transformer_blocks:
                for attn, kv in ((tb.attn1, sq), (tb.attn2, skv)):
                    routes.add(attention_route(sq, kv, attn.num_heads, attn.head_dim,
                                               attn.backend, "cuda"))
    return routes


def launcher_symbols(routes, fused_gn: bool) -> Dict[str, list]:
    """{launcher symbol: its argtypes} of the kernel routes in `routes` and,
    with `fused_gn`, of the fused GroupNorm (B6, B6-b, and the rule that
    picks their variant)."""
    from ..ops import flash_attention, groupnorm, onepass_attention

    out = {}
    if "onepass" in routes:
        out["pea_onepass_attention_fwd"] = onepass_attention._ARGTYPES
    if "flash" in routes:
        out["pea_flash_attention_fwd"] = flash_attention._ARGTYPES
    if fused_gn:
        out["pea_group_norm_fwd"] = groupnorm._ARGTYPES
        out["pea_group_norm_bias_fwd"] = groupnorm._BIAS_ARGTYPES
        out["pea_gn_shipped_variant"] = groupnorm._SHIPPED_ARGTYPES
    return out


def device_put_streamed(state, device, chunk_leaves: int = 32):
    """Copies `state` (a state dict, or an nn.Module's parameters and
    buffers) to `device` on a background thread, `chunk_leaves` tensors at
    a time, and returns `join`. Do the other start-up work meanwhile (the
    pipeline's `prefetch`), then call `join()`: it returns the placed state
    dict, or the module with its tensors on `device`, and raises the
    thread's exception if it had one.

    Copies to a card go from pinned host memory on a side stream; `join`
    makes the current stream wait for that stream, so nothing queued after
    it reads weights still in flight."""
    import torch
    from torch import nn

    device = torch.device(device)
    module = state if isinstance(state, nn.Module) else None
    if module is not None:
        entries = [(m, name, t, kind) for m in module.modules()
                   for kind, table in (("param", m._parameters), ("buffer", m._buffers))
                   for name, t in table.items() if t is not None]
        tensors = [t for _, _, t, _ in entries]
    else:
        keys = list(state)
        tensors = [state[k] for k in keys]
    out: list = [None] * len(tensors)
    err: list = []
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def work():
        try:
            for i in range(0, len(tensors), chunk_leaves):
                chunk = tensors[i:i + chunk_leaves]
                if cuda:
                    with torch.cuda.stream(side):
                        staged = [t.detach().pin_memory() if t.device.type == "cpu"
                                  else t.detach() for t in chunk]
                        out[i:i + len(chunk)] = [t.to(device, non_blocking=True)
                                                 for t in staged]
                    side.synchronize()  # the pinned copies may go now
                else:
                    out[i:i + len(chunk)] = [t.detach().to(device) for t in chunk]
        except Exception as e:  # surfaced at join()
            err.append(e)

    thread = threading.Thread(target=work, daemon=True, name="pea-weight-stream")
    thread.start()

    def join():
        thread.join()
        if err:
            raise err[0]
        if cuda:
            current = torch.cuda.current_stream(device)
            current.wait_stream(side)
            for t in out:
                t.record_stream(current)
        if module is None:
            return dict(zip(keys, out))
        placed: dict = {}
        for (m, name, t, kind), new in zip(entries, out):
            new = placed.setdefault(id(t), new)  # a tensor two modules share stays shared
            if kind == "param":
                m._parameters[name] = nn.Parameter(new, requires_grad=t.requires_grad)
            else:
                m._buffers[name] = new
        return module

    return join
