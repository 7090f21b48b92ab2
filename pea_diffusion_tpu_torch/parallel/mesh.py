"""Meshes and the data-parallel / FSDP placement rules (port of
``pea_diffusion_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the JAX package's
dimension names: ("data", "fsdp"), or ("dcn", "data", "fsdp") for a hybrid
mesh. The batch splits over dcn x data (``shard_batch`` keeps this rank's
rows of the global batch); the frozen weights shard over fsdp, which stays
inside a node; the adapter and its optimizer state are replicated, and the
one collective across data ranks is the adapter gradient's ``all_reduce``
(train/trainer.py), the counterpart of the psum that XLA inserts.

``fsdp_sharding`` is the JAX rule over the port's parameters: a frozen leaf
of at least ``min_size`` elements is sharded on its largest axis that the
fsdp size divides, the rest replicated. "Largest" is read in the flax layout
(a conv kernel [kh, kw, cin, cout], a dense kernel [in, out]) and mapped to
the torch one (a conv weight [cout, cin, kh, kw], a Linear weight [out, in]),
so that where two axes are equal (cin = cout) the port shards the axis the
JAX rule picks (cin). ``shard_params`` puts the UNet under FSDP2
(``fully_shard``) with that rule as its ``shard_placement_fn``; the leaves the
rule replicates go to ``ignored_params`` (FSDP2 shards every parameter it
manages, so a whole leaf has to be left out of it), and stay whole on every
rank. At fsdp 1 the rule replicates everything, as the JAX one does, and
``shard_params`` leaves the UNet unwrapped: pure data parallelism pays no
FSDP2 hooks. ``fully_shard_unet`` is the wrap itself, at any fsdp size.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# torch.distributed.device_mesh and .tensor (~1 s of import) load inside the
# functions that use them: the layers import this package for the
# tensor-parallel collectives, and a server's start-up should not pay it.
if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
DCN_AXIS = "dcn"
MIN_SIZE = 2**16  # leaves below this many elements stay whole (the JAX rule's)


def mesh_device_type() -> str:
    """The device type of the default process group's collectives: "cuda"
    under NCCL, "cpu" under gloo (which also carries CUDA tensors through
    the host)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _resolve(shape: Tuple[int, int], n: int) -> Tuple[int, int]:
    a, b = shape
    if a == -1:
        assert b > 0 and n % b == 0, (shape, n)
        a = n // b
    if b == -1:
        assert a > 0 and n % a == 0, (shape, n)
        b = n // a
    assert a * b == n, (shape, n)
    return a, b


def make_mesh(shape: Tuple[int, int] = (-1, 1)) -> DeviceMesh:
    """shape = (data, fsdp) over every rank of the process group; -1 = all
    remaining ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    data, fsdp = _resolve(shape, dist.get_world_size())
    return init_device_mesh(mesh_device_type(), (data, fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def make_hybrid_mesh(num_slices: int, ici_shape: Tuple[int, int] = (-1, 1)) -> DeviceMesh:
    """("dcn", "data", "fsdp"): `num_slices` groups of consecutive ranks
    (torchrun numbers a node's ranks consecutively, so a group is a node),
    each split (data, fsdp) as `ici_shape`. The batch splits over dcn and
    data; fsdp stays inside a node, so weight all-gathers ride NVLink and the
    one collective across nodes is the adapter gradient's."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    assert n % num_slices == 0, (n, num_slices)
    data, fsdp = _resolve(ici_shape, n // num_slices)
    return init_device_mesh(mesh_device_type(), (num_slices, data, fsdp),
                            mesh_dim_names=(DCN_AXIS, DATA_AXIS, FSDP_AXIS))


def _size(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _coord(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.get_coordinate()[names.index(name)] if name in names else 0


def batch_shards(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index over dcn x data, the number of such indices)."""
    return (_coord(mesh, DCN_AXIS) * _size(mesh, DATA_AXIS) + _coord(mesh, DATA_AXIS),
            _size(mesh, DCN_AXIS) * _size(mesh, DATA_AXIS))


def batch_group(mesh: DeviceMesh):
    """The process group of the ranks that hold the other rows of this
    rank's batch (dcn x data at this rank's fsdp index; a group of one
    with a single data index): where the adapter gradient is averaged."""
    names = tuple(n for n in (DCN_AXIS, DATA_AXIS) if n in (mesh.mesh_dim_names or ()))
    if len(names) == 1:
        return mesh[names[0]].get_group()
    return mesh[names]._flatten().get_group()


def batch_sharding(mesh: DeviceMesh):
    """The batch's placement: its leading dim over dcn x data."""
    from torch.distributed.tensor import Shard

    del mesh
    return Shard(0)


def replicated(mesh: DeviceMesh):
    from torch.distributed.tensor import Replicate

    del mesh
    return Replicate()


def shard_batch(batch: Dict, mesh: DeviceMesh, accum: int = 1) -> Dict:
    """This rank's rows of the global batch `batch` (tensors, arrays and
    lists; other entries pass through): each of its `accum` micro-batches
    (consecutive row blocks) split into one block per data index, the
    rank's block of each, concatenated. With accum 1 that is the rank's
    contiguous block, the JAX batch sharding's."""
    r, n = batch_shards(mesh)

    def pick(v):
        if not (torch.is_tensor(v) or isinstance(v, (np.ndarray, list, tuple))):
            return v
        b = len(v)
        if b % (accum * n):
            raise ValueError(f"{b} rows do not split into {accum} micro-batches "
                             f"of {n} data shards")
        lb = b // (accum * n)
        if accum == 1 and not isinstance(v, (list, tuple)):
            return v[r * lb:(r + 1) * lb]
        idx = [i for k in range(accum) for i in range((k * n + r) * lb, (k * n + r + 1) * lb)]
        if torch.is_tensor(v):
            return v[torch.tensor(idx, device=v.device)]
        if isinstance(v, np.ndarray):
            return v[idx]
        return type(v)(v[i] for i in idx)

    return {k: pick(v) for k, v in batch.items()}


# --- the FSDP rule -------------------------------------------------------------


def _flax_order(module: nn.Module, leaf: str, ndim: int) -> Tuple[int, ...]:
    """The torch dims of a leaf in the order of its flax layout's axes."""
    if leaf in ("weight", "kernel_q") and ndim == 4:  # [kh, kw, cin, cout] <- [cout, cin, kh, kw]
        return (2, 3, 1, 0)
    if isinstance(module, nn.Linear) and leaf == "weight":  # [in, out] <- [out, in]
        return (1, 0)
    return tuple(range(ndim))


def _fsdp_dim(name: str, module: nn.Module, leaf: str, shape, n: int, min_size: int
              ) -> Optional[int]:
    """The torch dim the JAX rule shards at fsdp size `n` (its largest flax
    axis that `n` divides; a stable order breaks ties, as the JAX rule's
    ``sorted``), or None (replicated), not counting the fsdp-1 shortcut.
    The GEGLU projection (``ff.net.0.proj``) is two flax leaves, h and gate,
    fused along torch dim 0: its size is a half's."""
    numel = 1
    for s in shape:
        numel *= s
    if name.endswith("ff.net.0.proj." + leaf):
        numel //= 2
    if numel < min_size:
        return None
    order = _flax_order(module, leaf, len(shape))
    for a in sorted(range(len(shape)), key=lambda a: -shape[order[a]]):
        if shape[order[a]] % n == 0:
            return order[a]
    return None


def _leaves(root: nn.Module):
    for mname, m in root.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            yield (f"{mname}.{leaf}" if mname else leaf), m, leaf, p


def fsdp_sharding(params: nn.Module, mesh: DeviceMesh, min_size: int = MIN_SIZE
                  ) -> Dict[str, object]:
    """{parameter name: Shard(torch dim) or Replicate()} of the JAX rule
    over `params` (a module) at the mesh's fsdp size. With fsdp 1 this
    degrades to full replication."""
    from torch.distributed.tensor import Replicate, Shard

    n = _size(mesh, FSDP_AXIS)
    out = {}
    for name, m, leaf, p in _leaves(params):
        d = None if n == 1 else _fsdp_dim(name, m, leaf, tuple(p.shape), n, min_size)
        out[name] = Replicate() if d is None else Shard(d)
    return out


def fsdp_units(unet: nn.Module):
    """The modules FSDP2 wraps, innermost first: every resnet and every
    transformer block (a unit's weights are gathered for its forward and
    freed after), then the root, which holds the rest."""
    from ..models.layers import BasicTransformerBlock, ResnetBlock2D

    units = [m for m in unet.modules() if isinstance(m, (ResnetBlock2D, BasicTransformerBlock))]
    return units + [unet]


def fully_shard_unet(unet: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Puts `unet` under FSDP2 over the mesh's fsdp dimension, in place: each
    of `fsdp_units` is a ``fully_shard`` unit, the rule's sharded leaves on
    their dims (``shard_placement_fn``), the leaves it keeps whole in
    ``ignored_params``. At fsdp 1 every leaf of at least MIN_SIZE elements is
    a one-rank shard (the whole leaf behind FSDP2's hooks)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = _size(mesh, FSDP_AXIS)
    dims, ignored = {}, set()
    for name, m, leaf, p in _leaves(unet):
        d = _fsdp_dim(name, m, leaf, tuple(p.shape), n, MIN_SIZE)
        if d is None:
            ignored.add(p)
        else:
            dims[p] = d
    for unit in fsdp_units(unet):
        fully_shard(unit, mesh=mesh[FSDP_AXIS], shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params=ignored)
    return unet


def shard_params(models, mesh: DeviceMesh):
    """Shards the frozen UNet of `models` (KDModels; it serves the student
    and the teacher forward) over the mesh's fsdp dimension with FSDP2
    (`fully_shard_unet`), in place, and returns `models`. The towers, the
    VAE and the adapter stay whole on every rank (the adapter is what
    trains). At fsdp 1 nothing is wrapped (the JAX rule replicates); above
    it the mesh's device type must be the weights' (gloo's CPU mesh cannot
    shard CUDA weights)."""
    n = _size(mesh, FSDP_AXIS)
    if n == 1:
        return models
    dev_type = next(models.unet.parameters()).device.type
    if mesh.device_type != dev_type:
        raise ValueError(f"fsdp {n} over a {mesh.device_type} mesh but the weights are "
                         f"on {dev_type}")
    fully_shard_unet(models.unet, mesh)
    return models
