"""Tensor-parallel (Megatron) serving of the UNet (port of
``pea_diffusion_tpu/parallel/tp.py``).

``shard_bundle_for_tp`` cuts this rank's shard out of each sharded UNet
weight, in place, and attaches the mesh's "model" process group to the
modules that hold one; the text tower, the adapter and the VAE stay whole
on every rank. Every rank runs the same request; the modules meet in one
``all_reduce`` each.

Layout (Megatron pairs that need only ``all_reduce``):

- attention: ``to_q``, ``to_k`` and ``to_v`` column-sharded by heads (a
  rank holds ``heads / tp`` whole heads, so the per-head math, and the B1 /
  B3 kernel, runs locally on contiguous q/k/v), ``to_out`` row-sharded, one
  ``all_reduce`` of its partial product, the bias added once after it;
- the GEGLU feed-forward: rank r takes rows ``r * inner / tp ...`` of both
  the h and the gate half of the fused ``net.0.proj`` (a plain dim-0 chunk
  would give one rank all of h and the other all of gate), ``net.2``
  row-sharded, one ``all_reduce``, its bias after;
- a resnet: ``conv1``, its bias and ``time_emb_proj`` sharded by output
  channel, ``norm2`` on the rank's own groups (tp divides the group count),
  then ``conv2`` sharded by input channel. The rank's input-channel slice of
  ``conv_shortcut``, where there is one, adds into the same partial sum, so
  one ``all_reduce`` covers both, and both biases are added after it. The
  int8 ``QConvInt8`` shards the same way: its codes and ``w_scale`` follow
  the conv's sharded axis (``w_scale`` is per output channel, so it stays
  whole on an input-sharded conv), ``x_scale`` is replicated, and partials
  are dequantized before the ``all_reduce``;
- ``norm1``, the transformer's ``norm``, ``proj_in`` / ``proj_out``,
  ``conv_in``, ``conv_out``, ``conv_norm_out``, Down/Upsample and the time
  and added embeddings replicated.

Partial sums meet in fp32 and are cast back to the activations' type after
the bias; on a card the row-sharded linears' bf16 partials leave the tensor
cores in fp32, so only the sum is rounded, as the unsharded product is (with
bf16 partials a TP = 2 SDXL forward at 1024² sat further from an fp32
forward than the unsharded bf16 one did, on two of three inputs).

Departures from the JAX placement, which shards by output channel and lets
GSPMD insert all-gathers (about 2.6 a conv): ``conv2`` and ``conv_shortcut``
are input-sharded (JAX: output channel), their biases replicated (JAX:
sharded); ``norm1`` and the transformer's ``norm``, ``proj_in`` /
``proj_out``, ``conv_in``, Down/Upsample and the time / added embeddings'
biases are replicated (JAX: sharded). An attention module whose head count
tp does not divide (SDXL's 10 heads at tp 4) keeps its weights whole on
every rank and runs unsharded, with no collective: a placement choice, not a
fallback of the device (JAX shards such a module by lanes and GSPMD splits
heads). The outputs are the same function.
"""
from __future__ import annotations

import collections
from typing import TYPE_CHECKING, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import _resolve, _size, mesh_device_type

if TYPE_CHECKING:  # imported where used (see mesh.py)
    from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"

# collectives the tensor-parallel layers issued, by kind ("all_reduce")
COLLECTIVES: "collections.Counter[str]" = collections.Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def reduce_partial(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of the ranks' partial results `x`, in fp32."""
    y = x.float().contiguous()
    dist.all_reduce(y, group=group)
    COLLECTIVES["all_reduce"] += 1
    return y


def make_tp_mesh(shape: Tuple[int, int] = (1, -1)) -> DeviceMesh:
    """shape = (data, model) over every rank; -1 = all remaining ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    data, model = _resolve(shape, dist.get_world_size())
    return init_device_mesh(mesh_device_type(), (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _spec_for(names: Tuple[str, ...], shape: Tuple[int, ...], tp: int,
              divides: bool = True):
    """Placement of one UNet leaf (names: its dotted diffusers name, split),
    in the torch layout: ``Shard(dim)`` or ``Replicate()``. `divides` says
    whether the leaf's unit (its attention module, feed-forward or resnet)
    can be sharded at `tp` (heads, inner width, groups and channels)."""
    from torch.distributed.tensor import Replicate, Shard

    def ok(dim: int) -> bool:
        return divides and len(shape) > dim and shape[dim] % tp == 0 and shape[dim] >= tp

    module = names[-2] if len(names) >= 2 else ""
    leaf = names[-1]
    if module in ("to_q", "to_k", "to_v") and ok(0):
        return Shard(0)
    if len(names) >= 3 and names[-3] == "to_out":
        return Shard(1) if leaf == "weight" and ok(1) else Replicate()
    if names[-4:-1] == ("net", "0", "proj") and "ff" in names and ok(0):
        return Shard(0)  # each of the [h | gate] halves, see _take
    if names[-3:-1] == ("net", "2") and "ff" in names:
        return Shard(1) if leaf == "weight" and ok(1) else Replicate()
    if "resnets" in names:
        if module in ("conv1", "time_emb_proj", "norm2") and leaf != "x_scale" and ok(0):
            return Shard(0)
        if module in ("conv2", "conv_shortcut") and leaf in ("weight", "kernel_q") and ok(1):
            return Shard(1)
    return Replicate()


def _conv_weight(conv: nn.Module) -> torch.Tensor:
    return conv.weight if isinstance(conv, nn.Conv2d) else conv.kernel_q


def _divides(unit: nn.Module, tp: int) -> bool:
    from ..models.layers import FeedForward, MultiHeadAttention, ResnetBlock2D

    if isinstance(unit, MultiHeadAttention):
        return unit.num_heads % tp == 0
    if isinstance(unit, FeedForward):
        return unit.net[2].weight.shape[1] % tp == 0
    if isinstance(unit, ResnetBlock2D):
        cout, cin = _conv_weight(unit.conv1).shape[:2]
        return (unit.norm2.num_groups % tp == 0 and cout % tp == 0
                and (unit.conv_shortcut is None or cin % tp == 0))
    return False


def _units(unet: nn.Module) -> Dict[str, nn.Module]:
    from ..models.layers import FeedForward, MultiHeadAttention, ResnetBlock2D

    return {n: m for n, m in unet.named_modules()
            if isinstance(m, (MultiHeadAttention, FeedForward, ResnetBlock2D))}


def _leaves(root: nn.Module):
    yield from root.named_parameters()
    yield from root.named_buffers()


def tp_unet_sharding(unet: nn.Module, tp) -> Dict[str, object]:
    """{leaf name: placement} of every parameter and buffer of a UNet at
    tensor-parallel degree `tp` (an int or a mesh with a "model" dim)."""
    from torch.distributed.tensor import Replicate

    tp = tp if isinstance(tp, int) else _size(tp, MODEL_AXIS)
    units = _units(unet)
    out = {}
    for name, t in _leaves(unet):
        parts = tuple(name.split("."))
        unit = next((units[".".join(parts[:i])] for i in range(len(parts) - 1, 0, -1)
                     if ".".join(parts[:i]) in units), None)
        divides = unit is not None and _divides(unit, tp)
        out[name] = Replicate() if tp == 1 else _spec_for(parts, tuple(t.shape), tp, divides)
    return out


def _take(t: torch.Tensor, dim: int, r: int, tp: int, halves: bool) -> torch.Tensor:
    """Rank r's shard of `t` on `dim` (with `halves`, rank r's shard of each
    half of dim 0, concatenated: the GEGLU projection's [h | gate])."""
    if halves:
        return torch.cat([_take(h, dim, r, tp, False) for h in t.chunk(2, dim=0)])
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n).clone().contiguous()


def shard_bundle_for_tp(models, mesh: DeviceMesh):
    """Places a PEAModels bundle for tensor-parallel serving over `mesh`'s
    "model" dim, in place: the UNet's sharded leaves cut to this rank's
    shard and the group attached (see the module's docstring); the text
    tower, the adapter and the VAE whole. Returns `models`."""
    from torch.distributed.tensor import Shard

    from ..models.layers import MultiHeadAttention, ResnetBlock2D

    tp = _size(mesh, MODEL_AXIS)
    unet = models.unet
    if tp == 1:
        return models
    r = mesh.get_local_rank(MODEL_AXIS)
    group = mesh.get_group(MODEL_AXIS)
    plan = tp_unet_sharding(unet, tp)
    sharded = [m for m in _units(unet).values() if _divides(m, tp)]  # before the cuts
    with torch.no_grad():
        for name, pl in plan.items():
            if not isinstance(pl, Shard):
                continue
            owner_name, leaf = name.rsplit(".", 1)
            owner = unet.get_submodule(owner_name)
            halves = owner_name.endswith("ff.net.0.proj")
            if leaf in owner._parameters:
                owner._parameters[leaf].data = _take(owner._parameters[leaf], pl.dim, r, tp,
                                                     halves)
            else:
                owner._buffers[leaf] = _take(owner._buffers[leaf], pl.dim, r, tp, halves)
    for m in sharded:
        m.tp_group = group
        if isinstance(m, MultiHeadAttention):
            m.num_heads //= tp
        elif isinstance(m, ResnetBlock2D):
            m.norm2.num_groups //= tp
            if m.conv_shortcut is not None:
                n = _conv_weight(m.conv_shortcut).shape[1]
                m.tp_in = (r * n, (r + 1) * n)
    unet.tp_group, unet.tp_size = group, tp
    return models


def collectives_per_forward(cfg, tp: int) -> int:
    """The layout's ``all_reduce`` count per UNet forward (UNetConfig
    `cfg`): one per resnet and, in each transformer block, one per
    attention module whose heads tp divides and one per feed-forward."""
    if tp == 1:
        return 0
    ch = cfg.block_out_channels
    groups_ok = cfg.norm_num_groups % tp == 0

    def resnet(cin, cout):
        return int(groups_ok and cout % tp == 0 and (cin == cout or cin % tp == 0))

    def blocks(level, depth):
        heads = cfg.num_attention_heads[level]
        return depth * (2 * int(heads % tp == 0) + int(4 * ch[level] % tp == 0))

    n, prev, skips = 0, ch[0], [ch[0]]
    for i, c in enumerate(ch):
        for d in cfg.down_block_layers(i):
            n += resnet(prev, c) + blocks(i, d)
            prev = c
            skips.append(c)
        if i < cfg.num_blocks - 1:
            skips.append(c)
    n += 2 * resnet(ch[-1], ch[-1]) + blocks(cfg.num_blocks - 1, cfg.mid_transformer_layers)
    for i, c in enumerate(reversed(ch)):
        for d in cfg.up_block_layers(i):
            n += resnet(prev + skips.pop(), c) + blocks(cfg.num_blocks - 1 - i, d)
            prev = c
    return n


def replicated(mesh: DeviceMesh):
    from torch.distributed.tensor import Replicate

    del mesh
    return Replicate()


def batch_sharding(mesh: DeviceMesh):
    """The leading (batch) dim over "data", replicated over "model"."""
    from torch.distributed.tensor import Shard

    del mesh
    return Shard(0)
