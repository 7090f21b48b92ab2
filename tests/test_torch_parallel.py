"""The port's tensor parallelism (parallel/tp.py, the TP-aware layers,
cli/generate.py and cli/serve.py --tp) held against the JAX package on the
CPU: ranks are spawned gloo processes on one torch thread each
(tests/_torch_dist.py), the tiny SDXL UNet's weights come from JAX through
checkpoints/from_jax.py.

- The TP = 2 UNet forward against ``jax.jit(unet.apply)`` on one device at
  rtol/atol 2e-4 (tests/test_tp_inference.py's tolerance), and the int8
  one against JAX's int8 UNet by test_torch_quant_int8.py's measure (within
  twice what a rounding-sized nudge of the inputs does).
- The placement against JAX's ``tp._spec_for`` on every leaf of the float
  and the int8 tiny UNet, names and layouts mapped, equal except the
  departures parallel/tp.py documents; ``fsdp_sharding`` against JAX's
  ``mesh.fsdp_sharding`` at fsdp 2.
- The collectives per forward against the layout's formula; none without a
  group.
- ``generate --tp 2`` writes ``--tp 1``'s image, the serve engine at --tp 2
  answers with the one-process engine's images.
"""
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from PIL import Image

from _torch_dist import run_ranks
from _torch_parity import host_params, one_torch_thread  # noqa: F401
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from pea_diffusion_tpu.parallel import mesh as jax_mesh
from pea_diffusion_tpu.parallel import tp as jax_tp
from pea_diffusion_tpu.quant import int8 as jq
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.configs import SDXL_UNET_TINY
from pea_diffusion_tpu_torch.models import UNet2DCondition
from pea_diffusion_tpu_torch.parallel import mesh as pmesh
from pea_diffusion_tpu_torch.parallel import tp

TP = 2
INT8 = "int8:resnet,sampler,shortcut,stem"
INT8_SCOPES = frozenset({"resnet", "shortcut", "sampler", "stem"})
POOLED = (JAX_UNET_TINY.projection_class_embeddings_input_dim
          - 6 * JAX_UNET_TINY.addition_time_embed_dim)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    b = 2
    return {"sample": rng.standard_normal((b, 16, 16, 4)).astype(np.float32),
            "t": np.array([500, 10]),
            "context": rng.standard_normal((b, 12, 64)).astype(np.float32),
            "added": {"text_embeds": 0.5 * rng.standard_normal((b, POOLED)).astype(np.float32),
                      "time_ids": np.tile(np.array([[128, 128, 0, 0, 128, 128]], np.float32),
                                          (b, 1))}}


def _nudged(x, seed=1):
    """The float inputs times 1 + 1e-6 N(0, 1): a rounding-sized change."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        return (a * (1 + 1e-6 * rng.standard_normal(a.shape))).astype(np.float32)

    return dict(x, sample=nudge(x["sample"]), context=nudge(x["context"]),
                added=dict(x["added"], text_embeds=nudge(x["added"]["text_embeds"])))


def _jax_args(x):
    return (jnp.asarray(x["sample"]), jnp.asarray(x["t"], jnp.int32), jnp.asarray(x["context"]),
            {k: jnp.asarray(v) for k, v in x["added"].items()})


def _port_args(x):
    return (torch.as_tensor(x["sample"]), torch.as_tensor(x["t"]), torch.as_tensor(x["context"]),
            {k: torch.as_tensor(v) for k, v in x["added"].items()})


@pytest.fixture(scope="module")
def unets():
    """The tiny SDXL UNet's float and int8 (resnet, shortcut, sampler and
    stem convs) trees in JAX, their state dicts for the port, and JAX's
    single-device outputs on the inputs."""
    junet = JaxUNet(JAX_UNET_TINY)
    x = _inputs()
    params = host_params(junet, *_jax_args(x), seed=3)
    ranges = jq.calibrate_conv_ranges(junet, params, [_jax_args(x)], INT8_SCOPES)
    qtree = jq.quantize_unet_params(params, ranges, scopes=INT8_SCOPES)
    jq_unet = JaxUNet(JAX_UNET_TINY, conv_quant=INT8)
    return {
        "params": params, "qtree": qtree, "x": x,
        "sd": from_jax.unet_state_dict(params, SDXL_UNET_TINY),
        "qsd": from_jax.unet_state_dict(qtree, SDXL_UNET_TINY),
        "want": np.asarray(jax.jit(junet.apply)(params, *_jax_args(x))),
        "qwant": np.asarray(jax.jit(jq_unet.apply)(qtree, *_jax_args(x))),
    }


@pytest.fixture(scope="module")
def tp_runs(unets):
    """The float and the int8 UNet at TP = 2 on two spawned ranks (one
    spawn carries both, and the int8 one also on nudged inputs)."""
    sd = {k: v.numpy() for k, v in unets["sd"].items()}
    qsd = {k: v.numpy() for k, v in unets["qsd"].items()}
    x = unets["x"]
    return run_ranks("tp_unet_forward", TP, [(SDXL_UNET_TINY, sd, "none", x, None),
                                             (SDXL_UNET_TINY, qsd, INT8, x, _nudged(x))])


def _layout_formula(cfg, tp_size):
    """all_reduces per forward of the layout, counted from the config as
    tests/test_tp_inference.py counts JAX's: one per resnet and three per
    transformer block (two attention modules and a feed-forward) where tp
    divides every width, as it does the tiny UNet's at 2."""
    assert all(h % tp_size == 0 for h in cfg.num_attention_heads)
    assert cfg.norm_num_groups % tp_size == 0
    resnets = cfg.num_blocks * cfg.layers_per_block + 2 + cfg.num_blocks * (
        cfg.layers_per_block + 1)
    blocks = cfg.mid_transformer_layers
    for i in range(cfg.num_blocks):
        blocks += sum(cfg.down_block_layers(i)) + sum(cfg.up_block_layers(i))
    return resnets + 3 * blocks


def test_tp_unet_forward_matches_jax_single_device(unets, tp_runs):
    """Both ranks' TP = 2 outputs equal JAX's one-device forward within
    2e-4, and the sharded leaves really are cut in half."""
    for out, _, shapes, _ in (r[0] for r in tp_runs):
        np.testing.assert_allclose(out, unets["want"], rtol=2e-4, atol=2e-4)
        full = {k: tuple(v.shape) for k, v in unets["sd"].items()}
        cut = [k for k in full if shapes[k] != full[k]]
        assert len(cut) >= len(full) // 4, (len(cut), len(full))
        for k in cut:
            assert int(np.prod(shapes[k])) * TP == int(np.prod(full[k])), k


def test_tp_int8_unet_matches_jax_int8(unets, tp_runs):
    """The int8 UNet at TP = 2 against JAX's int8 UNet: within twice what a
    1e-6 relative nudge of the inputs moves the TP forward itself (the int8
    codes flip at rounding edges, test_torch_quant_int8.py's measure), and
    near the float forward."""
    for out, n, _, nudged in (r[1] for r in tp_runs):
        chaos = _rel(nudged, out)
        assert _rel(out, unets["qwant"]) <= 2 * chaos
        assert 1e-6 < _rel(out, unets["want"]) < 0.08
        assert n == _layout_formula(SDXL_UNET_TINY, TP)


def test_tp_collective_budget(unets, tp_runs):
    """One all_reduce per resnet, attention module and feed-forward: the
    count of a TP = 2 forward equals the formula counted from the config
    and tp.collectives_per_forward's; an unsharded UNet issues none."""
    want = _layout_formula(SDXL_UNET_TINY, TP)
    assert tp.collectives_per_forward(SDXL_UNET_TINY, TP) == want
    assert tp.collectives_per_forward(SDXL_UNET_TINY, 1) == 0
    assert [r[0][1] for r in tp_runs] == [want] * TP
    unet = UNet2DCondition(SDXL_UNET_TINY)
    unet.load_state_dict(unets["sd"])
    tp.reset_collectives()
    with torch.no_grad():
        plain = unet(*_port_args(unets["x"])).numpy()
    assert tp.COLLECTIVES["all_reduce"] == 0
    np.testing.assert_allclose(plain, unets["want"], rtol=2e-4, atol=2e-4)


# --- placement against JAX ------------------------------------------------------


def _mark(shape, axis):
    """A leaf whose values vary along `axis` only (constant for None)."""
    if axis is None:
        return np.full(shape, 7, np.float32)
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return np.broadcast_to((np.arange(shape[axis]) % 100).reshape(view), shape).astype(np.float32)


def _varying_dim(t):
    dims = [d for d in range(t.ndim) if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


def _jax_dims_in_torch(tree, spec_fn, axis_name, cfg):
    """{port leaf name: the torch dim JAX shards, or None}: each JAX leaf
    marked along its sharded axis, carried by from_jax."""
    def mark(path, leaf):
        spec = tuple(spec_fn(path, leaf))
        axis = next((i for i, s in enumerate(spec) if s == axis_name), None)
        arr = _mark(np.shape(leaf), axis)
        return arr.astype(np.int8) if np.asarray(leaf).dtype == np.int8 else arr

    marked = jax.tree_util.tree_map_with_path(mark, tree)
    return {k: _varying_dim(v) for k, v in from_jax.unet_state_dict(marked, cfg).items()}


def _port_dims(plan):
    return {k: getattr(v, "dim", None) for k, v in plan.items()}


# The layout's departures from JAX's placement (parallel/tp.py's docstring):
# input-sharded conv2 / shortcut (JAX: output channels), and replicated
# leaves that JAX shards by channel.
DEPARTURES = {
    r"resnets\.\d+\.(conv2|conv_shortcut)\.(weight|kernel_q)$": 1,
    r"resnets\.\d+\.(conv2|conv_shortcut)\.(bias|w_scale)$": None,
    r"resnets\.\d+\.norm1\.(weight|bias)$": None,
    r"attentions\.\d+\.(norm|proj_in|proj_out)\.(weight|bias)$": None,
    r"(downsamplers|upsamplers)\.0\.conv\.": None,
    r"^conv_in\.": None,
    r"^(time_embedding|add_embedding)\.linear_\d\.bias$": None,
}


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_tp_placement_matches_jax_spec_for(unets, quant):
    """tp_unet_sharding against JAX's tp._spec_for on every leaf of the tiny
    UNet (float, and the int8 layout of every conv scope): the same torch
    dim where the port follows JAX, the documented placement at each
    departure; and tp._spec_for's own rules on single leaves."""
    tree = unets["params"] if quant == "float" else unets["qtree"]
    want = _jax_dims_in_torch(
        tree, lambda path, leaf: jax_tp._spec_for(jax_tp._path_names(path), np.shape(leaf), TP),
        "model", SDXL_UNET_TINY)
    unet = UNet2DCondition(SDXL_UNET_TINY, conv_quant="none" if quant == "float" else INT8)
    got = _port_dims(tp.tp_unet_sharding(unet, TP))
    assert sorted(got) == sorted(want)
    departed = 0
    for name, dim in got.items():
        rule = next((d for pat, d in DEPARTURES.items() if re.search(pat, name)), "follows")
        if rule == "follows":
            assert dim == want[name], (name, dim, want[name])
        else:
            assert dim == rule, (name, dim, rule)
            departed += dim != want[name]
    assert departed > 0
    assert sum(d is not None for d in got.values()) >= len(got) // 4
    if quant == "int8":  # JAX tests/test_tp_inference.py's int8 placement
        assert got["down_blocks.0.resnets.0.conv1.kernel_q"] == 0
        assert got["down_blocks.0.resnets.0.conv1.w_scale"] == 0
        assert got["down_blocks.0.resnets.0.conv1.x_scale"] is None
        assert got["down_blocks.0.resnets.0.conv2.x_scale"] is None
    names = ("down_blocks", "1", "attentions", "0", "transformer_blocks", "0")
    assert tp._spec_for(names + ("ff", "net", "0", "proj", "weight"), (512, 64), TP).dim == 0
    assert not hasattr(tp._spec_for(names + ("attn1", "to_out", "0", "bias"), (64,), TP), "dim")
    assert not hasattr(tp._spec_for(names + ("attn1", "to_q", "weight"), (63, 64), TP), "dim")
    assert not hasattr(tp._spec_for(names + ("attn1", "to_q", "weight"), (64, 64), TP,
                                    divides=False), "dim")


def test_geglu_shard_takes_rows_of_both_halves():
    """Rank r's GEGLU projection is [h_r | gate_r], not a plain dim-0 chunk."""
    w = torch.arange(8.0)[:, None].expand(8, 3)
    assert tp._take(w, 0, 1, 2, halves=True)[:, 0].tolist() == [2, 3, 6, 7]
    assert tp._take(w, 0, 1, 2, halves=False)[:, 0].tolist() == [4, 5, 6, 7]


def test_fsdp_rule_matches_jax_fsdp_sharding(unets):
    """fsdp_sharding at fsdp 2 against JAX's mesh.fsdp_sharding on every
    leaf of the tiny UNet (min_size 1024, so that most leaves qualify):
    the largest flax axis mapped to the torch layout, ties to cin as JAX's
    stable sort; and at fsdp 1 everything replicated, as in JAX."""
    jm = jax_mesh.make_mesh((1, 2), devices=jax.devices()[:2])
    sh = jax_mesh.fsdp_sharding(unets["params"], jm, min_size=1024)
    specs = {jax.tree_util.keystr(p): s.spec for p, s in
             jax.tree_util.tree_leaves_with_path(sh)}
    want = _jax_dims_in_torch(unets["params"],
                              lambda path, leaf: specs[jax.tree_util.keystr(path)],
                              "fsdp", SDXL_UNET_TINY)
    unet = UNet2DCondition(SDXL_UNET_TINY)
    mesh2 = SimpleNamespace(mesh_dim_names=("data", "fsdp"), size=lambda i: (1, 2)[i])
    got = _port_dims(pmesh.fsdp_sharding(unet, mesh2, min_size=1024))
    assert {k: (got[k], want[k]) for k in got if got[k] != want[k]} == {}
    # the tie: conv2 of a resnet with cin = cout shards cin (torch dim 1)
    assert got["down_blocks.0.resnets.0.conv2.weight"] == 1
    assert sum(d is not None for d in got.values()) > 20
    mesh1 = SimpleNamespace(mesh_dim_names=("data", "fsdp"), size=lambda i: (2, 1)[i])
    assert all(getattr(v, "dim", None) is None
               for v in pmesh.fsdp_sharding(unet, mesh1, min_size=1024).values())
    assert jax_mesh.fsdp_sharding({"w": jnp.zeros((64, 64))}, jax_mesh.make_mesh(
        (2, 1), devices=jax.devices()[:2]), min_size=1)["w"].spec == P()


# --- the CLIs --------------------------------------------------------------------


def test_generate_tp2_writes_the_tp1_image(tmp_path):
    """cli/generate.py --demo --tp 2 on two ranks: rank 0 alone writes the
    image, within one uint8 level of --tp 1's."""
    from pea_diffusion_tpu_torch.cli import generate

    argv = ["--demo", "--device", "cpu", "--sampler", "ddim", "--steps", "2", "--size", "64"]
    generate.main(argv + ["-o", str(tmp_path / "tp1.png")])
    run_ranks("generate_cli", TP, argv + ["--tp", "2", "-o", str(tmp_path / "tp2.png")],
              init=False)
    a = np.asarray(Image.open(tmp_path / "tp1.png"), np.int16)
    b = np.asarray(Image.open(tmp_path / "tp2.png"), np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tp1.png", "tp2.png"]


def test_serve_engine_tp2_answers_with_the_one_process_images():
    """cli/serve.py --demo --tp 2: rank 0's engine answers three requests
    (mixed seeds, guidance and steps) with the one-process engine's
    images, within one uint8 level; the follower replays the three calls."""
    from pea_diffusion_tpu_torch.cli import serve
    from pea_diffusion_tpu_torch.cli.generate import build_demo
    from pea_diffusion_tpu_torch.pipelines.text2image import StableDiffusionXLPEAPipeline

    requests = [("一只猫", "", 2, 7.5, 0.0, 3), ("一条狗", "模糊", 2, 3.0, 0.5, 4),
                ("山水", "", 3, 7.5, 0.0, 5)]
    models, tokenize, size = build_demo("cpu")  # the size serve --demo serves
    engine = serve.BatchingEngine(StableDiffusionXLPEAPipeline(models, "ddim"), tokenize, size,
                                  max_batch=1)
    want = [np.asarray(engine.submit(*r), np.int16) for r in requests]
    engine.close()
    images, replayed = run_ranks(
        "serve_tp", TP, ["--demo", "--device", "cpu", "--sampler", "ddim", "--max-batch", "1", "--port", "0", "--tp", "2"], requests,
        init=False)
    assert replayed == len(requests)
    for got, w in zip(images, want):
        assert got.shape == w.shape and np.abs(got.astype(np.int16) - w).max() <= 1


@pytest.mark.parametrize("failing", [1, 0], ids=["follower", "leader"])
def test_serve_tp2_rank_failing_mid_forward_ends_every_rank(failing):
    """cli/serve.py --demo --tp 2 with one rank raising inside the first
    call's UNet forward: rank 0's submit fails within seconds (not the
    collective's 600 s timeout), the second request is refused, rank 0's
    main exits non-zero and the follower's main raises too."""
    requests = [("一只猫", "", 2, 7.5, 0.0, 3), ("一条狗", "", 2, 7.5, 0.0, 4)]
    leader, follower = run_ranks(
        "serve_tp_rank_fails", TP, ["--demo", "--device", "cpu", "--sampler", "ddim",
                                    "--max-batch", "1", "--port", "0", "--tp", "2"],
        requests, failing, init=False, timeout=90)
    (err1, s1), (err2, _) = leader["submits"]
    # the leader raises itself; the follower's exit closes its gloo connections
    assert ("injected failure on rank 0" if failing == 0 else "Connection closed") in err1
    assert s1 < 30
    assert err2.startswith("tensor-parallel serving stopped")
    assert leader["ended"].startswith("SystemExit: tensor-parallel serving stopped")
    assert follower["ended"] != "returned"
    if failing == 1:
        assert "injected failure on rank 1" in follower["ended"]
