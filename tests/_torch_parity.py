"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: seeded numpy parameters for a Flax module, and a state dict for a
port sub-module built from the JAX sub-tree under a name prefix."""
import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run its tiny torch models on one
    intra-op thread, restored after the module: under pytest-xdist several
    workers' thread pools share the cores, and small ops that wait on a
    pool's barrier then run hundreds of times slower (six processes at
    eight threads each: 400x on a tiny UNet loop)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host_params(module, *args, seed=0, **kwargs):
    """Flax params for `module` made with numpy from a seed (no device
    init): weights N(0, 1/fan_in), norm scales 1 + 0.1 N(0, 1), biases and
    embeddings N(0, 0.1) / N(0, 0.5), so every affine is exercised."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        shape = s.shape
        if name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            x = 0.1 * rng.standard_normal(shape)
        elif name == "embedding":
            x = 0.5 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def perturb(tree, seed=0):
    """Norm scales 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1) over a numpy copy
    of a JAX tree (init_params_host leaves them at 1 and 0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        x = np.asarray(x, np.float32)
        if name == "scale":
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def sub_state_dict(write, node, *args, prefix="m"):
    """Run a from_jax._Writer method on one sub-tree and strip its prefix,
    giving the state dict of the port's sub-module."""
    from pea_diffusion_tpu_torch.checkpoints.from_jax import _Writer

    w = _Writer()
    getattr(w, write)(prefix, node, *args)
    return {k[len(prefix) + 1:]: v for k, v in w.sd.items()}


def to_numpy_sd(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def assert_tree_equal(a, b):
    fa = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(a)}
    fb = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(b)}
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(fb[k]), err_msg=k)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def tiny_sdxl_pair(jax_unet_cfg, port_unet_cfg, time_ids=6, seed=0):
    """A tiny SDXL-architecture PEA stack in both frameworks at the same
    weights: BERT_TINY, an adapter onto the UNet's pooled and cross-attention
    widths, the UNet of the given (equal) configs with `time_ids` added time
    ids, VAE_TINY; fp32, every module's weights `host_params`' (each module
    traced once). Returns (JAX models, JAX params, port models)."""
    import jax.numpy as jnp

    from pea_diffusion_tpu.configs.adapter import AdapterConfig as JaxAdapterConfig
    from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
    from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
    from pea_diffusion_tpu.pipelines import factory as jax_factory
    from pea_diffusion_tpu_torch.checkpoints import from_jax
    from pea_diffusion_tpu_torch.configs import BERT_TINY, VAE_TINY, AdapterConfig
    from pea_diffusion_tpu_torch.pipelines import build_models

    ucfg = jax_unet_cfg
    pooled = ucfg.projection_class_embeddings_input_dim - time_ids * ucfg.addition_time_embed_dim
    dims = (JAX_BERT_TINY.hidden_size, (96, pooled))
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(*dims, head_dim=ucfg.cross_attention_dim),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, dtype=jnp.float32)
    text, _ = jax_factory.make_text_encoder_fn("chinese_clip", JAX_BERT_TINY)
    z = np.zeros
    params = {
        "text": host_params(text, z((1, 16), np.int32), seed=seed),
        "adapter": host_params(jmodels.adapter, z((1, 16, dims[0]), np.float32), seed=seed + 1),
        "unet": host_params(
            jmodels.unet, z((1, 8, 8, ucfg.in_channels), np.float32), np.array([500], np.int32),
            z((1, 4, ucfg.cross_attention_dim), np.float32),
            {"text_embeds": z((1, pooled), np.float32),
             "time_ids": z((1, time_ids), np.float32)}, seed=seed + 2),
        "vae": host_params(jmodels.vae, z((1, 16, 16, 3), np.float32), jax.random.PRNGKey(0),
                           seed=seed + 3),
    }
    pmodels = build_models(family="chinese_clip", text_cfg=BERT_TINY,
                           adapter_cfg=AdapterConfig(*dims, head_dim=ucfg.cross_attention_dim),
                           unet_cfg=port_unet_cfg, vae_cfg=VAE_TINY, dtype=torch.float32,
                           device="cpu")
    pmodels.text_encoder.load_state_dict(from_jax.bert_text_state_dict(params["text"]))
    pmodels.adapter.load_state_dict(from_jax.adapter_state_dict(params["adapter"]))
    pmodels.unet.load_state_dict(from_jax.unet_state_dict(params["unet"], port_unet_cfg))
    pmodels.vae.load_state_dict(from_jax.vae_state_dict(params["vae"], VAE_TINY))
    return jmodels, params, pmodels
