"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: seeded numpy parameters for a Flax module, and a state dict for a
port sub-module built from the JAX sub-tree under a name prefix."""
import jax
import numpy as np
import torch


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
