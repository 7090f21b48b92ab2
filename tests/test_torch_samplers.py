"""The port's few-step samplers held against the JAX package's: each Euler,
Euler-ancestral, LCM and DDPM step at float32 and bfloat16 samples (with the
JAX step's own draw, `jax.random.normal` of its key in the type it draws
in, passed to the port's step), whole trajectories against the
diffusers-semantics simulators of tests/test_scheduler_goldens.py,
`get_velocity` and `predict_eps`, and the tiny SDXL slice under euler_a and
lcm at guidance 0 (the conditional half only) with the initial and per-step
draws passed in; the SD1.5 slice, whose denoise loop gets no random source
in either package.

Tolerances: 1e-5 on float32 steps (the same float32 arithmetic); one
bfloat16 rounding step (8e-3 of the values' scale) on bfloat16 ones; 2e-4
on the trajectories, as tests/test_scheduler_goldens.py; 2e-3 on the final
images, as tests/test_torch_pipeline.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import perturb, t
from test_scheduler_goldens import (_euler_a_diffusers_trajectory,
                                    _euler_diffusers_trajectory, _lcm_diffusers_trajectory)
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JaxAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.configs.unet import SD15_UNET_TINY as JAX_SD15_UNET_TINY
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu.pipelines import text2image as jax_t2i
from pea_diffusion_tpu.schedulers import NoiseScheduleConfig as JaxSchedule
from pea_diffusion_tpu.schedulers import common as jax_common
from pea_diffusion_tpu.schedulers import ddpm as jax_ddpm
from pea_diffusion_tpu.schedulers import euler as jax_euler
from pea_diffusion_tpu.schedulers import lcm as jax_lcm
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli.generate import build_demo
from pea_diffusion_tpu_torch.pipelines import generate_sd, generate_sdxl
from pea_diffusion_tpu_torch.schedulers import NoiseScheduleConfig, common, ddpm, euler, lcm

SHAPE = (2, 4, 4, 4)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _to_torch(a):
    """A JAX array (bfloat16 included) -> a torch tensor of the same type
    and values."""
    a = np.asarray(a)
    bf16 = a.dtype == jnp.bfloat16
    out = torch.from_numpy(np.array(a, np.float32))
    return out.bfloat16() if bf16 else out


def _check(got, want, dtype_name):
    """Same result type as JAX's step, same values (module docstring)."""
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    tol = 1e-5 if want.dtype == np.float32 and dtype_name == "float32" else 8e-3
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol * scale, rtol=0)


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("name", ["euler", "euler_a", "lcm", "ddpm"])
def test_step_matches_jax(name, dtype_name, prediction):
    jdt, tdt = DTYPES[dtype_name]
    spacing = "trailing" if name == "euler_a" else "leading"
    jcfg = JaxSchedule(prediction_type=prediction, timestep_spacing=spacing)
    pcfg = NoiseScheduleConfig(prediction_type=prediction, timestep_spacing=spacing)
    x, out = jnp.asarray(_rand(*SHAPE), jdt), jnp.asarray(_rand(*SHAPE, seed=1), jdt)
    px, pout = _to_torch(x), _to_torch(out)
    key = jax.random.PRNGKey(7)
    if name in ("euler", "euler_a"):
        js, ps = jax_euler.make_schedule(jcfg, 4), euler.make_schedule(pcfg, 4)
        np.testing.assert_array_equal(np.asarray(js.sigmas), ps.sigmas)
        assert js.init_noise_sigma == ps.init_noise_sigma
        for i in range(4):
            _check(euler.scale_model_input(ps, i, px), jax_euler.scale_model_input(js, i, x),
                   dtype_name)
            if name == "euler":
                _check(euler.step(ps, i, px, pout), jax_euler.step(js, i, x, out), dtype_name)
                continue
            draw = jax.random.normal(key, x.shape, jnp.float32)
            _check(euler.step_ancestral(ps, i, px, pout, _to_torch(draw)),
                   jax_euler.step_ancestral(js, i, x, out, key), dtype_name)
            _check(euler.step_ancestral(ps, i, px, pout),
                   jax_euler.step_ancestral(js, i, x, out), dtype_name)
    elif name == "lcm":
        js, ps = jax_lcm.make_schedule(jcfg, 4), lcm.make_schedule(pcfg, 4)
        np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
        for i in range(4):  # the last step returns the denoised estimate
            draw = jax.random.normal(key, x.shape, x.dtype)
            _check(lcm.step(ps, i, px, pout, _to_torch(draw)),
                   jax_lcm.step(js, jnp.asarray(i), x, out, key), dtype_name)
            _check(lcm.step(ps, i, px, pout), jax_lcm.step(js, jnp.asarray(i), x, out),
                   dtype_name)
    else:
        js, ps = jax_ddpm.make_schedule(jcfg), ddpm.make_schedule(pcfg)
        for step_t in (999, 500, 1, 0):  # no noise at t = 0
            draw = jax.random.normal(key, x.shape, x.dtype)
            _check(ddpm.step(ps, step_t, px, pout, _to_torch(draw)),
                   jax_ddpm.step(js, jnp.asarray(step_t), x, out, key), dtype_name)
            _check(ddpm.step(ps, step_t, px, pout),
                   jax_ddpm.step(js, jnp.asarray(step_t), x, out), dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_get_velocity_and_predict_eps_match_jax(dtype_name):
    jdt, _ = DTYPES[dtype_name]
    cfg = JaxSchedule()
    sample = jnp.asarray(_rand(*SHAPE), jdt)
    noise = jnp.asarray(_rand(*SHAPE, seed=1), jdt)
    ts = np.array([999, 3])
    jsched, psched = jax_ddpm.make_schedule(cfg), ddpm.make_schedule(NoiseScheduleConfig())
    want = jax_ddpm.get_velocity(jsched, sample, noise, jnp.asarray(ts))
    got = ddpm.get_velocity(psched, _to_torch(sample), _to_torch(noise), torch.from_numpy(ts))
    _check(got, want, dtype_name)
    _check(common.get_velocity(psched.alphas_cumprod, _to_torch(sample), _to_torch(noise),
                               torch.from_numpy(ts)),
           jax_common.get_velocity(jsched.alphas_cumprod, sample, noise, jnp.asarray(ts)),
           dtype_name)
    a, s = float(np.float32(0.8)), float(np.float32(0.6))  # Python floats in both
    for prediction in ("epsilon", "v_prediction", "sample"):
        _check(common.predict_eps(prediction, _to_torch(sample), _to_torch(noise), a, s),
               jax_common.predict_eps(prediction, sample, noise, a, s), dtype_name)


# --- trajectories against tests/test_scheduler_goldens.py's simulators ----------

def _golden_inputs(seed, steps, noise=True):
    rng = np.random.default_rng(seed)
    shape = (1, 4, 8, 8)
    x = rng.standard_normal(shape)
    eps = [rng.standard_normal(shape) for _ in range(steps)]
    draws = [rng.standard_normal(shape) for _ in range(steps)] if noise else None
    return x, eps, draws


def test_euler_trajectory_matches_the_diffusers_simulator():
    x, eps, _ = _golden_inputs(2, 30, noise=False)
    scaled, golden = _euler_diffusers_trajectory(x, eps, 30)
    sched = euler.make_schedule(NoiseScheduleConfig(), 30)
    xr = torch.from_numpy(np.asarray(x, np.float32))
    for i in range(30):
        np.testing.assert_allclose(euler.scale_model_input(sched, i, xr).numpy(), scaled[i],
                                   rtol=2e-4, atol=2e-4)
        xr = euler.step(sched, i, xr, t(eps[i]))
        np.testing.assert_allclose(xr.numpy(), golden[i], rtol=2e-4, atol=2e-4,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("spacing,steps", [("trailing", 4), ("leading", 30)])
def test_euler_ancestral_trajectory_matches_the_diffusers_simulator(spacing, steps):
    x, eps, draws = _golden_inputs(4, steps)
    scaled, golden = _euler_a_diffusers_trajectory(x, eps, draws, steps, spacing)
    sched = euler.make_schedule(NoiseScheduleConfig(timestep_spacing=spacing), steps)
    xr = torch.from_numpy(np.asarray(x, np.float32))
    for i in range(steps):
        np.testing.assert_allclose(euler.scale_model_input(sched, i, xr).numpy(), scaled[i],
                                   rtol=2e-4, atol=2e-4)
        xr = euler.step_ancestral(sched, i, xr, t(eps[i]), t(draws[i]))
        np.testing.assert_allclose(xr.numpy(), golden[i], rtol=2e-4, atol=2e-4,
                                   err_msg=f"step {i}")


def test_lcm_trajectory_matches_the_diffusers_simulator():
    x, eps, draws = _golden_inputs(3, 5)
    golden = _lcm_diffusers_trajectory(x, eps, draws, 5)
    sched = lcm.make_schedule(NoiseScheduleConfig(), 5)
    xr = torch.from_numpy(np.asarray(x, np.float32))
    for i in range(5):
        xr = lcm.step(sched, i, xr, t(eps[i]), t(draws[i]))
        np.testing.assert_allclose(xr.numpy(), golden[i], rtol=2e-4, atol=2e-4,
                                   err_msg=f"step {i}")


# --- the slices ---------------------------------------------------------------------

def _load(pmodels, params):
    pmodels.text_encoder.load_state_dict(from_jax.bert_text_state_dict(params["text"]))
    pmodels.adapter.load_state_dict(from_jax.adapter_state_dict(params["adapter"]))
    pmodels.unet.load_state_dict(from_jax.unet_state_dict(params["unet"], pmodels.unet.config))
    pmodels.vae.load_state_dict(from_jax.vae_state_dict(params["vae"], pmodels.vae.config))
    return pmodels


@pytest.fixture(scope="module")
def sdxl_stacks():
    """The tiny SDXL stack in both packages at the same weights, with the
    trailing schedule of SDXL-Turbo."""
    ucfg = JAX_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(JAX_BERT_TINY.hidden_size, (96, pooled),
                                     head_dim=ucfg.cross_attention_dim),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, dtype=jnp.float32,
        schedule=JaxSchedule(timestep_spacing="trailing"))
    params = perturb(jax_factory.init_params_host(jmodels, "chinese_clip", JAX_BERT_TINY),
                     seed=3)
    pmodels, tokenize, _ = build_demo(device="cpu")
    pmodels.schedule = NoiseScheduleConfig(timestep_spacing="trailing")
    return jmodels, params, _load(pmodels, params), tokenize


def _jax_step_draws(key, steps, shape):
    """The draws JAX's generate_sdxl makes for a stochastic sampler's steps:
    the normal of fold_in(fold_in(key, 1), i), in float32 (the latents'
    type, also LCM's)."""
    loop = jax.random.fold_in(key, 1)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(loop, i), shape,
                                                  jnp.float32)) for i in range(steps)])


@pytest.mark.parametrize("sampler_name", ["euler_a", "lcm"])
def test_generate_sdxl_few_step_matches_jax(sdxl_stacks, sampler_name):
    """guidance 0: the conditional half only, batch 1 through the UNet."""
    jmodels, params, pmodels, tokenize = sdxl_stacks
    ids, uncond = tokenize(["一只戴着帽子的可爱猫咪"]), tokenize([""])
    key = jax.random.PRNGKey(0)
    noise = _rand(1, 8, 8, 4, seed=12)
    want = jax_t2i.generate_sdxl(
        jmodels, params, ids.astype(np.int32), uncond.astype(np.int32), key,
        sampler_name=sampler_name, height=64, width=64, num_steps=3, guidance_scale=0.0,
        init_noise=jnp.asarray(noise))
    draws = _jax_step_draws(key, 3, noise.shape)
    calls = []
    unet = pmodels.unet
    hook = unet.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
    try:
        got = generate_sdxl(pmodels, ids, uncond, sampler_name=sampler_name, height=64,
                            width=64, num_steps=3, guidance_scale=0.0, init_noise=noise,
                            step_noise=draws)
    finally:
        hook.remove()
    assert calls == [1, 1, 1]
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    # without draws the steps differ: the draws were taken
    plain = generate_sdxl(pmodels, ids, uncond, sampler_name=sampler_name, height=64,
                          width=64, num_steps=3, guidance_scale=0.0, init_noise=noise)
    assert not torch.allclose(plain, got, atol=1e-3)


def test_generate_sdxl_draws_come_from_the_request_generator(sdxl_stacks):
    """A seed gives the same bits twice and another seed other bits."""
    _, _, pmodels, tokenize = sdxl_stacks
    ids, uncond = tokenize(["湖"]), tokenize([""])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate_sdxl(pmodels, ids, uncond, generator=gen, sampler_name="euler_a",
                             height=32, width=32, num_steps=2, guidance_scale=0.0,
                             init_noise=np.zeros((1, 4, 4, 4), np.float32))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def sd15_stacks():
    ucfg = JAX_SD15_UNET_TINY
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(JAX_BERT_TINY.hidden_size,
                                     (96, 96, ucfg.cross_attention_dim)),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, dtype=jnp.float32)
    params = perturb(jax_factory.init_params_host(jmodels, "chinese_clip", JAX_BERT_TINY),
                     seed=4)
    pmodels, tokenize, _ = build_demo(device="cpu", model="sd15")
    return jmodels, params, _load(pmodels, params), tokenize


def test_generate_sd_takes_no_fresh_noise(sd15_stacks):
    """JAX's generate_sd runs its denoise loop with no rng, so euler_a adds
    no noise there; the port's does the same whatever generator it gets."""
    jmodels, params, pmodels, tokenize = sd15_stacks
    ids, uncond = tokenize(["雪山"]), tokenize([""])
    key = jax.random.PRNGKey(5)
    want = jax_t2i.generate_sd(jmodels, params, jnp.asarray(ids, jnp.int32),
                               jnp.asarray(uncond, jnp.int32), key, sampler_name="euler_a",
                               height=64, width=64, num_steps=3, guidance_scale=7.5)
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    got = [generate_sd(pmodels, ids, uncond, generator=torch.Generator().manual_seed(s),
                       sampler_name="euler_a", height=64, width=64, num_steps=3,
                       guidance_scale=7.5, init_noise=noise) for s in (0, 1)]
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("start", [3, 9])
def test_dpm_loop_started_past_step_zero_matches_jax(start):
    """DPM++ over 10 steps started at step `start` (an inpaint strength < 1,
    a refiner hand-off): the first step reads the previous x0 as zeros, the
    JAX state's initial value, and so is second order with d1 = x0 / r0
    (first order at the last step). A loop started past step 0 used to
    raise a TypeError on the missing previous x0."""
    from pea_diffusion_tpu.pipelines import sampling as jax_sampling
    from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as JAX_SCHEDULE
    from pea_diffusion_tpu_torch.pipelines import denoise_loop, make_sampler
    from pea_diffusion_tpu_torch.schedulers import SDXL_SCHEDULE

    outs, noise = _rand(10, *SHAPE, seed=4), _rand(*SHAPE, seed=5)
    want = jax_t2i.denoise_loop(lambda x, i: jnp.asarray(outs)[i] + 0.3 * x,
                                jax_sampling.make_sampler("dpm++", JAX_SCHEDULE, 10),
                                jnp.asarray(noise), start=start)
    got = denoise_loop(lambda x, i: t(outs[i]) + 0.3 * x,
                       make_sampler("dpm++", SDXL_SCHEDULE, 10), t(noise), start=start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
