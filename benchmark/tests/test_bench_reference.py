"""The plain reference against the program at tiny sizes on the CPU, in
fp32, on the same seeded weights: every module of both stacks, one
DPM-Solver++ trajectory, the KD loss and its adapter gradient, and AdamW.
Only this test imports both sides."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import port_stack, weights
from benchmark.drivers import train
from benchmark.reference import checks, diffusion
from benchmark.tests import tiny

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(a, b, tol=2e-5):
    a, b = a.detach().double(), b.detach().double()
    assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("make", [tiny.sdxl, tiny.sd15])
def test_modules_match(make):
    cfg = make()
    prog = port_stack.kd_models(cfg, SEED, "cpu")
    ref = {n: weights.reference_module(cfg, n, SEED, "cpu") for n in cfg["components"]}
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(5, 1000, (2, 12), generator=g)
    ids[:, 9:] = 0  # padded keys are masked
    hs = ref["text_encoder"](ids)
    close(prog.text_encoder_fn(ids), hs)
    out_p, out_r = prog.adapter(hs), ref["adapter"](hs)
    added = None
    if isinstance(out_r, tuple):
        for a, b in zip(out_p, out_r):
            close(a, b)
        pooled, seq = out_r
        added = {"text_embeds": pooled,
                 "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]]).repeat(2, 1)}
    else:
        close(out_p, out_r)
        seq = out_r
    x = torch.randn(2, 8, 8, 4, generator=g)
    t = torch.tensor([10, 500])
    with torch.no_grad():
        up, fp = prog.unet(x, t, seq, added, capture_features=True)
        ur, fr = ref["unet"](x, t, seq, added, features=True)
        close(up, ur)
        assert sorted(fp) == sorted(fr)
        for k in fp:
            close(fp[k], fr[k])
        img = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
        eps = torch.randn(2, 32, 32, 4, generator=g)
        z = ref["vae"].encode(img, eps)
        close(prog.vae.encode_sample(img, eps=eps), z)
        close(prog.vae.decode(z), ref["vae"].decode(z))
        tid = torch.randint(4, 499, (2, 16), generator=g)
        o1, r1 = prog.teacher_clip1(tid), ref["teacher_1"](tid)
        close(o1.last_hidden_state, r1[0])
        close(o1.penultimate_hidden_state, r1[1])
        if "teacher_2" in ref:
            close(prog.teacher_clip2(tid).projected, ref["teacher_2"](tid)[2])


def test_dpm_solver_trajectory_matches():
    from pea_diffusion_tpu_torch.pipelines.sampling import make_sampler
    from pea_diffusion_tpu_torch.schedulers import NoiseScheduleConfig

    s = tiny.SCHEDULER
    steps = 6
    prog = make_sampler("dpm++", NoiseScheduleConfig(), steps)
    ref = diffusion.DPMSolver(s, steps)
    assert list(prog.timesteps) == list(ref.t)
    g = torch.Generator().manual_seed(1)
    x_p = x_r = torch.randn(1, 8, 8, 4, generator=g)
    state, prev = prog.init(), None
    for i in range(steps):
        eps = torch.sin(3 * x_r + i)  # any model of x
        new_r = ref.step(i, x_r, eps, prev)
        prev = ref.x0(i, x_r, eps)
        x_p, state = prog.step(i, x_p, torch.sin(3 * x_p + i), state)
        x_r = new_r
        close(x_p, x_r, 1e-5)
    noise = checks.request_noise(12345, 8)
    from pea_diffusion_tpu_torch.cli.serve import request_noise

    assert np.array_equal(request_noise(12345, 1, 8), noise)
    from pea_diffusion_tpu_torch.cli.generate import make_tokenizer

    assert np.array_equal(make_tokenizer(1000, 8)(["一只猫"])[0],
                          checks.token_ids("一只猫", 1000, 8))


@pytest.mark.parametrize("make", [tiny.sdxl, tiny.sd15])
def test_kd_loss_gradient_and_adamw_match(make):
    from pea_diffusion_tpu_torch.configs.train import TrainConfig
    from pea_diffusion_tpu_torch.train import kd

    cfg, tr = make(), tiny.train()
    hp = train.hyper(cfg, tr)
    prog = port_stack.kd_models(cfg, SEED, "cpu")
    tc = TrainConfig(learning_rate=hp["learning_rate"], warmup_steps=0, warmup_ratio=0.0,
                     total_steps=hp["total_steps"], min_learning_rate=hp["min_learning_rate"])
    batch = train.make_batch(cfg, tr, SEED, 0, "cpu")
    draws = diffusion.kd_draws(77, tr["batch"], (32, 32), "cpu")
    loss_p, _ = kd.kd_loss(prog, tc, batch, torch.Generator().manual_seed(77))
    params = dict(prog.adapter.named_parameters())
    grads_p = torch.autograd.grad(loss_p, list(params.values()))
    ref = {n: weights.reference_module(cfg, n, SEED, "cpu") for n in cfg["components"]}
    for p in ref["adapter"].parameters():
        p.requires_grad_(True)
    acp = diffusion.alphas_cumprod(cfg["scheduler"])
    loss_r, _ = diffusion.kd_loss_rows(ref, hp, batch, draws, acp, slice(0, 4), 4)
    grads_r = torch.autograd.grad(loss_r, list(ref["adapter"].parameters()))
    assert float(loss_p) == pytest.approx(float(loss_r), rel=1e-5)
    for a, b in zip(grads_p, grads_r):
        close(a, b, 1e-4)
    # one AdamW update from the same gradient
    from pea_diffusion_tpu_torch.train import optim

    named = {k: p.detach().clone() for k, p in params.items()}
    grads = {k: g.clone() for k, g in zip(params, grads_r)}
    state = optim.init_state(named)
    optim.apply_update(tc, named, dict(grads), state, optim.decay_mask(prog.adapter))
    mine = {k: p.detach().clone() for k, p in ref["adapter"].named_parameters()}
    opt = diffusion.AdamW(mine, hp)
    opt.step(mine, grads)
    for k in named:
        close(named[k], mine[k], 1e-6)
