"""The port's diffusion and distillation trainers against the reference's.

``cassmantle_tpu_torch/parallel/train.py`` against
``cassmantle_tpu/parallel/train.py`` at the tiny ``port_test_config()`` UNet
(fp32, CPU), on the same seeded numpy weights and batch. Torch and JAX
draw different streams, so each port step takes the draws the JAX step
makes from its key (t and noise; n and noise), draw for draw.

Tolerances: the optimizer's updates on identical gradients within 1e-6;
the step-0 loss within rtol 1e-5 and every parameter's gradient within
1e-4 of its largest reference value; losses over three steps within rtol
1e-4 (Adam's normalized step carries float noise on near-zero gradients
into the parameters); remat equal to the plain step within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.ops.ddim import ddim_update as jddim_update
from cassmantle_tpu.parallel import train as jtrain
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import attention as port_attention
from cassmantle_tpu_torch.parallel import train as ptrain
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.utils.logging import metrics

from _torch_port_common import assert_grads, assert_rel, jax_params, randn

B, HW, SEQ = 2, 8, 6


@pytest.fixture(scope="module")
def jcfg():
    return jax_test_config()


@pytest.fixture(scope="module")
def teacher(jcfg):
    """The reference UNet's tree, seeded numpy values."""
    d = jcfg.models.unet.context_dim
    return jax_params(JUNet(jcfg.models.unet), 7,
                      jnp.zeros((B, HW, HW, 4)), jnp.zeros((B,), jnp.int32),
                      jnp.zeros((B, SEQ, d)))


@pytest.fixture(scope="module")
def batch(jcfg):
    rng = np.random.default_rng(3)
    return {"latents": randn(rng, B, HW, HW, 4),
            "context": randn(rng, B, SEQ, jcfg.models.unet.context_dim)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_grads(module, jgrads, kind="unet"):
    assert_grads({n: p.grad for n, p in module.named_parameters()},
                 from_jax(kind, jax.device_get(jgrads)))


# -- the optimizer ------------------------------------------------------------

def test_make_optimizer_matches_optax():
    """Four updates on identical gradient trees, two with a global norm
    above 1.0 (clipped), two below (passed through); parameters within
    1e-6 after each."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "norm": (7,)}
    params = {k: randn(rng, *s) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = jtrain.make_optimizer(3e-2)
    jstate = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    popt = ptrain.make_optimizer(tparams.items(), 3e-2)
    norms = []
    for scale in (5.0, 0.05, 3.0, 0.01):
        grads = {k: scale * randn(rng, *s) / 3 for k, s in shapes.items()}
        norms.append(float(np.sqrt(sum((g ** 2).sum()
                                       for g in grads.values()))))
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in
                                      grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        popt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6)
    assert min(norms) < 1.0 < max(norms)
    assert popt.count == 4


def test_optimizer_state_round_trips():
    p = torch.nn.Parameter(torch.ones(3))
    opt = ptrain.make_optimizer([("p", p)], 1e-2)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    state = {k: v.clone() for k, v in opt.state_dict().items()}
    q = torch.nn.Parameter(torch.ones(3))
    again = ptrain.make_optimizer([("p", q)], 1e-2)
    again.load_state_dict(state)
    assert again.count == 1
    assert torch.equal(again.mu[0], opt.mu[0])
    with pytest.raises(ValueError, match="keys differ"):
        again.load_state_dict({"count": state["count"]})


def test_one_device_only():
    with pytest.raises(NotImplementedError, match="item 16"):
        ptrain.DiffusionTrainer(port_test_config(), mesh={"dp": 2, "tp": 1},
                                device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        ptrain.ConsistencyDistillTrainer(port_test_config(), mesh=(1, 2, 1),
                                         solver_steps=8, skip=2,
                                         max_serve_steps=4, device="cpu")
    ptrain.require_one_device((1, 1, 1))
    ptrain.require_one_device(None)


def test_step_seed_depends_on_seed_and_step_only():
    assert ptrain.step_seed(0, 5) == ptrain.step_seed(0, 5)
    assert len({ptrain.step_seed(s, n) for s in range(3)
                for n in range(50)}) == 150
    a = torch.randn(4, generator=ptrain.step_generator(1, 9, "cpu"))
    b = torch.randn(4, generator=ptrain.step_generator(1, 9, "cpu"))
    assert torch.equal(a, b)


# -- diffusion ----------------------------------------------------------------

def _diffusion_draws(key, shape, num_train_steps):
    """The reference step's draws from ``key`` (its split, randint,
    normal)."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, num_train_steps)
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return t, noise


def test_alpha_bars_equal_reference(jcfg):
    jt = jtrain.DiffusionTrainer(jcfg, None)
    ours = ptrain.train_alpha_bars(1000, "cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(jt.alpha_bars), rtol=2e-6)


def test_diffusion_step0_loss_and_grads_match_reference(jcfg, teacher,
                                                        batch):
    jt = jtrain.DiffusionTrainer(jcfg, None, lr=1e-3)
    t, noise = _diffusion_draws(jax.random.PRNGKey(4),
                                batch["latents"].shape, 1000)
    lat, ctx = jnp.asarray(batch["latents"]), jnp.asarray(batch["context"])
    a = jt.alpha_bars[t][:, None, None, None]
    noisy = jnp.sqrt(a) * lat + jnp.sqrt(1.0 - a) * noise

    def loss_fn(p):
        pred = jt._apply(p, noisy, t, ctx)
        return jnp.mean((pred - noise) ** 2)

    jloss, jgrads = jax.value_and_grad(loss_fn)(teacher)
    pt = ptrain.DiffusionTrainer(port_test_config(), lr=1e-3, device="cpu")
    pt.init_state(state_dict=from_jax("unet", teacher))
    loss = pt.loss_and_grads(_tbatch(batch), _t(t), _t(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads(pt.unet, jgrads)


def test_diffusion_three_steps_match_reference(jcfg, teacher, batch):
    jt = jtrain.DiffusionTrainer(jcfg, None, lr=1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, teacher)
    opt = jt.optimizer.init(params)
    pt = ptrain.DiffusionTrainer(port_test_config(), lr=1e-3, device="cpu")
    pt.init_state(state_dict=from_jax("unet", teacher))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, pl = [], []
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        params, opt, loss = jt.step(params, opt, jbatch, key)
        jl.append(float(loss))
        t, noise = _diffusion_draws(key, batch["latents"].shape, 1000)
        pl.append(float(pt.step_at(_tbatch(batch), _t(t), _t(noise))))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)


def test_diffusion_remat_equals_plain(teacher, batch):
    out = {}
    rng = np.random.default_rng(5)
    t = torch.tensor([17, 803], dtype=torch.int32)
    noise = torch.from_numpy(randn(rng, *batch["latents"].shape))
    for remat in (False, True):
        pt = ptrain.DiffusionTrainer(port_test_config(), lr=1e-3, remat=remat,
                                     device="cpu")
        pt.init_state(state_dict=from_jax("unet", teacher))
        loss = pt.loss_and_grads(_tbatch(batch), t, noise)
        out[remat] = (float(loss), {n: p.grad.clone() for n, p in
                                    pt.unet.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, g in out[False][1].items():
        assert_rel(out[True][1][name], g, 1e-6)


def test_differentiated_forward_routes_attention_to_plain(monkeypatch,
                                                          teacher, batch):
    """Fault 1: inside plain_only (and its remat recompute, which runs in
    the backward) UNet attention takes plain_attention, never the flash
    wrapper; a forward outside it takes the flash wrapper."""
    calls = {"flash": 0, "plain": 0}
    flash, plain = port_attention.flash_attention, \
        port_attention.plain_attention

    def spy_flash(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    def spy_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", spy_flash)
    monkeypatch.setattr(port_attention, "plain_attention", spy_plain)
    pt = ptrain.DiffusionTrainer(port_test_config(), remat=True, device="cpu")
    pt.init_state(state_dict=from_jax("unet", teacher))
    tb = _tbatch(batch)
    t = torch.tensor([3, 500], dtype=torch.int32)
    with torch.no_grad():
        pt.unet(tb["latents"], t, tb["context"])
    assert calls["flash"] > 0 and calls["plain"] == 0
    per_forward = calls["flash"]
    calls.update(flash=0, plain=0)
    pt.loss_and_grads(tb, t, torch.zeros_like(tb["latents"]))
    # the forward and its recompute in the backward, both plain
    assert calls == {"flash": 0, "plain": 2 * per_forward}
    with port_attention.plain_only():
        with port_attention.plain_only():
            pass
        assert port_attention._PLAIN_ONLY.get()
    assert not port_attention._PLAIN_ONLY.get()


def test_fp32_attention_on_the_card_takes_the_plain_path():
    """Fault 2: the route rule. Unmasked fp32 attention on the card
    (the CLIP vision tower) takes plain_attention; bf16 takes the kernel;
    the CPU keeps its route for every dtype."""
    q, k = (2, 257, 16, 64), (2, 257, 16, 64)
    rule = port_attention.takes_flash
    assert not rule(q, k, False, "cuda", torch.float32)
    assert rule(q, k, False, "cuda", torch.bfloat16)
    assert rule(q, k, False, "cpu", torch.float32)
    assert rule(q, k, False, "cpu", torch.bfloat16)
    assert not rule(q, k, True, "cuda", torch.bfloat16)
    with port_attention.plain_only():
        assert not rule(q, k, False, "cuda", torch.bfloat16)
        assert not rule(q, k, False, "cpu", torch.float32)


# -- consistency distillation -------------------------------------------------

DISTILL = dict(lr=3e-3, solver_steps=8, skip=2, ema_decay=0.9,
               max_serve_steps=4)


@pytest.fixture(scope="module")
def jdistill(jcfg):
    return jtrain.ConsistencyDistillTrainer(jcfg, mesh=None, **DISTILL)


def _pdistill(teacher):
    pt = ptrain.ConsistencyDistillTrainer(port_test_config(), device="cpu",
                                          **DISTILL)
    pt.init_state(from_jax("unet", teacher))
    return pt


def _distill_draws(key, shape, n_grid, skip):
    rng_n, rng_eps = jax.random.split(key)
    n = jax.random.randint(rng_n, (shape[0],), 0, n_grid - skip)
    noise = jax.random.normal(rng_eps, shape, jnp.float32)
    return n, noise


def test_distill_schedule_equals_reference(jdistill, teacher):
    pt = _pdistill(teacher)
    assert np.array_equal(pt.timesteps.numpy(), np.asarray(jdistill.timesteps))
    assert np.array_equal(pt.alpha_bars.numpy(),
                          np.asarray(jdistill.alpha_bars))
    assert pt.sigma_min == jdistill.sigma_min


def test_distill_step0_loss_and_grads_match_reference(jdistill, teacher,
                                                      batch):
    jt = jdistill
    n, noise = _distill_draws(jax.random.PRNGKey(6), batch["latents"].shape,
                              jt.timesteps.shape[0], jt.skip)
    lat, ctx = jnp.asarray(batch["latents"]), jnp.asarray(batch["context"])
    t_n, t_k = jt.timesteps[n], jt.timesteps[n + jt.skip]
    ab_n = jt.alpha_bars[n][:, None, None, None]
    ab_k = jt.alpha_bars[n + jt.skip][:, None, None, None]
    x_n = jnp.sqrt(ab_n) * lat + jnp.sqrt(1.0 - ab_n) * noise
    eps_teacher = jt._apply(teacher, x_n, t_n, ctx)
    x_k = jddim_update(x_n, eps_teacher, ab_n, ab_k)
    target = jax.lax.stop_gradient(
        jt._consistency_f(teacher, x_k, t_k, ab_k, ctx))

    def loss_fn(p):
        pred = jt._consistency_f(p, x_n, t_n, ab_n, ctx)
        return jnp.mean((pred - target) ** 2)

    jloss, jgrads = jax.value_and_grad(loss_fn)(teacher)
    pt = _pdistill(teacher)
    loss = pt.loss_and_grads(_tbatch(batch), _t(n).long(), _t(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads(pt.student, jgrads)


def test_distill_three_steps_match_reference(jdistill, teacher, batch):
    jt = jdistill
    student, ema, opt = jt.init_state(teacher)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pt = _pdistill(teacher)
    jl, pl = [], []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        student, ema, opt, loss = jt.step(student, ema, opt, teacher,
                                          jbatch, key)
        jl.append(float(loss))
        n, noise = _distill_draws(key, batch["latents"].shape,
                                  jt.timesteps.shape[0], jt.skip)
        pl.append(float(pt.step_at(_tbatch(batch), _t(n).long(),
                                   _t(noise))))
    # steps 2 and 3 read the EMA target the earlier steps updated
    np.testing.assert_allclose(pl, jl, rtol=1e-4)


@pytest.mark.parametrize("solver_steps,skip,max_serve", [
    (8, 8, 4), (8, 0, 4), (8, 2, 8), (8, 2, 4), (8, 1, 8), (50, 1, 8),
    (50, 5, 8), (50, 6, 8), (50, 10, 4), (20, 4, 2), (3, 2, 8)])
def test_skip_coverage_matches_reference(jcfg, solver_steps, skip,
                                         max_serve):
    """The constructor refuses exactly what the reference's assertions
    refuse, with its messages."""
    try:
        jtrain.ConsistencyDistillTrainer(jcfg, solver_steps=solver_steps,
                                         skip=skip,
                                         max_serve_steps=max_serve)
        ref = None
    except AssertionError as exc:
        ref = str(exc)
    if ref is None:
        ptrain.ConsistencyDistillTrainer(port_test_config(),
                                         solver_steps=solver_steps,
                                         skip=skip, max_serve_steps=max_serve,
                                         device="cpu")
    else:
        with pytest.raises(ValueError) as info:
            ptrain.ConsistencyDistillTrainer(
                port_test_config(), solver_steps=solver_steps, skip=skip,
                max_serve_steps=max_serve, device="cpu")
        assert str(info.value) == ref


def test_ema_update_math(teacher, batch):
    pt = _pdistill(teacher)
    d = pt.ema_decay
    before = {n: p.detach().clone() for n, p in pt.ema.named_parameters()}
    pt.step(_tbatch(batch), torch.Generator().manual_seed(0))
    student = dict(pt.student.named_parameters())
    for name, e in pt.ema.named_parameters():
        want = d * before[name] + (1.0 - d) * student[name].detach()
        np.testing.assert_allclose(e.detach().numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)
    # the teacher stays frozen
    for name, p in pt.teacher.named_parameters():
        assert not p.requires_grad
        assert torch.equal(p, from_jax("unet", teacher)[name])


def test_student_layout_equals_teacher(teacher):
    pt = _pdistill(teacher)
    t_sd = pt.teacher.state_dict()
    for model in (pt.student, pt.ema):
        sd = model.state_dict()
        assert list(sd) == list(t_sd)
        for k, v in sd.items():
            assert v.shape == t_sd[k].shape and v.dtype == t_sd[k].dtype
            assert v.data_ptr() != t_sd[k].data_ptr()
    assert all(p.requires_grad for p in pt.student.parameters())
    assert not any(p.requires_grad for p in pt.ema.parameters())
    assert set(pt.model_state()) == ({f"student.{k}" for k in t_sd}
                                     | {f"ema.{k}" for k in t_sd})


def test_toy_student_serves_few_step_through_the_pipeline(teacher, batch):
    """Distill a few steps, give the student's state_dict to the port's
    Text2ImagePipeline under a 4-step consistency config on the trainer's
    grid: finite uint8 images, num_steps UNet forwards an image."""
    pt = _pdistill(teacher)
    for i in range(4):
        pt.step(_tbatch(batch), ptrain.step_generator(3, i, "cpu"))
    cfg = port_test_config()
    lcm = cfg.replace(sampler=dataclasses.replace(
        cfg.sampler, consistency=True, num_steps=4,
        consistency_teacher_steps=pt.solver_steps))
    pipe = Text2ImagePipeline(lcm, device="cpu",
                              state_dicts={"unet": pt.ema.state_dict()})
    before = metrics.counter_total("pipeline.consistency_steps")
    imgs = pipe.generate(["a quiet harbor at dawn", "a stormy night at sea"],
                         seed=5)
    per_image = (metrics.counter_total("pipeline.consistency_steps")
                 - before) / imgs.shape[0]
    assert imgs.dtype == np.uint8 and imgs.shape == (2, 64, 64, 3)
    assert per_image == 4
    for name, p in pipe.unet.named_parameters():
        assert torch.equal(p, pt.ema.state_dict()[name])


def test_loss_decreases_on_a_fixed_batch(teacher, batch):
    pt = ptrain.DiffusionTrainer(port_test_config(), lr=3e-3, device="cpu")
    pt.init_state(state_dict=from_jax("unet", teacher))
    tb = _tbatch(batch)
    t = torch.tensor([100, 700], dtype=torch.int32)
    noise = torch.from_numpy(randn(np.random.default_rng(9),
                                   *batch["latents"].shape))
    losses = [float(pt.step_at(tb, t, noise)) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
