"""Serving over a mesh, on the CPU at ``test_config()`` and
``test_sdxl_config()`` sizes: the port's ``parallel/mesh.py`` and
``parallel/collectives.py`` and the meshed pipelines and service
(``serving/pipeline.py``, ``serving/sdxl.py``, ``serving/service.py``).

- ``resolve_axis_sizes`` against the reference's on the same cases, the
  error cases raising alike; ``make_mesh`` over repeated devices;
  ``batch_sharding`` / ``replicated``;
- each collective on CPU positions;
- dp = 2 and 4 ``generate`` (SD1.5 and SDXL, weights carried over by
  ``from_jax``): every row, the dropped pad rows too, bit-equal to the
  port's meshless batch-1 dispatch from the same x_T row, and the
  prompts' rows within the slice's image bar (2 levels everywhere, mean
  |diff| <= 0.5) of the reference's pipeline on the same x_T;
- the staged gate false under a mesh; ``default_serving_mesh`` over a
  patched card count; the cost attribution of the padded rows over the
  mesh's cards; a module's replica; a full ``Game`` round on a 2 x 2
  mesh.
"""

import asyncio
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import MeshConfig as JMeshConfig
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops.ddim import DDIMSchedule as JSchedule
from cassmantle_tpu.ops.ddim import ddim_sample as jax_ddim_sample
from cassmantle_tpu.ops.ddim import make_cfg_denoiser as jax_cfg_denoiser
from cassmantle_tpu.parallel.mesh import (
    resolve_axis_sizes as jax_resolve_axis_sizes,
)
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu_torch.config import MeshConfig
from cassmantle_tpu_torch.config import staged_serving_config
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.engine.game import Game
from cassmantle_tpu_torch.engine.store import MemoryStore
from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.parallel import collectives as coll
from cassmantle_tpu_torch.parallel import mesh as mesh_mod
from cassmantle_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    resolve_axis_sizes,
)
from cassmantle_tpu_torch.serving import service as service_mod
from cassmantle_tpu_torch.serving.pipeline import (
    Text2ImagePipeline,
    pad_prompts_to_dp,
    replicate_module,
    serving_layout,
)
from cassmantle_tpu_torch.serving.service import (
    InferenceService,
    default_serving_mesh,
)
from cassmantle_tpu_torch.utils import profiling
from cassmantle_tpu_torch.utils.logging import metrics

from _torch_port_common import randn
from test_torch_port_sdxl import PROMPTS as SDXL_PROMPTS
from test_torch_port_sdxl import _port_pipe, _ref_pipe, sdxl_ref  # noqa: F401
from test_torch_port_slice import PROMPTS, slice_ref  # noqa: F401

CPU = torch.device("cpu")

AXIS_CASES = [
    (dict(), 8), (dict(dp=-1, tp=2), 8), (dict(dp=2, tp=2, sp=2), 8),
    (dict(dp=-1, pp=2, ep=2), 8), (dict(dp=-1, sp=2), 4),
    (dict(dp=1, sp=-1), 4), (dict(dp=3), 6), (dict(dp=4), 6),
    (dict(dp=2, sp=2), 2), (dict(dp=-1, tp=3), 8),
]


@pytest.mark.parametrize("sizes,n", AXIS_CASES)
def test_resolve_axis_sizes_matches_reference(sizes, n):
    """The same sizes for every case, and an AssertionError wherever the
    reference raises one (the fixed axes do not divide the devices)."""
    try:
        ref = jax_resolve_axis_sizes(JMeshConfig(**sizes), n)
    except AssertionError:
        with pytest.raises(AssertionError):
            resolve_axis_sizes(MeshConfig(**sizes), n)
        return
    assert resolve_axis_sizes(MeshConfig(**sizes), n) == list(ref)


def test_make_mesh_over_repeated_devices():
    mesh = make_mesh(MeshConfig(dp=2, sp=2), ["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "pp": 1, "tp": 1, "sp": 2, "ep": 1}
    assert mesh.size == 4 and mesh.home == CPU
    assert mesh.distinct_devices() == [CPU]
    assert serving_layout(mesh) == [[CPU, CPU], [CPU, CPU]]
    with pytest.raises(NotImplementedError, match="item 16"):
        serving_layout(make_mesh(MeshConfig(dp=1, tp=2), ["cpu"] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(MeshConfig())


def test_shardings_place_rows_and_copies():
    mesh = make_mesh(MeshConfig(dp=2, sp=2), ["cpu"] * 4)
    x = torch.arange(24.0).reshape(4, 6)
    held = batch_sharding(mesh).place(x)
    assert held.shape == (2, 1, 1, 2, 1)
    for dp in range(2):
        for sp in range(2):
            piece = held[dp, 0, 0, sp, 0]
            assert torch.equal(piece, x[2 * dp:2 * dp + 2])
    # one tensor per device for what its positions hold alike
    assert held[0, 0, 0, 0, 0] is held[0, 0, 0, 1, 0]
    whole = replicated(mesh).place(x)
    assert len({id(t) for t in whole.flat}) == 1
    assert all(t.data_ptr() == x.data_ptr() and torch.equal(t, x)
               for t in whole.flat)
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(mesh).place(torch.zeros(3, 2))


def test_collectives_on_cpu_positions():
    devs = [CPU] * 4
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    shards = coll.split(x, devs, 1)
    assert [tuple(s.shape) for s in shards] == [(2, 2, 3)] * 4
    assert torch.equal(coll.gather(shards, CPU, 1), x)
    for got in coll.all_gather(shards, 1):
        assert torch.equal(got, x)
    # ppermute: a shift right, the first position receiving zeros
    moved = coll.ppermute(shards, [(i, i + 1) for i in range(3)])
    assert torch.equal(moved[0], torch.zeros_like(shards[0]))
    for i in range(1, 4):
        assert torch.equal(moved[i], shards[i - 1])
    tops, bottoms = coll.halo_rows(shards, 1)
    for i in range(4):
        want_top = (x[:, 2 * i - 1:2 * i] if i else torch.zeros(2, 1, 3))
        want_bottom = (x[:, 2 * i + 2:2 * i + 3] if i < 3
                       else torch.zeros(2, 1, 3))
        assert torch.equal(tops[i], want_top)
        assert torch.equal(bottoms[i], want_bottom)
    parts = [torch.full((2,), float(i)) - 1.5 for i in range(4)]
    for total in coll.psum(parts):
        assert torch.equal(total, torch.full((2,), 0.0))
    for top in coll.pmax(parts):
        assert torch.equal(top, torch.full((2,), 1.5))
    with pytest.raises(ValueError, match="split 3 ways"):
        coll.split(x, [CPU] * 3, 1)
    assert coll.move(x, CPU) is x


def test_pad_prompts_to_dp():
    assert pad_prompts_to_dp(["a", "b", "c"], 2) == (["a", "b", "c", ""], 3)
    assert pad_prompts_to_dp(["a"], 4) == (["a", "", "", ""], 1)
    assert pad_prompts_to_dp(["a", "b"], 1) == (["a", "b"], 2)


def _sdxl_ref_images(ref):
    """The reference SDXL slice's images on its x_T (the SDXL test's own
    construction from the reference's modules)."""
    cfg = ref["cfg"]
    m, s = cfg.models, cfg.sampler
    ns, params = _ref_pipe(ref)
    ids, uids = jnp.asarray(ref["ids"]), jnp.asarray(ref["uids"])
    ctx, pooled = JSDXL._encode(ns, params, ids)
    uctx, upooled = JSDXL._encode(ns, params, uids)
    time_ids = JSDXL._time_ids(ns, len(SDXL_PROMPTS))
    denoise = jax_cfg_denoiser(
        JUNet(m.unet).apply, params["unet"], ctx, uctx, s.guidance_scale,
        addition_embeds=jnp.concatenate([pooled, time_ids], axis=-1),
        uncond_addition_embeds=jnp.concatenate([upooled, time_ids],
                                               axis=-1))
    final = jax_ddim_sample(denoise, jnp.asarray(ref["x_t"]),
                            JSchedule.create(s.num_steps))
    return np.asarray(jax_postprocess(JVAE(m.vae).apply(params["vae"],
                                                        final)))


@pytest.fixture(scope="module")
def meshless(slice_ref, sdxl_ref):  # noqa: F811
    """The port's meshless pipelines from the references' trees, the
    references' images, prompts and x_T."""
    sd = {k: from_jax(k, v) for k, v in slice_ref["params"].items()}
    sd15 = Text2ImagePipeline(port_test_config(), device="cpu",
                              state_dicts=sd)
    return {"sd15": (sd15, PROMPTS, slice_ref["x_t"],
                     slice_ref["images"]),
            "sdxl": (_port_pipe(sdxl_ref), SDXL_PROMPTS, sdxl_ref["x_t"],
                     _sdxl_ref_images(sdxl_ref))}


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("model", ["sd15", "sdxl"])
def test_dp_rows_equal_meshless_batch_one(meshless, model, dp):
    """dp positions, one row each (the prompts padded to dp): each row and
    each dropped pad row bit-equal to the meshless pipeline's batch-1
    dispatch of its prompt ("" for a pad row) from the same x_T row; the
    prompts' rows within the image bar of the reference's images."""
    ref_pipe, prompts, x_t, ref_images = meshless[model]
    mesh = make_mesh(MeshConfig(dp=dp), ["cpu"] * dp)
    pipe = type(ref_pipe)(ref_pipe.cfg, device="cpu", mesh=mesh,
                          share_params_with=ref_pipe)
    assert pipe.unet is ref_pipe.unet and pipe.dp == dp
    extra = randn(np.random.default_rng(60), dp - len(prompts),
                  *x_t.shape[1:])
    lat = torch.from_numpy(np.concatenate([x_t, extra]))
    images = pipe.generate(prompts, latents=lat)
    assert images.shape == ref_images.shape and images.dtype == np.uint8
    assert len(pipe.last_pad_images) == dp - len(prompts)
    rows = np.concatenate([images, pipe.last_pad_images])
    padded = list(prompts) + [""] * (dp - len(prompts))
    for i, prompt in enumerate(padded):
        one = ref_pipe.generate([prompt], latents=lat[i:i + 1])
        assert np.array_equal(one[0], rows[i]), (i, prompt)
    diff = np.abs(images.astype(np.int32) - ref_images.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()
    assert pipe.last_decoded_finite
    assert set(pipe.last_stage_seconds) == {"clip", "denoise", "vae"}
    # each position captured (here: built) its own step loop
    assert len(pipe._mesh_positions()) == dp
    assert [v.position for v in pipe._mesh_positions()] == list(range(dp))


def test_staged_gate_false_under_a_mesh(meshless):
    cfg = staged_serving_config()
    ref_pipe = meshless["sd15"][0]
    cfg = cfg.replace(models=ref_pipe.cfg.models,
                      sampler=ref_pipe.cfg.sampler)
    assert Text2ImagePipeline._staged_enabled(
        type("P", (), {"cfg": cfg, "mesh": None})())
    pipe = Text2ImagePipeline(cfg, device="cpu", share_params_with=ref_pipe,
                              mesh=make_mesh(MeshConfig(dp=2), ["cpu"] * 2))
    assert not pipe._staged_enabled()


def test_padded_rows_counted_over_the_mesh_cards(meshless, monkeypatch):
    """flops_est counts the padded rows (as the reference's), and
    utilization divides by the peaks of the mesh's distinct cards."""
    ref_pipe = meshless["sd15"][0]
    seen = {}

    def spy(name, *, flops_est=None, pipeline=None, cards=1):
        seen.update(flops=flops_est, cards=cards)
        return real(name, flops_est=flops_est, pipeline=pipeline,
                    cards=cards)

    real = profiling.block_timer
    monkeypatch.setattr("cassmantle_tpu_torch.serving.pipeline.block_timer",
                        spy)
    per_image = costmodel.Products(bf16=1e9)
    pipe = Text2ImagePipeline(ref_pipe.cfg, device="cpu",
                              share_params_with=ref_pipe,
                              mesh=make_mesh(MeshConfig(dp=4), ["cpu"] * 4))
    monkeypatch.setattr(pipe, "_dispatch_flops", lambda v: per_image)
    pipe.generate(["one prompt"], seed=1)
    assert seen == {"flops": per_image.scaled(4), "cards": 1}
    assert costmodel.utilization(per_image, 2.0, cards=4) == pytest.approx(
        costmodel.utilization(per_image, 2.0) / 4)


def test_replicate_module_copies_every_tensor():
    cfg = port_test_config().models.unet
    unet = UNet(dataclasses.replace(cfg, fused_conv=True))
    init_weights(unet, torch.Generator().manual_seed(3))
    twin = replicate_module(unet, CPU)
    pairs = list(zip(twin.state_dict().items(), unet.state_dict().items()))
    assert len(pairs) == len(unet.state_dict())
    for (name, a), (name_b, b) in pairs:
        assert name == name_b and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr() and a.stride() == b.stride()
    with torch.no_grad():
        next(unet.parameters()).add_(1.0)
    assert not torch.equal(next(twin.parameters()),
                           next(unet.parameters()))


@pytest.mark.parametrize("cards,want", [(0, None), (1, None), (4, 4)])
def test_default_serving_mesh(monkeypatch, cards, want):
    """dp over every card when the host has more than one; None on one
    card and for a service asked onto the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for module in (service_mod, mesh_mod):
        monkeypatch.setattr(module, "resolve_device",
                            lambda d: torch.device(d))
    cfg = port_test_config()
    assert default_serving_mesh(cfg, "cpu") is None
    mesh = default_serving_mesh(cfg, "cuda")
    if want is None:
        assert mesh is None
    else:
        assert mesh.shape["dp"] == want
        assert mesh.distinct_devices() == [torch.device("cuda", i)
                                           for i in range(want)]


def test_full_game_round_on_a_2x2_mesh():
    """The counterpart of the reference's ``_run_full_round_on_mesh``: a
    ``Game`` over an ``InferenceService`` on a dp x sp = 2 x 2 CPU mesh:
    the startup generation, 100 guesses from 8 sessions, the buffer
    generation and the promotion; each image uint8 with std > 0."""
    cfg = port_test_config()
    cfg = cfg.replace(game=dataclasses.replace(
        cfg.game, time_per_prompt=4.0, lock_timeout=60.0,
        acquire_timeout=1.0))
    mesh = make_mesh(MeshConfig(dp=2, sp=2), ["cpu"] * 4)
    svc = InferenceService(cfg, device="cpu", table=None, mesh=mesh)
    assert svc.backend.t2i.mesh is mesh and svc.mesh is mesh
    game = Game(cfg, MemoryStore(), svc.content_backend, svc.embed,
                svc.similarity)
    game.rounds.rng = random.Random(0)
    count = metrics.counter_total
    images = count("pipeline.images")

    async def play():
        await game.startup()
        episode0 = int((await game.fetch_story()).get("episode", 0))
        ver0 = await game.rounds.current_image_version()
        timer = game.start_timer(tick=0.2)

        async def one_guess(i: int) -> dict:
            masks = await game.rounds.current_masks()
            return await game.compute_client_scores(
                f"mesh-player-{i % 8}",
                {str(masks[i % len(masks)]): f"guess{i}"})

        results = await asyncio.gather(*(one_guess(i) for i in range(100)))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 120.0
        while int((await game.fetch_story()).get("episode", 0)) <= episode0:
            assert loop.time() < deadline, "the round never promoted"
            await asyncio.sleep(0.2)
        ver1 = await game.rounds.current_image_version()
        current = await game.store.hget("image", "current")
        timer.cancel()
        await game.shutdown()
        await svc.stop()
        return results, ver0, ver1, current

    results, ver0, ver1, current = asyncio.run(play())
    assert len(results) == 100 and all("won" in r for r in results)
    assert ver1 != ver0
    # startup's current and buffered rounds, then the promotion's buffer
    assert count("pipeline.images") - images >= 2
    from PIL import Image
    import io

    image = np.asarray(Image.open(io.BytesIO(current)))
    assert image.dtype == np.uint8 and image.std() > 0
    assert image.shape == (cfg.sampler.image_size,) * 2 + (3,)


def test_brownout_tier_over_the_mesh(meshless, monkeypatch):
    """A brownout tier's variant is built over the same mesh: at tier 4
    (half the size) a dp x sp = 2 x 2 pipeline serves the tier's images,
    each dp position through its own tier step loop, the sp positions
    splitting the tier's latent rows; the images equal the meshless
    pipeline's at the tier within the slice's bar."""
    from cassmantle_tpu_torch.serving import overload

    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    ref_pipe = meshless["sd15"][0]
    pipe = Text2ImagePipeline(ref_pipe.cfg, device="cpu",
                              share_params_with=ref_pipe,
                              mesh=make_mesh(MeshConfig(dp=2, sp=2),
                                             ["cpu"] * 4))
    ladder = overload.BrownoutLadder(overload.DEFAULT_TIERS)
    with ladder._lock:
        ladder._tier = 4
    monkeypatch.setattr(overload, "_LADDER", ladder)
    size = ref_pipe.cfg.sampler.image_size // 2
    images = pipe.generate(["a lighthouse", "a harbor"], seed=4)
    want = ref_pipe.generate(["a lighthouse", "a harbor"], seed=4)
    assert images.shape == want.shape == (2, size, size, 3)
    diff = np.abs(images.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 2 and diff.mean() <= 0.5
    (variant,) = pipe.tier_variants.values()
    assert variant.sampler_cfg.image_size == size
    assert [v.position for v in pipe._mesh_positions()] == [0, 1]


def test_rebuild_replaces_every_replica(meshless):
    """The device-loss rebuild refills the served models in place, then
    copies them into every other card's replica in place (here a replica
    kept under a second device key, corrupted first)."""
    ref_pipe = meshless["sd15"][0]
    pipe = Text2ImagePipeline(ref_pipe.cfg, device="cpu",
                              share_params_with=ref_pipe,
                              mesh=make_mesh(MeshConfig(dp=2), ["cpu"] * 2))
    pipe._mesh_positions()
    other = torch.device("cpu", 1)
    pipe._replicas[other] = {name: replicate_module(getattr(pipe, name), CPU)
                             for name in pipe.REPLICATED}
    replica = pipe._replicas[other]["unet"]
    held = next(replica.parameters())
    with torch.no_grad():
        held.add_(1.0)
        next(pipe.unet.parameters()).mul_(2.0)
    pipe.reload_params()
    assert next(replica.parameters()) is held
    for a, b in zip(replica.state_dict().values(),
                    pipe.unet.state_dict().values()):
        assert torch.equal(a, b)
