"""The spatially partitioned UNet (``parallel/spatial.py``) and the sp
serving path, on the CPU at ``test_config()`` and ``test_sdxl_config()``
sizes.

- ``SpatialUNet`` over sp = 2 and 4 CPU positions against the reference
  UNet's apply on the same numpy-seeded tree and inputs (fp32, max |diff|
  < 1e-4, the reference's own bound for its partitioned denoise), and
  against the reference's partitioned apply itself
  (``spatially_shard_latents`` over a dp x sp mesh of the suite's virtual
  CPU devices); DeepCache's and encoder propagation's modes against the
  port's one-device forward;
- the attention route: the shards' self attention keeps the kernel's
  route under ``CASSMANTLE_NO_FLASH_CROSS``;
- the refusals: a latent H that does not split, and the fused-conv, W8A8
  and weights-only int8 UNets under sp > 1 (naming the ROADMAP item);
- an sp pipeline's images (plain DDIM, DeepCache, encoder propagation,
  SDXL) within the slice's image bar of the meshless pipeline's.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cassmantle_tpu.config import MeshConfig as JMeshConfig
from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.config import test_sdxl_config as jax_test_sdxl_config
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cassmantle_tpu.serving.pipeline import spatially_shard_latents
from cassmantle_tpu_torch.config import MeshConfig
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.config import (
    test_sdxl_config as port_test_sdxl_config,
)
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.ops import attention
from cassmantle_tpu_torch.ops import quant
from cassmantle_tpu_torch.parallel.mesh import make_mesh
from cassmantle_tpu_torch.parallel.spatial import (
    SpatialUNet,
    check_spatial,
)
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

from _torch_port_common import jax_params, load, randn

CPU = torch.device("cpu")
CONFIGS = {"sd15": (jax_test_config, port_test_config, "unet"),
           "sdxl": (jax_test_sdxl_config, port_test_sdxl_config, "unet_xl")}


@pytest.fixture(scope="module", params=["sd15", "sdxl"])
def unet_case(request):
    """The reference UNet, its numpy tree, the port's UNet from it and
    the inputs: x (2, 32, 32, 4), two timesteps, an 8-token context and
    SDXL's additions."""
    jax_cfg, port_cfg, kind = CONFIGS[request.param]
    m = jax_cfg().models
    rng = np.random.default_rng(70)
    x = randn(rng, 2, 32, 32, 4)
    t = np.array([3, 701], dtype=np.int32)
    ctx = randn(rng, 2, 8, m.unet.context_dim)
    args = [x, t, ctx]
    if m.unet.addition_embed_dim:
        args.append(randn(rng, 2, m.unet.addition_embed_dim))
    ref = JUNet(m.unet)
    params = jax_params(ref, 71, *map(jnp.asarray, args))
    port = load(UNet(port_cfg().models.unet), params, kind)
    return {"name": request.param, "ref": ref, "params": params,
            "port": port, "args": args}


def _port_args(case):
    x, t, *rest = case["args"]
    return [torch.from_numpy(x), torch.from_numpy(t).long(),
            *map(torch.from_numpy, rest)]


@pytest.mark.parametrize("sp", [2, 4])
def test_spatial_forward_matches_reference(unet_case, sp):
    """sp shards against the reference UNet on one device and against the
    reference's own partitioned forward (latents constrained to
    P("dp", "sp") over a dp=2 mesh of virtual devices): fp32, < 1e-4."""
    case = unet_case
    args = list(map(jnp.asarray, case["args"]))
    ref = np.asarray(jax.jit(case["ref"].apply)(case["params"], *args))
    mesh = jax_make_mesh(JMeshConfig(dp=2, tp=1, sp=sp),
                         devices=jax.devices()[:2 * sp])
    batch = NamedSharding(mesh, P("dp"))

    def sharded(p, lat, *rest):
        return case["ref"].apply(p, spatially_shard_latents(lat, mesh),
                                 *rest)

    ref_sp = np.asarray(jax.jit(
        sharded, in_shardings=(None,) + (batch,) * len(args))(
            case["params"], *args))
    spatial = SpatialUNet([case["port"]] * sp, [CPU] * sp)
    with torch.inference_mode():
        out = spatial(*_port_args(case)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-4
    assert np.abs(out - ref_sp).max() < 1e-4


@pytest.mark.parametrize("sp", [2, 4])
def test_spatial_feature_reuse_modes(unet_case, sp):
    """DeepCache's deep activation and shallow pass, encoder propagation's
    skip stack, up-path entry and decoder-only pass: gathered and split
    again, each within 1e-4 of the one-device forward."""
    port = unet_case["port"]
    x, t, ctx, *add = _port_args(unet_case)
    spatial = SpatialUNet([port] * sp, [CPU] * sp)

    def close(a, b):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() < 1e-4

    with torch.inference_mode():
        eps, deep = port(x, t, ctx, *add, return_deep=True)
        s_eps, s_deep = spatial(x, t, ctx, *add, return_deep=True)
        close(s_eps, eps)
        close(s_deep, deep)
        close(spatial(x, t, ctx, *add, deep_cache=deep),
              port(x, t, ctx, *add, deep_cache=deep))
        _, (skips, entry) = port(x, t, ctx, *add, return_skips=True)
        _, (s_skips, s_entry) = spatial(x, t, ctx, *add, return_skips=True)
        for a, b in zip(s_skips, skips, strict=True):
            close(a, b)
        close(s_entry, entry)
        close(spatial(None, t, ctx, *add, skips_cache=(skips, entry)),
              port(None, t, ctx, *add, skips_cache=(skips, entry)))


def test_spatial_self_attention_keeps_the_kernel_route(unet_case,
                                                       monkeypatch):
    """A shard's queries against the whole image's keys are self
    attention: CASSMANTLE_NO_FLASH_CROSS (which sends Sq != Sk to the
    plain path) leaves them on the kernel's route, and cross attention
    (the context) still obeys it."""
    monkeypatch.setenv("CASSMANTLE_NO_FLASH_CROSS", "1")
    routes = []
    real = attention.takes_flash

    def spy(q_shape, k_shape, masked, device_type, dtype, cross=None):
        route = real(q_shape, k_shape, masked, device_type, dtype, cross)
        routes.append((q_shape[-3], k_shape[-3], cross, route))
        return route

    monkeypatch.setattr(attention, "takes_flash", spy)
    spatial = SpatialUNet([unet_case["port"]] * 2, [CPU] * 2)
    with torch.inference_mode():
        spatial(*_port_args(unet_case))
    selfs = [r for r in routes if r[2] is False]
    assert selfs and all(sq * 2 == sk and route
                         for sq, sk, _, route in selfs)
    assert all(not route for sq, sk, cross, route in routes
               if cross is None and sq != sk)


def test_spatial_rows_must_split_at_every_level(unet_case):
    x, t, ctx, *add = _port_args(unet_case)
    spatial = SpatialUNet([unet_case["port"]] * 4, [CPU] * 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        spatial(x[:, :28], t, ctx, *add)


def _with_unet(cfg, **unet_kw):
    return cfg.replace(models=dataclasses.replace(
        cfg.models, unet=dataclasses.replace(cfg.models.unet, **unet_kw)))


@pytest.mark.parametrize("build", ["fused_conv", "w8a8", "int8"])
def test_sp_refuses_fused_and_quantized_unets(build):
    """Under sp > 1 the fused-conv, W8A8 and weights-only int8 UNets
    raise, naming the ROADMAP item: the pipeline at its construction, and
    a built module given to SpatialUNet."""
    cfg = _with_unet(port_test_config(), fused_conv=True)
    if build == "w8a8":
        cfg = cfg.replace(models=dataclasses.replace(cfg.models,
                                                     unet_w8a8=True))
    elif build == "int8":
        cfg = cfg.replace(models=dataclasses.replace(
            cfg.models, unet_int8=True,
            unet=dataclasses.replace(cfg.models.unet, fused_conv=False)))
    mesh = make_mesh(MeshConfig(dp=1, sp=2), ["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="item 16"):
        Text2ImagePipeline(cfg, device="cpu", mesh=mesh)
    unet = UNet(cfg.models.unet)
    if build == "w8a8":
        quant.w8a8_modules(unet)
    elif build == "int8":
        quant.int8_modules(unet, partial(quant.default_predicate,
                                         min_size=0))
    with pytest.raises(NotImplementedError, match="item 16"):
        check_spatial(unet)
    with pytest.raises(NotImplementedError, match="item 16"):
        SpatialUNet([unet] * 2, [CPU] * 2)
    # dp alone serves them as replicas
    Text2ImagePipeline(cfg, device="cpu",
                       mesh=make_mesh(MeshConfig(dp=2), ["cpu"] * 2))


SAMPLERS = {
    "ddim": {},
    "deepcache": {"deepcache": True},
    "encprop": {"encprop": True, "encprop_stride": 2,
                "encprop_dense_steps": 1},
}


@pytest.mark.parametrize("model,sampler", [("sd15", "ddim"),
                                           ("sd15", "deepcache"),
                                           ("sd15", "encprop"),
                                           ("sdxl", "ddim")])
def test_sp_pipeline_images_near_meshless(model, sampler):
    """A dp x sp = 1 x 2 pipeline (and 2 x 2 for plain DDIM) over the
    meshless pipeline's models, the same x_T: the sampler loops ride the
    partitioned forward, and the images stay within the slice's bar (2
    levels, mean <= 0.5) of the meshless ones; uint8 with std > 0."""
    base = CONFIGS[model][1]()
    cfg = base.replace(sampler=dataclasses.replace(base.sampler,
                                                   **SAMPLERS[sampler]))
    cls = SDXLPipeline if model == "sdxl" else Text2ImagePipeline
    ref = cls(cfg, device="cpu")
    prompts = ["a lighthouse at dusk", "a comet over the harbor"]
    meshes = [(1, 2)] + ([(2, 2)] if sampler == "ddim" else [])
    want = ref.generate(prompts, seed=5)
    for dp, sp in meshes:
        pipe = cls(cfg, device="cpu", share_params_with=ref,
                   mesh=make_mesh(MeshConfig(dp=dp, sp=sp),
                                  ["cpu"] * (dp * sp)))
        got = pipe.generate(prompts, seed=5)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.std() > 0
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 2 and diff.mean() <= 0.5, (dp, sp, diff.max())
        assert all(isinstance(v.unet, SpatialUNet)
                   for v in pipe._mesh_positions())
