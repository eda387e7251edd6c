"""The port's cost model (``cassmantle_tpu_torch/obs/costmodel.py``) held
against the reference's (``cassmantle_tpu/obs/costmodel.py``).

At ``test_config()`` sizes each preset's per-image count, walked on the
meta twins of the port pipeline's models, equals the reference's
``trace_cost`` of its own jitted sampler (what its pipelines attribute),
for every sampler loop and for SDXL: both count every matmul,
convolution and attention product (the reference's attention on its
CPU route, the port's through the flash wrapper's meta path).

At full width, on meta tensors only, against ``data/cost_model.json``
(the reference's committed counts): ``t2i``, ``t2i_lcm`` and ``sdxl``
equal to the operation; W8A8 counts the same products as bf16, with
the quantized sites' share in the int8 class, where the committed
``t2i_w8a8`` omits exactly the int8 3x3 convs' products (the bodies of
its ``pallas_call``s, which ``trace_cost`` does not enter); the prompt
LM within 0.1% a token at the round's bucket; and the scorer, where the
reference's ``2 * params * tokens`` counts the embedding tables and the
norms' and biases' parameters as products and no attention, each class
stated.
"""

import dataclasses
import json
import math
import os

import pytest
import torch

import cassmantle_tpu.config as jconfig
import cassmantle_tpu_torch.config as pconfig
from cassmantle_tpu.serving.pipeline import Text2ImagePipeline as JText2Image
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu_torch.models.minilm import MiniLMEncoder
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    Text2ImagePipeline,
    w8a8_unet_tools,
)
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

COST_MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "cost_model.json")
SAMPLERS = {
    "ddim": {},
    "deepcache": dict(deepcache=True),
    "encprop": dict(encprop=True, num_steps=8, encprop_stride=3,
                    encprop_dense_steps=2),
    "dpmpp_2m": dict(kind="dpmpp_2m"),
    "euler": dict(kind="euler"),
    "consistency": dict(consistency=True, consistency_available=True),
}


@pytest.fixture(scope="module")
def committed():
    with open(COST_MODEL) as f:
        return json.load(f)["pipelines"]


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    for var in ("CASSMANTLE_CHIP_TFLOPS", "CASSMANTLE_NO_W8A8",
                "CASSMANTLE_NO_CONSISTENCY", "CASSMANTLE_NO_ENCPROP"):
        monkeypatch.delenv(var, raising=False)
    costmodel.reset_cache()
    yield
    costmodel.reset_cache()


def _with_sampler(config, base, **changes):
    cfg = base()
    return cfg.replace(sampler=dataclasses.replace(cfg.sampler, **changes))


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_test_size_counts_equal_the_references_trace_cost(sampler):
    """One image's products under each sampler loop: the port's meta walk
    of its pipeline's encode, denoise and decode equals the reference's
    trace of its jitted sampler, to the operation."""
    jcfg = _with_sampler(jconfig, jconfig.test_config, **SAMPLERS[sampler])
    pcfg = _with_sampler(pconfig, pconfig.test_config, **SAMPLERS[sampler])
    ref = JText2Image(jcfg)
    want = ref._dispatch_flops(ref._sample, jcfg.sampler)
    port = Text2ImagePipeline(pcfg, device="cpu")
    got = port.image_products()
    assert want and got.total == want
    # test_config is fp32 throughout: one class
    assert got.fp32 == got.total
    # the same count from the config alone, nothing built
    assert Text2ImagePipeline.shape_twin(pcfg).image_products() == got


def test_test_size_sdxl_count_equals_the_references():
    jcfg, pcfg = jconfig.test_sdxl_config(), pconfig.test_sdxl_config()
    ref = JSDXL(jcfg)
    want = ref._dispatch_flops(ref._sample, jcfg.sampler)
    got = SDXLPipeline(pcfg, device="cpu").image_products()
    assert want and got.total == want


@pytest.mark.parametrize("cls, preset, entry", [
    (Text2ImagePipeline, "FrameworkConfig", "t2i"),
    (Text2ImagePipeline, "lcm_serving_config", "t2i_lcm"),
    (SDXLPipeline, "sdxl_config", "sdxl"),
])
def test_full_width_counts_equal_the_committed_entries(cls, preset, entry,
                                                       committed):
    """The served presets at published width, counted on meta tensors in
    seconds: equal to the reference's committed per-image FLOPs."""
    cfg = getattr(pconfig, preset)()
    got = cls.shape_twin(cfg).image_products()
    assert got.total == committed[entry]["flops_per_item"]
    assert got.int8 == 0 and got.bf16 > 0.99 * got.total


def _int8_conv_products(cfg) -> float:
    """Per UNet forward at the CFG batch: the products of the int8 3x3
    convs (kernel 4's sites), split out of the count by op."""
    conv = {"ops": 0.0}

    class Split(costmodel.ProductCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.ops["int8"]
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.overloadpacket is torch.ops.aten.convolution:
                conv["ops"] += self.ops["int8"] - before
            return out

    unet = costmodel.meta_module(lambda: UNet(cfg.models.unet))
    w8a8_unet_tools(cfg.models)(unet)
    size = cfg.sampler.image_size // 8
    counter = Split()
    with torch.no_grad(), counter:
        unet(torch.zeros((2, size, size, 4), device="meta"),
             torch.zeros((2,), device="meta"),
             torch.zeros((2, 77, cfg.models.unet.context_dim),
                         device="meta"))
    return conv["ops"]


def test_w8a8_counts_the_products_of_bf16(committed):
    """W8A8 runs the same products as bf16, its quantized sites' share
    in the int8 class. The reference's committed ``t2i_w8a8`` is lower by
    exactly the int8 3x3 convs' products over the 50 steps: its count
    does not enter the ``pallas_call`` bodies of kernel 4 (it counts the
    int8 matmuls, and attention on its XLA route)."""
    cfg = pconfig.w8a8_serving_config()
    got = Text2ImagePipeline.shape_twin(cfg).image_products()
    bf16 = Text2ImagePipeline.shape_twin(pconfig.FrameworkConfig()) \
        .image_products()
    assert got.total == bf16.total
    assert got.int8 > 0.6 * got.total and got.fp32 == bf16.fp32
    omitted = _int8_conv_products(cfg) * cfg.sampler.num_steps
    assert got.total - omitted == committed["t2i_w8a8"]["flops_per_item"]
    # the kill switch serves bf16: so counts the signature
    assert costmodel.t2i_signature(cfg) != \
        costmodel.t2i_signature(pconfig.FrameworkConfig())


def test_no_w8a8_switch_counts_the_bf16_path(monkeypatch):
    monkeypatch.setenv("CASSMANTLE_NO_W8A8", "1")
    cfg = pconfig.w8a8_serving_config()
    assert costmodel.t2i_signature(cfg) == costmodel.t2i_signature(
        cfg.replace(models=dataclasses.replace(cfg.models, unet_w8a8=False)))


def test_prompt_lm_per_token_within_a_tenth_of_a_percent(committed):
    """GPT-2's decode of a round's prompt (bucket 32, 96 new tokens) per
    token: the port's products (the linears, the fp32 weight-tied head,
    attention over the static cache) within 0.1% of the reference's
    ``2 * params``; at bucket 64 the port's attention over the longer
    cache puts it above."""
    cfg = pconfig.FrameworkConfig()
    gen = PromptGenerator.shape_twin(cfg)
    entry = committed["prompt"]
    assert entry["flops_per_item"] == 2 * entry["params"]
    row = gen.row_products(32, 96)
    per_token = row.total / (32 + 96)
    assert abs(per_token / entry["flops_per_item"] - 1) < 1e-3
    assert row.fp32 > 0 and row.int8 == 0     # the head runs in fp32
    assert gen.row_products(64, 96).total / (64 + 96) > per_token


def test_scorer_counts_products_where_the_reference_counts_params(
        committed):
    """MiniLM per encoded row at 16 tokens. The reference's figure is
    ``2 * params * tokens``; the port counts the matmuls: every linear's
    weight once a token, and attention (q k^T and p v). The difference,
    class by class: the embedding tables and the norms' and biases'
    parameters (counted by the reference, no product) and attention
    (counted by the port)."""
    cfg = pconfig.FrameworkConfig().models.minilm
    entry = committed["scorer"]
    s = entry["seq_len"]
    twin = costmodel.meta_module(lambda: MiniLMEncoder(cfg))
    params = sum(p.numel() for p in twin.parameters())
    linear = sum(m.weight.numel() for m in twin.modules()
                 if isinstance(getattr(m, "weight", None), torch.Tensor)
                 and m.weight.ndim == 2 and "Embed" not in type(m).__name__)
    attention = 4 * cfg.num_layers * s * s * cfg.hidden_size
    assert entry["params"] == params
    assert entry["flops_per_item"] == 2 * params * s
    got = EmbeddingScorer(cfg, "cpu", seq_len=s).row_products()
    assert got.total == 2 * linear * s + attention
    assert got.fp32 == got.total
    not_products = params - linear
    assert entry["flops_per_item"] - got.total == \
        2 * not_products * s - attention


def test_the_staged_count_is_the_steps_forwards_at_width_one():
    """A staged request's denoise: num_steps CFG forwards at width 1, the
    monolithic image's count less its encode and decode."""
    cfg = pconfig.FrameworkConfig()
    twin = Text2ImagePipeline.shape_twin(cfg)
    staged = twin.staged_denoise_products()
    whole = twin.image_products()
    assert 0.95 * whole.total < staged.total < whole.total


def test_flops_per_item_caches_and_never_raises(caplog):
    calls = []

    def counter():
        calls.append(1)
        return costmodel.Products(bf16=3.0)

    assert costmodel.flops_per_item("k", "s", counter).total == 3.0
    assert costmodel.flops_per_item("k", "s", counter).total == 3.0
    assert len(calls) == 1

    def broken():
        raise RuntimeError("no count")

    assert costmodel.flops_per_item("k", "t", broken) is None
    assert costmodel.cached("k", "t") == (True, None)
    assert costmodel.cached("k", "u") == (False, None)


def test_signatures_follow_the_config():
    base = pconfig.FrameworkConfig()
    other = _with_sampler(pconfig, pconfig.FrameworkConfig, num_steps=30)
    assert costmodel.t2i_signature(base) != costmodel.t2i_signature(other)
    assert costmodel.t2i_signature(base) == costmodel.t2i_signature(
        pconfig.fusedconv_serving_config())        # the same products
    assert costmodel.sdxl_signature(pconfig.sdxl_config()) != \
        costmodel.t2i_signature(pconfig.sdxl_config())
    m = base.models
    assert costmodel.lm_signature(m.gpt2) != costmodel.lm_signature(
        m.gpt2, w8a8=True)
    assert costmodel.scorer_signature(m.minilm, 16) != \
        costmodel.scorer_signature(m.minilm, 32)
    assert math.isclose(costmodel.chip_peak_flops("int8"),
                        2 * costmodel.chip_peak_flops("bf16"), rel_tol=1e-3)
