"""Port parity of weights-only int8 (``unet_int8``, ``lm_int8``) and the
fp8 leaves, on the CPU.

Inputs and reference parameter trees are made with numpy from a seed and
fed to both sides. Tolerances, each with its reason:
- the int8 data and scales, their dequantized weights, the quantized
  files and the fp8 grids are bit-identical: the same fp32 divides,
  half-to-even rounding, and e4m3 round-to-nearest-even;
- the int8 LM decodes give the reference's tokens exactly (greedy
  argmax over the same dequantized weights);
- the int8 UNet's output is held within 1e-4 of max |output|: both sides
  run fp32 on bit-identical dequantized weights, so only summation order
  differs (measured below 1e-6);
- the fp8 dense and conv within 1e-5 of max |output|: the same fp8
  operands, fp32 products and sums in another order.
The test geometries hold no weight of 65,536 elements, so the weights-only
predicate's floor is lowered to 0 on both sides where a model is
quantized; the predicate itself is held at its real floor on the
published widths, on shapes alone.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.mistral import MistralLM as JMistral
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.ops import quant as jq
from cassmantle_tpu.ops import quant_matmul as jqm
from cassmantle_tpu.serving import pipeline as jax_pipeline
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.mistral import MistralLM
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.weights import (
    from_jax,
    load_safetensors,
    save_safetensors,
    state_dict_from_tree,
)
from cassmantle_tpu_torch.ops import quant, quant_matmul
from cassmantle_tpu_torch.serving import pipeline as port_pipeline
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    Text2ImagePipeline,
    build_streamed,
)

from _torch_port_common import assert_rel, jax_params, load, randn

SEEDS = ["The Night the Trains Sang", "Chapter two: the harbor"]


def _ref_pred0(path, leaf):
    """The reference's predicate with its element floor at 0."""
    name = str(path[-1]) if path else ""
    return "kernel" in name and hasattr(leaf, "ndim") and leaf.ndim >= 2


_PORT_PRED = quant.default_predicate


@pytest.fixture
def floor0(monkeypatch):
    """Both packages' weights-only predicate with no element floor (the
    test geometries' weights are all below 65,536 elements)."""
    monkeypatch.setattr(jq, "default_predicate", _ref_pred0)
    monkeypatch.setattr(quant, "default_predicate",
                        partial(_PORT_PRED, min_size=0))


def np_(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# -- the tensor ---------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((3, 3, 16, 24), -1),
                                        ((24, 16, 3, 3), 0), ((5, 7), 0)])
def test_quantize_tensor_and_dequantize_are_bit_identical(shape, axis):
    w = randn(np.random.default_rng(sum(shape)), *shape) * 0.1
    w[(slice(None),) * (axis % len(shape)) + (1,)] = 0.0   # scale 1 there
    ref = jq.quantize_tensor(jnp.asarray(w), axis)
    q = quant.quantize_tensor(torch.from_numpy(w), axis)
    np.testing.assert_array_equal(np_(q.data), np.asarray(ref.data))
    np.testing.assert_array_equal(np_(q.scale), np.asarray(ref.scale))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            np_(q.dequantize(dt).float()),
            np.asarray(ref.dequantize(jdt).astype(jnp.float32)))
    data, scale = q                      # unpacks as the W8A8 code does
    assert data.dtype == torch.int8 and scale.dtype == torch.float32
    # a bf16 weight quantizes from its bf16 values, as cast_to then
    # quantize_tree_host does
    wb = torch.from_numpy(w).bfloat16()
    refb = jq.quantize_tensor(jnp.asarray(w).astype(jnp.bfloat16), axis)
    np.testing.assert_array_equal(np_(quant.quantize_tensor(wb, axis).data),
                                  np.asarray(refb.data))


def test_error_and_bytes_helpers():
    w = randn(np.random.default_rng(3), 128, 96)
    assert quant.quantization_error(torch.from_numpy(w)) == pytest.approx(
        jq.quantization_error(jnp.asarray(w)), rel=1e-5)
    lin = torch.nn.Linear(256, 256, bias=False)
    fp = quant.tree_nbytes(lin)
    from cassmantle_tpu_torch.models.layers import Dense

    dense = Dense(256, 256, use_bias=False)
    dense.weight.data.copy_(lin.weight.data)
    assert quant.int8_modules(dense) == 1
    assert quant.tree_nbytes(dense) == 256 * 256 + 256 * 4
    assert quant.tree_nbytes(dense) < fp / 3


# -- the predicate at published widths ---------------------------------------

def _reference_selection(module, *args):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a), *args)
    out = set()

    def visit(path, leaf):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        if jq.default_predicate(keys, leaf):
            out.add("/".join(keys[1:-1]))       # the module's path
        return leaf

    jax.tree_util.tree_map_with_path(visit, shapes)
    return out


def _port_selection(factory):
    with torch.device("meta"):
        model = factory()
    return {name.replace(".", "/") for name, m in model.named_modules()
            if quant.default_predicate(tuple(name.split(".")), m)}


def _model_case(which):
    jc, pc = jax_config, port_config
    if which == "gpt2":
        j, p = jc.FrameworkConfig().models.gpt2, pc.FrameworkConfig().models.gpt2
        return JGPT2(j), partial(GPT2LM, p), (jnp.zeros((1, 8), jnp.int32),)
    if which == "mistral":
        return (JMistral(jc.MistralConfig()),
                partial(MistralLM, pc.MistralConfig()),
                (jnp.zeros((1, 8), jnp.int32),))
    j = (jc.FrameworkConfig() if which == "unet" else jc.sdxl_config()).models
    p = (pc.FrameworkConfig() if which == "unet" else pc.sdxl_config()).models
    hw = 8
    args = [jnp.zeros((1, hw, hw, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, j.unet.context_dim))]
    if j.unet.addition_embed_dim:
        args.append(jnp.zeros((1, j.unet.addition_embed_dim)))
    return JUNet(j.unet), partial(UNet, p.unet), tuple(args)


@pytest.mark.parametrize("which", ["gpt2", "mistral", "unet", "sdxl_unet"])
def test_predicate_selects_the_reference_leaf_set(which):
    """At the published widths (shapes only): the port's predicate picks
    the modules whose Flax ``kernel`` the reference's picks, with its
    65,536-element floor; embeddings (GPT-2's tied ``wte``, Mistral's
    ``embed``) and norm scales stay fp."""
    ref_mod, factory, args = _model_case(which)
    ref = _reference_selection(ref_mod, *args)
    port = _port_selection(factory)
    assert port == ref, sorted(port ^ ref)
    assert ref and not any(k.split("/")[-1] in ("wte", "wpe", "embed")
                           for k in port)


# -- files --------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt2", "mistral"])
def test_quantized_files_load_across_packages(family, tmp_path, floor0):
    """A file the reference's ``save_quantized`` wrote loads in the port
    (the int8 buffers equal from_jax of the reference's tree), and the
    port's ``save_quantized`` of that model writes what the reference's
    ``load_quantized`` reads back as its own tree, bit for bit, keys and
    layouts included."""
    if family == "gpt2":
        jm = jax_config.test_config().models.gpt2
        pm = port_config.test_config().models.gpt2
        ref_mod, factory = JGPT2(jm), partial(GPT2LM, pm)
    else:
        jm, pm = jax_config.MistralConfig.tiny(), port_config.MistralConfig.tiny()
        ref_mod, factory = JMistral(jm), partial(MistralLM, pm)
    params = jax_params(ref_mod, 61, jnp.zeros((1, 8), jnp.int32))
    tree = jq.quantize_tree(params)
    assert jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jq.QTensor))
    ref_path = str(tmp_path / "ref.int8.safetensors")
    jq.save_quantized(tree, ref_path)
    sd = state_dict_from_tree(quant.load_quantized(ref_path))
    model = build_streamed(factory, family, torch.device("cpu"), 0, sd)
    want = from_jax(family, tree)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    port_path = str(tmp_path / "port.int8.safetensors")
    quant.save_quantized(model, port_path)
    back = jq.load_quantized(port_path)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jq.QTensor)))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(
        back, is_leaf=lambda x: isinstance(x, jq.QTensor)))
    assert set(map(str, flat_ref)) == set(map(str, flat_back))
    by_name = {str(k): v for k, v in flat_back.items()}
    for k, v in flat_ref.items():
        b = by_name[str(k)]
        if isinstance(v, jq.QTensor):
            assert isinstance(b, jq.QTensor), k
            np.testing.assert_array_equal(np.asarray(b.data),
                                          np.asarray(v.data))
            np.testing.assert_array_equal(np.asarray(b.scale),
                                          np.asarray(v.scale))
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(v))


def test_safetensors_writer_is_the_format(tmp_path):
    """The port's writer against the safetensors package's reader, every
    dtype a weights file carries."""
    from safetensors.torch import load_file

    ts = {"a": torch.randn(3, 5), "b": torch.randn(4).bfloat16(),
          "c": torch.randint(-127, 127, (2, 3), dtype=torch.int8),
          "d": torch.randn(2, 2).half(), "e": torch.zeros(0),
          "s": torch.tensor(1.5)}
    path = str(tmp_path / "x.safetensors")
    save_safetensors(ts, path)
    for read in (load_file(path), load_safetensors(path)):
        assert set(read) == set(ts)
        for k, v in ts.items():
            assert read[k].dtype == v.dtype and torch.equal(read[k], v), k


# -- serving ------------------------------------------------------------------

def _int8_cfg(module, family):
    cfg = module.test_config()
    m = dataclasses.replace(cfg.models, lm_int8=True)
    if family == "mistral":
        m = dataclasses.replace(m, mistral=module.MistralConfig.tiny())
    return cfg.replace(models=m)


@pytest.mark.parametrize("family", ["gpt2", "mistral"])
def test_lm_int8_decodes_give_the_reference_tokens(family, floor0):
    """PromptGenerator under lm_int8 from the fp weights of the
    reference's own int8 generator: the port quantizes the same int8
    values (on the host, submodule by submodule) and its greedy decode
    gives the reference's tokens, lengths and text."""
    ref = jax_pipeline.PromptGenerator(_int8_cfg(jax_config, family))
    fp_ref = jax_pipeline.PromptGenerator(dataclasses.replace(
        _int8_cfg(jax_config, family), models=dataclasses.replace(
            _int8_cfg(jax_config, family).models, lm_int8=False)))
    port = PromptGenerator(_int8_cfg(port_config, family), "cpu",
                           from_jax(family, jax.device_get(fp_ref.params)))
    want = from_jax(family, jax.device_get(ref.params))
    got = port.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v.to(got[k].dtype)) for k, v in
               want.items() if k.endswith(("weight_q8", "weight_q8_scale")))
    assert quant.int8_site_count(port.model) == sum(
        k.endswith("weight_q8") for k in want) > 0
    toks, lens = port.decode_ids_batch(SEEDS)
    ref_toks, ref_lens = ref.decode_ids_batch(SEEDS)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    assert port.generate(SEEDS[1]) == ref.generate(SEEDS[1])


def test_lm_int8_file_is_written_read_back_and_checked(tmp_path, floor0):
    """``save_quantized`` writes ``gpt2.int8.safetensors``; an lm_int8
    build from that directory reads it (same buffers, same tokens); with
    no fp source it is not real weights; a newer fp checkpoint makes it
    stale (None: the fp path); lm_int8 with lm_w8a8 raises."""
    cfg = _int8_cfg(port_config, "gpt2")
    gen = PromptGenerator(cfg, "cpu", weights_dir=str(tmp_path))
    path = gen.save_quantized()
    assert path == str(tmp_path / "gpt2.int8.safetensors")
    again = PromptGenerator(cfg, "cpu", weights_dir=str(tmp_path))
    a, b = gen.model.state_dict(), again.model.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not again.loaded_real_weights
    np.testing.assert_array_equal(gen.decode_ids_batch(SEEDS)[0],
                                  again.decode_ids_batch(SEEDS)[0])
    assert again.int8_from_file and not gen.int8_from_file
    assert again._load_int8_checkpoint("gpt2") is not None
    fp = tmp_path / "gpt2.safetensors"
    fp.write_bytes(b"")
    later = os.path.getmtime(path) + 10
    os.utime(fp, (later, later))
    assert again._load_int8_checkpoint("gpt2") is None
    with pytest.raises(AssertionError, match="mutually exclusive"):
        PromptGenerator(cfg.replace(models=dataclasses.replace(
            cfg.models, lm_w8a8=True)), "cpu")
    plain = PromptGenerator(port_config.test_config(), "cpu")
    with pytest.raises(AssertionError, match="lm_int8"):
        plain.save_quantized(str(tmp_path / "x.safetensors"))


def test_bf16_quantized_file_reads_back(tmp_path, floor0):
    """An lm_int8 LM stored in bf16 (the serving dtype): its file's bf16
    tensors read back into the same buffers (the int8 file is read, not
    re-quantized)."""
    cfg = _int8_cfg(port_config, "mistral")
    cfg = cfg.replace(models=dataclasses.replace(cfg.models,
                                                 param_dtype="bfloat16"))
    gen = PromptGenerator(cfg, "cpu", weights_dir=str(tmp_path))
    assert gen.model.embed.weight.dtype == torch.bfloat16
    gen.save_quantized()
    again = PromptGenerator(cfg, "cpu", weights_dir=str(tmp_path))
    assert again.int8_from_file
    a, b = gen.model.state_dict(), again.model.state_dict()
    assert set(a) == set(b)
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)


@pytest.fixture(scope="module")
def unet_case():
    jm = jax_config.test_config().models
    rng = np.random.default_rng(9)
    lat, ctx = randn(rng, 2, 8, 8, 4), randn(rng, 2, 16, jm.unet.context_dim)
    t = np.array([981, 21], dtype=np.int32)
    mod = JUNet(jm.unet)
    params = jax_params(mod, 9, jnp.asarray(lat), jnp.asarray(t),
                        jnp.asarray(ctx))
    return dict(mod=mod, params=params, args=(lat, t, ctx))


@pytest.mark.parametrize("fused", [False, True])
def test_int8_unet_matches_quantized_apply(unet_case, fused, monkeypatch):
    """The port's UNet with its weights-only int8 transform (fused conv
    on or off) against the reference's ``quantized_apply`` forward of its
    ``quantize_tree``: the same int8 buffers, outputs within 1e-4."""
    monkeypatch.setenv("CASSMANTLE_NO_FUSED_CONV", "1")   # reference: lax
    mod, params, args = (unet_case[k] for k in ("mod", "params", "args"))
    tree = jq.quantize_tree(params, predicate=_ref_pred0)
    ref = np.asarray(jq.quantized_apply(mod.apply, jnp.float32)(
        tree, *map(jnp.asarray, args)))
    monkeypatch.delenv("CASSMANTLE_NO_FUSED_CONV")
    ucfg = dataclasses.replace(port_config.test_config().models.unet,
                               fused_conv=fused)
    port = load(UNet(ucfg), params, "unet")
    n = quant.int8_modules(port, partial(_PORT_PRED, min_size=0))
    assert n == len([1 for leaf in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jq.QTensor))
        if isinstance(leaf, jq.QTensor)])
    want = from_jax("unet", tree)
    got = port.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want
               if k.endswith("weight_q8"))
    with torch.no_grad():
        out = port(*map(torch.from_numpy, args))
    assert_rel(out, ref, 1e-4)


def test_unet_int8_pipeline_serves_with_bf16_products(floor0):
    """Text2ImagePipeline under unet_int8: the UNet built submodule by
    submodule with its weights int8, an image served, no kernel counted
    as int8 by the cost model (each product runs in the compute dtype on
    the dequantized weight), the same counts as the fp build's; W8A8
    with int8 raises."""
    base = port_config.test_config()
    cfg = base.replace(models=dataclasses.replace(base.models,
                                                  unet_int8=True))
    pipe = Text2ImagePipeline(cfg, device="cpu")
    assert quant.int8_site_count(pipe.unet) > 0
    assert not any(isinstance(p, torch.nn.Parameter) and "weight" in n
                   and quant.int8_weight(pipe.unet.get_submodule(
                       n.rsplit(".", 1)[0])) is not None
                   for n, p in pipe.unet.named_parameters())
    img = pipe.generate(["a lighthouse"], seed=3)
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8
    fp = Text2ImagePipeline.shape_twin(base).image_products()
    q8 = Text2ImagePipeline.shape_twin(cfg).image_products()
    assert q8 == fp and q8.int8 == 0
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_pipeline.w8a8_unet_tools(dataclasses.replace(
            cfg.models, unet_w8a8=True,
            unet=dataclasses.replace(cfg.models.unet, fused_conv=True)))


def test_commands_and_the_server_flag(tmp_path, monkeypatch, capsys,
                                      floor0):
    """``quantize-weights`` builds on the card unless asked for the CPU
    (without CUDA it raises) and writes the int8 file where ``--weights``
    says; ``lm-int8-ab`` prints one JSON line labelled seeded (not real)
    weights; ``serve --lm-int8`` builds the reference server's config."""
    import json

    from cassmantle_tpu_torch import __main__ as cli
    from cassmantle_tpu_torch.server import app as papp
    from cassmantle_tpu_torch.tools import lm_int8_ab, quantize_weights

    monkeypatch.setattr(quantize_weights, "quantized_config",
                        lambda lm: _int8_cfg(port_config, lm))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["quantize-weights", "--weights", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    assert cli.main(["quantize-weights", "--weights", str(tmp_path),
                     "--lm", "mistral", "--platform", "cpu"]) == 0
    assert (tmp_path / "mistral.int8.safetensors").exists()
    capsys.readouterr()
    assert cli.main(["lm-int8-ab", "--tiny", "--platform", "cpu",
                     "--tokens", "4", "--reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "lm_int8_decode_ab_gpt2"
    assert line["real_weights"] is False
    assert all("decode_ms_per_token" in line[arm] for arm in ("fp", "int8"))
    # each arm in this process (the children's predicate keeps its
    # 65,536-element floor, which no tiny weight reaches)
    fp, q8 = (lm_int8_ab.measure_arm(PromptGenerator(
        lm_int8_ab.build_cfg("gpt2", True, int8), "cpu"), 4, 1)
        for int8 in (False, True))
    rep = lm_int8_ab.report(fp, q8, "gpt2", 4, True)
    assert q8["quantized_leaves"] > 0 == fp["quantized_leaves"]
    assert rep["param_shrink"] < 1 and rep["real_weights"] is False
    assert cli.main(["lm-int8-ab", "--weights", str(tmp_path / "nope")]) \
        == 2
    cfg = papp._config_for(papp.parse_args(["--lm-int8", "--lm",
                                            "mistral"]))
    assert cfg.models.lm_int8 and cfg.models.mistral is not None
    assert not papp._config_for(papp.parse_args([])).models.lm_int8


# -- fp8 ----------------------------------------------------------------------

@pytest.mark.parametrize("per_token", [False, True])
def test_fp8_quantize_is_bit_identical(per_token):
    """quantize_act and quantize_tensor_act on the e4m3 grid: the scales,
    the fp8 bits and the clip at +-448 as the reference's."""
    rng = np.random.default_rng(5)
    x = randn(rng, 6, 40) * 3.0
    x[0, 0] = 1e4                                # clipped
    s = jq.act_scale_from_absmax(jq.act_absmax(jnp.asarray(x), per_token),
                                 jnp.float8_e4m3fn)
    ps = quant.act_scale_from_absmax(
        quant.act_absmax(torch.from_numpy(x), per_token),
        torch.float8_e4m3fn)
    np.testing.assert_array_equal(np_(ps), np.asarray(s))
    for scale_p, scale_j in ((ps, s), (torch.tensor(0.01), 0.01)):
        ref = jq.quantize_act(jnp.asarray(x), scale_j, jnp.float8_e4m3fn)
        got = quant.quantize_act(torch.from_numpy(x), scale_p,
                                 torch.float8_e4m3fn)
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy(),
            np.asarray(ref).view(np.uint8))
    w = randn(rng, 3, 3, 16, 24) * 0.2
    w[..., 3] = 0.0
    ref = jq.quantize_tensor_act(jnp.asarray(w), act_scale=0.5,
                                 dtype=jnp.float8_e4m3fn)
    got = quant.quantize_tensor_act(torch.from_numpy(w), act_scale=0.5,
                                    dtype=torch.float8_e4m3fn)
    np.testing.assert_array_equal(got.data.view(torch.uint8).numpy(),
                                  np.asarray(ref.data).view(np.uint8))
    np.testing.assert_array_equal(np_(got.scale),
                                  np.asarray(ref.scale).reshape(-1))
    assert float(got.act_scale) == float(ref.act_scale)
    assert quant.qmax_for(torch.float8_e4m3fn) == jq.qmax_for(
        jnp.float8_e4m3fn) == 448.0


@pytest.mark.parametrize("mode", ["dynamic", "static", "per_token"])
def test_fp8_dense_matches_the_reference_dot(mode):
    rng = np.random.default_rng(11)
    x, w, b = randn(rng, 2, 9, 48), randn(rng, 48, 32) * 0.1, \
        randn(rng, 32) * 0.1
    act = 0.02 if mode == "static" else None
    jqt = jq.quantize_tensor_act(jnp.asarray(w), act_scale=act,
                                 dtype=jnp.float8_e4m3fn)
    pq = quant.ActQTensor(torch.from_numpy(np.asarray(jqt.data).view(
        np.uint8)).view(torch.float8_e4m3fn),
        torch.from_numpy(np.asarray(jqt.scale).reshape(-1)),
        None if act is None else torch.tensor(act))
    ref = np.asarray(jqm.w8a8_dense(jnp.asarray(x), jqt, jnp.asarray(b),
                                    per_token=mode == "per_token"))
    out = quant_matmul.w8a8_dense(torch.from_numpy(x), pq,
                                  torch.from_numpy(b),
                                  per_token=mode == "per_token")
    assert_rel(out, ref, 1e-5)


def test_fp8_conv_matches_the_reference_conv():
    rng = np.random.default_rng(12)
    x = randn(rng, 2, 6, 6, 16)
    a, b = randn(rng, 2, 16) * 0.5 + 1.0, randn(rng, 2, 16) * 0.5
    w, bias = randn(rng, 3, 3, 16, 24) / 12.0, randn(rng, 24) * 0.1
    jqt = jq.quantize_tensor_act(jnp.asarray(w), dtype=jnp.float8_e4m3fn)
    pq = quant.ActQTensor(torch.from_numpy(np.asarray(jqt.data).view(
        np.uint8)).view(torch.float8_e4m3fn),
        torch.from_numpy(np.asarray(jqt.scale).reshape(-1)), None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqm, "int8_conv_ok", lambda *a: False)
        ref = np.asarray(jqm.gn_silu_conv3x3_w8a8(
            *map(jnp.asarray, (x, a, b)), jqt, jnp.asarray(bias)))
    out = quant_matmul.gn_silu_conv3x3_w8a8(
        *map(torch.from_numpy, (x, a, b)), pq, torch.from_numpy(bias))
    assert_rel(out, ref, 1e-5)
