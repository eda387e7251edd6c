"""The port's LM trainer, data helpers, checkpointer and training CLI.

``cassmantle_tpu_torch/parallel/lm_train.py`` and ``utils/data.py``
against the reference's, at the tiny GPT-2 of ``test_config()`` and
``MistralConfig.tiny()`` (fp32, CPU), on the same seeded numpy weights
and rows. Tolerances: ``next_token_loss`` within rtol 1e-6; LM losses
over three steps within rtol 1e-4; remat equal to the plain step within
1e-6; a resumed run's losses equal to the uninterrupted run's (the CPU
is deterministic: exact).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import MistralConfig as JMistralConfig
from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.mistral import MistralLM as JMistral
from cassmantle_tpu.parallel import lm_train as jlm
from cassmantle_tpu.utils import data as jdata
from cassmantle_tpu_torch import __main__ as cli
from cassmantle_tpu_torch.config import MistralConfig
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.mistral import MistralLM
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.parallel import lm_train as plm
from cassmantle_tpu_torch.utils import data as pdata
from cassmantle_tpu_torch.utils.checkpoint import TrainCheckpointer

from _torch_port_common import assert_grads, assert_rel, jax_params

ENC = lambda s: [ord(c) % 250 for c in s]  # noqa: E731
DATA = (jdata, pdata)


# -- the data helpers (tests/test_lm_train.py's cases, on both packages) ------

@pytest.mark.parametrize("mod", DATA, ids=("reference", "port"))
def test_pack_tokens_dense_rows(mod):
    packed = mod.pack_tokens(["abc", "defg"], ENC, seq_len=4, eos_id=255)
    ids, mask = packed["input_ids"], packed["loss_mask"]
    assert ids.shape == (3, 4) and mask.shape == (3, 4)
    assert ids[0].tolist() == [ord("a") % 250, ord("b") % 250,
                               ord("c") % 250, 255]
    assert mask[:2].min() == 1
    assert mask[2].tolist() == [1, 0, 0, 0]
    assert ids[2, 1:].tolist() == [255, 255, 255]
    ref = jdata.pack_tokens(["abc", "defg"], ENC, seq_len=4, eos_id=255)
    for k in ref:
        assert np.array_equal(packed[k], ref[k]) and packed[k].dtype == \
            ref[k].dtype


@pytest.mark.parametrize("mod", DATA, ids=("reference", "port"))
def test_pack_tokens_empty(mod):
    packed = mod.pack_tokens([], ENC, seq_len=8, eos_id=1)
    assert packed["input_ids"].shape == (0, 8)
    assert packed["loss_mask"].shape == (0, 8)


@pytest.mark.parametrize("mod", DATA, ids=("reference", "port"))
def test_batches_from_epochs_and_shapes(mod):
    packed = mod.pack_tokens(["hello world"] * 10, ENC, seq_len=4,
                             eos_id=255)
    batches = list(mod.batches_from(packed, 8, epochs=2, seed=1))
    n = packed["input_ids"].shape[0]
    assert len(batches) == 2 * (n // 8)
    assert all(b["input_ids"].shape == (8, 4) for b in batches)
    packed2 = {"input_ids": np.arange(64, dtype=np.int32).reshape(16, 4),
               "loss_mask": np.ones((16, 4), np.int32)}
    two = list(mod.batches_from(packed2, 8, epochs=2, seed=3))
    e1 = np.concatenate([b["input_ids"] for b in two[:2]])
    e2 = np.concatenate([b["input_ids"] for b in two[2:]])
    assert e1.shape == e2.shape and not np.array_equal(e1, e2)
    two_ns = list(mod.batches_from(packed2, 8, epochs=2, shuffle=False))
    np.testing.assert_array_equal(two_ns[0]["input_ids"],
                                  two_ns[2]["input_ids"])
    # the same seed draws the same batches in both packages
    ref = list(jdata.batches_from(packed2, 8, epochs=2, seed=3))
    for a, b in zip(two, ref):
        assert np.array_equal(a["input_ids"], b["input_ids"])


@pytest.mark.parametrize("mod", DATA, ids=("reference", "port"))
def test_prefetch_loader_order_and_error(mod):
    batches = [{"x": np.full((2,), i)} for i in range(5)]
    out = list(mod.PrefetchLoader(batches, depth=2))
    assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3, 4]

    def bad():
        yield {"x": np.zeros(1)}
        raise RuntimeError("boom")

    loader = mod.PrefetchLoader(bad())
    next(loader)
    with pytest.raises(RuntimeError, match="boom"):
        next(loader)


@pytest.mark.parametrize("mod", DATA, ids=("reference", "port"))
def test_batches_from_rejects_undersized_corpus(mod):
    packed = mod.pack_tokens(["ab"], ENC, seq_len=4, eos_id=255)
    with pytest.raises(ValueError, match="batch_size"):
        next(mod.batches_from(packed, 8))


@pytest.mark.parametrize("mod", DATA, ids=("reference", "port"))
def test_prefetch_loader_exhaustion_is_sticky(mod):
    loader = mod.PrefetchLoader([{"x": np.zeros(1)}])
    assert len(list(loader)) == 1
    with pytest.raises(StopIteration):
        next(loader)
    with pytest.raises(StopIteration):
        next(loader)


def test_prefetch_loader_places_batches_on_its_thread():
    import threading

    seen = []

    def place(b):
        seen.append(threading.current_thread().name)
        return {k: torch.as_tensor(v) for k, v in b.items()}

    out = list(pdata.PrefetchLoader([{"x": np.ones(2)}] * 3, place=place))
    assert seen == ["data-prefetch"] * 3
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


# -- the loss -----------------------------------------------------------------

def test_next_token_loss_masks_padding():
    v = 16
    ids = np.asarray([[1, 2, 3, 0]], dtype=np.int32)
    logits = np.zeros((1, 4, v), np.float32)
    peaked = logits.copy()
    peaked[0, 2, 0] = 10.0          # predicts the target at position 3
    full_mask = np.ones((1, 4), np.int32)
    pad_mask = np.asarray([[1, 1, 1, 0]], np.int32)
    t = torch.from_numpy
    full = plm.next_token_loss(t(logits), t(ids), t(full_mask))
    np.testing.assert_allclose(float(full), np.log(v), rtol=1e-5)
    m_all = plm.next_token_loss(t(peaked), t(ids), t(full_mask))
    m_pad = plm.next_token_loss(t(peaked), t(ids), t(pad_mask))
    assert float(m_pad) > float(m_all)
    for lg, mk in ((logits, full_mask), (peaked, full_mask),
                   (peaked, pad_mask)):
        ref = jlm.next_token_loss(jnp.asarray(lg), jnp.asarray(ids),
                                  jnp.asarray(mk))
        np.testing.assert_allclose(
            float(plm.next_token_loss(t(lg), t(ids), t(mk))), float(ref),
            rtol=1e-6)
    # an all-zero mask divides by one, not zero
    assert float(plm.next_token_loss(t(peaked), t(ids),
                                     t(np.zeros_like(pad_mask)))) == 0.0


def test_masked_ce_matches_reference_on_random_logits():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (3, 5)).astype(np.int32)
    ref = jlm.masked_ce(jnp.asarray(logits), jnp.asarray(targets),
                        jnp.asarray(mask))
    got = plm.masked_ce(torch.from_numpy(logits), torch.from_numpy(targets),
                        torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# -- the trainer --------------------------------------------------------------

def _family(family):
    """(reference module, port module factory, kind, vocab)."""
    if family == "gpt2":
        jc = jax_test_config().models.gpt2
        pc = port_test_config().models.gpt2
        return JGPT2(jc), lambda: GPT2LM(pc), "gpt2", jc.vocab_size
    jc, pc = JMistralConfig.tiny(), MistralConfig.tiny()
    return JMistral(jc), lambda: MistralLM(pc), "mistral", jc.vocab_size


def _rows(vocab, seed=0, b=8, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[::2, -3:] = 0                      # tail pads on half the rows
    return {"input_ids": ids, "loss_mask": mask}


def _port_trainer(make, kind, params, **kw):
    tr = plm.LMTrainer(make(), device="cpu", **kw)
    tr.init_state(state_dict=from_jax(kind, params))
    return tr


@pytest.mark.parametrize("family", ["gpt2", "mistral"])
def test_lm_trainer_matches_reference_over_three_steps(family):
    jmodel, make, kind, vocab = _family(family)
    rows = _rows(vocab)
    params = jax_params(jmodel, 4, jnp.asarray(rows["input_ids"][:1]))
    jt = jlm.LMTrainer(jmodel, None, lr=1e-2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jt.optimizer.init(jparams)
    pt = _port_trainer(make, kind, params, lr=1e-2)
    jbatch = {k: jnp.asarray(v) for k, v in rows.items()}
    pbatch = pt.place_batch(rows)
    jl, pl = [], []
    for i in range(3):
        jparams, opt, loss = jt.step(jparams, opt, jbatch,
                                     jax.random.PRNGKey(i))
        jl.append(float(loss))
        pl.append(float(pt.step(pbatch)))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]


def test_lm_trainer_step0_gradients_match_reference():
    jmodel, make, kind, vocab = _family("gpt2")
    rows = _rows(vocab, seed=1)
    params = jax_params(jmodel, 5, jnp.asarray(rows["input_ids"][:1]))

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(rows["input_ids"]),
                              jnp.asarray(rows["loss_mask"]).astype(bool))
        return jlm.next_token_loss(logits, jnp.asarray(rows["input_ids"]),
                                   jnp.asarray(rows["loss_mask"]))

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    pt = _port_trainer(make, kind, params)
    loss = pt.loss_and_grads(pt.place_batch(rows))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_grads({n: p.grad for n, p in pt.model.named_parameters()},
                 from_jax(kind, jax.device_get(jgrads)))


def test_lm_trainer_remat_equals_plain():
    jmodel, make, kind, vocab = _family("gpt2")
    rows = _rows(vocab, seed=2)
    params = jax_params(jmodel, 6, jnp.asarray(rows["input_ids"][:1]))
    out = {}
    for remat in (False, True):
        pt = _port_trainer(make, kind, params, remat=remat)
        loss = pt.loss_and_grads(pt.place_batch(rows))
        out[remat] = (float(loss), {n: p.grad.clone() for n, p in
                                    pt.model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, g in out[False][1].items():
        assert_rel(out[True][1][name], g, 1e-6)


def test_lm_trainer_refuses_context_parallel_and_meshes():
    with pytest.raises(NotImplementedError, match="item 16"):
        plm.LMTrainer(GPT2LM(port_test_config().models.gpt2),
                      context_parallel=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        plm.LMTrainer(GPT2LM(port_test_config().models.gpt2),
                      mesh={"dp": 4}, device="cpu")


def test_end_to_end_data_to_train():
    """Corpus -> pack -> batches -> prefetch(place=place_batch) -> steps."""
    tr = plm.LMTrainer(GPT2LM(port_test_config().models.gpt2), lr=1e-3,
                       device="cpu")
    tr.init_state(seed=0)
    texts = [f"the {w} ship sailed at dawn" for w in
             ("red", "old", "last", "lost", "great")] * 16
    packed = pdata.pack_tokens(texts, ENC, seq_len=16, eos_id=255)
    loader = pdata.PrefetchLoader(pdata.batches_from(packed, 8, epochs=1,
                                                     seed=2),
                                  place=tr.place_batch)
    losses = [float(tr.step(b)) for b in loader]
    assert len(losses) >= 2 and np.isfinite(losses).all()


# -- the checkpointer ---------------------------------------------------------

def _gpt2_trainer(seed=0):
    tr = plm.LMTrainer(GPT2LM(port_test_config().models.gpt2), lr=1e-2,
                       device="cpu")
    tr.init_state(seed=seed)
    return tr


def test_checkpointer_resume_equals_uninterrupted(tmp_path):
    rows = _rows(256, seed=3)
    whole = _gpt2_trainer()
    batch = whole.place_batch(rows)
    want = [float(whole.step(batch)) for _ in range(4)]
    first = _gpt2_trainer()
    for _ in range(2):
        first.step(batch)
    ck = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    ck.save(2, first.model_state(), first.optimizer.state_dict(),
            extra={"note": "half"})
    resumed = _gpt2_trainer(seed=9)             # other weights until loaded
    got = ck.restore()
    assert got["step"] == 2 and got["extra"] == {"note": "half"}
    resumed.load_model_state(got["model"])
    resumed.optimizer.load_state_dict(got["optimizer"])
    assert [float(resumed.step(batch)) for _ in range(2)] == want[2:]
    for (n, a), b in zip(whole.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), n


def test_checkpointer_keeps_max_to_keep_and_saves_whole(tmp_path):
    d = tmp_path / "ck"
    ck = TrainCheckpointer(str(d), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.full((2,), float(step))},
                {"count": torch.tensor(step)})
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]
    assert torch.equal(ck.restore(2)["model"]["w"], torch.full((2,), 2.0))
    ck.save(3, {"w": torch.zeros(2)}, {"count": torch.tensor(0)})
    assert torch.equal(ck.restore()["model"]["w"], torch.zeros(2))
    with open(d / "step_3" / "extra.json") as f:
        assert json.load(f) == {"step": 3}
    ck.close()
    with pytest.raises(ValueError):
        TrainCheckpointer(str(d), max_to_keep=0)


# -- the CLI ------------------------------------------------------------------

def _losses(out, name):
    return {int(line.split()[2]): float(line.split()[4])
            for line in out.splitlines()
            if line.startswith(f"[{name}] step ")}


def test_cli_train_lm_resumes_as_if_uninterrupted(tmp_path, capsys):
    common = ["train-lm", "--config", "test", "--platform", "cpu",
              "--batch", "2", "--seq-len", "16", "--log-every", "1",
              "--checkpoint-every", "2"]
    assert cli.main(common + ["--steps", "4", "--checkpoint-dir",
                              str(tmp_path / "a")]) == 0
    whole = _losses(capsys.readouterr().out, "lm")
    assert sorted(whole) == [0, 1, 2, 3]
    assert cli.main(common + ["--steps", "2", "--checkpoint-dir",
                              str(tmp_path / "b")]) == 0
    capsys.readouterr()
    assert cli.main(common + ["--steps", "4", "--checkpoint-dir",
                              str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    resumed = _losses(out, "lm")
    assert resumed == {2: whole[2], 3: whole[3]}
    assert "tokens/s on cpu" in out
    assert TrainCheckpointer(str(tmp_path / "b")).steps() == [2, 4]


def test_cli_train_diffusion_resumes_with_the_same_draws(tmp_path, capsys):
    """Each step's t and noise come from (seed, step): a run resumed at
    step 2 draws, and loses, what the uninterrupted run did."""
    common = ["train-diffusion", "--config", "test", "--platform", "cpu",
              "--batch", "2", "--image-size", "64", "--log-every", "1",
              "--checkpoint-every", "2", "--seed", "3"]
    assert cli.main(common + ["--steps", "4", "--checkpoint-dir",
                              str(tmp_path / "a")]) == 0
    whole = _losses(capsys.readouterr().out, "diffusion")
    assert cli.main(common + ["--steps", "2", "--checkpoint-dir",
                              str(tmp_path / "b")]) == 0
    capsys.readouterr()
    assert cli.main(common + ["--steps", "4", "--checkpoint-dir",
                              str(tmp_path / "b")]) == 0
    resumed = _losses(capsys.readouterr().out, "diffusion")
    assert resumed == {2: whole[2], 3: whole[3]}
    assert len(set(whole.values())) == 4


def test_cli_train_diffusion_runs(capsys):
    assert cli.main(["train-diffusion", "--config", "test", "--platform",
                     "cpu", "--steps", "2", "--batch", "2", "--image-size",
                     "64", "--log-every", "1", "--remat"]) == 0
    out = capsys.readouterr().out
    losses = _losses(out, "diffusion")
    assert sorted(losses) == [0, 1] and np.isfinite(list(losses.values())
                                                    ).all()
    assert "images/s on cpu" in out


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"],
                                   ["--sp", "4"], ["--dp", "0"]])
def test_cli_refuses_meshes(flags, capsys):
    with pytest.raises(SystemExit) as info:
        cli.main(["train-lm", "--config", "test", "--platform", "cpu"]
                 + flags)
    assert info.value.code == 2
    assert "item 16" in capsys.readouterr().err


def test_cli_lists_the_new_commands(capsys):
    assert cli.main(["--help"]) == 0
    usage = capsys.readouterr().err
    for name in ("train-diffusion", "train-lm", "clip-report"):
        assert name in usage
