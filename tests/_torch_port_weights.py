"""Weights directories for the port's loading tests.

Reference parameter trees (seeded numpy, ``_torch_port_common.jax_params``)
are written back under the published HF/diffusers names with the
reference's own fabricators (``tests/test_weights.py``, the Mistral and
VAE-encoder round trips of ``tests/test_mistral.py`` and
``tests/test_img2img.py``) and saved with the ``safetensors`` package, so
the port's reader is held against an independent writer. Small synthetic
vocabularies (greedy BPE merges over the game's own text) go beside them
under the reference's file names.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
from safetensors.numpy import save_file

from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.minilm import MiniLMEncoder as JMiniLM
from cassmantle_tpu.models.mistral import MistralLM as JMistral
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import VAEEncoder as JVAEEncoder
from cassmantle_tpu.utils.tokenizers import (
    SentencePieceBPETokenizer,
    _bytes_to_unicode,
)
from test_weights import (
    _torch_conv,
    _torch_dense,
    fabricate_clip,
    fabricate_gpt2,
    fabricate_minilm,
    fabricate_unet,
    fabricate_vae_decoder,
)

from _torch_port_common import jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(name):
    with open(os.path.join(REPO, "data", name), encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


SEEDS, STYLES, WORDS = (_lines("seeds.txt"), _lines("styles.txt"),
                        _lines("wordlist.txt"))


# -- reference trees ----------------------------------------------------------

def reference_params(cfg, seed=0):
    """{kind: numpy Flax tree} of every model ``cfg`` (a reference config)
    serves, drawn from a seeded numpy generator."""
    m, s = cfg.models, cfg.sampler
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    ids = jnp.zeros((1, pad), jnp.int32)
    scale = 2 ** (len(m.vae.channel_mults) - 1)
    hw = s.image_size // scale
    lat = jnp.zeros((1, hw, hw, 4), jnp.float32)
    unet_args = [lat, jnp.zeros((1,), jnp.int32),
                 jnp.zeros((1, pad, m.unet.context_dim), jnp.float32)]
    if m.unet.addition_embed_dim:
        unet_args.append(jnp.zeros((1, m.unet.addition_embed_dim)))
    img = jnp.zeros((1, s.image_size, s.image_size, 3), jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    out = {
        "clip_text": jax_params(JClip(m.clip_text), seed + 1, ids),
        "unet": jax_params(JUNet(m.unet), seed + 2, *unet_args),
        "vae": jax_params(JVAE(m.vae), seed + 3, lat),
        "vae_enc": jax_params(JVAEEncoder(m.vae), seed + 4, img,
                              jnp.zeros((2,), jnp.uint32)),
        "minilm": jax_params(JMiniLM(m.minilm), seed + 7, tokens,
                             jnp.ones((1, 8), jnp.int32)),
    }
    if m.mistral is not None:
        out["mistral"] = jax_params(JMistral(m.mistral), seed + 5, tokens)
    else:
        out["gpt2"] = jax_params(JGPT2(m.gpt2), seed + 5, tokens)
    if m.clip_text_2 is not None:
        out["clip_text_2"] = jax_params(JClip(m.clip_text_2), seed + 11, ids)
    d = cfg.spec_decode.draft_model
    if cfg.spec_decode.mode == "draft_model" and d is not None:
        out["gpt2_draft"] = jax_params(JGPT2(d), seed + 6, tokens)
    return out


# -- fabricators the reference tests lack ------------------------------------

def fabricate_unet_xl(params, levels):
    """``fabricate_unet`` plus SDXL's micro-conditioning MLP."""
    p = dict(params["params"])
    extra = {}
    for ours, theirs in (("add_fc1", "linear_1"), ("add_fc2", "linear_2")):
        leaf = p.pop(ours)
        extra[f"add_embedding.{theirs}.weight"] = _torch_dense(leaf["kernel"])
        extra[f"add_embedding.{theirs}.bias"] = np.asarray(leaf["bias"])
    return {**fabricate_unet({"params": p}, levels), **extra}


def fabricate_vae_encoder(params, cfg):
    """The encoder half of an AutoencoderKL file (tests/test_img2img.py's
    round trip)."""
    p = params["params"]
    src = {}

    def conv(key, tree):
        src[f"{key}.weight"] = _torch_conv(tree["kernel"])
        if "bias" in tree:
            src[f"{key}.bias"] = np.asarray(tree["bias"])

    def gn(key, tree):
        src[f"{key}.weight"] = np.asarray(tree["norm"]["scale"])
        src[f"{key}.bias"] = np.asarray(tree["norm"]["bias"])

    def res(key, tree):
        gn(f"{key}.norm1", tree["norm1"])
        conv(f"{key}.conv1", tree["conv1"])
        gn(f"{key}.norm2", tree["norm2"])
        conv(f"{key}.conv2", tree["conv2"])
        if "skip" in tree:
            conv(f"{key}.conv_shortcut", tree["skip"])

    conv("quant_conv", p["quant_conv"])
    conv("encoder.conv_in", p["conv_in"])
    levels = len(cfg.channel_mults)
    for lvl in range(levels):
        for blk in range(cfg.blocks_per_level):
            res(f"encoder.down_blocks.{lvl}.resnets.{blk}",
                p[f"down_{lvl}_res_{blk}"])
        if lvl != levels - 1:
            conv(f"encoder.down_blocks.{lvl}.downsamplers.0.conv",
                 p[f"down_{lvl}_downsample"])
    res("encoder.mid_block.resnets.0", p["mid_res_0"])
    attn = p["mid_attn"]
    gn("encoder.mid_block.attentions.0.group_norm", attn["norm"])
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                         ("out", "to_out.0")):
        src[f"encoder.mid_block.attentions.0.{theirs}.weight"] = \
            _torch_dense(attn["attn"][ours]["kernel"])
        src[f"encoder.mid_block.attentions.0.{theirs}.bias"] = \
            np.asarray(attn["attn"][ours]["bias"])
    res("encoder.mid_block.resnets.1", p["mid_res_1"])
    gn("encoder.conv_norm_out", p["norm_out"])
    conv("encoder.conv_out", p["conv_out"])
    return src


def fabricate_mistral(params, num_layers):
    """tests/test_mistral.py's round trip."""
    p = params["params"]
    src = {"model.embed_tokens.weight": np.asarray(p["embed"]["embedding"])}
    for i in range(num_layers):
        b, pre = p[f"block_{i}"], f"model.layers.{i}"
        src[f"{pre}.input_layernorm.weight"] = np.asarray(b["ln1"]["scale"])
        src[f"{pre}.post_attention_layernorm.weight"] = np.asarray(
            b["ln2"]["scale"])
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "o_proj")):
            src[f"{pre}.self_attn.{hf}.weight"] = _torch_dense(
                b["attn"][name]["kernel"])
        for name, hf in (("gate", "gate_proj"), ("up", "up_proj"),
                         ("down", "down_proj")):
            src[f"{pre}.mlp.{hf}.weight"] = _torch_dense(
                b["mlp"][name]["kernel"])
    src["model.norm.weight"] = np.asarray(p["ln_f"]["scale"])
    src["lm_head.weight"] = _torch_dense(p["lm_head"]["kernel"])
    return src


def fabricate(kind, params, cfg, seed=0):
    """The published tensor dict of reference tree ``params`` of ``kind``
    (``cfg``: the reference config's models). MiniLM's token-type rows are
    seeded noise, so the converters' fold is exercised; bigG's file
    carries a text projection."""
    m = cfg
    if kind in ("clip_text", "clip_text_2"):
        tower = m.clip_text if kind == "clip_text" else m.clip_text_2
        out = fabricate_clip(params, tower.num_layers)
        if kind == "clip_text_2":
            rng = np.random.default_rng(seed + 21)
            h = tower.hidden_size
            out["text_projection.weight"] = (
                rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32)
        return out
    if kind == "unet":
        levels = len(m.unet.channel_mults)
        return (fabricate_unet_xl(params, levels) if m.unet.addition_embed_dim
                else fabricate_unet(params, levels))
    if kind == "vae":
        return fabricate_vae_decoder(params, len(m.vae.channel_mults))
    if kind == "vae_enc":
        return fabricate_vae_encoder(params, m.vae)
    if kind in ("gpt2", "gpt2_draft"):
        p = params["params"]
        return fabricate_gpt2(params, sum(k.startswith("block_") for k in p),
                              p["wte"]["embedding"].shape[1])
    if kind == "minilm":
        out = fabricate_minilm(params, m.minilm.num_layers)
        rng = np.random.default_rng(seed + 22)
        out["embeddings.token_type_embeddings.weight"] = (
            0.02 * rng.standard_normal((2, m.minilm.hidden_size))
        ).astype(np.float32)
        return out
    if kind == "mistral":
        return fabricate_mistral(params, m.mistral.num_layers)
    raise KeyError(kind)


FILES = {"clip_text": "clip_text.safetensors",
         "clip_text_2": "clip_text_2.safetensors",
         "unet": "unet.safetensors", "vae": "vae.safetensors",
         "gpt2": "gpt2.safetensors", "gpt2_draft": "gpt2_draft.safetensors",
         "minilm": "minilm.safetensors", "mistral": "mistral.safetensors"}
XL_FILES = {"unet": "unet_xl.safetensors", "vae": "vae_xl.safetensors"}


def save(path, tensors):
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()}, path)


def write_weights_dir(path, cfg, params, shards=1, vocab=True):
    """Every checkpoint of reference ``params`` under its published file
    name in ``path`` (the VAE file holds the decoder and the encoder;
    SDXL's UNet and VAE take their ``_xl`` names; Mistral in ``shards``
    shards), and, with ``vocab``, the synthetic vocabularies."""
    os.makedirs(path, exist_ok=True)
    m = cfg.models
    xl = m.clip_text_2 is not None
    tensors = {k: fabricate(k, v, m) for k, v in params.items()}
    if "vae_enc" in tensors:
        tensors["vae"] = {**tensors["vae"], **tensors.pop("vae_enc")}
    for kind, t in tensors.items():
        name = (XL_FILES.get(kind) if xl else None) or FILES[kind]
        if kind == "mistral" and shards > 1:
            keys = sorted(t)
            stem = name.rsplit(".", 1)[0]
            for i in range(shards):
                part = {k: t[k] for k in keys[i::shards]}
                save(os.path.join(path, f"{stem}-{i + 1:05d}.safetensors"),
                     part)
        else:
            save(os.path.join(path, name), t)
    if vocab:
        write_vocab_files(path)
    return tensors


# -- synthetic vocabularies ----------------------------------------------------

def greedy_merges(counts, n):
    """``n`` greedy most-frequent-pair merges over ``counts`` (symbol
    tuple -> count), ties to the smallest pair."""
    merges = []
    for _ in range(n):
        pairs = {}
        for sym, c in counts.items():
            for pair in zip(sym, sym[1:]):
                pairs[pair] = pairs.get(pair, 0) + c
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        merged = {}
        for sym, c in counts.items():
            out, i = [], 0
            while i < len(sym):
                if i < len(sym) - 1 and (sym[i], sym[i + 1]) == best:
                    out.append(sym[i] + sym[i + 1])
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + c
        counts = merged
    return merges


def _counts(seqs):
    out = {}
    for seq in seqs:
        out[tuple(seq)] = out.get(tuple(seq), 0) + 1
    return out


def bpe_merges(words, n, end=""):
    """Greedy merges over ``words`` split into GPT-2's byte symbols
    (``end`` appended to each word's last one)."""
    b2u = _bytes_to_unicode()
    seqs = []
    for w in words:
        sym = [b2u[b] for b in w.encode("utf-8")]
        sym[-1] += end
        seqs.append(sym)
    return greedy_merges(_counts(seqs), n)


def training_words():
    text = " ".join(SEEDS + STYLES + WORDS[:400]).lower()
    return text.split()


def write_vocab_files(path, n_merges=120):
    """``{gpt2,clip}_vocab.json`` + ``_merges.txt``, ``minilm_vocab.txt``
    and ``mistral_tokenizer.json`` in ``path``, from greedy merges over
    the game's seeds, styles and the head of its wordlist."""
    b2u = _bytes_to_unicode()
    words = training_words()
    for kind, end in (("gpt2", ""), ("clip", "</w>")):
        merges = bpe_merges(words, n_merges, end)
        symbols = list(b2u.values())
        if end:
            symbols += [s + end for s in b2u.values()]
        symbols += [a + b for a, b in merges]
        vocab = {s: i for i, s in enumerate(dict.fromkeys(symbols))}
        if kind == "clip":
            vocab["<|startoftext|>"] = len(vocab)
        vocab["<|endoftext|>"] = len(vocab)
        with open(os.path.join(path, f"{kind}_vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(path, f"{kind}_merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            f.writelines(f"{a} {b}\n" for a, b in merges)
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    chars = sorted({c for w in words for c in w if c.isalnum()})
    pieces += chars + [f"##{c}" for c in chars]
    freq = {}
    for w in words:
        freq[w] = freq.get(w, 0) + 1
    pieces += [w for w in sorted(freq, key=lambda w: (-freq[w], w))[:300]
               if w.isalnum()]
    pieces += ["##ing", "##ed", "##er", "##s", "##ly", "##tion"]
    with open(os.path.join(path, "minilm_vocab.txt"), "w") as f:
        f.writelines(f"{p}\n" for p in dict.fromkeys(pieces))
    mark = SentencePieceBPETokenizer.WORD_MARK
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    sp_words = [mark + w for w in words]
    for c in sorted({c for w in sp_words for c in w}):
        vocab.setdefault(c, len(vocab))
    merges = greedy_merges(_counts(sp_words), n_merges)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    spec = {"model": {"type": "BPE", "vocab": vocab,
                      "merges": [" ".join(m) for m in merges]},
            "added_tokens": [{"content": "<s>", "id": 1},
                             {"content": "</s>", "id": 2}]}
    with open(os.path.join(path, "mistral_tokenizer.json"), "w") as f:
        json.dump(spec, f)
