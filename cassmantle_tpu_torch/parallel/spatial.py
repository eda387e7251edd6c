"""The UNet forward with its latent rows split over the mesh's ``sp`` axis.

The reference partitions the serving denoise spatially by one constraint,
``spatially_shard_latents`` (``cassmantle_tpu/serving/pipeline.py:82``):
the x_T latents (B, H, W, C) are laid out ``P("dp", "sp")`` and GSPMD
carries that layout through the UNet, halo-exchanging around the convs
and resharding around the attention. :class:`SpatialUNet` is that
partitioned forward written out over per-position shards (the
collectives are ``parallel/collectives.py``). Each of the sp positions
holds rows ``[i H/sp, (i+1) H/sp)`` of every activation, NCHW, and:

- a 3x3 conv of stride 1 (``conv_in``, the ResBlocks', the upsample's,
  ``conv_out``) reads one halo row from each neighbour, zeros at the
  image's top and bottom, and pads only along W;
- the stride-2 downsample conv (padding 1) makes output row j from input
  rows 2j-1 .. 2j+1: a shard that starts on an even row needs the row
  above it alone;
- a GroupNorm adds up the shards' per-group sums of x and x² in fp32
  (:func:`~cassmantle_tpu_torch.parallel.collectives.psum`) and
  normalises every shard by the one mean and variance ``GroupNorm32``
  computes over the whole image;
- self attention: each shard's queries against the keys and values of
  all the image's tokens, gathered over sp in row order (the flash
  kernel at Sq = S/sp, Sk = S; it is self attention, so the
  ``CASSMANTLE_NO_FLASH_CROSS`` switch does not apply);
- cross attention, LayerNorms, the projections and GEGLU act per token,
  the 1x1 skip convs and the nearest upsample per row: no exchange;
- the time and addition embeddings are replicated (each position's own
  copy of the UNet computes them).

The eps, and DeepCache's deep activation and encoder propagation's skip
stack and up-path entry where asked for, are gathered onto the first
position's device; a cache given back in is split again. So the
callable takes and returns what ``UNet.forward`` does, and every sampler
loop (``ops/ddim.py``) runs it as it runs the UNet. Reductions add in
another order than the one-device forward: the result agrees to fp32
rounding (tests/test_torch_port_spatial.py holds it to the reference's
bound, 1e-4).

sp must divide the latent rows at every level: H divisible by sp times
2^(levels - 1). The fused-conv UNet (kernel 2's GroupNorm statistics
would need the psum and its halo rows), W8A8 (its per-tensor dynamic
activation scale needs a :func:`pmax` over the shards) and the
weights-only int8 UNet are refused here: ROADMAP Queue 1 item 16 queues
them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cassmantle_tpu_torch.models.layers import (
    _per_channel,
    nearest_upsample_2x,
    timestep_embedding,
)
from cassmantle_tpu_torch.ops.attention import multi_head_attention
from cassmantle_tpu_torch.ops.quant import (
    int8_site_count,
    layer_weight,
    w8a8_site_count,
)
from cassmantle_tpu_torch.parallel.collectives import (
    Shards,
    all_gather,
    device_scope,
    gather,
    halo_rows,
    move,
    psum,
    split,
)

#: where the spatially partitioned quantized and fused UNets are queued
SPATIAL_QUEUE = ("ROADMAP Queue 1 item 16: the spatially partitioned "
                 "fused-conv, W8A8 and int8 UNets")


def check_spatial(unet) -> None:
    """Raise for a built UNet :class:`SpatialUNet` cannot partition."""
    if w8a8_site_count(unet):
        raise NotImplementedError(
            f"sp > 1 with the W8A8 UNet: {SPATIAL_QUEUE}")
    if int8_site_count(unet):
        raise NotImplementedError(
            f"sp > 1 with the weights-only int8 UNet: {SPATIAL_QUEUE}")
    if unet.cfg.fused_conv:
        raise NotImplementedError(
            f"sp > 1 with the fused-conv UNet: {SPATIAL_QUEUE}")


def rows_multiple(unet_cfg, sp: int) -> int:
    """What the latent H must be a multiple of for sp shards: each
    level's shard an even number of rows until the last downsample."""
    return sp * 2 ** (len(unet_cfg.channel_mults) - 1)


class SpatialUNet:
    """``UNet.forward`` over ``len(devices)`` sp positions. ``unets[i]`` is
    the UNet replica on ``devices[i]`` (one module for the positions of
    one device). Inputs come on, and outputs go to, ``devices[0]``."""

    def __init__(self, unets: Sequence[torch.nn.Module],
                 devices: Sequence[torch.device]):
        if len(unets) != len(devices) or len(devices) < 2:
            raise ValueError("one UNet per sp position, at least two")
        for unet in dict.fromkeys(unets):
            check_spatial(unet)
        self.unets = list(unets)
        self.devices = list(devices)
        self.sp = len(devices)
        self.cfg = unets[0].cfg
        self.dtype = unets[0].dtype
        self.home = devices[0]

    def _mods(self, name: str) -> list:
        return [u.get_submodule(name) for u in self.unets]

    # -- the partitioned layers ---------------------------------------------
    def _group_norm(self, name: str, xs: Shards) -> Shards:
        """GroupNorm32 over the whole image from the shards' psum'd sums."""
        cores = [m.norm for m in self._mods(name)]
        g, eps = cores[0].num_groups, cores[0].eps
        b, c = xs[0].shape[:2]
        parts = []
        for x in xs:
            x32 = x.float().reshape(b, g, -1)
            parts.append(torch.stack([x32.sum(-1), x32.square().sum(-1)]))
        totals = psum(parts)
        count = (c // g) * sum(x[0, 0].numel() for x in xs)
        out = []
        for x, total, core in zip(xs, totals, cores):
            # divided by a device tensor: an IEEE divide on every device
            n = total.new_full((), count)
            mean, ex2 = total[0] / n, total[1] / n
            inv = torch.rsqrt(ex2 - mean.square() + eps)
            a = _per_channel(inv, c) * core.weight.float()[None, :]
            shift = core.bias.float()[None, :] - _per_channel(mean, c) * a
            shape = (b, c, 1, 1)
            out.append(x * a.reshape(shape).to(x.dtype)
                       + shift.reshape(shape).to(x.dtype))
        return out

    def _conv(self, name: str, xs: Shards) -> Shards:
        """A ``Conv``: 1x1 per shard; 3x3 over halo rows (stride 2: the
        row above only), padded along W alone."""
        convs = self._mods(name)
        if convs[0].weight.shape[-1] == 1:
            return [conv(x) for conv, x in zip(convs, xs)]
        stride = convs[0].stride
        tops, bottoms = halo_rows(xs, 2, above=1,
                                  below=1 if stride == 1 else 0)
        out = []
        for i, (conv, x) in enumerate(zip(convs, xs)):
            rows = [tops[i], x] + ([bottoms[i]] if stride == 1 else [])
            dt = conv.dtype
            out.append(F.conv2d(torch.cat(rows, dim=2).to(dt),
                                layer_weight(conv).to(dt), conv.bias.to(dt),
                                stride=stride, padding=(0, 1)))
        return out

    def _self_attention(self, attns: list, xs: Shards) -> Shards:
        """Each shard's queries against every token's keys and values."""
        qs, ks, vs = [], [], []
        for attn, x in zip(attns, xs):
            heads = (attn.num_heads, attn.head_dim)
            q, k, v = attn.qkv(x).split(attn.inner, dim=-1)
            qs.append(q.unflatten(-1, heads))
            ks.append(k.unflatten(-1, heads))
            vs.append(v.unflatten(-1, heads))
        k_all, v_all = all_gather(ks, 1), all_gather(vs, 1)
        out = []
        for attn, q, k, v, dev in zip(attns, qs, k_all, v_all, self.devices):
            # a kernel launches on its position's card
            with device_scope(dev):
                o = multi_head_attention(q, k, v, cross=False)
            out.append(attn.out(o.flatten(-2)))
        return out

    def _transformer(self, name: str, xs: Shards, ctxs: Shards) -> Shards:
        sts = self._mods(name)
        normed = self._group_norm(f"{name}.norm", xs)
        b, c, _, w = xs[0].shape
        toks = [st.proj_in(h.permute(0, 2, 3, 1).reshape(b, -1, c))
                for st, h in zip(sts, normed)]
        for i in range(sts[0].depth):
            blocks = [getattr(st, f"block_{i}") for st in sts]
            attn = self._self_attention([blk.self_attn for blk in blocks],
                                        [blk.ln1(t) for blk, t in
                                         zip(blocks, toks)])
            toks = [t + a for t, a in zip(toks, attn)]
            toks = [t + blk.cross_attn(blk.ln2(t), context=ctx)
                    for blk, t, ctx in zip(blocks, toks, ctxs)]
            toks = [t + blk.ff(blk.ln3(t)) for blk, t in zip(blocks, toks)]
        return [st.proj_out(t).reshape(b, x.shape[2], w, c)
                .permute(0, 3, 1, 2) + x
                for st, t, x in zip(sts, toks, xs)]

    def _resblock(self, name: str, xs: Shards, tembs: Shards) -> Shards:
        blocks = self._mods(name)
        h = self._conv(f"{name}.conv1", [
            F.silu(t) for t in self._group_norm(f"{name}.norm1", xs)])
        h = [hh + blk.time_proj(F.silu(temb))[:, :, None, None]
             for blk, hh, temb in zip(blocks, h, tembs)]
        h = self._conv(f"{name}.conv2", [
            F.silu(t) for t in self._group_norm(f"{name}.norm2", h)])
        xs = [x if blk.skip is None else blk.skip(x)
              for blk, x in zip(blocks, xs)]
        return [x + hh for x, hh in zip(xs, h)]

    def _block_at(self, name: str, xs: Shards, tembs: Shards,
                  ctxs: Shards) -> Shards:
        """A level's ResBlock and, where the level has one, its
        transformer (``name`` without the kind: ``down_0_{}_1``)."""
        xs = self._resblock(name.format("res"), xs, tembs)
        if not hasattr(self.unets[0], name.format("attn")):
            return xs
        return self._transformer(name.format("attn"), xs, ctxs)

    # -- UNet.forward over shards ---------------------------------------------
    def __call__(self, latents: Optional[torch.Tensor],
                 timesteps: torch.Tensor, context: torch.Tensor,
                 addition_embeds: Optional[torch.Tensor] = None,
                 deep_cache: Optional[torch.Tensor] = None,
                 return_deep: bool = False,
                 skips_cache: Optional[Tuple[Sequence[torch.Tensor],
                                             torch.Tensor]] = None,
                 return_skips: bool = False):
        """``UNet.forward``'s arguments and results, on ``devices[0]``."""
        cfg, dtype, devs = self.cfg, self.dtype, self.devices
        levels = len(cfg.channel_mults)
        decoder_only = skips_cache is not None
        shallow_only = deep_cache is not None
        assert not (decoder_only and shallow_only), (
            "deep_cache and skips_cache are mutually exclusive modes")
        assert latents is not None or decoder_only, (
            "latents may be None only with skips_cache")
        assert not (return_skips and (shallow_only or decoder_only)), (
            "return_skips needs the full encoder to have run")
        rows = (latents.shape[1] if latents is not None
                else skips_cache[0][0].shape[2])
        multiple = rows_multiple(cfg, self.sp)
        if rows % multiple:
            raise ValueError(f"latent H {rows} does not split over sp="
                             f"{self.sp}: it must be a multiple of "
                             f"{multiple} (every level's shard even)")
        # replicated: the conditioning and the time embedding
        ctxs = [move(context, d).to(dtype) for d in devs]
        tembs = []
        for unet, d in zip(self.unets, devs):
            temb = timestep_embedding(move(timesteps, d), cfg.base_channels)
            temb = unet.time_fc2(F.silu(unet.time_fc1(temb.to(dtype))))
            if cfg.addition_embed_dim and addition_embeds is not None:
                temb = temb + unet.add_fc2(F.silu(unet.add_fc1(
                    move(addition_embeds, d).to(dtype))))
            tembs.append(temb)

        if decoder_only:
            cached_skips, up_entry = skips_cache
            skips = [split(s.to(dtype), devs, 2) for s in cached_skips]
            xs = split(up_entry.to(dtype), devs, 2)
        else:
            xs = [x.to(dtype).permute(0, 3, 1, 2)
                  for x in split(latents, devs, 1)]
            xs = self._conv("conv_in", xs)
            skips: List[Shards] = [xs]
            for lvl in range(1 if shallow_only else levels):
                for blk in range(cfg.blocks_per_level):
                    xs = self._block_at(f"down_{lvl}_{{}}_{blk}", xs, tembs,
                                        ctxs)
                    skips.append(xs)
                if lvl != levels - 1 and not shallow_only:
                    xs = self._conv(f"down_{lvl}_downsample", xs)
                    skips.append(xs)
        skips_out = list(skips) if return_skips else None

        if not shallow_only and not decoder_only:
            xs = self._resblock("mid_res_0", xs, tembs)
            xs = self._transformer("mid_attn", xs, ctxs)
            xs = self._resblock("mid_res_1", xs, tembs)
        up_entry_out = xs if return_skips else None

        deep_out = None
        if shallow_only:
            xs = split(deep_cache.to(dtype), devs, 2)
        for lvl in [0] if shallow_only else reversed(range(levels)):
            if lvl == 0 and return_deep:
                deep_out = gather(xs, self.home, 2)
            for blk in range(cfg.blocks_per_level + 1):
                skip = skips.pop()
                xs = [torch.cat([x, s], dim=1) for x, s in zip(xs, skip)]
                xs = self._block_at(f"up_{lvl}_{{}}_{blk}", xs, tembs, ctxs)
            if lvl != 0:
                xs = self._conv(f"up_{lvl}_upsample",
                                [nearest_upsample_2x(x) for x in xs])

        assert not skips, f"unconsumed skips: {len(skips)}"

        xs = self._conv("conv_out", [
            F.silu(t) for t in self._group_norm("norm_out", xs)])
        eps = gather([x.float().permute(0, 2, 3, 1) for x in xs], self.home, 1)
        if return_skips:
            cache = (tuple(gather(s, self.home, 2) for s in skips_out),
                     gather(up_entry_out, self.home, 2))
        if return_deep and return_skips:
            return eps, deep_out, cache
        if return_deep:
            return eps, deep_out
        if return_skips:
            return eps, cache
        return eps
