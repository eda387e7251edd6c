"""Greedy text decode: prefill + cached decode steps.

Port of ``cassmantle_tpu/ops/decode.py::greedy_decode`` at temperature 0
(the reference's decode mode). The reference scans ``max_new_tokens``
steps inside one XLA computation; here the steps are a Python loop whose
state (tokens, the done mask, the cache) stays on the device, so nothing
waits on the host until the tokens are read. Tokens after EOS are EOS and
the reported length stops at the first EOS, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


def greedy_decode(model, input_ids: torch.Tensor, prompt_len: torch.Tensor,
                  max_new_tokens: int, eos_token: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids (B, P) right-padded, prompt_len (B,) -> (generated
    (B, max_new_tokens) int32, gen_len (B,) int32)."""
    b, p = input_ids.shape
    dev = input_ids.device
    max_len = p + max_new_tokens
    logits, cache = model.prefill(input_ids, prompt_len, max_len)
    positions = torch.arange(max_len, device=dev)[None, :]
    prompt_valid = positions < prompt_len[:, None]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    eos = torch.full((b,), eos_token, dtype=torch.int32, device=dev)
    tokens = []
    for i in range(max_new_tokens):
        token = torch.where(done, eos, logits.argmax(dim=-1).to(torch.int32))
        tokens.append(token)
        done = done | (token == eos_token)
        if i == max_new_tokens - 1:
            break  # the reference's last step computes logits nobody reads
        idx = p + i
        valid = prompt_valid | ((positions >= p) & (positions <= idx))
        logits, cache = model.decode_step(token, idx, cache, valid)
    out = torch.stack(tokens, dim=1)
    is_eos = out == eos_token
    gen_len = torch.where(
        is_eos.any(dim=1),
        is_eos.int().argmax(dim=1).to(torch.int32),
        torch.full((b,), max_new_tokens, dtype=torch.int32, device=dev))
    return out, gen_len
