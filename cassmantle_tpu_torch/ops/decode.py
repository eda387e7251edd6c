"""Greedy text decode: prefill + cached decode steps.

Port of ``cassmantle_tpu/ops/decode.py::greedy_decode`` at temperature 0
(the reference's decode mode). The reference scans ``max_new_tokens``
steps inside one XLA computation; here the loop state (the cache, the
logits, the done mask, the tokens and a step counter) lives in the
buffers of a :class:`GreedyDecodeState`, on the device, and one decode
step reads its position from the counter there: the valid mask is
computed from it as the reference's scan does, the token is written at
it, and the counter advances in place. On the card the step is captured
once into a CUDA graph (per batch, prompt bucket, ``max_new_tokens`` and
EOS) and replayed once per token; elsewhere, or when asked, it runs
eagerly. Both run the same arithmetic. Tokens after EOS are EOS and the
reported length stops at the first EOS, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cassmantle_tpu_torch.ops.graphs import CapturedStep


class GreedyDecodeState:
    """The static buffers of one greedy decode shape: batch ``b``, prompt
    bucket ``p``, ``max_new`` tokens and ``eos``; and, once
    :meth:`capture` ran, the captured decode step."""

    def __init__(self, model, b: int, p: int, max_new: int, eos: int,
                 device):
        self.model, self.p, self.max_new, self.eos = model, p, max_new, eos
        max_len = p + max_new
        self.cache = model.new_cache(b, max_len, device)
        self.logits = torch.zeros((b, model.cfg.vocab_size),
                                  dtype=torch.float32, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.eos_row = torch.full((b,), eos, dtype=torch.int32,
                                  device=device)
        self.tokens = torch.zeros((b, max_new), dtype=torch.int32,
                                  device=device)
        self.step_index = torch.zeros((1,), dtype=torch.long, device=device)
        self.positions = torch.arange(max_len, device=device)[None, :]
        self.prompt_valid = torch.zeros((b, max_len), dtype=torch.bool,
                                        device=device)
        self.graph: Optional[CapturedStep] = None

    def start(self, input_ids: torch.Tensor, prompt_len: torch.Tensor
              ) -> None:
        """Prefill the prompt into the cache (eagerly) and reset the
        loop state."""
        logits, _ = self.model.prefill(input_ids, prompt_len,
                                       self.p + self.max_new, self.cache)
        self.logits.copy_(logits)
        torch.lt(self.positions, prompt_len[:, None], out=self.prompt_valid)
        self.done.zero_()
        self.step_index.zero_()

    def pick(self) -> torch.Tensor:
        """Step i's token from the logits (EOS once done), written at
        column i; updates the done mask."""
        token = torch.where(self.done, self.eos_row,
                            self.logits.argmax(dim=-1).to(torch.int32))
        self.tokens.index_copy_(1, self.step_index, token[:, None])
        self.done |= token == self.eos
        return token

    def step(self) -> None:
        """One decode step: pick token i, run it through the model at
        position p + i over the positions the reference's scan marks
        valid there, keep its logits and advance i."""
        token = self.pick()
        index = self.step_index + self.p
        valid = self.prompt_valid | ((self.positions >= self.p)
                                     & (self.positions <= index))
        logits, _ = self.model.decode_step(token, index, self.cache, valid)
        self.logits.copy_(logits)
        self.step_index.add_(1)

    def capture(self) -> None:
        """Capture :meth:`step` into a CUDA graph, after :meth:`start`.
        Its warm-up runs step 0 of the prompt just prefilled; the state
        that step changes and step 0's replay does not rewrite (logits,
        done mask, counter) is put back after."""
        logits, done = self.logits.clone(), self.done.clone()
        self.step_index.zero_()
        self.graph = CapturedStep(self.step)
        self.logits.copy_(logits)
        self.done.copy_(done)
        self.step_index.zero_()

    def finish(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The last token (its logits' step is skipped, as the reference's
        last scan step computes logits nobody reads), then (tokens
        (B, max_new) int32, gen_len (B,) int32)."""
        self.pick()
        out = self.tokens.clone()
        is_eos = out == self.eos
        gen_len = torch.where(
            is_eos.any(dim=1), is_eos.int().argmax(dim=1).to(torch.int32),
            torch.full_like(self.eos_row, self.max_new))
        return out, gen_len


def greedy_decode(model, input_ids: torch.Tensor, prompt_len: torch.Tensor,
                  max_new_tokens: int, eos_token: int,
                  graphs: Optional[Dict[tuple, GreedyDecodeState]] = None,
                  graphed: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids (B, P) right-padded, prompt_len (B,) -> (generated
    (B, max_new_tokens) int32, gen_len (B,) int32).

    ``graphed`` (default: on a CUDA device) replays a captured decode
    step ``max_new_tokens - 1`` times; the state and its graph are kept
    in ``graphs`` under (B, P, max_new_tokens, eos_token) and captured on
    first use (without ``graphs``, anew for this call). A capture failure
    raises. ``graphed=False`` runs the same steps eagerly."""
    b, p = input_ids.shape
    if graphed is None:
        graphed = input_ids.device.type == "cuda"
    key = (b, p, max_new_tokens, eos_token)
    state = None if graphs is None else graphs.get(key)
    if state is None:
        state = GreedyDecodeState(model, b, p, max_new_tokens, eos_token,
                                  input_ids.device)
        if graphs is not None:
            graphs[key] = state
    state.start(input_ids, prompt_len)
    if graphed and state.graph is None and max_new_tokens > 1:
        state.capture()
    for _ in range(max_new_tokens - 1):
        if graphed:
            state.graph.replay()
        else:
            state.step()
    return state.finish()
