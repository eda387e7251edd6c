"""Text decode: prefill + cached decode steps, greedy or top-k sampled, and
speculative (draft/verify) greedy decode.

Port of ``cassmantle_tpu/ops/decode.py``. Every loop here drives any zoo LM
with the ``new_cache`` / ``prefill`` / ``decode_step`` (and, to verify,
``decode_chunk``) contract: GPT-2 and Mistral.

``greedy_decode``: the reference scans ``max_new_tokens`` steps inside one
XLA computation; here the loop state (the cache, the logits, the done mask,
the tokens and a step counter) lives in the buffers of a
:class:`GreedyDecodeState`, on the device, and one decode step reads its
position from the counter there: the valid mask is computed from it as the
reference's scan does, the token is written at it, and the counter
advances in place. On the card the step is captured once into a CUDA graph
(per batch, prompt bucket, ``max_new_tokens``, EOS and sampler) and
replayed once per token; elsewhere, or when asked, it runs eagerly. Both
run the same arithmetic. Tokens after EOS are EOS and the reported length
stops at the first EOS, as in the reference. At a temperature above 0 a
step draws from the top-k logits: argmax of ``k_logits / temperature``
plus Gumbel noise, the reference's ``jax.random.categorical``. The noise
of every step is drawn at ``start()``, outside the graph, from a
``torch.Generator`` the caller seeds, into a static buffer that the step
indexes at its counter, so the graph holds no RNG state. Torch's stream is
not JAX's: sampled tokens agree with the reference's in distribution, not
draw for draw.

``speculative_decode``: a draft proposes ``gamma`` tokens (:class:`NgramDraft`,
prompt lookup over the known context; or :class:`ModelDraft`, a smaller LM
with its own cache) and the target scores all gamma + 1 positions in one
``decode_chunk``; the rows commit, in lockstep, the accepted prefix plus
the target's own next token. Acceptance is an exact argmax match, so the
tokens are greedy decode's. The reference's ``lax.while_loop`` becomes one
chunk body (:meth:`SpecDecodeState.chunk`) on static buffers, every
dynamic offset a device tensor, captured once into a CUDA graph and
replayed until the stop flag it writes reads true: one host read a chunk.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from cassmantle_tpu_torch.ops.graphs import CapturedStep
from cassmantle_tpu_torch.utils.profiling import annotate


def gumbel_(noise: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``noise`` in place with standard Gumbel draws from
    ``generator``: -log(-log(u)), u uniform in [tiny, 1), as
    ``jax.random.gumbel``."""
    noise.uniform_(generator=generator)
    noise.clamp_(min=torch.finfo(noise.dtype).tiny)
    return noise.log_().neg_().log_().neg_()


def sample_top_k(logits: torch.Tensor, noise: torch.Tensor,
                 temperature: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row over the top-k logits at
    ``temperature`` (a 0-dim device tensor: an IEEE divide on every
    device), given that draw's Gumbel ``noise`` (B, k): (B,) int32 ids."""
    k_logits, k_idx = logits.topk(noise.shape[-1], dim=-1)
    choice = (k_logits.float() / temperature + noise).argmax(-1,
                                                             keepdim=True)
    return k_idx.gather(-1, choice)[:, 0].to(torch.int32)


def decode_lengths(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """(B, N) tokens -> (B,) int32: the index of each row's first EOS, or
    N when it has none."""
    is_eos = tokens == eos
    n = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                   device=tokens.device)
    return torch.where(is_eos.any(dim=1),
                       is_eos.int().argmax(dim=1).to(torch.int32), n)


class GreedyDecodeState:
    """The static buffers of one decode shape: batch ``b``, prompt bucket
    ``p``, ``max_new`` tokens, ``eos`` and the sampler (greedy at
    ``temperature`` 0, else top-``top_k`` sampling); and, once
    :meth:`capture` ran, the captured decode step."""

    def __init__(self, model, b: int, p: int, max_new: int, eos: int,
                 device, temperature: float = 0.0, top_k: int = 40):
        self.model, self.p, self.max_new, self.eos = model, p, max_new, eos
        max_len = p + max_new
        vocab = model.cfg.vocab_size
        self.cache = model.new_cache(b, max_len, device)
        self.logits = torch.zeros((b, vocab), dtype=torch.float32,
                                  device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.eos_row = torch.full((b,), eos, dtype=torch.int32,
                                  device=device)
        self.tokens = torch.zeros((b, max_new), dtype=torch.int32,
                                  device=device)
        self.step_index = torch.zeros((1,), dtype=torch.long, device=device)
        self.positions = torch.arange(max_len, device=device)[None, :]
        self.prompt_valid = torch.zeros((b, max_len), dtype=torch.bool,
                                        device=device)
        self.sampled = temperature > 0.0
        if self.sampled:
            k = max(1, min(top_k, vocab))
            self.temperature = torch.full((), temperature,
                                          dtype=torch.float32, device=device)
            self.noise = torch.zeros((max_new, b, k), dtype=torch.float32,
                                     device=device)
        self.graph: Optional[CapturedStep] = None

    def start(self, input_ids: torch.Tensor, prompt_len: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> None:
        """Prefill the prompt into the cache (eagerly), reset the loop
        state and, when sampling, draw every step's noise from
        ``generator``."""
        logits, _ = self.model.prefill(input_ids, prompt_len,
                                       self.p + self.max_new, self.cache)
        self.logits.copy_(logits)
        torch.lt(self.positions, prompt_len[:, None], out=self.prompt_valid)
        self.done.zero_()
        self.step_index.zero_()
        if self.sampled:
            if generator is None:
                raise ValueError("a sampled decode needs a seeded "
                                 "torch.Generator")
            gumbel_(self.noise, generator)

    def pick(self) -> torch.Tensor:
        """Step i's token from the logits (EOS once done), written at
        column i; updates the done mask."""
        if self.sampled:
            token = sample_top_k(self.logits,
                                 self.noise.index_select(0,
                                                         self.step_index)[0],
                                 self.temperature)
        else:
            token = self.logits.argmax(dim=-1).to(torch.int32)
        token = torch.where(self.done, self.eos_row, token)
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
        return out, decode_lengths(out, self.eos)


def greedy_decode(model, input_ids: torch.Tensor, prompt_len: torch.Tensor,
                  max_new_tokens: int, eos_token: int,
                  graphs: Optional[Dict[tuple, GreedyDecodeState]] = None,
                  graphed: Optional[bool] = None, temperature: float = 0.0,
                  top_k: int = 40,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids (B, P) right-padded, prompt_len (B,) -> (generated
    (B, max_new_tokens) int32, gen_len (B,) int32).

    ``temperature`` 0 is exact greedy argmax; above 0 each token is a
    top-``top_k`` draw whose noise comes from ``generator`` (the same
    seed gives the same tokens, graphed or eager). ``graphed`` (default:
    on a CUDA device) replays a captured decode step ``max_new_tokens -
    1`` times; the state and its graph are kept in ``graphs`` under
    (B, P, max_new_tokens, eos_token, temperature, top_k) and captured on
    first use (without ``graphs``, anew for this call). A capture failure
    raises. ``graphed=False`` runs the same steps eagerly."""
    b, p = input_ids.shape
    if graphed is None:
        graphed = input_ids.device.type == "cuda"
    key = (b, p, max_new_tokens, eos_token, temperature,
           top_k if temperature > 0.0 else None)
    state = None if graphs is None else graphs.get(key)
    if state is None:
        state = GreedyDecodeState(model, b, p, max_new_tokens, eos_token,
                                  input_ids.device, temperature, top_k)
        if graphs is not None:
            graphs[key] = state
    state.start(input_ids, prompt_len, generator)
    if graphed and state.graph is None and max_new_tokens > 1:
        state.capture()
    for _ in range(max_new_tokens - 1):
        if graphed:
            state.graph.replay()
        else:
            state.step()
    return state.finish()


# -- speculative decode -------------------------------------------------------


class NgramDraft(NamedTuple):
    """Prompt-lookup draft: the last ``ngram`` known tokens are matched
    against the earlier context and the tokens after the latest match are
    proposed. No second model."""

    ngram: int = 3


class ModelDraft(NamedTuple):
    """A smaller zoo LM drafting for the target, with its own cache. It
    must share the target's vocabulary: token ids are compared
    directly."""

    model: torch.nn.Module


def ngram_propose(ctx: torch.Tensor, prompt_len: torch.Tensor,
                  prompt_width: int, n_gen: Union[int, torch.Tensor],
                  gamma: int, k: int) -> torch.Tensor:
    """Propose (B, gamma) int32 tokens by suffix lookup (the reference's
    ``_ngram_propose``).

    ``ctx`` (B, L) holds the right-padded prompt in columns below
    ``prompt_width`` (real below each row's ``prompt_len``) and ``n_gen``
    known generated tokens (an int, or a one-element device tensor) from
    ``prompt_width`` on. The last ``k`` known tokens are matched against
    every earlier window (pad gaps blanked to -1 never match); the
    rightmost match wins and the ``gamma`` tokens after it are the
    proposal. No match: the last token, repeated. Offsets clamp as
    ``lax.dynamic_slice`` clamps them."""
    b, length = ctx.shape
    dev = ctx.device
    if not isinstance(n_gen, torch.Tensor):
        n_gen = torch.full((1,), n_gen, dtype=torch.long, device=dev)
    end = n_gen.reshape(1) + prompt_width          # one past the known
    pos = torch.arange(length, device=dev)[None, :]
    real = (pos < prompt_len[:, None]) | ((pos >= prompt_width)
                                          & (pos < end))
    mctx = ctx.masked_fill(~real, -1)
    arange_k = torch.arange(k, device=dev)
    suffix = mctx.index_select(1, (end - k).clamp(0, length - k) + arange_k)
    windows = torch.stack([mctx[:, t:length - k + t] for t in range(k)],
                          dim=-1)                  # (B, L - k, k)
    window_j = torch.arange(length - k, device=dev)[None, :]
    # a window must end before the suffix, so that a continuation exists
    match = (windows == suffix[:, None, :]).all(dim=-1) & (window_j < end - k)
    j_star = torch.where(match, window_j, -1).amax(dim=-1)
    start = (j_star + k).clamp(0, length - gamma)
    proposal = ctx.gather(1, start[:, None]
                          + torch.arange(gamma, device=dev)[None, :])
    last = mctx.index_select(1, (end - 1).clamp(0, length - 1))
    return torch.where((j_star >= 0)[:, None], proposal,
                       last.expand(b, gamma)).to(torch.int32)


class SpecDecodeState:
    """The static buffers of one speculative decode shape: batch ``b``,
    prompt bucket ``p``, ``max_new`` tokens, ``eos``, ``gamma`` drafts a
    chunk and the ``draft``; and, once :meth:`capture` ran, the captured
    chunk body. The caches reach ``p + max_new + gamma + 1`` positions:
    the last chunk's append may land past the budget."""

    def __init__(self, model, b: int, p: int, max_new: int, eos: int,
                 gamma: int, draft: Union[NgramDraft, ModelDraft], device):
        if max_new < 1 or gamma < 1:
            raise ValueError(f"speculative decode needs max_new >= 1 and "
                             f"gamma >= 1, got {max_new} and {gamma}")
        if (isinstance(draft, ModelDraft)
                and draft.model.cfg.vocab_size != model.cfg.vocab_size):
            raise ValueError("the draft and the target must share a "
                             "vocabulary: acceptance compares token ids")
        self.model, self.draft = model, draft
        self.p, self.max_new, self.eos, self.gamma = p, max_new, eos, gamma
        g1 = gamma + 1
        max_len = p + max_new + g1
        self.max_len = max_len
        kw = dict(device=device)
        self.cache = model.new_cache(b, max_len, device)
        self.d_cache = (draft.model.new_cache(b, max_len, device)
                        if isinstance(draft, ModelDraft) else [])
        # the n-gram draft's context: prompt bucket, then the tokens
        self.ctx = (torch.zeros((b, max_len), dtype=torch.int32, **kw)
                    if isinstance(draft, NgramDraft) else None)
        self.out = torch.zeros((b, max_new + g1), dtype=torch.int32, **kw)
        self.last_logits = torch.zeros((b, model.cfg.vocab_size),
                                       dtype=torch.float32, **kw)
        self.prev = torch.zeros((b,), dtype=torch.int32, **kw)
        self.done = torch.zeros((b,), dtype=torch.bool, **kw)
        self.live = torch.ones((b,), dtype=torch.bool, **kw)
        self.stats = torch.zeros((3,), dtype=torch.int32, **kw)
        self.g = torch.zeros((1,), dtype=torch.long, **kw)
        self.stop = torch.zeros((1,), dtype=torch.bool, **kw)
        self.positions = torch.arange(max_len, **kw)[None, :]
        self.prompt_valid = torch.zeros((b, max_len), dtype=torch.bool, **kw)
        self.prompt_len = torch.zeros((b,), dtype=torch.long, **kw)
        self.eos_row = torch.full((b,), eos, dtype=torch.int32, **kw)
        self.chunk_cols = torch.arange(g1, **kw)
        self.stat_base = torch.tensor([1, gamma], dtype=torch.int32, **kw)
        self.graph: Optional[CapturedStep] = None
        self.host_reads = 0

    def _loop_buffers(self):
        """Every buffer the chunk body writes."""
        caches = [t for kv in list(self.cache) + list(self.d_cache)
                  for t in kv]
        ctx = [] if self.ctx is None else [self.ctx]
        return caches + ctx + [self.out, self.last_logits, self.prev,
                               self.done, self.stats, self.g, self.stop]

    def start(self, input_ids: torch.Tensor, prompt_len: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None) -> None:
        """Prefill the target (and a model draft) into the caches, eagerly,
        and reset the loop state. ``row_mask`` (B,) marks the real rows
        (None: all); the others (batch-bucket padding) never hold the
        lockstep commit back, and their tokens are not the greedy ones.
        At least one row must be real."""
        p = self.p
        logits, _ = self.model.prefill(input_ids, prompt_len, self.max_len,
                                       self.cache)
        self.last_logits.copy_(logits)
        if isinstance(self.draft, ModelDraft):
            self.draft.model.prefill(input_ids, prompt_len, self.max_len,
                                     self.d_cache)
        else:
            self.ctx.zero_()
            self.ctx[:, :p] = input_ids
        torch.lt(self.positions, prompt_len[:, None], out=self.prompt_valid)
        self.prompt_len.copy_(prompt_len)
        # the model draft's first cache-sync step rewrites the last prompt
        # column's k/v verbatim (they depend on that column's token only)
        self.prev.copy_(input_ids[:, p - 1])
        if row_mask is None:
            self.live.fill_(True)
        else:
            self.live.copy_(row_mask)
        for t in (self.out, self.done, self.stats, self.g, self.stop):
            t.zero_()
        self.host_reads = 0

    def _valid_through(self, last: torch.Tensor) -> torch.Tensor:
        """The prompt and the generated positions up to ``last``."""
        pos = self.positions
        return self.prompt_valid | ((pos >= self.p) & (pos <= last))

    def _draft(self, idx: torch.Tensor, y_first: torch.Tensor
               ) -> torch.Tensor:
        """(B, gamma) proposals that continue after ``y_first``, at cache
        position ``idx``."""
        if isinstance(self.draft, NgramDraft):
            self.ctx.index_copy_(1, idx, y_first[:, None])
            return ngram_propose(self.ctx, self.prompt_len, self.p,
                                 self.g + 1, self.gamma, self.draft.ngram)
        draft = self.draft.model
        # cache sync: the previous chunk committed through idx - 1, but
        # the draft last wrote k/v for ITS tokens there (a rejected one,
        # or none on full acceptance); re-feeding the last committed token
        # repairs the slot
        draft.decode_step(self.prev, idx - 1, self.d_cache,
                          self._valid_through(idx - 1))
        tok, drafts = y_first, []
        for j in range(self.gamma):
            cur = idx + j
            logits, _ = draft.decode_step(tok, cur, self.d_cache,
                                          self._valid_through(cur))
            tok = logits.argmax(dim=-1).to(torch.int32)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def chunk(self) -> None:
        """One draft/verify chunk: draft gamma tokens after the known next
        one (y_first), score all gamma + 1 in one ``decode_chunk``, commit
        the accepted prefix plus the correction at output offset ``g``
        (the minimum over live rows, never past ``max_new``), and write
        the stop flag."""
        eos, gamma, g1 = self.eos, self.gamma, self.gamma + 1
        idx = self.g + self.p                          # y_first's position
        live_done = self.done | ~self.live
        y_first = torch.where(self.done, self.eos_row,
                              self.last_logits.argmax(dim=-1).to(torch.int32))
        # the profiler's ranges of the two halves (inside a replay the
        # trace shows the captured kernels without them)
        with annotate("spec_draft"):
            drafts = self._draft(idx, y_first)
        chunk_toks = torch.cat([y_first[:, None], drafts], dim=1)
        with annotate("spec_verify"):
            logits, _ = self.model.decode_chunk(
                chunk_toks, idx, self.cache, self._valid_through(idx + gamma))
        preds = logits.argmax(dim=-1).to(torch.int32)  # (B, g1)
        # greedy's continuation under the EOS freeze, and the count of
        # leading drafts that match it
        emit = [y_first]
        cur_done = self.done | (y_first == eos)
        accept = torch.ones_like(self.done)
        acc_count = torch.zeros_like(self.prev)
        for j in range(gamma):
            tok = torch.where(cur_done, self.eos_row, preds[:, j])
            emit.append(tok)
            accept = accept & (drafts[:, j] == tok)
            acc_count = acc_count + accept.int()
            cur_done = cur_done | (tok == eos)
        emit = torch.stack(emit, dim=1)                # (B, g1)
        # lockstep: the fewest committed over live rows
        c_rows = (1 + acc_count).masked_fill(live_done, g1)
        c = torch.minimum(c_rows.min().long().reshape(1),
                          self.max_new - self.g)
        self.out.index_copy_(1, self.g + self.chunk_cols, emit)
        if self.ctx is not None:
            self.ctx.index_copy_(1, idx + self.chunk_cols, emit)
        committed = self.chunk_cols[None, :] < c
        self.done |= ((emit == eos) & committed).any(dim=1)
        self.last_logits.copy_(logits.index_select(1, c - 1)[:, 0])
        self.prev.copy_(emit.index_select(1, c - 1)[:, 0])
        self.stats.add_(torch.cat([self.stat_base, (c - 1).int()]))
        self.g.add_(c)
        torch.logical_or(self.g >= self.max_new,
                         (self.done | ~self.live).all().reshape(1),
                         out=self.stop)

    def capture(self) -> None:
        """Capture :meth:`chunk` into a CUDA graph, after :meth:`start`.
        Its warm-up runs the first chunk; every buffer the body writes is
        put back before the capture and after it, so the first served
        replay starts at the prompt just prefilled."""
        saved = [t.clone() for t in self._loop_buffers()]

        def restore():
            for t, s in zip(self._loop_buffers(), saved):
                t.copy_(s)

        self.graph = CapturedStep(self.chunk, reset=restore)
        restore()

    def run(self, graphed: bool) -> None:
        """Chunks until the stop flag reads true: one host read each."""
        while True:
            if graphed:
                self.graph.replay()
            else:
                self.chunk()
            self.host_reads += 1
            if bool(self.stop.item()):
                return

    def finish(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tokens (B, max_new) int32, gen_len (B,) int32, stats (3,)
        int32 = [chunks, drafted, accepted]). Past the stop point every
        live row is done, and greedy emits EOS after EOS."""
        cols = torch.arange(self.out.shape[1], device=self.out.device)
        tokens = self.out.masked_fill(cols[None, :] >= self.g,
                                      self.eos)[:, :self.max_new]
        return tokens, decode_lengths(tokens, self.eos), self.stats.clone()


def speculative_decode(model, input_ids: torch.Tensor,
                       prompt_len: torch.Tensor, max_new_tokens: int,
                       eos_token: int, gamma: int,
                       draft: Union[NgramDraft, ModelDraft],
                       row_mask: Optional[torch.Tensor] = None,
                       graphs: Optional[Dict[tuple, SpecDecodeState]] = None,
                       graphed: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draft/verify greedy decode: input_ids (B, P) right-padded,
    prompt_len (B,) -> (generated (B, max_new_tokens) int32, gen_len (B,)
    int32, stats (3,) int32 = [chunks, drafted, accepted]); the tokens
    and lengths of :func:`greedy_decode` at temperature 0 for every row
    ``row_mask`` marks real.

    ``graphed`` (default: on a CUDA device) replays the captured chunk
    body until its stop flag reads true; the state and its graph are kept
    in ``graphs`` under (B, P, max_new_tokens, eos_token, gamma, draft)
    and captured on first use. A capture failure raises.
    ``graphed=False`` runs the same body eagerly."""
    b, p = input_ids.shape
    if graphed is None:
        graphed = input_ids.device.type == "cuda"
    key = (b, p, max_new_tokens, eos_token, gamma, draft)
    state = None if graphs is None else graphs.get(key)
    if state is None:
        state = SpecDecodeState(model, b, p, max_new_tokens, eos_token,
                                gamma, draft, input_ids.device)
        if graphs is not None:
            graphs[key] = state
    state.start(input_ids, prompt_len, row_mask)
    if graphed and state.graph is None:
        state.capture()
    state.run(graphed)
    return state.finish()
