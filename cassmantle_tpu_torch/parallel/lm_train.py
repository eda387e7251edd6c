"""Causal-LM training on one device.

Port of ``cassmantle_tpu/parallel/lm_train.py``: the next-token loss with
pad positions masked out, over the port's ``GPT2LM`` or ``MistralLM``
(both take ``forward(input_ids, valid)``), with the optimizer of
``parallel/train.py`` (fp32 parameters and state, compute in the model's
dtype, logits in fp32 from the models' LM heads). Like the diffusion
trainers it owns its module and updates it in place.

The reference's context-parallel mode (``context_parallel=True``,
``prepare_long_context_batch``: sequences zigzag-permuted and sharded
over a mesh axis) needs more than one device: ROADMAP Queue 1 item 16's
training half. The constructor refuses it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.parallel.train import (
    ClipAdamW,
    Mesh,
    differentiated_forward,
    make_optimizer,
    require_one_device,
)
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device

# the pipelines' seed offsets (serving/pipeline.py::INIT_SEEDS)
LM_INIT_SEED = 5


def masked_ce(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean fp32 cross-entropy over the positions where ``mask`` is
    nonzero (at least one position in the denominator)."""
    losses = F.cross_entropy(logits.float().flatten(0, -2),
                             targets.long().flatten(),
                             reduction="none").view(targets.shape)
    maskf = mask.float()
    return (losses * maskf).sum() / maskf.sum().clamp_min(1.0)


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                    loss_mask: torch.Tensor) -> torch.Tensor:
    """Mean masked cross-entropy of logits[:, :-1] against ids[:, 1:]."""
    return masked_ce(logits[:, :-1], input_ids[:, 1:], loss_mask[:, 1:])


class LMTrainer:
    """Next-token training of ``model`` (a port LM module; built on
    ``device`` already, or moved there by :meth:`init_state`)."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh = None,
                 lr: float = 3e-4, remat: bool = False,
                 context_parallel: bool = False,
                 device: DeviceLike = "cuda") -> None:
        require_one_device(mesh)
        if context_parallel:
            raise NotImplementedError(
                "context_parallel shards the sequence across devices: "
                "ROADMAP Queue 1 item 16's training half")
        self.device = resolve_device(device)
        self.model = model
        self.lr = lr
        self.remat = remat
        self.optimizer: Optional[ClipAdamW] = None

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> None:
        """The model's fp32 parameters on the device (``state_dict``, or a
        seeded init) and fresh optimizer state."""
        self.model.to(self.device, torch.float32)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            init_weights(self.model, torch.Generator(
                self.device).manual_seed(seed + LM_INIT_SEED))
        self.model.requires_grad_(True).train()
        self.optimizer = make_optimizer(self.model.named_parameters(),
                                        self.lr)

    def place_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Host rows -> int64 ``input_ids`` and ``loss_mask`` on the
        device."""
        return {k: torch.as_tensor(v).to(self.device, torch.int64)
                for k, v in batch.items()}

    def loss_and_grads(self, batch: Mapping[str, torch.Tensor]
                       ) -> torch.Tensor:
        ids, mask = batch["input_ids"], batch["loss_mask"]
        self.optimizer.zero_grad()
        logits = differentiated_forward(self.model, self.remat, ids,
                                        mask.bool())
        loss = next_token_loss(logits, ids, mask)
        loss.backward()
        return loss.detach()

    def step(self, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step; the forward draws nothing (``generator`` is taken for
        the diffusion trainers' signature). The loss stays on the
        device."""
        del generator
        loss = self.loss_and_grads(batch)
        self.optimizer.step()
        return loss

    def model_state(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def load_model_state(self, state: Mapping[str, torch.Tensor]) -> None:
        self.model.load_state_dict(state)
