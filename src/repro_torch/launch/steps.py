"""The train step: forward → ``loss_fn`` → backward → AdamW, in place.

Twin of ``repro/launch/steps.py``'s ``build_train_step``, on one device:
the reference's shardings, its ``build_prefill_step`` and
``build_decode_step`` and the dry-run's abstract arguments wait for the
mesh (ROADMAP.md §1, item 11). Where the reference's jitted step donates
the old parameters and returns new ones, this step updates the model's
parameters in place and returns the new optimizer state.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..models.transformer import Transformer, loss_fn
from ..optim import adamw

TrainStep = Callable[[Transformer, adamw.OptState, Dict[str, np.ndarray]],
                     Tuple[adamw.OptState, Dict[str, object]]]


def build_train_step(cfg: ModelConfig, run: RunConfig) -> TrainStep:
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``.

    ``batch`` holds "tokens" (B, S) ids, or (B, S, M) embeddings for a
    frontend arch, and "targets" (B, S), numpy or torch; they move to the
    model's device. ``metrics`` holds the device scalars "loss", "nll",
    "aux" and "grad_norm" and the host float "lr". A parameter that the
    loss does not reach (a frontend arch's untied ``embed``) gets a zero
    gradient, as ``jax.grad`` gives it.
    """
    def train_step(model: Transformer, opt_state: adamw.OptState,
                   batch: Dict[str, np.ndarray]) -> Tuple[adamw.OptState, Dict[str, object]]:
        if model.cfg != cfg:
            raise ValueError(f"train step built for {cfg.name}, model is {model.cfg.name}")
        dev = model.device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if not tokens.is_floating_point():
            tokens = tokens.long()
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, metrics = loss_fn(model, tokens, targets, remat=run.remat)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        opt_state, om = adamw.update(grads, opt_state, params, run)
        for p in params.values():
            p.grad = None
        out = {"loss": loss.detach(), "nll": metrics["nll"].detach(),
               "aux": metrics["aux"].detach(), **om}
        return opt_state, out

    return train_step
