"""AdamW with warmup-cosine schedule, global-norm clipping, and optional
int8 gradient compression with error feedback.

Twin of ``repro/optim/adamw.py``. The state's moments (and the error
feedback residual) are f32 dicts keyed by parameter name
(``model.named_parameters()``). ``update`` computes each step in f32 under
``torch.no_grad()`` and writes the result back into the parameter in its
own dtype, in place; it returns a new ``OptState`` whose m and v are new
tensors, so a state handed to an asynchronous reader (the offload of
``m`` in ``launch.train``) is never written again. ``init(..., shardings=,
mesh=)`` places the moments on a mesh as DTensors, as the reference's
ZeRO-1 ``optim_rules`` shard them ("embed" over "data");
``launch.steps`` unwraps them to this device's shards for a model of plain
tensors, and the dry run updates them as DTensors.

Weight decay goes on tensors of ``ndim >= 2``, the reference's "matrices
only". The reference stacks its block parameters on a leading layer axis,
so there a block's norm weights and biases are 2-D and decayed too; the
port's are 1-D per layer and are not (only the decay of those vectors
differs).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import RunConfig
from ..distributed.sharding import distribute

Tensors = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor           # () int32, on the host
    m: Tensors                   # f32
    v: Tensors                   # f32
    err: Optional[Tensors]       # error-feedback residual (grad compression)


def lr_schedule(step: int, run: RunConfig) -> float:
    warm = min(step / max(run.warmup_steps, 1), 1.0)
    prog = min(max((step - run.warmup_steps) /
                   max(run.total_steps - run.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return run.learning_rate * warm * (0.1 + 0.9 * cos)


def init(params: Tensors, run: RunConfig, *, shardings: Optional[Dict[str, tuple]] = None,
         mesh=None) -> OptState:
    """Zero moments (and residual) in f32; with ``shardings`` ({name:
    placements}) each a DTensor on ``mesh`` with those placements."""
    def zeros() -> Tensors:
        out = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        if shardings is None:
            return out
        return {n: distribute(t, mesh, shardings[n]) for n, t in out.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32), m=zeros(), v=zeros(),
                    err=zeros() if run.grad_compression else None)


def local_state(state: OptState) -> OptState:
    """The state with every DTensor moment replaced by this device's shard."""
    def loc(tree: Optional[Tensors]) -> Optional[Tensors]:
        if tree is None:
            return None
        return {n: t.to_local() if hasattr(t, "to_local") else t for n, t in tree.items()}
    return OptState(state.step, loc(state.m), loc(state.v), loc(state.err))


@torch.no_grad()
def compress_grads(grads: Tensors, err: Tensors) -> Tuple[Tensors, Tensors]:
    """int8 quantization with error feedback: (dequantized grads, new residual).

    Each tensor is quantized against its own max-abs scale (round half to
    even, as ``jnp.round``); the residual carries what the int8 values lost
    into the next step.
    """
    deq, new_err = {}, {}
    for n, g in grads.items():
        g = g.float() + err[n]
        scale = g.abs().max().clamp(min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq[n] = q.float() * scale
        new_err[n] = g - deq[n]
    return deq, new_err


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Grads scaled to a global L2 norm of at most ``max_norm``; (grads, norm).
    The scale stays on the device: no host sync."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / gn.clamp(min=1e-12), max=1.0)
    return {n: g * scale for n, g in grads.items()}, gn


@torch.no_grad()
def update(grads: Tensors, state: OptState, params: Tensors, run: RunConfig,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8
           ) -> Tuple[OptState, Dict[str, object]]:
    """One AdamW step: ``params`` are updated in place; returns (new state,
    {"lr", "grad_norm"})."""
    step = int(state.step) + 1
    new_err = state.err
    if run.grad_compression and state.err is not None:
        grads, new_err = compress_grads(grads, state.err)
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    lr = lr_schedule(step, run)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    new_m, new_v = {}, {}
    for n, p in params.items():
        g = grads[n].float()
        m = b1 * state.m[n] + (1 - b1) * g
        v = b2 * state.v[n] + (1 - b2) * g.square()
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            upd = upd + run.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        new_m[n], new_v[n] = m, v
    new_state = OptState(torch.tensor(step, dtype=torch.int32), new_m, new_v, new_err)
    return new_state, {"lr": lr, "grad_norm": gnorm}
