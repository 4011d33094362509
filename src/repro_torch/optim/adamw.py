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

On the card ``update`` runs the whole step in two launches of one
hand-written kernel (``kernels/adamw``: the global norm, then the clip, both
moments, the decay and the write-back over every leaf at once). DTensor
leaves of a one-device mesh go to it as their shards, and their new moments
come back as DTensors with the old ones' placements. Leaves off the card
(CPU tensors, the dry run's meta tensors, DTensors or not) take the plain
loop in ``kernels/adamw/ref.py``; ``kernels.adamw.ops.plain_reason``
decides, and raises for leaves on the card the kernel has no instance for.
Both clip in f32, as the reference does. ``snapshot()`` counts the steps
each way and says why the last plain one was plain.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import RunConfig
from ..distributed.sharding import distribute, is_dtensor
from ..kernels.adamw import ops
from ..kernels.adamw.ref import adamw_plain, clip_by_global_norm_plain

Tensors = Dict[str, torch.Tensor]

fused_steps = 0                             # update steps through the kernel
plain_steps = 0                             # and through the plain loop
last_plain_reason: Optional[str] = None     # why the last plain step was plain


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
        return {n: ops.local(t) for n, t in tree.items()}
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


# the reference's name; ``update`` on the card takes the kernel's norm
clip_by_global_norm = clip_by_global_norm_plain


@torch.no_grad()
def update(grads: Tensors, state: OptState, params: Tensors, run: RunConfig,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8
           ) -> Tuple[OptState, Dict[str, object]]:
    """One AdamW step: ``params`` are updated in place; returns (new state,
    {"lr", "grad_norm"})."""
    global fused_steps, plain_steps, last_plain_reason
    step = int(state.step) + 1
    new_err = state.err
    if run.grad_compression and state.err is not None:
        grads, new_err = compress_grads(grads, state.err)
    lr = lr_schedule(step, run)
    hyper = dict(lr=lr, bc1=1 - b1 ** step, bc2=1 - b2 ** step, b1=b1, b2=b2, eps=eps,
                 weight_decay=run.weight_decay)
    names = list(params)
    leaves = [[tree[n] for n in names] for tree in (grads, params, state.m, state.v)]
    reason = ops.plain_reason(*leaves)
    if reason is None:
        m, v, gnorm = ops.adamw_fused(*([ops.local(t) for t in group] for group in leaves),
                                      **hyper, max_norm=run.grad_clip)
        new_m = {n: placed_as(state.m[n], t) for n, t in zip(names, m)}
        new_v = {n: placed_as(state.v[n], t) for n, t in zip(names, v)}
        fused_steps += 1
    else:
        clipped, gnorm = clip_by_global_norm_plain(grads, run.grad_clip)
        new_m, new_v = adamw_plain(clipped, state.m, state.v, params, **hyper)
        plain_steps += 1
        last_plain_reason = reason
    new_state = OptState(torch.tensor(step, dtype=torch.int32), new_m, new_v, new_err)
    return new_state, {"lr": lr, "grad_norm": gnorm}


def placed_as(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new``, this device's whole leaf, as a DTensor with ``old``'s mesh
    and placements when ``old`` is one; else as it is."""
    if not is_dtensor(old):
        return new
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(new, old.device_mesh, old.placements, run_check=False)


def snapshot() -> Dict[str, object]:
    """Steps of ``update`` through the kernel and through the plain loop since
    the last ``reset``, why the last plain one was plain, and the kernel's
    launches."""
    return {"fused_steps": fused_steps, "plain_steps": plain_steps,
            "plain_reason": last_plain_reason, "launches": ops.launches}


def reset() -> None:
    global fused_steps, plain_steps, last_plain_reason
    fused_steps = plain_steps = 0
    last_plain_reason = None
    ops.launches = 0
