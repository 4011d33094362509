"""Step builders: train / prefill / decode, with their shardings.

Twin of ``repro/launch/steps.py``. ``build_step(cfg, shape, run, mesh)``
returns (step, example args): the args are meta tensors (shapes only,
nothing allocated; DTensors placed on ``mesh``), so the dry run runs the
step without any weights. ``mesh=None`` is one device, with plain tensors.

A step runs the ``Transformer`` on whatever its tensors are:

- On the dry run's production meshes the parameters, moments and data are
  DTensors: each op runs on this device's shards plus the collectives its
  placements need, and the kernels meet the DTensors only through
  ``distributed.sharding.on_local_shards``.
- On a real mesh (``launch.mesh.make_local_mesh``: 1 × 1) the caller places
  its tensors with ``place`` and hands the step their local shards, which on
  1 × 1 are the whole tensors; a DTensor argument (data from
  ``data_structs``, moments from ``adamw.init(..., shardings=)`` or a
  restore) is unwrapped to its shard at the step's edge. The kernels launch
  on plain tensors exactly as in ``launch.serve`` and ``launch.train``.

Where the reference's jitted train step donates the old parameters and
returns new ones, this step updates the model's parameters in place and
returns the new optimizer state. The decode step runs on the port's own
caches (``PagedKVPool``, the sliding-window ring, the latent cache, the SSM
state; ``Transformer.init_cache``), not on the reference's dense cache,
updating them in place; its ``cur_index`` is a host array, since the page
planner plans on the host.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..distributed.sharding import (batch_spec, distribute, is_dtensor, optim_rules,
                                    placements, rules_for, tree_shardings)
from ..models.transformer import Transformer, logical_axes, loss_fn
from ..optim import adamw
from ..spans import span

Placements = Dict[str, tuple]
TrainStep = Callable[[Transformer, adamw.OptState, Dict[str, Any]],
                     Tuple[adamw.OptState, Dict[str, object]]]


# ---------------------------------------------------------------------------
# structs and placement
# ---------------------------------------------------------------------------

def param_structs(cfg: ModelConfig) -> Tuple[Transformer, Dict[str, tuple]]:
    """(a ``Transformer`` on the meta device, its logical axes): the
    parameters' shapes and dtypes, nothing allocated."""
    model = Transformer(cfg, device="meta")
    return model, logical_axes(model)


def data_structs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> Dict[str, torch.Tensor]:
    """Meta tensors (with ``batch_spec`` placements on a mesh) for the step's
    data inputs, the reference's shapes and dtypes: token ids int32, or
    (…, d_model) bf16 embeddings for a frontend arch."""
    B, S = shape.global_batch, shape.seq_len
    pl = placements(batch_spec(mesh, B), mesh) if mesh is not None else ()

    def sds(shp, dtype=torch.int32):
        t = torch.empty(shp, dtype=dtype, device="meta")
        return t if mesh is None else distribute(t, mesh, pl)

    if shape.kind == "train":
        tok = sds((B, S, cfg.d_model), torch.bfloat16) if cfg.frontend else sds((B, S))
        return {"tokens": tok, "targets": sds((B, S))}
    if shape.kind == "prefill":
        tok = sds((B, S, cfg.d_model), torch.bfloat16) if cfg.frontend else sds((B, S))
        return {"tokens": tok}
    # decode: one new token against a seq_len cache
    tok = sds((B, cfg.d_model), torch.bfloat16) if cfg.frontend else sds((B,))
    return {"token": tok, "cur_index": sds((B,))}


def shardings(cfg: ModelConfig, model: nn.Module, mesh) -> Tuple[Placements, Placements]:
    """(parameter placements under ``rules_for``, moment placements under
    ``optim_rules``: ZeRO-1 adds "embed" → "data")."""
    params, axes = dict(model.named_parameters()), logical_axes(model)
    return (tree_shardings(params, axes, mesh, rules_for(cfg)),
            tree_shardings(params, axes, mesh, optim_rules(cfg)))


def place(tree: Dict[str, torch.Tensor], pls: Placements, mesh) -> Dict[str, torch.Tensor]:
    """Each tensor of ``tree`` distributed onto ``mesh`` with its placements."""
    return {n: distribute(t, mesh, pls[n]) for n, t in tree.items()}


def place_model(model: Transformer, pls: Placements, mesh, *, local: bool) -> Transformer:
    """The model's parameters distributed onto ``mesh`` in place: as DTensors
    (the dry run), or (``local``) as this device's shards, plain tensors."""
    placed = place(dict(model.named_parameters()), pls, mesh)
    for name, t in placed.items():
        owner, _, leaf = name.rpartition(".")
        old = getattr(model.get_submodule(owner), leaf)
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(t.to_local() if local else t, requires_grad=old.requires_grad))
    return model


def local(t):
    """A DTensor's local shard; anything else as it is."""
    return t.to_local() if is_dtensor(t) else t


def dtensor_mode(model: Transformer):
    """DTensor ops meet plain tensors made inside the model (positions,
    masks) as replicated ones."""
    if not is_dtensor(model.embed):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _inputs(model: Transformer, *tensors):
    """The step's data on the model's terms: unwrapped to this device's
    shards for a model of plain tensors; ids as int64 for the lookup."""
    out = []
    for t in tensors:
        if not is_dtensor(model.embed):
            t = torch.as_tensor(local(t), device=model.device)
        out.append(t if t.is_floating_point() else t.long())
    return out


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, run: RunConfig, mesh=None) -> TrainStep:
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``.

    ``batch`` holds "tokens" (B, S) ids, or (B, S, M) embeddings for a
    frontend arch, and "targets" (B, S), numpy or torch; they move to the
    model's device. ``metrics`` holds the device scalars "loss", "nll",
    "aux" and "grad_norm" and the host float "lr". A parameter that the
    loss does not reach (a frontend arch's untied ``embed``) gets a zero
    gradient, as ``jax.grad`` gives it. With a ``mesh`` the moments are
    expected placed by ``optim_rules`` (``adamw.init(..., shardings=)``);
    for a model of plain tensors they are unwrapped to their shards here.
    """
    def train_step(model: Transformer, opt_state: adamw.OptState,
                   batch: Dict[str, Any]) -> Tuple[adamw.OptState, Dict[str, object]]:
        if model.cfg != cfg:
            raise ValueError(f"train step built for {cfg.name}, model is {model.cfg.name}")
        tokens, targets = _inputs(model, batch["tokens"], batch["targets"])
        if mesh is not None and not is_dtensor(model.embed):
            opt_state = adamw.local_state(opt_state)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with dtensor_mode(model):
            with span("train.forward"):
                loss, metrics = loss_fn(model, tokens, targets, remat=run.remat)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                         for n, p in params.items()}
                opt_state, om = adamw.update(grads, opt_state, params, run)
        for p in params.values():
            p.grad = None
        out = {"loss": loss.detach(), "nll": metrics["nll"].detach(),
               "aux": metrics["aux"].detach(), **om}
        return opt_state, out

    return train_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, mesh=None):
    """(``prefill_step(model, batch) -> (last-position logits, decode cache)``,
    (parameter structs,), (parameter placements,)). The cache is the arch's
    decode cache sized to the prompt (``Transformer.init_cache``)."""
    structs, p_shard = _structs(cfg, mesh)

    @torch.no_grad()
    def prefill_step(model: Transformer, batch: Dict[str, Any]):
        (tokens,) = _inputs(model, batch["tokens"])
        B, S = tokens.shape[:2]
        with dtensor_mode(model):
            cache = model.init_cache(B, S)
            return model.prefill(tokens, cache), cache

    return prefill_step, (structs,), (p_shard,)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(``decode_step(model, cache, token, cur_index) -> (logits, cache)``,
    (parameter structs, a meta cache of ``shape``), (parameter placements,)).

    One token a sequence against a ``shape.seq_len`` cache, on the port's own
    decode cache (paged K/V, ring, latent or SSM state; built by
    ``model.init_cache``), updated in place; ``cur_index`` is the host's (B,)
    positions of the tokens being decoded."""
    structs, p_shard = _structs(cfg, mesh)
    cache = structs.init_cache(shape.global_batch, shape.seq_len)

    @torch.no_grad()
    def decode_step(model: Transformer, cache, token, cur_index: np.ndarray):
        (token,) = _inputs(model, token)
        with dtensor_mode(model):
            return model.decode_step(cache, token, np.asarray(cur_index)), cache

    return decode_step, (structs, cache), (p_shard,)


def build_step(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, mesh=None
               ) -> Tuple[Callable, Tuple]:
    """(step, example args in call order): meta structs on ``mesh``; a decode
    step's ``cur_index`` is every sequence at the cache's last position."""
    data = data_structs(cfg, shape, mesh)
    if shape.kind == "train":
        model, _ = _structs(cfg, mesh)
        model.requires_grad_(True)
        opt = adamw.init(dict(model.named_parameters()), run,
                         shardings=None if mesh is None else shardings(cfg, model, mesh)[1],
                         mesh=mesh)
        return build_train_step(cfg, run, mesh), (model, opt, data)
    if shape.kind == "prefill":
        step, (model,), _ = build_prefill_step(cfg, shape, run, mesh)
        return step, (model, {"tokens": data["tokens"]})
    step, (model, cache), _ = build_decode_step(cfg, shape, mesh)
    cur = np.full(shape.global_batch, shape.seq_len - 1, np.int64)
    return step, (model, cache, data["token"], cur)


def _structs(cfg: ModelConfig, mesh) -> Tuple[Transformer, Optional[Placements]]:
    """The meta model, its parameters DTensors placed by ``rules_for`` on a mesh."""
    model, _ = param_structs(cfg)
    if mesh is None:
        return model, None
    p_shard = shardings(cfg, model, mesh)[0]
    return place_model(model, p_shard, mesh, local=False), p_shard
