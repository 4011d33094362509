"""Mixture-of-Experts with sort-based capacity dispatch.

Twin of ``repro/models/moe.py``. Tokens are routed top-k, their gates
renormalised, the (token, expert) pairs stably sorted by expert and packed
into per-expert buffers of capacity ``C`` (pairs past an expert's capacity
go to a trash row and are dropped), the experts run as batched SwiGLU
products over (E, C, M), and each kept pair's output, weighted by its gate,
is added back to its token in f32. Shared experts are one dense SwiGLU of
width ``num_shared_experts · moe_d_ff``.

The reference scatter-adds the pairs' outputs (``.at[src].add``). Here both
directions are gathers, so the layer repeats bit for bit on the card: an
``index_add_`` into a CUDA tensor, or the backward of ``xt[src]`` (an
accumulate over repeated indices), adds with atomics in an order that
changes from run to run. Each token's K slots (a (T, K) slot map, a zero row
for a dropped pair) are gathered and summed over k in order, and the
buffers' gradient gathers back by the same maps (``_Dispatch``,
``_Combine``): the values are the same sums.

``cfg.moe_shard_map`` (the ``moe`` knob, ``configs/optimized.py``) is the
reference's shard-local dispatch, ``_moe_shard_map``. On a mesh with a
"model" axis each (pod, data) shard routes only its own tokens, over all E
experts with the full router, keeps the pairs whose expert lies on its model
shard (EP: E / model experts a shard, where E divides the axis under the
config's rules, deepseek) or runs every expert on its slice of ``moe_d_ff``
(TP, qwen2-moe), with capacity from its own token count, adds the shared
experts on their ``ffn`` shard, and sums over "model" once: one all-reduce
of (T_local, M) in f32 where the global dispatch replicates every token onto
every device. Where the reference's returns ``None`` (no DTensor, no "model"
axis, neither layout divides) the global dispatch runs. The expert products
are plain batched products in the reference too, outside any Pallas kernel,
so here they stay torch products. Every step stays on the device: no host
sync. Without the knob, in a step on a mesh (DTensors) the layer's tokens
are replicated onto every device first, so the routing, and with it the
sort, slots and aux counts (plain tensors), is the global one, as the
reference's default dispatch is; the expert products split as the expert
weights are sharded.

``cfg.moe_dropless`` (the port's own, ``configs/base.py`` ``PORT_ONLY``) keeps
every pair, as DeepSeek serves: under a capacity a token's output would
depend on which other sequences share its step, and at a prefill of 131,072
tokens a capacity of T would be an E·T·M buffer of 34 GB a layer. The pairs,
sorted by expert, run through the three expert products as grouped products
over the sorted rows (``torch._grouped_mm``; each expert's rows end at an
offset counted on the device), and each token's K rows are summed in order of
k, weighted by their gates in f32, so the layer repeats bit for bit. No step
waits for the host, so a decode step with it replays as a CUDA graph too.
Where a gradient is wanted the same operations run inside ``_DroplessExperts``,
whose backward has no atomics (autograd's of the gather of the sorted rows
and of the combine's gathers would add into repeated rows): the three
products' input and weight gradients are grouped products over the same
rows, each gate's gradient a dot product a row, and each token's input
gradient the sum of its K rows in order of k, in f32, so a training step
repeats bit for bit too. ``cfg.norm_topk_prob`` false takes the gates as the
softmax router gives them, unnormalised.

The balance loss is the Switch-style one over the whole batch, or with
``cfg.moe_seq_aux`` (the port's own, DeepSeek-V2's ``seq_aux``) per sequence:
for each sequence of S tokens f_i = E/(K·S) · (pairs it sends to expert i)
and P_i = the mean over its tokens of the router's probability of i, and
aux = ``router_aux_weight`` · Σ_i f_i · P_i, averaged over the sequences, as
the release's ``MoEGate`` computes it. It is computed only where a gradient
is wanted (a step in ``no_grad``, serving, returns 0 for it).

Every call adds its routing to a counter kept on the device
(``MoE.routed``: pairs routed to each expert, and pairs dropped, summed over
calls; one add a call, no host sync), which ``MoE.snapshot`` reads. The
spans ``moe.route`` (router, top-k, sort), ``moe.experts`` (the expert
products) and ``moe.combine`` (gates and the sum back to tokens) split the
layer on a profiler's timeline, and ``moe.backward`` holds the dropless
layer's backward.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (flatten, is_dtensor, mesh_shape, reshape_replicated,
                                    settle, split_rows)
from ..spans import span
from .layers import swiglu, weight


class MoE(nn.Module):
    """The reference's ``init_moe`` leaves, under its names: ``router`` (f32),
    ``wi``/``wg`` (E, M, F), ``wo`` (E, F, M) and the ``shared_*`` SwiGLU."""

    AXES = {"router": ("embed", None), "wi": ("experts", "embed", "moe_ff"),
            "wg": ("experts", "embed", "moe_ff"), "wo": ("experts", "moe_ff", "embed"),
            "shared_wi": ("embed", "ffn"), "shared_wg": ("embed", "ffn"),
            "shared_wo": ("ffn", "embed")}

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        M, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = weight(M, E, device=device, dtype=torch.float32)
        self.wi = weight(E, M, Fe, device=device)
        self.wg = weight(E, M, Fe, device=device)
        self.wo = weight(E, Fe, M, device=device)
        if cfg.num_shared_experts:
            Fs = cfg.num_shared_experts * Fe
            self.shared_wi = weight(M, Fs, device=device)
            self.shared_wg = weight(M, Fs, device=device)
            self.shared_wo = weight(Fs, M, device=device)
        self.routed: Optional[torch.Tensor] = None    # (E + 1,) int64: pairs by expert, dropped

    def count(self, record: torch.Tensor) -> None:
        """Adds one call's (E + 1,) record (pairs routed to each expert, then
        pairs dropped) to ``routed``, made on the record's device at first."""
        if record.device.type == "meta":
            return
        if self.routed is None or self.routed.device != record.device:
            self.routed = torch.zeros_like(record, dtype=torch.int64)
        self.routed += record

    def snapshot(self) -> Dict[str, float]:
        """Pairs routed over every call so far, the most and the mean an expert
        took, and the pairs dropped (a host sync: read it after serving)."""
        if self.routed is None:
            return {"pairs": 0, "most": 0, "mean": 0.0, "dropped": 0}
        per = self.routed[:-1].cpu()
        return {"pairs": int(per.sum()), "most": int(per.max()),
                "mean": float(per.float().mean()), "dropped": int(self.routed[-1])}


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer rows: the reference's ``_capacity``."""
    cap = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8


class _Dispatch(torch.autograd.Function):
    """grouped = xt[src] · occupied (E·C, M); its gradient gathers each
    token's K slots (``slot_map`` (T, K), E·C for a dropped pair) and sums
    them over k, where autograd's would add into repeated rows."""

    @staticmethod
    def forward(ctx, xt, src, occupied, slot_map):
        ctx.save_for_backward(slot_map)
        return xt[src] * occupied[:, None].to(xt.dtype)

    @staticmethod
    def backward(ctx, dgrouped):
        (slot_map,) = ctx.saved_tensors
        return _gather_sum(dgrouped, slot_map), None, None, None


class _Combine(torch.autograd.Function):
    """y (T, M) = each token's K slots of ``contrib`` (E·C, M) summed over k
    in order (a zero row for a dropped pair); its gradient is dy gathered by
    each occupied slot's token."""

    @staticmethod
    def forward(ctx, contrib, slot_map, src, occupied):
        ctx.save_for_backward(src, occupied)
        return _gather_sum(contrib, slot_map)

    @staticmethod
    def backward(ctx, dy):
        src, occupied = ctx.saved_tensors
        return dy[src] * occupied[:, None].to(dy.dtype), None, None, None


def _gather_sum(rows: torch.Tensor, slot_map: torch.Tensor) -> torch.Tensor:
    """out[t] = Σ_k rows[slot_map[t, k]] in order of k; index len(rows) is a
    zero row."""
    padded = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    picked = padded[slot_map]                                        # (T, K, M)
    out = picked[:, 0]
    for k in range(1, slot_map.shape[1]):
        out = out + picked[:, k]
    return out


def _slots(local_e: torch.Tensor, E: int, C: int):
    """Sort-based slots of the (token, expert) pairs of ``local_e`` (T, K) in E
    buffers of C rows; an id of E marks a pair whose expert lies outside this
    slice (sorted last, never kept). Returns (order, the stable sort of the
    pairs by expert; valid, each sorted pair kept; slot, its row, E·C (the
    trash row) when dropped; src (E·C,), each row's token; occupied (E·C,);
    slot_map (T, K), pair t·K + k's row, E·C when dropped)."""
    T, K = local_e.shape
    dev = local_e.device
    flat_e = local_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E + 1, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[sorted_e]
    valid = (rank < C) & (sorted_e < E)
    slot = torch.where(valid, sorted_e * C + rank, E * C)
    token_of = order // K

    src = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    src[slot] = token_of
    occupied = torch.zeros(E * C + 1, dtype=torch.bool, device=dev)
    occupied[slot] = valid
    slot_map = torch.empty(T * K, dtype=torch.long, device=dev)
    slot_map[order] = slot
    return order, valid, slot, src[:-1], occupied[:-1], slot_map.view(T, K)


def _dispatch_core(xt: torch.Tensor, p, cfg: ModelConfig, offset: int, E_loc: int,
                   wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor, seqs: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch of ``xt`` (T, M) to the ``E_loc`` experts
    whose weights are ``wi``/``wg``/``wo``, global expert ids offset by
    ``offset`` (an EP slice): the reference's ``_dispatch_core``. Routes over
    all E experts with ``p.router``, keeps the pairs whose expert lies in
    [offset, offset + E_loc), capacity from T. Returns (y (T, M) f32, this
    slice's part of the output; aux, over the global experts and ``seqs``
    sequences of T/seqs tokens)."""
    T = xt.shape[0]
    dev = xt.device

    with span("moe.route"):
        gate, expert_idx, counts, aux = _route(xt, p, cfg, seqs)
        C = capacity(T, cfg)
        local_e = expert_idx - offset
        local_e = torch.where((local_e >= 0) & (local_e < E_loc), local_e, E_loc)
        order, valid, slot, src, occupied, slot_map = _slots(local_e, E_loc, C)

    with span("moe.experts"):
        grouped = split_rows(_Dispatch.apply(xt, src, occupied, slot_map), E_loc, C)
        h = torch.bmm(grouped, wi)                                    # (E_loc, C, M) in
        g = torch.bmm(grouped, wg)
        yg = flatten(torch.bmm(h * F.silu(g), wo), 0, 1)              # (E_loc·C, M)

    with span("moe.combine"):
        w_slot = torch.where(valid, gate.reshape(-1)[order], 0.0)
        w_of_slot = torch.zeros(E_loc * C + 1, device=dev).index_put((slot,), w_slot)[:-1]
        y = _Combine.apply(yg.float() * w_of_slot[:, None] * occupied[:, None], slot_map,
                           src, occupied)
    if isinstance(p, MoE) and not is_dtensor(xt):
        routed = counts.long()
        p.count(torch.cat([routed, (routed - C).clamp(min=0).sum()[None]]))
    return y, aux


def _route(xt: torch.Tensor, p, cfg: ModelConfig, seqs: int = 1):
    """(gates (T, K) f32, expert ids (T, K), pairs each global expert took (E,)
    f32, aux): the softmax router's top-k, the gates renormalised to sum to 1
    unless ``cfg.norm_topk_prob`` is false, and the balance loss: over the
    whole batch (Switch-style, aux = w·E·Σ_i mean_t(p_ti)·pairs_i/(T·K)), or
    with ``cfg.moe_seq_aux`` over each of the ``seqs`` sequences of T/seqs
    consecutive tokens (``_seq_aux``), then averaged."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ p.router.float(), dim=-1)     # (T, E)
    gate, expert_idx = torch.topk(probs, K, dim=-1)                   # (T, K)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    if is_dtensor(expert_idx):     # replicated: the routing is the same on every device
        expert_idx = expert_idx.to_local()
    flat_e = expert_idx.reshape(-1)                                   # (T·K,)
    ones = torch.ones(T * K, device=xt.device)
    counts = torch.zeros(E, device=xt.device).index_add_(0, flat_e, ones)
    if cfg.moe_seq_aux:
        aux = _seq_aux(probs, expert_idx, seqs, cfg)
    else:
        aux = cfg.router_aux_weight * E * torch.sum(probs.mean(dim=0) * (counts / (T * K)))
    return gate, expert_idx, counts, aux


def _seq_aux(probs: torch.Tensor, expert_idx: torch.Tensor, seqs: int, cfg: ModelConfig
             ) -> torch.Tensor:
    """The release's sequence-wise balance loss (``MoEGate`` with ``seq_aux``):
    per sequence f_i = E/(K·S)·(its pairs to expert i), P_i = its tokens'
    mean probability of i; w·Σ_i f_i·P_i averaged over the sequences. Zero
    where no gradient is wanted, so serving does none of this work."""
    if not (torch.is_grad_enabled() and probs.requires_grad):
        return probs.new_zeros(())
    T, E = probs.shape
    K, S = cfg.top_k, T // seqs
    picks = torch.zeros(seqs, E, device=probs.device).scatter_add_(
        1, expert_idx.reshape(seqs, S * K), torch.ones(seqs, S * K, device=probs.device))
    f = picks * (E / (K * S))                                         # exact: whole counts
    return cfg.router_aux_weight * (f * probs.view(seqs, S, E).mean(dim=1)).sum(dim=1).mean()


def _experts(xt: torch.Tensor, gate: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
             wo: torch.Tensor, order: torch.Tensor, ends: torch.Tensor, row: torch.Tensor):
    """The dropless layer's experts and combine: the pairs' rows gathered in
    sorted order, the SwiGLU's three products grouped by expert, each token's
    K rows (``row`` (T, K), pair (t, k)'s sorted row) weighted by their gates
    and summed in order of k in f32. Returns (y (T, M) f32, and what the
    backward keeps: the sorted rows, h, g, the products' output)."""
    K = row.shape[1]
    with span("moe.experts"):
        rows = xt[order // K]                                         # (T·K, M) sorted
        h = torch._grouped_mm(rows, wi, offs=ends)
        g = torch._grouped_mm(rows, wg, offs=ends)
        out = torch._grouped_mm(h * F.silu(g), wo, offs=ends)         # (T·K, M)
    with span("moe.combine"):
        y = out[row[:, 0]].float() * gate[:, :1]
        for k in range(1, K):
            y = y + out[row[:, k]].float() * gate[:, k:k + 1]
    return y, rows, h, g, out


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-2, -1)


class _DroplessExperts(torch.autograd.Function):
    """``_experts`` with a backward of its own, in gathers and grouped
    products only (no atomics: the same bits every run). For dy (T, M):

    - each gate's gradient is the dot product of dy[t] with its pair's row;
    - each pair's row gradient dy[t]·gate[t, k], gathered into sorted order;
    - the products' gradients grouped by expert as the forward's are: the
      input gradients against each expert's weights transposed, the weight
      gradients rowsᵀ·d(out) over each expert's rows (``_grouped_mm``'s
      grouping over the contracted dimension);
    - each token's input gradient the sum of its K rows' in order of k, in
      f32, rounded once to the input's dtype."""

    @staticmethod
    def forward(ctx, xt, gate, wi, wg, wo, order, ends, row):
        y, rows, h, g, out = _experts(xt, gate, wi, wg, wo, order, ends, row)
        ctx.save_for_backward(gate, wi, wg, wo, order, ends, row, rows, h, g, out)
        return y

    @staticmethod
    def backward(ctx, dy):
        gate, wi, wg, wo, order, ends, row, rows, h, g, out = ctx.saved_tensors
        T, K = row.shape
        with span("moe.backward"):
            dy = dy.float()
            dgate = (out[row].float() * dy[:, None, :]).sum(-1)           # (T, K)
            dout = (dy[:, None, :] * gate[:, :, None]).reshape(T * K, -1)[order].to(out.dtype)
            a = h * F.silu(g)
            da = torch._grouped_mm(dout, _t(wo), offs=ends).float()       # (T·K, F)
            dwo = torch._grouped_mm(a.t(), dout, offs=ends)               # (E, F, M)
            gf, sg = g.float(), torch.sigmoid(g.float())
            dh = (da * gf * sg).to(h.dtype)                               # silu(g) = g·σ(g)
            dg = (da * h.float() * sg * (1 + gf * (1 - sg))).to(g.dtype)
            dwi = torch._grouped_mm(rows.t(), dh, offs=ends)              # (E, M, F)
            dwg = torch._grouped_mm(rows.t(), dg, offs=ends)
            drows = (torch._grouped_mm(dh, _t(wi), offs=ends).float()
                     + torch._grouped_mm(dg, _t(wg), offs=ends).float())  # (T·K, M)
            picked = drows[row]                                           # (T, K, M)
            dx = picked[:, 0]
            for k in range(1, K):
                dx = dx + picked[:, k]
        return (dx.to(rows.dtype), dgate, dwi, dwg, dwo, None, None, None)


def _dropless(xt: torch.Tensor, p: MoE, cfg: ModelConfig, seqs: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (token, expert) pair of ``xt`` (T, M) through its expert: the
    pairs stably sorted by expert, each expert's rows ending at ``ends[e]``
    (counted on the device), the SwiGLU's three products grouped over those
    rows, and each token's K rows weighted by their gates and summed in order
    of k in f32 (``_experts``; through ``_DroplessExperts`` where a gradient is
    wanted). Returns (y (T, M) f32, aux)."""
    if is_dtensor(xt):
        raise NotImplementedError("the dropless dispatch runs on plain tensors, not on a mesh")
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    dev = xt.device
    with span("moe.route"):
        gate, expert_idx, counts, aux = _route(xt, p, cfg, seqs)
        flat_e = expert_idx.reshape(-1)
        order = torch.argsort(flat_e, stable=True)                    # pairs by expert
        ends = torch.searchsorted(flat_e[order], torch.arange(E, device=dev, dtype=flat_e.dtype),
                                  right=True, out_int32=True)         # (E,) row ends
        row = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=dev))
        row = row.view(T, K)                                          # pair (t, k)'s row
    args = (xt, gate, p.wi, p.wg, p.wo, order, ends, row)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args[:5]):
        y = _DroplessExperts.apply(*args)
    else:
        y = _experts(*args)[0]
    p.count(torch.cat([counts.long(), (T * K - ends[-1:]).long()]))   # rows past the last end
    return y, aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, M) → (out in x's dtype, aux loss f32 scalar). The dropless
    dispatch (``cfg.moe_dropless``) goes backward through a function of its
    own (``_DroplessExperts``); the capacity dispatch through ``_Dispatch``
    and ``_Combine`` and autograd's products."""
    if cfg.moe_shard_map:
        out = _moe_shard_map(p, x, cfg)
        if out is not None:
            return out
    B, S, M = x.shape
    xt = reshape_replicated(x, B * S, M)     # a step on a mesh: every token on every device
    y, aux = (_dropless(xt, p, cfg, B) if cfg.moe_dropless
              else _dispatch_core(xt, p, cfg, 0, cfg.num_experts, p.wi, p.wg, p.wo, B))
    if cfg.num_shared_experts:
        y = y + swiglu(xt, p.shared_wi, p.shared_wg, p.shared_wo).float()
    return reshape_replicated(y, B, S, M).to(x.dtype), aux


def _moe_shard_map(p: MoE, x: torch.Tensor, cfg: ModelConfig
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Shard-local dispatch on the mesh of ``x`` (a DTensor): the reference's
    ``_moe_shard_map`` (module docstring). ``None`` where the reference's
    returns it: ``x`` on no mesh, a mesh with no "model" axis, or neither
    layout dividing (EP: E by the model axis, the rules putting "experts" on
    it; else TP: ``moe_d_ff`` by it).

    Each device takes its rows of the batch over the batch axes that divide
    it, the router whole, its expert (EP) or ``moe_ff`` (TP) shards and its
    ``ffn`` shard of the shared experts, and returns its partial output,
    summed over "model" by one all-reduce (``settle``). aux is averaged over
    the batch axes: each device's aux over the batch and model shards, summed
    (the model shards hold the same aux, so the router's gradient takes it
    once)."""
    if not is_dtensor(x):
        return None
    mesh = x.device_mesh
    sizes = mesh_shape(mesh)
    if "model" not in sizes:
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = sizes["model"]
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes and x.shape[0] % sizes[a] == 0)
    ep = (dict(cfg.sharding_overrides).get("experts", "model") == "model"
          and cfg.num_experts % m == 0)
    if not ep and cfg.moe_d_ff % m:
        return None

    def pl(batch, model) -> tuple:
        """Placements: ``batch`` on the batch axes, ``model`` on "model"."""
        return tuple(batch if n in batch_axes else model if n == "model" else Replicate()
                     for n in mesh.mesh_dim_names)

    R, P = Replicate(), Partial()
    win, wout = (Shard(0), Shard(0)) if ep else (Shard(2), Shard(1))
    args = [x, p.router, p.wi, p.wg, p.wo]
    pls = [pl(Shard(0), R), pl(R, R), pl(R, win), pl(R, win), pl(R, wout)]
    grads = [pl(Shard(0), P), pl(P, P), pl(P, win), pl(P, win), pl(P, wout)]
    if cfg.num_shared_experts:
        args += [p.shared_wi, p.shared_wg, p.shared_wo]
        pls += [pl(R, Shard(1)), pl(R, Shard(1)), pl(R, Shard(0))]
        grads += [pl(P, Shard(1)), pl(P, Shard(1)), pl(P, Shard(0))]
    shards = m * math.prod(sizes[a] for a in batch_axes)

    # this device's shards; each gradient comes back in its grads placements
    x_l, router, wi, wg, wo, *shared = (a.redistribute(mesh, q).to_local(grad_placements=g)
                                        for a, q, g in zip(args, pls, grads))
    Bl, S, M = x_l.shape
    xt = x_l.reshape(Bl * S, M)
    E_loc = wi.shape[0]
    offset = mesh.get_local_rank("model") * E_loc if ep else 0
    y, aux = _dispatch_core(xt, SimpleNamespace(router=router), cfg, offset, E_loc,
                            wi, wg, wo, Bl)
    if shared:
        y = y + swiglu(xt, *shared).float()
    y = DTensor.from_local(y.reshape(Bl, S, M), mesh, pl(Shard(0), P), run_check=False)
    aux = DTensor.from_local(aux / shards, mesh, pl(P, P), run_check=False)
    return settle(y).to(x.dtype), settle(aux)
