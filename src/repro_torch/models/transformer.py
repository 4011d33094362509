"""Decoder stack: forward, training forward and loss, prefill into the
decode cache, decode.

Twin of ``repro/models/transformer.py`` for every arch of the registry. A
block is a pre-norm mixer plus a pre-norm FFN, as the reference's
``block_forward`` and ``block_decode``:

- mixer: GQA attention, MLA, the Mamba-2 SSM, or (``mixer = "hybrid"``)
  attention and the SSM in parallel, mixed ``0.5 · (attn + ssm)``;
- FFN: the MoE when ``num_experts`` is set, else a SwiGLU MLP when ``d_ff``
  is set, else nothing (the reference adds zero). With the port's own
  ``first_dense_layers`` (a published DeepSeek-V2), those leading layers
  take a SwiGLU MLP of ``d_ff`` and the rest the MoE.

The layer ``scan`` becomes a Python loop over an ``nn.ModuleList``. The
reference's prompt-length cache plus splice becomes a prefill that writes
each layer's state straight into the decode cache (``init_cache``): K and V
into the paged pool, the last ``window`` tokens' K/V into a ring, MLA's
latent into its cache, the (conv, h) state into an ``SSMCache``. Inputs are
token ids, or precomputed embeddings for the archs with a stubbed modality
frontend (the reference's ``tokens_or_embeds``).

Training (``forward_train``, ``loss_fn``) runs the same trunk with autograd
on and keeps the MoE's aux loss, summed over layers as the reference's
``forward`` does; ``remat="full"`` recomputes each block in the backward
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint`` of its
scan body.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..distributed.sharding import Shards, is_dtensor, on_local_shards, settle
from ..spans import span
from .attention import (Attention, PagedKVPool, RingKVCache, attention_decode,
                        attention_train)
from .decode_graph import DecodeGraphs, eager_reason
from .layers import MLP, init_weights, rms_norm, weight
from .mla import MLA, LatentCache, mla_decode, mla_train
from .moe import MoE, moe_apply
from .ssm import SSM, SSMCache, ssm_decode, ssm_train

KVCache = Union[PagedKVPool, RingKVCache, LatentCache]


@dataclass(eq=False)           # hashed by identity: a key of the model's decode graphs
class HybridCache:
    """A hybrid arch's decode cache: its attention half's ring of the last
    ``window`` tokens' K/V and its SSM half's state."""

    kv: RingKVCache
    ssm: SSMCache


Cache = Union[PagedKVPool, RingKVCache, LatentCache, SSMCache, HybridCache]


def _parts(cache: Optional[Cache]) -> Tuple[Optional[KVCache], Optional[SSMCache]]:
    """(attention cache, SSM cache) of any decode cache; None where absent."""
    if isinstance(cache, HybridCache):
        return cache.kv, cache.ssm
    if isinstance(cache, SSMCache):
        return None, cache
    return cache, None


class Block(nn.Module):
    """Pre-norm mixer + pre-norm FFN, with the reference's leaf names.

    On a mesh the residual stream stays whole over "model": the partial sums
    of the mixer's and the FFN's output products (their inputs sharded on
    the contracted dim) are reduced where they join it (``settle``), or the
    next column-sharded product would gather its weight instead."""

    AXES = {"norm_mixer": ("embed",), "norm_ffn": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device: torch.device, layer: int) -> None:
        super().__init__()
        self.cfg = cfg
        self.norm_mixer = weight(cfg.d_model, device=device)
        self.norm_ffn = weight(cfg.d_model, device=device)
        mla = cfg.uses_attention and cfg.attention == "mla"
        self.attn = Attention(cfg, device=device) if cfg.uses_attention and not mla else None
        self.mla = MLA(cfg, device=device) if mla else None
        self.ssm = SSM(cfg, device=device) if cfg.uses_ssm else None
        moe = cfg.is_moe_layer(layer)
        self.moe = MoE(cfg, device=device) if moe else None
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device) if cfg.d_ff and not moe else None

    def _mix(self, attn: Optional[torch.Tensor], ssm: Optional[torch.Tensor]
             ) -> torch.Tensor:
        if ssm is None:
            return attn
        return ssm if attn is None else 0.5 * (attn + ssm)

    def mix_prompt(self, h: torch.Tensor, positions: torch.Tensor, layer: int,
                   kv: Optional[KVCache], kv_plan, ssm: Optional[SSMCache]
                   ) -> torch.Tensor:
        """The mixer over a whole sequence; stores its decode state in the caches given."""
        cfg = self.cfg
        a = s = None
        B = h.shape[0]
        if self.attn is not None:
            with span("layer.attn"):
                a, k, v = attention_train(self.attn, h, cfg, positions)
                if kv is not None:
                    on_local_shards(lambda k, v: kv.write_prompt(layer, kv_plan, k, v),
                                    (k, v), ((0, 2), (0, 2)), (), batch=B,
                                    heads=(cfg.num_heads, cfg.num_kv_heads))
        elif self.mla is not None:
            with span("layer.attn"):
                a, c_kv, k_pe = mla_train(self.mla, h, cfg, positions)
                if kv is not None:
                    on_local_shards(lambda c, k: kv.write_prompt(layer, kv_plan, c, k),
                                    (c_kv, k_pe), ((0, 2), (0, None)), (), batch=B,
                                    heads=(cfg.kv_lora_rank,))
        if self.ssm is not None:
            with span("layer.ssm"):
                s = ssm_train(self.ssm, h, cfg, return_state=ssm is not None)
                if ssm is not None:
                    s, state = s
                    ssm.write(layer, state)
        return settle(self._mix(a, s))

    def mix_step(self, h: torch.Tensor, layer: int, kv: Optional[KVCache], plan,
                 ssm: Optional[SSMCache]) -> torch.Tensor:
        """The mixer for one token a sequence, updating the caches in place."""
        cfg = self.cfg
        a = s = None
        if self.attn is not None:
            with span("layer.attn"):
                a = attention_decode(self.attn, h, cfg, kv, layer, plan)
        elif self.mla is not None:
            with span("layer.attn"):
                a = mla_decode(self.mla, h, cfg, kv, layer, plan)
        if self.ssm is not None:
            with span("layer.ssm"):
                s = ssm_decode(self.ssm, h, ssm, layer, cfg)
        return settle(self._mix(a, s))

    def ffn(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x + FFN(norm(x)), the MoE's aux loss or None). Prefill and decode
        drop the aux loss, as the reference's do; training adds it."""
        if self.mlp is None and self.moe is None:    # d_ff = 0: the FFN half adds zero
            return x, None
        with span("layer.ffn"):
            if self.moe is not None:
                y, aux = moe_apply(self.moe, rms_norm(x, self.norm_ffn, self.cfg.norm_eps),
                                   self.cfg)
                return x + y, aux
            return x + settle(self.mlp(rms_norm(x, self.norm_ffn, self.cfg.norm_eps))), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer: int,
                kv: Optional[KVCache], kv_plan, ssm: Optional[SSMCache]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block over a whole sequence (the reference's ``block_forward``):
        (x out, aux loss or None); decode state goes into the caches given."""
        with span("layer"):
            h = rms_norm(x, self.norm_mixer, self.cfg.norm_eps)
            return self.ffn(x + self.mix_prompt(h, positions, layer, kv, kv_plan, ssm))


class Transformer(nn.Module):
    AXES = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            "unembed": ("embed", "vocab")}

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"
                 ) -> None:
        super().__init__()
        if cfg.mixer not in ("attn", "ssm", "hybrid") or cfg.attention not in (
                "gqa", "mla", "none"):
            raise ValueError(f"{cfg.name}: no block for mixer {cfg.mixer!r} with "
                             f"attention {cfg.attention!r}")
        device = resolve_device(device, allow_meta=True)
        self.cfg = cfg
        self.embed = weight(cfg.padded_vocab, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device, layer=layer)
                                    for layer in range(cfg.num_layers))
        self.final_norm = weight(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = weight(cfg.d_model, cfg.padded_vocab, device=device)
        self._decode_graphs: "weakref.WeakKeyDictionary[Cache, DecodeGraphs]" = (
            weakref.WeakKeyDictionary())

    def _apply(self, fn, recurse=True):
        """A move or cast gives the parameters new storage, which graphs
        captured before it do not read: they are dropped."""
        self._decode_graphs = weakref.WeakKeyDictionary()
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens_or_embeds: torch.Tensor, token_ndim: int) -> torch.Tensor:
        """Token ids (``token_ndim`` dims) through the table, or precomputed
        embeddings (one dim more) cast to the table's dtype. The lookup is
        ``F.embedding``, whose gradient on the card sums each row's tokens in
        a fixed order (no atomics), so training is reproducible."""
        if tokens_or_embeds.ndim == token_ndim:
            return settle(F.embedding(tokens_or_embeds, self.embed))
        return tokens_or_embeds.to(self.embed.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        unembed = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return x @ unembed

    def _trunk(self, tokens_or_embeds: torch.Tensor, cache: Optional[Cache],
               remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
        """(hidden states, aux loss summed over layers, f32 scalar)."""
        x = self._embed(tokens_or_embeds, 2)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        kv, ssm = _parts(cache)
        kv_plan = kv.prompt_plan(B, S) if kv is not None else None
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer, blk in enumerate(self.blocks):
            if remat == "full":
                x, a = checkpoint(blk, x, positions, layer, kv, kv_plan, ssm,
                                  use_reentrant=False)
            else:
                x, a = blk(x, positions, layer, kv, kv_plan, ssm)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward(self, tokens_or_embeds: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) or embeddings (B, S, M) → logits (B, S, padded_vocab)."""
        return self._logits(self._trunk(tokens_or_embeds, None)[0])

    def forward_train(self, tokens_or_embeds: torch.Tensor, *, remat: str = "none"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's training ``forward``: (logits, aux loss). ``remat``
        "full" recomputes each block's activations in the backward; any other
        value ("none", "dots") keeps them, as the reference does."""
        x, aux = self._trunk(tokens_or_embeds, None, remat)
        return self._logits(x), aux

    def init_cache(self, batch: int, max_len: int, *, page_tokens: int = 16,
                   pages_per_block: int = 4) -> Cache:
        """The decode cache of this arch's family:

        - dense, MoE and frontend GQA archs: a ``PagedKVPool``;
        - GQA with a sliding window: a ``RingKVCache`` of ``min(max_len, window)``
          slots a sequence (the page shape does not apply);
        - MLA: a ``LatentCache``;
        - SSM: an ``SSMCache`` (fixed size: ``max_len`` does not apply);
        - hybrid: a ``HybridCache`` of the ring and the SSM state.

        K/V and latent entries are kept in the weights' dtype (bf16, the
        reference's cache dtype, unless the model was cast); the SSM state in f32.

        When the parameters are DTensors (a step on a mesh, ``launch.steps``),
        the cache holds only this device's shards as plain tensors
        (``Shards``): this rank's sequences of ``batch`` and the head axes split
        over "model" as the attention splits them.
        """
        cfg, dev, dtype = self.cfg, self.device, self.embed.dtype
        shards = (Shards(self.embed.device_mesh, batch) if is_dtensor(self.embed)
                  else None)
        kw = dict(device=dev, dtype=dtype, shards=shards)
        kv = None
        if cfg.uses_attention and cfg.attention == "mla":
            kv = LatentCache(cfg, batch, max_len, **kw)
        elif cfg.uses_attention and cfg.window is not None:
            kv = RingKVCache(cfg, batch, max_len, **kw)
        elif cfg.uses_attention:
            kv = PagedKVPool(cfg, batch, max_len, page_tokens=page_tokens,
                             pages_per_block=pages_per_block, **kw)
        if not cfg.uses_ssm:
            return kv
        ssm = SSMCache(cfg, batch, device=dev, shards=shards)
        return ssm if kv is None else HybridCache(kv, ssm)

    def prefill(self, tokens_or_embeds: torch.Tensor, cache: Cache) -> torch.Tensor:
        """Runs the prompt, writes its decode state into ``cache``;
        last-position logits."""
        with span("prefill.step"):
            return self._logits(self._trunk(tokens_or_embeds, cache)[0][:, -1])

    def routing_snapshot(self) -> Dict[int, Dict[str, float]]:
        """Each MoE layer's ``MoE.snapshot()`` by layer index: pairs routed
        over every call so far, the most and mean an expert took, pairs dropped."""
        return {layer: blk.moe.snapshot() for layer, blk in enumerate(self.blocks)
                if blk.moe is not None}

    def decode_graphs(self, cache: Cache) -> DecodeGraphs:
        """This model's decode graphs on ``cache`` and its steps' counts
        (``models/decode_graph.py``), held as long as the cache lives."""
        graphs = self._decode_graphs.get(cache)
        if graphs is None:
            graphs = self._decode_graphs[cache] = DecodeGraphs(self.device)
        return graphs

    def decode_step(self, cache: Cache, token_or_embed: torch.Tensor,
                    cur_index: np.ndarray) -> torch.Tensor:
        """One token per sequence: ids (B,) or embeddings (B, M) at host
        positions ``cur_index`` (B,). Returns logits (B, padded_vocab), which
        no later step overwrites. On the card the step replays a CUDA graph
        of ``_decode_body`` where ``eager_reason`` finds nothing against it."""
        with span("decode.step"):
            kv, ssm = _parts(cache)
            plan = None
            if kv is not None:
                with span("kv.plan"):
                    plan = kv.plan_step(cur_index)
            return self.decode_graphs(cache).run(
                lambda inp, key: self._decode_body(
                    kv, ssm, None if plan is None else plan.for_key(key), inp),
                token_or_embed, eager_reason(self, (kv, ssm)),
                (None,) if plan is None else plan.launch_keys)

    def _decode_body(self, kv: Optional[KVCache], ssm: Optional[SSMCache], plan,
                     token_or_embed: torch.Tensor) -> torch.Tensor:
        """The step on the device, from the input and the planned buffers."""
        x = self._embed(token_or_embed, 1)[:, None, :]              # (B, 1, M)
        for layer, blk in enumerate(self.blocks):
            with span("layer"):
                h = rms_norm(x, blk.norm_mixer, self.cfg.norm_eps)
                x = blk.ffn(x + blk.mix_step(h, layer, kv, plan, ssm))[0]
        with span("decode.logits"):
            return self._logits(x)[:, 0]


def logical_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: its logical axis names}, from the ``AXES`` table of
    the module that owns it: the reference's spec tree (``SpecTree``), where
    a block's leaf ``blocks.{l}.<path>`` drops the reference's leading
    "layers" axis (its leaves are stacked over layers, the port's are not)."""
    out = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        axes = type(model.get_submodule(owner)).AXES[leaf]
        if len(axes) != p.ndim:
            raise AssertionError(f"{name}: axes {axes} vs shape {tuple(p.shape)}")
        out[name] = axes
    return out


def cache_specs(cfg: ModelConfig) -> Dict:
    """The reference's logical-axis tree of its decode cache (``init_cache``'s
    structure; its ``cache_specs``). The port's caches name their own tensors'
    axes after these (``cache_axes``)."""
    specs: Dict = {}
    if cfg.uses_attention:
        if cfg.attention == "mla":
            specs["mla"] = {"c_kv": ("layers", "batch", "kv_seq", "kv_lora"),
                            "k_pe": ("layers", "batch", "kv_seq", None)}
        else:
            specs["attn"] = {"k": ("layers", "batch", "kv_seq", "kv_flat"),
                             "v": ("layers", "batch", "kv_seq", "kv_flat")}
    if cfg.uses_ssm:
        specs["ssm"] = {"conv": ("layers", "batch", None, "ssm_inner"),
                        "h": ("layers", "batch", "ssm_heads", None, None)}
    return specs


def cache_tensors(cache: Cache) -> Dict[str, torch.Tensor]:
    """Every tensor of a decode cache by name (``cache_specs``'s keys where
    the layout is the reference's: ``attn/k``, ``mla/c_kv``, ``ssm/h``; the
    paged pool is ``attn/pool``)."""
    kv, ssm = _parts(cache)
    out = {}
    if isinstance(kv, PagedKVPool):
        out["attn/pool"] = kv.pool
    elif isinstance(kv, LatentCache):
        out.update({"mla/c_kv": kv.c_kv, "mla/k_pe": kv.k_pe})
    elif kv is not None:
        out.update({"attn/k": kv.bufs[0], "attn/v": kv.bufs[1]})
    if ssm is not None:
        out.update({"ssm/conv": ssm.conv, "ssm/h": ssm.h})
    return out


def loss_fn(model: Transformer, tokens: torch.Tensor, targets: torch.Tensor, *,
            remat: str = "none") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn``: (nll + aux, {"nll", "aux"}).

    Logits in f32, the pad-vocab columns masked with −1e30, the negative
    log-likelihood of ``targets`` averaged over ``targets >= 0`` (the
    denominator at least 1).
    """
    cfg = model.cfg
    logits, aux = model.forward_train(tokens, remat=remat)
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:          # mask pad-vocab columns
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = settle(logits.gather(-1, targets.clamp(min=0)[..., None]))[..., 0]
    mask = (targets >= 0).float()
    nll = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    return nll + aux, {"nll": nll, "aux": aux}


def init_transformer(cfg: ModelConfig, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> Transformer:
    """A model with the reference's init rule, drawn from ``seed``."""
    model = Transformer(cfg, device=device)
    init_weights(model, seed=seed)
    return model
