"""Plain reference of a DeepSeek-V2 decoder's training step, as the
configurations in this folder describe it (``mla_moe.py``'s model: MLA on
every layer with YaRN, a dense SwiGLU on the first ``first_dense_layers``
layers, a mixture of experts after it with no capacity): the mean
next-token loss plus the routers' balance loss, and AdamW.

The balance loss is the release's ``MoEGate`` with ``seq_aux``: for each
sequence of S tokens and each expert i, f_i = E/(K·S) · (the sequence's
pairs sent to i) and P_i = the mean over its tokens of the router's
probability of i; aux = α · Σ_i f_i · P_i, averaged over the sequences and
summed over the MoE layers, α = ``router_aux_weight`` (0.001, the release's
``aux_loss_alpha``). A configuration without ``moe_seq_aux`` takes it over
the whole batch as one sequence of T tokens would not (Switch's form,
α · E · Σ_i mean_t(p_ti) · pairs_i/(T·K)).

It is written from those equations in plain PyTorch, in float32 with TF32
off, and imports nothing of the program under test; of ``mla_moe.py`` (the
serving reference, loaded from its file) it takes the weights' groups, the
norms and YaRN's rope, and computes its own layers, whose products take a
gradient. Memory: the parameters, their gradients and AdamW's two moments
in f32 are 16 bytes a parameter (45 GB for a five-layer stage of
DeepSeek-V2-Lite); each block is recomputed in the backward
(``torch.utils.checkpoint``), attention takes its queries in blocks of
``Q_ROWS`` (512) rows, each recomputed in the backward too, over the keys
up to the block's last query (so at most one (B, H, 512, ≤ S) score
tensor lives at a time: 268 MB at B 2, H 16, S 4096), and the head and its
loss take ``HEAD_ROWS`` (2048) token rows at a time, each recomputed (one
(2048, vocab) block of logits at a time: 839 MB at 102,400). AdamW scales
the gradients it is given in place (it clips them) rather than copy them.

``quant="fp8"`` is the control: every product with a weight (the router's
too) has its operands rounded to float8 e4m3, one scale a tensor, the
precision below the configurations' bfloat16; the gradient passes straight
through the rounding. Nothing else changes.
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _serving_reference():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mla_moe.py")
    spec = importlib.util.spec_from_file_location("bench_reference_mla_moe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_mla_moe = _serving_reference()
groups, full_name, exact_f32 = _mla_moe.groups, _mla_moe.full_name, _mla_moe.exact_f32
rms_norm, rope, rope_table = _mla_moe.rms_norm, _mla_moe.rope, _mla_moe.rope_table
score_scale, is_moe_layer = _mla_moe.score_scale, _mla_moe.is_moe_layer

FP8_MAX = 448.0          # largest finite float8 e4m3 value
Q_ROWS = 512             # attention's query rows a block
HEAD_ROWS = 2048         # the head's token rows a block
ROUTER = "moe.router"    # kept in float32 by the program, so not rounded by AdamW


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor, back in f32;
    its gradient passes straight through the rounding."""
    d = t.detach()
    scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (d / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - d)


def mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        a, w = fp8(a), fp8(w)
    elif quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return a @ w


def _attend(qn, qp, k_nope, k_pe, v, r0: int, scale: float) -> torch.Tensor:
    """Queries r0.. of one block, (B, H, r, ·), over the keys up to the block's
    last query: softmax over j ≤ i in f32, then times v. (B, r, H, dv)."""
    r = qn.shape[2]
    keys = r0 + r
    s = (qn @ k_nope[:, :, :keys].transpose(-1, -2)
         + qp @ k_pe[:, None, :keys].transpose(-1, -2)) * scale       # (B, H, r, keys)
    i = torch.arange(r0, keys, device=qn.device)[:, None]
    ok = torch.arange(keys, device=qn.device)[None, :] <= i
    s = s.masked_fill(~ok, float("-inf"))
    return (torch.softmax(s, dim=-1) @ v[:, :, :keys]).transpose(1, 2)


def mla(p: dict, h: torch.Tensor, m: dict, quant: Optional[str]) -> torch.Tensor:
    """Causal MLA over h (B, S, M), as ``mla_moe.mla`` defines it: q = h·W_q
    split into (nope, rope) parts; the latent c = RMSNorm((h·W_kv_a)[:R]) and
    the rope key from the rest; per head k = [c·W_kb, k_rope], v = c·W_vb;
    the queries in blocks of ``Q_ROWS``, each recomputed in the backward."""
    B, S, _ = h.shape
    H, R = m["num_heads"], m["kv_lora_rank"]
    dr, dn, dv = m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    cos, sin = rope_table(m, dr, S, h.device)
    q = mm(h, p["mla.wq"], quant).view(B, S, H, dn + dr)
    q_nope = q[..., :dn].transpose(1, 2)                               # (B, H, S, dn)
    q_pe = rope(q[..., dn:], cos, sin).transpose(1, 2)                 # (B, H, S, dr)
    kv = mm(h, p["mla.wkv_a"], quant)
    c = rms_norm(kv[..., :R], p["mla.kv_norm"], m.get("norm_eps", 1e-5))
    k_pe = rope(kv[..., R:], cos, sin)                                 # (B, S, dr)
    k_nope = mm(c, p["mla.wk_b"], quant).view(B, S, H, dn).transpose(1, 2)
    v = mm(c, p["mla.wv_b"], quant).view(B, S, H, dv).transpose(1, 2)
    scale = score_scale(m)
    outs = [checkpoint(_attend, q_nope[:, :, r0:r0 + Q_ROWS], q_pe[:, :, r0:r0 + Q_ROWS],
                       k_nope, k_pe, v, r0, scale, use_reentrant=False)
            for r0 in range(0, S, Q_ROWS)]
    out = torch.cat(outs, dim=1).reshape(B, S, H * dv)
    return mm(out, p["mla.wo"], quant)


def swiglu(x, wi, wg, wo, quant):
    return mm(mm(x, wi, quant) * F.silu(mm(x, wg, quant)), wo, quant)


def balance_loss(probs: torch.Tensor, idx: torch.Tensor, m: dict, seqs: int) -> torch.Tensor:
    """The routers' balance loss of one layer (module docstring): probs (T, E),
    the picks idx (T, K), the tokens in ``seqs`` sequences of T/seqs."""
    T, E = probs.shape
    K = idx.shape[1]
    alpha = m.get("router_aux_weight", 0.001)
    if not m.get("moe_seq_aux"):
        picks = torch.zeros(E, device=probs.device).index_add_(
            0, idx.reshape(-1), torch.ones(T * K, device=probs.device))
        return alpha * E * (probs.mean(0) * picks / (T * K)).sum()
    S = T // seqs
    picks = torch.zeros(seqs, E, device=probs.device).scatter_add_(
        1, idx.reshape(seqs, S * K), torch.ones(seqs, S * K, device=probs.device))
    f = picks * E / (K * S)
    return alpha * (f * probs.view(seqs, S, E).mean(1)).sum(1).mean()


def moe(p: dict, f: torch.Tensor, m: dict, quant: Optional[str], seqs: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f (T, M) → (y, aux): the softmax router, the top_k experts a token and
    their gates (renormalised only with ``norm_topk_prob``), every token
    through every expert it picked (a loop over the experts), the gated
    outputs summed, plus the shared experts; and the balance loss."""
    E, K = m["num_experts"], m["top_k"]
    probs = torch.softmax(mm(f, p["moe.router"], quant), dim=-1)       # (T, E)
    gate, idx = torch.topk(probs, K, dim=-1)
    if m.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(f)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            out = swiglu(f[tok], p["moe.wi"][e], p["moe.wg"][e], p["moe.wo"][e], quant)
            y = y.index_add(0, tok, out * gate[tok, slot][:, None])
    if m.get("num_shared_experts"):
        y = y + swiglu(f, p["moe.shared_wi"], p["moe.shared_wg"], p["moe.shared_wo"], quant)
    return y, balance_loss(probs, idx, m, seqs)


def block(p: dict, x: torch.Tensor, m: dict, layer: int, quant: Optional[str] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + MLA(norm(x)), then + FFN(norm(·)); the layer's balance loss, 0 for
    a dense layer)."""
    eps = m.get("norm_eps", 1e-5)
    x = x + mla(p, rms_norm(x, p["norm_mixer"], eps), m, quant)
    f = rms_norm(x, p["norm_ffn"], eps)
    if not is_moe_layer(m, layer):
        return (x + swiglu(f, p["mlp.wi"], p["mlp.wg"], p["mlp.wo"], quant),
                x.new_zeros(()))
    B, S, M = f.shape
    y, aux = moe(p, f.reshape(B * S, M), m, quant, B)
    return x + y.view(B, S, M), aux


def _nll(x: torch.Tensor, targets: torch.Tensor, norm_w, unembed, m: dict,
         quant: Optional[str]) -> torch.Tensor:
    """Summed negative log-likelihood of ``targets`` (n,) from hidden rows x (n, M)."""
    logits = mm(rms_norm(x, norm_w, m.get("norm_eps", 1e-5)), unembed[:, : m["vocab_size"]],
                quant)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, targets[:, None])[:, 0]).sum()


def loss(params: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
         targets: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood over every target (B, S), plus
    every MoE layer's balance loss."""
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"])
    aux = x.new_zeros(())
    for layer in range(m["num_layers"]):
        prefix = f"blocks.{layer}."
        p = {k[len(prefix):]: t for k, t in params.items() if k.startswith(prefix)}
        x, a = checkpoint(block, p, x, m, layer, quant, use_reentrant=False)
        aux = aux + a
    x, flat = x.reshape(B * S, -1), targets.reshape(-1)
    nll = sum(checkpoint(_nll, x[r0:r0 + HEAD_ROWS], flat[r0:r0 + HEAD_ROWS],
                         params["final_norm"], params["unembed"], m, quant, use_reentrant=False)
              for r0 in range(0, B * S, HEAD_ROWS))
    return nll / (B * S) + aux


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to a tenth
    of it at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict, opt: dict, step: int, store_dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """One AdamW step in f32: the gradients clipped in place to a global norm
    of ``grad_clip``, bias-corrected moments, decoupled weight decay on
    matrices, each parameter rounded to the dtype the program stores it in
    (``store_dtype``; the routers stay in float32). Returns the clipped
    gradients, as the optimizer used them (``grads``, scaled)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / norm.clamp(min=1e-12), max=1.0)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr = lr_at(step, opt)
    for n, p in params.items():
        g = grads[n].mul_(scale)
        m1 = state.setdefault("m", {}).get(n)
        v1 = state.setdefault("v", {}).get(n)
        m1 = (1 - b1) * g if m1 is None else m1.mul_(b1).add_(g, alpha=1 - b1)
        v1 = (1 - b2) * g.square() if v1 is None else v1.mul_(b2).addcmul_(g, g, value=1 - b2)
        state["m"][n], state["v"][n] = m1, v1
        upd = (m1 / (1 - b1 ** step)) / (torch.sqrt(v1 / (1 - b2 ** step)) + eps)
        if p.ndim >= 2:
            upd = upd + opt["weight_decay"] * p
        dtype = torch.float32 if n.endswith(ROUTER) else store_dtype
        p.copy_((p - lr * upd).to(dtype).float())
    return grads
