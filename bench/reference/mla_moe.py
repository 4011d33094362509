"""Plain reference of a DeepSeek-V2 decoder as the configurations in this
folder describe it: Multi-head Latent Attention on every layer (no query
compression, a low-rank latent of ``kv_lora_rank`` for keys and values, a
decoupled rope key shared by the heads, YaRN's rope and score scale), a
dense SwiGLU on the first ``first_dense_layers`` layers and a
mixture-of-experts on the rest (a softmax router, the top ``top_k`` experts
of ``num_experts`` with their gates as the router gives them or
renormalised, no capacity: every token reaches every expert it picks, plus
the shared experts as one SwiGLU), RMSNorm, an untied output head.

It is written from those equations in plain PyTorch, in float32 with TF32
off, and imports nothing of the program under test. Attention is computed
un-absorbed, as the model is defined: each head's keys and values are the
latent times its up-projections (k_nope = c·W_kb, v = c·W_vb), and the
scores of the whole causal sequence are taken at once (no cache). The
mixture-of-experts loops over the experts, each on the tokens routed to it.
Weights come from ``bench.lib.weights`` through a ``get(group) -> {leaf:
tensor}`` callable, one layer group at a time, so 15.7 B parameters check
in a few GB.

``quant="fp8"`` is the control: every product with a weight (the router's
too) has its operands rounded to float8 e4m3, one scale a tensor, the
precision below the configurations' bfloat16. Nothing else changes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], str, float]      # (name, shape, init, scale)
Getter = Callable[[str], Dict[str, torch.Tensor]]

FP8_MAX = 448.0          # largest finite float8 e4m3 value


def padded_vocab(m: dict) -> int:
    """Rows of the embedding table: the vocabulary padded to a multiple of 128."""
    return -(-m["vocab_size"] // 128) * 128


def is_moe_layer(m: dict, layer: int) -> bool:
    return layer >= m.get("first_dense_layers", 0)


def groups(m: dict) -> List[Tuple[str, List[Leaf]]]:
    """Every weight, in drawing order, grouped as it is drawn: the embedding,
    one group a block, then the head. ``init`` is "normal" (N(0, 1) times
    ``scale``), "ones" or "zeros". Each matrix is drawn at N(0, 1/fan_in): the
    experts' stacked (E, M, F) and (E, F, M) leaves at 1/M and 1/F, the
    router (kept in float32 by the program, filled from this draw) at 1/M.
    Leaf names are the program's parameter names under the group's prefix."""
    if m.get("attention") != "mla" or not m.get("num_experts"):
        raise NotImplementedError(f"{m['name']}: this reference covers MLA with a "
                                  "mixture of experts only")
    if m.get("tie_embeddings"):
        raise NotImplementedError(f"{m['name']}: a tied head")
    M, V, H = m["d_model"], padded_vocab(m), m["num_heads"]
    R, dr, dn, dv = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    E, Fe = m["num_experts"], m["moe_d_ff"]

    def mat(name, *shape, fan_in=None):
        return (name, shape, "normal", (shape[0] if fan_in is None else fan_in) ** -0.5)

    mla: List[Leaf] = [
        ("norm_mixer", (M,), "ones", 1.0), ("norm_ffn", (M,), "ones", 1.0),
        mat("mla.wq", M, H * (dn + dr)), mat("mla.wkv_a", M, R + dr),
        ("mla.kv_norm", (R,), "ones", 1.0), mat("mla.wk_b", R, H * dn),
        mat("mla.wv_b", R, H * dv), mat("mla.wo", H * dv, M)]
    dense = [mat("mlp.wi", M, m["d_ff"]), mat("mlp.wg", M, m["d_ff"]),
             mat("mlp.wo", m["d_ff"], M)]
    moe = [mat("moe.router", M, E), mat("moe.wi", E, M, Fe, fan_in=M),
           mat("moe.wg", E, M, Fe, fan_in=M), mat("moe.wo", E, Fe, M, fan_in=Fe)]
    if m.get("num_shared_experts"):
        Fs = m["num_shared_experts"] * Fe
        moe += [mat("moe.shared_wi", M, Fs), mat("moe.shared_wg", M, Fs),
                mat("moe.shared_wo", Fs, M)]
    out = [("embed", [mat("embed", V, M, fan_in=1)])]
    out += [(f"blocks.{layer}", mla + (moe if is_moe_layer(m, layer) else dense))
            for layer in range(m["num_layers"])]
    return out + [("head", [("final_norm", (M,), "ones", 1.0), mat("unembed", M, V)])]


def full_name(group: str, leaf: str) -> str:
    """The parameter's name in the program: "blocks.3.mla.wq", "embed"."""
    return leaf if group in ("embed", "head") else f"{group}.{leaf}"


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the layers, float32
# ---------------------------------------------------------------------------

def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor, back in f32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        a, w = fp8(a), fp8(w)
    elif quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return a @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_bounds(m: dict, dim: int) -> Tuple[int, int]:
    """(low, high): YaRN's ramp runs between the rope pairs that turn
    ``yarn_beta_fast`` and ``yarn_beta_slow`` times over the original context,
    pair(n) = dim·ln(orig / (2πn)) / (2 ln θ)."""
    theta, orig = m.get("rope_theta", 10_000.0), m["yarn_original_max_pos"]

    def pair(n: float) -> float:
        return dim * math.log(orig / (2 * math.pi * n)) / (2 * math.log(theta))
    return (max(math.floor(pair(m["yarn_beta_fast"])), 0),
            min(math.ceil(pair(m["yarn_beta_slow"])), dim - 1))


def rope_table(m: dict, dim: int, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (S, dim/2), of positions 0..S−1. Frequencies
    θ^(−2i/dim); with YaRN (``yarn_factor``) f_i = θ^(−2i/dim)/factor·r_i +
    θ^(−2i/dim)·(1 − r_i), r_i the ramp clamp((i − low)/(high − low), 0, 1),
    and cos, sin times mscale(factor, mscale)/mscale(factor, mscale_all_dim)."""
    theta = m.get("rope_theta", 10_000.0)
    i = torch.arange(dim // 2, dtype=torch.float64, device=device)
    base = theta ** (-2 * i / dim)
    scale = 1.0
    factor = m.get("yarn_factor", 0.0)
    if factor:
        low, high = yarn_bounds(m, dim)
        r = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
        base = base / factor * r + base * (1 - r)
        scale = (yarn_mscale(factor, m.get("yarn_mscale", 1.0))
                 / yarn_mscale(factor, m.get("yarn_mscale_all_dim", 0.0)))
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * base[None, :]
    return (ang.cos() * scale).float(), (ang.sin() * scale).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, ..., D): rotate its two halves by each position's angles
    (split-half pairs, i with i + D/2)."""
    while cos.ndim < x.ndim - 1:
        cos, sin = cos[:, None], sin[:, None]
    D = x.shape[-1]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def score_scale(m: dict) -> float:
    """(qk_nope + qk_rope)^-0.5, times mscale(factor, mscale_all_dim)² with YaRN."""
    s = (m["qk_nope_dim"] + m["qk_rope_dim"]) ** -0.5
    if m.get("yarn_factor") and m.get("yarn_mscale_all_dim"):
        s *= yarn_mscale(m["yarn_factor"], m["yarn_mscale_all_dim"]) ** 2
    return s


def mla(p: dict, h: torch.Tensor, m: dict, quant: Optional[str],
        q_rows: int = 1024) -> torch.Tensor:
    """Causal MLA over h (B, S, M): q = h·W_q split into (nope, rope) parts;
    the latent c = RMSNorm((h·W_kv_a)[:R]) and the rope key from the rest;
    per head k = [c·W_kb, k_rope], v = c·W_vb; softmax over j ≤ i in f32."""
    B, S, _ = h.shape
    H, R = m["num_heads"], m["kv_lora_rank"]
    dr, dn, dv = m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    cos, sin = rope_table(m, dr, S, h.device)
    q = mm(h, p["mla.wq"], quant).view(B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], rope(q[..., dn:], cos, sin)
    kv = mm(h, p["mla.wkv_a"], quant)
    c = rms_norm(kv[..., :R], p["mla.kv_norm"], m.get("norm_eps", 1e-5))
    k_pe = rope(kv[..., R:], cos, sin)                              # (B, S, dr)
    k_nope = mm(c, p["mla.wk_b"], quant).view(B, S, H, dn).transpose(1, 2)   # (B, H, S, dn)
    v = mm(c, p["mla.wv_b"], quant).view(B, S, H, dv).transpose(1, 2)
    pos = torch.arange(S, device=h.device)
    scale = score_scale(m)
    outs = []
    for r0 in range(0, S, q_rows):                                  # query rows in blocks
        qn = q_nope[:, r0:r0 + q_rows].transpose(1, 2)               # (B, H, r, dn)
        qp = q_pe[:, r0:r0 + q_rows].transpose(1, 2)                 # (B, H, r, dr)
        s = (qn @ k_nope.transpose(-1, -2)
             + qp @ k_pe[:, None].transpose(-1, -2)) * scale         # (B, H, r, S)
        ok = pos[None, :] <= pos[r0:r0 + q_rows, None]
        s = s.masked_fill(~ok, float("-inf"))
        outs.append((torch.softmax(s, dim=-1) @ v).transpose(1, 2))  # (B, r, H, dv)
    out = torch.cat(outs, dim=1).reshape(B, S, H * dv)
    return mm(out, p["mla.wo"], quant)


def swiglu(x, wi, wg, wo, quant):
    return mm(mm(x, wi, quant) * F.silu(mm(x, wg, quant)), wo, quant)


def moe(p: dict, f: torch.Tensor, m: dict, quant: Optional[str]) -> torch.Tensor:
    """f (N, M): softmax router, the top_k experts a token and their gates
    (renormalised to sum to 1 only with ``norm_topk_prob``), every token
    through every expert it picked (a loop over the experts), the gated
    outputs summed, plus the shared experts."""
    E, K = m["num_experts"], m["top_k"]
    probs = torch.softmax(mm(f, p["moe.router"], quant), dim=-1)     # (N, E)
    gate, idx = torch.topk(probs, K, dim=-1)
    if m.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(f)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            out = swiglu(f[tok], p["moe.wi"][e], p["moe.wg"][e], p["moe.wo"][e], quant)
            y.index_add_(0, tok, out * gate[tok, slot][:, None])
    if m.get("num_shared_experts"):
        y = y + swiglu(f, p["moe.shared_wi"], p["moe.shared_wg"], p["moe.shared_wo"], quant)
    return y


def block(p: dict, x: torch.Tensor, m: dict, layer: int,
          quant: Optional[str] = None) -> torch.Tensor:
    """x + MLA(norm(x)), then + FFN(norm(·)): a dense SwiGLU on the first
    ``first_dense_layers`` layers, the mixture of experts after."""
    eps = m.get("norm_eps", 1e-5)
    x = x + mla(p, rms_norm(x, p["norm_mixer"], eps), m, quant)
    f = rms_norm(x, p["norm_ffn"], eps)
    if not is_moe_layer(m, layer):
        return x + swiglu(f, p["mlp.wi"], p["mlp.wg"], p["mlp.wo"], quant)
    B, S, M = f.shape
    return x + moe(p, f.reshape(B * S, M), m, quant).view(B, S, M)


def head(p: dict, x: torch.Tensor, m: dict, quant: Optional[str] = None) -> torch.Tensor:
    """Logits over the real vocabulary (the padded columns are never scored)."""
    x = rms_norm(x, p["final_norm"], m.get("norm_eps", 1e-5))
    return mm(x, p["unembed"][:, : m["vocab_size"]], quant)


# ---------------------------------------------------------------------------
# serving: logits at chosen positions, one layer group at a time
# ---------------------------------------------------------------------------

@torch.no_grad()
def logits_at(get: Getter, m: dict, tokens: torch.Tensor, rows: List[List[int]],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each sequence b of ``tokens`` (B, S), the logits (len(rows[b]), vocab)
    at positions ``rows[b]``. Sequences shorter than S are padded at the end,
    which no earlier position sees; a padded token's routing changes no other
    token's experts (there is no capacity)."""
    with exact_f32():
        x = F.embedding(tokens, get("embed")["embed"]).float()
        for layer in range(m["num_layers"]):
            p = {k: t.float() for k, t in get(f"blocks.{layer}").items()}
            x = block(p, x, m, layer, quant)
            del p
        p = {k: t.float() for k, t in get("head").items()}
        return [head(p, x[b, r], m, quant) for b, r in enumerate(rows)]


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best: (n,), ≥ 0."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[:, None])[:, 0]
