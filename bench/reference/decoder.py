"""Plain reference of the decoder stack the configurations in this folder
describe: dense GQA attention (full or sliding-window), the Mamba-2 (SSD)
mixer, and both in parallel (a hybrid), each block pre-norm with a SwiGLU
feed-forward, RMSNorm, split-half rotary embeddings, an output head of its
own or tied to the embedding (``tie_embeddings``).

It is written from those equations in plain PyTorch, in float32 with TF32
off, and imports nothing of the program under test. Weights come from
``bench.lib.weights`` (drawn from the seed, the same values the program is
given); the reference reads them one layer group at a time through a
``get(group) -> {leaf: tensor}`` callable, so a 35B model runs in a few GB.

``quant="fp8"`` is the control: every matrix product's operands rounded to
float8 e4m3 (one scale a tensor), the precision below the configurations'
bfloat16. Nothing else changes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], str, float]      # (name, shape, init, scale)
Getter = Callable[[str], Dict[str, torch.Tensor]]

CONV_W = 4               # the SSM's causal depthwise conv width
FP8_MAX = 448.0          # largest finite float8 e4m3 value


def padded_vocab(m: dict) -> int:
    """Rows of the embedding table: the vocabulary padded to a multiple of 128."""
    return -(-m["vocab_size"] // 128) * 128


def uses_attention(m: dict) -> bool:
    return m.get("mixer", "attn") in ("attn", "hybrid")


def uses_ssm(m: dict) -> bool:
    return m.get("mixer", "attn") in ("ssm", "hybrid")


def groups(m: dict) -> List[Tuple[str, List[Leaf]]]:
    """Every weight, in drawing order, grouped as it is drawn: the embedding,
    one group a block, then the head. ``init`` is "normal" (N(0, 1) times
    ``scale``), "ones" or "zeros". Leaf names are the program's parameter
    names under the group's prefix."""
    if m.get("attention", "gqa") != "gqa" or m.get("num_experts", 0):
        raise NotImplementedError(f"{m['name']}: this reference covers dense GQA, SSM "
                                  "and hybrid blocks only")
    M, V = m["d_model"], padded_vocab(m)

    def mat(name, *shape, scale=None):
        return (name, shape, "normal", shape[0] ** -0.5 if scale is None else scale)

    block: List[Leaf] = [("norm_mixer", (M,), "ones", 1.0), ("norm_ffn", (M,), "ones", 1.0)]
    if uses_attention(m):
        H, Kh, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        block += [mat("attn.wq", M, H * D), mat("attn.wk", M, Kh * D),
                  mat("attn.wv", M, Kh * D), mat("attn.wo", H * D, M)]
        if m.get("qkv_bias"):
            block += [("attn.bq", (H * D,), "zeros", 1.0), ("attn.bk", (Kh * D,), "zeros", 1.0),
                      ("attn.bv", (Kh * D,), "zeros", 1.0)]
    if uses_ssm(m):
        Hs, P, N = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"]
        Din = Hs * P
        block += [mat("ssm.w_z", M, Din), mat("ssm.w_xbc", M, Din + 2 * N),
                  mat("ssm.w_dt", M, Hs), mat("ssm.conv_w", CONV_W, Din + 2 * N, scale=0.5),
                  ("ssm.conv_b", (Din + 2 * N,), "zeros", 1.0), ("ssm.A_log", (Hs,), "ones", 1.0),
                  ("ssm.D", (Hs,), "ones", 1.0), ("ssm.dt_bias", (Hs,), "zeros", 1.0),
                  ("ssm.norm_w", (Din,), "ones", 1.0), mat("ssm.w_out", Din, M)]
    if m.get("d_ff"):
        Fd = m["d_ff"]
        block += [mat("mlp.wi", M, Fd), mat("mlp.wg", M, Fd), mat("mlp.wo", Fd, M)]
    tied = bool(m.get("tie_embeddings"))
    # a tied table is also the head: drawn at the head's scale, so logits keep theirs
    out = [("embed", [mat("embed", V, M, scale=M ** -0.5 if tied else 1.0)])]
    out += [(f"blocks.{layer}", list(block)) for layer in range(m["num_layers"])]
    head: List[Leaf] = [("final_norm", (M,), "ones", 1.0)]
    if not tied:
        head.append(mat("unembed", M, V))
    return out + [("head", head)]


def full_name(group: str, leaf: str) -> str:
    """The parameter's name in the program: "blocks.3.attn.wq", "embed"."""
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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), pos (S,): rotate the two halves of D by pos · theta^(−2i/D)."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = pos.float()[:, None] * inv[None, :]                       # (S, D/2)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, h: torch.Tensor, m: dict, quant: Optional[str],
              q_rows: int = 1024) -> torch.Tensor:
    """Causal GQA self-attention over h (B, S, M); query i sees keys j with
    i − window < j ≤ i (any j ≤ i without a window). Softmax in f32."""
    B, S, _ = h.shape
    H, Kh, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    window = m.get("window")
    q, k, v = mm(h, p["attn.wq"], quant), mm(h, p["attn.wk"], quant), mm(h, p["attn.wv"], quant)
    if m.get("qkv_bias"):
        q, k, v = q + p["attn.bq"], k + p["attn.bk"], v + p["attn.bv"]
    pos = torch.arange(S, device=h.device)
    theta = m.get("rope_theta", 10_000.0)
    q = rope(q.view(B, S, H, D), pos, theta)
    k = rope(k.view(B, S, Kh, D), pos, theta)
    v = v.view(B, S, Kh, D)
    G = H // Kh
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)               # (B, H, S, D)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    outs = []
    for r0 in range(0, S, q_rows):                                  # query rows in blocks
        qi = q[:, r0:r0 + q_rows].transpose(1, 2)                   # (B, H, r, D)
        s = qi @ k.transpose(-1, -2) * D ** -0.5                    # (B, H, r, S)
        i = pos[r0:r0 + q_rows, None]
        ok = pos[None, :] <= i
        if window is not None:
            ok = ok & (pos[None, :] > i - window)
        s = s.masked_fill(~ok, float("-inf"))
        outs.append((torch.softmax(s, dim=-1) @ v).transpose(1, 2))  # (B, r, H, D)
    out = torch.cat(outs, dim=1).reshape(B, S, H * D)
    return mm(out, p["attn.wo"], quant)


def ssd_chunked(x, Bm, Cm, dt, A, chunk: int) -> torch.Tensor:
    """The SSD recurrence h_t = exp(dt_t·A)·h_{t−1} + dt_t·(B_t ⊗ x_t),
    y_t = C_t·h_t, chunk by chunk. x (B, L, H, P), Bm/Cm (B, L, N), dt (B, L, H),
    A (H,). L need not be a multiple of ``chunk``: the tail is padded with
    dt = 0 (no decay, no input) after the last token, which changes nothing
    before it."""
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = -L % chunk
    if pad:
        x, Bm, Cm, dt = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, Bm, Cm, dt))
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    h = x.new_zeros(Bb, H, N, P)
    ys = []
    for c0 in range(0, L + pad, chunk):
        xc, Bc, Cc, dc = (t[:, c0:c0 + chunk] for t in (x, Bm, Cm, dt))
        cs = torch.cumsum(dc * A, dim=1)                            # (B, K, H)
        seg = (cs[:, :, None, :] - cs[:, None, :, :]).masked_fill(
            ~tril[None, :, :, None], float("-inf"))
        W = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * seg.exp() * dc[:, None]
        y = torch.einsum("bijh,bjhp->bihp", W, xc)
        y = y + torch.einsum("bin,bhnp->bihp", Cc, h) * cs.exp()[..., None]
        to_end = (cs[:, -1:] - cs).exp() * dc                       # (B, K, H)
        h = h * cs[:, -1].exp()[..., None, None] + torch.einsum(
            "bjh,bjn,bjhp->bhnp", to_end, Bc, xc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :L]


def ssm(p: dict, h: torch.Tensor, m: dict, quant: Optional[str]) -> torch.Tensor:
    """The Mamba-2 mixer over h (B, L, M): z and (x, B, C) projections, a
    causal depthwise conv of width 4 and SiLU, softplus dt, the SSD scan with
    the D skip, a gated RMSNorm, the output projection."""
    B, L, _ = h.shape
    Hs, P, N = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"]
    Din = Hs * P
    z = mm(h, p["ssm.w_z"], quant)
    raw = mm(h, p["ssm.w_xbc"], quant)
    padded = F.pad(raw, (0, 0, CONV_W - 1, 0))
    conv = sum(padded[:, i:i + L] * p["ssm.conv_w"][i] for i in range(CONV_W))
    xbc = F.silu(conv + p["ssm.conv_b"])
    dt = F.softplus(mm(h, p["ssm.w_dt"], quant) + p["ssm.dt_bias"])
    A = -torch.exp(p["ssm.A_log"])
    xs = xbc[..., :Din].reshape(B, L, Hs, P)
    y = ssd_chunked(xs, xbc[..., Din:Din + N], xbc[..., Din + N:], dt, A, m["ssm_chunk"])
    y = (y + xs * p["ssm.D"][:, None]).reshape(B, L, Din)
    y = y * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + m.get("norm_eps", 1e-5))
    return mm(y * p["ssm.norm_w"], p["ssm.w_out"], quant)


def block(p: dict, x: torch.Tensor, m: dict, quant: Optional[str] = None) -> torch.Tensor:
    """x + mixer(norm(x)), then + SwiGLU(norm(·)); a hybrid mixes 0.5·(attn + ssm)."""
    eps = m.get("norm_eps", 1e-5)
    h = rms_norm(x, p["norm_mixer"], eps)
    parts = []
    if uses_attention(m):
        parts.append(attention(p, h, m, quant))
    if uses_ssm(m):
        parts.append(ssm(p, h, m, quant))
    x = x + (parts[0] if len(parts) == 1 else 0.5 * (parts[0] + parts[1]))
    if m.get("d_ff"):
        f = rms_norm(x, p["norm_ffn"], eps)
        x = x + mm(mm(f, p["mlp.wi"], quant) * F.silu(mm(f, p["mlp.wg"], quant)),
                   p["mlp.wo"], quant)
    return x


def head(p: dict, x: torch.Tensor, m: dict, quant: Optional[str] = None) -> torch.Tensor:
    """Logits over the real vocabulary (the padded columns are never scored);
    a tied head multiplies by the embedding table, transposed."""
    x = rms_norm(x, p["final_norm"], m.get("norm_eps", 1e-5))
    w = p["embed"].T if m.get("tie_embeddings") else p["unembed"]
    return mm(x, w[:, : m["vocab_size"]], quant)


# ---------------------------------------------------------------------------
# serving: logits at chosen positions, one layer group at a time
# ---------------------------------------------------------------------------

@torch.no_grad()
def logits_at(get: Getter, m: dict, tokens: torch.Tensor, rows: List[List[int]],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each sequence b of ``tokens`` (B, S), the logits (len(rows[b]), vocab)
    at positions ``rows[b]``. Sequences shorter than S are padded at the end,
    which no earlier position sees."""
    with exact_f32():
        table = get("embed")["embed"]
        x = F.embedding(tokens, table).float()
        if not m.get("tie_embeddings"):
            del table
        for layer in range(m["num_layers"]):
            p = {k: t.float() for k, t in get(f"blocks.{layer}").items()}
            x = block(p, x, m, quant)
            del p
        p = {k: t.float() for k, t in get("head").items()}
        if m.get("tie_embeddings"):
            p["embed"] = table.float()
            del table
        return [head(p, x[b, r], m, quant) for b, r in enumerate(rows)]


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best: (n,), ≥ 0."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[:, None])[:, 0]


# ---------------------------------------------------------------------------
# training: the loss, and AdamW as the configurations state it
# ---------------------------------------------------------------------------

def loss(params: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
         targets: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood over every target; each block
    recomputed in the backward to keep the reference's memory small."""
    from torch.utils.checkpoint import checkpoint
    x = F.embedding(tokens, params["embed"])
    for layer in range(m["num_layers"]):
        prefix = f"blocks.{layer}."
        p = {k[len(prefix):]: t for k, t in params.items() if k.startswith(prefix)}
        x = checkpoint(block, p, x, m, quant, use_reentrant=False)
    logits = head({k: params[k] for k in ("final_norm", "unembed", "embed") if k in params},
                  x, m, quant)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[..., None])[..., 0]).mean()


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
    """One AdamW step in f32: the gradient clipped to a global norm of
    ``grad_clip``, bias-corrected moments, decoupled weight decay on matrices,
    each parameter rounded to ``store_dtype`` (the dtype it is stored in).
    Returns the clipped gradients, as the optimizer used them."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / norm.clamp(min=1e-12), max=1.0)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr = lr_at(step, opt)
    clipped = {}
    for n, p in params.items():
        g = grads[n] * scale
        clipped[n] = g
        m1 = state.setdefault("m", {}).get(n)
        v1 = state.setdefault("v", {}).get(n)
        m1 = (1 - b1) * g if m1 is None else b1 * m1 + (1 - b1) * g
        v1 = (1 - b2) * g.square() if v1 is None else b2 * v1 + (1 - b2) * g.square()
        state["m"][n], state["v"][n] = m1, v1
        upd = (m1 / (1 - b1 ** step)) / (torch.sqrt(v1 / (1 - b2 ** step)) + eps)
        if p.ndim >= 2:
            upd = upd + opt["weight_decay"] * p
        p.copy_((p - lr * upd).to(store_dtype).float())
    return clipped
