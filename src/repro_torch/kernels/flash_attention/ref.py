"""Plain-torch attention: the oracle and the online-softmax twin.

``attention_ref`` is the twin of the reference's
``kernels/flash_attention/ref.py`` (one masked softmax over all keys).
``flash_attention_online`` is the twin of ``models/attention.py``'s
``flash_attention_jnp``: the same block-by-block online softmax that the
CUDA kernel runs, over the reference's tiles (``q_block``/``kv_block``, the
``blocks`` knob); with ``bf16_compute`` (``flash_bf16``) its products read
their operands in q's dtype and accumulate in f32, P rounded to that dtype
before P·V; with ``swa_sliced_kv`` (``swa``) a sliding window reads a fixed
slice of ``window + q_block`` keys a query block (``_flash_swa_sliced``, the
reference's twin). With ``return_lse`` it also returns what the backward
needs, each query row's log-sum-exp. ``flash_attention_bwd_ref`` is the backward kernel's plain
version: the explicit gradient from q, k, v, o and that LSE.

q: (B, Sq, H, D); k, v: (B, Skv, Kh, D). Causal + optional sliding window.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30


def _mask(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
          device) -> torch.Tensor:
    """(Sq, Skv) bool: query i at ``q_offset + i`` may see key j."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    kv_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= kv_pos > q_pos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    G = H // Kh
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), kk) * D ** -0.5
    mask = _mask(Sq, Skv, causal, window, Skv - Sq, q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    out = torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, dim=-1), vv)
    return out.to(q.dtype)


def flash_attention_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: Optional[int] = None,
                           q_block: int = 512, kv_block: int = 512,
                           q_offset: int = 0, bf16_compute: bool = False,
                           swa_sliced_kv: bool = False, return_lse: bool = False
                           ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Online-softmax attention over (q_block × kv_block) tiles, f32 inside.

    ``q_offset`` positions q token i at ``q_offset + i`` against kv. With
    ``return_lse`` also returns the LSE, (B, H, Sq) f32: the natural log of
    Σ exp(scale·s) over the row's unmasked keys, as ``m + log(max(l, 1e-30))``
    of the online softmax (the output's own normaliser). ``bf16_compute``
    and ``swa_sliced_kv`` as the reference's (module docstring).
    """
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    if window is not None and swa_sliced_kv and Skv > window + q_block:
        return _flash_swa_sliced(q, k, v, window=window, q_block=q_block, q_offset=q_offset,
                                 bf16_compute=bf16_compute, return_lse=return_lse)
    G = H // Kh
    scale = D ** -0.5
    op = _operand(q, bf16_compute)
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    qh = op(q).reshape(B, Sq, Kh, G, D)
    kf, vf = op(k), op(v)
    out = torch.empty((B, Sq, Kh, G, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Kh, G, Sq), dtype=torch.float32, device=q.device)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    for q0 in range(0, Sq, q_block):
        qc = qh[:, q0:q0 + q_block]                            # (B, qb, Kh, G, D)
        m = torch.full((B, Kh, G, qc.shape[1]), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Kh, G, qc.shape[1], D), device=q.device)
        for k0 in range(0, Skv, kv_block):
            kc, vc = kf[:, k0:k0 + kv_block], vf[:, k0:k0 + kv_block]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc) * scale
            s = torch.where(mask[q0:q0 + q_block, k0:k0 + kv_block], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", op(p), vc)
            m = m_new
        res = acc / l.clamp(min=1e-30)[..., None]                # (B, Kh, G, qb, D)
        out[:, q0:q0 + q_block] = res.permute(0, 3, 1, 2, 4)
        lse[..., q0:q0 + q_block] = m + torch.log(l.clamp(min=1e-30))
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, lse.reshape(B, H, Sq)
    return out


def _operand(q: torch.Tensor, bf16_compute: bool):
    """A product's operand as the reference reads it: rounded to q's dtype
    under ``bf16_compute``, else f32; then widened to f32, so each product
    of two such operands is exact and the sums run in f32 (the reference's
    ``preferred_element_type=jnp.float32``)."""
    dtype = q.dtype if bf16_compute else torch.float32
    return lambda t: t.to(dtype).float()


def _flash_swa_sliced(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                      q_block: int, q_offset: int, bf16_compute: bool, return_lse: bool):
    """Sliding-window attention with a fixed slice of keys a query block: the
    twin of the reference's ``_flash_swa_sliced``. Query block i attends to
    keys [i·q_block − window, (i + 1)·q_block) (the keys padded on the left
    by ``window``), masked causally and to the window; one softmax a block."""
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    G = H // Kh
    scale = D ** -0.5
    op = _operand(q, bf16_compute)
    q_block = min(q_block, Sq)
    if Sq % q_block:
        raise ValueError(f"the sliced sliding-window path needs q_block | Sq "
                         f"({q_block}, {Sq})")
    span = window + q_block
    pad = (0, 0, 0, 0, window, 0)
    kp, vp = op(torch.nn.functional.pad(k, pad)), op(torch.nn.functional.pad(v, pad))
    qh = op(q).reshape(B, Sq, Kh, G, D)
    out = torch.empty((B, Sq, Kh, G, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Kh, G, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_block):
        ks, vs = kp[:, q0:q0 + span], vp[:, q0:q0 + span]
        q_pos = q_offset + q0 + torch.arange(q_block, device=q.device)[:, None]
        kv_pos = q0 - window + torch.arange(span, device=q.device)[None, :]
        mask = (kv_pos >= 0) & (kv_pos <= q_pos) & (kv_pos > q_pos - window)
        s = torch.einsum("bqkgd,btkd->bkgqt", qh[:, q0:q0 + q_block], ks) * scale
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1)
        res = torch.einsum("bkgqt,btkd->bkgqd", op(p), vs) / l.clamp(min=1e-30)[..., None]
        out[:, q0:q0 + q_block] = res.permute(0, 3, 1, 2, 4)
        lse[..., q0:q0 + q_block] = m[..., 0] + torch.log(l.clamp(min=1e-30))
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, lse.reshape(B, H, Sq)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit attention gradient (not autograd), f32 inside.

    With s = scale·q·k and the forward's LSE (B, H, Sq): P = exp(s − LSE)
    (0 where masked), dV = Pᵀ·dO, dP = dO·Vᵀ, Δ = rowsum(dO ⊙ O),
    dS = P ⊙ (dP − Δ), dQ = scale·dS·K, dK = scale·dSᵀ·Q. dK and dV sum over
    the G query heads of each KV head. Returns (dq, dk, dv) in the inputs'
    dtype, shaped as q, k, v.
    """
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    G = H // Kh
    scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Kh, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Kh, G, D)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kf) * scale
    p = torch.exp(s - lse.reshape(B, Kh, G, Sq, 1))
    p = torch.where(mask, p, 0.0)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dof)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, vf)
    delta = (dof * o.float().reshape(B, Sq, Kh, G, D)).sum(-1)      # (B, Sq, Kh, G)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qf) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
