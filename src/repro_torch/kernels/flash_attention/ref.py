"""Plain-torch attention: the oracle and the online-softmax twin.

``attention_ref`` is the twin of the reference's
``kernels/flash_attention/ref.py`` (one masked softmax over all keys).
``flash_attention_online`` is the twin of ``models/attention.py``'s
``flash_attention_jnp`` without its sliced sliding-window branch: the
same block-by-block online softmax that the CUDA kernel runs.

q: (B, Sq, H, D); k, v: (B, Skv, Kh, D). Causal + optional sliding window.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    G = H // Kh
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), kk) * D ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    out = torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, dim=-1), vv)
    return out.to(q.dtype)


def flash_attention_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: Optional[int] = None,
                           q_block: int = 512, kv_block: int = 512,
                           q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over (q_block × kv_block) tiles, f32 inside.

    ``q_offset`` positions q token i at ``q_offset + i`` against kv.
    """
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    G = H // Kh
    scale = D ** -0.5
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    qh = q.float().reshape(B, Sq, Kh, G, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, Kh, G, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_block):
        qc = qh[:, q0:q0 + q_block]                            # (B, qb, Kh, G, D)
        q_pos = q_offset + torch.arange(q0, q0 + qc.shape[1], device=q.device)
        m = torch.full((B, Kh, G, qc.shape[1]), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Kh, G, qc.shape[1], D), device=q.device)
        for k0 in range(0, Skv, kv_block):
            kc, vc = kf[:, k0:k0 + kv_block], vf[:, k0:k0 + kv_block]
            kv_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc) * scale
            mask = torch.ones((qc.shape[1], kc.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= kv_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vc)
            m = m_new
        res = acc / l.clamp(min=1e-30)[..., None]                # (B, Kh, G, qb, D)
        out[:, q0:q0 + q_block] = res.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)
