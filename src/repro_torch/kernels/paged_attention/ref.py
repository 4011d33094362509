"""Plain-torch oracle for paged decode attention (twin of the reference's
``kernels/paged_attention/ref.py``), computed in float32.

q:          (B, H, D)           one query token per sequence
kv_pages:   (P, T, 2, Kh, D)    pooled pages: T tokens each, k & v
page_table: (B, Pmax)           page ids per sequence (−1 = unused)
lengths:    (B,)                tokens so far (cache length per sequence)

Returns (B, H, D) in q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, kv_pages: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
    B, H, D = q.shape
    _, T, _, Kh, _ = kv_pages.shape
    Pmax = page_table.shape[1]
    G = H // Kh

    gathered = kv_pages[page_table.clamp(min=0).long()]   # (B, Pmax, T, 2, Kh, D)
    k = gathered[:, :, :, 0].reshape(B, Pmax * T, Kh, D).float()
    v = gathered[:, :, :, 1].reshape(B, Pmax * T, Kh, D).float()

    pos = torch.arange(Pmax * T, device=q.device)[None, :]
    valid = (pos < lengths[:, None]) & (page_table >= 0).repeat_interleave(T, dim=1)

    qh = q.reshape(B, Kh, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k) * D ** -0.5
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(B, H, D).to(q.dtype)
