"""Plain-torch oracle for decode attention over a ring of K/V slots: the
arithmetic of the reference's windowed ``attention_decode``
(``repro/models/attention.py``) after its cache write, in float32.

q:        (B, H, D)            one query token per sequence
k, v:     (B, S, Kh, D)        the ring: token p at slot p % S
cur:      (B,)                 the step's position (tokens so far)

Slot s holds the token of age (cur % S − s) mod S and counts while that age
is below min(cur + 1, S). Returns (B, H, D) in q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cur: torch.Tensor) -> torch.Tensor:
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    slot = cur.long() % S
    age = (slot[:, None] - torch.arange(S, device=k.device)[None, :]) % S
    valid = age < (cur.long()[:, None] + 1).clamp(max=S)

    qh = q.reshape(B, Kh, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k.float()) * (D ** -0.5)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(B, H, D).to(q.dtype)
