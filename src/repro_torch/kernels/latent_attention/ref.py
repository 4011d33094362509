"""Plain-torch oracle for decode attention over MLA's latent cache: the
arithmetic of the reference's ``mla_decode`` (``repro/models/mla.py``) after
its cache write, in float64, on the positions alone.

q_lat:    (B, H, R)        q_nope through W_kb
q_pe:     (B, H, dr)       the rope part of the query
c_kv:     (B, S, R)        the latent cache: token p at slot p (it never wraps)
k_pe:     (B, S, dr)       the rope keys
cur:      (B,)             the step's position: slots 0..cur count

Returns o_lat (B, H, R) in float64: the yardstick both the plain f32 version
and the kernel are measured against.
"""

from __future__ import annotations

import torch


def latent_attention_ref(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                         k_pe: torch.Tensor, cur: torch.Tensor, scale: float) -> torch.Tensor:
    S = c_kv.shape[1]
    valid = torch.arange(S, device=c_kv.device)[None, :] <= cur.long()[:, None]
    c = c_kv.double()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.double(), c)
         + torch.einsum("bhd,bsd->bhs", q_pe.double(), k_pe.double())) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    return torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c)
