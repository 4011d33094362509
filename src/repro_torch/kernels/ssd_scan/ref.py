"""Plain-torch SSD (Mamba-2) scans: the sequential oracle and the chunked twin.

``ssd_ref`` is the twin of the reference's ``kernels/ssd_scan/ref.py``: the
naive recurrence, one token at a time. ``ssd_chunked`` is the plain version
of the CUDA kernel: the same chunk decomposition as the Pallas
``kernels/ssd_scan/kernel.py`` body, over all (B, H) at once, and it also
returns the final state.

x: (B, L, H, P); Bm/Cm: (B, L, N) (n_groups = 1, shared by every head);
dt: (B, L, H); A: (H,) negative. y: (B, L, H, P); h: (B, H, N, P) f32.

  h_t = exp(dt·A)·h_{t-1} + dt·(B_t ⊗ x_t);  y_t = C_t · h_t
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor,
            A: torch.Tensor) -> torch.Tensor:
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    xf, Bf, Cf, dtf = x.float(), Bm.float(), Cm.float(), dt.float()
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * A)                                  # (B, H)
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, *, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-by-chunk SSD carrying h (B, H, N, P) in f32; returns (y, h_final).

    Per chunk, with cs = cumsum(dt·A):
      y = ((C·Bᵀ) ⊙ L ⊙ dt_j)·x + exp(cs) ⊙ (C·h_prev),  L_ij = exp(cs_i − cs_j), i ≥ j
      h = exp(cs_last)·h_prev + (B ⊙ dt ⊙ exp(cs_last − cs))ᵀ·x
    """
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError("L must be a multiple of chunk")
    K = chunk
    xf, Bf, Cf, dtf = x.float(), Bm.float(), Cm.float(), dt.float()
    A = A.float()
    causal = torch.ones((K, K), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, L, K):
        xk, Bk, Ck, dtk = (t[:, c0:c0 + K] for t in (xf, Bf, Cf, dtf))
        cs = torch.cumsum(dtk * A, dim=1)                                 # (B, K, H)
        # above the diagonal cs_i − cs_j > 0 and exp overflows: select 0 there
        diff = (cs[:, :, None, :] - cs[:, None, :, :]).clamp(max=0.0)     # (B, K, K, H)
        Lmat = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
        qk = torch.einsum("bin,bjn->bij", Ck, Bk)                         # (B, K, K)
        scores = qk[..., None] * Lmat * dtk[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", scores, xk)
        y = y + torch.einsum("bkn,bhnp->bkhp", Ck, h) * torch.exp(cs)[..., None]
        decay_out = torch.exp(cs[:, -1:, :] - cs)                         # (B, K, H)
        h = h * torch.exp(cs[:, -1, :])[:, :, None, None] + torch.einsum(
            "bkh,bkn,bkhp->bhnp", dtk * decay_out, Bk, xk)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h
