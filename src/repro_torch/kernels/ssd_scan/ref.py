"""Plain-torch SSD (Mamba-2) scans: the sequential oracle and the chunked twin.

``ssd_ref`` is the twin of the reference's ``kernels/ssd_scan/ref.py``: the
naive recurrence, one token at a time. ``ssd_chunked`` is the plain version
of the CUDA kernel: the same chunk decomposition as the Pallas
``kernels/ssd_scan/kernel.py`` body, over all (B, H) at once, and it also
returns the final state (and, on request, the state entering each chunk).
``ssd_scan_bwd_ref`` is the plain version of the backward kernel: the
gradient of ``ssd_chunked`` as an explicit reverse sweep over the chunks.

x: (B, L, H, P); Bm/Cm: (B, L, N) (n_groups = 1, shared by every head);
dt: (B, L, H); A: (H,) negative. y: (B, L, H, P); h: (B, H, N, P) f32.

  h_t = exp(dt·A)·h_{t-1} + dt·(B_t ⊗ x_t);  y_t = C_t · h_t
"""

from __future__ import annotations

from typing import Optional, Tuple

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
                dt: torch.Tensor, A: torch.Tensor, *, chunk: int,
                return_states: bool = False, cs64: bool = False):
    """Chunk-by-chunk SSD carrying h (B, H, N, P) in f32; returns (y, h_final),
    and with ``return_states`` also the state entering each chunk,
    (B, L // chunk, H, N, P) f32 (zeros for the first), which the backward reads.
    With ``cs64`` cs is summed in f64 (a·dt rounded to f32 first) and each
    exponent rounded to f32 once, as the training forward's kernel instance
    and the backward sum it; serving's kernel and this default sum in f32.

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
    ys, states = [], []
    for c0 in range(0, L, K):
        states.append(h)
        xk, Bk, Ck, dtk = (t[:, c0:c0 + K] for t in (xf, Bf, Cf, dtf))
        dA = dtk * A
        cs = torch.cumsum(dA.double() if cs64 else dA, dim=1)             # (B, K, H)
        # above the diagonal cs_i − cs_j > 0 and exp overflows: select 0 there
        diff = (cs[:, :, None, :] - cs[:, None, :, :]).clamp(max=0.0)     # (B, K, K, H)
        Lmat = torch.where(causal[None, :, :, None], torch.exp(diff.float()), 0.0)
        qk = torch.einsum("bin,bjn->bij", Ck, Bk)                         # (B, K, K)
        scores = qk[..., None] * Lmat * dtk[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", scores, xk)
        y = y + torch.einsum("bkn,bhnp->bkhp", Ck, h) * torch.exp(cs.float())[..., None]
        decay_out = torch.exp((cs[:, -1:, :] - cs).float())               # (B, K, H)
        h = h * torch.exp(cs[:, -1, :].float())[:, :, None, None] + torch.einsum(
            "bkh,bkn,bkhp->bhnp", dtk * decay_out, Bk, xk)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    if return_states:
        return y, h, torch.stack(states, dim=1)
    return y, h


def ssd_scan_bwd_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     dt: torch.Tensor, A: torch.Tensor, states: torch.Tensor,
                     dy: torch.Tensor, dh_final: Optional[torch.Tensor], *, chunk: int
                     ) -> Tuple[torch.Tensor, ...]:
    """Gradient of ``ssd_chunked(..., cs64=True)``'s (y, h_final): (dx, dB, dC,
    ddt, dA), f32.

    ``states`` (B, nC, H, N, P) are the states entering each chunk, ``dy`` y's
    cotangent and ``dh_final`` h_final's (None: zero). The chunks are swept in
    reverse carrying dh, the cotangent of the state leaving the chunk. Per
    chunk, with cs = cumsum(a·dt), G_ij = C_i·B_j, L_ij = exp(cs_i − cs_j) and
    W_ij = G_ij·L_ij·dt_j for j ≤ i (0 above the diagonal: no gradient flows
    through the masked entries), w_j = dt_j·exp(cs_last − cs_j), h⁻ the state
    entering and dW_ij = dy_i·x_j:

      dx_j  = Σ_{i≥j} W_ij·dy_i + w_j·(B_j·dh)
      dC_i  = Σ_{j≤i} dW_ij·L_ij·dt_j·B_j + exp(cs_i)·(h⁻·dy_i)
      dB_j  = Σ_{i≥j} dW_ij·L_ij·dt_j·C_i + w_j·(dh·x_j)         (both summed over heads)
      ddt_j = Σ_{i≥j} dW_ij·G_ij·L_ij + exp(cs_last − cs_j)·u_j + a·Σ_{i≥j} dcs_i
      dh⁻   = exp(cs_last)·dh + Σ_i exp(cs_i)·C_i ⊗ dy_i

    where u_j = B_j·dh·x_j and dcs, the cotangent of cs, gathers S_ij = dW_ij·W_ij
    (+ on row i, − on column j, j < i), exp(cs_i)·C_i·h⁻·dy_i, −w_j·u_j, and on
    the last token Σ_j w_j·u_j + exp(cs_last)·Σ h⁻ ⊙ dh; dA = Σ dcs_i·Σ_{t≤i} dt_t.

    cs is summed in f64 (a·dt rounded to f32 first), as the backward kernel
    sums it: over a chunk of 256 it runs to −O(500), and a difference of two
    f32 sums that deep is off by ~1e-4 relative, in an order-dependent way.
    dcs, its reverse cumsum and dA are f64 sums of the f32 terms too: each
    S_ij enters dcs with both signs, and dA weighs dcs_i by Σ_{t≤i} dt_t, so
    f32 rounding of those sums would reach dA amplified by that weight (up to
    ~200 at chunk 256).
    """
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError("L must be a multiple of chunk")
    K = chunk
    xf, Bf, Cf, dtf, dyf = (t.float() for t in (x, Bm, Cm, dt, dy))
    a = A.float()
    causal = torch.ones((K, K), dtype=torch.bool, device=x.device).tril()
    strict = causal.tril(-1)
    dh = (torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
          if dh_final is None else dh_final.float())
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros(H, dtype=torch.float64, device=x.device)
    for c in reversed(range(L // K)):
        sl = slice(c * K, (c + 1) * K)
        xk, Bk, Ck, dtk, dyk = (t[:, sl] for t in (xf, Bf, Cf, dtf, dyf))
        hp = states[:, c].float()                                         # (B, H, N, P)
        cs = torch.cumsum((dtk * a).double(), dim=1)                      # (B, K, H)
        cs_last = cs[:, -1]                                               # (B, H)
        diff = (cs[:, :, None, :] - cs[:, None, :, :]).clamp(max=0.0)     # (B, K, K, H)
        Lm = torch.where(causal[None, :, :, None], torch.exp(diff.float()), 0.0)
        ecs = torch.exp(cs.float())                                       # (B, K, H)
        e_out = torch.exp((cs_last[:, None] - cs).float())                # (B, K, H)
        w = dtk * e_out
        e_last = torch.exp(cs_last.float())                               # (B, H)
        G = torch.einsum("bin,bjn->bij", Ck, Bk)                          # (B, K, K)
        GL = G[..., None] * Lm                                            # (B, K, K, H)
        W = GL * dtk[:, None]
        dW = torch.einsum("bihp,bjhp->bijh", dyk, xk)
        dG = dW * Lm * dtk[:, None]
        S = torch.where(strict[None, :, :, None], dW * W, 0.0)
        v = torch.einsum("bhnp,bjhp->bjhn", dh, xk)                       # dh·x_j
        hdy = torch.einsum("bhnp,bihp->bihn", hp, dyk)                    # h⁻·dy_i
        u = torch.einsum("bjn,bjhn->bjh", Bk, v)
        dx[:, sl] = (torch.einsum("bijh,bihp->bjhp", W, dyk)
                     + w[..., None] * torch.einsum("bjn,bhnp->bjhp", Bk, dh))
        dC[:, sl] = (torch.einsum("bijh,bjn->bin", dG, Bk)
                     + torch.einsum("bih,bihn->bin", ecs, hdy))
        dB[:, sl] = (torch.einsum("bijh,bin->bjn", dG, Ck)
                     + torch.einsum("bjh,bjhn->bjn", w, v))
        ddt_dir = (dW * GL).sum(1) + e_out * u
        wu = (w * u).double()
        S = S.double()
        dcs = (S.sum(2) - S.sum(1) + (ecs * torch.einsum("bin,bihn->bih", Ck, hdy)).double()
               - wu)
        dcs[:, -1] += wu.sum(1) + (e_last * (hp * dh).sum((-2, -1))).double()
        R = dcs.flip(1).cumsum(1).flip(1)                                 # Σ_{i≥t} dcs_i
        ddt[:, sl] = ddt_dir + (a.double() * R).float()
        dA += (dtk.double() * R).sum((0, 1))
        dh = e_last[..., None, None] * dh + torch.einsum("bih,bin,bihp->bhnp", ecs, Ck, dyk)
    return dx, dB, dC, ddt, dA.float()
