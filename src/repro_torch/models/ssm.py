"""Mamba-2 (SSD) mixer: chunked prefill through the SSD scan kernel, O(1) decode.

Twin of ``repro/models/ssm.py``. Where the reference runs its ``lax.scan``
over ``chunk_body``, the port calls ``ssd_scan_op``, which computes the same
chunked SSD (less the ``D`` skip, added here) in one CUDA kernel on CUDA
tensors and in plain torch on CPU tensors. Where the reference trains
through autodiff of that ``lax.scan``, ``ssd_scan_op``'s gradient is the
scan's backward kernel (``csrc/ssd_scan_bwd.cu``) on CUDA tensors and its
plain version on CPU tensors. Each step keeps the reference's
dtypes: the projections and the prefill conv in bf16, ``dt``, ``A`` and the
scan in f32, the decode conv and state in f32, ``y`` cast to bf16 before
``w_out``. Decode updates the cache in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (Shards, flatten, keep_grad_sharded, on_local_shards,
                                    split_last)
from ..kernels.ssd_scan.ops import ssd_scan_op
from .layers import weight

CONV_W = 4  # depthwise conv width


class SSM(nn.Module):
    """The ten leaves of the reference's ``init_ssm``, under its names."""

    AXES = {"w_z": ("embed", "ssm_inner"), "w_xbc": ("embed", "ssm_inner"),
            "w_dt": ("embed", None), "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",), "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "norm_w": ("ssm_inner",), "w_out": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        M, H, P, N = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        Din = H * P
        conv_ch = Din + 2 * N   # conv over (x, B, C); n_groups = 1
        self.w_z = weight(M, Din, device=device)
        self.w_xbc = weight(M, conv_ch, device=device)
        self.w_dt = weight(M, H, device=device)
        self.conv_w = weight(CONV_W, conv_ch, device=device)
        self.conv_b = weight(conv_ch, device=device)
        self.A_log = weight(H, device=device)
        self.D = weight(H, device=device)
        self.dt_bias = weight(H, device=device)
        self.norm_w = weight(Din, device=device)
        self.w_out = weight(Din, M, device=device)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * w.float()


def _conv_scan(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
               L: int) -> torch.Tensor:
    """Causal depthwise conv in xBC's dtype: the sum of CONV_W shifted products."""
    pad = F.pad(xBC, (0, 0, CONV_W - 1, 0))
    conv = sum(pad[:, i:i + L] * conv_w[i] for i in range(CONV_W))
    return F.silu(conv + conv_b)


def ssm_train(p: SSM, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """x: (B, L, M) → (B, L, M) via chunked SSD; with ``return_state`` also the
    decode state ``{"conv": (B, CONV_W − 1, conv_ch), "h": (B, H, N, P)}``."""
    B, L, M = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Din = H * P
    K = min(cfg.ssm_chunk, L)
    if L % K:
        raise ValueError("seq_len must be a multiple of ssm_chunk")

    z = keep_grad_sharded(x @ p.w_z)
    xBC_raw = keep_grad_sharded(x @ p.w_xbc)
    xBC = _conv_scan(xBC_raw, p.conv_w, p.conv_b, L)
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias.float())          # (B, L, H)
    A = -torch.exp(p.A_log.float())                                     # (H,)

    xs = split_last(xBC[..., :Din], H, P).float().contiguous()
    Bm = xBC[..., Din:Din + N].float().contiguous()                     # (B, L, N)
    Cm = xBC[..., Din + N:].float().contiguous()
    y, h_final = on_local_shards(
        lambda *a: ssd_scan_op(*a, chunk=K, return_state=True), (xs, Bm, Cm, dt, A),
        ((0, 2), (0, None), (0, None), (0, 2), (None, 0)), ((0, 2), (0, 1)), batch=B,
        heads=(H,))
    y = y + xs * p.D.float()[None, None, :, None]
    y = _gated_norm(flatten(y, 2, 3), z, p.norm_w, cfg.norm_eps)
    out = y.to(x.dtype) @ p.w_out
    if not return_state:
        return out
    # the last CONV_W − 1 inputs, zero-padded on the left for a short prompt
    conv_tail = F.pad(xBC_raw, (0, 0, CONV_W - 1, 0))[:, -(CONV_W - 1):].float()
    return out, {"conv": conv_tail, "h": h_final}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class SSMCache:
    """Every layer's decode state: ``conv`` (L, B, CONV_W − 1, conv_ch) and
    ``h`` (L, B, H, N, P), both f32, as the reference's ``init_ssm_cache``
    stacked on the layer axis. Prefill fills it; decode updates it in place.

    With ``shards`` (a step on a mesh) it holds this device's shards: its
    sequences, and ``conv_ch`` and the heads split over "model" where they
    divide (the reference's "ssm_inner" and "ssm_heads"); ``read`` gives a
    layer's state as DTensors and ``write`` takes DTensors."""

    def __init__(self, cfg: ModelConfig, batch: int, *, device: torch.device,
                 shards: Optional[Shards] = None) -> None:
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        self.shards, self.heads = shards, {"conv": (H * P + 2 * N,), "h": (H,)}
        conv_ch, heads = self.heads["conv"][0], H
        if shards is not None:
            batch = shards.local_batch
            conv_ch, heads = shards.local_heads(conv_ch)[0], shards.local_heads(H)[0]
        self.conv = torch.zeros((cfg.num_layers, batch, CONV_W - 1, conv_ch),
                                dtype=torch.float32, device=device)
        self.h = torch.zeros((cfg.num_layers, batch, heads, N, P), dtype=torch.float32,
                             device=device)

    DIMS = {"conv": (0, 2), "h": (0, 1)}      # (batch dim, split dim) of a layer's state

    def snapshot(self) -> Dict[str, int]:
        """The state's bytes on the device (conv and h, every layer)."""
        return {"reserved_bytes": self.conv.nbytes + self.h.nbytes}

    def read(self, layer: int) -> Dict[str, torch.Tensor]:
        state = {"conv": self.conv[layer], "h": self.h[layer]}
        if self.shards is None:
            return state
        return {k: self.shards.to_global(t, self.DIMS[k], self.heads[k])
                for k, t in state.items()}

    def write(self, layer: int, state: Dict[str, torch.Tensor]) -> None:
        if self.shards is not None:
            state = {k: self.shards.to_local(t, self.DIMS[k], self.heads[k])
                     for k, t in state.items()}
        self.conv[layer] = state["conv"]
        self.h[layer] = state["h"]


def _state_step(h: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, xs: torch.Tensor, D: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence, each (b, h) on its own: (y (B, H, P),
    the new state (B, H, N, P))."""
    decay = torch.exp(dt * A)
    h = h * decay[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, Bm, xs)
    return torch.einsum("bn,bhnp->bhp", Cm, h) + xs * D[None, :, None], h


def ssm_decode(p: SSM, x: torch.Tensor, cache: SSMCache, layer: int,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, 1, M); O(1) state update per token, in place in ``cache``."""
    B = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Din = H * P
    x0 = x[:, 0]
    z = x0 @ p.w_z
    xBC = x0 @ p.w_xbc
    dt_in = x0 @ p.w_dt
    state = cache.read(layer)
    hist = torch.cat([state["conv"], xBC[:, None, :].float()], dim=1)      # (B, W, C)
    conv = torch.einsum("bwc,wc->bc", hist, p.conv_w.float())
    xBC_c = F.silu(conv + p.conv_b.float())
    xs = split_last(xBC_c[..., :Din], H, P)
    Bm = xBC_c[..., Din:Din + N]
    Cm = xBC_c[..., Din + N:]

    dt = F.softplus(dt_in.float() + p.dt_bias.float())                 # (B, H)
    A = -torch.exp(p.A_log.float())
    y, h = on_local_shards(
        _state_step, (state["h"], dt, A, Bm, Cm, xs, p.D.float()),
        ((0, 1), (0, 1), (None, 0), (0, None), (0, None), (0, 1), (None, 0)),
        ((0, 1), (0, 1)), batch=B, heads=(H,))
    y = _gated_norm(y.reshape(B, Din), z, p.norm_w, cfg.norm_eps)
    out = y.to(x.dtype) @ p.w_out
    cache.write(layer, {"conv": hist[:, 1:], "h": h})
    return out[:, None, :]
