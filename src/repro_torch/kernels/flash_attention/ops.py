"""Wrapper for the flash attention kernels, forward and backward.

``flash_attention_op`` launches ``csrc/flash_attention.cu`` on CUDA
tensors and adds one to ``launches``; on CPU tensors it runs the kernel's
plain version, ``flash_attention_online`` with the kernel's alignment of
query row i at position ``i + Skv − Sq``.

When an input requires a gradient (and autograd is on) the call goes
through ``FlashAttention``, a ``torch.autograd.Function``: its forward also
keeps each query row's log-sum-exp, and its backward launches
``csrc/flash_attention_bwd.cu`` on CUDA tensors (one count in
``bwd_launches`` a call) or runs ``flash_attention_bwd_ref`` on CPU
tensors. Otherwise (serving, ``torch.no_grad()``) nothing is saved and the
forward launches exactly as it does without autograd.

On meta tensors both directions go through the custom ops
``repro_torch::flash_attention`` and ``repro_torch::flash_attention_bwd``
(``kernels/__init__.py``): shapes, and the kernels' own counts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ...distributed.sharding import refuse_dtensor
from .. import _build, meta_only, register_bytes
from .ref import flash_attention_bwd_ref, flash_attention_online

HEAD_DIMS = (32, 64, 128, 192)      # 192: MLA's qk_nope + qk_rope

launches = 0                        # forward kernel launches since the last reset
bwd_launches = 0                    # backward kernel calls since the last reset


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       q_block: int = 512, kv_block: int = 512, bf16_compute: bool = False,
                       swa_sliced_kv: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Kh, D). Returns (B, Sq, H, D).

    ``q_block``, ``kv_block``, ``bf16_compute`` and ``swa_sliced_kv`` are the
    plain version's (the config's ``blocks``, ``flash_bf16`` and ``swa``
    knobs, ``flash_attention_online``). The kernel computes the same function
    with its own Hopper tiles, skips the blocks left of a window, and on its
    bf16 path always rounds P to bf16 before P·V, as ``flash_bf16`` does."""
    refuse_dtensor("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be ≥ 1 or None, got {window}")
    plain = (q_block, kv_block, bf16_compute, swa_sliced_kv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, plain)
    return _forward(q, k, v, causal, window, False, plain)


def _forward(q, k, v, causal: bool, window: Optional[int], with_lse: bool, plain: tuple):
    """out, or (out, LSE (B, H, Sq) f32) ``with_lse``: the plain version on
    the CPU (tiles and rounding ``plain``), the custom op's shapes on meta,
    else the kernel."""
    if q.device.type == "cpu":
        q_block, kv_block, bf16_compute, swa_sliced_kv = plain
        return flash_attention_online(q, k, v, causal=causal, window=window,
                                      q_block=q_block, kv_block=kv_block,
                                      q_offset=k.shape[1] - q.shape[1],
                                      bf16_compute=bf16_compute, swa_sliced_kv=swa_sliced_kv,
                                      return_lse=with_lse)
    if q.device.type == "meta":
        out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal, window or 0,
                                                         with_lse)
        return (out, lse) if with_lse else out
    return _launch(q, k, v, causal, window, with_lse=with_lse)


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the backward kernel (the plain backward on
    the CPU), from q, k, v, the output and the forward's LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], plain: tuple):
        out, lse = _forward(q, k, v, causal, window, True, plain)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=ctx.causal,
                                                 window=ctx.window,
                                                 q_offset=k.shape[1] - q.shape[1])
        elif q.device.type == "meta":
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, out, lse, dout, ctx.causal, ctx.window or 0)
        else:
            dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# the kernels as custom ops (meta: shapes and counts) and their work
# ---------------------------------------------------------------------------

def attended_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the kernel scores: query row i sits at position
    i + Skv − Sq; it sees keys up to it (``causal``) and, with a window, the
    last ``window`` of them."""
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q_shape, k_shape, causal: bool, window: Optional[int]) -> int:
    """Operations of one forward: QKᵀ and PV, 2·D each a scored pair."""
    B, Sq, H, D = q_shape
    return 4 * D * B * H * attended_pairs(Sq, k_shape[1], causal, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int, with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, LSE or an empty tensor): meta tensors only (its fake)."""
    raise meta_only("flash_attention")


@_flash_op.register_fake
def _(q, k, v, causal, window, with_lse):
    B, Sq, H, _ = q.shape
    lse = q.new_empty((B, H, Sq) if with_lse else (0,), dtype=torch.float32)
    return torch.empty_like(q), lse


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q, k, v, causal, window, with_lse, *args, out_shape=None, **kw) -> int:
    return flash_work(q, k, causal, window or None)


@register_bytes(torch.ops.repro_torch.flash_attention)
def _(q, k, v, causal, window, with_lse, *, result) -> int:
    return sum(t.numel() * t.element_size() for t in (q, k, v, *result))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, causal: bool,
                  window: int) -> List[torch.Tensor]:
    """(dq, dk, dv): meta tensors only (its fake)."""
    raise meta_only("flash_attention_bwd")


@_flash_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, window):
    return [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q, k, v, out, lse, dout, causal, window, *args, out_shape=None, **kw) -> int:
    """Five products of 2·D a scored pair: S again, dV, dP, dQ, dK."""
    return flash_work(q, k, causal, window or None) * 5 // 2


@register_bytes(torch.ops.repro_torch.flash_attention_bwd)
def _(q, k, v, o, lse, dout, causal, window, *, result) -> int:
    """q, k, v, o, dO and the LSE read, Δ written and read, dq, dk, dv written."""
    return (sum(t.numel() * t.element_size() for t in (q, k, v, o, dout, *result))
            + 2 * lse.numel() * 4)


def _check(q, k, v) -> None:
    B, Sq, H, D = q.shape
    Bk, Skv, Kh, Dk = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (Bk != B or Dk != D or v.shape != k.shape or H % Kh
            or D not in HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (D in {HEAD_DIMS})")
    if any(t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned tensors "
                         "on one device")


def _launch(q, k, v, causal: bool, window: Optional[int], with_lse: bool = False):
    global launches
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Skv, H, Kh, D, int(causal), window or 0,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    launches += 1
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, window: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global bwd_launches
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or dout.dtype != q.dtype or lse.shape != (B, H, Sq)
            or lse.dtype != torch.float32
            or any(t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16
                   for t in (out, dout, lse))):
        raise ValueError("flash_attention backward: o and dO shaped and typed as q, "
                         "LSE (B, H, Sq) f32, all contiguous on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _lib_bwd().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, H, Kh, D, int(causal), window or 0, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib
