"""Wrapper for the flash attention kernel.

``flash_attention_op`` launches ``csrc/flash_attention.cu`` on CUDA
tensors and adds one to ``launches``; on CPU tensors it runs the kernel's
plain version, ``flash_attention_online`` with the kernel's alignment of
query row i at position ``i + Skv − Sq``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .ref import flash_attention_online

HEAD_DIMS = (32, 64, 128, 192)      # 192: MLA's qk_nope + qk_rope

launches = 0                        # kernel launches since the last reset


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Kh, D). Returns (B, Sq, H, D)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be ≥ 1 or None, got {window}")
    if q.device.type == "cpu":
        return flash_attention_online(q, k, v, causal=causal, window=window,
                                      q_offset=k.shape[1] - q.shape[1])
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    global launches
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
    if any(t.device != q.device or not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous tensors on one device")
    out = torch.empty_like(q)
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, Kh, D, int(causal), window or 0,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib
