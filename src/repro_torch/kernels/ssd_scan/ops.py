"""Wrapper for the SSD chunk-scan kernel.

``ssd_scan_op`` launches ``csrc/ssd_scan.cu`` on CUDA tensors and adds one
to ``launches`` per call (the source runs two kernels a call: C·Bᵀ once per
(batch, chunk) into a scratch buffer allocated here, then the scan, which
reads it for every head); on CPU tensors it runs the kernel's plain version,
``ssd_chunked``. With ``return_state`` it also returns the state after the
last chunk, (B, H, N, P) f32, which serving needs to start decode.

The kernel has no backward yet (ROADMAP.md §1, item 12): on CUDA tensors a
call that would need a gradient raises rather than return an output with
no history; on CPU tensors the plain version differentiates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from .. import _build
from .ref import ssd_chunked

MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 256, 128, 64

launches = 0                        # kernel launches since the last reset


def ssd_scan_op(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, *, chunk: int,
                return_state: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, L, H, P); Bm, Cm (B, L, N); dt (B, L, H); A (H,) → y (B, L, H, P)
    [, h_final (B, H, N, P)]. Requires L % chunk == 0."""
    if chunk < 1 or x.shape[1] % chunk:
        raise ValueError(f"L must be a multiple of chunk (L {x.shape[1]}, chunk {chunk})")
    if x.device.type == "cpu":
        y, h = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk)
    else:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, Bm, Cm, dt, A)):
            raise NotImplementedError(
                "ssd_scan has no backward kernel yet (ROADMAP.md §1, item 12): the SSM "
                "and hybrid archs train on the CPU until it lands")
        y, h = _launch(x, Bm, Cm, dt, A, chunk, return_state)
    return (y, h) if return_state else y


def _launch(x, Bm, Cm, dt, A, chunk: int, return_state: bool):
    global launches
    tensors = (x, Bm, Cm, dt, A)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_scan takes f32 x, Bm, Cm, dt, A, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if (Bm.shape != (B, L, N) or Cm.shape != (B, L, N) or dt.shape != (B, L, H)
            or A.shape != (H,) or chunk > MAX_CHUNK or N > MAX_STATE
            or P > MAX_HEAD_DIM):
        raise ValueError(
            f"ssd_scan: unsupported shapes x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, chunk "
            f"{chunk} (chunk ≤ {MAX_CHUNK}, N ≤ {MAX_STATE}, P ≤ {MAX_HEAD_DIM})")
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan takes contiguous tensors on one device")
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device) \
        if return_state else None
    k16 = -(-chunk // 16) * 16                     # chunk rounded up to the mma tile
    cb = torch.empty(B * (L // chunk) * k16 * k16, dtype=torch.float32, device=x.device)
    rc = _lib().ssd_scan_fwd(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(),
        y.data_ptr(), None if h is None else h.data_ptr(), cb.data_ptr(),
        B, L, H, P, N, chunk, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_scan_fwd")
    launches += 1
    return y, h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib
