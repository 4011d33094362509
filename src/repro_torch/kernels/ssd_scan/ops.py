"""Wrapper for the SSD chunk-scan kernels, forward and backward.

``ssd_scan_op`` launches ``csrc/ssd_scan.cu`` on CUDA tensors and adds one
to ``launches`` per call (the source runs two kernels a call: C·Bᵀ once per
(batch, chunk) into a scratch buffer allocated here, then the scan, which
reads it for every head); on CPU tensors it runs the kernel's plain version,
``ssd_chunked``. With ``return_state`` it also returns the state after the
last chunk, (B, H, N, P) f32, which serving needs to start decode.

When an input requires a gradient (and autograd is on) the call goes
through ``SSDScan``, a ``torch.autograd.Function``: its forward launches the
scan's training forward (``ssd_scan_fwd_states`` in the same source: y in
f32 on the CUDA cores, the state sweep on the FP64 tensor cores, cs summed in
f64, the state entering each chunk written; ``ssd_chunked(..., cs64=True)``
on CPU tensors), and its backward launches ``csrc/ssd_scan_bwd.cu`` (every
product on the FP64 tensor cores) on CUDA tensors
(one count in ``bwd_launches`` a call) or runs ``ssd_scan_bwd_ref`` on CPU
tensors. Otherwise (serving, ``torch.no_grad()``) nothing is saved and the
forward launches exactly as it does without autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from .. import _build
from .ref import ssd_chunked, ssd_scan_bwd_ref

MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 256, 128, 64

launches = 0                        # forward kernel launches since the last reset
bwd_launches = 0                    # backward kernel calls since the last reset


def ssd_scan_op(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, *, chunk: int,
                return_state: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, L, H, P); Bm, Cm (B, L, N); dt (B, L, H); A (H,) → y (B, L, H, P)
    [, h_final (B, H, N, P)]. Requires L % chunk == 0."""
    if chunk < 1 or x.shape[1] % chunk:
        raise ValueError(f"L must be a multiple of chunk (L {x.shape[1]}, chunk {chunk})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, Bm, Cm, dt, A)):
        y, h = SSDScan.apply(x, Bm, Cm, dt, A, chunk)
    elif x.device.type == "cpu":
        y, h = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk)
    else:
        y, h = _launch(x, Bm, Cm, dt, A, chunk, return_state)
    return (y, h) if return_state else y


class SSDScan(torch.autograd.Function):
    """The scan whose gradient is the backward kernel (the plain backward on
    the CPU), from the inputs and the state entering each chunk. Returns
    (y, h_final); either cotangent may be absent."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A, chunk: int):
        if x.device.type == "cpu":
            y, h, states = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, return_states=True,
                                       cs64=True)
        else:
            y, h, states = _launch(x, Bm, Cm, dt, A, chunk, True, with_states=True)
        ctx.save_for_backward(x, Bm, Cm, dt, A, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, Bm, Cm, dt, A, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        if x.device.type == "cpu":
            grads = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, dh, chunk=ctx.chunk)
        else:
            grads = _launch_bwd(x, Bm, Cm, dt, A, states, dy, dh, ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, (x, Bm, Cm, dt, A))), None)


def _check(x, Bm, Cm, dt, A, chunk: int, what: str) -> None:
    tensors = (x, Bm, Cm, dt, A)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes f32 x, Bm, Cm, dt, A, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if (Bm.shape != (B, L, N) or Cm.shape != (B, L, N) or dt.shape != (B, L, H)
            or A.shape != (H,) or chunk > MAX_CHUNK or N > MAX_STATE
            or P > MAX_HEAD_DIM):
        raise ValueError(
            f"{what}: unsupported shapes x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, chunk "
            f"{chunk} (chunk ≤ {MAX_CHUNK}, N ≤ {MAX_STATE}, P ≤ {MAX_HEAD_DIM})")
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors on one device")


def _launch(x, Bm, Cm, dt, A, chunk: int, return_state: bool, with_states: bool = False):
    """y and h_final (None unless ``return_state``); with ``with_states`` also
    the state entering each chunk, (B, L // chunk, H, N, P), from the training
    forward (f32-exact, cs in f64) instead of serving's 3×TF32 tensor-core
    scan."""
    global launches
    _check(x, Bm, Cm, dt, A, chunk, "ssd_scan")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device) \
        if return_state else None
    k16 = -(-chunk // 16) * 16                     # chunk rounded up to the mma tile
    cb = torch.empty(B * (L // chunk) * k16 * k16, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(),
            y.data_ptr(), None if h is None else h.data_ptr(), cb.data_ptr())
    if with_states:
        states = torch.empty((B, L // chunk, H, N, P), dtype=torch.float32,
                             device=x.device)
        rc = _lib().ssd_scan_fwd_states(*args, states.data_ptr(), B, L, H, P, N, chunk,
                                        stream)
        _build.check(rc, "ssd_scan_fwd_states")
        launches += 1
        return y, h, states
    rc = _lib().ssd_scan_fwd(*args, B, L, H, P, N, chunk, stream)
    _build.check(rc, "ssd_scan_fwd")
    launches += 1
    return y, h


def _launch_bwd(x, Bm, Cm, dt, A, states, dy, dh, chunk: int):
    """(dx, dB, dC, ddt, dA) from ``csrc/ssd_scan_bwd.cu``; ``dh`` (h_final's
    cotangent) may be None."""
    global bwd_launches
    _check(x, Bm, Cm, dt, A, chunk, "ssd_scan backward")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    extra = (states, dy) + (() if dh is None else (dh,))
    if (states.shape != (B, L // chunk, H, N, P) or dy.shape != x.shape
            or (dh is not None and dh.shape != (B, H, N, P))
            or any(t.dtype != torch.float32 or t.device != x.device
                   or not t.is_contiguous() for t in extra)):
        raise ValueError("ssd_scan backward: states (B, L / chunk, H, N, P), dy shaped as "
                         "x and dh_final (B, H, N, P), all f32, contiguous, on x's device")
    lib = _lib_bwd()
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.empty_like(A)
    scratch = torch.empty(lib.ssd_scan_bwd_scratch_floats(B, L, H, P, N, chunk),
                          dtype=torch.float32, device=x.device)
    rc = lib.ssd_scan_bwd(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(),
        states.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
        dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        scratch.data_ptr(), B, L, H, P, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_scan_bwd")
    bwd_launches += 1
    return dx, dB, dC, ddt, dA


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_fwd_states.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ssd_scan_fwd_states.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_scratch_floats.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib
