"""Byte buffers of the port's engine: torch ``uint8`` tensors.

Donor memory (regions, hot-page frames, staging slabs) is host memory,
pinned when the session's device is CUDA so that a device↔donor copy is
a DMA. A client buffer is a ``uint8`` tensor, or a ``uint8`` view of
one, on any device. Every byte move is a ``copy_`` between the two.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Sequence, Tuple

import torch

_tls = threading.local()


def host_bytes(shape, pin_memory: bool = False) -> torch.Tensor:
    """Zeroed host ``uint8`` memory, allocated once at build time."""
    return torch.zeros(shape, dtype=torch.uint8, pin_memory=pin_memory)


def byte_view(t: torch.Tensor, writable: bool = False) -> torch.Tensor:
    """The tensor's bytes as ``uint8``, never a cast of its values: a
    ``uint8`` tensor as it is, any other dtype as a flat byte view. A
    non-contiguous tensor of another dtype is copied first, so one that
    is to be written into (``writable``) must be contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch tensor, got {type(t).__name__}")
    if t.dtype == torch.uint8:
        return t
    if not t.is_contiguous():
        if writable:
            raise ValueError(
                f"a {t.dtype} buffer read into must be contiguous, so that "
                f"its bytes can be viewed in place")
        t = t.contiguous()
    return t.reshape(-1).view(torch.uint8)


def copy_parts(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """``dst.copy_(src)`` for each pair, then wait for the CUDA stream the
    copies ran on, so the bytes have landed when this returns (callers
    hold the region's stripe locks across it)."""
    dev = None
    for dst, src in pairs:
        if src.shape != dst.shape:
            src = src.reshape(dst.shape)
        dst.copy_(src, non_blocking=True)
        if dev is None and (dst.is_cuda or src.is_cuda):
            dev = dst.device if dst.is_cuda else src.device
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()


def ready_event(payloads: Sequence[Optional[torch.Tensor]]):
    """A CUDA event recorded on the submitting thread's current stream
    when any payload lies on the card, else None. The NIC's copy waits on
    it, so a transfer reads (or overwrites) a device buffer only after
    the work queued on it before the submit."""
    for p in payloads:
        if p is not None and p.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
            return ev
    return None


def worker_stream(device: torch.device) -> "torch.cuda.Stream":
    """This thread's own CUDA stream for ``device`` (made once per NIC
    worker thread), so the engine's copies overlap the caller's work."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    streams = getattr(_tls, "streams", None)
    if streams is None:
        streams = _tls.streams = {}
    s = streams.get(index)
    if s is None:
        s = streams[index] = torch.cuda.Stream(index)
    return s
