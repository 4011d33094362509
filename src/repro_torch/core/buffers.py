"""Byte buffers of the port's engine: torch ``uint8`` tensors.

Donor memory (regions, hot-page frames, staging slabs) is host memory,
pinned when the session's device is CUDA so that a device↔donor copy is
a DMA. A client buffer is a ``uint8`` tensor, or a ``uint8`` view of
one, on any device. Every byte move is a copy between the two.

The engine runs many Python threads (NIC PUs, donor workers, pollers,
clients), so a call that lets go of the interpreter lock for a few
microseconds can wait milliseconds to get it back, and that wait lands in
the modeled latency. A move of up to ``HOLD_GIL_BYTES`` between
contiguous buffers therefore keeps the lock: ``memmove`` between host
buffers, and the CUDA runtime torch loaded, called through
``ctypes.PyDLL``, for the card (stream query, copy, synchronize). Larger
or strided moves, and waits for work still queued on the card, go through
torch, which lets go of the lock.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

_tls = threading.local()

HOLD_GIL_BYTES = 1 << 20      # moves up to this size keep the interpreter lock
_CUDA_MEMCPY_DEFAULT = 4      # cudaMemcpyDefault: direction from the pointers
_VOID = ctypes.c_void_p


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


@functools.cache
def _libc() -> ctypes.CDLL:
    """The C library's ``memmove``, called with the interpreter lock held."""
    libc = ctypes.PyDLL(None)
    libc.memmove.argtypes = [_VOID, _VOID, ctypes.c_size_t]
    libc.memmove.restype = _VOID
    return libc


@functools.cache
def _cudart() -> Optional[ctypes.CDLL]:
    """The CUDA runtime library torch loaded, bound with ``ctypes.PyDLL``
    so its calls keep the interpreter lock; None where torch links it
    statically or there is no ``/proc`` (torch's calls then serve)."""
    torch.cuda.init()
    try:
        maps = Path("/proc/self/maps").read_text()
    except OSError:
        return None
    paths = sorted({line.split()[-1] for line in maps.splitlines()
                    if "/libcudart.so" in line})
    if not paths:
        return None
    rt = ctypes.PyDLL(paths[0])
    for name, args in (
            ("cudaMemcpyAsync", [_VOID, _VOID, ctypes.c_size_t, ctypes.c_int,
                                 _VOID]),
            ("cudaStreamSynchronize", [_VOID]),
            ("cudaStreamQuery", [_VOID])):
        fn = getattr(rt, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return rt


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


class ByteSpan(NamedTuple):
    """``nbytes`` bytes at byte ``offset`` of the contiguous tensor
    ``base``, named by address: making a span makes no tensor (slicing or
    reshaping one can let the interpreter lock go)."""

    base: torch.Tensor
    offset: int
    nbytes: int

    def tensor(self) -> torch.Tensor:
        """The span as a ``uint8`` tensor view (the ``copy_`` path only)."""
        flat = self.base.reshape(-1).view(torch.uint8)
        return flat[self.offset:self.offset + self.nbytes]


def _address(x) -> Tuple[int, int, bool, bool, torch.dtype]:
    """(pointer, bytes, on the card, contiguous, dtype) of a tensor or span."""
    if isinstance(x, ByteSpan):
        return (x.base.data_ptr() + x.offset, x.nbytes, x.base.is_cuda, True,
                torch.uint8)
    return x.data_ptr(), x.nbytes, x.is_cuda, x.is_contiguous(), x.dtype


def copy_parts(pairs: Iterable[Tuple[Union[torch.Tensor, ByteSpan],
                                     Union[torch.Tensor, ByteSpan]]]) -> None:
    """Copy ``src`` into ``dst`` (tensors or ``ByteSpan``s) for each pair,
    then wait for the CUDA stream the copies ran on, so the bytes have
    landed when this returns (callers hold the region's stripe locks
    across it). Contiguous byte pairs move by address with the
    interpreter lock held (host pairs up to ``HOLD_GIL_BYTES``; a card
    copy's synchronize lets the lock go above that total); the rest go
    through ``copy_``."""
    stream, rt, raw, total = None, None, False, 0
    for dst, src in pairs:
        d_ptr, nbytes, d_cuda, d_ok, d_type = _address(dst)
        s_ptr, s_bytes, s_cuda, s_ok, s_type = _address(src)
        cuda = d_cuda or s_cuda
        if cuda and stream is None:
            on_card = dst if d_cuda else src
            stream = torch.cuda.current_stream(
                on_card.base.device if isinstance(on_card, ByteSpan)
                else on_card.device)
            rt = _cudart()
        total += nbytes
        if (d_ok and s_ok and d_type == s_type and nbytes == s_bytes
                and (rt is not None if cuda else nbytes <= HOLD_GIL_BYTES)):
            if cuda:
                _check(rt.cudaMemcpyAsync(d_ptr, s_ptr, nbytes,
                                          _CUDA_MEMCPY_DEFAULT,
                                          stream.cuda_stream),
                       "cudaMemcpyAsync")
                raw = True
            elif nbytes:
                _libc().memmove(d_ptr, s_ptr, nbytes)
            continue
        dst, src = (x.tensor() if isinstance(x, ByteSpan) else x
                    for x in (dst, src))
        if src.shape != dst.shape:
            src = src.reshape(dst.shape)
        dst.copy_(src, non_blocking=True)
    if stream is None:
        return
    if raw and total <= HOLD_GIL_BYTES:
        _check(rt.cudaStreamSynchronize(stream.cuda_stream),
               "cudaStreamSynchronize")
    else:
        stream.synchronize()


def ready_event(payloads: Sequence[Optional[torch.Tensor]]
                ) -> Optional["torch.cuda.Event"]:
    """A CUDA event on the submitting thread's current stream when any
    payload lies on the card and that stream still has work queued; the
    NIC's copy waits for it, so a transfer reads (or overwrites) a device
    buffer only after the work queued on it before the submit. None when
    no payload is on the card or the stream is idle: everything queued
    before the submit has finished, so the bytes are ready now."""
    for p in payloads:
        if p is not None and p.is_cuda:
            stream = torch.cuda.current_stream(p.device)
            rt = _cudart()
            if rt is not None and rt.cudaStreamQuery(stream.cuda_stream) == 0:
                return None
            ev = torch.cuda.Event()
            ev.record(stream)
            return ev
    return None


def warm_up(device: torch.device) -> None:
    """Pay the card path's one-time costs before any transfer is timed:
    binding the runtime (``_cudart``) and torch's per-device stream pool,
    which the first ``torch.cuda.Stream`` fills with a few dozen streams
    (a stall of every engine thread when a NIC worker meets it first)."""
    _cudart()
    torch.cuda.Stream(device)


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
