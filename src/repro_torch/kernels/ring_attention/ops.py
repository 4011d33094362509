"""Decode attention over a dense ring of K/V slots (sliding-window archs).

``ring_attention`` is the entry point: on a CUDA tensor it launches
``csrc/ring_attention.cu`` and adds one to ``launches`` (the kernel and, when
the slots are split, its combine); on a CPU tensor it runs
``ring_attention_plain``, the f32 products the reference's
``attention_decode`` takes over its ring. The kernel takes q and a ring of
one dtype, bf16 (q·K on the tensor cores, exact for bf16 operands) or f32
(every product on the CUDA cores), at the (head dim, query heads a KV head)
pairs of ``INSTANCES``; a CUDA call with any other raises.

The kernel splits each (sequence, KV head)'s slots over S CTAs; S follows
from the grid, the ring's length and the SM count (``split_count``), never
from a step's values, so a captured decode step replays for every step.

On meta tensors the call goes through the custom op
``repro_torch::ring_attention`` (``kernels/__init__.py``): the output's shape,
and the kernel's count over every slot of the ring.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ...distributed.sharding import refuse_dtensor
from .. import _build, meta_only, register_bytes

NEG_INF = -1e30
# (D, G) the kernel is built for: hymba-1.5b, its reduced copy, and the largest
# head and group (the tests' edge cases)
INSTANCES = ((64, 5), (32, 2), (128, 8))
DTYPES = (torch.bfloat16, torch.float32)
# Splits fill every SM this deep, with at least this many slots each: at 1024
# slots of hymba-1.5b's heads the pick is the fastest measured at B 1, 4, 16
# and 64 (S 4, 4, 4 and 1; csrc/ring_attention.cu's note)
CTAS_PER_SM = 2
MIN_SLOTS_PER_SPLIT = 256
MAX_SLOTS_PER_SPLIT = 32768         # valid bytes a CTA keeps in shared memory

launches = 0                        # kernel launches since the last reset


def ring_attention_plain(q: torch.Tensor, k_ring: torch.Tensor, v_ring: torch.Tensor,
                         valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, H, D) over k_ring, v_ring (B, length, Kh, D) at the slots where
    ``valid`` (B, length) holds, in f32, as the reference's ``attention_decode``
    does. Returns (B, H, D) in q's dtype."""
    kc, vc = k_ring.float(), v_ring.float()
    B, H, D = q.shape
    Kh = kc.shape[2]
    qh = q.reshape(B, Kh, H // Kh, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, kc) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), vc)
    return out.reshape(B, H, D).to(q.dtype)


def split_count(ctas: int, length: int, sm_count: int) -> int:
    """How many splits share each of ``ctas`` (sequence, KV head) pairs:
    enough for ``CTAS_PER_SM`` CTAs on every SM, each with at least
    ``MIN_SLOTS_PER_SPLIT`` slots and at most ``MAX_SLOTS_PER_SPLIT``, and no
    trailing split without a slot."""
    want = -(-CTAS_PER_SM * sm_count // max(ctas, 1))
    S = max(1, min(want, length // MIN_SLOTS_PER_SPLIT), -(-length // MAX_SLOTS_PER_SPLIT))
    per = -(-length // S)
    return -(-length // per)


def kernel_takes(q: torch.Tensor, k_ring: torch.Tensor) -> bool:
    """Whether the kernel has an instance for these shapes and dtypes."""
    H, D, Kh = q.shape[1], q.shape[2], k_ring.shape[2]
    return (q.dtype in DTYPES and k_ring.dtype == q.dtype and H % Kh == 0
            and (D, H // Kh) in INSTANCES)


def ring_attention(q: torch.Tensor, k_ring: torch.Tensor, v_ring: torch.Tensor,
                   valid: torch.Tensor, scale: float, *,
                   splits: Optional[int] = None) -> torch.Tensor:
    """Decode attention of one query token per sequence over a dense ring.

    q (B, H, D); k_ring, v_ring (B, length, Kh, D), one layer's slices of the
    ring; valid (B, length) bool, the step plan's mask. Returns (B, H, D) in
    q's dtype. ``splits`` fixes what ``split_count`` would choose.
    """
    refuse_dtensor("ring_attention", q, k_ring, v_ring, valid)
    if q.device.type == "meta":
        return torch.ops.repro_torch.ring_attention(q, k_ring, v_ring, valid, float(scale))
    if q.device.type == "cpu":
        return ring_attention_plain(q, k_ring, v_ring, valid, scale)
    if q.dtype not in DTYPES or k_ring.dtype != q.dtype or v_ring.dtype != q.dtype:
        raise TypeError(f"ring_attention takes bf16 or f32 q and ring of one dtype, got "
                        f"{q.dtype}, {k_ring.dtype} and {v_ring.dtype}")
    if not kernel_takes(q, k_ring):
        raise ValueError(f"ring_attention: no instance for q {tuple(q.shape)} over a ring "
                         f"{tuple(k_ring.shape)} ((D, H / Kh) in {INSTANCES})")
    if torch.is_grad_enabled() and (q.requires_grad or k_ring.requires_grad
                                    or v_ring.requires_grad):
        raise NotImplementedError(
            "ring_attention is decode-only and has no backward kernel: it takes no input "
            "that requires a gradient on the card (training goes through flash attention)")
    return _launch(q, k_ring, v_ring, valid, scale, splits)


@torch.library.custom_op("repro_torch::ring_attention", mutates_args=())
def _ring_op(q: torch.Tensor, k_ring: torch.Tensor, v_ring: torch.Tensor, valid: torch.Tensor,
             scale: float) -> torch.Tensor:
    """``ring_attention``: meta tensors only (its fake)."""
    raise meta_only("ring_attention")


@_ring_op.register_fake
def _(q, k_ring, v_ring, valid, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.ring_attention)
def _(q, k_ring, v_ring, valid, scale, *args, out_shape=None, **kw) -> int:
    """q·K and P·V, 2·D each a query head and slot, over every slot."""
    B, H, D = q
    return 4 * D * H * B * k_ring[1]


@register_bytes(torch.ops.repro_torch.ring_attention)
def _(q, k_ring, v_ring, valid, scale, *, result) -> int:
    """q read and the output written, every slot's K and V read once, the
    mask read."""
    return (2 * q.numel() * q.element_size()
            + (k_ring.numel() + v_ring.numel()) * k_ring.element_size() + valid.numel())


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, k_ring, v_ring, valid, scale, splits) -> torch.Tensor:
    global launches
    B, H, D = q.shape
    Bk, length, Kh, Dk = k_ring.shape
    if (Bk, Dk) != (B, D) or tuple(v_ring.shape) != tuple(k_ring.shape):
        raise ValueError(f"ring_attention: q {tuple(q.shape)} and a ring of K "
                         f"{tuple(k_ring.shape)}, V {tuple(v_ring.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, length):
        raise ValueError(f"valid must be bool {(B, length)}, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    tensors = (q, k_ring, v_ring, valid)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("ring_attention takes contiguous tensors on one device")
    if q.data_ptr() % 16 or k_ring.data_ptr() % 16 or v_ring.data_ptr() % 16:
        raise ValueError("ring_attention needs q and the ring 16-byte aligned "
                         "(16-byte copies and loads)")
    S = splits or split_count(B * Kh, length, sm_count(q.device))
    if not 1 <= S <= length or -(-length // S) > MAX_SLOTS_PER_SPLIT:
        raise ValueError(f"ring_attention: splits must be in [1, {length}] with at most "
                         f"{MAX_SLOTS_PER_SPLIT} slots each, got {S}")
    out = torch.empty_like(q)
    partial = (torch.empty(B * Kh * S * (H // Kh) * (D + 2), dtype=torch.float32,
                           device=q.device) if S > 1 else None)
    rc = _lib().ring_attention_fwd(
        q.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(), valid.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), B, H, Kh, D, length, S,
        int(q.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "ring_attention_fwd")
    launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_attention")
    lib.ring_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                       + [ctypes.c_float, ctypes.c_void_p])
    lib.ring_attention_fwd.restype = ctypes.c_int
    return lib
