"""Decode attention over MLA's latent cache (DeepSeek-V2's absorbed decode).

``latent_attention`` is the entry point: on a CUDA tensor it launches
``csrc/latent_attention.cu`` and adds one to ``launches`` (the kernel and, when
the slots are split, its combine); on a CPU tensor it runs
``latent_attention_plain``, the f32 products the reference's ``mla_decode``
takes over its latent cache. The kernel takes the latent ``c_kv``, the rope key
``k_pe`` and ``q_pe`` in one dtype, bf16 (every product on the tensor cores at
f32 precision: q_lat and P enter as three bf16 terms each) or f32 (every
product on the CUDA cores), q_lat in f32, at the (latent, rope) widths of
``INSTANCES``; a CUDA call with any other raises.

The kernel splits each sequence's slots over S CTAs; S follows from the grid,
the cache's length and the SM count (``split_count``), never from a step's
values, so a captured decode step replays for every step.

On meta tensors the call goes through the custom op
``repro_torch::latent_attention`` (``kernels/__init__.py``): the output's shape,
and the kernel's count over every slot of the cache.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ...distributed.sharding import refuse_dtensor
from .. import _build, meta_only, register_bytes

NEG_INF = -1e30
# (R, dr) the kernel is built for: deepseek-v2-lite-16b and its reduced copy
INSTANCES = ((512, 64), (32, 16))
DTYPES = (torch.bfloat16, torch.float32)
HEADS_PER_CTA = 16                  # the query heads one CTA takes (an mma tile's rows)
# The grid spans this many waves of one CTA an SM (the bf16 kernel's 256
# threads take 170 registers each, so one CTA is resident an SM): a split past
# its sequence's live slots ends at once, so when the sequences fill two fifths
# to nine tenths of the cache, as chat sessions do, the CTAs with live slots
# about fill one wave. Each split takes at least MIN_SLOTS_PER_SPLIT slots.
GRID_WAVES = 1.5
MIN_SLOTS_PER_SPLIT = 256
MAX_SLOTS_PER_SPLIT = 16384         # mask bytes a CTA keeps in shared memory

launches = 0                        # kernel launches since the last reset


def latent_attention_plain(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                           k_pe: torch.Tensor, valid: torch.Tensor, scale: float, *,
                           reduce: Callable = lambda s: s) -> torch.Tensor:
    """q_lat (B, H, R) f32 and q_pe (B, H, dr) over c_kv (B, length, R) and
    k_pe (B, length, dr) at the slots where ``valid`` (B, length) holds, in
    f32, as the reference's ``mla_decode`` does: scores against the latent
    plus the rope key's, scaled, masked, softmaxed, and the latent weighted by
    them. Returns o_lat (B, H, R) f32. ``reduce`` takes the scores against
    the latent first: a cache sharded over R passes the reduction of their
    partial sum (``models/mla.py``)."""
    c_kv, k_pe = c_kv.float(), k_pe.float()
    s = reduce(torch.einsum("bhr,bsr->bhs", q_lat, c_kv))
    s = s + torch.einsum("bhd,bsd->bhs", q_pe.float(), k_pe)
    s = s * scale
    s = torch.where(valid[:, None, :], s, NEG_INF)
    return torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c_kv)


def split_count(ctas: int, length: int, sm_count: int) -> int:
    """How many splits share each of ``ctas`` (sequence, 16 heads) pairs:
    as many as ``GRID_WAVES`` waves of one CTA an SM hold, each with at least
    ``MIN_SLOTS_PER_SPLIT`` slots and at most ``MAX_SLOTS_PER_SPLIT``, and no
    trailing split without a slot."""
    want = int(GRID_WAVES * sm_count) // max(ctas, 1)
    S = max(1, min(want, length // MIN_SLOTS_PER_SPLIT), -(-length // MAX_SLOTS_PER_SPLIT))
    per = -(-length // S)
    return -(-length // per)


def kernel_takes(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                 k_pe: torch.Tensor) -> bool:
    """Whether the kernel has an instance for these widths and dtypes."""
    return (q_lat.dtype == torch.float32 and c_kv.dtype in DTYPES
            and q_pe.dtype == c_kv.dtype and k_pe.dtype == c_kv.dtype
            and (c_kv.shape[-1], k_pe.shape[-1]) in INSTANCES)


def check_args(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
               k_pe: torch.Tensor, valid: torch.Tensor) -> None:
    """The contract of every route, the CPU's and the meta's too, so that a
    caller that breaks it fails without a card: an f32 q_lat, q_pe and the
    cache in one dtype, bf16 or f32; shapes that agree; a bool mask; one
    device; every tensor contiguous (the kernel reads rows whole) and q and
    the cache 16-byte aligned (its 16-byte copies and 8-byte loads)."""
    if (q_lat.dtype != torch.float32 or c_kv.dtype not in DTYPES or q_pe.dtype != c_kv.dtype
            or k_pe.dtype != c_kv.dtype):
        raise TypeError(f"latent_attention takes an f32 q_lat and q_pe, c_kv, k_pe of one "
                        f"dtype, bf16 or f32, got {q_lat.dtype}, {q_pe.dtype}, {c_kv.dtype} "
                        f"and {k_pe.dtype}")
    B, H, R = q_lat.shape
    Bc, length, Rc = c_kv.shape
    dr = k_pe.shape[-1]
    if ((Bc, Rc) != (B, R) or tuple(k_pe.shape) != (B, length, dr)
            or tuple(q_pe.shape) != (B, H, dr)):
        raise ValueError(f"latent_attention: q_lat {tuple(q_lat.shape)}, q_pe "
                         f"{tuple(q_pe.shape)} over c_kv {tuple(c_kv.shape)}, k_pe "
                         f"{tuple(k_pe.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, length):
        raise ValueError(f"latent_attention: valid must be bool {(B, length)}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    tensors = (q_lat, q_pe, c_kv, k_pe, valid)
    if any(t.device != q_lat.device or not t.is_contiguous() for t in tensors):
        raise ValueError("latent_attention takes contiguous tensors on one device")
    if q_lat.device.type != "meta" and any(t.data_ptr() % 16 for t in tensors[:4]):
        raise ValueError("latent_attention needs q and the cache 16-byte aligned "
                         "(16-byte copies, 8-byte loads)")


def latent_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                     k_pe: torch.Tensor, valid: torch.Tensor, scale: float, *,
                     splits: Optional[int] = None) -> torch.Tensor:
    """Absorbed MLA decode attention of one query token per sequence.

    q_lat (B, H, R) f32, q_nope through W_kb; q_pe (B, H, dr); c_kv (B,
    length, R) and k_pe (B, length, dr), one layer's slices of the latent
    cache; valid (B, length) bool, the step plan's mask; ``scale`` the score
    scale (YaRN's m² included). Returns o_lat (B, H, R) f32. ``splits`` fixes
    what ``split_count`` would choose.
    """
    refuse_dtensor("latent_attention", q_lat, q_pe, c_kv, k_pe, valid)
    check_args(q_lat, q_pe, c_kv, k_pe, valid)
    if q_lat.device.type == "meta":
        return torch.ops.repro_torch.latent_attention(q_lat, q_pe, c_kv, k_pe, valid,
                                                      float(scale))
    if q_lat.device.type == "cpu":
        return latent_attention_plain(q_lat, q_pe, c_kv, k_pe, valid, scale)
    if not kernel_takes(q_lat, q_pe, c_kv, k_pe):
        raise ValueError(f"latent_attention: no instance for a latent of {c_kv.shape[-1]} and "
                         f"a rope key of {k_pe.shape[-1]} ((R, dr) in {INSTANCES})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_lat, q_pe, c_kv, k_pe)):
        raise NotImplementedError(
            "latent_attention is decode-only and has no backward kernel: it takes no input "
            "that requires a gradient on the card (training goes through flash attention)")
    return _launch(q_lat, q_pe, c_kv, k_pe, valid, scale, splits)


@torch.library.custom_op("repro_torch::latent_attention", mutates_args=())
def _latent_op(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
               valid: torch.Tensor, scale: float) -> torch.Tensor:
    """``latent_attention``: meta tensors only (its fake)."""
    raise meta_only("latent_attention")


@_latent_op.register_fake
def _(q_lat, q_pe, c_kv, k_pe, valid, scale):
    return torch.empty_like(q_lat, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.latent_attention)
def _(q_lat, q_pe, c_kv, k_pe, valid, scale, *args, out_shape=None, **kw) -> int:
    """Scores against the latent and the rope key, 2·(R + dr) a head and slot,
    and the output over the latent, 2·R, over every slot."""
    B, H, R = q_lat
    return 2 * B * H * c_kv[1] * (2 * R + k_pe[2])


@register_bytes(torch.ops.repro_torch.latent_attention)
def _(q_lat, q_pe, c_kv, k_pe, valid, scale, *, result) -> int:
    """q_lat and q_pe read and the output written, every slot's latent and
    rope key read once, the mask read."""
    return (q_lat.numel() * q_lat.element_size() + q_pe.numel() * q_pe.element_size()
            + (c_kv.numel() + k_pe.numel()) * c_kv.element_size() + valid.numel()
            + result.numel() * result.element_size())


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q_lat, q_pe, c_kv, k_pe, valid, scale, splits) -> torch.Tensor:
    global launches
    B, H, R = q_lat.shape
    length, dr = c_kv.shape[1], k_pe.shape[-1]
    ctas = B * H if c_kv.dtype == torch.float32 else B * -(-H // HEADS_PER_CTA)
    S = splits or split_count(ctas, length, sm_count(q_lat.device))
    if not 1 <= S <= length or -(-length // S) > MAX_SLOTS_PER_SPLIT:
        raise ValueError(f"latent_attention: splits must be in [1, {length}] with at most "
                         f"{MAX_SLOTS_PER_SPLIT} slots each, got {S}")
    out = torch.empty(B, H, R, dtype=torch.float32, device=q_lat.device)
    partial = (torch.empty(B * H * S * (R + 2), dtype=torch.float32, device=q_lat.device)
               if S > 1 else None)
    rc = _lib().latent_attention_fwd(
        q_lat.data_ptr(), q_pe.data_ptr(), c_kv.data_ptr(), k_pe.data_ptr(), valid.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(), B, H, R, dr, length,
        S, int(c_kv.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    _build.check(rc, "latent_attention_fwd")
    launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("latent_attention")
    lib.latent_attention_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                         + [ctypes.c_float, ctypes.c_void_p])
    lib.latent_attention_fwd.restype = ctypes.c_int
    return lib
