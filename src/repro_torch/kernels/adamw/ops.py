"""AdamW over every leaf of a model in two launches of ``csrc/adamw.cu``.

``adamw_fused`` is the entry point of ``optim.adamw.update`` on the card: the
gradients' global norm in one launch, then the clip, both moments, the decay
and each parameter's write-back in its own dtype in another, over all the
leaves at once, and 2 added to ``launches``.

``plain_reason`` decides from the tensors alone. Leaves off the card (CPU
tensors, the dry run's meta tensors) go to the plain version in ``ref.py``,
and the reason says why. Leaves on the card always take the kernel, which
has an instance for contiguous tensors on one device, gradients and
parameters in bf16 or f32, moments in f32, each leaf's four of one size;
any other leaf on the card raises, a TypeError for its dtype and a
ValueError for the rest, as ``ring_attention`` does. A DTensor counts by
its shard on this device: ``optim.adamw.update`` hands the kernel the
shards of a one-device mesh, where a shard is the whole leaf. A wider mesh
raises, since the kernel's norm would cover this device's shards only (the
port's real meshes are 1 × 1: ``launch.mesh.make_local_mesh``).

Each call fills a table of the leaves' addresses (g, p, m, v and the new
m' and v') in pinned memory and copies it to the device in one
asynchronous copy; PyTorch's pinned-memory cache keeps that memory until
the copy has run. What depends on the leaves' shapes and dtypes alone (each
leaf's size, decay and dtypes, which chunk belongs to which leaf) is
planned once per set of shapes and kept on the device (``plan``). The new
moments are a tensor a leaf, allocated each call: a state that was handed
out is never written again, and a reader that holds one leaf's moment holds
that leaf's memory alone. Nothing here synchronises with the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...distributed.sharding import is_dtensor
from .. import _build

DTYPES = (torch.bfloat16, torch.float32)
CHUNK = 32768          # elements a chunk: csrc/adamw.cu kChunk
# Grids, in blocks of 256 threads an SM: the fastest measured at hymba-1.5b's
# 611 leaves (H100 SXM, 700 W): the norm 1.03 ms at 4-6 (1.17 at 2), the
# update with the norm 14.1 ms at 2 (14.8 at 4; 16.0 at 1)
NORM_BLOCKS_PER_SM = 6
UPDATE_BLOCKS_PER_SM = 2
DECAY, GRAD_F32, PARAM_F32 = 1, 2, 4   # csrc/adamw.cu's flags

launches = 0           # kernel launches since the last reset


def plain_reason(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor] = (),
                 m: Sequence[torch.Tensor] = (), v: Sequence[torch.Tensor] = ()
                 ) -> Optional[str]:
    """Why these leaves go to the plain version (they are off the card), or
    None when the kernel takes them. ``params``, ``m`` and ``v``, when given,
    hold each leaf of ``grads`` in the same order. Leaves on the card that
    the kernel has no instance for raise."""
    if not grads:
        return "no leaves"
    groups = (grads, params, m, v)
    tensors = [*grads, *params, *m, *v]
    wide = max((t.device_mesh.size() for t in tensors if is_dtensor(t)), default=0)
    if wide:
        groups = tuple([local(t) for t in group] for group in groups)
        tensors = [t for group in groups for t in group]
    # each check one pass of cheap attributes: the host runs this every step
    if not all([t.is_cuda for t in tensors]):
        kinds = sorted({t.device.type for t in tensors})
        if "cuda" not in kinds:
            return f"{kinds[0]} tensors"
        raise ValueError(f"AdamW's leaves lie on more than one device ({kinds})")
    device = tensors[0].get_device()
    if not all([t.get_device() == device for t in tensors]):
        raise ValueError("AdamW's leaves lie on more than one card")
    if wide > 1:
        raise ValueError(f"AdamW's kernel takes DTensors of a one-device mesh, not of {wide} "
                         "devices: its norm would cover this device's shards only")
    if not all([t.is_contiguous() for t in tensors]):
        raise ValueError("AdamW's kernel takes contiguous leaves")
    if not all([t.dtype in DTYPES for t in (*groups[0], *groups[1])]):
        raise TypeError("AdamW's kernel takes bf16 or f32 gradients and parameters, not "
                        f"{sorted({str(t.dtype) for t in (*groups[0], *groups[1])})}")
    if not all([t.dtype == torch.float32 for t in (*groups[2], *groups[3])]):
        raise TypeError("AdamW's kernel takes f32 moments")
    sizes = [g.numel() for g in groups[0]]
    for group in groups[1:]:
        if group and sizes != [t.numel() for t in group]:
            raise ValueError("AdamW's leaves differ in size from their gradients")
    return None


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this device; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


@dataclass(frozen=True)
class Plan:
    """What a set of leaf shapes and dtypes fixes: the kernel's meta (L, 3)
    and chunk_leaf (C,) on the device, and the grids."""
    meta: torch.Tensor
    chunk_leaf: torch.Tensor
    n_chunks: int
    norm_blocks: int
    update_blocks: int


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on the device through pinned memory, without a host sync."""
    host = torch.from_numpy(a).pin_memory()
    return host.to(device, non_blocking=True)


@functools.lru_cache(maxsize=8)
def plan(device: torch.device, key: Tuple[Tuple[torch.Size, torch.dtype, torch.dtype], ...]
         ) -> Plan:
    """The plan of leaves ``key`` ((shape, gradient dtype, parameter dtype)
    each) on ``device``."""
    meta = np.zeros((len(key), 3), np.int64)
    owners = []
    first = 0
    for i, (shape, g_dtype, p_dtype) in enumerate(key):
        chunks = -(-math.prod(shape) // CHUNK)
        flags = ((DECAY if len(shape) >= 2 else 0) | (GRAD_F32 if g_dtype == torch.float32 else 0)
                 | (PARAM_F32 if p_dtype == torch.float32 else 0))
        meta[i] = (math.prod(shape), first, flags)
        owners.append(np.full(chunks, i, np.int32))
        first += chunks
    sms = sm_count(device)
    return Plan(_upload(meta.reshape(-1), device), _upload(np.concatenate(owners), device),
                first, min(first, NORM_BLOCKS_PER_SM * sms),
                min(first, UPDATE_BLOCKS_PER_SM * sms))


def address_table(device: torch.device, *groups: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves' addresses, (L, 6) int64 rows of g, p, m, v, m', v' (0
    where a group is absent), on the device through pinned memory."""
    rows = np.zeros((len(groups[0]), 6), np.int64)
    for j, group in enumerate(groups):
        if group:
            rows[:, j] = [t.data_ptr() for t in group]
    return _upload(rows.reshape(-1), device)


def plan_of(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> Plan:
    """The plan of these leaves, built once per set of shapes and dtypes."""
    return plan(grads[0].device,
                tuple((p.shape, g.dtype, p.dtype) for g, p in zip(grads, params)))


def adamw_fused(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], *, lr: float,
                bc1: float, bc2: float, b1: float, b2: float, eps: float,
                weight_decay: float, max_norm: float
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """One AdamW step of every leaf in two launches: the gradients clipped to
    a global norm of ``max_norm``, ``params`` updated in place. Returns (new
    m, new v, the norm as a device scalar). The leaves must be plain tensors
    that ``plain_reason`` passes."""
    device = grads[0].device
    m_out = [torch.empty_like(t) for t in m]
    v_out = [torch.empty_like(t) for t in v]
    pl = plan_of(grads, params)
    gn = torch.empty((), dtype=torch.float32, device=device)
    launch_fused(pl, address_table(device, grads, params, m, v, m_out, v_out),
                 torch.empty(pl.norm_blocks, dtype=torch.float64, device=device), gn,
                 lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 max_norm=max_norm)
    return m_out, v_out, gn


def launch_fused(pl: Plan, table: torch.Tensor, partials: torch.Tensor, gn: torch.Tensor, *,
                 lr: float, bc1: float, bc2: float, b1: float, b2: float, eps: float,
                 weight_decay: float, max_norm: float) -> None:
    """``adamw_fused``'s two launches on buffers already allocated: the leaves'
    addresses ``table`` (``address_table``), the norm's ``pl.norm_blocks`` f64
    partials and the norm."""
    global launches
    f = np.float32
    rc = _lib().adamw_fused(
        pl.meta.data_ptr(), table.data_ptr(), pl.chunk_leaf.data_ptr(), pl.n_chunks,
        pl.norm_blocks, pl.update_blocks, partials.data_ptr(), gn.data_ptr(), max_norm,
        b1, 1 - b1, b2, 1 - b2,
        # the plain version's m / bc1 on the card: m times the f32 reciprocal
        float(f(1) / f(bc1)), float(f(1) / f(bc2)), eps, weight_decay, lr,
        torch.cuda.current_stream(gn.device).cuda_stream)
    _build.check(rc, "adamw_fused")
    launches += 2


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    lib.adamw_fused.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 10
                                + [ctypes.c_void_p])
    lib.adamw_fused.restype = ctypes.c_int
    return lib
