"""Host-side planner + wrapper for paged decode attention.

``plan_blocks`` is the merge queue of the kernel tier: page lists →
contiguous runs → block descriptors of at most R pages (a copy of the
reference's planner). ``paged_attention`` is the entry point: on a CUDA
tensor it launches ``csrc/paged_attention.cu`` and adds one to
``launches``; on a CPU tensor it runs ``paged_attention_plain``, which
computes the kernel's function from the same descriptors in plain torch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...memory.kv_cache import plan_page_runs
from .. import _build

NEG_INF = -1e30
MAX_GROUP = 8                       # query heads per KV head the kernel takes
HEAD_DIMS = (32, 64, 128)

launches = 0                        # kernel launches since the last reset


def plan_blocks(page_table: np.ndarray, pages_per_block: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, Pmax) page table (−1 padded) → (block_start, block_valid).

    Runs are chopped into blocks of ≤ R pages, in sequence order. The
    number of descriptors per sequence is NB = ceil(Pmax / R) at worst;
    contiguity makes most blocks carry R valid pages.
    """
    B, Pmax = page_table.shape
    R = pages_per_block
    NB = Pmax                     # worst case: fully fragmented, 1 page/block
    starts = np.zeros((B, NB), np.int32)
    valid = np.zeros((B, NB), np.int32)
    for b in range(B):
        pages = [int(p) for p in page_table[b] if p >= 0]
        blocks = []
        for run in plan_page_runs(pages):
            s, n = run.start, run.length
            while n > 0:
                take = min(n, R)
                blocks.append((s, take))
                s += take
                n -= take
        for i, (s, n) in enumerate(blocks):
            starts[b, i] = s
            valid[b, i] = n
    return starts, valid


def descriptor_stats(page_table: np.ndarray, pages_per_block: int) -> dict:
    """How many block descriptors the planner emits vs per-page baseline."""
    _, valid = plan_blocks(page_table, pages_per_block)
    pages = int((page_table >= 0).sum())
    descs = int((valid > 0).sum())
    return {"pages": pages, "descriptors": descs,
            "reduction": pages / max(descs, 1)}


def paged_attention_plain(q: torch.Tensor, kv_pages: torch.Tensor,
                          block_start: torch.Tensor, block_valid: torch.Tensor,
                          lengths: torch.Tensor, *, pages_per_block: int
                          ) -> torch.Tensor:
    """The kernel's function in plain torch, float32 inside.

    Block i of sequence b covers pages ``block_start[b,i] + [0, valid)``
    and tokens from ``T·Σ_{j<i} valid[b,j]`` on; a token counts if it lies
    in a valid page and before ``lengths[b]`` (the kernel's cumulative mask).
    """
    B, H, D = q.shape
    P, T, _, Kh, _ = kv_pages.shape
    R, G = pages_per_block, H // Kh
    tok = torch.arange(R * T, device=q.device)
    valid = block_valid.long()
    base = (valid.cumsum(1) - valid) * T                       # (B, NB)
    live = (tok < valid[..., None] * T) & (
        base[..., None] + tok < lengths.long()[:, None, None])  # (B, NB, R·T)
    pages = (block_start.long()[..., None] + tok // T).clamp(max=P - 1)
    kv = kv_pages[pages, tok % T].float()                      # (B, NB, R·T, 2, Kh, D)
    k = kv[:, :, :, 0].reshape(B, -1, Kh, D)
    v = kv[:, :, :, 1].reshape(B, -1, Kh, D)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, Kh, G, D).float(), k)
    s = torch.where(live.reshape(B, 1, 1, -1), s * D ** -0.5, NEG_INF)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v)
    return out.reshape(B, H, D).to(q.dtype)


def upload_plan(page_table: np.ndarray, pages_per_block: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan on the host and copy (block_start, block_valid) to ``device``."""
    starts, valid = plan_blocks(page_table, pages_per_block)
    both = torch.from_numpy(np.stack([starts, valid])).to(device)
    return both[0], both[1]


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                    page_table: np.ndarray, lengths: torch.Tensor,
                    *, pages_per_block: int = 4,
                    plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Decode attention of one query token per sequence over a paged pool.

    ``plan`` is a precomputed ``(block_start, block_valid)`` pair of int32
    (B, NB) tensors on q's device; without it the table is planned here.
    """
    if plan is None:
        plan = upload_plan(np.asarray(page_table), pages_per_block, q.device)
    block_start, block_valid = plan
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pages, block_start, block_valid,
                                     lengths, pages_per_block=pages_per_block)
    return _launch(q, kv_pages, block_start, block_valid, lengths)


def _launch(q, kv_pages, block_start, block_valid, lengths) -> torch.Tensor:
    global launches
    B, H, D = q.shape
    P, T, two, Kh, Dk = kv_pages.shape
    NB = block_start.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16) or kv_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention takes f32 or bf16 q and pool of one "
                        f"dtype, got {q.dtype} and {kv_pages.dtype}")
    if two != 2 or Dk != D or H % Kh or H // Kh > MAX_GROUP or D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: unsupported shapes q {tuple(q.shape)}, "
                         f"kv_pages {tuple(kv_pages.shape)} (D in {HEAD_DIMS}, "
                         f"H/Kh ≤ {MAX_GROUP})")
    for name, t, shape in (("block_start", block_start, (B, NB)),
                           ("block_valid", block_valid, (B, NB)),
                           ("lengths", lengths, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = (q, kv_pages, block_start, block_valid, lengths)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention takes contiguous tensors on one device")
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.paged_attention_fwd(
        q.data_ptr(), kv_pages.data_ptr(), block_start.data_ptr(),
        block_valid.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, Kh, D, T, NB, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention_fwd")
    launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    lib.paged_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.paged_attention_fwd.restype = ctypes.c_int
    return lib
