"""Host-side planner + wrapper for paged decode attention.

``plan_blocks`` is the merge queue of the kernel tier: page lists →
contiguous runs → block descriptors of at most R pages (a copy of the
reference's planner). ``paged_attention`` is the entry point: on a CUDA
tensor it launches ``csrc/paged_attention.cu`` and adds one to
``launches``; on a CPU tensor it runs ``paged_attention_plain``, which
computes the kernel's function from the same descriptors in plain torch.

The kernel copies K/V in stages of ``STAGE_BYTES``, splits each
sequence's descriptors over S CTAs (flash-decoding), and lets a CTA cover
1, 2 or 4 neighbouring KV heads when one head's run is smaller than a
stage. All of it comes from what the host knows without asking the
device: ``count_live_blocks`` on the numpy plan and lengths, and
``launch_shape`` and ``box_tokens`` over the shapes and the SM count.

On meta tensors the call goes through the custom op
``repro_torch::paged_attention`` (``kernels/__init__.py``): the output's
shape, and the kernel's own count for ``live_blocks`` descriptors a
sequence (the host's count; every sequence at that length).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ...distributed.sharding import refuse_dtensor
from ...memory.kv_cache import plan_page_runs
from .. import _build, meta_only, register_bytes

NEG_INF = -1e30
MAX_GROUP = 8                       # query heads per KV head the kernel takes
HEAD_DIMS = (32, 64, 128)
CTAS_PER_SM = 2                     # a long context's splits fill the card this deep
MIN_BLOCKS_PER_SPLIT = 4            # descriptors a split needs to fill the copy ring
HEADS_PER_CTA = (4, 2, 1)           # KV heads one CTA may cover, widest first
STAGE_BYTES = 16 * 1024             # one copy a stage: a 4-page run of bf16 D=64 K/V
MAX_BOX_TOKENS = 256                # TMA's limit on a box extent

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


def live_descriptors(block_valid: np.ndarray, lengths: np.ndarray,
                     page_tokens: int) -> np.ndarray:
    """(B,) descriptors each sequence needs: those with valid pages that
    start before its length (host arrays, so no device round trip)."""
    valid = np.asarray(block_valid, np.int64)
    before = (valid.cumsum(1) - valid) * page_tokens
    live = (valid > 0) & (before < np.asarray(lengths, np.int64)[:, None])
    return live.sum(1)


def count_live_blocks(block_valid: np.ndarray, lengths: np.ndarray,
                      page_tokens: int) -> int:
    """The most descriptors any sequence needs (``live_descriptors``)."""
    return int(live_descriptors(block_valid, lengths, page_tokens).max(initial=0))


def split_count(ctas: int, live_blocks: int, sm_count: int) -> int:
    """How many splits share each of ``ctas`` (sequence, head group) pairs:
    enough for ``CTAS_PER_SM`` CTAs on every SM, but at least
    ``MIN_BLOCKS_PER_SPLIT`` live descriptors each, so a short context keeps
    one CTA (no combine launch) and no split is ever planned without a live
    descriptor."""
    want = -(-CTAS_PER_SM * sm_count // max(ctas, 1))
    S = max(1, min(want, live_blocks // MIN_BLOCKS_PER_SPLIT))
    per = -(-live_blocks // S) if live_blocks else 1
    return max(1, -(-live_blocks // per))   # the kernel's per; no trailing empty split


def box_tokens(run_tokens: int, row_bytes: int) -> int:
    """Tokens one stage (one TMA box) holds, for rows of ``row_bytes`` (K and
    V of the CTA's heads): the whole run when it fits ``STAGE_BYTES``, else
    the run cut into the fewest equal pieces that fit."""
    k = 1
    while True:
        c = -(-run_tokens // k)
        if c <= MAX_BOX_TOKENS and c * row_bytes <= STAGE_BYTES or c == 1:
            return c
        k += 1


def launch_shape(batch: int, kv_heads: int, live_blocks: int, sm_count: int,
                 run_bytes: int) -> Tuple[int, int]:
    """(KV heads a CTA, splits S). One head a CTA copies one R-page run of
    its K and V (``run_bytes``) a stage; when a run is smaller than a stage
    (short pages, R = 1 or a fragmented table) the widest head group whose
    runs still fit a stage and whose splits still give every SM a CTA
    copies the group's rows side by side instead, so each copy stays a
    stage long."""
    for heads in HEADS_PER_CTA:
        if kv_heads % heads or (heads > 1 and heads * run_bytes > STAGE_BYTES):
            continue
        ctas = batch * kv_heads // heads
        S = split_count(ctas, live_blocks, sm_count)
        if heads == 1 or ctas * S >= sm_count:
            return heads, S
    raise AssertionError("unreachable: one head a CTA always fits")


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
                    plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    live_blocks: Optional[int] = None,
                    splits: Optional[int] = None,
                    heads_per_cta: Optional[int] = None) -> torch.Tensor:
    """Decode attention of one query token per sequence over a paged pool.

    ``plan`` is a precomputed ``(block_start, block_valid)`` pair of int32
    (B, NB) tensors on q's device; without it the table is planned here.
    ``live_blocks`` is the host's bound on the descriptors any sequence
    needs (``count_live_blocks``); it only balances the kernel's splits,
    and without it the plan's own count (or NB) stands in. ``splits`` and
    ``heads_per_cta`` fix what ``launch_shape`` would choose.
    """
    refuse_dtensor("paged_attention", q, kv_pages, lengths)
    if plan is None:
        starts, valid = plan_blocks(np.asarray(page_table), pages_per_block)
        if live_blocks is None:     # lengths stay on the device: count every valid one
            live_blocks = int((valid > 0).sum(1).max(initial=0))
        both = torch.from_numpy(np.stack([starts, valid])).to(q.device)
        plan = both[0], both[1]
    block_start, block_valid = plan
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pages, block_start, block_valid,
                                     lengths, pages_per_block=pages_per_block)
    if q.device.type == "meta":
        return torch.ops.repro_torch.paged_attention(
            q, kv_pages, block_start, block_valid, lengths, pages_per_block,
            block_start.shape[1] if live_blocks is None else live_blocks)
    if torch.is_grad_enabled() and (q.requires_grad or kv_pages.requires_grad):
        raise NotImplementedError(
            "paged_attention is decode-only and has no backward kernel: it takes no "
            "input that requires a gradient on the card (training goes through "
            "flash attention)")
    if live_blocks is None:
        live_blocks = block_start.shape[1]
    return _launch(q, kv_pages, block_start, block_valid, lengths,
                   pages_per_block, live_blocks, splits, heads_per_cta)


def paged_tokens(q_shape, kv_shape, block_shape, pages_per_block: int,
                 live_blocks: int) -> int:
    """K/V tokens the kernel reads: ``live_blocks`` descriptors of R pages
    for each of the B sequences."""
    return q_shape[0] * min(live_blocks, block_shape[1]) * pages_per_block * kv_shape[1]


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def _paged_op(q: torch.Tensor, kv_pages: torch.Tensor, block_start: torch.Tensor,
              block_valid: torch.Tensor, lengths: torch.Tensor, pages_per_block: int,
              live_blocks: int) -> torch.Tensor:
    """``paged_attention`` on a planned table: meta tensors only (its fake)."""
    raise meta_only("paged_attention")


@_paged_op.register_fake
def _(q, kv_pages, block_start, block_valid, lengths, pages_per_block, live_blocks):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.paged_attention)
def _(q, kv, starts, valid, lengths, pages_per_block, live_blocks, *args,
      out_shape=None, **kw) -> int:
    """q·K and P·V, 2·D each a query head and token read."""
    B, H, D = q
    return 4 * D * H * paged_tokens(q, kv, starts, pages_per_block, live_blocks)


@register_bytes(torch.ops.repro_torch.paged_attention)
def _(q, kv, starts, valid, lengths, pages_per_block, live_blocks, *, result) -> int:
    """q read and the output written, each token's K and V read once, the
    descriptors and lengths read."""
    _, _, _, Kh, D = kv.shape
    tokens = paged_tokens(q.shape, kv.shape, starts.shape, pages_per_block, live_blocks)
    return ((2 * q.numel() + tokens * 2 * Kh * D) * q.element_size()
            + (starts.numel() + valid.numel() + lengths.numel()) * 4)


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, kv_pages, block_start, block_valid, lengths, pages_per_block,
            live_blocks, splits, heads_per_cta) -> torch.Tensor:
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
    if q.data_ptr() % 16 or kv_pages.data_ptr() % 16:
        raise ValueError("paged_attention needs q and the pool 16-byte aligned "
                         "(16-byte vector loads and the TMA copies)")
    live = max(1, min(int(live_blocks), NB))
    row_bytes = 2 * D * q.element_size()                    # K and V of one head
    heads, S = launch_shape(B, Kh, live, sm_count(q.device),
                            pages_per_block * T * row_bytes)
    heads, S = heads_per_cta or heads, splits or S
    if not 1 <= S <= NB or heads not in HEADS_PER_CTA or Kh % heads:
        raise ValueError(f"paged_attention: splits must be in [1, {NB}] and heads_per_cta "
                         f"in {HEADS_PER_CTA} dividing Kh = {Kh}, got {S} and {heads}")
    out = torch.empty_like(q)
    partial = (torch.empty(B * Kh * S * (H // Kh) * (D + 2), dtype=torch.float32,
                           device=q.device) if S > 1 else None)
    lib = _lib()
    rc = lib.paged_attention_fwd(
        q.data_ptr(), kv_pages.data_ptr(), block_start.data_ptr(),
        block_valid.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        B, H, Kh, D, T, P, NB, box_tokens(pages_per_block * T, heads * row_bytes),
        live, heads, S,
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention_fwd")
    launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    lib.paged_attention_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                                        + [ctypes.c_void_p])
    lib.paged_attention_fwd.restype = ctypes.c_int
    return lib
