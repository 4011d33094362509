"""GQA attention: prefill through the flash kernel; decode through the paged
kernel over a device pool of KV pages, or over a dense ring of the last
``window`` tokens for sliding-window archs.

Twin of ``repro/models/attention.py``. Where the reference prefills with
``flash_attention_jnp`` and decodes over a dense cache, the port calls the
two kernels that compute the same functions: ``flash_attention_op``
(prefill, with the config's window) and ``paged_attention`` (decode). On
CPU tensors both run their plain versions. The reference's windowed decode
reads its ring buffer with plain products, not a kernel; the port's
``RingKVCache`` reads it with a kernel of its own, ``ring_attention``, which
computes those products' function in f32 from the bf16 ring (the paged kernel
has no window mask).

The reference's attention knobs (``configs/optimized.py``) reach the plain
version only: ``attn_q_block``/``attn_kv_block`` (``blocks``) set its tiles,
``flash_bf16`` its operand dtype and P's rounding, ``swa_sliced_kv`` (``swa``)
its fixed key slice a query block. On a CUDA tensor the kernel launches as
it does without them, and computes the same function: it already skips the
key blocks left of a window (``swa``'s effect), its tiles are its own Hopper
design (``blocks`` sets only the plain version's), and its bf16 path always
rounds P to bf16 before P·V (``flash_bf16``'s rounding, whatever the knob
says).

A decode cache offers ``prompt_plan``/``write_prompt`` (prefill stores
the prompt's entries), ``plan_step`` (one step's indices on the device,
shared by every layer) and, for K/V caches, ``attend`` (store this step's
k/v, attend over the cache); ``SlotCache`` is the dense kind, also used for
MLA's latent cache. ``plan_step`` copies up only the step's positions and slots,
into a device buffer the cache keeps (``PlanBuffer``; a pool plans its blocks once,
a slot cache derives its mask on the device): the same addresses every step, so a
decode step can be captured once as a CUDA graph and replayed (``models/decode_graph.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (Shards, flatten, keep_grad_sharded, on_local_shards,
                                    split_last)
from ..kernels.flash_attention.ops import flash_attention_op
from ..kernels.paged_attention.ops import (count_live_blocks, live_descriptors,
                                           paged_attention, plan_blocks)
from ..kernels.ring_attention.ops import ring_attention
from ..memory.kv_cache import PageAllocator
from .layers import apply_rope, weight

NEG_INF = -1e30


class Attention(nn.Module):
    AXES = {"wq": ("embed", "q_flat"), "wk": ("embed", "kv_flat"),
            "wv": ("embed", "kv_flat"), "wo": ("q_flat", "embed"),
            "bq": ("q_flat",), "bk": ("kv_flat",), "bv": ("kv_flat",)}

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        H, Kh, D, M = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
        self.wq = weight(M, H * D, device=device)
        self.wk = weight(M, Kh * D, device=device)
        self.wv = weight(M, Kh * D, device=device)
        self.wo = weight(H * D, M, device=device)
        if cfg.qkv_bias:
            self.bq = weight(H * D, device=device)
            self.bk = weight(Kh * D, device=device)
            self.bv = weight(Kh * D, device=device)


def qkv_proj(p: Attention, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = (keep_grad_sharded(t) for t in (q, k, v))
    q = apply_rope(split_last(q, H, D), positions, cfg.rope_theta)
    k = apply_rope(split_last(k, Kh, D), positions, cfg.rope_theta)
    return q, k, split_last(v, Kh, D)


def attention_train(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over the whole sequence; returns (y, k, v)."""
    q, k, v = qkv_proj(p, x, cfg, positions)
    B, S = x.shape[:2]
    out = on_local_shards(
        lambda q, k, v: flash_attention_op(
            q, k, v, causal=True, window=cfg.window, q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block, bf16_compute=cfg.flash_bf16,
            swa_sliced_kv=cfg.swa_sliced_kv),
        (q, k, v), ((0, 2),) * 3, ((0, 2),), batch=B, heads=(cfg.num_heads, cfg.num_kv_heads))
    return flatten(out, 2, 3) @ p.wo, k, v


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@dataclass
class DecodePlan:
    """One decode step's indices on the device, shared by every layer."""

    block_start: torch.Tensor   # (B, NB) int32: first page of each block
    block_valid: torch.Tensor   # (B, NB) int32: pages in the block
    lengths: torch.Tensor       # (B,) int32: tokens once this step's is written
    slot: torch.Tensor          # (B,) int32: flat token slot of this step's k/v
    live_blocks: int            # host: most descriptors a sequence needs
    global_positions: Optional[torch.Tensor] = None   # a sharded pool: every sequence's
    most_blocks: int = 0        # host: most descriptors a sequence holds (live_blocks' cap)

    @property
    def positions(self) -> torch.Tensor:
        """(B, 1) positions of the step's tokens (RoPE)."""
        if self.global_positions is not None:
            return self.global_positions
        return (self.lengths - 1)[:, None]

    @property
    def launch_keys(self) -> range:
        """The host values the step's launches depend on (the paged kernel's
        grid and splits follow ``live_blocks``): this step's, then every one
        above it up to ``most_blocks``, which later steps meet as their
        sequences grow (a turn that restarts lower meets its own again)."""
        return range(self.live_blocks, max(self.live_blocks, self.most_blocks) + 1)

    def for_key(self, key: int) -> "DecodePlan":
        """The same buffers, launched as a step whose ``live_blocks`` is ``key``."""
        return self if key == self.live_blocks else replace(self, live_blocks=key)


def _local_rows(cur_index: np.ndarray, shards: Optional[Shards], device
                ) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """(this device's rows of the step's host positions, every sequence's
    positions (B, 1) on the device when the cache is sharded, else None)."""
    cur = np.asarray(cur_index, np.int64)
    if shards is None:
        return cur, None
    return shards.rows(cur), torch.from_numpy(cur[:, None]).to(device)


class PlanBuffer:
    """The device buffer of a step's positions (or lengths) and slots, written
    by one copy a step (``put``): at the same addresses every step.

    On the card the copy comes from ``STAGES`` pinned host buffers in turn
    and does not wait for the device, so the host plans and launches the next
    step while the device still runs this one. A host buffer is written again
    only once its last copy, ``STAGES`` steps back, has landed (its event;
    a replayed decode step has waited for that step already,
    ``models/decode_graph.py``, so the check does not hold the host). The
    device buffer is rewritten in stream order, after the kernels of the
    step before, which read it. Elsewhere (the CPU, meta tensors) the copy is
    direct."""

    STAGES = 3

    def __init__(self, numel: int, dtype: torch.dtype, device: torch.device) -> None:
        self.dev = torch.zeros(numel, dtype=dtype, device=device)
        self.staged = []
        if self.dev.device.type == "cuda":
            self.staged = [(torch.empty(numel, dtype=dtype, pin_memory=True),
                            torch.cuda.Event()) for _ in range(self.STAGES)]
        self.turn = 0

    def put(self, packed: np.ndarray) -> torch.Tensor:
        """``packed`` (the buffer's dtype and size) on the device."""
        src = torch.from_numpy(packed)
        if not self.staged:
            return self.dev.copy_(src)
        host, landed = self.staged[self.turn]
        self.turn = (self.turn + 1) % self.STAGES
        landed.synchronize()             # an event never recorded returns at once
        host.copy_(src)
        self.dev.copy_(host, non_blocking=True)
        landed.record(torch.cuda.current_stream(self.dev.device))
        return self.dev


class PagedKVPool:
    """Every layer's KV pages in one device tensor, plus the page tables.

    ``pool`` is (L, P + R − 1, T, 2, Kh, D): ``pool[l]`` is contiguous in
    the paged kernel's (P, T, 2, Kh, D) layout. The R − 1 slack pages are
    allocated once, here, for block copies that read whole R-page blocks.
    Each sequence gets all ``ceil(max_len / T)`` of its pages in one
    ``alloc`` so its pages form contiguous runs and its blocks stay full.

    With ``shards`` (a step on a mesh) the pool is this device's: its local
    sequences' pages and its KV heads, every data shard the same program.
    """

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 page_tokens: int = 16, pages_per_block: int = 4,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 shards: Optional[Shards] = None) -> None:
        if cfg.window is not None:
            raise ValueError("the paged kernel has no window mask: a "
                             "sliding-window arch decodes over a RingKVCache")
        T, R = page_tokens, pages_per_block
        per_seq = -(-max_len // T)
        self.shards = shards
        if shards is not None:
            batch = shards.local_batch
        kv_heads = (cfg.num_kv_heads if shards is None
                    else shards.local_heads(cfg.num_heads, cfg.num_kv_heads)[1])
        self.page_tokens, self.pages_per_block = T, R
        self.allocator = PageAllocator(batch * per_seq)
        self.page_table = np.array([self.allocator.alloc(per_seq)
                                    for _ in range(batch)], np.int32)
        self.page_table.flags.writeable = False     # fixed: its blocks are planned once
        self.pool = torch.zeros(
            (cfg.num_layers, self.allocator.num_pages + R - 1, T, 2,
             kv_heads, cfg.head_dim), dtype=dtype, device=device)
        starts, self._host_valid = plan_blocks(self.page_table, R)   # (B, NB) each
        self.block_start, self.block_valid = torch.from_numpy(
            np.stack([starts, self._host_valid])).to(device)
        self.most_blocks = int((self._host_valid > 0).sum(1).max(initial=0))
        self._plan = PlanBuffer(2 * batch, torch.int32, device)   # lengths, slots
        self._last_lengths: Optional[np.ndarray] = None

    @property
    def capacity(self) -> int:
        """Tokens each sequence can hold."""
        return self.page_table.shape[1] * self.page_tokens

    def snapshot(self) -> Dict[str, int]:
        """The pool's bytes on the device, and what the last ``plan_step``
        found live: its tokens, their K and V in every layer, and the block
        descriptors that hold them."""
        out = {"reserved_bytes": self.pool.nbytes, "live_tokens": 0, "live_bytes": 0,
               "live_blocks": 0}
        if self._last_lengths is not None:
            tokens = int(self._last_lengths.sum())
            token_bytes = self.pool.shape[0] * self.pool[0, 0, 0].nbytes     # L · (2, Kh, D)
            live = live_descriptors(self._host_valid, self._last_lengths, self.page_tokens)
            out.update(live_tokens=tokens, live_bytes=tokens * token_bytes,
                       live_blocks=int(live.sum()))
        return out

    def token_slots(self, positions: np.ndarray) -> np.ndarray:
        """(B, S) token positions → flat slots ``page·T + offset`` of the pool."""
        if positions.max() >= self.capacity or positions.min() < 0:
            raise IndexError(f"positions outside [0, {self.capacity})")
        T = self.page_tokens
        rows = np.arange(self.page_table.shape[0])[:, None]
        return self.page_table[rows, positions // T] * T + positions % T

    def write(self, layer: int, slots: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Store k, v (B, S, Kh, D) at ``slots`` (B, S) of one layer, in place."""
        flat = self.pool[layer].view(-1, *self.pool.shape[3:])   # (P'·T, 2, Kh, D)
        flat[slots] = torch.stack([k, v], dim=2).to(flat.dtype)

    def prompt_plan(self, batch: int, length: int) -> torch.Tensor:
        """The prompt's token slots (B, S) on the device, once for every layer
        (the pool's own sequences when it is sharded)."""
        if self.shards is not None:
            batch = self.page_table.shape[0]
        pos = np.broadcast_to(np.arange(length), (batch, length))
        return torch.from_numpy(self.token_slots(pos).astype(np.int32)).to(self.pool.device)

    write_prompt = write                 # with ``prompt_plan``'s slots

    def plan_step(self, cur_index: np.ndarray) -> DecodePlan:
        """This step's lengths and write slots, one copy up into the pool's
        plan buffer, beside the blocks planned when the pool was made (the
        same tensors every step).

        ``cur_index`` (B,) is each sequence's position of the token being
        decoded, i.e. its cached tokens so far. Each sequence holds all its
        pages from the start, so early in decode its last descriptors hold
        no live token: ``live_blocks`` counts only those that do.
        """
        cur, positions = _local_rows(cur_index, self.shards, self.pool.device)
        lengths = cur + 1
        dev = self._plan.put(np.concatenate(
            [lengths, self.token_slots(cur[:, None])[:, 0]]).astype(np.int32))
        self._last_lengths = lengths
        B = len(cur)
        return DecodePlan(self.block_start, self.block_valid, dev[:B], dev[B:],
                          count_live_blocks(self._host_valid, lengths, self.page_tokens),
                          positions, most_blocks=self.most_blocks)

    def attend(self, layer: int, plan: DecodePlan, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """q (B, H, D), k, v (B, Kh, D): writes this token's k/v into its page
        slot, then attends over ``lengths = cur + 1`` tokens (the reference's
        ``kv_pos <= cur``) through the paged kernel. Returns (B, H, D)."""
        self.write(layer, plan.slot[:, None], k[:, None], v[:, None])
        return paged_attention(q, self.pool[layer], self.page_table, plan.lengths,
                               pages_per_block=self.pages_per_block,
                               plan=(plan.block_start, plan.block_valid),
                               live_blocks=plan.live_blocks)


# ---------------------------------------------------------------------------
# dense slot caches: the sliding-window ring, MLA's latent cache
# ---------------------------------------------------------------------------

@dataclass
class SlotPlan:
    """One decode step's dense-cache indices on the device, shared by every layer."""

    positions: torch.Tensor     # (B, 1): the step's token positions (RoPE)
    slot: torch.Tensor          # (B,): where the step's entry goes
    valid: torch.Tensor         # (B, length) bool: the slots the step attends to
                                # (a sharded cache: its own sequences' slot and valid)
    launch_keys = (None,)       # no host value shapes the step's launches

    def for_key(self, key: None) -> "SlotPlan":
        """The plan itself: its one key."""
        return self


class SlotCache:
    """Dense per-layer caches of ``length`` token slots a sequence.

    ``bufs`` holds one (L, B, length, *shape) tensor per entry the cache
    keeps (K and V, or MLA's latent and rope key). Token p sits at slot
    ``p % length``, so the cache is a ring of the last ``length`` tokens,
    and a step at ``cur`` attends to the slots of age
    ``(slot − s) mod length < min(cur + 1, length)`` (the reference's
    rule), which is ``s ≤ cur`` while ``cur < length``. A cache that must
    not wrap overrides ``_check``.

    Prefill keeps the prompt's last ``length`` tokens, token p at slot
    ``p % length``. The reference keeps them at slots 0..length−1 instead
    while its decode writes token p at ``p % length``; the two agree when
    the prompt is at most ``length`` tokens or a multiple of it, and
    otherwise the reference's decode evicts the wrong token.
    """

    def __init__(self, num_layers: int, batch: int, length: int,
                 shapes: Sequence[Tuple[int, ...]], *,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 shards: Optional[Shards] = None) -> None:
        self.length = length
        self.shards = shards
        if shards is not None:
            batch = shards.local_batch
        self.bufs = [torch.zeros((num_layers, batch, length, *shape), dtype=dtype,
                                 device=device) for shape in shapes]
        self._plan = PlanBuffer(2 * batch, torch.int64, device)   # positions, slots
        self._slots = torch.arange(length, device=device)
        self._valid = torch.empty((batch, length), dtype=torch.bool, device=device)

    @property
    def device(self) -> torch.device:
        return self.bufs[0].device

    def snapshot(self) -> Dict[str, int]:
        """The cache's bytes on the device (every slot of every layer)."""
        return {"reserved_bytes": sum(buf.nbytes for buf in self.bufs)}

    def _check(self, last: int) -> None:
        """Positions up to ``last`` are about to be written; a ring takes any."""

    def prompt_plan(self, batch: int, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kept prompt positions, their slots) on the device."""
        self._check(length - 1)
        pos = torch.arange(max(0, length - self.length), length, device=self.device)
        return pos, pos % self.length

    def write_prompt(self, layer: int, plan: Tuple[torch.Tensor, torch.Tensor],
                     *values: torch.Tensor) -> None:
        """Each value (B, S, *shape) into its buffer, the kept positions only."""
        pos, slots = plan
        for buf, val in zip(self.bufs, values):
            buf[layer][:, slots] = val[:, pos].to(buf.dtype)

    def plan_step(self, cur_index: np.ndarray) -> SlotPlan:
        """The step at host positions ``cur_index`` (B,): positions and slots copied
        up at once, the mask ``age ≤ cur`` (ages are below ``length``) on the device."""
        cur, positions = _local_rows(cur_index, self.shards, self.device)
        self._check(int(cur.max()))
        B = len(cur)
        buf = self._plan.put(np.concatenate([cur, cur % self.length]))
        slot = buf[B:]
        age = (slot[:, None] - self._slots).remainder_(self.length)
        torch.le(age, buf[:B, None], out=self._valid)
        if positions is None:
            positions = buf[:B].view(B, 1)
        return SlotPlan(positions, slot, self._valid)

    def write_step(self, layer: int, plan: SlotPlan, *values: torch.Tensor) -> None:
        """Each value (B, *shape) at its sequence's step slot, in place."""
        rows = torch.arange(plan.slot.shape[0], device=self.device)
        for buf, val in zip(self.bufs, values):
            buf[layer][rows, plan.slot] = val.to(buf.dtype)


class RingKVCache(SlotCache):
    """K and V (L, B, length, Kh, D) for a sliding-window arch:
    ``length = min(max_len, window)`` slots a sequence, as the reference's
    ``init_kv_cache`` sizes them."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 shards: Optional[Shards] = None) -> None:
        kv_heads = (cfg.num_kv_heads if shards is None
                    else shards.local_heads(cfg.num_heads, cfg.num_kv_heads)[1])
        shape = (kv_heads, cfg.head_dim)
        super().__init__(cfg.num_layers, batch, min(max_len, cfg.window), (shape, shape),
                         device=device, dtype=dtype, shards=shards)

    def attend(self, layer: int, plan: SlotPlan, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """q (B, H, D), k, v (B, Kh, D): writes this token's k/v at its ring
        slot, then attends over the window in f32, as the reference's
        ``attention_decode`` does, through ``ring_attention``. Returns
        (B, H, D) in q's dtype."""
        self.write_step(layer, plan, k, v)
        kc, vc = (buf[layer] for buf in self.bufs)             # (B, length, Kh, D)
        return ring_attention(q, kc, vc, plan.valid, q.shape[-1] ** -0.5)


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     cache, layer: int, plan) -> torch.Tensor:
    """x: (B, 1, M) → (B, 1, M) through ``cache.attend`` (a ``PagedKVPool``
    with its ``DecodePlan``, or a ``RingKVCache`` with its ``SlotPlan``)."""
    B = x.shape[0]
    q, k, v = qkv_proj(p, x, cfg, plan.positions)
    out = on_local_shards(lambda q, k, v: cache.attend(layer, plan, q, k, v),
                          (q[:, 0], k[:, 0], v[:, 0]), ((0, 1),) * 3, ((0, 1),), batch=B,
                          heads=(cfg.num_heads, cfg.num_kv_heads))
    return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ p.wo
