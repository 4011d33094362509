"""Tensor offload manager: optimizer state / activations → remote memory.

The training-side consumer of the RDMAbox engine. Tensors are flattened to
page-granular buffers, swapped out through the remote paging system
(replicated, admission-window-paced, merge-coalesced), and prefetched back
ahead of use. A slow donor delays only its own window slots (straggler
mitigation by backpressure + first-responder replica reads). A tensor of
any dtype travels as a view of its bytes and comes back with its dtype
and shape, on the engine's device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from .._deprecation import warn_once
from ..core.buffers import byte_view
from ..core.descriptors import PAGE_SIZE
from ..core.paging import RemotePagingSystem

PyTree = Any


@dataclass
class OffloadConfig:
    """Degraded-mode knobs for the offload tier.

    ``acked_writes`` routes swap-outs through the paging layer's
    acknowledged path: replica failures are struck (feeding donor
    eviction) and a page whose every replica write fails is persisted to
    disk instead of being silently lost. ``fetch_timeout`` bounds how
    long a fetch waits on any single replica before failing over.
    ``fetch_parallel`` posts every page's read before waiting on any of
    them, so the merge queue sees the whole burst (the swap-in mirror of
    the bulk swap-out path); pages whose prefetch errors or times out
    fall back to the serial failover read.
    """

    acked_writes: bool = False
    write_timeout: float = 30.0
    fetch_timeout: float = 10.0
    fetch_parallel: bool = False


class OffloadManager:
    def __init__(self, paging: RemotePagingSystem,
                 config: Optional[OffloadConfig] = None) -> None:
        if not getattr(self, "_box_internal", False):
            warn_once(
                "OffloadManager",
                "constructing OffloadManager directly is deprecated; use "
                "repro_torch.box.open(spec).tensors()")
        self.paging = paging
        self.cfg = config or OffloadConfig()
        self._meta: Dict[str, Dict] = {}
        self._next_page = 0
        self._lock = threading.Lock()
        self._inflight: Dict[str, List] = {}

    def _pages_for(self, nbytes: int) -> int:
        return -(-nbytes // PAGE_SIZE)

    # ---- swap out ----------------------------------------------------------
    def offload(self, name: str, array: torch.Tensor,
                wait: bool = False) -> None:
        """Write a tensor to remote memory (page-granular, replicated)."""
        raw = byte_view(array).reshape(-1)
        shape, dtype = tuple(array.shape), array.dtype
        n_pages = self._pages_for(raw.nbytes)
        with self._lock:
            meta = self._meta.get(name)
            if meta is None or meta["n_pages"] < n_pages:
                meta = {"base": self._next_page, "n_pages": n_pages,
                        "shape": shape, "dtype": dtype,
                        "nbytes": raw.nbytes}
                self._next_page += n_pages
                self._meta[name] = meta
            else:
                meta.update(shape=shape, dtype=dtype, nbytes=raw.nbytes)
        pad = n_pages * PAGE_SIZE - raw.nbytes
        if pad:
            raw = torch.cat([raw, raw.new_zeros(pad)])
        # every path rides the batched hot path: the tensor's whole page
        # vector posts per donor as one write_pages run (single submit-lock
        # acquisition, one BatchFuture per donor instead of
        # pages x replicas futures)
        items = [(meta["base"] + i, raw[i * PAGE_SIZE:(i + 1) * PAGE_SIZE])
                 for i in range(n_pages)]
        if wait and self.cfg.acked_writes:
            # acked path: per-replica outcomes (strikes, stale marks, disk
            # persistence) resolve after the whole burst has posted
            self.paging.swap_out_batch(items, timeout=self.cfg.write_timeout)
            return
        futs = self.paging.swap_out_batch(items, wait=False)
        if wait:
            for f in futs:
                f.wait(self.cfg.write_timeout)
        else:
            self._inflight[name] = futs

    def flush(self) -> None:
        for futs in self._inflight.values():
            for f in futs:
                f.wait()
        self._inflight.clear()

    # ---- swap in ----------------------------------------------------------
    def fetch(self, name: str) -> torch.Tensor:
        meta = self._meta[name]
        n_pages = meta["n_pages"]
        buf = torch.empty(n_pages * PAGE_SIZE, dtype=torch.uint8,
                          device=self.paging.box.device)
        if self.cfg.fetch_parallel:
            self._fetch_burst(meta["base"], n_pages, buf)
        else:
            for i in range(n_pages):
                buf[i * PAGE_SIZE:(i + 1) * PAGE_SIZE].copy_(
                    self.paging.swap_in(meta["base"] + i,
                                        timeout=self.cfg.fetch_timeout))
        raw = buf[: meta["nbytes"]]
        return raw.view(meta["dtype"]).reshape(meta["shape"]).clone()

    def _fetch_burst(self, base: int, n_pages: int,
                     buf: torch.Tensor) -> None:
        """Post the whole page vector as one batched prefetch (one
        read_pages run per donor, donor copies land straight in ``buf``'s
        views), then resolve; any page whose prefetch fails — error, no
        live replica, or timeout — takes the replica-failover read."""
        items = [(base + i, buf[i * PAGE_SIZE:(i + 1) * PAGE_SIZE])
                 for i in range(n_pages)]
        batch = self.paging.prefetch_batch(items)
        for i, ok in enumerate(batch.resolve(timeout=self.cfg.fetch_timeout)):
            if not ok:
                items[i][1].copy_(self.paging.swap_in(
                    base + i, timeout=self.cfg.fetch_timeout))

    # ---- pytree convenience --------------------------------------------------
    def offload_tree(self, prefix: str, tree: PyTree, wait: bool = True) -> None:
        leaves, _ = pytree.tree_flatten(tree)
        for i, leaf in enumerate(leaves):
            self.offload(f"{prefix}/{i}", torch.as_tensor(leaf), wait=False)
        if wait:
            self.flush()

    def fetch_tree(self, prefix: str, like: PyTree) -> PyTree:
        leaves, spec = pytree.tree_flatten(like)
        out = [self.fetch(f"{prefix}/{i}") for i in range(len(leaves))]
        return pytree.tree_unflatten(out, spec)
