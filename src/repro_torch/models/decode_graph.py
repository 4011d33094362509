"""Decode steps replayed as CUDA graphs, one graph per launch shape.

A decode step is some thousands of small kernels (3,052 for command-r-35b at
batch 16, 4,140 for hymba-1.5b at batch 64, on an H100), each launched by
Python: the host's dispatch, not the device, sets the step's time.
``DecodeGraphs`` captures the step once as a CUDA graph and replays it with
one launch. The graph wraps the eager body itself (``Transformer``'s
``_decode_body``): the same kernels, hand-written ones included, in the
same order, on the same dtypes.

What a replay reads from the host is put in place before it: the caches'
``plan_step`` copies up the step's positions and slots (a slot cache's mask follows
on the device: ``models/attention.py``), and token ids or embeddings are copied into a
static input. The caches' state (K/V pages, the ring, the SSM's conv and h)
is updated in place by the step itself. The one host value that shapes the
launches is the paged pool's ``live_blocks``, which sets the paged kernel's
split count and grid (``kernels/paged_attention/ops.py``): graphs are keyed
by the plan's launch key (that count, or None for a ring, latent or SSM
cache) and the input's shape and dtype, and the graphs of one cache share
one memory pool. The first time a key is met its graph is captured, and with
it the graph of every key above it up to the most blocks a sequence of the
pool holds (the plan's ``launch_keys``): decode sequences grow, so those are
the keys later steps meet, and a capture (an eager step's host time and the
graph's instantiation: 0.08–0.23 s a key for command-r-35b on an H100) then
lands in set-up and not in the middle of serving, where it would stall
every sequence of the batch (and, under ``torch.profiler``, hide replays
from the trace).

Before the first capture one step runs eagerly on the capture's stream, as
``torch.cuda.graphs`` asks, so that the stream's lazily made state (cuBLAS's
workspace) exists before any capture. Each replay returns a copy of the
graph's output, so no later step overwrites the logits a caller holds.

Nothing in a replayed step waits for the device (the plan's copy is
``non_blocking``), so the host plans and launches step k + 1 while the
device runs step k, and the launch of a graph of thousands of kernels (some
milliseconds of host time) no longer leaves the device idle. The host runs
at most ``AHEAD`` replays ahead: before replaying step k it waits for step
k − ``AHEAD`` to end.

The step replays only where nothing of it depends on the host beyond the
plan and the input; ``eager_reason`` says why a step runs eagerly instead:
parameters on a mesh (DTensors, whose collectives and redistributions are
not captured), a sharded cache, autograd recording the step, or a device
that is not CUDA. Every cache kind plans into fixed buffers, and every
block's decode (GQA over the paged pool or the ring, MLA, the SSM, the MoE's
sort-based dispatch, capacity or dropless) runs without a host sync and at
shapes fixed by the batch, so no arch is kept eager for its own sake.

The hand-written kernels count their launches in their wrappers
(``kernels/*/ops.py``). A replay launches no wrapper, so the launches a
graph captured are added to those counts at each replay, and taken back
from them at the capture, which ran nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import is_dtensor
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.latent_attention import ops as latent_ops
from ..kernels.paged_attention import ops as paged_ops
from ..kernels.ring_attention import ops as ring_ops
from ..kernels.ssd_scan import ops as ssd_ops
from ..spans import span

# wrappers whose ``launches`` count kernels
COUNTED = (paged_ops, flash_ops, ssd_ops, ring_ops, latent_ops)
WARM_UP = "warm-up of the capture stream"
AHEAD = 2                  # replays the host may have queued before it waits


def eager_reason(model, parts) -> Optional[str]:
    """Why a decode step of ``model`` over the cache ``parts`` (its attention
    cache and SSM state, None where absent) runs eagerly; None when it
    replays a CUDA graph."""
    if is_dtensor(model.embed):
        return "parameters on a mesh"
    if any(part is not None and part.shards is not None for part in parts):
        return "sharded cache"
    if torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters()):
        return "autograd"
    if model.device.type != "cuda":
        return f"{model.device.type} device"
    return None


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor                  # the static output, rewritten by each replay
    launches: Tuple[int, ...]          # each ``COUNTED`` wrapper's launches in it


class DecodeGraphs:
    """A model's decode steps on one cache: the graphs by key, and how each
    step ran (``snapshot``)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.graphs: Dict[Hashable, _Graph] = {}
        self.inputs: Dict[Tuple, torch.Tensor] = {}      # static input by (shape, dtype)
        self.stream: Optional[torch.cuda.Stream] = None  # the capture stream, once warm
        self.pool = None                                 # the graphs' shared memory pool
        self.ended = []                # events after the last AHEAD replays, in turn
        self.replays = 0
        self.captures: Dict[str, int] = {}
        self.eager: Dict[str, int] = {}

    def snapshot(self) -> Dict[str, object]:
        """Steps replayed, graphs captured by launch key, and eager steps by
        reason; a step that captured its graph replays it too, so replays
        plus eager steps are all the steps."""
        return {"replays": self.replays, "captures": dict(self.captures),
                "eager": dict(self.eager)}

    def run(self, body: Callable[[torch.Tensor, Hashable], torch.Tensor],
            inp: torch.Tensor, why: Optional[str], keys: Sequence[Hashable]
            ) -> torch.Tensor:
        """``body(inp, keys[0])``, the step at its launch key: eagerly when
        ``why`` names a reason, else by replaying the graph of that key and
        the input's shape and dtype. A key met for the first time is captured
        with every key after it in ``keys`` (those later steps will meet)."""
        key = keys[0]
        if why is not None:
            _add(self.eager, why)
            return body(inp, key)
        sig = (tuple(inp.shape), inp.dtype)
        static = self.inputs.get(sig)
        if static is None:
            static = self.inputs[sig] = torch.empty(inp.shape, dtype=inp.dtype,
                                                    device=self.device)
        static.copy_(inp)
        g = self.graphs.get((key, sig))
        if g is None:
            if self.stream is None:
                return self._warm_up(lambda x: body(x, key), static)
            with span("decode.capture"):
                for k in keys:
                    if (k, sig) not in self.graphs:
                        self.graphs[(k, sig)] = self._capture(lambda x: body(x, k), static)
                        _add(self.captures, str(k))
            g = self.graphs[(key, sig)]
        ended = self.ended[self.replays % AHEAD]
        ended.synchronize()              # step k − AHEAD has ended (at once if never recorded)
        with span("decode.replay"):
            g.graph.replay()
        ended.record(torch.cuda.current_stream(self.device))
        for wrapper, n in zip(COUNTED, g.launches):
            wrapper.launches += n
        self.replays += 1
        return g.out.clone()

    def _warm_up(self, body, static: torch.Tensor) -> torch.Tensor:
        """The step itself, run eagerly on the new capture stream."""
        here = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.ended = [torch.cuda.Event() for _ in range(AHEAD)]
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = body(static)
        here.wait_stream(self.stream)
        out.record_stream(here)
        _add(self.eager, WARM_UP)
        return out

    def _capture(self, body, static: torch.Tensor) -> _Graph:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = [w.launches for w in COUNTED]
        with torch.cuda.stream(self.stream):
            # thread_local: another thread's CUDA calls (a kv_store's copies) go on
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = body(static)
            finally:
                graph.capture_end()
        launches = tuple(w.launches - b for w, b in zip(COUNTED, before))
        for wrapper, n in zip(COUNTED, launches):     # captured, not run
            wrapper.launches -= n
        return _Graph(graph, out, launches)


def _add(counts: Dict[str, int], key: str) -> None:
    counts[key] = counts.get(key, 0) + 1
