"""Named spans at the model path's layer boundaries, for ``torch.profiler``.

``span(name)`` marks a block of the program on the profiler's timeline as
``repro_torch.<name>``, on the clock that the profiler's device activity
uses, so each kernel, copy and idle gap of a trace can be put down to the
span that launched it or was running then. The profiler is the recorder
and the exporter: wrap any entry point in ``torch.profiler.profile`` and
the spans are in its events and its Chrome trace.

With no profiler running, ``span`` returns a shared no-op context and enters
no ``RecordFunction``: ``torch.profiler.record_function`` costs ~11 µs of
host time even with nothing recording, and a decode step enters over a
hundred spans. With one running, a span is the ``RecordFunction`` that the
profiler's own op events use (``torch._C._profiler._RecordFunctionFast``),
entered and left in C++. ``record_function``'s Python path took 25–35 µs a
span there: at each layer boundary of hymba-1.5b's decode step (H100) its
three transitions held the device idle ~150 µs, against ~60 µs with this
one, in the very capture that names the device's idle gaps. Its events are
the host's, with no image on the device's timeline. Span names carry no
layer index, so a trace sums them by name.

The spans, and the spans each nests in:

- ``decode.step``: ``Transformer.decode_step``, the whole call;
- ``kv.plan``: the decode cache's ``plan_step`` (in ``decode.step``);
- ``decode.replay``: the launch of a step's CUDA graph, and
  ``decode.capture``: the capture of a new launch key's graphs (in
  ``decode.step``; ``models/decode_graph.py``). A replayed step runs no
  ``layer`` span on the host: the spans below are those of an eager step
  and of a capture;
- ``layer``: one block (in ``decode.step``, ``prefill.step``,
  ``train.forward``, or ``train.backward`` where a block is recomputed), holding ``layer.attn`` (attention or MLA, with the
  cache write), ``layer.ssm`` (the SSM, with its state write) and
  ``layer.ffn`` (the FFN's norm, MLP or MoE and residual add);
- ``moe.route`` (the router, top-k and the pairs' sort), ``moe.experts``
  (the expert products) and ``moe.combine`` (the gates and the sum back to
  each token), in ``layer.ffn`` (``models/moe.py``); ``moe.backward``, the
  dropless layer's backward (on the autograd engine's thread, in
  ``train.backward``'s interval);
- ``decode.logits``: the final norm and the head (in ``decode.step``);
- ``prefill.step``: ``Transformer.prefill``;
- ``train.forward``, ``train.backward``, ``train.optimizer``: the loss, its
  backward, and the gradients with the AdamW update (``launch.steps``).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
