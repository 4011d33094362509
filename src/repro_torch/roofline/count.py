"""Count one device's FLOPs, bytes and collective bytes of a step, on meta.

The port's stand-in for ``repro/roofline/hlo_parse.py``, which walks XLA's
optimized HLO: torch has no HLO, so ``Counter`` is a ``TorchDispatchMode``
that sees every aten op and kernel op the step runs on this device.

- A DTensor op is handed on (the mode returns ``NotImplemented``): DTensor
  computes the sharding, redistributes and runs the local op on this
  device's shards, and that local op comes back through the mode and is
  counted. So every count is one device's, as the reference's per-device
  HLO counts are; FLOPs of the global op are never counted. DTensor's own
  shape propagation (ops on fake tensors) is not counted either.
- FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry), which include the kernels' own registered formulas. FLOPs of
  ops on f32 operands are kept apart (``f32_flops``): their peak is 3×TF32's.
- Bytes, the unfused rule: each op's input and output tensors, as if every
  op read its inputs from and wrote its outputs to HBM. Views move nothing.
  A gather (``embedding``, ``index``, ``index_select``, ``gather``) reads
  what it writes (its output, twice) plus its indices; an indexed write
  (``index_put_``, ``scatter``, ``index_add_``, ``index_copy_``) reads and
  writes its values plus its indices; ``copy_`` reads and writes its source;
  any other in-place op reads its arguments and writes the one it mutates;
  ``empty`` allocates nothing. A kernel op moves what its ``BYTES`` formula
  says (``kernels/__init__.py``). Unfused, the count overcounts chains of
  elementwise ops that a fused program keeps in registers, so
  ``roofline.analysis`` reports it beside a minimum-bytes term and never
  clips it.
- Collectives: the functional collectives DTensor issues on this device's
  shards, the bytes of their outputs by the reference's categories;
  ``CommDebugMode`` counts the same calls, and ``Counts.comm_calls`` keeps
  its count beside ours.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import BYTES

aten = torch.ops.aten

_GATHERS = {aten.embedding, aten.index, aten.index_select, aten.gather}
_INDEXED_WRITES = {aten.index_put_, aten.index_put, aten._index_put_impl_, aten.scatter_,
                   aten.scatter, aten.scatter_add_, aten.scatter_add, aten.index_add_,
                   aten.index_add, aten.index_copy_, aten.index_copy}
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
             aten.new_empty_strided}
# functional collective → the reference's category
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all", "broadcast": "collective-permute"}
CATEGORIES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")


@dataclass
class Counts:
    """One device's counts of a step."""

    flops: float = 0.0                  # every op's, kernels' included
    f32_flops: float = 0.0              # of which on f32 operands
    bytes: float = 0.0                  # the unfused rule (module docstring)
    coll_bytes: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(CATEGORIES, 0))
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)  # name → calls, flops, bytes
    comm_calls: Dict[str, int] = field(default_factory=dict)     # CommDebugMode's count by op
    flops_by_op: Dict[str, float] = field(default_factory=dict)  # op name → FLOPs
    ops: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _in_propagation(args, kwargs) -> bool:
    """DTensor's sharding propagation runs the global op on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(a, FakeTensor) for a in tree_flatten((args, kwargs))[0])


class Counter(TorchDispatchMode):
    """Counts every op this device runs while the mode is on (module docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.counts = Counts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _in_propagation(args, kwargs):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c, packet = self.counts, func.overloadpacket
        c.ops += 1
        ns = func.namespace
        if ns == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            c.coll_bytes[_COLLECTIVES[packet.__name__]] += sum(
                _nbytes(t) for t in tree_flatten(out)[0])
            return
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += flops
            c.flops_by_op[packet.__name__] = c.flops_by_op.get(packet.__name__, 0) + flops
            first = next((t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)
                          and t.is_floating_point()), None)
            if first is not None and first.dtype == torch.float32:
                c.f32_flops += flops
        nbytes = self._bytes(func, packet, args, kwargs, out)
        c.bytes += nbytes
        if ns == "repro_torch":
            k = c.kernels.setdefault(packet.__name__, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes

    @staticmethod
    def _bytes(func, packet, args, kwargs, out) -> int:
        if packet in BYTES:
            return BYTES[packet](*args, result=out, **kwargs)
        if packet in _NO_BYTES:
            return 0
        schema = func._schema
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return 0                                               # a view
        tensors = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if packet in _GATHERS:
            idx = sum(_nbytes(t) for t in tensors[1:] if not t.is_floating_point())
            return 2 * sum(_nbytes(t) for t in outs) + idx
        written = [a for a, arg in zip(args, schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write
                   and isinstance(a, torch.Tensor)]
        if packet in _INDEXED_WRITES:
            rest = [t for t in tensors if all(t is not w for w in written)]
            values = max((_nbytes(t) for t in rest if t.is_floating_point()), default=0)
            return 2 * values + sum(_nbytes(t) for t in rest if not t.is_floating_point())
        if packet is aten.copy_:
            return 2 * _nbytes(args[1])
        if written:
            return sum(_nbytes(t) for t in tensors) + sum(_nbytes(t) for t in written)
        return sum(_nbytes(t) for t in tensors) + sum(_nbytes(t) for t in outs)


def count(fn, *args, **kwargs) -> Tuple[Counts, Any]:
    """(one device's ``Counts`` of ``fn(*args, **kwargs)``, its result);
    collectives counted by ``CommDebugMode`` too."""
    from torch.distributed.tensor.debug import CommDebugMode
    counter = Counter()
    with CommDebugMode() as comm, counter:
        out = fn(*args, **kwargs)
    counter.counts.comm_calls = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    return counter.counts, out


def min_bytes(tensors) -> int:
    """Bytes a step must move at least: each tensor given (this device's
    shards) once."""
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t) for t in tensors)
