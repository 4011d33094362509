"""repro_torch.box — the public user-space library surface of the reproduction.

One import gives the whole workflow::

    from repro_torch import box

    spec = box.ClusterSpec(num_donors=3, replication=2, heap_pages=1024,
                           admission="congestion")
    with box.open(spec, device="cuda") as session:
        buf = session.heap().alloc(64 * box.PAGE_SIZE)   # remote memory
        buf.writev([(i, page) for i, page in enumerate(pages)]).wait()
        session.pager().swap_out(0, page, wait=True)     # replicated paging
        session.tensors().offload("opt/m", momentum)     # tensor offload
        print(session.stats(flat=True))                  # one stats tree

Layers: a declarative, JSON-round-trippable ``ClusterSpec`` consumed by
``open(spec) -> Session``; a ``Session`` facade owning lifecycle and
handing out typed capabilities (``RemoteHeap``/``RemoteBuffer``,
``Pager``, ``TensorStore``, ``KVStore``, raw ``engine()``); eight policy
registries (``admission``/``polling``/``batching``/``placement``/
``service``/``cache``/``mr``/``sla``) selected by name and extended via
``register_policy``; a typed error
hierarchy rooted at ``BoxError``; and a single composed stats tree with
``fabric.*`` / ``nic.<node>.*`` / ``client.<i>.box.*`` / ``paging.*``
namespaces. The old entrypoints (``MemoryCluster`` et al.) survive as
deprecation shims over this surface.

``open(spec, backend="model")`` swaps the threaded simulator for the
closed-form queueing-model evaluator (``ModelSession``; traffic via
``workload=ModelWorkload(...)``) — same spec, same stats namespaces,
milliseconds per topology, for capacity planning at cluster scale.

The port of ``repro.box``. Buffers are torch ``uint8`` tensors (or byte
views of any tensor): client-side buffers live on ``open``'s ``device``,
donor memory on the host, pinned when that device is CUDA. The model
backend (``repro_torch.model``) computes on the host; ``open`` checks
its ``device`` all the same, so one call fails alike on both backends.
"""

from ..core.descriptors import PAGE_SIZE
from ..core.errors import AllocError, BoxError, ClosedError
from ..core.rdmabox import (
    BatchFuture,
    BatchTransferError,
    TransferError,
    TransferFuture,
)
from ..model.session import ModelSession
from ..model.workload import ModelWorkload
from .handles import KVStore, Pager, RemoteBuffer, RemoteHeap, TensorStore
from .policies import create_policy, policy_names, register_policy
from .session import Session, open_session
from .spec import ClusterSpec, PolicySpec, SLAClass
from .stats import flatten_stats

# the factory reads naturally as repro_torch.box.open(spec)
open = open_session  # noqa: A001 - deliberate builtin shadow at module scope

__all__ = [
    "AllocError",
    "BatchFuture",
    "BatchTransferError",
    "BoxError",
    "ClosedError",
    "ClusterSpec",
    "KVStore",
    "ModelSession",
    "ModelWorkload",
    "PAGE_SIZE",
    "Pager",
    "PolicySpec",
    "RemoteBuffer",
    "RemoteHeap",
    "SLAClass",
    "Session",
    "TensorStore",
    "TransferError",
    "TransferFuture",
    "create_policy",
    "flatten_stats",
    "open",
    "policy_names",
    "register_policy",
]
