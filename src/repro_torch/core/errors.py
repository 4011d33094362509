"""The library's typed error hierarchy.

Every failure the public ``repro_torch.box`` surface can raise is rooted at
``BoxError``, so callers write ONE except clause for "the remote-memory
library failed" and still get typed subclasses when they need to react
differently:

* ``TransferError`` / ``BatchTransferError`` (defined beside the futures
  in ``core.rdmabox``) — an RDMA transfer completed with an error status.
* ``ClosedError`` — a capability (session, heap, buffer, pager, engine)
  was used after close, or a transfer was still in flight when its engine
  closed. Waiters fail immediately instead of hitting a flush timeout.
* ``AllocError`` — remote-heap exhaustion / invalid allocation.

``BoxError`` subclasses ``RuntimeError`` so pre-existing callers that
caught ``RuntimeError`` for transfer failures keep working.
"""

from __future__ import annotations


class BoxError(RuntimeError):
    """Root of the repro_torch.box error hierarchy."""


class ClosedError(BoxError):
    """The session/engine/capability was closed (or closed mid-flight)."""


class AllocError(BoxError):
    """Remote-heap allocation failed (exhaustion or invalid request)."""
