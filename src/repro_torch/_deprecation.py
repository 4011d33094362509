"""One-shot deprecation warnings for the legacy entrypoints.

The old surfaces (``MemoryCluster``, legacy ``RDMABox(directory, peers)``,
direct ``RemotePagingSystem``/``OffloadManager``/``PagedKVCache``
construction) keep working as thin shims over ``repro_torch.box``, but each
warns exactly once per process so migration pressure exists without log
spam. ``repro_torch.box`` internals construct subclasses flagged
``_box_internal`` and never warn.
"""

from __future__ import annotations

import threading
import warnings

_warned: set = set()
_lock = threading.Lock()


def warn_once(key: str, message: str, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning`` for ``key`` once per process."""
    with _lock:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset(key: str) -> None:
    """Forget that ``key`` warned (test hook)."""
    with _lock:
        _warned.discard(key)
