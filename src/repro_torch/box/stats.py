"""Stats-tree utilities.

Every layer of the library implements ``snapshot() -> dict``;
``Session.stats()`` composes them into one namespaced tree. This module
holds the view helpers shared by consumers (dashboards, benchmarks,
tests) that want dotted-key access instead of nested dicts.
"""

from __future__ import annotations

from typing import Any, Dict


def flatten_stats(tree: Dict[str, Any], prefix: str = "",
                  sep: str = ".") -> Dict[str, Any]:
    """Flatten a nested stats tree into dotted keys.

    ``{"nic": {"0": {"wqes_posted": 7}}}`` becomes
    ``{"nic.0.wqes_posted": 7}``. Non-empty lists/tuples expand into
    indexed keys (``{"per_worker": [{"served": 3}]}`` becomes
    ``{"per_worker.0.served": 3}``) so per-worker and per-link stats are
    addressable; empty lists and scalars stay leaves.
    """
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{sep}{key}" if prefix else str(key)
        _flatten_value(value, path, sep, out)
    return out


def _flatten_value(value: Any, path: str, sep: str,
                   out: Dict[str, Any]) -> None:
    if isinstance(value, dict):
        for key, sub in value.items():
            _flatten_value(sub, f"{path}{sep}{key}", sep, out)
    elif isinstance(value, (list, tuple)) and value:
        for i, sub in enumerate(value):
            _flatten_value(sub, f"{path}{sep}{i}", sep, out)
    else:
        out[path] = value
