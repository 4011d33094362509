"""repro_torch.fabric — the multi-node fabric: per-node simulated NICs joined by
an explicit link model, with first-class fault injection (donor crash,
stragglers, transient WC errors, congestion)."""

from ..core.nic import ServiceConfig
from .fabric import Fabric
from .faults import FaultEvent, FaultKind, FaultPlan, FaultState
from .link import DelayLine, Link, LinkConfig

__all__ = [
    "Fabric", "FaultEvent", "FaultKind", "FaultPlan", "FaultState",
    "DelayLine", "Link", "LinkConfig", "ServiceConfig",
]
