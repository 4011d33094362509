"""repro_torch.core — RDMAbox's contribution: load-aware batching, admission
control, adaptive polling, and the node-level remote-memory abstraction.

The supported public surface is ``repro_torch.box`` (declarative ClusterSpec →
Session → capability handles); this package is the engine underneath it.
"""

from .admission import AdmissionController, AdmissionHook, CongestionAwareHook
from .batching import BatchPolicy, plan, resolve_reg_mode
from .channel import Channel, ChannelSet
from .completion import CompletionQueue
from .descriptors import (
    PAGE_SIZE,
    RegMode,
    TransferDescriptor,
    Verb,
    WCStatus,
    WorkCompletion,
    WorkRequest,
    contiguous_runs,
)
from .errors import AllocError, BoxError, ClosedError
from .hist import LatencyHistogram
from .merge_queue import MergeQueue
from .nic import NICCostModel, ServiceConfig, SimulatedNIC, SLOServiceConfig
from .paging import DiskTier, PrefetchBatch, RemotePagingSystem, StripedPlacement
from .polling import PollConfig, Poller, PollMode
from .rdmabox import (
    BatchFuture,
    BatchTransferError,
    BoxConfig,
    RDMABox,
    TransferError,
    TransferFuture,
)
from .region import CacheConfig, CacheTier, RegionDirectory, RemoteRegion
from .registration import (
    ExtentPrefetcher,
    FreqExtentConfig,
    FreqExtentMRCache,
    MRCache,
    MRConfig,
    SLRUConfig,
    SLRUMRCache,
    StagingPool,
)

__all__ = [
    "AdmissionController", "AdmissionHook", "CongestionAwareHook",
    "AllocError", "BoxError", "ClosedError",
    "BatchPolicy", "plan",
    "resolve_reg_mode", "Channel", "ChannelSet", "CompletionQueue",
    "PAGE_SIZE", "RegMode", "TransferDescriptor", "Verb", "WCStatus",
    "WorkCompletion", "WorkRequest", "contiguous_runs", "MergeQueue",
    "LatencyHistogram", "NICCostModel", "ServiceConfig", "SLOServiceConfig",
    "SimulatedNIC", "DiskTier", "PrefetchBatch",
    "RemotePagingSystem", "StripedPlacement",
    "Poller", "PollConfig", "PollMode", "BoxConfig", "RDMABox",
    "BatchFuture", "BatchTransferError",
    "TransferError", "TransferFuture", "RegionDirectory", "RemoteRegion",
    "CacheConfig", "CacheTier",
    "ExtentPrefetcher", "FreqExtentConfig", "FreqExtentMRCache",
    "MRCache", "MRConfig", "SLRUConfig", "SLRUMRCache", "StagingPool",
]
