from .kv_cache import PageAllocator, PagedKVCache, PageRun, plan_page_runs
from .offload import OffloadConfig, OffloadManager
from .pool import MemoryCluster

__all__ = ["PageAllocator", "PagedKVCache", "PageRun", "plan_page_runs",
           "OffloadConfig", "OffloadManager", "MemoryCluster"]
