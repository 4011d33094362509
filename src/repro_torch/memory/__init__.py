from .kv_cache import PageAllocator, PageRun, plan_page_runs

__all__ = ["PageAllocator", "PageRun", "plan_page_runs"]
