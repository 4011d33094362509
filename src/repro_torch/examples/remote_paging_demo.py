"""Remote paging under memory pressure — the paper's §7.1 scenario in
miniature: an "application" whose working set exceeds local memory pages
its cold data to remote donors, with the engine's merge/admission machinery
visible in the stats, and a donor failure mid-run.

The access sequence and page bytes come from the reference's numpy
generator (torch has no zipf), so hits, faults and evictions equal the
reference's; the pages themselves are ``uint8`` tensors on the device.

  PYTHONPATH=src python -m repro_torch.examples.remote_paging_demo [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import box
from repro_torch.core import PAGE_SIZE

LOCAL_BUDGET = 64          # pages the "host" may keep
WORKING_SET = 512          # pages the app touches


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="remote paging demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    spec = box.ClusterSpec(num_donors=3, donor_pages=1 << 14)
    with box.open(spec, device=args.device) as session:
        dev = session.device
        paging = session.pager()
        local: dict[int, torch.Tensor] = {}
        content = {}

        t0 = time.perf_counter()
        # zipfian page accesses: hot head stays local, tail gets swapped
        accesses = ((rng.zipf(1.3, size=4000) - 1) % WORKING_SET)
        hits = misses = evictions = 0
        for pid in accesses:
            pid = int(pid)
            if pid in local:
                hits += 1
                continue
            if pid in content:               # page was swapped out: fault
                misses += 1
                data = paging.swap_in(pid)
            else:                            # first touch
                data = torch.from_numpy(
                    rng.integers(0, 255, PAGE_SIZE).astype(np.uint8)).to(dev)
                content[pid] = data[:8].clone()
            local[pid] = data
            if len(local) > LOCAL_BUDGET:    # evict coldest (fifo here)
                evictions += 1
                victim, vdata = next(iter(local.items()))
                del local[victim]
                paging.swap_out(victim, vdata)
        session.flush()
        dt = time.perf_counter() - t0

        # verify a few pages survived the round trips
        for pid in list(content)[:20]:
            data = local.get(pid)
            if data is None:
                data = paging.swap_in(pid)
            assert torch.equal(data[:8], content[pid]), f"page {pid} corrupt"

        st = session.stats()
        merge = st["client"]["0"]["box"]["merge"]
        nic = st["nic"]["0"]
        blocked = st["client"]["0"]["box"]["admission"]["blocked"]
        print(f"{len(accesses)} accesses: {hits} hits, {misses} faults, "
              f"{evictions} evictions in {dt:.2f}s")
        print(f"engine: {merge['submitted']} requests -> "
              f"{nic['rdma_ops']} RDMA ops, "
              f"{nic['cache_misses']} WQE-cache misses, "
              f"window blocked {blocked}x")

        # donor failure mid-run: replication keeps every page readable
        paging.fail_node(session.donors[0])
        ok = sum(1 for pid in list(content)[:50]
                 if pid not in local and
                 torch.equal(paging.swap_in(pid)[:8], content[pid]))
        print(f"after donor-0 failure: {ok} swapped pages still readable "
              f"via replicas")
    print("REMOTE PAGING DEMO OK")
    return {"hits": hits, "faults": misses, "evictions": evictions,
            "readable_after_failure": ok, "seconds": dt}


if __name__ == "__main__":
    main()
