"""Quickstart: the ``repro_torch.box`` public API in 70 lines.

One declarative spec opens a 3-donor remote-memory cluster; the session
hands out handle-based remote buffers, the replicated pager, and one
composed stats tree — with the load-aware batching engine underneath.
Buffers are torch ``uint8`` tensors on the session's device.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
from typing import List, Optional

import torch

from repro_torch import box

# modest admission window + realistic link speed so the burst below
# actually stacks the merge queue (light load never batches — by design);
# congestion-aware admission selected by registry name
SPEC = box.ClusterSpec(num_donors=3, donor_pages=8192, heap_pages=1024,
                       replication=2, window_bytes=256 << 10,
                       nic_scale=2e-7, admission="congestion")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with box.open(SPEC, device=args.device) as session:
        dev = session.device
        # --- 1. handle-based remote memory with futures --------------------
        heap = session.heap()
        buf = heap.alloc(4 * box.PAGE_SIZE)
        data = (torch.arange(4 * box.PAGE_SIZE, device=dev) % 256).to(torch.uint8)
        buf.write(data).wait()             # one WorkRequest, zero-copy
        assert torch.equal(buf.read(), data)
        print(f"1. alloc/write/read roundtrip OK "
              f"({buf.num_pages} pages on donor {buf.donor})")

        # --- 2. load-aware batching: a burst of adjacent pages merges ------
        page = (torch.arange(box.PAGE_SIZE, device=dev) % 256).to(torch.uint8)
        bufs = [heap.alloc(128 * box.PAGE_SIZE) for _ in range(6)]

        def burst(b):
            # one batched vector: single submit-lock acquisition, ONE future
            b.writev([(i, page) for i in range(128)]).wait()

        threads = [threading.Thread(target=burst, args=(b,)) for b in bufs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = session.stats()
        merge = st["client"]["0"]["box"]["merge"]
        nic = st["nic"]["0"]
        admission = st["client"]["0"]["box"]["admission"]
        print(f"2. {merge['submitted']} requests -> "
              f"{nic['rdma_ops']} RDMA ops "
              f"({merge['submitted']/nic['rdma_ops']:.1f}x fewer WQEs), "
              f"{nic['mmio_writes']} MMIOs, "
              f"admission blocked {admission['blocked']} times")

        # --- 3. remote paging with replication + failover ------------------
        pager = session.pager()
        pager.swap_out(7, page, wait=True)
        primary = pager.replicas(7)[0][0]
        pager.fail_node(primary)           # kill the primary donor
        back = pager.swap_in(7)            # read served by the surviving replica
        assert back.device.type == dev.type and torch.equal(back, page)
        print(f"3. donor {primary} failed; replica read OK")

        # --- 4. one stats tree, dotted access -------------------------------
        flat = session.stats(flat=True)
        print(f"4. adaptive polling: {flat['client.0.box.poll.handled']} "
              f"completions in {flat['client.0.box.poll.wakeups']} wakeups; "
              f"window fraction "
              f"{flat['client.0.box.admission.hook.window_fraction']:.2f}")
    print("QUICKSTART OK")
    return {"submitted": merge["submitted"], "rdma_ops": nic["rdma_ops"],
            "failed_primary": primary}


if __name__ == "__main__":
    main()
