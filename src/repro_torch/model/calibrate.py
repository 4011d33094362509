"""Calibration harness: run the SAME spec + workload through both
backends and compare what they report.

The analytic backend is only trustworthy if, on topologies small enough
for the threaded engine to simulate, the two agree. This module drives
the simulator with a paced open-loop workload — the exact traffic shape
``ModelWorkload`` describes (per-client arrival rate, pages per op,
read fraction, uniform or zipfian page choice) — measures
``Session.stats()``, evaluates the model at the same operating point,
and reports the ratios side by side.

Methodology notes (also in ``docs/modeling.md``):

* Arrivals are paced on an *absolute* schedule (``t0 + k * gap``), not
  ``sleep(gap)`` accumulation, so scheduler jitter does not silently
  lower the offered rate.
* The comparison only means something when the simulated per-op costs
  are large enough for the pacers to actually sleep (charges below
  ``Pacer.min_sleep_real`` are virtually accounted but do not shape
  cross-thread timing) — calibration specs use PU-heavy cost models at
  a coarse ``nic_scale`` for exactly this reason.
* Elapsed virtual time is real elapsed divided by ``nic_scale``; the
  measured rate is completions over that window, so it includes the
  drain tail (conservative on short runs — size ``ops_per_client``
  accordingly).

In the port the simulator's client buffers are ``torch.uint8`` tensors
on the session's device, so on the card every paced write moves its
bytes from device memory to the donor's pinned host region; the model
side is the same closed-form evaluation as on the CPU. The interpreter's
garbage is collected just before the measured window: a full collection
of a heap that holds torch stops every engine thread for about 0.1 s, and
landing inside a run of 0.4 s it alone pushes the mean latency out of
any band.
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass
from typing import List, Union

import torch

from ..core.descriptors import PAGE_SIZE
from .engine import ModelReport, evaluate
from .workload import ModelWorkload


@dataclass
class CalibrationResult:
    """Both backends' view of one (spec, workload) operating point."""

    offered_ops_per_s: float       # per client, virtual
    measured_ops_per_s: float      # per client, sim completions / elapsed
    model_ops_per_s: float         # per client, analytic achieved rate
    measured_mean_us: float        # sim, count-weighted across clients
    model_mean_us: float
    measured_p99_us: float
    model_p99_us: float
    measured_shrinks: int          # admission-window shrinks, all clients
    model_saturated: bool          # any center at/over the threshold
    report: ModelReport

    @property
    def throughput_ratio(self) -> float:
        return self.model_ops_per_s / max(self.measured_ops_per_s, 1e-12)

    @property
    def latency_ratio(self) -> float:
        return self.model_mean_us / max(self.measured_mean_us, 1e-12)

    def within(self, tolerance: float) -> bool:
        """True when both ratios land inside ``1 +- tolerance``."""
        lo, hi = 1.0 - tolerance, 1.0 + tolerance
        return (lo <= self.throughput_ratio <= hi
                and lo <= self.latency_ratio <= hi)

    def agreement(self) -> str:
        return (f"throughput model/measured={self.throughput_ratio:.3f} "
                f"({self.model_ops_per_s:.0f} vs "
                f"{self.measured_ops_per_s:.0f} ops/s/client), "
                f"mean latency model/measured={self.latency_ratio:.3f} "
                f"({self.model_mean_us:.0f} vs "
                f"{self.measured_mean_us:.0f} us), "
                f"saturated={self.model_saturated} "
                f"shrinks={self.measured_shrinks}")


def _drive_client(session, i: int, donors: List[int], workload:
                  ModelWorkload, ops: int, gap_real: float,
                  data: torch.Tensor, share: int, timeout: float) -> None:
    """One paced open-loop client: deterministic donor round-robin,
    stride page choice inside the client's own share, read/write split
    by a fixed per-client phase — fully reproducible, no RNG."""
    eng = session.engine(i)
    reads = round(workload.read_fraction * 1000)
    base = i * share
    futures = []
    t0 = time.perf_counter()
    for k in range(ops):
        target = t0 + k * gap_real
        while True:
            now = time.perf_counter()
            if now >= target:
                break
            time.sleep(min(target - now, 0.002))
        donor = donors[(i + k) % len(donors)]
        page = base + (k * 7) % max(1, share - workload.pages_per_op)
        if (k * 1000 + i * 337) % 1000 < reads:
            futures.append(eng.read(donor, page, workload.pages_per_op))
        else:
            futures.append(eng.write(donor, page, data,
                                     num_pages=workload.pages_per_op))
    for f in futures:
        f.wait(timeout)


def run_calibration(spec, workload, *, ops_per_client: int = 64,
                    timeout: float = 240.0,
                    device: Union[str, torch.device] = "cuda",
                    ) -> CalibrationResult:
    """Measure the sim and evaluate the model at one operating point.

    ``workload.client_ops_per_s`` must be set (the sim cannot pace
    toward "target utilization" without knowing the rate). ``device``
    is the threaded ``Session``'s, resolved like every entry point's:
    the clients' write buffer lives there.

    Raises:
        ValueError: when the workload has no explicit rate.
        RuntimeError: a CUDA ``device`` and no GPU.
    """
    from ..box.session import Session

    wl = ModelWorkload.coerce(workload).validate()
    if wl.client_ops_per_s is None:
        raise ValueError("calibration needs an explicit "
                         "client_ops_per_s to pace the simulator at")
    report = evaluate(spec, wl)
    model_rate = sum(c.achieved_ops_per_s * c.clients
                     for c in report.classes.values()) / spec.num_clients
    model_mean = sum(c.mean_us * c.clients
                     for c in report.classes.values()) / spec.num_clients
    model_p99 = max(c.p99_us for c in report.classes.values())

    gap_real = (1e6 / wl.client_ops_per_s) * spec.nic_scale
    share = spec.donor_pages // spec.num_clients
    with Session(spec, device=device) as s:
        data = torch.zeros(wl.pages_per_op * PAGE_SIZE, dtype=torch.uint8,
                           device=s.device)
        threads = [threading.Thread(
            target=_drive_client,
            args=(s, i, s.donors, wl, ops_per_client, gap_real, data,
                  share, timeout))
            for i in range(spec.num_clients)]
        gc.collect()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed_vus = (time.perf_counter() - t0) / spec.nic_scale
        stats = s.stats()

    count = mean_acc = 0.0
    p99 = 0.0
    shrinks = 0
    for i in range(spec.num_clients):
        box = stats["client"][str(i)]["box"]
        lat = box["latency"]
        count += lat["count"]
        mean_acc += lat["mean_us"] * lat["count"]
        p99 = max(p99, lat["p99_us"])
        hook = box["admission"].get("hook")
        if hook:
            shrinks += hook["shrinks"]
    measured_mean = mean_acc / max(count, 1.0)
    measured_rate = (count / spec.num_clients) / elapsed_vus * 1e6

    return CalibrationResult(
        offered_ops_per_s=wl.client_ops_per_s,
        measured_ops_per_s=measured_rate,
        model_ops_per_s=model_rate,
        measured_mean_us=measured_mean,
        model_mean_us=model_mean,
        measured_p99_us=p99,
        model_p99_us=model_p99,
        measured_shrinks=shrinks,
        model_saturated=report.saturated,
        report=report)
