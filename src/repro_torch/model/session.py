"""``ModelSession`` — the analytic backend behind
``box.open(spec, backend="model")``.

It answers the questions the threaded engine answers with
``Session.stats()``, but in closed form: same declarative
``ClusterSpec`` in, same dotted-key namespaces out
(``nic.<node>.service.*`` per-class serve estimates,
``client.<i>.box.latency.*`` p50/p99 estimates), plus a ``model.*``
namespace carrying what only an analytic backend can say — per-center
utilization cards, the predicted bottleneck, total capacity, and
saturation warnings. Where an estimate fills a histogram-shaped slot
its ``count`` is 0: closed-form numbers, not samples.

The payoff is ``sweep()``: a grid of ClusterSpec variants (clients x
donors x workers x cache) evaluates in milliseconds per point — the
capacity-planning loop RDMAvisor argues datacenter RDMA needs, at
scales where the thread-per-NIC engine would melt the host.

Imperative capabilities (``engine()``, ``pager()``, fault injection,
…) have no analytic counterpart and raise ``BoxError`` — loudly, so a
bench never silently "runs" against a model.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Iterable, List, Optional, Union

from ..core.errors import BoxError
from .engine import ModelReport, evaluate
from .workload import ModelWorkload

# Session capabilities with no analytic counterpart: each raises a
# BoxError naming the sim backend as the way to get the real object.
_IMPERATIVE = ("engine", "heap", "pager", "tensors", "kv_store",
               "crash_donor", "recover_donor", "congest_path",
               "clear_path")


def _unsupported(name: str):
    def method(self, *args: Any, **kwargs: Any):
        raise BoxError(
            f"ModelSession.{name}() is not available: the model backend "
            f"is a closed-form evaluator, it has no live objects to hand "
            f"out — open the spec with backend=\"sim\" for an imperative "
            f"session")
    method.__name__ = name
    method.__doc__ = (f"Unavailable on the analytic backend; raises "
                      f"``BoxError`` (use ``backend=\"sim\"``).")
    return method


class ModelSession:
    """Analytic session: evaluate once at construction, read forever.

    Args:
        spec: a validated ``ClusterSpec`` (``backend`` field ignored
            here — dispatch happened in ``box.open``).
        workload: the offered traffic (``ModelWorkload``, dict, or None
            for the target-utilization default).
        link_config: optional ``LinkConfig`` override, mirroring the
            ``open_session`` escape hatch of the same name.

    Raises:
        BoxError: from any imperative accessor, and from ``stats`` /
            ``evaluate`` after ``close``.
    """

    backend = "model"

    def __init__(self, spec, *, workload=None, link_config=None) -> None:
        self.spec = spec
        self.workload = ModelWorkload.coerce(workload)
        self._link_config = link_config
        self._closed = False
        self.donors: List[int] = [spec.client_node + spec.num_clients + i
                                  for i in range(spec.num_donors)]
        self.report: ModelReport = evaluate(spec, self.workload,
                                            link_config=link_config)

    # ---- lifecycle (mirrors Session) ---------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def _guard(self) -> None:
        if self._closed:
            raise BoxError("session is closed")

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "ModelSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def flush(self, timeout: float = 30.0) -> None:
        """No-op: a closed-form evaluation has nothing in flight."""
        self._guard()

    # ---- evaluation --------------------------------------------------------
    def evaluate(self, workload=None) -> ModelReport:
        """Re-solve under a different workload (spec unchanged) and make
        it the report ``stats()`` renders."""
        self._guard()
        if workload is not None:
            self.workload = ModelWorkload.coerce(workload)
        self.report = evaluate(self.spec, self.workload,
                               link_config=self._link_config)
        return self.report

    def sweep(self, variants: Iterable[Union[Dict[str, Any], Any]],
              workload=None) -> List[Dict[str, Any]]:
        """Evaluate a grid of spec variants, one summary dict each.

        Each variant is either a dict of ``ClusterSpec`` field overrides
        applied to this session's spec (``{"serve_workers": 4}``) or a
        complete ``ClusterSpec``. The summary carries the planning
        signals: total capacity, the predicted bottleneck center,
        per-class achieved rate and p99, and whether anything saturated
        at the offered load. Milliseconds per point — this is the
        capacity-planning loop.
        """
        self._guard()
        wl = ModelWorkload.coerce(workload) if workload is not None \
            else self.workload
        out: List[Dict[str, Any]] = []
        for variant in variants:
            spec = (replace(self.spec, **variant)
                    if isinstance(variant, dict) else variant)
            rep = evaluate(spec, wl, link_config=self._link_config)
            out.append({
                "variant": variant if isinstance(variant, dict)
                else spec.to_dict(),
                "capacity_ops_per_s": rep.capacity_ops_per_s,
                "bottleneck": rep.bottleneck,
                "saturated": sorted(rep.warnings["saturated"]),
                "eval_ms": rep.eval_ms,
                "classes": {
                    name: {"achieved_ops_per_s": c.achieved_ops_per_s,
                           "mean_us": c.mean_us, "p99_us": c.p99_us}
                    for name, c in rep.classes.items()},
            })
        return out

    # ---- the one stats tree ------------------------------------------------
    def stats(self, flat: bool = False) -> Dict[str, Any]:
        """The composed stats tree, same namespaces as the sim backend.

        ``nic.<donor>.service.*`` — per-class serve-rate and latency
        *estimates* (``ops_per_s``/``bytes_per_s`` rates instead of the
        sim's monotonic counters; histogram-shaped latency leaves with
        ``count=0``); ``client.<i>.box.latency.*`` — that client's class
        estimate; ``model.*`` — centers, capacity, bottleneck, warnings.
        ``flat=True`` returns dotted keys (``box.flatten_stats``).
        """
        self._guard()
        from ..box.stats import flatten_stats    # lazy: box imports model
        rep = self.report
        wl = rep.workload
        donor_visits = wl.read_fraction + (1.0 - wl.read_fraction) * (
            self.spec.replication if wl.replicate_writes else 1)
        nic: Dict[str, Any] = {}
        per_class: Dict[str, Any] = {}
        for name, c in rep.classes.items():
            rate = (c.achieved_ops_per_s * c.clients * donor_visits
                    / self.spec.num_donors)
            per_class[name] = {
                "ops_per_s": rate,
                "bytes_per_s": rate * (c.bytes_per_s
                                       / max(c.achieved_ops_per_s, 1e-12)),
                "latency": c.latency_snapshot(),
            }
        ingress = rep.centers.get("donor.ingress_pu")
        service = {
            "serve_workers": ingress.servers if ingress else 0,
            "per_class": per_class,
            "cache": {"hit_rate": rep.cache_hit_rate},
            "mr": {"hit_rate": rep.mr_hit_rate,
                   "prefetch_coverage": rep.mr_prefetch_coverage},
        }
        for node in self.donors:
            nic[str(node)] = {"service": service}
        clients: Dict[str, Any] = {}
        for i, cls in enumerate(rep.client_class):
            c = rep.classes[cls]
            clients[str(i)] = {"box": {
                "latency": c.latency_snapshot(),
                "sla_class": cls,
                "offered_ops_per_s": c.offered_ops_per_s,
                "achieved_ops_per_s": c.achieved_ops_per_s,
            }}
        tree = {
            "nic": nic,
            "client": clients,
            "model": {
                "backend": "model",
                "capacity_ops_per_s": rep.capacity_ops_per_s,
                "bottleneck": rep.bottleneck,
                "cache_hit_rate": rep.cache_hit_rate,
                "mr_hit_rate": rep.mr_hit_rate,
                "mr_prefetch_coverage": rep.mr_prefetch_coverage,
                "eval_ms": rep.eval_ms,
                "workload": wl.to_dict(),
                "centers": {name: est.snapshot()
                            for name, est in rep.centers.items()},
                "warnings": dict(rep.warnings),
            },
        }
        return flatten_stats(tree) if flat else tree


for _name in _IMPERATIVE:
    setattr(ModelSession, _name, _unsupported(_name))
