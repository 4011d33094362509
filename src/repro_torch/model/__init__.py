"""``repro_torch.model`` — the analytic (queueing-model) cluster backend.

The thread-per-NIC simulator answers "what happened"; this package
answers "what would happen" in closed form: the same ``ClusterSpec``
is compiled into a graph of service centers — one per resource the
simulator charges (PUs, wires, links, region bandwidth, disk) — and
solved with M/G/k queue-delay formulas instead of sleeping threads.
Select it with ``box.open(spec, backend="model")``; see
``docs/modeling.md`` for the center graph, composition rules, and the
calibration methodology that keeps it honest.

The port of ``repro.model``. The model computes on the host in closed
form with the standard library: it allocates no tensor and starts no
thread, whatever ``device`` ``box.open`` was given. Only
``run_calibration`` touches the card, through the threaded ``Session``
it measures against.
"""

from .calibrate import CalibrationResult, run_calibration
from .centers import (
    SATURATION_RHO,
    Center,
    CenterDisk,
    CenterEstimate,
    CenterLink,
    CenterPU,
    CenterRegionBW,
    CenterWire,
    erlang_c,
    make_center,
)
from .engine import ClassReport, ModelReport, evaluate
from .session import ModelSession
from .workload import ModelWorkload, harmonic, zipf_top_share

__all__ = [
    "SATURATION_RHO",
    "CalibrationResult",
    "Center",
    "CenterDisk",
    "CenterEstimate",
    "CenterLink",
    "CenterPU",
    "CenterRegionBW",
    "CenterWire",
    "ClassReport",
    "ModelReport",
    "ModelSession",
    "ModelWorkload",
    "erlang_c",
    "evaluate",
    "harmonic",
    "make_center",
    "run_calibration",
    "zipf_top_share",
]
