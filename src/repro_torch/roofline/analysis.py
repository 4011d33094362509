"""Three-term roofline of one device's step, on the H100.

Twin of ``repro/roofline/analysis.py``, from ``roofline.count``'s counts of
one device's program (the reference's per-device ``hlo_flops``,
``hlo_bytes`` and collective bytes):

compute    = bf16 FLOPs / 989 TFLOP/s + f32 FLOPs / (495 / 3) TFLOP/s
memory     = unfused bytes / 3.35 TB/s          (``count``'s rule)
collective = Σ collective output bytes / 450 GB/s   (NVLink, one direction)

The constants are ``launch.mesh``'s, from NVIDIA's H100 SXM data sheet.
The unfused byte count can exceed what a fused run moves, so a bound built
from it could sit above the true least time. The report therefore also
carries ``min_bytes``: what the step must move at least (this device's
parameters read once, its cache read and written once, its inputs and
outputs once). ``floor_s``, the larger of the compute term, that
minimum-bytes term and the collective term, is the bound a measured time
is held to; ``memory_s`` stays beside it, never clipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
from .count import CATEGORIES, Counts

COLLECTIVES = CATEGORIES


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # per device, every op's
    hlo_bytes: float                 # per device, the unfused rule
    coll_bytes: Dict[str, int]       # per device, by category
    model_flops: float               # 6·N·D (global, analytic)
    f32_flops: float = 0.0           # per device, of hlo_flops on f32 operands
    min_bytes: float = 0.0           # per device, moved at least
    memory_stats: Optional[Dict] = None
    compile_seconds: float = 0.0     # the dry run's seconds for the cell

    @property
    def compute_s(self) -> float:
        return ((self.hlo_flops - self.f32_flops) / PEAK_FLOPS_BF16
                + self.f32_flops / PEAK_FLOPS_F32)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def min_memory_s(self) -> float:
        return self.min_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs × chips) — remat/redundancy waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def floor_s(self) -> float:
        """The least time with the minimum-bytes term in place of the unfused
        one: what a measured step's share is taken against."""
        return max(self.compute_s, self.min_memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / achievable step time (higher = better).

        useful-compute time = MODEL_FLOPS / (chips × peak); the step can at
        best take ``bound_s``, so this is the MFU the program could reach if
        it hit its own roofline.
        """
        ideal = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "f32_flops": self.f32_flops,
            "hlo_bytes": self.hlo_bytes, "min_bytes": self.min_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "min_memory_s": self.min_memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s, "floor_s": self.floor_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_stats": self.memory_stats,
            "compile_seconds": self.compile_seconds,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D for
    inference steps (D = tokens processed by the step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence, plus KV-cache attention reads are
    # memory-, not FLOP-, dominated; 2·N·B is the useful matmul work.
    return 2.0 * n * shape.global_batch


def analyze(counts: Counts, *, arch: str, shape_name: str, mesh_name: str, chips: int,
            model_flops: float, min_bytes: float = 0.0, memory_stats: Optional[Dict] = None,
            compile_seconds: float = 0.0) -> RooflineReport:
    """The roofline of one device's ``counts`` (``roofline.count.count``)."""
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=counts.flops, hlo_bytes=counts.bytes,
        coll_bytes={k: int(v) for k, v in counts.coll_bytes.items()},
        model_flops=model_flops, f32_flops=counts.f32_flops, min_bytes=min_bytes,
        memory_stats=memory_stats, compile_seconds=compile_seconds)
