"""The paper's own application workload: SDSS DR5 image stacking (§5).

Table 2 workload characteristics (locality -> objects/files), file sizes
(2 MB compressed GZ / 6 MB uncompressed FIT), and the §5.2 stacking-code
profile used to calibrate per-task compute in the simulator:

  * calibration+interpolation+doStacking < 1 ms
  * radec2xy ~ 10-20% of total (we use 2 ms)
  * GZ decompress is CPU-bound (~40 ms for 2 MB -> 6 MB): single-CPU GZ is
    *slower* than FIT locally, but wins at scale because it moves 3x fewer
    bytes through the saturated shared FS (Figure 7's crossover).
"""
from __future__ import annotations

from dataclasses import dataclass

MB = 1_000_000

# Table 2: locality -> (num objects, num files)
WORKLOADS: dict[float, tuple[int, int]] = {
    1: (111_700, 111_700),
    1.38: (154_345, 111_699),
    2: (97_999, 49_000),
    3: (88_857, 29_620),
    4: (76_575, 19_145),
    5: (60_590, 12_120),
    10: (46_480, 4_650),
    20: (40_460, 2_025),
    30: (23_695, 790),
}

GZ_BYTES = 2 * MB
FIT_BYTES = 6 * MB

# §5.2-calibrated per-task CPU costs (seconds)
RADEC2XY_S = 2e-3
STACK_MATH_S = 1e-3          # calibration + interpolation + doStacking
GZ_DECOMPRESS_S = 40e-3
ROI_SHAPE = (100, 100)       # pixels per cutout


@dataclass(frozen=True)
class StackingWorkload:
    locality: float
    n_objects: int
    n_files: int
    compressed: bool

    @property
    def file_bytes(self) -> int:
        return GZ_BYTES if self.compressed else FIT_BYTES

    @property
    def compute_seconds(self) -> float:
        cpu = RADEC2XY_S + STACK_MATH_S
        if self.compressed:
            cpu += GZ_DECOMPRESS_S
        return cpu

    @property
    def ideal_cache_hit_ratio(self) -> float:
        """Paper's Figure 10 ideal: 1 - 1/locality."""
        return 1.0 - 1.0 / self.locality if self.locality > 0 else 0.0


def workload(locality: float, compressed: bool = True,
             scale: float = 1.0) -> StackingWorkload:
    n_obj, n_files = WORKLOADS[locality]
    return StackingWorkload(locality=locality,
                            n_objects=max(int(n_obj * scale), 1),
                            n_files=max(int(n_files * scale), 1),
                            compressed=compressed)
