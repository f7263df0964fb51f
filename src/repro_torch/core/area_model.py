"""Per-core / package area model calibrated to paper Table II (7 nm).

Fits (mm², L = lanes per core, s = NTTU submodules = L/16, RF in MB):
    RF        0.4955 · MB_per_core          (256 MB scratch + 16 MB aux fixed)
    NTTU      0.2209 · s + 0.0145
    BConvU    0.00329 · L + 0.2273
    EFU       0.0028125 · L
    AutoU     3.539e-5 · L²                 (quadratic permutation network)
    PRNG      0.00277 · L
    Router/PHY 6.80 · per_edge_bw / 1 TB/s  (bisection 2 TB/s / crossing edges)
    I/O dies  36.71 (package constant)

These fits reproduce Table II; the value of the model is extrapolation to
non-default configurations (the §VI-D sweep of lane counts and NoP
bandwidths).  The port of ``repro.core.area_model``.
"""
from __future__ import annotations

import dataclasses

from .cost_model import PackageConfig, TB
from .mapping import ClusterMap

RF_MM2_PER_MB = 0.4955
SCRATCH_MB = 256.0
AUX_MB = 16.0
IO_DIE_MM2 = 36.71


def bisection_edges(cm: ClusterMap) -> int:
    """Links crossing the bisection of a d_x×d_y mesh (cut the longer dim)."""
    return min(cm.dx, cm.dy) if cm.dx != cm.dy else cm.dx


@dataclasses.dataclass
class CoreArea:
    rf: float
    nttu: float
    bconvu: float
    efu: float
    autou: float
    prng: float
    router_phy: float

    @property
    def total(self) -> float:
        return (self.rf + self.nttu + self.bconvu + self.efu + self.autou
                + self.prng + self.router_phy)


def core_area(pkg: PackageConfig) -> CoreArea:
    L = pkg.lanes_per_core
    s = L / 16
    n = pkg.n_cores
    per_edge_bw = pkg.bisection_bw / bisection_edges(pkg.cm)
    return CoreArea(
        rf=RF_MM2_PER_MB * (SCRATCH_MB + AUX_MB) / n,
        nttu=0.2209 * s + 0.0145,
        bconvu=0.00329 * L + 0.2273,
        efu=0.0028125 * L,
        autou=3.539e-5 * L * L,
        prng=0.00277 * L,
        router_phy=6.80 * per_edge_bw / TB,
    )


def package_area(pkg: PackageConfig) -> dict:
    ca = core_area(pkg)
    return {
        "core_mm2": ca.total,
        "cores_mm2": ca.total * pkg.n_cores,
        "io_mm2": IO_DIE_MM2,
        "total_mm2": ca.total * pkg.n_cores + IO_DIE_MM2,
        "breakdown": dataclasses.asdict(ca),
    }
