"""Generalized data-mapping methodology (paper §IV): ClusterMap.

A CiFHER package is a d_x×d_y mesh of cores.  *Block clustering*
``dx×dy-BK-bh×bw`` tiles the mesh into (dx/bh)·(dy/bw) blocks:

* each **block** is one *limb cluster* — its bh·bw cores jointly hold a subset
  of the limbs, with the N coefficients split across the block's cores;
* the cores at the same intra-block position across all blocks form one
  *coefficient cluster* — same coefficient range, different limbs.

Special cases: ``-DW`` (dimension-wise) = BK-dx×1; limb scattering = BK-1×1;
coefficient scattering = BK-dx×dy.

A polynomial (ℓ × N) is split along its limbs over the limb clusters and
along its coefficients within each, so (i)NTT communicates only within a
limb cluster and BConv only within a coefficient cluster — the paper's
central property.

The port of ``repro.core.mapping``.  :meth:`ClusterMap.make_mesh` returns
the port's mesh: one device holding (limb clusters × cores per cluster)
logical shards, axes ("limb", "coef") (:class:`repro_torch.core.distributed.Mesh`).
Physical placement (hop counts on the 2-D NoP mesh, XY routing) feeds the
analytical cost model (:mod:`repro_torch.core.cost_model`).
"""
from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class ClusterMap:
    dx: int                   # mesh rows
    dy: int                   # mesh cols
    bh: int                   # block rows  (limb-cluster height)
    bw: int                   # block cols  (limb-cluster width)

    def __post_init__(self):
        assert self.dx % self.bh == 0 and self.dy % self.bw == 0, \
            f"block {self.bh}x{self.bw} must tile mesh {self.dx}x{self.dy}"

    # -- cluster structure -----------------------------------------------------
    @property
    def n_cores(self) -> int:
        return self.dx * self.dy

    @property
    def block_size(self) -> int:
        """Cores per limb cluster (= size of the ``coef`` mesh axis)."""
        return self.bh * self.bw

    @property
    def n_limb_clusters(self) -> int:
        """#blocks (= size of the ``limb`` mesh axis = coefficient-cluster size)."""
        return self.n_cores // self.block_size

    @property
    def coef_cluster_size(self) -> int:
        return self.n_limb_clusters

    # -- notation ---------------------------------------------------------------
    @property
    def name(self) -> str:
        if self.block_size == 1:
            return f"{self.dx}x{self.dy}-limb-scatter"
        if self.block_size == self.n_cores:
            return f"{self.dx}x{self.dy}-coef-scatter"
        if self.bw == 1 and self.bh == self.dx:
            return f"{self.dx}x{self.dy}-DW"
        return f"{self.dx}x{self.dy}-BK-{self.bh}x{self.bw}"

    @staticmethod
    def parse(s: str) -> "ClusterMap":
        m = re.fullmatch(r"(\d+)x(\d+)-BK-(\d+)x(\d+)", s)
        if m:
            return ClusterMap(*map(int, m.groups()))
        m = re.fullmatch(r"(\d+)x(\d+)-DW", s)
        if m:
            dx, dy = map(int, m.groups())
            return ClusterMap(dx, dy, dx, 1)
        m = re.fullmatch(r"(\d+)x(\d+)-limb-scatter", s)
        if m:
            dx, dy = map(int, m.groups())
            return ClusterMap(dx, dy, 1, 1)
        m = re.fullmatch(r"(\d+)x(\d+)-coef-scatter", s)
        if m:
            dx, dy = map(int, m.groups())
            return ClusterMap(dx, dy, dx, dy)
        raise ValueError(f"unparseable cluster map {s!r}")

    # -- the port's mesh ----------------------------------------------------------
    def make_mesh(self, device="cuda", devices=None):
        """A mesh of (n_limb_clusters, block_size) logical shards, axes
        ("limb", "coef"), on one ``device``, or with ``devices`` its
        coefficient axis split over a sequence of them, or both axes over a
        grid of rows of them (:class:`~repro_torch.core.distributed.Mesh`)."""
        from .distributed import Mesh  # lazy: distributed imports this module
        return Mesh(self.n_limb_clusters, self.block_size,
                    device if devices is None else devices)

    # -- physical NoP geometry (for the analytical cost model) -------------------
    def core_xy(self, core: int) -> tuple[int, int]:
        return core // self.dy, core % self.dy

    def block_of(self, x: int, y: int) -> int:
        return (x // self.bh) * (self.dy // self.bw) + (y // self.bw)

    def intra_block_pos(self, x: int, y: int) -> int:
        return (x % self.bh) * self.bw + (y % self.bw)

    def limb_cluster_members(self, block: int) -> list[tuple[int, int]]:
        bx = (block // (self.dy // self.bw)) * self.bh
        by = (block % (self.dy // self.bw)) * self.bw
        return [(bx + i, by + j) for i in range(self.bh) for j in range(self.bw)]

    def coef_cluster_members(self, pos: int) -> list[tuple[int, int]]:
        px, py = pos // self.bw, pos % self.bw
        return [(bx * self.bh + px, by * self.bw + py)
                for bx in range(self.dx // self.bh)
                for by in range(self.dy // self.bw)]

    @staticmethod
    def _avg_pairwise_hops(members: list[tuple[int, int]]) -> float:
        if len(members) < 2:
            return 0.0
        tot = cnt = 0
        for i, (x1, y1) in enumerate(members):
            for x2, y2 in members[i + 1:]:
                tot += abs(x1 - x2) + abs(y1 - y2)   # XY routing
                cnt += 1
        return tot / cnt

    def limb_cluster_hops(self) -> float:
        """Mean XY-hop distance between cores of one limb cluster."""
        return self._avg_pairwise_hops(self.limb_cluster_members(0))

    def coef_cluster_hops(self) -> float:
        """Mean XY-hop distance between cores of one coefficient cluster."""
        return self._avg_pairwise_hops(self.coef_cluster_members(0))

    def max_cluster_hops(self) -> int:
        def mx(members):
            return max((abs(a[0] - b[0]) + abs(a[1] - b[1])
                        for a in members for b in members), default=0)
        return max(mx(self.limb_cluster_members(0)),
                   mx(self.coef_cluster_members(0)))


def default_block(dx: int, dy: int) -> ClusterMap:
    """Paper §VI-F default: d_x×d_y-BK-(d_x/2)×(d_y/2) (falls back gracefully)."""
    return ClusterMap(dx, dy, max(dx // 2, 1), max(dy // 2, 1))


def all_cluster_maps(dx: int, dy: int, max_limb_clusters: int = 8) -> list[ClusterMap]:
    """Every valid block size for a mesh; the paper caps limb clusters at 8
    (§VI-C) to avoid fragmentation."""
    out = []
    bh = 1
    while bh <= dx:
        bw = 1
        while bw <= dy:
            if dx % bh == 0 and dy % bw == 0:
                cm = ClusterMap(dx, dy, bh, bw)
                if cm.n_limb_clusters <= max_limb_clusters:
                    out.append(cm)
            bw *= 2
        bh *= 2
    return out
