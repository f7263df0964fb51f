"""The FHE mesh of a package of cores.

:func:`make_fhe_mesh` builds the port's mesh (one device holding ``limb ×
coef`` logical shards, :class:`repro_torch.core.distributed.Mesh`) from a
core count: ``limb`` = limb clusters, ``coef`` = cores per cluster (the block
size).  The reference derives its core count from the JAX devices; here the
cores are logical, so the count is the caller's, and it defaults to the
paper's 16-core package.  ``devices`` splits the coefficient axis over
several cards (or parts of one), or as a grid of rows of them both axes.  The reference's LM meshes and its
multi-pod form wait for the LM scaffolding.
"""
from __future__ import annotations

from repro_torch.core.distributed import Mesh

#: The paper's default package: a 4×4 mesh of cores (§VI-F).
DEFAULT_CORES = 16


def make_fhe_mesh(*, limb_clusters: int = 4, n_cores: int | None = None,
                  device="cuda", devices=None) -> Mesh:
    """CiFHER cluster mesh: ``limb`` = limb clusters, ``coef`` = cores per
    cluster, on ``device`` or split over ``devices`` (a sequence, or a grid
    of rows along "limb").  Raises ``ValueError`` when ``limb_clusters``
    does not divide ``n_cores``, the grid's columns the cores per cluster or
    its rows the limb clusters."""
    if n_cores is None:
        n_cores = DEFAULT_CORES
    if limb_clusters < 1 or n_cores % limb_clusters:
        raise ValueError(
            f"limb_clusters={limb_clusters} does not divide the core count "
            f"{n_cores} — choose a divisor")
    return Mesh(limb_clusters, n_cores // limb_clusters,
                device if devices is None else devices)
