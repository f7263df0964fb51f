"""Meshes: the FHE mesh of a package of cores, and the LM's production
meshes over a fake world of ranks.

**FHE.** :func:`make_fhe_mesh` builds the port's mesh (``limb × coef``
logical shards, :class:`repro_torch.core.distributed.Mesh`) from a core
count: ``limb`` = limb clusters, ``coef`` = cores per cluster (the block
size).  The reference derives its core count from the JAX devices; here the
cores are logical, so the count is the caller's, and it defaults to the
paper's 16-core package.  ``devices`` splits the coefficient axis over
several cards (or parts of one), or as a grid of rows of them both axes.
``multi_pod=True`` adds a leading "pod" axis of 2 (:class:`PodMesh`): each
pod holds one ciphertext of a batch on a mesh of its own, and no collective
crosses "pod".

**LM.** :func:`make_production_mesh` and :func:`make_host_mesh` are
``DeviceMesh``es over a fake process group (``torch.distributed``'s "fake"
backend: every collective is a no-op that returns the right shapes), the
counterpart of the reference's forced XLA host devices.  The dry-run
(:mod:`repro_torch.launch.dryrun`) lowers a cell on them with DTensors under
``FakeTensorMode``: nothing is allocated and no card is needed, by design.
The group lives in :func:`fake_world`, the one place that creates and
destroys it.

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model") — "pod" is the
cross-pod data-parallel axis; params replicate across it, gradients
all-reduce over it.
"""
from __future__ import annotations

import contextlib

from repro_torch.core.distributed import Mesh

#: The paper's default package: a 4×4 mesh of cores (§VI-F).
DEFAULT_CORES = 16


def make_fhe_mesh(*, multi_pod: bool = False, limb_clusters: int = 4,
                  n_cores: int | None = None, device="cuda", devices=None):
    """CiFHER cluster mesh: ``limb`` = limb clusters, ``coef`` = cores per
    cluster, on ``device`` or split over ``devices`` (a sequence, or a grid
    of rows along "limb").  With ``multi_pod`` a :class:`PodMesh` of two such
    meshes of ``n_cores`` each, both on ``device``, or with ``devices`` one
    pod per device.  Raises ``ValueError`` when ``limb_clusters`` does not
    divide ``n_cores``, the grid's columns the cores per cluster or its rows
    the limb clusters."""
    if n_cores is None:
        n_cores = DEFAULT_CORES
    if limb_clusters < 1 or n_cores % limb_clusters:
        raise ValueError(
            f"limb_clusters={limb_clusters} does not divide the core count "
            f"{n_cores} — choose a divisor")
    cs = n_cores // limb_clusters
    if multi_pod:
        pods = list(devices) if devices is not None else [device, device]
        if len(pods) != 2:
            raise ValueError(f"a multi-pod mesh takes one device per pod, got {pods}")
        return PodMesh([Mesh(limb_clusters, cs, d) for d in pods])
    return Mesh(limb_clusters, cs, device if devices is None else devices)


class PodMesh:
    """Axes ("pod", "limb", "coef"): one :class:`Mesh` per pod, each holding
    one ciphertext of the batch.  It has no collective of its own: each
    pod's exchanges run on, and are tallied by, that pod's mesh, so nothing
    crosses "pod"."""

    def __init__(self, pods: list):
        self.pods = list(pods)
        lc, cs = self.pods[0].lc, self.pods[0].cs
        if any((m.lc, m.cs) != (lc, cs) for m in self.pods):
            raise ValueError("the pods of a mesh must have one shape")
        self.shape = {"pod": len(self.pods), "limb": lc, "coef": cs}

    def __repr__(self) -> str:
        return f"PodMesh({self.pods})"


# ----------------------------------------------------------------------------
# The LM's meshes over a fake world
# ----------------------------------------------------------------------------

def _fake_store():
    """``torch``'s fake-backend store (an internal module: imported here only,
    and loudly missing)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - depends on the torch build
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg): "
                           "the dry-run cannot build its mesh") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks, this process rank 0, for
    the duration of the block; destroyed on exit, whatever happens.

    Inside it, DTensor's Shard→Shard redistribution records the all-to-all
    its plan asks for (``_dtensor.shard_dim_alltoall``), where on a CPU mesh
    it would otherwise run an all-gather and keep a chunk."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types as pt
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: fake_world needs "
                           "the process to itself")
    dist.init_process_group("fake", store=_fake_store(), rank=0, world_size=n_ranks)
    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = _planned_alltoall
    try:
        yield n_ranks
    finally:
        pt.shard_dim_alltoall = saved
        dist.destroy_process_group()


def _planned_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    import torch
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs fake_world({n}) around it")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") pod, or the (2, 16, 16) ("pod", "data",
    "model") pair of pods; inside :func:`fake_world` of 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes)


def make_host_mesh(n_devices: int | None = None):
    """Small ("data", "model") mesh over the fake world's ranks (tests,
    examples): the largest power of two d with d² ≤ n on "data"."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    d = 1
    while d * d <= n:
        d *= 2
    d //= 2
    return _device_mesh((d, n // d), ("data", "model"))
