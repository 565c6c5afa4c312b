"""Device mesh and sharded pipeline execution.

Counterpart of epidemicmodeling_tpu/parallel/mesh.py. The reference is
serial; its parallel structure is the embarrassingly parallel loop nest
over regions x Pareto epsilon x Monte Carlo, mapped onto a 2-D mesh:

    dp = regions  (data parallel)
    ep = Pareto epsilon ensemble (ensemble parallel)

A ``Mesh`` here is a (dp, ep) grid of slots, each a ``torch.device``, with
the process that owns each slot and, when the mesh spans processes, the
``torch.distributed`` group that joins them. As in the JAX package's Pallas
path, the only work the mesh splits is the lane work of the two EKS kernels
(and, on the "vmap" backend, the sweep's EKS lanes): ``ops/cuda/shard.py``
blocks the lane axis over the slots, runs each block on its slot and
gathers the outputs back to the lead slot (this process's first). The
region inputs, the rollouts, the costs and the regressions stay on the lead
slot (see shard_region_batch). Lanes are independent filters, so there is
no collective in the hot loop: across processes the one communication is
the gather of each kernel call's outputs.

Several slots may name the same device: they then run their blocks on it in
turn. That checks the split, the per-block kernel geometry and the gather
on a machine with fewer cards than slots, and says nothing of scaling.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..utils.device import resolve_device


class Mesh:
    """A 2-D grid of slots. ``devices``: (dp, ep) object array of
    ``torch.device``; ``process_index``: (dp, ep) ints, the rank of the
    process that owns each slot (all 0 within one process); ``group``: the
    ``torch.distributed`` group of a mesh that spans processes, else None.
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names=("dp", "ep"), process_index=None,
                 group=None, rank: int = 0):
        shape = np.shape(devices)
        flat = np.empty(int(np.prod(shape)), dtype=object)
        flat[:] = [torch.device(d) for d in np.asarray(devices,
                                                       dtype=object).flat]
        self.devices = flat.reshape(shape)
        if self.devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {shape} do not match the "
                             f"axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.process_index = (np.zeros(shape, int) if process_index is None
                              else np.asarray(process_index, int)
                              .reshape(shape))
        owners, counts = np.unique(self.process_index, return_counts=True)
        if len(set(counts.tolist())) > 1:
            raise ValueError("every process must own the same number of "
                             f"slots (got {dict(zip(owners, counts))})")
        if rank not in owners:
            raise ValueError(f"process {rank} owns no slot of the mesh")
        self.group = group
        self.rank = rank

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return bool((self.process_index != self.rank).any())

    def local_slots(self):
        """[(slot index tuple, device)] of the slots this process owns, in
        row-major order."""
        return [(idx, self.devices[idx])
                for idx in np.ndindex(self.devices.shape)
                if self.process_index[idx] == self.rank]

    @property
    def lead(self) -> torch.device:
        """The device of this process's first slot: where the replicated
        inputs and the glue around the kernels live."""
        return self.local_slots()[0][1]


def make_mesh(n_devices: int | None = None, axis_names=("dp", "ep"), *,
              device=None, devices=None) -> Mesh:
    """Build a 2-D mesh over (regions, ensemble).

    Factorizes the slot count as evenly as possible (the largest factor
    <= sqrt(n) is ep); a prime count yields (n, 1). The slots: ``devices``
    when given (a device may appear more than once: its slots then share
    it), else every CUDA card (``device`` resolved as the entry points do:
    the card by default, raising without one), or ``n_devices`` CPU slots
    for device="cpu" (one by default; they run in turn). ``n_devices``
    keeps the first n slots."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * (n_devices or 1)
    else:
        devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one slot")
    f = max(k for k in range(1, math.isqrt(n) + 1) if n % k == 0)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // f, f), axis_names)


def mesh_device(mesh, device=None):
    """The device an entry point runs its replicated work on: without a
    mesh, ``device``; with one, its lead slot (a ``device`` that names
    another device raises)."""
    if mesh is None:
        return device
    if device is not None:
        want = torch.device(device)
        lead = mesh.lead
        if want.type != lead.type or (want.index is not None
                                      and want.index != lead.index):
            raise ValueError(f"device={want} is not the mesh's lead slot "
                             f"{lead}: with a mesh, leave device unset")
    return mesh.lead


def block_index(mesh, slot, axes) -> tuple[int, int]:
    """(k, n): the block of a dimension split over the mesh axes ``axes``
    (a name or a tuple of names, the first major) that ``slot`` holds, and
    the number of blocks, as a JAX PartitionSpec entry assigns them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    pos = dict(zip(mesh.axis_names, slot))
    k, n = 0, 1
    for a in axes:
        k = k * mesh.shape[a] + pos[a]
        n *= mesh.shape[a]
    return k, n


class Placed:
    """A host array placed on a mesh: ``shards`` maps each local slot to its
    block (the whole array where ``spec`` replicates) on the slot's device.
    ``spec`` has one entry per dimension: None, an axis name or a tuple of
    names, as a JAX PartitionSpec (() replicates)."""

    def __init__(self, spec, shards):
        self.spec = spec
        self.shards = shards


def put_global(x, mesh: Mesh, spec=()):
    """Place ``x`` (a host array or tensor every process holds in full) on
    the mesh with the given spec: each process builds only the blocks of
    the slots it owns."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    spec = tuple(spec)
    shards = {}
    for slot, dev in mesh.local_slots():
        index = []
        for d, axes in enumerate(spec):
            if axes is None:
                index.append(slice(None))
                continue
            k, n = block_index(mesh, slot, axes)
            b = t.shape[d] // n
            index.append(slice(k * b, (k + 1) * b))
        shards[slot] = t[tuple(index)].to(dev)
    return Placed(spec, shards)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(out) if type(tree) in (list, tuple) \
            else type(tree)(*out)
    return fn(tree)


def shard_batch_arrays(mesh: Mesh, tree, axis: str = "dp",
                       strict: bool = True):
    """Place every array leaf (of nested dicts, lists and tuples) with its
    leading axis sharded over ``axis``.

    Scalars (ndim == 0) are replicated. A leaf whose leading dim does not
    divide the axis size cannot be sharded; with ``strict=True`` (default)
    that raises so a divisibility mistake fails fast instead of silently
    demoting the sharding to replication; with ``strict=False`` it is
    replicated with a warning.
    """
    axis_size = mesh.shape[axis]

    def put(x):
        ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
        spec = ()
        if ndim >= 1:
            if x.shape[0] % axis_size:
                msg = (f"shard_batch_arrays: leaf with shape "
                       f"{tuple(x.shape)} has leading dim {x.shape[0]} not "
                       f"divisible by mesh axis '{axis}' size {axis_size}")
                if strict:
                    raise ValueError(msg + " (pass strict=False to "
                                     "replicate instead)")
                warnings.warn(msg + "; replicating", stacklevel=3)
            else:
                spec = (axis,) + (None,) * (ndim - 1)
        return put_global(x, mesh, spec)

    return _tree_map(put, tree)


REGION_BATCH_ARRAY_FIELDS = ("observations", "new_cases_norm",
                             "confirmed_norm", "npis", "obs_noise_var",
                             "population")


def validate_pareto_chunk(pareto_chunk: int, mesh) -> None:
    """Refuse a Pareto chunk size the 'ep' mesh axis cannot shard.

    Each epsilon chunk's lanes are split over the mesh with 'ep' major; an
    indivisible chunk would otherwise surface deep inside the sweep. Shared
    by every mesh-taking entry point (run_pipeline, pareto_prescribe) so
    the rule and the message cannot diverge."""
    if mesh is not None and pareto_chunk % mesh.shape["ep"]:
        raise ValueError(
            f"pareto_chunk={pareto_chunk} not divisible by mesh "
            f"ep={mesh.shape['ep']}; pick a chunk size that is a "
            "multiple of the ep axis")


def shard_region_batch(mesh: Mesh, batch, axis: str = "dp", dtype=None):
    """Place a RegionBatch's array fields (REGION_BATCH_ARRAY_FIELDS) for a
    mesh run, REPLICATED: the hot fields (observations, npis,
    obs_noise_var) as tensors in ``dtype`` on the lead slot, the fields host
    logic reads (new_cases_norm, confirmed_norm, population) as NumPy on the
    host, in every process.

    Deliberate design (the JAX package's rule): the region INPUTS are
    replicated, while the lane WORK is sharded (each EKS kernel call splits
    its lanes over the mesh, ops/cuda/shard.py). Two reasons:

    1. Bit-parity. A dp-sharded region axis runs the regions' arithmetic at
       other per-device shapes, which can reorder fma contractions by
       ~1 ulp; harmless in the smoother but AMPLIFIED by the NNLS
       active-set selection (a discrete support flip turned a 1-ulp
       smoother difference into 6% different trained coefficients in the
       JAX package's testing). Replicated inputs keep the sharded run
       bit-identical to the single-device run.
    2. Multi-host. Host-side init logic (region_init's data-dependent
       first-positive search) reads these fields on the host, which a
       region shard held by another process would not allow; replicated
       fields stay host-readable everywhere.

    ``axis`` is kept for signature stability; placement is replicated."""
    from ..pipelines.core import device_batch
    return device_batch(batch, dtype, mesh.lead)[0]


def sharded_train_prescribe_step(mesh: Mesh, R: int, E: int, T_hist: int,
                                 horizon: int, n_npi: int = 12,
                                 dtype=None, backend: str = "lanes"):
    """Build and run ONE full train -> prescribe step over the mesh on tiny
    synthetic shapes: the multi-device validation entry.

    - training (two EKF rounds + NNLS regression): region inputs
      replicated (see shard_region_batch), each ekf3 call's region lanes
      split over the mesh
    - Pareto sweep (6-state optimal-control EKS): each chunk's
      (epsilon, region) lanes split over the mesh, epsilon-major

    backend: "lanes" or "pallas" (both run the EKS kernels, or their plain
    versions on CPU slots) or "vmap" (the generic core; only the sweep's
    lanes are split). dtype: of the replicated work (torch's default
    dtype when None). Returns a dict of small result tensors on the lead
    slot."""
    from ..control import epsilon_grid
    from ..data.preprocess import (NPI_MAXES_DEFAULT, build_region_batch,
                                   preprocess_region)
    from ..data.synthetic import synthetic_oxford_frame
    from ..pipelines.config import PipelineConfig
    from ..pipelines.core import (forecast_scenarios, pareto_prescribe,
                                  train_regions)

    fdtype = dtype or torch.get_default_dtype()
    cfg = PipelineConfig(pareto_chunk=E, num_monte_carlo=8,
                         backend=backend, smoother_gain="solve")

    _, _, truth = synthetic_oxford_frame(n_regions=R, n_days=T_hist, seed=0)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc), None, tr["u"],
                                      tr["pop"]))
        names.append(name)
    batch_train = shard_region_batch(mesh, build_region_batch(sers, names),
                                     dtype=fdtype)
    batch_full = shard_region_batch(
        mesh, build_region_batch(sers, names, horizon=horizon), dtype=fdtype)

    npi_mins = np.zeros(n_npi)
    npi_maxes = NPI_MAXES_DEFAULT[:n_npi]
    train_out = train_regions(batch_train, npi_mins, npi_maxes, T_hist, cfg,
                              dtype=fdtype, mesh=mesh)
    scen, s_hist = forecast_scenarios(
        batch_full, train_out.trained, train_out.init, np.ones(n_npi),
        npi_mins, npi_maxes, T_hist, cfg, dtype=fdtype, mesh=mesh)
    par = pareto_prescribe(
        batch_full, train_out.trained, train_out.init, s_hist,
        epsilon_grid(E).numpy(), np.ones(n_npi), npi_mins, npi_maxes,
        T_hist, cfg, dtype=fdtype, mesh=mesh)
    return {
        "a2": train_out.trained.a2,
        "J0": par["J0"], "J1": par["J1"],
        "J0_fixed": scen["fixed"].J0,
    }
