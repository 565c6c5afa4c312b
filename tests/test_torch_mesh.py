"""The port's mesh layer (parallel/mesh.py, ops/cuda/shard.py) against the
JAX package's: the counterparts of tests/test_mesh.py's seven tests, the
lane-block order of shard_lanes against JAX's NamedSharding, and ekf3_lanes
over eight CPU slots against one call, bit for bit.

The mesh's slots here are CPU slots (make_mesh(n, device="cpu")), the
counterpart of the JAX tests' eight virtual CPU devices: they run their
blocks in turn on the kernels' plain versions."""

import numpy as np
import pytest
import torch
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from epidemicmodeling_tpu.control import epsilon_grid as jax_epsilon_grid
from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.data.preprocess import (
    NPI_MAXES_DEFAULT, build_region_batch, preprocess_region)
from epidemicmodeling_tpu.parallel import make_mesh as jax_make_mesh

from epidemicmodeling_torch.ops.cuda import shard
from epidemicmodeling_torch.ops.cuda.ekf3_kernel import ekf3_lanes
from epidemicmodeling_torch.parallel import (Mesh, make_mesh,
                                             shard_batch_arrays)
from epidemicmodeling_torch.parallel.mesh import block_index
from epidemicmodeling_torch.pipelines import PipelineConfig, run_pipeline
from epidemicmodeling_torch.pipelines.core import (
    device_batch, ekf3_lane_inputs, pareto_prescribe, region_init,
    stage_params, train_regions)


def _batches(n_regions, seed=2):
    _, _, truth = synthetic_oxford_frame(n_regions=n_regions, n_days=80,
                                         seed=seed)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:70], None,
                                      tr["u"][:70], tr["pop"]))
        names.append(name)
    return (build_region_batch(sers, names),
            build_region_batch(sers, names, horizon=9))


def test_make_mesh_factorizes_evenly(monkeypatch):
    m = make_mesh(8, device="cpu")
    assert m.shape["dp"] * m.shape["ep"] == 8 == m.size
    assert m.shape["ep"] == 2                     # 8 -> (4, 2), as JAX's
    assert m.shape == dict(jax_make_mesh(8).shape)
    m3 = make_mesh(3, device="cpu")
    assert (m3.shape["dp"], m3.shape["ep"]) == (3, 1)
    # a device named several times gives as many slots, all of them local
    m5 = make_mesh(devices=["cpu"] * 5)
    assert m5.shape == {"dp": 5, "ep": 1} and len(m5.local_slots()) == 5
    assert m5.lead == torch.device("cpu")
    # no card: the default (every CUDA card) and CUDA slots raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 2)


def test_shard_batch_arrays_shards_divisible_leading_dim():
    mesh = make_mesh(8, device="cpu")
    dp = mesh.shape["dp"]
    a = np.arange(4 * dp * 7, dtype=float).reshape(4 * dp, 7)
    out = shard_batch_arrays(mesh, {"a": a, "scalar": np.float32(3.0)})
    assert out["a"].spec == ("dp", None)
    for (d, e), t in out["a"].shards.items():
        np.testing.assert_array_equal(t.numpy(), a[4 * d:4 * (d + 1)])
    # scalars replicate silently
    assert out["scalar"].spec == ()
    assert len(out["scalar"].shards) == 8


def test_shard_batch_arrays_strict_raises_on_indivisible():
    mesh = make_mesh(8, device="cpu")
    dp = mesh.shape["dp"]
    bad = {"a": np.zeros((4 * dp + 1, 2))}
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch_arrays(mesh, bad)


def test_shard_batch_arrays_nonstrict_warns_and_replicates():
    mesh = make_mesh(8, device="cpu")
    dp = mesh.shape["dp"]
    bad = {"a": np.arange(2 * (4 * dp + 1), dtype=float).reshape(-1, 2)}
    with pytest.warns(UserWarning, match="replicating"):
        out = shard_batch_arrays(mesh, bad, strict=False)
    assert out["a"].spec == ()
    for t in out["a"].shards.values():
        np.testing.assert_array_equal(t.numpy(), bad["a"])


def test_pipeline_mesh_rejects_indivisible_regions():
    bt, bf = _batches(3)
    with pytest.raises(ValueError, match="not divisible"):
        run_pipeline(bt, bf, None, 70, np.ones(12),
                     np.asarray(jax_epsilon_grid(4)), np.zeros(12),
                     NPI_MAXES_DEFAULT, 70,
                     PipelineConfig(backend="lanes", pareto_chunk=4),
                     dtype=torch.float64, mesh=make_mesh(8, device="cpu"))


def test_pipeline_mesh_rejects_indivisible_pareto_chunk():
    """pareto_chunk must divide the ep mesh axis: a clear message from
    run_pipeline and from the stage called directly."""
    bt, bf = _batches(4)
    mesh = make_mesh(8, device="cpu")   # ep = 2
    eps = np.asarray(jax_epsilon_grid(6))
    cfg = PipelineConfig(backend="lanes", pareto_chunk=3)
    with pytest.raises(ValueError, match="pareto_chunk"):
        run_pipeline(bt, bf, None, 70, np.ones(12), eps, np.zeros(12),
                     NPI_MAXES_DEFAULT, 70, cfg, dtype=torch.float64,
                     mesh=mesh)
    tr = train_regions(bt, np.zeros(12), NPI_MAXES_DEFAULT, 70, cfg,
                       dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="pareto_chunk"):
        pareto_prescribe(bf, tr.trained, tr.init, np.zeros((4, 70, 3)), eps,
                         np.ones(12), np.zeros(12), NPI_MAXES_DEFAULT, 70,
                         cfg, dtype=torch.float64, mesh=mesh)


def test_pad_for_mesh_per_device_tiles():
    """The port's pad rule: the kernels take any lane count and mask their
    ragged edge, so the pad is only to a multiple of the slot count (not to
    JAX's 128 / 1024-lane TPU tiles), and pad_lanes repeats lane 0."""
    assert shard.pad_for_mesh(235, None) == (1, 0)
    mesh = make_mesh(8, device="cpu")
    for B in (1, 7, 8, 235, 5875, 470_000):
        n, pad = shard.pad_for_mesh(B, mesh)
        assert n == 8 and (B + pad) % 8 == 0 and 0 <= pad < 8
    a = torch.arange(10.0).reshape(2, 5)
    padded = shard.pad_lanes(3)(a)
    assert torch.equal(padded[:, :5], a)
    assert torch.equal(padded[:, 5:], a[:, :1].expand(2, 3))
    assert shard.pad_lanes(0)(a) is a


@pytest.mark.parametrize("axis_order", [("ep", "dp"), ("dp", "ep")])
def test_shard_lanes_follows_jax_block_order(axis_order):
    """Lane block k of shard_lanes lands on the mesh slot at the position
    where JAX's NamedSharding(make_mesh(8), P(None, axis_order)) puts the
    device holding that block; the gather restores the lane order."""
    B = 24
    jmesh = jax_make_mesh(8)
    arr = jax.device_put(np.zeros((2, B)),
                         NamedSharding(jmesh, P(None, axis_order)))
    pos = {d: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
           for d in jmesh.devices.flat}
    jax_block = {pos[s.device]: s.index[1].start // (B // 8)
                 for s in arr.addressable_shards}
    mesh = make_mesh(8, device="cpu")
    assert {slot: block_index(mesh, slot, axis_order)[0]
            for slot, _ in mesh.local_slots()} == jax_block

    seen = []

    def run(x, y):
        seen.append(x[0].clone())
        return x * 2, y + 1

    x = torch.arange(3 * B, dtype=torch.float64).reshape(3, B)
    y = torch.arange(B, dtype=torch.float64)
    got = shard.shard_lanes(run, mesh, [x, y], axis_order, 2)
    assert torch.equal(got[0], x * 2) and torch.equal(got[1], y + 1)
    # one call a slot, in block order, each on its own block of 3 lanes
    assert [int(s[0]) // 3 for s in seen] == list(range(8))
    with pytest.raises(ValueError, match="equal blocks"):
        shard.shard_lanes(run, mesh, [x[:, :-1], y[:-1]], axis_order, 2)


def test_ekf3_lanes_on_the_mesh_is_bit_identical():
    """ekf3_lanes with its region lanes split over eight CPU slots (5 lanes
    padded to 8, one a slot) against one call."""
    bt, _ = _batches(5, seed=4)
    cfg = PipelineConfig(backend="pallas")
    b, fd, dev = device_batch(bt, torch.float64, "cpu")
    init = region_init(b, cfg, fd, dev)
    params = stage_params(cfg, b, None, np.zeros(12), NPI_MAXES_DEFAULT, fd,
                          dev)
    args = ekf3_lane_inputs(b.npis, b.observations, params,
                            b.obs_noise_var, init)
    one = ekf3_lanes(*args)
    mesh = make_mesh(8, device="cpu")
    sharded = ekf3_lanes(*args, mesh=mesh)
    for a, s in zip(one, sharded):
        assert s.shape == a.shape and torch.equal(s, a)
    # a one-slot mesh is the plain call
    assert all(torch.equal(a, s) for a, s in
               zip(one, ekf3_lanes(*args, mesh=Mesh(
                   np.array([[torch.device("cpu")]], dtype=object)))))
