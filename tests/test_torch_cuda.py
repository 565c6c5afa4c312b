"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the marker
``cuda``); this file imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q

B = 300 lanes is a multiple neither of ekf3's 24 lanes a block at T = 120
(ekf3_geometry) nor of ekf6's 32 lanes a block, so the ragged edge the
kernels mask is exercised; ekf6 is also run at B = 1 and B = 45.
Tolerances are those of the CPU tests (tests/test_ekf6_kernel.py:83-86,
188-190): both sides run float32 in a different operation order, and
roundoff compounds on the costates.

The spatial kernels: the stencil on ragged grids in both schemes and both
dtypes, at atol 3e-7 in float32 (the JAX package's bound, bench.py:448) and
rtol 1e-12 in float64 (the kernel computes each cell in the plain version's
order without fused multiply-adds, so it is expected to agree exactly); the
multi-step stencil bit for bit against its own one-step loop, and its
sparse injections and per-step weights against the plain version; the
pairwise forces at N = 300 (not a multiple
of 128) with and without obstacles, at atol 1e-5 * max|ref| (the CPU tests'
bound, tests/test_spatial.py:153-154): the kernel sums in source order, the
plain version in PyTorch's reduction order (a float32 sequential sum differs
from the plain version by 3.3e-7 of the largest force at N = 300, CPU run).

The native deployment artefact's card build (csrc/newcase_ekf.cu, float64,
compiled without fused multiply-adds) equals its CPU build bit for bit, the
sweep and the single-epsilon entry, through the device-pointer and the
host-pointer entries, at lane counts that are and are not multiples of its
16-lane blocks, and matches the sweep's plain version on the card
(prescriptions equal, J0 and J1 at rtol 1e-9); 2,000 lanes spread one
block to an SM, and the host-pointer entry's parts add up to its wall.

The NNLS kernel (csrc/nnls.cu, nnls_with_intercept for every region in one
launch) against its plain version: in float64 on random full-rank batches
(40 and 800 rows a problem) the same supports,
coefficients and intercepts within 1e-10 and each problem's iteration
counts equal to a run of the plain version on that problem alone; in
float32 on the smoke backtest's round-2 regression (235 x 380 x 12)
every problem's squared residual within chip_smoke's NNLS_F32_SSE_GAP of
the plain version's, which certifies any support that differs as
co-optimal; a collinear passive set gives NaN; its other forms and its
refusals.

The SI-alpha rollout kernel (csrc/rollout.cu, every schedule and region
of a rollout in one launch) against its plain version at the
xprize-pipeline-f64 cell's three call sites, float32 and float64; its
call under torch's sync debug mode "error"; its 12 launches in a warm
float64 run_pipeline at 250 epsilons in chunks of 25, with fewer than
2,500 device events in all; the float32 run_pipeline against its plain
versions (chip_smoke.small_reference_check).

The generic EKF/EKS core, the MATLAB-exact pinv, the other regressions and
the Rt estimator have no hand-written kernel: they run as tensor ops on the card
and are held against the same calls on the CPU in float64, at the
tolerances their CPU tests hold them to against the JAX package.
"""

import ctypes
import time

import numpy as np
import pytest
import torch

from epidemicmodeling_torch.deploy import (native as deploy_native,
                                           newcase_ekf_optimal_npi_native,
                                           newcase_ekf_pareto_sweep_native,
                                           pareto_sweep_plain)
from epidemicmodeling_torch.ops.cuda import (build, ekf3_kernel, ekf6_kernel,
                                             nnls_kernel, pairwise_kernel,
                                             roofline_kernel, rollout_kernel,
                                             stencil_kernel)
from epidemicmodeling_torch.ops.cuda.ekf3_kernel import ekf3, ekf3_plain
from epidemicmodeling_torch.ops.cuda.ekf6_kernel import ekf6, ekf6_plain
from epidemicmodeling_torch.ops.cuda.pairwise_kernel import (
    social_forces, social_forces_plain)
from epidemicmodeling_torch.ops.cuda.stencil_kernel import (
    STEPS_PER_LAUNCH, stencil, stencil_plain, stencil_rollout,
    stencil_rollout_plain)
from epidemicmodeling_torch.regression.nnls import (
    _masked_ls, nnls, nnls_with_intercept, nnls_with_intercept_plain)
from epidemicmodeling_torch.spatial import (PopulationSimConfig,
                                            diffusion_rollout,
                                            population_motion_sim)
from epidemicmodeling_torch.spatial.agents import default_environment
from epidemicmodeling_torch.spatial.walkers import walking_sources_sim
from epidemicmodeling_torch.control import epsilon_grid
from epidemicmodeling_torch.control.pareto import random_npi_schedules
from epidemicmodeling_torch.data import NPI_MAXES_DEFAULT
from epidemicmodeling_torch.pipelines import PipelineConfig
from epidemicmodeling_torch.pipelines.train_predict_prescribe import \
    run_pipeline
from epidemicmodeling_torch.utils.profiling import recording

from chip_smoke import (EKF3_BOUNDS, F64_BOUND, FILTER_TYPES, LM_COST_RTOL,
                        LM_RTOL,
                        NNLS_F32_SSE_GAP, PAIRWISE_ROW_BOUND,
                        backtest_regression, nnls_agreement,
                        SI_ROLLOUT_BOUNDS, SMALL_REF_BOUNDS,
                        copy_check_sizes, copy_into,
                        law_rows, lm_costs,
                        T_HIST, per_capita_case, pinv_ranks_agree, row_err,
                        rt_series, shooting_certificates, small_lstm_parity,
                        sweep_errs)
from tests._torch_helpers import (deploy_inputs, deploy_sweep_args,
                                  make_inputs, masked_err, nnls_problems,
                                  npi_levels, packed_args, reference_gaps,
                                  rollout_params, scaled_err,
                                  small_region_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf3_kernel_matches_plain(cuda, obs_type, beta):
    args = packed_args(3, make_inputs(3, B=300, T=120, T_hist=90, seed=3,
                                      obs_type=obs_type,
                                      dtype=np.float32), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    before = ekf3_kernel.launches
    ssm, sp, sm = ekf3(*args, **kw)
    torch.cuda.synchronize()
    assert ekf3_kernel.launches == before + 1
    r_ssm, r_sp, r_sm = ekf3_plain(*args, **kw)
    assert ekf3_kernel.launches == before + 1
    assert all(bool(torch.isfinite(o).all()) for o in (ssm, sp, sm))
    assert scaled_err(sp, r_sp) < 1e-4
    assert scaled_err(sm, r_sm) < 1e-4
    assert scaled_err(ssm, r_ssm) < 1e-3


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf6_kernel_matches_plain(cuda, obs_type, beta):
    T_hist = 64
    args = packed_args(6, make_inputs(6, B=300, T=96, T_hist=T_hist, seed=4,
                                      obs_type=obs_type,
                                      dtype=np.float32), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    before = ekf6_kernel.launches
    ssm, usm, sp = ekf6(*args, **kw)
    torch.cuda.synchronize()
    assert ekf6_kernel.launches == before + 1
    r_ssm, r_usm, r_sp = ekf6_plain(*args, **kw)
    assert bool(torch.isfinite(usm).all())
    assert bool(torch.isfinite(ssm[:, :3]).all())
    err, mismatch = masked_err(sp, r_sp)
    assert err < 1e-3 and mismatch <= 1e-3
    err, mismatch = masked_err(ssm, r_ssm)
    assert err < 1e-2 and mismatch <= 1e-3
    diff = (usm[T_hist:-1] != r_usm[T_hist:-1]).double().mean()
    assert float(diff) <= 5e-3
    assert bool((usm[-1] == 0).all())


@pytest.mark.parametrize("B", [1, 45])
@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf6_kernel_ragged_lanes(cuda, obs_type, beta, B):
    """ekf6 with B not a multiple of its 32 lanes a block (a single lane,
    and a block and a half), in both adaptive variants and both observation
    types, at test_ekf6_kernel_matches_plain's tolerances."""
    T_hist = 64
    args = packed_args(6, make_inputs(6, B=B, T=96, T_hist=T_hist, seed=8,
                                      obs_type=obs_type,
                                      dtype=np.float32), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    ssm, usm, sp = ekf6(*args, **kw)
    torch.cuda.synchronize()
    r_ssm, r_usm, r_sp = ekf6_plain(*args, **kw)
    assert ssm.shape == (96, 6, B) and usm.shape == (96, 12, B)
    assert bool(torch.isfinite(usm).all())
    err, mismatch = masked_err(sp, r_sp)
    assert err < 1e-3 and mismatch <= 1e-3
    err, mismatch = masked_err(ssm, r_ssm)
    assert err < 1e-2 and mismatch <= 1e-3
    diff = (usm[T_hist:-1] != r_usm[T_hist:-1]).double().mean()
    assert float(diff) <= 5e-3
    assert bool((usm[-1] == 0).all())


def test_kernels_refuse_what_they_cannot_take(cuda):
    args = packed_args(3, make_inputs(3, B=40, T=20, T_hist=15, seed=1,
                                      dtype=np.float32), cuda)
    with pytest.raises(ValueError, match="float32 or float64"):
        ekf3(*(a.half() for a in args))
    with pytest.raises(ValueError, match="one dtype"):
        ekf3(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ekf3(args[0].transpose(0, 2).contiguous().transpose(0, 2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ekf3(args[0][:, :, :30].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        ekf3(args[0], args[1].cpu(), *args[2:])
    args6 = packed_args(6, make_inputs(6, B=40, T=20, T_hist=15, seed=1,
                                       dtype=np.float32), cuda)
    with pytest.raises(ValueError, match="inv_monitor_len"):
        ekf6(*args6, beta=0.9, inv_monitor_len=0)
    with pytest.raises(ValueError, match="float32 or float64"):
        ekf6(*(a.bfloat16() for a in args6))


# The double instances against the plain versions in float64, at
# chip_smoke's F64_BOUND: the two differ in the order of the operations
# (the kernels' team products, ekf3's 1 / S formed once, its Joseph update
# times 1 / gd) and in nvcc's fused multiply-adds, which the plain
# version's separate operations round twice; each a few float64 ulps a step
# on well-conditioned inputs (these read <= 9e-12; on the CPU, where the
# sources run without fused multiply-adds, tests/test_torch_ekf_emulated.py
# reads <= 1.9e-14), so 1e-10, and every prescription equal.


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
@pytest.mark.parametrize("B,T", [(1, 440), (235, 532), (300, 120),
                                 (1000, 532)])
def test_ekf3_double_instance_matches_plain(cuda, B, T, obs_type, beta):
    """ekf3's double instance, one launch a call, at a single lane, the
    pipeline's width (records in shared memory, 2 lanes a block at T = 532)
    and B = 1,000 at T = 532 (records in the device-memory scratch)."""
    args = packed_args(3, make_inputs(3, B=B, T=T, T_hist=T - T // 5,
                                      seed=B + T, obs_type=obs_type), cuda)
    assert args[0].dtype == torch.float64
    g = ekf3_kernel.ekf3_geometry(T, B, 8)
    assert g.smem_hist == (B < 1000)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    before = ekf3_kernel.launches
    got = ekf3(*args, **kw)
    torch.cuda.synchronize()
    assert ekf3_kernel.launches == before + 1
    ref = ekf3_plain(*args, **kw)
    assert all(o.dtype == torch.float64 for o in got)
    assert all(bool(torch.isfinite(o).all()) for o in got)
    for a, b in zip(got, ref):
        assert scaled_err(a, b) < F64_BOUND


def _ekf6_f64_gaps(args, T_hist, kw):
    """ekf6's double instance against its plain version on the card: the
    scaled gaps of S_PLUS and S_SMOOTH where both are finite (asserting no
    cell finite in one only), and every prescription equal."""
    before = ekf6_kernel.launches
    ssm, usm, sp = ekf6(*args, **kw)
    torch.cuda.synchronize()
    assert ekf6_kernel.launches == before + 1
    r_ssm, r_usm, r_sp = ekf6_plain(*args, **kw)
    assert all(o.dtype == torch.float64 for o in (ssm, usm, sp))
    assert torch.equal(usm[T_hist:-1], r_usm[T_hist:-1])
    assert bool((usm[-1] == 0).all())
    gaps = []
    for got, ref in ((sp, r_sp), (ssm, r_ssm)):
        err, mismatch = masked_err(got, ref)
        assert mismatch == 0.0
        gaps.append(err)
    return gaps, r_ssm


@pytest.mark.parametrize("active", [False, True])
def test_ekf6_double_instance_matches_plain(cuda, active):
    """ekf6's double instance (its backward's shared memory dynamic) at the
    sweep chunk's shape, T = 532 x 5,875 lanes, on chip_smoke's per-capita
    inputs in float64 (well conditioned: states and costates finite; with
    control active a third of the cells switch to u_max): within F64_BOUND,
    every prescription equal."""
    d = per_capita_case(active)
    d = {k: ({kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
             if isinstance(v, dict) else np.asarray(v, np.float64))
         for k, v in d.items()}
    gaps, _ = _ekf6_f64_gaps(packed_args(6, d, cuda), T_HIST,
                             dict(gamma_discount=0.995))
    assert max(gaps) < F64_BOUND


@pytest.mark.parametrize("B", [1, 45, 300])
@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf6_double_instance_on_ill_conditioned_lanes(cuda, obs_type, beta,
                                                       B):
    """ekf6's double instance on make_inputs' lanes (a NaN future over a
    quarter of the window; at B = 300 some lanes' smoothed costates reach
    1e4-6e4, and their smoother's P- are fixed only to cond * eps): the
    filtered states within F64_BOUND, every prescription equal, and the
    smoothed states within three times the plain version's own spread
    between the card and the CPU (the same float64 arithmetic in another
    order: how far those lanes are fixed at all), or F64_BOUND where that is
    smaller. On the card the kernel read 0.53-1.34 times that spread where
    it passed 1e-10 (5.9e-3 at most)."""
    T_hist = 64
    args = packed_args(6, make_inputs(6, B=B, T=96, T_hist=T_hist, seed=B,
                                      obs_type=obs_type), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    (sp_gap, ssm_gap), r_ssm = _ekf6_f64_gaps(args, T_hist, kw)
    assert sp_gap < F64_BOUND
    cpu_ssm = ekf6_plain(*(a.cpu() for a in args), **kw)[0]
    spread, mismatch = masked_err(r_ssm, cpu_ssm.to(cuda))
    assert mismatch == 0.0
    assert ssm_gap <= max(F64_BOUND, 3 * spread)


def test_run_pipeline_in_float64_on_the_card_matches_the_reference(cuda):
    """run_pipeline in float64 at 20 regions over 120 + 20 days, 16
    epsilons in chunks of 4, 16 Monte-Carlo schedules (every smoothed
    costate finite, the control switching) on the normal path: the double
    ekf3 (4 launches) and ekf6 (one a chunk) instances, held stage by stage
    against the benchmark's plain reference (benchmark/reference/plain.py,
    float64 on the card) on the same inputs, from the program's own state
    (reference_gaps): the prescriptions and the front exactly; every cost
    and historic state within F64_BOUND relative (the kernels' fused
    multiply-adds). The trained coefficients against the reference's own
    training are not held here: over 120 days the 12 NPIs take 4 levels
    (30-day segments), so the regressions are degenerate and the NNLS
    kernel's active-set path parts from the plain version's on inputs equal
    to 1e-16 (a1 up to 0.06 apart in 3 of 40 regions on an H100); the
    xprize-pipeline-f64 cell holds them at 440 days."""
    T_hist, H, E = 120, 20, 16
    bt, bf, actual = small_region_inputs(n_regions=20, t_hist=T_hist,
                                         horizon=H)
    cfg = PipelineConfig(backend="pallas", pareto_chunk=4,
                         num_monte_carlo=16)
    eps = epsilon_grid(E).numpy()
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 16,
                                    np.zeros(12), NPI_MAXES_DEFAULT, H,
                                    dtype=torch.float64)
    before = ekf3_kernel.launches, ekf6_kernel.launches
    with recording() as rec:
        res = run_pipeline(bt, bf, actual, T_hist, np.ones(12), eps,
                           np.zeros(12), NPI_MAXES_DEFAULT, T_hist, cfg,
                           dtype=torch.float64, device=cuda,
                           u_random=u_random.to(cuda))
    made = (ekf3_kernel.launches - before[0],
            ekf6_kernel.launches - before[1])
    assert made == (4, E // 4)
    assert rec.counters["ekf3.launches"] == made[0]
    assert rec.counters["ekf6.launches"] == made[1]
    assert rec.counters["ekf6.lanes"] == E * 20
    assert rec.counters["ekf6.costate_nonfinite"] == 0
    assert res.pareto["J0"].dtype == torch.float64
    g = reference_gaps(res, bf, actual, T_hist, eps, u_random, cfg,
                       np.zeros(12), NPI_MAXES_DEFAULT, np.ones(12))
    assert g["costate_nonfinite"] == 0.0
    assert g["u_max_share_first_eps"] > 0.05          # the control switches
    assert g["sweep_flips"] == 0 and g["front_mismatch"] == 0
    for name in ("sweep_cost", "sweep_score", "scenarios", "mc", "s_hist"):
        assert g[name] <= F64_BOUND, (name, g[name])


AX, AY, AXY = 0.04, 0.0204, 0.0135


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(51, 51), (129, 131), (300, 257), (2, 9),
                                   (9, 1), (3, 70)])
def test_stencil_kernel_matches_plain(cuda, shape, dtype):
    C = torch.rand(shape, dtype=dtype, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(sum(shape)))
    tol = (dict(rtol=0, atol=3e-7) if dtype == torch.float32
           else dict(rtol=1e-12, atol=0))
    for axy in (0.0, AXY):
        before = stencil_kernel.launches
        got = stencil(C, AX, AY, axy)
        torch.cuda.synchronize()
        assert stencil_kernel.launches == before + 1
        ref = stencil_plain(C, AX, AY, axy)
        assert stencil_kernel.launches == before + 1
        assert got.device == C.device and got.dtype == dtype
        torch.testing.assert_close(got, ref, **tol)
        out = torch.full_like(C, float("nan"))
        assert stencil(C, AX, AY, axy, out=out) is out
        torch.testing.assert_close(out, got, rtol=0, atol=0)
        assert stencil_kernel.launches == before + 2


@pytest.mark.parametrize("with_obstacles", [True, False])
def test_pairwise_kernel_matches_plain(cuda, with_obstacles):
    cfg = PopulationSimConfig(n_subjects=300)
    _, obs = default_environment(cfg)
    if not with_obstacles:
        obs = np.zeros((0, 2))
    rng = np.random.default_rng(6)
    pos = rng.uniform([cfg.x_min, cfg.y_min], [cfg.x_max, cfg.y_max],
                      (300, 2))
    pos[1] = pos[0]                               # coincident agents
    pos[3] = pos[2] + [cfg.inter_subject_opt_dist, 0.0]   # sign(0) = 0
    for dtype in (torch.float32, torch.float64):
        p = torch.tensor(pos, dtype=dtype, device=cuda)
        o = torch.tensor(obs, dtype=dtype, device=cuda)
        before = pairwise_kernel.launches
        got = social_forces(p, o, cfg)
        torch.cuda.synchronize()
        assert pairwise_kernel.launches == before + 1
        ref = social_forces_plain(p, o, cfg)
        assert pairwise_kernel.launches == before + 1
        assert got.dtype == dtype and got.shape == (300, 2)
        assert bool(torch.isfinite(got).all())
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("N,O", [(1, 0), (1, 914), (700, 0), (3000, 914)])
def test_pairwise_kernel_edge_shapes(cuda, N, O):
    """One agent; N not a multiple of the 512 rows a block; no obstacles;
    sources spread over many chunks (pairwise_geometry: 1 to 24). Held row
    by row against the plain law at chip_smoke's bound, and two launches on
    the same input must agree bit for bit (fixed summation orders)."""
    cfg = PopulationSimConfig(n_subjects=N)
    _, obs = default_environment(cfg)
    rng = np.random.default_rng(N + O)
    pos = torch.tensor(rng.uniform([cfg.x_min, cfg.y_min],
                                   [cfg.x_max, cfg.y_max], (N, 2)),
                       dtype=torch.float32, device=cuda)
    o = torch.tensor(obs[:O], dtype=torch.float32, device=cuda).reshape(-1, 2)
    got = social_forces(pos, o, cfg)
    again = social_forces(pos, o, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = social_forces_plain(pos, o, cfg)
    _, scale, slack = law_rows(pos, o, cfg, torch.arange(N, device=cuda))
    assert row_err(got, ref, scale, slack) <= PAIRWISE_ROW_BOUND


def test_spatial_kernels_refuse_what_they_cannot_take(cuda):
    C = torch.rand((6, 7), device=cuda)
    with pytest.raises(ValueError, match="float32 or float64"):
        stencil(C.half(), AX, AY)
    with pytest.raises(ValueError, match="contiguous"):
        stencil(C.T, AX, AY)
    with pytest.raises(ValueError, match="out must"):
        stencil(C, AX, AY, out=torch.empty((6, 7)))
    with pytest.raises(ValueError, match="out must not"):
        stencil(C, AX, AY, out=C)
    cfg = PopulationSimConfig(n_subjects=20)
    pos = torch.rand((20, 2), device=cuda) * 10
    obs = torch.rand((5, 2), device=cuda) * 10
    with pytest.raises(ValueError, match="float32 or float64"):
        social_forces(pos.half(), obs, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        social_forces(pos.T.contiguous().T, obs, cfg)
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        social_forces(pos, obs.cpu(), cfg)
    with pytest.raises(ValueError, match="8-byte boundary"):
        social_forces(pos.reshape(-1)[1:39].reshape(19, 2), obs, cfg)


def test_spatial_entry_points_run_the_kernels(cuda):
    """The three spatial entry points on the card, without device=: on a
    card by default, through the kernels, ceil(n / K) stencil launches a
    rollout and one two-step launch a sim step; the agent
    sim against the same run on the CPU (float32 forces on both sides)."""
    C0 = np.zeros((64, 80))
    C0[30, 40] = 1.0
    k = STEPS_PER_LAUNCH[torch.float32]
    stencil_kernel.launches = 0
    traj = diffusion_rollout(C0, 1e-1, 0.01, 0.1, 0.1, 25, neighborhood=8,
                             dtype=torch.float32)
    assert traj.device.type == "cuda"
    assert stencil_kernel.launches == -(-25 // k)
    assert abs(float(traj[-1].sum()) - 1.0) < 1e-5
    stencil_kernel.launches = 0
    C, pos = walking_sources_sim(40, 40, 3, 30, 1e-2, 0.01, 0.1, 0.1, 1.0,
                                 torch.Generator(cuda).manual_seed(0))
    assert C.device.type == "cuda" and pos.shape == (30, 3, 2)
    assert stencil_kernel.launches == -(-30 // k)
    assert float(C.sum()) <= 90.0 * (1 + 1e-5)

    N, T = 300, 20
    cfg = PopulationSimConfig(n_subjects=N, force_backend="pallas")
    g = torch.Generator().manual_seed(3)
    init = dict(p_init=torch.rand((N, 2), generator=g, dtype=torch.float64)
                * torch.tensor([70.0, 50.0], dtype=torch.float64),
                v_init=torch.zeros((N, 2), dtype=torch.float64),
                a_init=torch.zeros((N, 2), dtype=torch.float64),
                j_init=torch.zeros((N, 2), dtype=torch.float64))
    noise = tuple(torch.randn((T, N, 2), generator=g, dtype=torch.float64)
                  for _ in range(4))
    pairwise_kernel.launches = stencil_kernel.launches = 0
    got = population_motion_sim(cfg, T, device=cuda, noise=noise, **init)
    assert pairwise_kernel.launches == T and stencil_kernel.launches == T
    ref = population_motion_sim(cfg, T, device="cpu", noise=noise, **init)
    # float32 forces summed in two orders: a near pair's O(1e3) terms cancel
    # to an O(1) acceleration, ~6e-5 of roundoff per step carried through
    # the integrators (a sequential float32 sum in place of the kernel moved
    # a by 2.6e-5 over these 20 steps on the CPU); the CPU tests hold the
    # same two float32 orders at 1e-4 (test_torch_spatial SIM_TOL "pallas")
    for f in ("p", "v", "a", "C"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(ref, f),
                                   rtol=0, atol=1e-4)


# --------------------------------------------- the multi-step stencil kernel

MULTI_N = {"1": lambda k: 1, "k-1": lambda k: k - 1, "k": lambda k: k,
           "3k+1": lambda k: 3 * k + 1}


@pytest.mark.parametrize("with_sources", [False, True])
@pytest.mark.parametrize("n_case", list(MULTI_N))
@pytest.mark.parametrize("shape", [(51, 51), (234, 167), (1000, 777),
                                   (2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_multistep_equals_the_one_step_loop(cuda, dtype, shape,
                                                    n_case, with_sources):
    """n steps in ceil(n / K) launches equal n launches of the one-step
    kernel bit for bit, every frame, both schemes, without and with dense
    sources (added before each step, as the loop adds them with PyTorch);
    and the plain version exactly (the same operations in the same order,
    no fused multiply-adds)."""
    k = STEPS_PER_LAUNCH[dtype]
    n = MULTI_N[n_case](k)
    g = torch.Generator(cuda).manual_seed(n + sum(shape))
    C = torch.rand(shape, dtype=dtype, device=cuda, generator=g)
    src = (1e-2 * torch.rand((n,) + shape, dtype=dtype, device=cuda,
                             generator=g) if with_sources else None)
    for axy in (0.0, AXY):
        frames = torch.empty((n,) + shape, dtype=dtype, device=cuda)
        before = stencil_kernel.launches
        last = stencil_rollout(C, n, (AX, AY, axy), sources=src,
                               frames=frames)
        assert stencil_kernel.launches == before + -(-n // k)
        assert last.data_ptr() == frames[-1].data_ptr()
        final = stencil_rollout(C, n, (AX, AY, axy), sources=src)
        cur, loop = C, []
        for t in range(n):
            cur = stencil(cur if src is None else cur + src[t], AX, AY, axy)
            loop.append(cur)
        plain = stencil_rollout_plain(C, n, (AX, AY, axy), sources=src)
        torch.cuda.synchronize()
        assert torch.equal(frames, torch.stack(loop))
        assert torch.equal(final, cur)
        assert torch.equal(final, plain)


@pytest.mark.parametrize("shape", [(51, 51), (1000, 777)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_sparse_injections_match_plain(cuda, dtype, shape):
    """70 injections a step over 3K + 1 steps, with duplicate cells (which
    sum in walker order), cells on the boundary and switched-off ones (-1),
    and injections on the first steps only, against the plain version on
    the CPU, which adds in walker order too: at 1e-12 of the field's
    largest value (expected exactly)."""
    Lx, Ly = shape
    k = STEPS_PER_LAUNCH[dtype]
    n, W = 3 * k + 1, 70
    rng = np.random.default_rng(Lx)
    cells = rng.integers(0, Lx * Ly, (n, W))
    cells[:, 5] = cells[:, 40] = cells[:, 3]
    cells[0, :10] = 0
    cells[1, 3] = -1
    cells[2, :5] = Ly - 1
    amounts = rng.random((n, W))
    C = torch.rand(shape, dtype=dtype, device=cuda)
    w = (AX, AY, AXY)
    for steps in (n, k + 1):
        c_t = torch.tensor(cells[:steps], dtype=torch.int32, device=cuda)
        a_t = torch.tensor(amounts[:steps], dtype=dtype, device=cuda)
        got = stencil_rollout(C, n, w, cells=c_t, amounts=a_t)
        ref = stencil_rollout_plain(C.cpu(), n, w, cells=c_t.cpu(),
                                    amounts=a_t.cpu())
        scale = float(ref.abs().max())
        assert float((got.cpu() - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_two_step_launch_equals_two_single_steps(cuda, dtype):
    """The agent sim's step: an injection of its marked agents, then a
    4-neighbour and an 8-neighbour step, in one launch with per-step
    weights, equal to the additions and two one-step launches bit for
    bit."""
    C = torch.rand((234, 167), dtype=dtype, device=cuda)
    cells = torch.tensor([[500, 500, 167 * 100 + 3]], dtype=torch.int32,
                         device=cuda)
    amounts = torch.ones((1, 3), dtype=dtype, device=cuda)
    before = stencil_kernel.launches
    got = stencil_rollout(C, 2, [(AX, AY, 0.0), (AX, AY, AXY)], cells=cells,
                          amounts=amounts)
    assert stencil_kernel.launches == before + 1
    x = C.clone()
    x.view(-1)[500] += 1.0
    x.view(-1)[500] += 1.0
    x.view(-1)[167 * 100 + 3] += 1.0
    ref = stencil(stencil(x, AX, AY, 0.0), AX, AY, AXY)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_stencil_rollout_refuses_what_it_cannot_take(cuda):
    C = torch.rand((30, 40), device=cuda)
    w = (AX, AY, AXY)
    with pytest.raises(ValueError, match="sources"):
        stencil_rollout(C, 3, w, sources=torch.rand((2, 30, 40), device=cuda))
    with pytest.raises(ValueError, match="cells"):
        stencil_rollout(C, 3, w, cells=torch.zeros((1, 4), dtype=torch.int64,
                                                   device=cuda),
                        amounts=torch.ones((1, 4), device=cuda))
    with pytest.raises(ValueError, match="amounts"):
        stencil_rollout(C, 3, w, cells=torch.zeros((1, 4), dtype=torch.int32,
                                                   device=cuda),
                        amounts=torch.ones((1, 4), dtype=torch.float64,
                                           device=cuda))
    with pytest.raises(ValueError, match="frames"):
        stencil_rollout(C, 3, w, frames=torch.empty((2, 30, 40), device=cuda))
    big = torch.empty((4, 30, 40), device=cuda)
    with pytest.raises(ValueError, match="overlap"):
        stencil_rollout(big[1], 3, w, frames=big[1:])
    # the field just before its frames is diffusion_rollout's layout
    stencil_rollout(big[0], 3, w, frames=big[1:])
    with pytest.raises(ValueError, match="weights"):
        stencil_rollout(C, 3, [w, w])
    with pytest.raises(ValueError, match="n_steps"):
        stencil_rollout(C, 0, w)


# -------------------------------------------------- ekf3 at the path's shapes

@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
@pytest.mark.parametrize("B,T", [(B, T) for B in (1, 31, 235, 1000)
                                 for T in (1, 440, 532)] + [(14100, 440)])
def test_ekf3_kernel_at_path_shapes(cuda, B, T, obs_type, beta):
    """ekf3 at the train and scenario lengths (T = 440, 532) and T = 1, at
    ragged B (at T = 440 and 532, B = 1000 keeps its step records in the
    device-memory scratch, the others in shared memory), and at the
    backtest's 235 x 60 (region, start) lanes at T = 440 (the scratch), both
    observation types, fixed and adaptive R: one launch a call, within
    chip_smoke's EKF3_BOUNDS of the plain version."""
    args = packed_args(3, make_inputs(3, B=B, T=T, T_hist=max(1, T - 92),
                                      seed=B + T, obs_type=obs_type,
                                      dtype=np.float32), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    before = ekf3_kernel.launches
    ssm, sp, sm = ekf3(*args, **kw)
    torch.cuda.synchronize()
    assert ekf3_kernel.launches == before + 1
    r_ssm, r_sp, r_sm = ekf3_plain(*args, **kw)
    assert all(bool(torch.isfinite(o).all()) for o in (ssm, sp, sm))
    assert scaled_err(sp, r_sp) < EKF3_BOUNDS["s_plus"]
    assert scaled_err(sm, r_sm) < EKF3_BOUNDS["s_plus"]
    assert scaled_err(ssm, r_ssm) < EKF3_BOUNDS["s_smooth"]


def test_ekf3_geometry_matches_the_library(cuda):
    """ekf3_kernel.ekf3_geometry restates csrc/ekf3.cu's choice of lanes a
    block: the two agree in every branch."""
    lib = build.load("ekf3", ekf3_kernel._SIGNATURES)
    fn = lib.ekf3_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = None
    for T in (1, 7, 8, 440, 532, 3000, 4000):
        for B in (1, 31, 235, 1000, 5875):
            out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                   ctypes.c_longlong()]
            fn(T, B, *(ctypes.byref(o) for o in out))
            g = ekf3_kernel.ekf3_geometry(T, B)
            assert (out[0].value, out[1].value, bool(out[2].value),
                    out[3].value) == (g.lanes, g.blocks, g.smem_hist,
                                      g.smem_bytes)


def test_roofline_kernels_match_plain(cuda):
    """The copy (a persistent ring of TMA bulk copies): the library's launch
    geometry equals roofline_kernel.copy_geometry, and roofline_copy through
    its C entry writes x + 1 bit for bit into a NaN-filled output (a skipped
    chunk or tail would leave NaN) at the schedule's ragged sizes and 1 GiB;
    then both wrappers against their plain versions."""
    lib = build.load("roofline", roofline_kernel._SIGNATURES)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in copy_check_sizes(sms):
        assert (roofline_kernel.library_copy_geometry(n)
                == roofline_kernel.copy_geometry(n, sms)), n
        x = torch.rand(n, device=cuda)
        out = torch.full_like(x, float("nan"))
        copy_into(lib, x, out)
        torch.cuda.synchronize()
        assert torch.equal(out, x + 1), n
    x = torch.rand(1 << 20, device=cuda)
    before = roofline_kernel.launches
    assert torch.equal(roofline_kernel.copy_plus_one(x), x + 1)
    got = roofline_kernel.fma_chain(x).double()
    assert roofline_kernel.launches == before + 2
    ref = roofline_kernel.fma_chain_plain(x).double()
    assert float(((got - ref).abs() / ref.abs()).max()) <= (
        roofline_kernel.DEPTH + 1) * 2.0 ** -24
    with pytest.raises(ValueError, match="4k"):
        roofline_kernel.copy_plus_one(x[:7])
    with pytest.raises(ValueError, match="float32"):
        roofline_kernel.fma_chain(x.double())


# ------------------------------------------- the XPRIZE CLI on the card


def test_cli_runs_both_kernels_on_the_card(cuda, tmp_path):
    """The port's CLI end to end on a small CSV without --device: it runs on
    the card with --backend pallas, launching ekf3 (train, scenarios) and
    ekf6 (the sweep), and writes integer prescriptions in [0, max]."""
    from epidemicmodeling_torch.data import (NPI_MAXES_DEFAULT,
                                             OXFORD_NPI_COLUMNS,
                                             synthetic_oxford_frame,
                                             write_oxford_csvs)
    from epidemicmodeling_torch.data.csvio import (parse_floats,
                                                   read_csv_columns)
    from epidemicmodeling_torch.pipelines.xprize_cli import main

    files = write_oxford_csvs(tmp_path, *synthetic_oxford_frame(
        n_regions=5, n_days=150, seed=2)[:2])
    ekf3_before, ekf6_before = ekf3_kernel.launches, ekf6_kernel.launches
    assert main(["--data", files["data"], "--geos", files["geos"],
                 "--populations", files["populations"],
                 "--start-train", "2020-03-01", "--end-train", "2020-06-30",
                 "--end-predict", "2020-07-28", "--num-epsilon", "8",
                 "--pareto-chunk", "4", "--num-monte-carlo", "16",
                 "--backend", "pallas",
                 "--prescriptions-out", str(tmp_path / "presc.csv"),
                 "--predictions-out", str(tmp_path / "pred.csv")]) == 0
    assert ekf3_kernel.launches - ekf3_before == 4
    assert ekf6_kernel.launches - ekf6_before == 2
    cols = read_csv_columns(tmp_path / "presc.csv")
    u = np.stack([parse_floats(cols[c]) for c in OXFORD_NPI_COLUMNS], 1)
    assert u.shape == (8 * 5 * 28, 12)
    assert (u == np.round(u)).all() and (u >= 0).all()
    assert (u <= NPI_MAXES_DEFAULT).all()
    pred = parse_floats(read_csv_columns(tmp_path / "pred.csv")[
        "PredictedDailyNewCases"])
    assert np.isfinite(pred).all() and (pred >= 0).all()


def _batch_first(d):
    """make_inputs' lanes-last arrays as the generic core's batch-first
    tensors (float64, CPU)."""
    t = lambda a: torch.movedim(torch.tensor(a), -1, 0)
    return dict(u=torch.tensor(d["u"]).permute(2, 0, 1),
                x=torch.tensor(d["x"]).T, R=torch.tensor(d["Rv"]).T,
                params={k: t(v) for k, v in d["params"].items()},
                s_init=t(d["s_init"]), Ps_init=t(d["Ps_init"]),
                s_final=t(d["s_final"]), Ps_final=t(d["Ps_final"]),
                Q=t(d["Q"]))


@pytest.mark.parametrize("outputs", ["full", "light"])
@pytest.mark.parametrize("gain", ["pinv", "solve"])
@pytest.mark.parametrize("m", [3, 6])
def test_generic_core_on_the_card_matches_the_cpu(cuda, m, gain, outputs):
    """The generic EKF/EKS core (ops/ekf.py) on the card against the same
    call on the CPU, float64, B = 300 lanes: the CPU tests' tolerances
    against the JAX package (rtol 1e-9 / atol 1e-12; the costate system
    rtol 1e-4 / atol 1e-8, its inputs exactly). The 3-state system on
    make_inputs' lanes (NaN holes and a NaN future); the costate system on
    chip_smoke's per-capita inputs with active control (T = 532), whose
    prior covariances stay below cond 1e8. Where they reach cond ~1e17 (the
    NaN future of make_inputs' costate lanes, the XPRIZE sweep) the gains
    are fixed only to cond * eps on either device, and the card and the CPU
    part (chip_smoke.vmap_reference_check, PERF.md)."""
    from epidemicmodeling_torch.models import (si_alpha_costate_ekf_system,
                                               si_alpha_ekf_system)
    from epidemicmodeling_torch.ops import ekf_smoother
    if m == 3:
        d = _batch_first(make_inputs(3, 300, 120, 90, seed=7))
        system = si_alpha_ekf_system("NEWCASES")
    else:
        cp = per_capita_case(True)
        cp = dict({k: np.asarray(v, np.float64) for k, v in cp.items()
                   if k != "params"},
                  params={k: np.asarray(v, np.float64)[..., :300]
                          for k, v in cp["params"].items()})
        d = _batch_first({k: v if k == "params" else v[..., :300]
                          for k, v in cp.items()})
        system = si_alpha_costate_ekf_system("NEWCASES")
    run = lambda dev: ekf_smoother(
        system, d["u"].to(dev), d["x"].to(dev),
        {k: v.to(dev) for k, v in d["params"].items()}, d["s_init"].to(dev),
        d["Ps_init"].to(dev), d["s_final"].to(dev), d["Ps_final"].to(dev),
        Q=d["Q"].to(dev), R=d["R"].to(dev), gamma_discount=0.995,
        smoother_gain=gain, outputs=outputs)
    got, ref = run("cuda"), run("cpu")
    tol = (dict(rtol=1e-9, atol=1e-12) if m == 3
           else dict(rtol=1e-4, atol=1e-8))
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None:
            assert getattr(got, f) is None
            continue
        torch.testing.assert_close(getattr(got, f).cpu(), r, equal_nan=True,
                                   **tol, msg=lambda m, f=f: f"{f}: {m}")
    assert torch.equal(got.u_opt_smooth.cpu(), ref.u_opt_smooth)


@pytest.mark.parametrize("cond", [1e6, 1e14, 1e15, 1e16])
def test_matlab_pinv_on_the_card(cuda, cond):
    """MATLAB's pinv cutoff on the card (cuSOLVER's batched Jacobi SVD) on
    tests/test_matlab_pinv.py's knife-edge inputs, float64, against the
    CPU (chip_smoke.pinv_ranks_agree): the same kept rank, or a differing
    one only where a singular value lies within the SVD's own error of the
    cutoff; values within kappa * 1e-12 of their scale where the ranks
    agree. At cond 1e6 the ranks must agree."""
    from epidemicmodeling_torch.ops.ekf import _matlab_pinv
    rng = np.random.default_rng(1)
    mats = []
    for _ in range(5):
        q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        mats.append((q * np.logspace(0, -np.log10(cond), 6)) @ q.T)
    A = torch.tensor(np.stack(mats))
    got, ref = _matlab_pinv(A.cuda()).cpu(), _matlab_pinv(A)
    for k in range(5):
        agree, ok = pinv_ranks_agree(got[k], ref[k], A[k])
        assert ok and (agree or cond > 1e6), (cond, k)


def test_regressions_on_the_card_match_the_cpu(cuda):
    """lasso_cv and the element-wise robust fits, batched over regions, on
    the card against the CPU, float64: the lasso at rtol 1e-9 / atol 1e-10
    (its stopping tolerance is 1e-10), the robust fits at rtol 1e-9 /
    atol 1e-12; the selected lambda exactly."""
    from epidemicmodeling_torch.regression import (
        lasso_cv, robust_affine_fit_elementwise)
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.integers(0, 4, (4, 40, 12)).astype(float))
    y = (X @ torch.tensor(0.02 * rng.random((4, 12, 1))))[..., 0] + 0.1 \
        + torch.tensor(0.002 * rng.standard_normal((4, 40)))
    c_g, i_g, info_g = lasso_cv(X.cuda(), y.cuda(), n_folds=8, n_lambda=20)
    c_c, i_c, info_c = lasso_cv(X, y, n_folds=8, n_lambda=20)
    assert torch.equal(info_g["index_min"].cpu(), info_c["index_min"])
    torch.testing.assert_close(c_g.cpu(), c_c, rtol=1e-9, atol=1e-10)
    torch.testing.assert_close(i_g.cpu(), i_c, rtol=1e-9, atol=1e-10)
    a_g, b_g = robust_affine_fit_elementwise(X.cuda(), y.cuda())
    a_c, b_c = robust_affine_fit_elementwise(X, y)
    torch.testing.assert_close(a_g.cpu(), a_c, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(b_g.cpu(), b_c, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [40, 800])
@pytest.mark.parametrize("seed", [0, 1])
def test_nnls_kernel_float64_matches_plain(cuda, seed, n):
    """Float64: the same supports, coefficients and intercepts within 1e-10
    of the plain version on the card, at 40 and 800 rows a problem. The
    route makes no host sync and one launch."""
    X, y = (t.to(cuda) for t in nnls_problems(seed, n=n))
    with recording() as rec:
        a, b = nnls_with_intercept(X, y)
    a_p, b_p = nnls_with_intercept_plain(X, y)
    assert torch.equal(a > 0, a_p > 0)
    torch.testing.assert_close(a, a_p, rtol=0, atol=1e-10)
    torch.testing.assert_close(b, b_p, rtol=0, atol=1e-10)
    assert rec.counters["host_sync"] == 0
    assert rec.counters["nnls.launches"] == 1


def test_nnls_kernel_counts_equal_per_problem_plain_runs(cuda):
    """Each problem's outer, inner and intercept iterations equal the
    plain version's loop trips on that problem alone (float64, CPU), and
    the recording's lane counters are their totals."""
    X, y = nnls_problems(2)
    _, _, counts = nnls_kernel.nnls_intercept(X.to(cuda), y.to(cuda), 100)
    want = []
    for r in range(X.shape[0]):
        with recording() as rec:
            nnls_with_intercept(X[r:r + 1], y[r:r + 1])
        want.append([rec.counters.get(k, 0) for k in
                     ("nnls.outer", "nnls.inner", "nnls.intercept")])
    assert counts.tolist() == want
    assert counts[:, 1].sum() > 0          # the inner loop ran
    with recording() as rec:
        nnls_with_intercept(X.to(cuda), y.to(cuda))
    assert [rec.counters[f"nnls.lane_{k}"] for k in
            ("outer", "inner", "intercept")] == counts.sum(0).tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_nnls_kernel_float32_at_the_cell(cuda, seed):
    """Float32 on the smoke backtest's round-2 regression, at the
    xprize-backtest cell's size (235 x 380 x 12, strided views as the
    training passes them): every problem's
    squared residual within NNLS_F32_SSE_GAP of the plain version's on
    the card, so a support that differs is a co-optimal solution."""
    X, y = backtest_regression(cuda, seed)
    assert X.shape == (235, 380, 12) and not y.is_contiguous()
    got = nnls_with_intercept(X, y)
    agree = nnls_agreement(X, y, got, nnls_with_intercept_plain(X, y))
    assert agree["sse_gap"] <= NNLS_F32_SSE_GAP, agree


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nnls_kernel_collinear_passive_set_poisons_with_nan(cuda, dtype):
    """The kernel's masked solve on tests/test_torch_nnls.py's collinear
    passive set (every Cholesky step exact, the second pivot exactly 0):
    NaN in every column, as _masked_ls; a regular passive set solves as
    _masked_ls does."""
    rng = np.random.default_rng(0)
    X = np.zeros((30, 12))
    X[:3, 4] = X[:3, 5] = [1.0, 2.0, 2.0]
    X[3, 1] = 4.0
    X[:, [0, 2, 3, 6, 7, 8, 9, 10, 11]] = rng.standard_normal((30, 9))
    y = rng.standard_normal(30)
    G = torch.tensor(X.T @ X, dtype=dtype, device=cuda)[None]
    c = torch.tensor(X.T @ y, dtype=dtype, device=cuda)[None]
    P = torch.zeros((1, 12), dtype=torch.bool, device=cuda)
    P[0, [1, 4, 5]] = True
    assert torch.isnan(nnls_kernel.masked_solve(G, c, P)).all()
    assert torch.isnan(_masked_ls(G, c, P)).all()
    P[0, 5] = False
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(nnls_kernel.masked_solve(G, c, P),
                               _masked_ls(G, c, P), rtol=tol, atol=tol)


def test_nnls_kernel_forms_and_refusals(cuda):
    """iterations = 0 is nnls; the unbatched form is the batch of one; p =
    32 (a lane each) matches the plain version; a side stream is taken;
    p = 33, float16 and a CPU tensor on the card's route are refused."""
    X, y = (t.to(cuda) for t in nnls_problems(3, R=6))
    a0, b0 = nnls_with_intercept(X, y, iterations=0)
    assert torch.equal(a0, nnls(X, y)) and not b0.any()
    a, b = nnls_with_intercept(X, y)
    a1, b1 = nnls_with_intercept(X[2], y[2])
    assert torch.equal(a1, a[2]) and torch.equal(b1, b[2])
    torch.testing.assert_close(nnls(X[2], y[2]), nnls_with_intercept_plain(
        X[2:3], y[2:3], 0)[0][0], rtol=0, atol=1e-10)
    X32, y32 = (t.to(cuda) for t in nnls_problems(4, R=3, n=60, p=32))
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        a32, b32 = nnls_with_intercept(X32, y32)
    side.synchronize()
    a32_p, b32_p = nnls_with_intercept_plain(X32, y32)
    torch.testing.assert_close(a32, a32_p, rtol=0, atol=1e-10)
    torch.testing.assert_close(b32, b32_p, rtol=0, atol=1e-10)
    X33, y33 = (t.to(cuda) for t in nnls_problems(4, R=3, n=60, p=33))
    with pytest.raises(ValueError, match="1 to 32 columns"):
        nnls_with_intercept(X33, y33)
    with pytest.raises(ValueError, match="float32 or float64"):
        nnls_with_intercept(X.half(), y.half())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        nnls_kernel.nnls_intercept(X, y.cpu(), 100)


@pytest.mark.parametrize("order", [1, 2])
def test_rt_estimator_on_the_card_matches_the_cpu(cuda, order):
    """rt_expfit_ekf (the order-2 consumer of the core) on the card
    against the CPU, float64, at rtol 1e-9 / atol 1e-12."""
    from epidemicmodeling_torch.rt import rt_expfit_ekf
    rng = np.random.default_rng(5)
    x = 5.0 * np.exp(0.03 * np.arange(90)) * np.exp(
        0.03 * rng.standard_normal(90))
    x[40:45] = np.nan
    kw = dict(s_init=np.array([5.0, 0.0]), time_scale=1.0, alpha=0.9,
              sigma=5.0, w_bar=np.array([0.0, 0.01]), v_bar=np.zeros(1),
              Ps_init=np.diag([1.0, 0.1]), Q_w=np.diag([1e-2, 1e-4]),
              R_v=np.array([[1e-2]]), beta=0.9, gamma=0.995, order=order)
    got = rt_expfit_ekf(x, device="cuda", **kw)
    ref = rt_expfit_ekf(x, device="cpu", **kw)
    for f in ref._fields:
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(ref, f),
                                   rtol=1e-9, atol=1e-12, equal_nan=True,
                                   msg=lambda m, f=f: f"{f}: {m}")


def _ar_test_series(T=240):
    rng = np.random.default_rng(6)
    y = np.zeros(T)
    e = 0.1 * rng.standard_normal(T)
    for t in range(2, T):
        y[t] = 1.5 * y[t - 1] - 0.7 * y[t - 2] + e[t]
    return y + 0.5 * np.sin(0.05 * np.arange(T))


def test_ar_and_rollouts_on_the_card_match_the_cpu(cuda):
    """ar_fit (fb, ls), ar_fit_burg, ar_forecast (with passed-in draws) and
    both SI rollouts, from NumPy inputs without device= (so on the card),
    against device="cpu", float64: the AR pieces at rtol 1e-10, the
    rollouts at rtol 1e-12 (the CPU tests' bounds against the JAX
    package)."""
    from epidemicmodeling_torch.models import (si_alpha_controlled_rollout,
                                               si_controlled_rollout)
    from epidemicmodeling_torch.ops import ar_fit, ar_fit_burg, ar_forecast
    y = _ar_test_series()
    z = np.random.default_rng(1).standard_normal(30)
    a8 = ar_fit(y, 8, device="cpu")[0].numpy()
    for run in (lambda **d: ar_fit(y, 8, "fb", **d),
                lambda **d: ar_fit(y, 8, "ls", **d),
                lambda **d: ar_fit_burg(y, 8, **d),
                lambda **d: (ar_forecast(y, a8, 0.01, 30, noise=z, **d),)):
        got, ref = run(), run(device="cpu")
        for g, r in zip(got, ref):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), r, rtol=1e-10, atol=0)
    rng = np.random.default_rng(2)
    kw = dict(s0=0.99, i0=1e-3, alpha0=0.4, u_max=np.full(12, 3.0),
              alpha_min=1e-8, alpha_max=100.0, gamma=1 / 7,
              a=0.004 * rng.random(12), b=0.2, beta=0.2, s_noise_std=1e-4,
              i_noise_std=1e-5, alpha_noise_std=1e-3, K=70, dt=1.0)
    u = rng.integers(0, 3, (70, 12)).astype(float)
    noise = rng.standard_normal((70, 3))
    alpha = 0.3 + 0.05 * rng.standard_normal(60)
    for run in (lambda **d: si_alpha_controlled_rollout(u, noise=noise,
                                                        **kw, **d),
                lambda **d: si_controlled_rollout(alpha, 0.2, 0.99, 1e-3, 60,
                                                  1.0, **d)):
        got, ref = run(), run(device="cpu")
        for g, r in zip(got, ref):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), r, rtol=1e-12, atol=0)


def test_ar_alpha_prescription_on_the_card_matches_the_cpu(cuda):
    """ar_alpha_prescription from the same draws on the card (its default)
    and on the CPU, float64, at rtol 1e-9 / atol 1e-12."""
    from epidemicmodeling_torch.control.pareto import npi_level_draws
    from epidemicmodeling_torch.pipelines.prescribe import \
        ar_alpha_prescription
    rng = np.random.default_rng(2)
    maxes = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4])
    g = torch.Generator().manual_seed(3)
    kw = dict(alpha_train=0.2 + 0.05 * np.sin(0.05 * np.arange(200))
              + 0.005 * rng.standard_normal(200),
              a_coef=0.004 * rng.random(12), b_coef=0.05, beta_model=0.2,
              gamma_model=1 / 7, npi_mins=np.zeros(12), npi_maxes=maxes,
              npi_weights=np.ones(12), s0=0.99, i0=1e-3, n_ahead=30,
              n_monte_carlo=8,
              ar_noise=torch.randn(30, generator=g,
                                   dtype=torch.float64).numpy(),
              u_draw=npi_level_draws(g, (8, 30, 12), np.zeros(12),
                                     maxes).numpy())
    got, ref = ar_alpha_prescription(**kw), ar_alpha_prescription(
        **kw, device="cpu")
    for f in ref._fields:
        assert getattr(got, f).device.type == "cuda"
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(ref, f),
                                   rtol=1e-9, atol=1e-12,
                                   msg=lambda m, f=f: f"{f}: {m}")


def test_new_case_ekf_optimal_npi_on_the_card_matches_the_cpu(cuda):
    """The pre-generic 6-state EKS on chip_smoke's per-capita inputs with
    active control (100 lanes, T = 532, every P- below cond 1e8), adaptive
    R (beta 0.9), float64, from NumPy inputs (so on the card) against the
    same on the CPU: the prescriptions equal, the epidemic states at rtol
    1e-9 / atol 1e-12, the costates and covariances at the costate bound
    rtol 1e-4 / atol 1e-8 (tests/test_torch_ekf_generic.py)."""
    from epidemicmodeling_torch.pipelines.prescribe import \
        new_case_ekf_optimal_npi
    cp = per_capita_case(True)
    t = lambda a: np.moveaxis(np.asarray(a, np.float64), -1, 0)[:100]
    args = dict(u=np.asarray(cp["u"], np.float64).transpose(2, 0, 1)[:100],
                x=t(cp["x"]),
                params={k: t(v) for k, v in cp["params"].items()},
                s_init=t(cp["s_init"]), Ps_init=t(cp["Ps_init"]),
                s_final=t(cp["s_final"]), Ps_final=t(cp["Ps_final"]),
                Q=t(cp["Q"]), R=t(cp["Rv"]), beta=0.9, gamma=0.995)
    got = new_case_ekf_optimal_npi(**args)
    ref = new_case_ekf_optimal_npi(**args, device="cpu")
    assert got.s_smooth.device.type == "cuda"
    assert torch.equal(got.u_opt_smooth.cpu(), ref.u_opt_smooth)
    for f in ("s_minus", "s_plus", "s_smooth"):
        g, r = getattr(got, f).cpu(), getattr(ref, f)
        torch.testing.assert_close(g[..., :3], r[..., :3], rtol=1e-9,
                                   atol=1e-12)
        torch.testing.assert_close(g[..., 3:], r[..., 3:], rtol=1e-4,
                                   atol=1e-8)
    torch.testing.assert_close(got.P_smooth.cpu(), ref.P_smooth, rtol=1e-4,
                               atol=1e-8)


def _deaths_batches(n_regions, t_hist, horizon, seed):
    """Synthetic regions with their cumulative deaths (1% of the cases):
    (training batch, full batch, the generating coefficients)."""
    from epidemicmodeling_torch.data import (build_region_batch,
                                             preprocess_region,
                                             synthetic_regions)
    truth = synthetic_regions(n_regions, t_hist + horizon, seed=seed)
    sers = []
    for tr in truth.values():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:t_hist],
                                      np.cumsum(0.01 * nc)[:t_hist],
                                      tr["u"][:t_hist], tr["pop"]))
    names = list(truth)
    a = np.stack([tr["a"] for tr in truth.values()])
    b = np.array([tr["b"] for tr in truth.values()])
    coefs = dict(names=names, population=[tr["pop"] for tr in
                                          truth.values()],
                 a1=a, b1=b, a2=a, b2=b)
    return (build_region_batch(sers, names),
            build_region_batch(sers, names, horizon=horizon), coefs)


def test_train_npi_prescriptor_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The training entry point with its default configuration (the
    generic core, NNLS) on the card (its default) against the CPU, float64,
    on a full-rank regression design (400 days: more NPI level changes than
    NPIs): coefficients, smoothed states and mortality estimates at rtol
    1e-9 / atol 1e-12; its .npz holds the card's coefficients."""
    from epidemicmodeling_torch.data import NPI_MAXES_DEFAULT
    from epidemicmodeling_torch.pipelines import (load_trained_params,
                                                  train_npi_prescriptor)
    bt, _, _ = _deaths_batches(3, 400, 0, seed=5)
    ckpt = str(tmp_path / "params.npz")
    got = train_npi_prescriptor(bt, np.zeros(12), NPI_MAXES_DEFAULT, 400,
                                trained_params_file=ckpt,
                                dtype=torch.float64)
    ref = train_npi_prescriptor(bt, np.zeros(12), NPI_MAXES_DEFAULT, 400,
                                dtype=torch.float64, device="cpu")
    for k in ("a1", "b1", "a2", "b2"):
        g = getattr(got[0].trained, k)
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), getattr(ref[0].trained, k),
                                   rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(got[0].s_smooth_round2.cpu(),
                               ref[0].s_smooth_round2, rtol=1e-9, atol=1e-12)
    for f in ref[1]._fields:
        np.testing.assert_allclose(getattr(got[1], f), getattr(ref[1], f),
                                   rtol=1e-9, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(load_trained_params(ckpt).a2,
                                  got[0].trained.a2.cpu().numpy())


def test_prescribe_from_checkpoint_runs_ekf6_on_the_card(cuda):
    """prescribe_from_checkpoint with the kernel backend from NumPy batches
    (so on the card: one ekf6 launch a chunk) against the same call on the
    CPU (the plain versions), float32, from the generating coefficients, at
    chip_smoke's SMALL_REF_BOUNDS. Not float64: the kernels are float32,
    and on this synthetic data the sweep's prior covariances reach cond
    ~1e17, where the generic core's card and CPU gains part (ROADMAP Queue
    C)."""
    from epidemicmodeling_torch.control import epsilon_grid
    from epidemicmodeling_torch.data import NPI_MAXES_DEFAULT
    from epidemicmodeling_torch.pipelines import (
        PipelineConfig, prescribe_from_checkpoint, trained_params_from_numpy)
    from epidemicmodeling_torch.pipelines.core import (device_batch,
                                                       forecast_scenarios,
                                                       region_init)
    bt, bf, coefs = _deaths_batches(6, 100, 20, seed=1)
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=8, num_monte_carlo=16)
    u_random = torch.randint(0, 3, (16, 20, 12),
                             generator=torch.Generator().manual_seed(0))

    def run(dev):
        tr = trained_params_from_numpy(coefs, torch.float32, dev)
        init = region_init(device_batch(bt, torch.float32, dev)[0], cfg,
                           torch.float32, dev)
        _, s_hist = forecast_scenarios(bf, tr, init, np.ones(12),
                                       np.zeros(12), NPI_MAXES_DEFAULT, 100,
                                       cfg, dtype=torch.float32, device=dev)
        # NumPy batches, no device= for the card
        return prescribe_from_checkpoint(
            tr, bf, s_hist.cpu().numpy(), init, epsilon_grid(32).numpy(),
            np.ones(12), np.zeros(12), NPI_MAXES_DEFAULT, 100, cfg,
            dtype=torch.float32, device=None if dev == "cuda" else dev,
            u_random=u_random.float())

    before = ekf6_kernel.launches
    kp, km = run("cuda")
    assert ekf6_kernel.launches - before == 4
    pp, pm = run("cpu")
    assert kp["u_prescribed"].device.type == "cuda"
    for k, v in sweep_errs(kp, pp, km, pm).items():
        assert v <= SMALL_REF_BOUNDS[k], (k, v)


def test_rt_and_smoothing_on_the_card_match_the_cpu(cuda):
    """The three windowed Rt estimators, both moving averages, Tikhonov
    and smooth_series's five filter types, from NumPy inputs (so on the
    card) against device="cpu", float64, at rtol 1e-9 / atol 1e-12; the
    nonlinear least squares at chip_smoke's LM_RTOL and by co-optimality
    (its LM fixes a fit only to ~1e-9)."""
    from epidemicmodeling_torch.ops import smooth_series, tikhonov_smooth
    from epidemicmodeling_torch.rt import (rt_expfit_gen_ratios,
                                           rt_expfit_log_lin_reg,
                                           rt_expfit_nonlin_ls)
    from epidemicmodeling_torch.utils import (causal_moving_average,
                                              filtfilt_ma)
    x = rt_series()
    x2 = x.copy()
    x2[60] = 0.0
    tol = dict(rtol=1e-9, atol=1e-12, equal_nan=True)
    runs = [lambda **d: rt_expfit_gen_ratios(x2, 7, 3, 1.0, **d),
            lambda **d: rt_expfit_log_lin_reg(x, 14, 1.0, False, **d),
            lambda **d: rt_expfit_log_lin_reg(x, 14, 1.0, True, **d),
            lambda **d: (causal_moving_average(x.reshape(4, 50), 7, **d),
                         filtfilt_ma(x.reshape(4, 50), 20, 0, **d),
                         tikhonov_smooth(x / 1e3, 2, 10.0, **d))]
    runs += [lambda ft=ft, **d: (smooth_series(x, ft, **d),)
             for ft in FILTER_TYPES]
    for run in runs:
        for g, r in zip(run(), run(device="cpu")):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), r, **tol)
    for causal in (True, False):
        got = rt_expfit_nonlin_ls(x2, 14, 1.0, causal)
        ref = rt_expfit_nonlin_ls(x2, 14, 1.0, causal, device="cpu")
        for k in (0, 1, 3):
            torch.testing.assert_close(got[k].cpu(), ref[k], rtol=LM_RTOL,
                                       atol=0)
        torch.testing.assert_close(
            got[2].cpu(), ref[2], rtol=0,
            atol=LM_RTOL * float(ref[2].abs().max()))
        if causal:
            np.testing.assert_allclose(lm_costs(x2, got[1], got[2], 14),
                                       lm_costs(x2, ref[1], ref[2], 14),
                                       rtol=LM_COST_RTOL, atol=0)


def test_seirp_and_linear_systems_on_the_card_match_the_cpu(cuda):
    """SIR, SEIRP (time-varying rates, a leading batch), the saturated
    model, a scenario at dt = 0.5 and the linear-systems analytics from
    NumPy inputs (so on the card) against device="cpu", float64, at rtol
    1e-9 (chip_smoke's SLICE6_TOL); the country statistics likewise."""
    from epidemicmodeling_torch.analysis import (
        active_cases, ctrb, lagged_case_rate, mortality_rate, obsv,
        r0_generation_ratio, run_seirp_scenario, seirp_early_closed_form,
        seirp_early_eigen, seirp_early_phase_matrix)
    from epidemicmodeling_torch.models import (seirp_rollout,
                                               seirp_saturated_rollout,
                                               sir_rollout)
    rng = np.random.default_rng(0)
    K = 600
    rates = (np.array([0.65, 0.005, 0.05, 0.08, 0.1, 0.02, 0.001])[:, None]
             * (1 + 0.3 * np.sin(0.01 * np.arange(K) + rng.uniform(
                 0, 6, (7, 1)))))
    ae = np.stack([rates[0], 0.8 * rates[0]])
    x0 = (1 - 1e-4, 1e-4, 0.0, 0.0, 0.0)
    sat = (0.1, 0.05, 0.02, 0.2, 0.01, 0.05)
    rates_a = dict(alpha_e=0.65, alpha_i=0.005, kappa=0.05, rho=0.08,
                   beta=0.1, mu=0.02, gamma=0.0)
    total = np.cumsum(rng.uniform(0, 80, (3, 50)), axis=1)
    infected = rng.uniform(50, 300, (3, 50))
    M = rng.standard_normal((4, 4))
    runs = [
        lambda **d: sir_rollout(0.99, 0.01, 0.0, 0.4, 0.1, 0.01, 60.0, 0.1,
                                **d),
        lambda **d: seirp_rollout(ae, *rates[1:], *x0, 300.0, 0.5, **d),
        lambda **d: seirp_saturated_rollout(*rates[[0, 1, 2, 3, 6]], *x0,
                                            300.0, 0.5, *sat, **d),
        lambda **d: tuple(run_seirp_scenario("C", 0.5, **d)[k]
                          for k in ("t", "s", "e", "i", "r", "p")),
        lambda **d: (seirp_early_phase_matrix(**rates_a, **d),
                     seirp_early_eigen(**rates_a, **d),
                     *seirp_early_closed_form(np.linspace(0, 25, 51), 1e-8,
                                              **rates_a, **d),
                     obsv(M, np.eye(4)[:1], **d),
                     ctrb(np.eye(4), np.ones((1, 4)), **d)),
        lambda **d: (mortality_rate(0.02 * total, total, **d),
                     active_cases(total, 0.02 * total, 0.3 * total, **d),
                     r0_generation_ratio(infected[0], 3, **d),
                     lagged_case_rate(total, infected, 2, True, **d)),
    ]
    for run in runs:
        for g, r in zip(run(), run(device="cpu")):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), r, rtol=1e-9, atol=1e-12)


def test_shooting_on_the_card_matches_the_cpu(cuda):
    """The three shooting variants at tests/test_analysis.py's settings on
    the card (their default) and on the CPU, float64: controls equal, the
    series at rtol 1e-9; the structural H certificate and the flip check
    on the card's own series (chip_smoke.shooting_certificates)."""
    from epidemicmodeling_torch.analysis import (
        si_alpha_hamiltonian_shooting, si_alpha_multiplicative_shooting,
        si_continuous_control)
    P = 12
    u_max = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)
    kw = dict(epsilon=0.2, w=np.ones(P), a=0.01 * np.ones(P),
              u_min=np.zeros(P), u_max=u_max, gamma=1 / 7, beta=1 / 7,
              s0=0.99, i0=0.01, alpha0=0.1,
              lambda_init=np.array([-1.0, 1.0, 1.0]), K=500, dt=0.1)
    sched = np.random.default_rng(1).integers(0, 4, (500, P)).astype(float)
    mult = dict(epsilon=0.2, w=np.ones(P), a=0.0001 * np.ones(P), c=0.0004,
                u_min=np.zeros(P), u_max=u_max, beta=1 / 7, s0=0.99,
                i0=0.01, alpha0=0.1, lambda_init=np.zeros(3), K=400, dt=0.1,
                alpha_max=10.0)
    additive = dict(a=kw["a"], gamma=kw["gamma"])
    for run, opt, cert in (
            (lambda **d: si_alpha_hamiltonian_shooting(**kw, **d), True,
             additive),
            (lambda **d: si_alpha_hamiltonian_shooting(
                **kw, u_schedule=sched, **d), False, additive),
            (lambda **d: si_alpha_multiplicative_shooting(**mult, **d),
             True, dict(a=mult["a"], c=mult["c"]))):
        got, ref = run(), run(device="cpu")
        assert torch.equal(got.u.cpu(), ref.u)
        for f in ("s", "i", "alpha", "lambdas", "J0", "J1"):
            torch.testing.assert_close(getattr(got, f).cpu(),
                                       getattr(ref, f), rtol=1e-9,
                                       atol=1e-12)
        h, flips = shooting_certificates(got, 0.2, np.ones(P), u_min=np.zeros(
            P), u_max=u_max, beta=1 / 7, optimal=opt, **cert)
        assert h <= 1.0 and flips
    cont = dict(A_coefs=0.002 * np.ones(P), w=np.ones(P), u_min=np.zeros(P),
                u_max=u_max, gamma=3e-5, beta=1 / 7, s0=0.99, i0=0.01,
                rho0=-1.0, lambda20=0.0, K=300, dt=0.1)
    got = si_continuous_control(**cont)
    ref = si_continuous_control(**cont, device="cpu")
    assert torch.equal(got["u"].cpu(), ref["u"])
    for k in ("s", "i", "alpha", "J0", "J1"):
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=1e-9,
                                   atol=1e-12)


def test_lstm_on_the_card_matches_the_cpu(cuda):
    """The LSTM forecaster (hidden (32, 16), each head) from the same
    initial weights, by chip_smoke.small_lstm_parity: 10 training epochs
    at LSTM_LOSS_RTOL and the float32 forward at LSTM_FWD_TOL, bounds
    that cuDNN's TF32 fails; the rollouts at rtol 1e-4; the weights and
    outputs on the card when the inputs are."""
    from epidemicmodeling_torch.ml import (LSTMForecaster, rollout_forecast,
                                           rollout_forecast_exog)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 60, 5))
    y = rng.standard_normal((4, 60, 1))
    for head in (None, "exp", "scaled_tanh"):
        card, cpu, loss, fwd = small_lstm_parity(
            cuda, torch.as_tensor(x, device=cuda),
            torch.as_tensor(y, device=cuda), head)
        assert all(v.device.type == "cuda" for v in card.params().values())
        assert loss <= 1.0 and fwd <= 1.0
        got = rollout_forecast_exog(card, None, x[0, :40], x[0, 40:], 1)
        want = rollout_forecast_exog(cpu, None, x[0, :40], x[0, 40:], 1)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    series = np.sin(0.3 * np.arange(50.0))[:, None]
    model = LSTMForecaster((8,))
    p = model.init(None, torch.as_tensor(series, device=cuda))
    got = rollout_forecast(model, p, series, 7)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    ref = rollout_forecast(LSTMForecaster((8,)), p_cpu, series, 7,
                           device="cpu")
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5)
    # NumPy history, weights on the CPU, a model not built yet: the card
    fresh = rollout_forecast(LSTMForecaster((8,)), p_cpu, series, 7)
    assert fresh.device.type == "cuda"
    torch.testing.assert_close(fresh.cpu(), ref, rtol=1e-4, atol=1e-5)


def test_features_ridge_arx_and_svr_on_the_card_match_the_cpu(cuda):
    """lagged_features, long_weekend_feature and standardize exactly /
    at rtol 1e-12; ridge and ARX (from the same draws) at rtol 1e-9; the
    three SVR modes after 100 Adam steps from the same draws at rtol 1e-9
    (float64)."""
    from epidemicmodeling_torch.ml import (arx_fit_predict, lagged_features,
                                           long_weekend_feature,
                                           ridge_regression, standardize,
                                           svr_fit, svr_predict)
    rng = np.random.default_rng(3)
    U = rng.integers(0, 4, (80, 12)).astype(float)
    dates = [f"2020-03-{d:02d}" for d in range(1, 32)]
    assert torch.equal(lagged_features(U, (0, 1, 7)).cpu(),
                       lagged_features(U, (0, 1, 7), device="cpu"))
    assert torch.equal(long_weekend_feature(dates).cpu(),
                       long_weekend_feature(dates, device="cpu"))
    X = rng.standard_normal((80, 6)) * 3 + 1
    y = X @ rng.standard_normal(6) + 0.1 * rng.standard_normal(80)
    for g, r in zip(standardize(X), standardize(X, device="cpu")):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-12, atol=1e-13)
    for g, r in zip(ridge_regression(X, y, 1e-2),
                    ridge_regression(X, y, 1e-2, device="cpu")):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-9, atol=1e-12)
    z = rng.standard_normal(20)
    series = np.cos(0.1 * np.arange(200)) + 0.05 * rng.standard_normal(200)
    for g, r in zip(arx_fit_predict(series, 6, 20, noise=z),
                    arx_fit_predict(series, 6, 20, noise=z, device="cpu")):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-9, atol=1e-12)
    for kernel in ("linear", "rbf", "rbf-exact"):
        fit = lambda **d: svr_fit(X, y, kernel, n_steps=100, n_rff=32,
                                  generator=torch.Generator().manual_seed(4),
                                  **d)
        got, ref = fit(), fit(device="cpu")
        assert got.w.device.type == "cuda"
        torch.testing.assert_close(svr_predict(got, X).cpu(),
                                   svr_predict(ref, X), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
@pytest.mark.parametrize("E", [1, 37, 300])
def test_newcase_ekf_card_equals_the_cpu_build(cuda, E, beta_ekf):
    eps = np.logspace(-8, 0, E)
    args = deploy_sweep_args(eps)
    before = deploy_native.launches
    card = newcase_ekf_pareto_sweep_native(*args, beta_ekf=beta_ekf)
    assert deploy_native.launches == before + 1
    cpu = newcase_ekf_pareto_sweep_native(*args, beta_ekf=beta_ekf,
                                          device="cpu")
    d = deploy_native.native_inputs(*(args[i] for i in (0, 1, 3, 5, 6, 7, 8,
                                                        9, 10)))
    host = deploy_native.sweep_host_entry(d, eps, args[2], args[11],
                                          beta_ekf)
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
        np.testing.assert_array_equal(host[k], cpu[k], err_msg=k)
    plain = pareto_sweep_plain(*args, beta_ekf=beta_ekf, device=cuda)
    np.testing.assert_array_equal(plain["U_OPT_SMOOTH"].cpu().numpy(),
                                  cpu["U_OPT_SMOOTH"])
    for k in ("J0", "J1"):
        np.testing.assert_allclose(plain[k].cpu().numpy(), cpu[k],
                                   rtol=1e-9, atol=0, err_msg=k)


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
@pytest.mark.parametrize("epsilon", [0.05, 0.5])
def test_newcase_ekf_single_entry_card_equals_the_cpu_build(cuda, epsilon,
                                                            beta_ekf):
    args = deploy_inputs(epsilon=epsilon)
    card = newcase_ekf_optimal_npi_native(*args, beta_ekf=beta_ekf)
    cpu = newcase_ekf_optimal_npi_native(*args, beta_ekf=beta_ekf,
                                         device="cpu")
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)


def test_newcase_ekf_blocks_spread_over_the_card(cuda):
    """2,000 lanes are 125 blocks, spread over at least 120 SMs (the kernel
    records each block's SM), and the host-pointer entry's parts lie within
    its wall."""
    eps = np.logspace(-8, -2, 2000)
    args = deploy_sweep_args(eps, T_hist=45, T=60)
    newcase_ekf_pareto_sweep_native(*args, beta_ekf=0.9)
    sms = deploy_native.block_sms(len(eps))
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert len(sms) == deploy_native.blocks(len(eps)) == 125
    assert ((sms >= 0) & (sms < n_sms)).all()
    assert len(set(sms.tolist())) >= min(120, n_sms)
    d = deploy_native.native_inputs(*(args[i] for i in (0, 1, 3, 5, 6, 7, 8,
                                                        9, 10)))
    t0 = time.perf_counter()
    deploy_native.sweep_host_entry(d, eps, args[2], args[11], 0.9)
    wall = 1e3 * (time.perf_counter() - t0)
    phases = deploy_native.host_entry_phases()
    assert set(phases) == set(deploy_native.HOST_PHASES)
    assert all(v >= 0 for v in phases.values())
    assert phases["kernel"] > 0 and sum(phases.values()) <= wall


def test_newcase_ekf_card_refuses_what_it_cannot_take(cuda):
    args = deploy_sweep_args(np.array([0.1, 0.2]))
    with pytest.raises(ValueError, match="card build's limit"):
        newcase_ekf_pareto_sweep_native(
            *args, inv_monitor_len=deploy_native.MONITOR_MAX + 1)
    bad = list(args)
    bad[2], bad[11] = 0, np.zeros((0, 3))
    with pytest.raises(RuntimeError, match="newcase_ekf_sweep_device"):
        newcase_ekf_pareto_sweep_native(*bad)
    d = deploy_native.to_device(deploy_native.native_inputs(
        *(args[i] for i in (0, 1, 3, 5, 6, 7, 8, 9, 10))), cuda)
    with pytest.raises(ValueError, match="float64"):
        deploy_native.newcase_ekf_sweep(
            d, torch.tensor([0.1], dtype=torch.float32, device=cuda))


def test_stage_timer_waits_for_the_card(cuda, monkeypatch):
    from epidemicmodeling_torch.utils.profiling import StageTimer
    seen, real = [], torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (seen.append(d), real(d)))
    x = torch.ones(1 << 20, device=cuda)
    timer = StageTimer()
    with timer.stage("card", block_on=[x, {"y": (x,)}, 1.0]):
        x = x * 2
    assert seen == [cuda] and "card" in timer.times


def test_torch_trace_captures_card_kernels(cuda, tmp_path):
    import json
    from epidemicmodeling_torch.utils.profiling import torch_trace
    with torch_trace(str(tmp_path)):
        y = torch.randn(256, 256, device=cuda) @ torch.randn(256, 256,
                                                             device=cuda)
        torch.cuda.synchronize()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert y.shape == (256, 256)


# ------------------------------------------- the SI-alpha rollout kernel

ROLLOUT_R, ROLLOUT_H, ROLLOUT_T_HIST = 235, 92, 440


def _rollout_site(site, dtype, dev):
    """(s0, params, u, noise, out) of a rollout call as the
    xprize-pipeline-f64 cell makes it: a sweep chunk (25 x 235 lanes, the
    batch-last prescription, the trajectory into the horizon of (E, R, T)
    buffers), the scenarios (3 x 235, the fields' horizon, with a noise
    draw shared by the three) and the Monte Carlo (500 x 235, the
    schedules at stride 0 over the regions, the sums alone)."""
    R, H, Th = ROLLOUT_R, ROLLOUT_H, ROLLOUT_T_HIST
    g = torch.Generator().manual_seed(11)
    s0, p = rollout_params(R, dtype, 0, dev)
    if site == "sweep chunk":
        G = 25
        u_bl = npi_levels(g, (H, G * R, 12), dtype, dev).permute(0, 2, 1)
        u = u_bl.contiguous().reshape(H, 12, G, R).permute(2, 3, 0, 1)
        out = tuple(torch.empty((G, R, Th + H), dtype=dtype,
                                device=dev)[..., Th:] for _ in range(3))
        return s0, p, u, None, out
    if site == "scenarios":
        G = 3
        noise = torch.randn((R, H, 3), generator=g, dtype=torch.float64)
        f = torch.empty((3, G, R, Th + H), dtype=dtype, device=dev)
        return (s0, p, npi_levels(g, (G, R, H, 12), dtype, dev),
                noise.to(dtype=dtype, device=dev).expand(G, R, H, 3),
                tuple(f[k, ..., Th:] for k in range(3)))
    u = npi_levels(g, (500, H, 12), dtype, dev)
    return s0, p, u[:, None].expand(500, R, H, 12), None, None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("site", ["sweep chunk", "scenarios", "monte carlo"])
def test_rollout_kernel_matches_plain_at_the_cell_shapes(cuda, site, dtype):
    """csrc/rollout.cu at the xprize-pipeline-f64 cell's three call sites
    (H = 92, P = 12) against rollout_plain on the card in the same dtype:
    each lane's horizon sum and every trajectory field within
    chip_smoke's SI_ROLLOUT_BOUNDS, one launch, counted as
    rollout.launches."""
    s0, p, u, noise, out = _rollout_site(site, dtype, cuda)
    before = rollout_kernel.launches
    with recording() as rec:
        got = rollout_kernel.rollout(s0, p, u, noise, out)
    assert rollout_kernel.launches == before + 1
    assert rec.counters["rollout.launches"] == 1
    ref_out = None if out is None else tuple(torch.empty_like(o)
                                             for o in out)
    want = rollout_kernel.rollout_plain(s0, p, u, noise, ref_out)
    assert got.dtype == dtype and got.device == cuda
    assert bool(torch.isfinite(got).all())
    assert scaled_err(got, want) < SI_ROLLOUT_BOUNDS[dtype]
    for o, r in zip(out or (), ref_out or ()):
        assert bool(torch.isfinite(o).all())
        assert scaled_err(o, r) < SI_ROLLOUT_BOUNDS[dtype]


def test_rollout_kernel_makes_no_host_sync(cuda):
    """The kernel's call at each site under torch's sync debug mode
    "error": no host sync (its clip bounds are literals, nothing goes to
    the card from the host); the plain version, whose clips make their
    bounds device tensors, raises there."""
    sites = [_rollout_site(s, torch.float64, cuda)
             for s in ("sweep chunk", "scenarios", "monte carlo")]
    rollout_kernel.rollout(*sites[0])          # built and loaded first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in sites:
            rollout_kernel.rollout(*args)
        with pytest.raises(RuntimeError):
            rollout_kernel.rollout_plain(*sites[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_warm_float64_run_pipeline_launches_the_rollout_once_a_call(cuda):
    """A warm float64 run_pipeline with 250 epsilons in chunks of 25 (20
    regions, 120 + 92 days): 12 rollout launches (10 sweep chunks, the
    scenarios, the Monte Carlo), and fewer than 2,500 device events in
    all (the profiler's kernels, copies and sets; the eager rollouts made
    ~43,000 at the cell)."""
    from benchmark.trace import summarize
    from torch.profiler import ProfilerActivity, profile
    T_hist, H, E = 120, 92, 250
    bt, bf, actual = small_region_inputs(n_regions=20, t_hist=T_hist,
                                         horizon=H)
    cfg = PipelineConfig(backend="pallas", pareto_chunk=25,
                         num_monte_carlo=16)
    eps = epsilon_grid(E).numpy()
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 16,
                                    np.zeros(12), NPI_MAXES_DEFAULT, H,
                                    dtype=torch.float64).to(cuda)
    run = lambda: run_pipeline(bt, bf, actual, T_hist, np.ones(12), eps,
                               np.zeros(12), NPI_MAXES_DEFAULT, T_hist, cfg,
                               dtype=torch.float64, device=cuda,
                               u_random=u_random)
    run()
    torch.cuda.synchronize()
    before = rollout_kernel.launches
    with recording() as rec, profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as pr:
        res = run()
        torch.cuda.synchronize()
    assert rollout_kernel.launches - before == 12
    assert rec.counters["rollout.launches"] == 12
    events = summarize(pr, 0.0, 1).device_events
    assert 0 < events < 2500, events
    assert res.pareto["s"].shape == (E, 20, T_hist + H)
    assert bool(torch.isfinite(res.pareto["J0"]).all())


def test_float32_run_pipeline_kernels_against_plain_versions(cuda):
    """The float32 run_pipeline held to its existing checks
    (chip_smoke.small_reference_check: every kernel, the rollout's
    included, against its plain version on the card at SMALL_REF_BOUNDS),
    the rollout launched once a sweep chunk, once for the scenarios and
    once for the Monte Carlo."""
    from chip_smoke import small_reference_check
    before = rollout_kernel.launches
    small_reference_check(cuda)
    assert rollout_kernel.launches - before == 16 // 4 + 2
