"""The PyTorch port's spatial stack, held against the JAX package on the CPU.

The same NumPy inputs go through the JAX functions and their counterparts in
epidemicmodeling_torch.spatial; on CPU tensors the port's kernel wrappers run
their plain versions (the stencil in the field's dtype, the pairwise forces
in float32). The JAX Pallas routes run in interpret mode, as
tests/test_spatial.py runs them. torch cannot reproduce jax.random draws, so
the random walks and the agent sim's noise are rebuilt here from JAX's own
key schedule and handed to both packages.

Tolerances, each with its reason:
- float64 stencil and rollouts: rtol 1e-12; the only difference is the
  summation order of the 9-point update.
- float32 stencil: atol 3e-7, the JAX package's own bound (bench.py:448).
- float64 dense social forces: rtol 1e-12 with atol 1e-12 * max|ref|; the
  sums over N + O sources run in another order, and a component that
  cancels to near zero carries absolute, not relative, roundoff.
- float32 pairwise forces against the Pallas kernel: atol 1e-5 * max|ref|
  (tests/test_spatial.py:153-154).
- the crossing test and the environment: exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicmodeling_tpu.ops.pallas.pairwise import social_forces_pallas
from epidemicmodeling_tpu.ops.pallas.stencil import diffusion_step_pallas
from epidemicmodeling_tpu.spatial import agents as jax_agents
from epidemicmodeling_tpu.spatial import diffusion as jax_diffusion
from epidemicmodeling_tpu.spatial.walkers import \
    walking_sources_sim as jax_walkers

from epidemicmodeling_torch.ops.cuda.pairwise_kernel import (
    social_forces, social_forces_plain)
from epidemicmodeling_torch.ops.cuda.stencil_kernel import (
    STEPS_PER_LAUNCH, stencil, stencil_plain, stencil_rollout,
    stencil_rollout_plain)
from epidemicmodeling_torch.spatial import (PopulationSimConfig, cfl_check,
                                            diffusion_rollout,
                                            diffusion_step_4,
                                            diffusion_step_8,
                                            population_motion_sim)
from epidemicmodeling_torch.spatial.agents import (_crossed_obstacle,
                                                   _social_forces,
                                                   default_environment)
from epidemicmodeling_torch.spatial.walkers import (clamped_walk,
                                                    walking_sources_sim)

from tests.test_spatial import make_init
from tests.test_spatial_fuzz import oracle_crossed, oracle_social_forces

CPU = torch.device("cpu")
F64 = dict(rtol=1e-12, atol=0)
# dx != dy so that an ax/ay axis swap cannot cancel out
D, DT, DX, DY = 1e-1, 0.004, 0.1, 0.14
AX, AY, AXY = D * DT / DX ** 2, D * DT / DY ** 2, D * DT / (DX ** 2 + DY ** 2)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------- the stencil

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(51, 51), (129, 131)])
def test_stencil_plain_matches_jax(shape, dtype):
    """stencil_plain against diffusion_step_4/8 and against the Pallas
    stencil in interpret mode, whole-grid and row-tiled, both schemes."""
    C = np.random.default_rng(sum(shape)).random(shape).astype(dtype)
    tol = F64 if dtype == "float64" else dict(rtol=0, atol=3e-7)
    Cj, Ct = jnp.asarray(C), torch.from_numpy(C.copy())
    for axy, jax_step in ((0.0, jax_diffusion.diffusion_step_4),
                          (AXY, jax_diffusion.diffusion_step_8)):
        got = stencil_plain(Ct, AX, AY, axy)
        assert got.dtype == Ct.dtype
        got = got.numpy()
        np.testing.assert_allclose(got, np.asarray(jax_step(Cj, D, DT, DX,
                                                            DY)), **tol)
        for tiled in (False, True):
            ref = diffusion_step_pallas(Cj, AX, AY, axy, force_tiled=tiled)
            np.testing.assert_allclose(got, np.asarray(ref), **tol,
                                       err_msg=f"tiled={tiled}")
        # the wrapper takes the plain version on the CPU; force_tiled and
        # out= change nothing
        out = torch.empty_like(Ct)
        res = stencil(Ct, AX, AY, axy, force_tiled=True, out=out)
        assert res is out
        np.testing.assert_array_equal(out.numpy(), got)
    np.testing.assert_array_equal(
        diffusion_step_4(Ct, D, DT, DX, DY).numpy(),
        stencil_plain(Ct, AX, AY, 0.0).numpy())
    np.testing.assert_array_equal(
        diffusion_step_8(Ct, D, DT, DX, DY).numpy(),
        stencil_plain(Ct, AX, AY, AXY).numpy())


@pytest.mark.parametrize("shape", [(2, 7), (7, 1), (3, 3)])
def test_stencil_small_grids(shape):
    """Lx < 3 or Ly < 3: no interior, the output is a copy; 3 x 3 updates
    only its centre cell."""
    C = torch.from_numpy(np.random.default_rng(1).random(shape))
    got = stencil(C, AX, AY, AXY)
    if min(shape) < 3:
        np.testing.assert_array_equal(got.numpy(), C.numpy())
    else:
        ref = np.asarray(jax_diffusion.diffusion_step_8(jnp.asarray(
            C.numpy()), D, DT, DX, DY))
        np.testing.assert_allclose(got.numpy(), ref, **F64)
        mask = np.ones(shape, bool)
        mask[1, 1] = False
        np.testing.assert_array_equal(got.numpy()[mask], C.numpy()[mask])


def test_stencil_refuses_other_dtypes():
    for dt in (torch.float16, torch.int64):
        with pytest.raises(ValueError, match="float32 or float64"):
            stencil(torch.zeros((5, 5), dtype=dt), AX, AY)
    with pytest.raises(ValueError, match="2-D"):
        stencil(torch.zeros(5), AX, AY)


# ------------------------------------------------------------- rollouts

@pytest.mark.parametrize("with_sources", [False, True])
@pytest.mark.parametrize("nb", [4, 8])
def test_diffusion_rollout_matches_jax(nb, with_sources):
    C0 = make_init()
    D_, dt, dx, dy, NT = 1e-1, 0.01, 0.1, 0.1, 50
    sources = None
    if with_sources:
        sources = np.zeros((NT,) + C0.shape)
        sources[::7, 10, 40] = 0.5
        sources[:, 30, 5] = 0.01
    ref = np.asarray(jax_diffusion.diffusion_rollout(
        C0, D_, dt, dx, dy, NT, neighborhood=nb, sources=sources))
    for use_pallas in (False, True):
        got = diffusion_rollout(C0, D_, dt, dx, dy, NT, neighborhood=nb,
                                sources=sources, use_pallas=use_pallas,
                                device="cpu")
        assert got.dtype == torch.float64 and got.shape == (NT + 1, 51, 51)
        np.testing.assert_allclose(got.numpy(), ref, **F64)


@pytest.mark.parametrize("nb", [4, 8, 6])
def test_diffusion_rollout_refuses_as_jax(nb):
    """The CFL guard and an unknown neighbourhood raise the JAX package's
    ValueError, with its message."""
    bad = dict(D=1.0, dt=1.0, dx=0.1, dy=0.1) if nb != 6 else \
        dict(D=1e-1, dt=0.01, dx=0.1, dy=0.1)
    msgs = []
    for fn, kw in ((jax_diffusion.diffusion_rollout, {}),
                   (diffusion_rollout, dict(device="cpu"))):
        with pytest.raises(ValueError) as err:
            fn(make_init(), n_steps=3, neighborhood=nb, **bad, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert cfl_check(1e-1, 0.01, 0.1, 0.1) == tuple(
        bool(v) for v in jax_diffusion.cfl_check(1e-1, 0.01, 0.1, 0.1))


def test_walking_sources_match_jax():
    """walking_sources_sim with the start cells and steps that JAX's keys
    give, both neighbourhoods, fields included; duplicate cells sum."""
    key = jax.random.PRNGKey(3)
    Lx, Ly, W, NT = 23, 19, 5, 40
    k_init, k_run = jax.random.split(key)
    start = np.stack([
        np.asarray(jax.random.randint(k_init, (W,), 1, Lx - 1)),
        np.asarray(jax.random.randint(jax.random.fold_in(k_init, 1), (W,),
                                      1, Ly - 1))], axis=1)
    steps = np.stack([np.asarray(jax.random.randint(k, (W, 2), -1, 2))
                      for k in jax.random.split(k_run, NT)])
    for nb in (4, 8):
        C_j, traj_j, fields_j = jax_walkers(
            Lx, Ly, W, NT, 1e-1, 0.01, 0.1, 0.1, 1.0, key, neighborhood=nb,
            return_fields=True)
        C, traj, fields = walking_sources_sim(
            Lx, Ly, W, NT, 1e-1, 0.01, 0.1, 0.1, 1.0, neighborhood=nb,
            return_fields=True, start=start, steps=steps, device="cpu",
            dtype=torch.float64)
        np.testing.assert_array_equal(traj.numpy(), np.asarray(traj_j))
        np.testing.assert_allclose(fields.numpy(), np.asarray(fields_j),
                                   **F64)
        np.testing.assert_allclose(C.numpy(), np.asarray(C_j), **F64)
        C2, traj2 = walking_sources_sim(
            Lx, Ly, W, NT, 1e-1, 0.01, 0.1, 0.1, 1.0, neighborhood=nb,
            start=torch.from_numpy(start), steps=torch.from_numpy(steps),
            dtype=torch.float64)
        np.testing.assert_array_equal(C2.numpy(), C.numpy())
        np.testing.assert_array_equal(traj2.numpy(), traj.numpy())


def test_walking_sources_draws_follow_the_law():
    """Without start/steps the walks come from the generator: start cells in
    the interior, moves of at most one cell per axis, mass bounded by what
    was injected."""
    g = torch.Generator().manual_seed(0)
    C, traj = walking_sources_sim(31, 29, 4, 60, 1e-2, 0.01, 0.1, 0.1, 1.0,
                                  g, device="cpu", dtype=torch.float64)
    t = traj.numpy()
    assert t.shape == (60, 4, 2)
    assert (t >= 1).all() and (t[..., 0] <= 29).all() \
        and (t[..., 1] <= 27).all()
    assert (np.abs(np.diff(t, axis=0)) <= 1).all()
    # 240 units injected; the frozen boundary only takes mass away
    assert 200.0 < float(C.sum()) <= 240.0 + 1e-9


# ---------------------------------------------------- the multi-step path

# step counts that are not multiples of the kernel's steps a launch
# (STEPS_PER_LAUNCH: 8 in float32, 4 in float64), grids with Lx or Ly < 3
ROLLOUT_CASES = [((51, 51), 7), ((23, 19), 9), ((40, 31), 25), ((2, 9), 5),
                 ((9, 1), 3), ((3, 70), 13)]


@pytest.mark.parametrize("with_sources", [False, True])
@pytest.mark.parametrize("nb", [4, 8])
@pytest.mark.parametrize("shape,n", ROLLOUT_CASES)
def test_stencil_rollout_plain_matches_jax(shape, n, nb, with_sources):
    """The multi-step path on the CPU (stencil_rollout's plain version, and
    diffusion_rollout through it) against the JAX package's
    diffusion_rollout, float64, rtol 1e-12: sources are added before each
    step, the boundary keeps C + src."""
    assert all(n % k for k in STEPS_PER_LAUNCH.values())
    rng = np.random.default_rng(n + sum(shape))
    C0 = rng.random(shape)
    sources = rng.random((n,) + shape) * 1e-2 if with_sources else None
    ref = np.asarray(jax_diffusion.diffusion_rollout(
        C0, D, DT, DX, DY, n, neighborhood=nb, sources=sources))
    got = diffusion_rollout(C0, D, DT, DX, DY, n, neighborhood=nb,
                            sources=sources, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, **F64)
    w = (AX, AY, AXY if nb == 8 else 0.0)
    src = None if sources is None else _t(sources)
    frames = torch.empty((n,) + shape, dtype=torch.float64)
    last = stencil_rollout(_t(C0), n, w, sources=src, frames=frames)
    assert last.data_ptr() == frames[-1].data_ptr()
    np.testing.assert_allclose(frames.numpy(), ref[1:], **F64)
    np.testing.assert_array_equal(
        stencil_rollout_plain(_t(C0), n, [w] * n, sources=src).numpy(),
        frames[-1].numpy())


def test_stencil_rollout_per_step_weights():
    """Per-step weights: the agent sim's 4-neighbour step then 8-neighbour
    step, with an injection before the first only, equal JAX's two steps
    after C.at[].add; a list of the wrong length raises."""
    rng = np.random.default_rng(2)
    C0 = rng.random((23, 19))
    cells = torch.tensor([[5 * 19 + 7, 5 * 19 + 7, 0]], dtype=torch.int32)
    amounts = torch.tensor([[0.5, 0.25, 1.0]], dtype=torch.float64)
    got = stencil_rollout(_t(C0), 2, [(AX, AY, 0.0), (AX, AY, AXY)],
                          cells=cells, amounts=amounts)
    Cj = jnp.asarray(C0).at[5, 7].add(0.5).at[5, 7].add(0.25).at[0, 0].add(
        1.0)
    ref = jax_diffusion.diffusion_step_8(
        jax_diffusion.diffusion_step_4(Cj, D, DT, DX, DY), D, DT, DX, DY)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)
    with pytest.raises(ValueError, match="weights"):
        stencil_rollout(_t(C0), 3, [(AX, AY, 0.0)] * 2)


def _jax_walks(key, Lx, Ly, W, NT):
    """The start cells and steps of JAX's walkers for ``key``."""
    k_init, k_run = jax.random.split(key)
    start = np.stack([
        np.asarray(jax.random.randint(k_init, (W,), 1, Lx - 1)),
        np.asarray(jax.random.randint(jax.random.fold_in(k_init, 1), (W,),
                                      1, Ly - 1))], axis=1)
    steps = np.stack([np.asarray(jax.random.randint(k, (W, 2), -1, 2))
                      for k in jax.random.split(k_run, NT)])
    return start, steps


@pytest.mark.parametrize("nb", [4, 8])
def test_walking_sources_with_duplicate_cells_match_jax(nb):
    """Twelve walkers on a 5 x 4 interior share cells on most steps, so
    duplicates sum; 21 steps, not a multiple of the kernel's steps a
    launch. float64, rtol 1e-12, fields included."""
    key = jax.random.PRNGKey(11)
    Lx, Ly, W, NT = 7, 6, 12, 21
    start, steps = _jax_walks(key, Lx, Ly, W, NT)
    C_j, traj_j, fields_j = jax_walkers(
        Lx, Ly, W, NT, 1e-1, 0.01, 0.1, 0.1, 0.7, key, neighborhood=nb,
        return_fields=True)
    pos = np.concatenate([start[None], np.asarray(traj_j)[:-1]])
    flat = pos[..., 0] * Ly + pos[..., 1]
    dup_steps = sum(len(np.unique(f)) < W for f in flat)
    assert dup_steps >= NT // 2
    C, traj, fields = walking_sources_sim(
        Lx, Ly, W, NT, 1e-1, 0.01, 0.1, 0.1, 0.7, neighborhood=nb,
        return_fields=True, start=start, steps=steps, device="cpu",
        dtype=torch.float64)
    np.testing.assert_array_equal(traj.numpy(), np.asarray(traj_j))
    np.testing.assert_allclose(fields.numpy(), np.asarray(fields_j), **F64)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_j), **F64)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33, 500])
def test_clamped_walk_matches_the_step_loop(n):
    """The walk's doubling scan equals the step-by-step clamp exactly,
    with moves large enough to hit both walls often."""
    g = torch.Generator().manual_seed(n)
    start = torch.randint(1, 9, (17, 2), generator=g)
    steps = torch.randint(-4, 5, (n, 17, 2), generator=g)
    lo, hi = torch.tensor([1, 2]), torch.tensor([8, 5])
    x, ref = start, []
    for t in range(n):
        x = torch.clamp(x + steps[t], lo, hi)
        ref.append(x)
    assert torch.equal(clamped_walk(start, steps, lo, hi), torch.stack(ref))


# ------------------------------------------------------------- agents

def test_population_config_matches_jax():
    ref = {f.name: f.default
           for f in dataclasses.fields(jax_agents.PopulationSimConfig)}
    got = {f.name: f.default for f in dataclasses.fields(PopulationSimConfig)}
    assert got == ref
    with pytest.raises(ValueError, match="force_backend"):
        PopulationSimConfig(force_backend="tiled")
    with pytest.raises(dataclasses.FrozenInstanceError):
        PopulationSimConfig().dt = 1.0


@pytest.mark.parametrize("cfg", [PopulationSimConfig(),
                                 PopulationSimConfig(dl=0.5, x_max=31.0,
                                                     y_min=-2.0)],
                         ids=["default", "coarse"])
def test_default_environment_matches_jax(cfg):
    plan, obs = default_environment(cfg)
    ref_plan, ref_obs = jax_agents.default_environment(cfg)
    np.testing.assert_array_equal(plan, np.asarray(ref_plan))
    np.testing.assert_array_equal(obs, np.asarray(ref_obs))
    if cfg == PopulationSimConfig():
        assert plan.shape == (234, 167) and obs.shape == (914, 2)


def _force_cases():
    cfg = PopulationSimConfig(n_subjects=150)
    _, obs = default_environment(cfg)
    rng = np.random.default_rng(5)
    pos = rng.uniform([cfg.x_min + 1, cfg.y_min + 1],
                      [cfg.x_max - 1, cfg.y_max - 1], (150, 2))
    two = np.array([[3.0, 4.0], [3.0, 4.0], [9.0, 4.0], [30.0, 20.0]])
    return {"default_env": (pos, obs), "no_obstacles": (pos, np.zeros((0, 2))),
            "coincident": (two, obs[:40])}


@pytest.mark.parametrize("case", ["default_env", "no_obstacles",
                                  "coincident"])
def test_social_forces_match_jax(case):
    """The dense float64 path against JAX's and the per-pair loop oracle;
    the plain float32 pairwise version against the Pallas kernel in
    interpret mode."""
    pos, obs = _force_cases()[case]
    cfg = PopulationSimConfig(n_subjects=len(pos))
    ref = np.asarray(jax_agents._social_forces(jnp.asarray(pos),
                                               jnp.asarray(obs), cfg))
    got = _social_forces(_t(pos), _t(obs).reshape(-1, 2), cfg).numpy()
    oracle = oracle_social_forces(pos, obs, cfg)
    scale = np.abs(ref).max()
    for a, b in ((got, ref), (got, oracle), (ref, oracle)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * scale)
    assert np.isfinite(got).all()

    pallas = np.asarray(social_forces_pallas(pos, obs, cfg))
    for fn in (social_forces_plain, social_forces):
        plain = fn(_t(pos, torch.float32), _t(obs, torch.float32)
                   .reshape(-1, 2), cfg)
        assert plain.dtype == torch.float32
        np.testing.assert_allclose(plain.numpy(), pallas,
                                   atol=1e-5 * np.abs(pallas).max())
    # float64 positions: float32 compute, forces cast back
    plain64 = social_forces(_t(pos), _t(obs).reshape(-1, 2), cfg)
    assert plain64.dtype == torch.float64
    np.testing.assert_allclose(plain64.numpy(), pallas,
                               atol=1e-5 * np.abs(pallas).max())


def test_crossed_obstacle_matches_jax():
    """Landing and crossing, with vertical, zero-length and wall-landing
    moves: the IEEE inf/NaN of a vertical move compares false on both
    sides. Exactly, and against the loop oracle."""
    cfg = PopulationSimConfig(n_subjects=64)
    plan, obs = default_environment(cfg)
    rng = np.random.default_rng(11)
    p_old = rng.uniform([cfg.x_min, cfg.y_min], [cfg.x_max, cfg.y_max],
                        (64, 2))
    p_new = p_old + rng.normal(scale=3.0, size=(64, 2))
    p_new = np.clip(p_new, [cfg.x_min, cfg.y_min], [cfg.x_max, cfg.y_max])
    p_new[0] = p_old[0]
    p_new[1, 0] = p_old[1, 0]
    p_new[2] = obs[17]
    p_old[3] = [15.0, 5.0]          # vertical, across the wall at y = 9.9
    p_new[3] = [15.0, 12.0]
    got = _crossed_obstacle(_t(p_old), _t(p_new), _t(obs), _t(plan),
                            cfg).numpy()
    ref = np.asarray(jax_agents._crossed_obstacle(
        jnp.asarray(p_old), jnp.asarray(p_new), jnp.asarray(obs),
        jnp.asarray(plan), cfg))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, oracle_crossed(p_old, p_new, obs,
                                                      plan, cfg))
    assert got[2] and got.any() and not got.all()


def _jax_sim_inputs(N, T, key):
    """A start state from a NumPy seed and the per-step normal draws of the
    JAX sim's key schedule (agents.py:171, :198, :236)."""
    rng = np.random.default_rng(N)
    cfg = PopulationSimConfig(n_subjects=N)
    init = dict(
        p_init=rng.uniform([cfg.x_min + 1, cfg.y_min + 1],
                           [cfg.x_max - 1, cfg.y_max - 1], (N, 2)),
        v_init=np.minimum(cfg.v_max / np.sqrt(2), 0.5 * rng.normal(
            size=(N, 2))),
        a_init=np.minimum(cfg.a_max / np.sqrt(2), 0.1 * rng.normal(
            size=(N, 2))),
        j_init=np.zeros((N, 2)))
    k_run = jax.random.split(key, 5)[4]
    draws = [[], [], [], []]
    for k_t in jax.random.split(k_run, T):
        for lst, k in zip(draws, jax.random.split(k_t, 4)):
            lst.append(np.asarray(jax.random.normal(k, (N, 2),
                                                    jnp.float64)))
    return init, tuple(np.stack(d) for d in draws)


# "xla": the same float64 arithmetic up to summation order, rtol 1e-9 (the
# pipeline's parity tolerance; measured 5e-10 at most, on the accelerations).
# "pallas": both sides sum float32 forces in different orders. A near pair
# contributes terms of O(1e3) that cancel to an acceleration of O(1), so each
# step carries absolute roundoff of ~1e3 * 2**-24 = 6e-5 into a, and through
# the integrators into v and p: atol 1e-4 absolute on p, v, a (m, m/s,
# m/s^2; measured 8.4e-6 at most). A flipped clip, crossing or cell decision
# would move a value by far more and fail.
SIM_TOL = {"xla": dict(rtol=1e-9, atol=1e-12),
           "pallas": dict(rtol=0, atol=1e-4)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_population_sim_matches_jax(backend):
    N, T = 40, 30
    key = jax.random.PRNGKey(4)
    init, draws = _jax_sim_inputs(N, T, key)
    cfg = PopulationSimConfig(n_subjects=N, force_backend=backend)
    ref = jax_agents.population_motion_sim(
        cfg, T, key, **{k: jnp.asarray(v) for k, v in init.items()})
    got = population_motion_sim(cfg, T, noise=draws, device="cpu",
                                dtype=torch.float64, **init)
    tol = SIM_TOL[backend]
    for f in ("p", "v", "a", "j", "C"):
        g, r = getattr(got, f), np.asarray(getattr(ref, f))
        assert g.dtype == torch.float64 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, **tol, err_msg=f)
    # the physical invariants of tests/test_spatial.py:102-116
    p, v, a = got.p.numpy(), got.v.numpy(), got.a.numpy()
    assert p.shape == (T, N, 2)
    assert (p[..., 0] >= cfg.x_min).all() and (p[..., 0] <= cfg.x_max).all()
    assert (p[..., 1] >= cfg.y_min).all() and (p[..., 1] <= cfg.y_max).all()
    assert (np.abs(v) <= cfg.v_max).all() and (np.abs(a) <= cfg.a_max).all()
    assert float(got.C.sum()) > 0


def test_population_sim_draws_from_generator():
    """Without a start state or noise the sim draws from the generator (the
    same seed gives the same run) and keeps the invariants; float32 by
    default from NumPy inputs."""
    cfg = PopulationSimConfig(n_subjects=25, force_backend="pallas")
    runs = [population_motion_sim(cfg, 12, torch.Generator().manual_seed(2),
                                  device="cpu") for _ in range(2)]
    for f in ("p", "v", "C"):
        np.testing.assert_array_equal(getattr(runs[0], f).numpy(),
                                      getattr(runs[1], f).numpy())
    res = runs[0]
    assert res.p.dtype == torch.float32 and res.p.shape == (12, 25, 2)
    assert (np.abs(res.v.numpy()) <= cfg.v_max).all()
    assert float(res.C.sum()) > 0


# ------------------------------------------------------------- the device

@pytest.mark.parametrize("entry", ["rollout", "walkers", "agents"])
def test_spatial_entry_points_default_to_the_card(monkeypatch, entry):
    """Without device= and with NumPy inputs the entry points run on the
    CUDA card, so with no card they raise instead of running on the CPU; a
    CPU tensor input keeps the run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "rollout": lambda **kw: diffusion_rollout(make_init(), 1e-1, 0.01,
                                                  0.1, 0.1, 3, **kw),
        "walkers": lambda **kw: walking_sources_sim(
            11, 11, 2, 3, 1e-1, 0.01, 0.1, 0.1, 1.0, **kw),
        "agents": lambda **kw: population_motion_sim(
            PopulationSimConfig(n_subjects=5), 2, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    if entry == "rollout":
        out = diffusion_rollout(torch.from_numpy(make_init()), 1e-1, 0.01,
                                0.1, 0.1, 3)
        assert out.device == CPU
    else:
        out = calls[entry](device="cpu")
        assert out[0].device == CPU
