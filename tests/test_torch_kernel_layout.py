"""The hand-written kernels' launch layouts, checked on the CPU (no card).

The CUDA kernels cannot run here, so what surrounds them is checked in
Python: the pairwise kernel's launch geometry (ops/cuda/pairwise_kernel.
pairwise_geometry) covers every (agent row, source) pair exactly once and
stays within the card's limits; a plain emulation of the kernel's
summation order (per-chunk partial sums in source order, then the chunks
in order) agrees with the plain force law row by row at chip_smoke's
bound; ekf6's team layout gives every lane one thread per matrix row, and
its backward's pipelined factor forms every row once and in time. The
constants and index expressions these restate, and the Jacobian's nonzeros
that chip_smoke's operation count assumes, are read from the CUDA sources,
so the two cannot drift apart.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import JAC_NNZ, PAIRWISE_ROW_BOUND, law_rows, row_err
from epidemicmodeling_torch.ops.cuda import ekf6_kernel, pairwise_kernel
from epidemicmodeling_torch.ops.cuda.pairwise_kernel import (
    MAX_CHUNK, MIN_BLOCKS_PER_SM, SMS, pair_terms, pairwise_geometry)
from epidemicmodeling_torch.spatial import PopulationSimConfig
from epidemicmodeling_torch.spatial.agents import default_environment

CSRC = Path(pairwise_kernel.__file__).resolve().parents[2] / "csrc"
# an H100's limits: shared memory a block takes without opting in, and an
# SM's shared memory (less 1 KiB a block) and threads
SMEM_PER_BLOCK, SMEM_PER_SM, THREADS_PER_SM = 48 * 1024, 228 * 1024, 2048


def _min_resident_warps_per_sm(g) -> int:
    """The warps every SM holds at once when the grid is spread evenly: the
    blocks the least loaded SM gets, but no more than fit on it by shared
    memory, threads and the launch bound's register budget."""
    fit = min(SMEM_PER_SM // (g.smem_bytes + 1024),
              THREADS_PER_SM // g.threads, MIN_BLOCKS_PER_SM)
    per_sm = (g.row_tiles * g.chunks) // SMS
    return min(fit, per_sm) * g.threads // 32


def _source(source: str) -> str:
    return (CSRC / source).read_text()


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1)) if m.group(1).isdigit() else m.group(1)


def test_pairwise_constants_match_the_source():
    assert _constant("pairwise.cu", "THREADS") == pairwise_kernel.THREADS
    assert (_constant("pairwise.cu", "ROWS")
            == pairwise_kernel.ROWS_PER_THREAD)
    assert (_constant("pairwise.cu", "MIN_BLOCKS")
            == pairwise_kernel.MIN_BLOCKS_PER_SM)
    assert _constant("pairwise.cu", "MAX_CHUNK") == MAX_CHUNK


@pytest.mark.parametrize("O", [0, 914])
@pytest.mark.parametrize("N", [1, 127, 150, 20_000, 100_000])
def test_pairwise_geometry_covers_every_pair_once(N, O):
    g = pairwise_geometry(N, O)
    M = N + O
    # rows: block tile x, thread tid, row slot r -> tile * T * R + r * T + tid
    T, R = g.threads, g.rows_per_thread
    rows = (np.arange(g.row_tiles)[:, None, None] * T * R
            + np.arange(R)[None, :, None] * T
            + np.arange(T)[None, None, :]).ravel()
    live = rows[rows < N]
    assert np.array_equal(np.bincount(live, minlength=N), np.ones(N))
    assert rows.max() < N + T * R           # the dead rows are one edge
    # sources: chunk s holds [s * chunk, min(M, (s + 1) * chunk))
    starts = np.arange(g.chunks) * g.chunk
    ends = np.minimum(starts + g.chunk, M)
    assert (ends > starts).all()            # no empty chunk
    cover = np.zeros(M, np.int64)
    for a, b in zip(starts, ends):
        cover[a:b] += 1
    assert (cover == 1).all()
    # every (row, source) pair: each row once per chunk, each source in one
    # chunk, so N * M pairs in all
    assert len(live) * int((ends - starts).sum()) == N * M
    # the card's limits and the scratch the wrapper allocates
    assert g.threads <= 1024 and g.threads % 32 == 0
    assert g.smem_bytes == 8 * g.chunk <= SMEM_PER_BLOCK
    assert g.chunk <= MAX_CHUNK and g.chunks <= 65535
    assert g.scratch == (g.chunks, N, 2)
    if N >= 20_000:
        assert _min_resident_warps_per_sm(g) >= 8


def _emulated_forces(pos, obs, cfg):
    """The kernel's summation order in plain PyTorch, float32: each row's
    terms summed over each chunk in source order from 0, then the chunks'
    partial sums added in chunk order."""
    N = pos.shape[0]
    g = pairwise_geometry(N, obs.shape[0])
    tx, ty = pair_terms(pos, obs, cfg, torch.arange(N))
    partial = torch.zeros((g.chunks, N, 2), dtype=torch.float32)
    for s in range(g.chunks):
        acc_x = torch.zeros(N, dtype=torch.float32)
        acc_y = torch.zeros(N, dtype=torch.float32)
        for k in range(s * g.chunk, min((s + 1) * g.chunk, tx.shape[1])):
            acc_x = acc_x + tx[:, k]
            acc_y = acc_y + ty[:, k]
        partial[s, :, 0], partial[s, :, 1] = acc_x, acc_y
    out = partial[0].clone()
    for s in range(1, g.chunks):
        out = out + partial[s]
    return out, g


@pytest.mark.parametrize("N,O", [(150, 914), (2000, 914), (600, 0)])
def test_pairwise_summation_order_within_the_row_bound(N, O):
    cfg = PopulationSimConfig(n_subjects=N)
    _, obs = default_environment(cfg)
    rng = np.random.default_rng(N)
    p = rng.uniform([cfg.x_min, cfg.y_min], [cfg.x_max, cfg.y_max], (N, 2))
    p[1] = p[0]                                     # coincident agents
    p[3] = p[2] + [cfg.inter_subject_opt_dist, 0.0]  # on the sign flip
    pos = torch.tensor(p, dtype=torch.float32)
    o = torch.tensor(obs[:O], dtype=torch.float32).reshape(-1, 2)
    got, g = _emulated_forces(pos, o, cfg)
    assert g.chunks > 1
    ref, scale, slack = law_rows(pos, o, cfg, torch.arange(N))
    assert torch.isfinite(got).all()
    assert row_err(got, ref, scale, slack) <= PAIRWISE_ROW_BOUND


def test_ekf6_constants_match_the_source():
    assert _constant("ekf6.cu", "LANES") == ekf6_kernel.LANES
    assert _constant("ekf6.cu", "BLOCK") == "M * LANES"
    assert ekf6_kernel.BLOCK == ekf6_kernel.M * ekf6_kernel.LANES


# the index expressions of csrc/ekf6.cu that the layout checks below restate
EKF6_TEAM = ("const int r = threadIdx.x / LANES;",
             "const int l = threadIdx.x % LANES;",
             "const int b = blockIdx.x * LANES + l;",
             "const bool live = b < B;",
             "const int bl = live ? b : B - 1;",
             "return (B + LANES - 1) / LANES;")
EKF6_PIPELINE = ("auto factor_step = [&](int it) { return it - (M - r); };",
                 "for (int it = T - 2 + M; it >= 0; --it) {",
                 "const bool smooth = it <= T - 2;",
                 "if (s >= 0 && s <= T - 2) {",
                 "float* Ls = L_s[s % RING];",
                 "const float* Lt = L_s[t % RING];")


def _team_layout(B: int):
    """ekf6.cu's mapping of threads to work for B lanes: a grid of
    ceil(B / LANES) blocks of BLOCK threads, thread t of block k being row
    t // LANES of lane k * LANES + t % LANES. Returns (lane, row, live),
    each a (blocks, BLOCK) int64 / bool tensor; a thread whose lane is past
    B is dead (it reads lane B - 1 and stores nothing)."""
    LANES, BLOCK = ekf6_kernel.LANES, ekf6_kernel.BLOCK
    t = torch.arange(BLOCK)
    k = torch.arange(-(-B // LANES))[:, None]
    lane = k * LANES + t % LANES
    row = (t // LANES).expand_as(lane)
    return lane, row, lane < B


@pytest.mark.parametrize("T", [2, 3, 9, 532])
def test_ekf6_factor_pipeline_schedule(T):
    """The backward's pipelined Cholesky (csrc/ekf6.cu): iteration it runs
    from T - 2 + M down to 0, smooths step it when it <= T - 2, and thread r
    forms row r of step it - (M - r)'s factor in ring slot step % RING.
    Every row of every step is formed once, after the rows above it and
    before the step is smoothed, and no slot is reused while its factor is
    still to be read."""
    M = ekf6_kernel.M
    text = _source("ekf6.cu")
    assert all(line in text for line in EKF6_PIPELINE)
    assert _constant("ekf6.cu", "RING") == "M + 1"
    ring = M + 1
    formed = {}                 # (step, row) -> iteration
    slot_owner = {}             # slot -> step whose rows it holds
    for it in range(T - 2 + M, -1, -1):
        for r in range(M):
            s = it - (M - r)
            if 0 <= s <= T - 2:
                assert (s, r) not in formed
                assert all(formed[(s, j)] > it for j in range(r))
                # the slot is free, or already holds this step's rows
                assert slot_owner.get(s % ring, s) in (s, s + ring)
                if slot_owner.get(s % ring) == s + ring:
                    assert s + ring > it       # that step was smoothed
                slot_owner[s % ring] = s
                formed[(s, r)] = it
        if it <= T - 2:
            assert all(formed[(it, r)] > it for r in range(M))
            assert slot_owner[it % ring] == it
    assert len(formed) == (T - 1) * M


@pytest.mark.parametrize("B", [1, 31, 32, 300, 5875])
def test_ekf6_team_layout_covers_every_lane_once(B):
    text = _source("ekf6.cu")
    assert all(line in text for line in EKF6_TEAM)
    lane, row, live = _team_layout(B)
    blocks = -(-B // ekf6_kernel.LANES)
    assert lane.shape == (blocks, ekf6_kernel.BLOCK)
    # every (lane, row) of the B lanes and six rows, exactly once
    key = (lane[live] * ekf6_kernel.M + row[live]).numpy()
    assert np.array_equal(np.sort(key), np.arange(B * ekf6_kernel.M))
    # dead threads only past B, only in the last block
    assert (lane[~live] >= B).all()
    assert bool(live[:-1].all())
    # a warp is one row of 32 consecutive lanes: its row stores coalesce
    warps_row = row.reshape(blocks, ekf6_kernel.M, 32)
    assert bool((warps_row == warps_row[..., :1]).all())
    warps_lane = lane.reshape(blocks, ekf6_kernel.M, 32)
    assert bool((warps_lane.diff(dim=-1) == 1).all())


def test_ekf6_jacobian_nonzeros_match_the_source():
    """chip_smoke's ekf6 operation count skips the Jacobian's structural
    zeros: the entries ekf6.cu's jacobian() sets are exactly JAC_NNZ per
    row, and it zeroes the rest."""
    text = _source("ekf6.cu")
    body = text[text.index("void jacobian("):]
    body = body[:body.index("\n}\n")]
    assert "A[i][j] = 0.f;" in body
    entries = set(re.findall(r"A\[(\d)\]\[(\d)\] =", body))
    per_row = [sum(1 for i, _ in entries if int(i) == r) for r in range(6)]
    assert tuple(per_row) == JAC_NNZ
    assert sum(JAC_NNZ) == 21
