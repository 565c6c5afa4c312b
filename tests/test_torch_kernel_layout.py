"""The hand-written kernels' launch layouts, checked on the CPU (no card).

The CUDA kernels cannot run here, so what surrounds them is checked in
Python: the pairwise kernel's launch geometry (ops/cuda/pairwise_kernel.
pairwise_geometry) covers every (agent row, source) pair exactly once and
stays within the card's limits; a plain emulation of the kernel's
summation order (per-chunk partial sums in source order, then the chunks
in order) agrees with the plain force law row by row at chip_smoke's
bound; ekf6's team layout gives every lane one thread per matrix row, and
its backward's pipelined factor forms every row once and in time; the
NNLS kernel's blocks at the backtest's size fit one wave. The
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
from epidemicmodeling_torch.ops.cuda import (ekf3_kernel, ekf6_kernel,
                                             nnls_kernel, pairwise_kernel,
                                             rollout_kernel)
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
                 "Real* Ls = L_s[s % RING];",
                 "const Real* Lt = L_s[t % RING];")


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
    assert "A[i][j] = Real(0);" in body
    entries = set(re.findall(r"A\[(\d)\]\[(\d)\] =", body))
    per_row = [sum(1 for i, _ in entries if int(i) == r) for r in range(6)]
    assert tuple(per_row) == JAC_NNZ
    assert sum(JAC_NNZ) == 21


# ------------------------------------------------- the stencil (csrc/stencil.cu)

STENCIL_DTYPES = (torch.float32, torch.float64)
# the index expressions of csrc/stencil.cu that the checks below restate
STENCIL_BLOCKING = (
    "const int TX = ROWS - 2 * K, TY = NT - 2 * K;",
    "const int gx0 = blockIdx.y * TX - K;",
    "const int gy0 = blockIdx.x * TY - K;",
    "const dim3 grid((Ly + TY - 1) / TY, (Lx + TX - 1) / TX);",
    "const int lo = s + 1, hi = ROWS - s - 1;",
    "if (col_in && c >= lo && c < NT - s - 1 && r0 < r1) {",
    "const bool col_tile = c >= K && c < NT - K;",
    "const int rt0 = K, nt = (a.keep || last) && col_tile ? ROWS - 2 * K : 0;",
    "if ((unsigned)(r - rt0) < (unsigned)nt) *fp = v;",
    "const int r0 = lo > -gx0 ? lo : -gx0;",
    "const int r1 = hi < Lx - gx0 ? hi : Lx - gx0;",
    "const int off_n = off_d + P + sh_n - sh;",
    "const int s0 = j * KMAX, K = n - s0 < KMAX ? n - s0 : KMAX;",
    "const int L = (n + KMAX - 1) / KMAX;")
STENCIL_LOAD = (
    "for (int i = threadIdx.x; i < ROWS * NQ; i += NT) {",
    "const int r = i / NQ, q = i - r * NQ;",
    "T* dst = buf0 + r * P + V * q;",
    "const int gy = gy0 + V * q - shift(r);   // global column of dst[0]",
    "auto shift = [&](int r) { return (sh0 + r * dly) & (V - 1); };",
    "const int sh0 = (int)(first & (V - 1));",
    "const int dly = Ly & (V - 1);")


def _launch_geometry(Lx, Ly, dtype, K):
    """csrc/stencil.cu's launch of K steps: (tile rows, tile columns, grid
    (columns, rows)), the box of BOX_ROWS x THREADS cells less a halo of K
    a side."""
    from epidemicmodeling_torch.ops.cuda import stencil_kernel as sk
    TX, TY = sk.BOX_ROWS[dtype] - 2 * K, sk.THREADS - 2 * K
    return TX, TY, (-(-Ly // TY), -(-Lx // TX))


def test_stencil_constants_match_the_source():
    from epidemicmodeling_torch.ops.cuda import stencil_kernel as sk
    assert _constant("stencil.cu", "NT") == sk.THREADS
    for dt, tag in ((torch.float32, "F32"), (torch.float64, "F64")):
        assert _constant("stencil.cu", f"ROWS_{tag}") == sk.BOX_ROWS[dt]
        assert _constant("stencil.cu", f"KMAX_{tag}") == sk.STEPS_PER_LAUNCH[dt]
        # the largest launch keeps a tile, and within KCAP weight slots
        assert sk.BOX_ROWS[dt] - 2 * sk.STEPS_PER_LAUNCH[dt] >= 1
        assert sk.STEPS_PER_LAUNCH[dt] <= _constant("stencil.cu", "KCAP")
        # two buffers of ROWS + 1 rows (the box and the spare row the
        # window's look-ahead may read) of NT + V cells: two blocks on an SM
        # (each also takes its static weights and amounts and 1 KiB)
        size = torch.finfo(dt).bits // 8
        box = (sk.BOX_ROWS[dt] + 1) * (sk.THREADS + 16 // size) * size
        static = (4 * 8 + 32) * size
        assert 2 * (2 * box + static + 1024) <= SMEM_PER_SM
    text = _source("stencil.cu")
    assert all(line in text for line in STENCIL_BLOCKING + STENCIL_LOAD)


@pytest.mark.parametrize("dtype", STENCIL_DTYPES)
@pytest.mark.parametrize("shape", [(51, 51), (234, 167), (1000, 777),
                                   (2048, 2048), (8191, 8193), (2, 9),
                                   (9, 1), (3, 70)])
def test_stencil_tiles_cover_every_cell_once_per_step(shape, dtype):
    """For every launch size K <= KMAX: the tiles the blocks store partition
    the field (rows and columns each exactly once), each block's box holds
    its tile plus a halo of K cells a side, and each step computes only
    from cells the step before computed (or the load brought), so the last
    step's cells, the tile, depend on the box alone."""
    from epidemicmodeling_torch.ops.cuda import stencil_kernel as sk
    Lx, Ly = shape
    ROWS, NT = sk.BOX_ROWS[dtype], sk.THREADS
    for K in range(1, sk.STEPS_PER_LAUNCH[dtype] + 1):
        TX, TY, (gx, gy) = _launch_geometry(Lx, Ly, dtype, K)
        assert gx <= 2 ** 31 - 1 and gy <= 65535
        for L, T_, box in ((Lx, TX, ROWS), (Ly, TY, NT)):
            blocks = -(-L // T_)
            cover = np.zeros(L, np.int64)
            for k in range(blocks):
                g0 = k * T_ - K                  # box index 0
                tile = np.arange(g0 + K, g0 + box - K)   # stored box indices
                assert len(tile) == T_
                # the halo: the box reaches K cells past the tile each side
                assert g0 <= tile[0] - K and g0 + box - 1 >= tile[-1] + K
                cover[tile[(tile >= 0) & (tile < L)]] += 1
            assert (cover == 1).all()
        # the valid region shrinks one cell a step from the loaded box: step
        # s computes box rows [s + 1, ROWS - s - 1) from rows [s, ROWS - s)
        valid = (0, ROWS)
        for s in range(K):
            lo, hi = s + 1, ROWS - s - 1
            assert valid[0] <= lo - 1 and hi + 1 <= valid[1]
            # the look-ahead row r + 2 of the window stays within the
            # buffer's ROWS + 1 rows
            assert hi + 1 <= ROWS
            valid = (lo, hi)
        assert valid == (K, ROWS - K)
        assert K <= sk.STEPS_PER_LAUNCH[dtype] <= (ROWS - 1) // 2


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 9, 25, 249, 500])
def test_stencil_launches_split_the_steps(n):
    """A rollout of n steps is ceil(n / KMAX) launches of KMAX steps, the
    last one shorter, covering every step once and in order."""
    from epidemicmodeling_torch.ops.cuda import stencil_kernel as sk
    for dt in STENCIL_DTYPES:
        kmax = sk.STEPS_PER_LAUNCH[dt]
        L = (n + kmax - 1) // kmax
        steps = []
        for j in range(L):
            s0 = j * kmax
            K = min(kmax, n - s0)
            assert 1 <= K <= kmax
            steps += range(s0, s0 + K)
        assert steps == list(range(n)) and L == -(-n // kmax)


@pytest.mark.parametrize("dtype", STENCIL_DTYPES)
@pytest.mark.parametrize("Ly", [1, 2, 5, 167, 777, 8193])
def test_stencil_box_load_is_aligned_and_complete(Ly, dtype):
    """The load puts box cell (r, c) at r * P + shift(r) + c, shift(r) being
    the misalignment of the row's first global cell: every 16-byte copy is
    aligned in device memory and in shared memory, each of the box's NT
    columns is written exactly once a row, and nothing lands past the
    row's pitch. Checked for field offsets 0..V-1 and blocks at the field's
    left edge, inside it and past its right edge."""
    from epidemicmodeling_torch.ops.cuda import stencil_kernel as sk
    size = torch.finfo(dtype).bits // 8
    V, NT, ROWS = 16 // size, sk.THREADS, sk.BOX_ROWS[dtype]
    P, NQ = NT + V, NT // V + 1
    for base in range(V):                 # the field's offset, in elements
        for gx0, gy0 in ((-2, -3), (5, 17), (1, Ly - 7)):
            first = base + gx0 * Ly + gy0
            sh0, dly = first & (V - 1), Ly & (V - 1)
            for r in range(ROWS):
                sh = (sh0 + r * dly) & (V - 1)
                assert sh == (base + (gx0 + r) * Ly + gy0) % V
                seen = np.zeros(P, np.int64)
                for q in range(NQ):
                    gy = gy0 + V * q - sh           # global column of dst[0]
                    dst = r * P + V * q
                    assert (dst * size) % 16 == 0
                    if 0 <= gy and gy + V <= Ly:    # a full vector
                        assert (base + (gx0 + r) * Ly + gy) % V == 0
                    seen[V * q:V * q + V] += 1
                cols = np.arange(NT) + sh           # where columns 0..NT-1 sit
                assert (seen[cols] == 1).all() and seen.sum() == NQ * V <= P


# ------------------------------------------------------ ekf3 (csrc/ekf3.cu)

EKF3_CHAIN = (
    "const int b0 = blockIdx.x * LB;",
    "const int nl = B - b0 < LB ? B - b0 : LB;   // live lanes of this block",
    "const int b = b0 + l;",
    "const bool chain = l < nl;                  // this thread runs lane b",
    "for (int i = threadIdx.x; i < nl * (T - 1); i += THREADS) {",
    "const int ll = i % nl, t = i / nl, bb = b0 + ll;",
    "if (t % CHUNK == 0) {",
    "if (t + CHUNK < T) prefetch(t / CHUNK + 1);",
    "in_ring + ((t / CHUNK) % SLOTS * CHUNK + t % CHUNK) * NIN * LB + l;",
    "if (t == nrows - 1 || t % CHUNK == CHUNK - 1) {",
    "if (t >= CHUNK) prefetch_rows(t / CHUNK - 1);",
    "if (!SMEM_HIST && nrows > 0) prefetch_rows((nrows - 1) / CHUNK);",
    "row = rec_ring + ((t / CHUNK) % SLOTS * CHUNK + t % CHUNK) * RREC * LB + l;",
    "size_t fit = SMEM_LIMIT / (sizeof(Real) * (ring + (size_t)T * REC));",
    "g.smem_hist = fit >= 1 && (B + (int)fit - 1) / (int)fit <= SMS;",
    "g.lanes = g.smem_hist ? (int)fit : MAX_LANES;")


def test_ekf3_constants_match_the_source():
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel as ek
    for name in ("THREADS", "MAX_LANES", "SMS", "SMEM_LIMIT", "CHUNK",
                 "SLOTS", "RREC"):
        assert _constant("ekf3.cu", name) == getattr(ek, name), name
    assert _constant("ekf3.cu", "NIN") == "NPI + 2"
    assert ek.NIN == ek.NPI + 2
    text = _source("ekf3.cu")
    assert "E_J = 6, REC = 18 };" in text and ek.REC == 18
    # the recursion's RREC floats (S+, S-, J) lead the record
    assert "enum { E_SP = 0, E_SMN = 3, E_PP = 6, E_PM = 12," in text
    assert ek.RREC == 3 + 3 + 9
    assert all(line in text for line in EKF3_CHAIN)
    assert ek.MAX_LANES <= 32 <= ek.THREADS      # the lanes are warp 0


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 440, 532, 3000, 4000])
@pytest.mark.parametrize("B", [1, 31, 235, 1000, 5875])
def test_ekf3_layout_covers_every_lane_once(T, B, itemsize):
    """ekf3_geometry (the kernel's choice) in both instances (float, double):
    every lane runs on exactly one thread of warp 0 of one block, each
    block's (lane, step) gain items are each taken once by its THREADS
    threads, and the shared memory fits."""
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel as ek
    g = ek.ekf3_geometry(T, B, itemsize)
    assert 1 <= g.lanes <= ek.MAX_LANES and g.blocks == -(-B // g.lanes)
    lanes = np.concatenate([k * g.lanes + np.arange(min(g.lanes,
                                                        B - k * g.lanes))
                            for k in range(g.blocks)])
    assert np.array_equal(lanes, np.arange(B))
    assert (lanes % g.lanes < 32).all()
    assert g.smem_bytes <= ek.SMEM_LIMIT
    if g.smem_hist:
        assert g.blocks <= ek.SMS and g.hist_floats == 0
        assert g.smem_bytes == itemsize * g.lanes * (
            ek.SLOTS * ek.CHUNK * ek.NIN + T * ek.REC)
    else:
        assert g.lanes == ek.MAX_LANES and g.hist_floats == T * ek.REC * B
    nl = min(g.lanes, B)
    items = [(i % nl, i // nl) for t0 in range(ek.THREADS)
             for i in range(t0, nl * (T - 1), ek.THREADS)]
    assert sorted(items) == [(lane, t) for lane in range(nl)
                             for t in range(T - 1)]


def _ring_schedule(T, chunk, slots, forward):
    """Emulate an ekf3 ring: the forward input ring (steps 0 .. T-1, chunk
    0 requested first, at each chunk's first step a wait for everything
    requested and the next chunk requested) or the backward record ring
    (rows T-2 .. 0, the last chunk requested first, at each chunk's first
    row going down a wait and the chunk below requested). Returns nothing;
    asserts that a step reads a slot holding its chunk, landed, and that no
    chunk is written over one with steps still to read."""
    rows = T if forward else T - 1
    if rows <= 0:
        return
    n_chunks = -(-rows // chunk)
    slot = {}                         # slot -> (chunk, landed)
    read = set()
    def request(c):
        s = c % slots
        if s in slot:
            old = slot[s][0]
            span = range(old * chunk, min(rows, (old + 1) * chunk))
            assert all(t in read for t in span), "overwrote unread steps"
        slot[s] = (c, False)
    order = range(rows) if forward else range(rows - 1, -1, -1)
    request(0 if forward else n_chunks - 1)
    for t in order:
        c = t // chunk
        if forward and t % chunk == 0:
            slot = {k: (v[0], True) for k, v in slot.items()}
            if t + chunk < T:
                request(c + 1)
        if not forward and (t == rows - 1 or t % chunk == chunk - 1):
            slot = {k: (v[0], True) for k, v in slot.items()}
            if t >= chunk:
                request(c - 1)
        assert slot[c % slots] == (c, True), f"step {t} not in place"
        read.add(t)
    assert read == set(range(rows))


@pytest.mark.parametrize("T", [1, 2, ekf3_kernel.CHUNK - 1, ekf3_kernel.CHUNK,
                               ekf3_kernel.CHUNK + 1, 2 * ekf3_kernel.CHUNK,
                               2 * ekf3_kernel.CHUNK + 1, 440, 532])
def test_ekf3_rings_never_overwrite_unread_chunks(T):
    for forward in (True, False):
        _ring_schedule(T, ekf3_kernel.CHUNK, ekf3_kernel.SLOTS, forward)


def test_nnls_constants_match_the_source():
    for name in ("THREADS", "MAX_P"):
        assert _constant("nnls.cu", name) == getattr(nnls_kernel, name), name
    assert nnls_kernel.MAX_P == 32      # a column a lane of one warp


@pytest.mark.parametrize("itemsize", [4, 8])
def test_nnls_blocks_fit_one_wave_at_the_backtest_size(itemsize):
    """235 regions, a block each: the blocks an SM holds (its shared
    memory over a block's static p x p matrices, vectors and partial sums
    with 1 KiB reserved, and its threads) cover the 235 blocks in one wave
    on SMS SMs, whatever the days, which the block reads from device
    memory."""
    R = 235
    P = nnls_kernel.MAX_P
    static = (2 * P * (P + 1) + 3 * P + nnls_kernel.THREADS // 32) * itemsize
    assert static == {4: 8864, 8: 17728}[itemsize]     # ptxas on sm_90a
    fit = min(SMEM_PER_SM // (static + 1024),
              THREADS_PER_SM // nnls_kernel.THREADS)
    assert fit >= 2 and -(-R // fit) <= SMS


def test_rollout_constants_match_the_source():
    """The rollout wrapper's block size, its NPI count and its order of the
    per-region parameters are csrc/rollout.cu's."""
    assert _constant("rollout.cu", "THREADS") == rollout_kernel.THREADS
    assert _constant("rollout.cu", "NPI") == rollout_kernel.NPI
    m = re.search(r"enum \{ ([^}]+) \};", _source("rollout.cu"))
    names = [n.strip() for n in m.group(1).split(",")]
    assert names[-1] == "NPARAM"
    assert len(names) - 1 == len(rollout_kernel.REGION_PARAMS) == 9
    assert [n.lower() for n in names[:6]] == [
        "dt", "beta", "gamma", "b", "alpha_min", "alpha_max"]
    assert list(rollout_kernel.REGION_PARAMS[:6]) == [
        "dt", "beta", "gamma", "b", "alpha_min", "alpha_max"]
