"""The card's roofline anchors (B5, csrc/roofline.cu), checked on the CPU.

B5's JAX bodies (``fma_kernel`` and ``copy_kernel`` in bench.py) are nested
inside ``measure_machine_anchors`` and read their blocks through TPU-only
``pltpu.VMEM`` specs (bench.py:101-127), so they cannot run on a CPU. The
plain versions stand in for them: ``copy_plus_one_plain`` is x + 1 and
``fma_chain_plain`` the 512-deep chain in float64. On a CPU tensor the
wrappers run those, so they are checked here against x + 1 bit for bit and
against a float32 emulation of the kernel's rounding.

The CUDA copy cannot run here either, so what surrounds it is checked in
Python: its launch geometry and the chunks each block walks
(``roofline_kernel.copy_geometry`` and the kernel's walk) cover the array's
4 n bytes exactly once in multiples of 16 bytes (the bulk copy's
granularity) and fit the card's shared memory, and the ring's order of
loads, waits and stores never refills a stage before its store has read
it. The constants and loop bounds these restate are read from the CUDA
source. tests/test_torch_cuda.py holds the library's own geometry against
``copy_geometry`` and the kernel against x + 1 on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import copy_check_sizes
from epidemicmodeling_torch.ops.cuda import roofline_kernel as rk

SOURCE = (Path(rk.__file__).resolve().parents[2] / "csrc"
          / "roofline.cu").read_text()
# an SM's shared memory, less 1 KiB a resident block; a bulk copy's
# transaction count must stay below 2**20 bytes
SMEM_PER_SM = 228 * 1024
MAX_TX = (1 << 20) - 1


def _schedule(n: int, sms: int) -> list:
    """The chunks each block of the copy walks, in its order: for block b,
    (byte offsets, byte sizes) of the chunks b, b + blocks, ...; the last
    chunk of the array holds what is left of its 4 n bytes."""
    g = rk.copy_geometry(n, sms)
    chunks = -(-4 * n // g.chunk_bytes)
    out = []
    for b in range(g.blocks):
        off = np.arange(b, chunks, g.blocks, dtype=np.int64) * g.chunk_bytes
        out.append((off, np.minimum(g.chunk_bytes, 4 * n - off)))
    return out


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in roofline.cu"
    return int(m.group(1))


def test_copy_constants_match_the_source():
    assert _constant("COPY_THREADS") == rk.COPY_THREADS
    assert _constant("CHUNK") == rk.CHUNK_BYTES
    assert _constant("STAGES") == rk.STAGES
    assert _constant("BLOCKS_PER_SM") == rk.BLOCKS_PER_SM
    assert _constant("SMEM_LIMIT") == rk.SMEM_LIMIT
    # the kernel's walk and the ring's order, as _schedule and
    # test_copy_ring_never_refills_a_stage_early restate them
    for line in (
            "const long long count = (chunks - blockIdx.x + gridDim.x - 1)"
            " / gridDim.x;",
            "return (blockIdx.x + k * gridDim.x) * (long long)CHUNK;",
            "for (long long k = 0; k < STAGES - 1 && k < count; ++k) load(k);",
            "wait_parity(shared_addr(&full[s]), (uint32_t)((k / STAGES) & 1));",
            "if (k + STAGES - 1 < count) {",
            'asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");',
            "load(k + STAGES - 1);",
            "const long long cap = (long long)BLOCKS_PER_SM * sms;"):
        assert line in SOURCE, line


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("case", range(10))
def test_copy_schedule_covers_every_byte_once(sms, case):
    """At chip_smoke.copy_check_sizes (the sizes the card checks bit for
    bit) on an H100 SXM's 132 SMs and a PCIe card's 114."""
    n = copy_check_sizes(sms)[case]
    g = rk.copy_geometry(n, sms)
    sched = _schedule(n, sms)
    chunks = -(-4 * n // rk.CHUNK_BYTES)
    assert g.blocks == len(sched) == min(chunks, rk.BLOCKS_PER_SM * sms)
    assert g == (g.blocks, rk.STAGES, rk.CHUNK_BYTES,
                 rk.STAGES * rk.CHUNK_BYTES)
    offs = np.concatenate([o for o, _ in sched])
    sizes = np.concatenate([s for _, s in sched])
    assert len(offs) == chunks
    assert (offs % 16 == 0).all() and (sizes % 16 == 0).all()
    assert (sizes > 0).all() and (sizes <= g.chunk_bytes).all()
    order = np.argsort(offs)
    ends = offs[order] + sizes[order]
    assert offs[order][0] == 0 and ends[-1] == 4 * n
    assert np.array_equal(offs[order][1:], ends[:-1])   # no gap, no overlap
    for b, (o, _) in enumerate(sched):
        # the kernel's count, and its walk b, b + blocks, ...
        assert len(o) == (chunks - b + g.blocks - 1) // g.blocks >= 1
        assert (np.diff(o) == g.blocks * g.chunk_bytes).all()
    counts = [len(o) for o, _ in sched]
    assert max(counts) - min(counts) <= 1       # at most a chunk of tail
    # the ring fits a block, and BLOCKS_PER_SM blocks fit an SM
    assert g.smem_bytes <= rk.SMEM_LIMIT
    assert rk.BLOCKS_PER_SM * (g.smem_bytes + 1024) <= SMEM_PER_SM
    assert g.chunk_bytes <= MAX_TX and g.chunk_bytes % (
        16 * rk.COPY_THREADS) == 0


@pytest.mark.parametrize("count", [1, 2, rk.STAGES - 1, rk.STAGES,
                                   rk.STAGES + 1, 3 * rk.STAGES + 2, 249])
def test_copy_ring_never_refills_a_stage_early(count):
    """One block's ring as csrc/roofline.cu orders it: thread 0 loads chunks
    0 .. STAGES - 2, then in iteration k every thread waits on chunk k's
    stage at parity (k / STAGES) & 1, the block stores it (commit group k),
    and thread 0 waits until all but the newest group have read shared
    memory before it loads chunk k + STAGES - 1 into the stage chunk k - 1
    used. Checked: a chunk is loaded before it is waited on, a stage is
    refilled only after its previous chunk's store has read it and never
    while the consumers use it, and each wait's parity is the phase that
    chunk's load completes."""
    S = rk.STAGES
    loaded_at = {}          # chunk -> the iteration its load was issued in
    phases = [0] * S        # completed phases of each stage's barrier
    holder = [None] * S     # the chunk in each stage
    for k in range(min(S - 1, count)):
        loaded_at[k] = -1
        holder[k % S] = k
    for k in range(count):
        s = k % S
        assert loaded_at[k] < k and holder[s] == k
        phases[s] += 1      # chunk k's bytes arrive: a phase completes
        parity = (k // S) & 1
        # try_wait.parity p returns once the phase of parity p completed
        assert phases[s] - 1 == k // S and (phases[s] - 1) & 1 == parity
        read_done = k - 1   # groups 0 .. k - 1 read after wait_group.read 1
        j = k + S - 1
        if j < count:
            t = j % S
            assert t != s
            assert holder[t] is None or holder[t] <= read_done
            holder[t] = j
            loaded_at[j] = k
    assert sorted(loaded_at) == list(range(count))


@pytest.mark.parametrize("n", [0, -4, 6, 4 * 1000 + 2])
def test_copy_geometry_refuses_what_the_kernel_cannot_take(n):
    with pytest.raises(ValueError, match="multiple of 4"):
        rk.copy_geometry(n, 132)


@pytest.mark.parametrize("n", [1, 7, 4096, 100_003])
def test_copy_plus_one_on_the_cpu_is_x_plus_one(n):
    x = torch.from_numpy(np.random.default_rng(n).uniform(
        -1e3, 1e3, n).astype(np.float32))
    before = rk.launches
    got = rk.copy_plus_one(x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, x + 1)
    assert np.array_equal(got.numpy(), x.numpy() + np.float32(1))
    assert rk.launches == before      # the plain version counts no launch


def test_fma_chain_on_the_cpu_within_the_kernels_rounding():
    """fma_chain's plain version (the chain in float64, rounded once) against
    a float32 emulation of the kernel: every step rounded to float32, as
    fmaf rounds, so the two differ by at most DEPTH + 1 roundings."""
    assert rk.FMA_A == float(np.float32(1.0000001))
    assert rk.FMA_B == float(np.float32(1e-9))
    x = np.random.default_rng(0).uniform(0, 1, 4096).astype(np.float32)
    emu = x.copy()
    for _ in range(rk.DEPTH):
        emu = (emu.astype(np.float64) * rk.FMA_A + rk.FMA_B).astype(
            np.float32)
    before = rk.launches
    got = rk.fma_chain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and rk.launches == before
    rel = np.abs(got.numpy().astype(np.float64) - emu) / np.abs(emu)
    assert rel.max() <= (rk.DEPTH + 1) * 2.0 ** -24
    # the chain moved every element: x a**512 + b (a**512 - 1) / (a - 1)
    assert (got.numpy() > x).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16, torch.int32])
@pytest.mark.parametrize("fn", [rk.copy_plus_one, rk.fma_chain])
def test_wrappers_refuse_other_types(fn, dtype):
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(8, dtype=dtype))


@pytest.mark.parametrize("fn", [rk.copy_plus_one, rk.fma_chain])
def test_wrappers_refuse_what_is_not_a_tensor(fn):
    with pytest.raises(ValueError, match="float32"):
        fn(np.zeros(8, np.float32))
