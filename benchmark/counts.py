"""Operations and bytes that the filters' outputs need, and the card's
published peaks: the yardstick of every roofline and mfu metric.

The peaks, ``EKF6_OPS`` and the byte counts are frozen copies from
``chip_smoke.py`` (``PEAK_BYTES_PER_S``, ``PEAK_F32_PER_S``, ``EKF6_OPS``,
``ekf_bound``). ``EKF3_OPS`` is derived here the same way as ``EKF6_OPS``
(chip_smoke counts ekf3 from csrc/ekf3.cu as written, which a rewrite of
the kernel would make stale): the float32 operations that ekf3's outputs
(smoothed, filtered and predicted states) need, whatever implements them.
Every division and square root is one operation, a compare-and-select one;
a product with the Jacobian A skips its structural zeros; the smoothed
covariance, which no output reads, is not counted; lane constants count
once a step, as in ``EKF6_OPS``.

Counts depend on the shapes only (lanes, steps), never on launches, so a
change that re-chunks or fuses the kernels leaves them as they are.
"""

from __future__ import annotations

# NVIDIA H100 SXM (700 W): HBM bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# ---- ekf6: the 6-state optimal-control EKS (frozen from chip_smoke.py) ----
# A has JAC_NNZ[i] nonzeros in row i (21 of 36): each column of A X, and
# each row of X A^T, takes sum_i (2 nnz_i - 1) operations. C has one row
# with 3 nonzeros, so K C is rank one.
JAC6_NNZ = (3, 3, 2, 4, 4, 5)
A6_PRODUCT_OPS = 6 * sum(2 * n - 1 for n in JAC6_NNZ)
EKF6_OPS = {
    # forward
    "observation, innovation": 7, "P C^T, S, K": 43,
    "(I - KC) P": 72, "((I - KC) P) (I - KC)^T": 30 + 72,
    "+ K K^T R, / gamma": 144,
    "two symmetrizations": 60, "filtered state, margins": 18,
    "12 inputs: bang-bang fill, drive, band terms": 12 * 18 + 4,
    "Euler step, margins": 40, "Jacobian entries": 40,
    "A Pp A^T + Q": 2 * A6_PRODUCT_OPS + 6,
    # backward
    "Jacobian: band terms, entries": 12 * 11 + 40, "Pp A^T": A6_PRODUCT_OPS,
    "Cholesky of P-": 91, "six gain rows": 6 * 72,
    "smoothed state, margins": 114, "bang-bang law on it": 12 * 6,
}

# ---- ekf3: the 3-state SI-alpha EKS --------------------------------------
JAC3_NNZ = (3, 3, 1)
A3_PRODUCT_OPS = 3 * sum(2 * n - 1 for n in JAC3_NNZ)
EKF3_OPS = {
    # forward
    # s0 s1 s2, its margin, the innovation, the NaN test and select
    "observation, innovation": 6,
    "observation row C": 3,
    # P C^T (3 x (3 + 2)), S = C.PC^T + gamma R (5 + 2), K (3 + 3 selects)
    "P C^T, S, K": 15 + 7 + 6,
    # P - K (P C^T)^T
    "(I - KC) P": 18,
    # X C^T (15), X - (X C^T) K^T (18)
    "((I - KC) P) (I - KC)^T": 15 + 18,
    # K K^T (9), times R (9), plus (9), divided by gamma (9)
    "+ K K^T R, / gamma": 36,
    # 3 off-diagonal pairs (add, halve) each
    "two symmetrizations": 12,
    # s + K innov (3 + 3), 3 selects, 3 two-sided clips
    "filtered state, margins": 15,
    # 12 NPIs: u_max - u, times a, summed (12 + 12 + 11)
    "12 inputs: drive": 35,
    # drive (5), s (6), i (6), alpha (4), margins in the clips
    "Euler step, margins": 21,
    "Jacobian entries": 12,
    "A Pp A^T + Q": 2 * A3_PRODUCT_OPS + 3,
    # backward
    "Jacobian entries (smoother)": 12,
    "Pp A^T": A3_PRODUCT_OPS,
    # three pivots (floor and root), three quotients, the updates
    "Cholesky of P-": 17,
    # forward and backward substitution, three right-hand sides
    "three gain rows": 3 * 18,
    # s_sm - s_minus (3), J times it (15), plus s_plus (3), margins (6)
    "smoothed state, margins": 27,
}

OPS_PER_LANE_STEP = {"ekf3": sum(EKF3_OPS.values()),
                     "ekf6": sum(EKF6_OPS.values())}

# float32 words each call reads or writes once: per lane and step (inputs
# u, x, Rv; the returned outputs) and per lane (parameters, initial and
# terminal conditions)
WORDS_PER_LANE_STEP = {"ekf3": 12 + 2 + 3 * 3, "ekf6": 12 + 2 + 6 + 12 + 6}
WORDS_PER_LANE = {"ekf3": 11 + 2 * 12 + 3 + 9 + 3 + 9,
                  "ekf6": 14 + 4 * 12 + 6 + 36 + 6 + 36}


def work(kernel: str, steps: int, lanes: int) -> tuple:
    """(float32 operations, bytes) that one call of ``kernel`` over
    ``lanes`` filters of ``steps`` steps needs."""
    ops = OPS_PER_LANE_STEP[kernel] * steps * lanes
    nbytes = 4 * (WORDS_PER_LANE_STEP[kernel] * steps * lanes
                  + WORDS_PER_LANE[kernel] * lanes)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the operations over the float32
    peak or the bytes over the memory rate, whichever is longer."""
    return max(ops / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S)
