// Shared device helpers for the hand-written EKS kernels (ekf3.cu, ekf6.cu).
//
// Layout convention, kept from the Pallas kernels' interface: every array is
// lanes-last, (T, C, B) row-major, so element (t, c, b) lives at
// (t * C + c) * B + b. One thread owns one lane b; the 32 threads of a warp
// own 32 neighbouring lanes, so every load and store below is coalesced.
//
// Every helper is a template on the scalar type Real: each kernel has a
// float and a double instance, and the dtype of the caller's tensors picks
// one (the MATLAB reference computes in double).
//
// Built with -O3 and WITHOUT --use_fast_math: the NaN masks, IEEE division
// and IEEE square root are part of the semantics (NaN observations mean
// "predict only", NaN inputs mean "optimize", NaN terminal entries mean
// "unconstrained").
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

// What differs between the two instances beyond the width of a value: the
// Cholesky pivot floor (the plain version's finfo(dtype).tiny) and the
// IEEE square root of that width.
template <typename Real>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float root(float v) { return sqrtf(v); }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double root(double v) { return sqrt(v); }
};

// max(lo, min(hi, v)) with MATLAB NaN semantics: NaN -> hi, then lo.
template <typename Real>
__device__ __forceinline__ Real clip_lo_hi(Real v, Real lo, Real hi) {
  const Real mn = v < hi ? v : hi;
  return mn > lo ? mn : lo;
}

// min(hi, max(lo, v)): NaN -> lo.
template <typename Real>
__device__ __forceinline__ Real clip_hi_lo(Real v, Real lo, Real hi) {
  const Real mx = v > lo ? v : lo;
  return mx < hi ? mx : hi;
}

// Element (t, c, b) of a lanes-last (T, C, B) array.
__device__ __forceinline__ size_t at3(int t, int c, int C, int b, int B) {
  return ((size_t)t * C + c) * (size_t)B + b;
}

// One value from device memory into shared memory, asynchronously
// (cp.async of the value's width; a plain copy where no card compiles it).
template <typename Real>
__device__ __forceinline__ void cp_async(Real* dst, const Real* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(Real) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// C = A @ B and C = A @ B^T for M x M register matrices, j summed in order.
template <int M, typename Real>
__device__ __forceinline__ void matmul(const Real (&A)[M][M],
                                       const Real (&Bm)[M][M],
                                       Real (&Cm)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      Real acc = A[i][0] * Bm[0][k];
#pragma unroll
      for (int j = 1; j < M; ++j) acc += A[i][j] * Bm[j][k];
      Cm[i][k] = acc;
    }
}

template <int M, typename Real>
__device__ __forceinline__ void matmul_t(const Real (&A)[M][M],
                                         const Real (&Bm)[M][M],
                                         Real (&Cm)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      Real acc = A[i][0] * Bm[k][0];
#pragma unroll
      for (int j = 1; j < M; ++j) acc += A[i][j] * Bm[k][j];
      Cm[i][k] = acc;
    }
}

// In-place symmetrization P <- (P + P^T) / 2.
template <int M, typename Real>
__device__ __forceinline__ void symmetrize(Real (&P)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i + 1; j < M; ++j) {
      const Real v = Real(0.5) * (P[i][j] + P[j][i]);
      P[i][j] = v;
      P[j][i] = v;
    }
}

// Unrolled Cholesky factor L (lower) of the SPD matrix Pm, every pivot
// floored at the reference's `tiny` (FLT_MIN, DBL_MIN).
template <int M, typename Real>
__device__ __forceinline__ void cholesky_floored(const Real (&Pm)[M][M],
                                                 Real (&L)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      Real acc = Pm[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= L[i][k] * L[j][k];
      if (i == j)
        L[i][j] = Num<Real>::root(acc > Num<Real>::tiny() ? acc
                                                          : Num<Real>::tiny());
      else
        L[i][j] = acc / L[j][j];
    }
}

// One row of the smoother gain: Jc = PAtc * inv(L L^T), by forward and
// backward substitution.
template <int M, typename Real>
__device__ __forceinline__ void gain_row(const Real (&L)[M][M],
                                         const Real (&PAtc)[M],
                                         Real (&Jc)[M]) {
  Real y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Real acc = PAtc[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[i][k] * y[k];
    y[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    Real acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc -= L[k][i] * Jc[k];
    Jc[i] = acc / L[i][i];
  }
}

// Smoother gain J = PAt * inv(Pm) for SPD Pm, row by row.
template <int M, typename Real>
__device__ __forceinline__ void smoother_gain(const Real (&Pm)[M][M],
                                              const Real (&PAt)[M][M],
                                              Real (&J)[M][M]) {
  Real L[M][M];
  cholesky_floored<M>(Pm, L);
#pragma unroll
  for (int c = 0; c < M; ++c) gain_row<M>(L, PAt[c], J[c]);
}

// Fixed-R adaptation window (GEKF.m:171-185), one per thread in local
// memory: newest-first rolling means of the innovation and of its squared
// deviation over the last L steps (zeros before the first step).
template <typename Real, int MAXL>
struct AdaptiveR {
  Real mean_win[MAXL];
  Real cov_win[MAXL];
  int head;
  Real R, R_prior;

  __device__ void init(Real r0, int L) {
    for (int i = 0; i < L; ++i) {
      mean_win[i] = Real(0);
      cov_win[i] = Real(0);
    }
    head = 0;
    R = r0;
    R_prior = r0;
  }

  // Push step t's innovation into both windows; R becomes step t+1's R.
  __device__ void update(int t, Real innov, bool valid, int L, Real beta,
                         Real one_minus_beta) {
    head = head == 0 ? L - 1 : head - 1;   // slot of the newest entry
    const Real cnt = (Real)(t + 1 < L ? t + 1 : L);
    mean_win[head] = innov;
    Real acc = Real(0);
    for (int j = 0; j < L; ++j) {
      int idx = head + j;
      acc += mean_win[idx >= L ? idx - L : idx];
    }
    const Real mu = acc / cnt;
    const Real d = innov - mu;
    cov_win[head] = d * d;
    acc = Real(0);
    for (int j = 0; j < L; ++j) {
      int idx = head + j;
      acc += cov_win[idx >= L ? idx - L : idx];
    }
    const Real R_estim = acc / cnt;
    // a NaN step resets R to the fixed prior: GEKF.m:180-185 skips the
    // R(:,:,k+1) write, so the cell keeps the prior
    R = valid ? beta * R + one_minus_beta * R_estim : R_prior;
  }
};
