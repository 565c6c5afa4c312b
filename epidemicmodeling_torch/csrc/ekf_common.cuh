// Shared device helpers for the hand-written EKS kernels (ekf3.cu, ekf6.cu).
//
// Layout convention, kept from the Pallas kernels' interface: every array is
// lanes-last, (T, C, B) row-major, so element (t, c, b) lives at
// (t * C + c) * B + b. One thread owns one lane b; the 32 threads of a warp
// own 32 neighbouring lanes, so every load and store below is coalesced.
//
// Built with -O3 and WITHOUT --use_fast_math: the NaN masks, IEEE division
// and IEEE square root are part of the semantics (NaN observations mean
// "predict only", NaN inputs mean "optimize", NaN terminal entries mean
// "unconstrained").
#pragma once

#include <cuda_runtime.h>
#include <float.h>

#define EKF_THREADS 128

// max(lo, min(hi, v)) with MATLAB NaN semantics: NaN -> hi, then lo.
__device__ __forceinline__ float clip_lo_hi(float v, float lo, float hi) {
  const float mn = v < hi ? v : hi;
  return mn > lo ? mn : lo;
}

// min(hi, max(lo, v)): NaN -> lo.
__device__ __forceinline__ float clip_hi_lo(float v, float lo, float hi) {
  const float mx = v > lo ? v : lo;
  return mx < hi ? mx : hi;
}

// Element (t, c, b) of a lanes-last (T, C, B) array.
__device__ __forceinline__ size_t at3(int t, int c, int C, int b, int B) {
  return ((size_t)t * C + c) * (size_t)B + b;
}

// C = A @ B and C = A @ B^T for M x M register matrices, j summed in order.
template <int M>
__device__ __forceinline__ void matmul(const float (&A)[M][M],
                                       const float (&Bm)[M][M],
                                       float (&Cm)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float acc = A[i][0] * Bm[0][k];
#pragma unroll
      for (int j = 1; j < M; ++j) acc += A[i][j] * Bm[j][k];
      Cm[i][k] = acc;
    }
}

template <int M>
__device__ __forceinline__ void matmul_t(const float (&A)[M][M],
                                         const float (&Bm)[M][M],
                                         float (&Cm)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float acc = A[i][0] * Bm[k][0];
#pragma unroll
      for (int j = 1; j < M; ++j) acc += A[i][j] * Bm[k][j];
      Cm[i][k] = acc;
    }
}

// In-place symmetrization P <- (P + P^T) / 2.
template <int M>
__device__ __forceinline__ void symmetrize(float (&P)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i + 1; j < M; ++j) {
      const float v = 0.5f * (P[i][j] + P[j][i]);
      P[i][j] = v;
      P[j][i] = v;
    }
}

// Unrolled Cholesky factor L (lower) of the SPD matrix Pm, every pivot
// floored at FLT_MIN (the f32 `tiny` of the reference).
template <int M>
__device__ __forceinline__ void cholesky_floored(const float (&Pm)[M][M],
                                                 float (&L)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = Pm[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= L[i][k] * L[j][k];
      if (i == j)
        L[i][j] = sqrtf(acc > FLT_MIN ? acc : FLT_MIN);
      else
        L[i][j] = acc / L[j][j];
    }
}

// One row of the smoother gain: Jc = PAtc * inv(L L^T), by forward and
// backward substitution.
template <int M>
__device__ __forceinline__ void gain_row(const float (&L)[M][M],
                                         const float (&PAtc)[M],
                                         float (&Jc)[M]) {
  float y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float acc = PAtc[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[i][k] * y[k];
    y[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc -= L[k][i] * Jc[k];
    Jc[i] = acc / L[i][i];
  }
}

// Smoother gain J = PAt * inv(Pm) for SPD Pm, row by row.
template <int M>
__device__ __forceinline__ void smoother_gain(const float (&Pm)[M][M],
                                              const float (&PAt)[M][M],
                                              float (&J)[M][M]) {
  float L[M][M];
  cholesky_floored<M>(Pm, L);
#pragma unroll
  for (int c = 0; c < M; ++c) gain_row<M>(L, PAt[c], J[c]);
}

// Fixed-R adaptation window (GEKF.m:171-185), one per thread in local
// memory: newest-first rolling means of the innovation and of its squared
// deviation over the last L steps (zeros before the first step).
template <int MAXL>
struct AdaptiveR {
  float mean_win[MAXL];
  float cov_win[MAXL];
  int head;
  float R, R_prior;

  __device__ void init(float r0, int L) {
    for (int i = 0; i < L; ++i) {
      mean_win[i] = 0.f;
      cov_win[i] = 0.f;
    }
    head = 0;
    R = r0;
    R_prior = r0;
  }

  // Push step t's innovation into both windows; R becomes step t+1's R.
  __device__ void update(int t, float innov, bool valid, int L, float beta,
                         float one_minus_beta) {
    head = head == 0 ? L - 1 : head - 1;   // slot of the newest entry
    const float cnt = (float)(t + 1 < L ? t + 1 : L);
    mean_win[head] = innov;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) {
      int idx = head + j;
      acc += mean_win[idx >= L ? idx - L : idx];
    }
    const float mu = acc / cnt;
    const float d = innov - mu;
    cov_win[head] = d * d;
    acc = 0.f;
    for (int j = 0; j < L; ++j) {
      int idx = head + j;
      acc += cov_win[idx >= L ? idx - L : idx];
    }
    const float R_estim = acc / cnt;
    // a NaN step resets R to the fixed prior: GEKF.m:180-185 skips the
    // R(:,:,k+1) write, so the cell keeps the prior
    R = valid ? beta * R + one_minus_beta * R_estim : R_prior;
  }
};
