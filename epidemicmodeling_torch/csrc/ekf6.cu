// 6-state optimal-control EKF/EKS for Hopper (sm_90a): the CUDA port of the
// Pallas kernels _fwd_kernel / _bwd_kernel behind ekf6_pallas
// (epidemicmodeling_tpu/ops/pallas/ekf6_kernel.py:160, :286, :446).
//
// What it computes (Tools/SIAlphaModelEKFOptControlled.m semantics): the
// 3-state SI-alpha filter of ekf3.cu plus three costates, where every NaN
// input is filled by the bang-bang law (phi = eps*w - gamma*lambda3*a;
// u = u_min where phi > 0, else u_max), the Jacobian carries the sigma-band
// term A[2][5] (which tests the RAW, unfilled input), C has three nonzero
// entries while K has six, and the margins are [0,1] / [0,1] /
// [alpha_min, alpha_max] with the costates free. The backward pass is the
// RTS smoother with an unrolled 6x6 Cholesky; it re-applies the bang-bang
// law to the smoothed states to give U_OPT_SMOOTH, whose last row is 0 (a
// reference convention: the MATLAB loop never writes it). The smoothed
// covariance, which no output reads, is not computed.
//
// What bounds it on the card: a sequential chain of T dependent steps per
// lane (~2.2k operations forward, ~1.3k backward, with IEEE divisions and
// square roots), so latency sets the time unless the chain is spread over
// threads. The design: a team of six threads per lane, one per row of the
// 6x6 matrices. A block holds LANES = 32 lanes in six warps, and warp r is
// row r of all 32 lanes, so every row store of S_*, P_* and U_SM is one
// coalesced 128-byte line across lanes in the lanes-last layout. The team
// exchanges rows through shared memory: each thread writes its row of an
// unsymmetrised product, the block synchronises, and every thread reads
// the whole matrix and symmetrises it itself. Each matrix element is a dot
// product in the same order as ekf_common.cuh's matmul, matmul_t and
// symmetrize, so the design changes where an element is computed, not how.
// - Forward, per step: every thread forms C, the gain K and the filtered
//   state redundantly (cheap, and needed whole); thread r forms row r of
//   (I-KC) P, of the Joseph update, of A Pp and of A Pp A^T + Q, and the
//   terms of inputs r and r + 6 in the two sums over the 12 inputs (the
//   drive of alpha and the band term A[2][5]), which every thread then adds
//   in input order. Two block barriers a step. The step's inputs (u, x, R)
//   are prefetched one step ahead into shared memory with cp.async,
//   double-buffered. With adaptive R, warp 0 alone keeps the innovation
//   window and publishes R.
// - Backward, per step: P-_{t+1} is factored once per lane, in a pipeline
//   through shared memory: thread r forms row r of the Cholesky factor of
//   step t + 6 - r, from the rows above it formed in earlier iterations, so
//   each thread takes one row of one factor a step and all six rows of
//   step t are in place when step t comes (the factors do not depend on
//   the smoothed states). The team shares the band terms of A[2][5] as in
//   the forward; thread r then solves row r of the gain J and forms row r
//   of the smoothed state, which the team exchanges through shared memory;
//   U_OPT_SMOOTH's rows of step t+1 (two a thread) follow one barrier
//   later. Two block barriers a step. The next iteration's S_PLUS, P_PLUS,
//   S_MINUS, u and factor rows are prefetched into shared memory with
//   cp.async, double-buffered, while this one computes.
// - P_MINUS and P_PLUS hold only the lower triangles of the symmetric
//   covariances (21 of 36 floats a step and lane).
// - vecs (a, u_min, u_max, w) sit in shared memory, loaded once per lane;
//   the scalar rows in registers.
// The ragged last block reads lane B-1's data for its dead lanes and
// stores nothing for them. 5,875 lanes (the Pareto sweep's chunk) give 184
// blocks of 192 threads, about 8 warps per SM on 132 SMs.
//
// Two instances of one template on the scalar type Real: float and double
// (entries ekf6_forward / ekf6_backward and their _f64 twins), the same
// team, pipeline and operation order. Both ask for two blocks an SM
// (registers capped at 168). The double backward fits them without a
// spill; the double forward spills 100 B (1,152 B of stack with adaptive
// R), and that measured 9.4% faster a sweep chunk on an H100 than 214
// registers at one block an SM, bit for bit equal (PERF.md). The float
// kernels take their shared memory statically; the double backward's
// 89,856 B (the float one's 44,928 B) pass the 48 KiB a static allocation
// may take, so it takes them dynamically.
//
// Registers (-Xptxas -v, sm_90a): printed by chip_smoke.py; PERF.md keeps
// the measured figures.
#include "ekf_common.cuh"

namespace {

constexpr int M = 6;
constexpr int NPI = 12;
constexpr int MAXL = 64;
constexpr int LANES = 32;
constexpr int BLOCK = M * LANES;   // warp r owns row r of its 32 lanes
// scal rows: dt, beta, gamma, b, epsilon, sigma, alpha_min, alpha_max, q(6)
enum { R_DT, R_BETA, R_GAMMA, R_B, R_EPS, R_SIGMA, R_AMIN, R_AMAX, R_Q };
constexpr int NSCAL = 14;
// vecs planes: a, u_min, u_max, w
enum { V_A, V_UMIN, V_UMAX, V_W };
constexpr int NVEC = 4 * NPI;
// forward inputs of one step: u (12), x, R
constexpr int NIN = NPI + 2;
// P_MINUS and P_PLUS keep the lower triangle of each symmetric 6x6
// matrix, row by row: element (i, k), k <= i, at tri(i, k)
constexpr int NTRI = M * (M + 1) / 2;
__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }
// backward inputs of one iteration: S_PLUS[t], P_PLUS[t], u[t],
// S_MINUS[t+1], and each thread r's row of the P_MINUS it factors
enum { B_SP = 0, B_PP = M, B_U = M + NTRI, B_SM = B_U + NPI,
       B_FM = B_SM + M, NB = B_FM + NTRI };
// Cholesky factors in flight in the backward, by step
constexpr int RING = M + 1;

template <typename Real>
struct Params6 {
  Real dt, beta, gam, b, eps, sig, amin, amax;
};

template <typename Real>
__device__ __forceinline__ Params6<Real> load_params(const Real* scal,
                                                     int b, int B) {
  Params6<Real> p;
  p.dt = scal[at3(0, R_DT, NSCAL, b, B)];
  p.beta = scal[at3(0, R_BETA, NSCAL, b, B)];
  p.gam = scal[at3(0, R_GAMMA, NSCAL, b, B)];
  p.b = scal[at3(0, R_B, NSCAL, b, B)];
  p.eps = scal[at3(0, R_EPS, NSCAL, b, B)];
  p.sig = scal[at3(0, R_SIGMA, NSCAL, b, B)];
  p.amin = scal[at3(0, R_AMIN, NSCAL, b, B)];
  p.amax = scal[at3(0, R_AMAX, NSCAL, b, B)];
  return p;
}

// vecs of this lane in shared memory: vs points at the lane's column of a
// (NVEC, LANES) array
template <typename Real>
__device__ __forceinline__ Real vec(const Real* vs, int plane, int k) {
  return vs[(plane * NPI + k) * LANES];
}

// v[r] for a row index r known only at run time, without indexing a
// register array (which would put it in local memory)
template <typename Real>
__device__ __forceinline__ Real pick(const Real (&v)[M], int r) {
  Real out = v[0];
#pragma unroll
  for (int i = 1; i < M; ++i) out = r == i ? v[i] : out;
  return out;
}

template <typename Real>
__device__ __forceinline__ void pick_row(const Real (&A)[M][M], int r,
                                         Real (&row)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    row[j] = A[0][j];
#pragma unroll
    for (int i = 1; i < M; ++i) row[j] = r == i ? A[i][j] : row[j];
  }
}

// The whole matrix from its rows in shared memory (a (M*M, LANES) array,
// lane column l).
template <typename Real>
__device__ __forceinline__ void read_matrix(const Real* buf, int l,
                                            Real (&A)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) A[i][j] = buf[(i * M + j) * LANES + l];
}

template <typename Real>
__device__ __forceinline__ void write_row(Real* buf, int r, int l,
                                          const Real (&row)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) buf[(r * M + j) * LANES + l] = row[j];
}

// The bang-bang fill of input k: u_min where phi > 0, else u_max.
template <typename Real>
__device__ __forceinline__ Real fill(Real u, Real s5, const Params6<Real>& p,
                                      const Real* vs, int k) {
  const Real a = vec(vs, V_A, k);
  const Real phi = p.eps * vec(vs, V_W, k) - p.gam * s5 * a;
  const Real cand = phi > Real(0) ? vec(vs, V_UMIN, k) : vec(vs, V_UMAX, k);
  return isnan(u) ? cand : u;
}

// Input k's terms of the two sums over the 12 inputs: the drive of alpha
// (gam * a times u_max - u filled) and the sigma-band term of A[2][5].
template <typename Real>
__device__ __forceinline__ void npi_terms(Real u, Real s5,
                                          const Params6<Real>& p,
                                          Real inv_sigma, const Real* vs,
                                          int k, Real& ga, Real& gap,
                                          Real& band_term) {
  const Real a = vec(vs, V_A, k);
  const Real umax = vec(vs, V_UMAX, k);
  const Real phi = p.eps * vec(vs, V_W, k) - p.gam * s5 * a;
  const bool band = isnan(u) && phi > -inv_sigma && phi < inv_sigma;
  ga = p.gam * a;
  gap = umax - fill(u, s5, p, vs, k);
  band_term = band ? p.gam * p.dt * (p.sig * Real(0.5)) * a *
                         (umax - vec(vs, V_UMIN, k))
                   : Real(0);
}

// The SI-alpha/costate Euler step, given the drive of alpha (the bang-bang
// fill of the NaN inputs is in it).
template <typename Real>
__device__ __forceinline__ void state_update(const Real (&s)[M],
                                             Real drive,
                                             const Params6<Real>& p,
                                             Real (&sn)[M]) {
  const Real rho = s[3] - s[4] - (Real(1) - p.eps);
  sn[0] = clip_lo_hi(s[0] - p.dt * s[2] * s[0] * s[1], Real(0), Real(1));
  sn[1] = clip_lo_hi(s[1] + p.dt * (s[2] * s[0] * s[1] - p.beta * s[1]), Real(0),
                     Real(1));
  sn[2] = clip_lo_hi(s[2] + p.dt * drive, p.amin, p.amax);
  sn[3] = s[3] + p.dt * rho * s[2] * s[1];
  sn[4] = s[4] + p.dt * (rho * s[2] * s[0] + p.beta * s[4]);
  sn[5] = s[5] + p.dt * (rho * s[0] * s[1] + p.gam * s[5]);
}

template <typename Real>
__device__ __forceinline__ void margins(Real (&s)[M],
                                        const Params6<Real>& p) {
  s[0] = clip_hi_lo(s[0], Real(0), Real(1));
  s[1] = clip_hi_lo(s[1], Real(0), Real(1));
  s[2] = clip_hi_lo(s[2], p.amin, p.amax);
}

// margins() applied to entry r of a state alone
template <typename Real>
__device__ __forceinline__ Real margin_of(Real v, int r,
                                          const Params6<Real>& p) {
  if (r < 2) return clip_hi_lo(v, Real(0), Real(1));
  if (r == 2) return clip_hi_lo(v, p.amin, p.amax);
  return v;
}

// The Jacobian at s, its band term a36 = -sum_k band_term_k given.
template <typename Real>
__device__ __forceinline__ void jacobian(const Real (&s)[M], Real a36,
                                         const Params6<Real>& p,
                                         Real (&A)[M][M]) {
  const Real rho = s[3] - s[4] - (Real(1) - p.eps);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) A[i][j] = Real(0);
  A[0][0] = Real(1) - p.dt * s[2] * s[1];
  A[0][1] = -p.dt * s[2] * s[0];
  A[0][2] = -p.dt * s[0] * s[1];
  A[1][0] = p.dt * s[1] * s[2];
  A[1][1] = Real(1) + p.dt * (s[0] * s[2] - p.beta);
  A[1][2] = p.dt * s[0] * s[1];
  A[2][2] = Real(1) - p.dt * p.gam;
  A[2][5] = a36;
  A[3][1] = p.dt * s[2] * rho;
  A[3][2] = p.dt * s[1] * rho;
  A[3][3] = Real(1) + p.dt * s[1] * s[2];
  A[3][4] = -p.dt * s[1] * s[2];
  A[4][0] = p.dt * s[2] * rho;
  A[4][2] = p.dt * s[0] * rho;
  A[4][3] = p.dt * s[0] * s[2];
  A[4][4] = Real(1) - p.dt * (s[0] * s[2] - p.beta);
  A[5][0] = p.dt * s[1] * rho;
  A[5][1] = p.dt * s[0] * rho;
  A[5][3] = p.dt * s[0] * s[1];
  A[5][4] = -p.dt * s[0] * s[1];
  A[5][5] = Real(1) + p.dt * p.gam;
}

// Row r of X @ Y (matmul's order) and of X @ Y^T (matmul_t's order), from
// row r of X and the whole Y.
template <typename Real>
__device__ __forceinline__ void row_matmul(const Real (&xr)[M],
                                           const Real (&Y)[M][M],
                                           Real (&out)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    Real acc = xr[0] * Y[0][k];
#pragma unroll
    for (int j = 1; j < M; ++j) acc += xr[j] * Y[j][k];
    out[k] = acc;
  }
}

template <typename Real>
__device__ __forceinline__ void row_matmul_t(const Real (&xr)[M],
                                             const Real (&Y)[M][M],
                                             Real (&out)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    Real acc = xr[0] * Y[k][0];
#pragma unroll
    for (int j = 1; j < M; ++j) acc += xr[j] * Y[k][j];
    out[k] = acc;
  }
}

// Copy the lane's vecs into shared memory (the caller synchronises).
template <typename Real>
__device__ __forceinline__ void load_vecs(const Real* vecs, Real* vecs_s,
                                          int r, int l, int bl, int B) {
  for (int e = r; e < NVEC; e += M)
    vecs_s[e * LANES + l] = vecs[at3(0, e, NVEC, bl, B)];
}

// The backward's shared memory: vecs, the double-buffered step inputs, the
// factors in flight, the smoothed state by step parity, the band terms.
template <typename Real>
struct BwdShared {
  Real* vecs_s;                // (NVEC, LANES)
  Real (*in_s)[NB * LANES];    // [2]
  Real (*L_s)[NTRI * LANES];   // [RING]: factor of P-_{s+1}, slot s % RING
  Real (*ss_s)[M * LANES];     // [2]: smoothed state, by step parity
  Real* band_s;                // (NPI, LANES): band terms of A[2][5]
};
constexpr int BWD_SHARED =
    (NVEC + 2 * NB + RING * NTRI + 2 * M + NPI) * LANES;

// float: static arrays, as the kernel had them before its double instance
__device__ __forceinline__ BwdShared<float> bwd_shared(float) {
  __shared__ float vecs_s[NVEC * LANES];
  __shared__ float in_s[2][NB * LANES];
  __shared__ float L_s[RING][NTRI * LANES];
  __shared__ float ss_s[2][M * LANES];
  __shared__ float band_s[NPI * LANES];
  return {vecs_s, in_s, L_s, ss_s, band_s};
}

// double: the same arrays laid out in the dynamic shared memory
__device__ __forceinline__ BwdShared<double> bwd_shared(double) {
  extern __shared__ double bwd_dynamic[];
  double* p = bwd_dynamic;
  BwdShared<double> sh;
  sh.vecs_s = p;
  p += NVEC * LANES;
  sh.in_s = reinterpret_cast<double (*)[NB * LANES]>(p);
  p += 2 * NB * LANES;
  sh.L_s = reinterpret_cast<double (*)[NTRI * LANES]>(p);
  p += RING * NTRI * LANES;
  sh.ss_s = reinterpret_cast<double (*)[M * LANES]>(p);
  p += 2 * M * LANES;
  sh.band_s = p;
  return sh;
}

template <typename Real, bool ADAPTIVE>
__global__ void __launch_bounds__(BLOCK, 2)
ekf6_fwd_kernel(const Real* __restrict__ u, const Real* __restrict__ x,
                const Real* __restrict__ Rv, const Real* __restrict__ scal,
                const Real* __restrict__ vecs,
                const Real* __restrict__ s_init,
                const Real* __restrict__ Ps_init,
                Real* __restrict__ S_MINUS, Real* __restrict__ S_PLUS,
                Real* __restrict__ P_MINUS, Real* __restrict__ P_PLUS,
                int T, int B, Real gd, int total_cases, Real beta,
                Real one_minus_beta, int L_mon) {
  __shared__ Real vecs_s[NVEC * LANES];
  __shared__ Real in_s[2][NIN * LANES];
  __shared__ Real Pbuf[M * M * LANES];    // rows of A Pp A^T + Q
  __shared__ Real Ppbuf[M * M * LANES];   // rows of the Joseph update
  __shared__ Real Rbuf[LANES];            // adaptive R of the next step
  __shared__ Real terms_s[3 * NPI * LANES];  // npi_terms of the step
  const int r = threadIdx.x / LANES;       // warp-uniform
  const int l = threadIdx.x % LANES;
  const int b = blockIdx.x * LANES + l;
  const bool live = b < B;
  const int bl = live ? b : B - 1;
  const Params6<Real> p = load_params(scal, bl, B);
  const Real qr = scal[at3(0, R_Q + r, NSCAL, bl, B)];
  const Real inv_sigma = Real(1) / p.sig;
  const Real* vs = vecs_s + l;
  load_vecs(vecs, vecs_s, r, l, bl, B);

  auto prefetch = [&](int t) {
    Real* dst = in_s[t & 1];
    for (int e = r; e < NIN; e += M) {
      const Real* src = e < NPI ? u + at3(t, e, NPI, bl, B)
                         : e == NPI ? x + at3(t, 0, 1, bl, B)
                                    : Rv + at3(t, 0, 1, bl, B);
      cp_async(dst + e * LANES + l, src);
    }
    cp_async_commit();
  };

  Real s[M];
#pragma unroll
  for (int i = 0; i < M; ++i) s[i] = s_init[at3(0, i, M, bl, B)];
#pragma unroll
  for (int j = 0; j < M; ++j)
    Pbuf[(r * M + j) * LANES + l] = Ps_init[at3(0, r * M + j, M * M, bl, B)];
  AdaptiveR<Real, ADAPTIVE ? MAXL : 1> ad;
  if constexpr (ADAPTIVE) {
    if (r == 0) {
      ad.init(Rv[bl], L_mon);
      Rbuf[l] = ad.R;
    }
  }
  prefetch(0);

  for (int t = 0; t < T; ++t) {
    // step t's inputs, the rows of P and the adaptive R are in place
    cp_async_wait_all();
    __syncthreads();
    Real P[M][M];
    read_matrix(Pbuf, l, P);
    if (t > 0) symmetrize<M>(P);
    const Real* in = in_s[t & 1];
    const Real xt = in[NPI * LANES + l];
    const Real Rt = ADAPTIVE ? Rbuf[l] : in[(NPI + 1) * LANES + l];
    if (t + 1 < T) prefetch(t + 1);

    Real Pr[M];
    pick_row(P, r, Pr);
    if (live) {
      S_MINUS[at3(t, r, M, b, B)] = pick(s, r);
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (j <= r) P_MINUS[at3(t, tri(r, j), NTRI, b, B)] = Pr[j];
    }

    // only the first three entries of C can be nonzero
    Real C[3], xp;
    if (total_cases) {
      C[0] = -Real(1); C[1] = Real(0); C[2] = Real(0);
      xp = Real(1) - s[0];
    } else {
      C[0] = s[1] * s[2]; C[1] = s[0] * s[2]; C[2] = s[0] * s[1];
      xp = s[0] * s[1] * s[2];
    }
    xp = xp > Real(0) ? xp : Real(0);
    const bool valid = !isnan(xt);
    const Real innov = valid ? xt - xp : Real(0);

    Real PCt[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      PCt[i] = P[i][0] * C[0] + P[i][1] * C[1] + P[i][2] * C[2];
    const Real S = C[0] * PCt[0] + C[1] * PCt[1] + C[2] * PCt[2] + gd * Rt;
    Real K[M];
#pragma unroll
    for (int i = 0; i < M; ++i) K[i] = valid ? PCt[i] / S : Real(0);

    // row r of the Joseph update (I - KC) P (I - KC)^T
    {
      Real IKC[M][M], IKCr[M], T1r[M], Ppr[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          IKC[i][j] = (i == j ? Real(1) : Real(0)) - (j < 3 ? K[i] * C[j] : Real(0));
      const Real Kr = pick(K, r);
#pragma unroll
      for (int j = 0; j < M; ++j)
        IKCr[j] = (r == j ? Real(1) : Real(0)) - (j < 3 ? Kr * C[j] : Real(0));
      row_matmul(IKCr, P, T1r);
      row_matmul_t(T1r, IKC, Ppr);
#pragma unroll
      for (int j = 0; j < M; ++j)
        Ppr[j] = valid ? (Ppr[j] + Kr * K[j] * Rt) / gd : Pr[j];
      write_row(Ppbuf, r, l, Ppr);
    }
    Real sp[M];
#pragma unroll
    for (int i = 0; i < M; ++i) sp[i] = valid ? s[i] + K[i] * innov : s[i];
    margins(sp, p);
    // this thread's share of the sums over the inputs: k = r and r + 6
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = r + h * M;
      Real ga, gap, band_term;
      npi_terms(in[k * LANES + l], sp[5], p, inv_sigma, vs, k, ga, gap,
                band_term);
      terms_s[k * LANES + l] = ga;
      terms_s[(NPI + k) * LANES + l] = gap;
      terms_s[(2 * NPI + k) * LANES + l] = band_term;
    }
    __syncthreads();
    Real Pp[M][M];
    read_matrix(Ppbuf, l, Pp);
    symmetrize<M>(Pp);
    {
      Real Ppr[M];
      pick_row(Pp, r, Ppr);
      if (live) {
        S_PLUS[at3(t, r, M, b, B)] = pick(sp, r);
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (j <= r) P_PLUS[at3(t, tri(r, j), NTRI, b, B)] = Ppr[j];
      }
    }

    // prediction: row r of A Pp A^T + Q; the sums over the inputs in k order
    Real drive = p.gam * p.b - p.gam * sp[2], a36 = Real(0);
#pragma unroll
    for (int k = 0; k < NPI; ++k) {
      drive += terms_s[k * LANES + l] * terms_s[(NPI + k) * LANES + l];
      a36 -= terms_s[(2 * NPI + k) * LANES + l];
    }
    Real sn[M];
    state_update(sp, drive, p, sn);
    margins(sn, p);
    {
      Real A[M][M], Ar[M], APr[M], Pnr[M];
      jacobian(sp, a36, p, A);
      pick_row(A, r, Ar);
      row_matmul(Ar, Pp, APr);
      row_matmul_t(APr, A, Pnr);
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (j == r) Pnr[j] += qr;
      write_row(Pbuf, r, l, Pnr);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] = sn[i];

    if constexpr (ADAPTIVE) {
      if (r == 0) {
        ad.update(t, innov, valid, L_mon, beta, one_minus_beta);
        Rbuf[l] = ad.R;
      }
    }
  }
}

template <typename Real>
__global__ void __launch_bounds__(BLOCK, 2)
ekf6_bwd_kernel(const Real* __restrict__ u,
                const Real* __restrict__ S_PLUS,
                const Real* __restrict__ S_MINUS,
                const Real* __restrict__ P_PLUS,
                const Real* __restrict__ P_MINUS,
                const Real* __restrict__ scal,
                const Real* __restrict__ vecs,
                const Real* __restrict__ s_final,
                Real* __restrict__ S_SMOOTH, Real* __restrict__ U_SM, int T,
                int B) {
  const BwdShared<Real> sh = bwd_shared(Real());
  Real* const vecs_s = sh.vecs_s;
  Real(*const in_s)[NB * LANES] = sh.in_s;
  Real(*const L_s)[NTRI * LANES] = sh.L_s;
  Real(*const ss_s)[M * LANES] = sh.ss_s;
  Real* const band_s = sh.band_s;
  const int r = threadIdx.x / LANES;       // warp-uniform
  const int l = threadIdx.x % LANES;
  const int b = blockIdx.x * LANES + l;
  const bool live = b < B;
  const int bl = live ? b : B - 1;
  const Params6<Real> p = load_params(scal, bl, B);
  const Real inv_sigma = Real(1) / p.sig;
  const Real* vs = vecs_s + l;
  load_vecs(vecs, vecs_s, r, l, bl, B);

  // Iteration it smooths step it (it <= T - 2) and, in thread r, factors
  // row r of P-_{s+1} for step s = it - (M - r): row r of a step's factor
  // is formed M - r iterations before the step, after the rows above it,
  // and all six are in place when the step comes.
  auto factor_step = [&](int it) { return it - (M - r); };
  // what iteration it reads, prefetched during iteration it + 1
  auto prefetch = [&](int it) {
    Real* dst = in_s[it & 1];
    if (it <= T - 2)
      for (int e = r; e < B_FM; e += M) {
        const Real* src =
            e < B_PP   ? S_PLUS + at3(it, e - B_SP, M, bl, B)
            : e < B_U  ? P_PLUS + at3(it, e - B_PP, NTRI, bl, B)
            : e < B_SM ? u + at3(it, e - B_U, NPI, bl, B)
                       : S_MINUS + at3(it + 1, e - B_SM, M, bl, B);
        cp_async(dst + e * LANES + l, src);
      }
    const int s = factor_step(it);
    if (s >= 0 && s <= T - 2)
      for (int k = 0; k <= r; ++k)
        cp_async(dst + (B_FM + tri(r, k)) * LANES + l,
                  P_MINUS + at3(s + 1, tri(r, k), NTRI, bl, B));
    cp_async_commit();
  };
  // U_OPT_SMOOTH rows r and r + 6 of step t from the smoothed state's
  // costate s5 and the step's raw inputs
  auto store_u = [&](int t, Real s5, Real u0, Real u1) {
    if (live) {
      U_SM[at3(t, r, NPI, b, B)] = fill(u0, s5, p, vs, r);
      U_SM[at3(t, r + M, NPI, b, B)] = fill(u1, s5, p, vs, r + M);
    }
  };

  // terminal row: NaN entries of s_final take the last filtered value;
  // U_OPT_SMOOTH's last row is 0
  {
    const Real sf = s_final[at3(0, r, M, bl, B)];
    const Real ssr = isnan(sf) ? S_PLUS[at3(T - 1, r, M, bl, B)] : sf;
    ss_s[(T - 1) & 1][r * LANES + l] = ssr;
    if (live) {
      S_SMOOTH[at3(T - 1, r, M, b, B)] = ssr;
      U_SM[at3(T - 1, r, NPI, b, B)] = Real(0);
      U_SM[at3(T - 1, r + M, NPI, b, B)] = Real(0);
    }
  }
  if (T < 2) return;
  prefetch(T - 2 + M);

  Real u0 = Real(0), u1 = Real(0);   // step t+1's inputs r and r + 6
  for (int it = T - 2 + M; it >= 0; --it) {
    // this iteration's rows, the factor rows formed before it and step
    // it+1's smoothed state are in place
    cp_async_wait_all();
    __syncthreads();
    const bool smooth = it <= T - 2;       // block-uniform
    Real ssn[M];
    if (smooth) {
#pragma unroll
      for (int i = 0; i < M; ++i) ssn[i] = ss_s[(it + 1) & 1][i * LANES + l];
      if (it + 1 < T - 1) store_u(it + 1, ssn[5], u0, u1);
    }
    if (it >= 1) prefetch(it - 1);
    const Real* in = in_s[it & 1];

    // row r of the factor of step s: cholesky_floored's row r, reading
    // the rows above it from shared memory
    {
      const int s = factor_step(it);
      if (s >= 0 && s <= T - 2) {
        Real* Ls = L_s[s % RING];
        Real Lr[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (j > r) break;
          Real acc = in[(B_FM + tri(r, j)) * LANES + l];
#pragma unroll
          for (int k = 0; k < j; ++k)
            acc -= Lr[k] * (j == r ? Lr[k] : Ls[tri(j, k) * LANES + l]);
          Lr[j] = j == r ? Num<Real>::root(acc > Num<Real>::tiny()
                                               ? acc
                                               : Num<Real>::tiny())
                         : acc / Ls[tri(j, j) * LANES + l];
        }
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (k <= r) Ls[tri(r, k) * LANES + l] = Lr[k];
      }
    }
    if (!smooth) continue;

    const int t = it;
    Real sp[M], Ppr[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      sp[i] = in[(B_SP + i) * LANES + l];
      Ppr[i] = in[(B_PP + (i <= r ? tri(r, i) : tri(i, r))) * LANES + l];
    }
    u0 = in[(B_U + r) * LANES + l];
    u1 = in[(B_U + r + M) * LANES + l];
    // this thread's band terms (k = r and r + 6), shared with the team
    {
      Real ga, gap, band_term;
      npi_terms(u0, sp[5], p, inv_sigma, vs, r, ga, gap, band_term);
      band_s[r * LANES + l] = band_term;
      npi_terms(u1, sp[5], p, inv_sigma, vs, r + M, ga, gap, band_term);
      band_s[(r + M) * LANES + l] = band_term;
    }
    __syncthreads();

    // row r of the gain J = Pp A^T inv(Pm)
    Real Jr[M];
    {
      Real a36 = Real(0);
#pragma unroll
      for (int k = 0; k < NPI; ++k) a36 -= band_s[k * LANES + l];
      Real A[M][M], PAtr[M], L[M][M];
      jacobian(sp, a36, p, A);
      row_matmul_t(Ppr, A, PAtr);
      const Real* Lt = L_s[t % RING];
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int k = 0; k <= i; ++k) L[i][k] = Lt[tri(i, k) * LANES + l];
      gain_row<M>(L, PAtr, Jr);
    }
    Real dj = Real(0);
#pragma unroll
    for (int j = 0; j < M; ++j)
      dj += Jr[j] * (ssn[j] - in[(B_SM + j) * LANES + l]);
    const Real ssr = margin_of(pick(sp, r) + dj, r, p);
    ss_s[t & 1][r * LANES + l] = ssr;
    if (live) S_SMOOTH[at3(t, r, M, b, B)] = ssr;
  }
  __syncthreads();
  store_u(0, ss_s[0][(M - 1) * LANES + l], u0, u1);
}

inline int n_blocks(int B) { return (B + LANES - 1) / LANES; }

// One forward launch of either instance.
template <typename Real>
int forward(const Real* u, const Real* x, const Real* Rv, const Real* scal,
            const Real* vecs, const Real* s_init, const Real* Ps_init,
            Real* S_MINUS, Real* S_PLUS, Real* P_MINUS, Real* P_PLUS, int T,
            int B, Real gamma_discount, int total_cases, Real beta,
            Real one_minus_beta, int L_mon, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (beta != Real(1)) {
    if (L_mon < 1 || L_mon > MAXL) return (int)cudaErrorInvalidValue;
    ekf6_fwd_kernel<Real, true><<<n_blocks(B), BLOCK, 0, st>>>(
        u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS, S_PLUS, P_MINUS,
        P_PLUS, T, B, gamma_discount, total_cases, beta, one_minus_beta,
        L_mon);
  } else {
    ekf6_fwd_kernel<Real, false><<<n_blocks(B), BLOCK, 0, st>>>(
        u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS, S_PLUS, P_MINUS,
        P_PLUS, T, B, gamma_discount, total_cases, beta, one_minus_beta,
        L_mon);
  }
  return (int)cudaGetLastError();
}

// One backward launch of either instance.
template <typename Real>
int backward(const Real* u, const Real* S_PLUS, const Real* S_MINUS,
             const Real* P_PLUS, const Real* P_MINUS, const Real* scal,
             const Real* vecs, const Real* s_final, Real* S_SMOOTH,
             Real* U_SM, int T, int B, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  // the double instance takes its shared memory dynamically (bwd_shared)
  const size_t smem = sizeof(Real) == 8 ? sizeof(Real) * BWD_SHARED : 0;
  if (smem) {
    cudaError_t err = cudaFuncSetAttribute(
        ekf6_bwd_kernel<Real>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ekf6_bwd_kernel<Real><<<n_blocks(B), BLOCK, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      u, S_PLUS, S_MINUS, P_PLUS, P_MINUS, scal, vecs, s_final, S_SMOOTH,
      U_SM, T, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u (T,12,B), x/Rv (T,B), scal (14,B), vecs (4,12,B), s_init (6,B),
// Ps_init (36,B) -> S_MINUS, S_PLUS (T,6,B), P_MINUS, P_PLUS (T,21,B), the
// lower triangles of the covariances row by row (P_MINUS[0], the lower
// triangle of Ps_init, is never read).
// beta != 1 adapts the fixed prior Rv[0] over an L_mon-step window
// (L_mon <= 64). Returns cudaGetLastError() after the launch.
// ekf6_forward is the float instance, ekf6_forward_f64 the double one.
int ekf6_forward(const float* u, const float* x, const float* Rv,
                 const float* scal, const float* vecs, const float* s_init,
                 const float* Ps_init, float* S_MINUS, float* S_PLUS,
                 float* P_MINUS, float* P_PLUS, int T, int B,
                 float gamma_discount, int total_cases, float beta,
                 float one_minus_beta, int L_mon, void* stream) {
  return forward<float>(u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS,
                        S_PLUS, P_MINUS, P_PLUS, T, B, gamma_discount,
                        total_cases, beta, one_minus_beta, L_mon, stream);
}

int ekf6_forward_f64(const double* u, const double* x, const double* Rv,
                     const double* scal, const double* vecs,
                     const double* s_init, const double* Ps_init,
                     double* S_MINUS, double* S_PLUS, double* P_MINUS,
                     double* P_PLUS, int T, int B, double gamma_discount,
                     int total_cases, double beta, double one_minus_beta,
                     int L_mon, void* stream) {
  return forward<double>(u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS,
                         S_PLUS, P_MINUS, P_PLUS, T, B, gamma_discount,
                         total_cases, beta, one_minus_beta, L_mon, stream);
}

// u + forward outputs + scal, vecs, s_final (6,B), Ps_final (36,B)
//   -> S_SMOOTH (T,6,B), U_SM (T,12,B). Ps_final enters no output: the
// smoothed covariance it starts is not computed.
int ekf6_backward(const float* u, const float* S_PLUS, const float* S_MINUS,
                  const float* P_PLUS, const float* P_MINUS, const float* scal,
                  const float* vecs, const float* s_final,
                  const float* Ps_final, float* S_SMOOTH, float* U_SM, int T,
                  int B, void* stream) {
  (void)Ps_final;
  return backward<float>(u, S_PLUS, S_MINUS, P_PLUS, P_MINUS, scal, vecs,
                         s_final, S_SMOOTH, U_SM, T, B, stream);
}

int ekf6_backward_f64(const double* u, const double* S_PLUS,
                      const double* S_MINUS, const double* P_PLUS,
                      const double* P_MINUS, const double* scal,
                      const double* vecs, const double* s_final,
                      const double* Ps_final, double* S_SMOOTH, double* U_SM,
                      int T, int B, void* stream) {
  (void)Ps_final;
  return backward<double>(u, S_PLUS, S_MINUS, P_PLUS, P_MINUS, scal, vecs,
                          s_final, S_SMOOTH, U_SM, T, B, stream);
}

const char* ekf6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
