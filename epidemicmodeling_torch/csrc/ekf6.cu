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
// reference convention: the MATLAB loop never writes it).
//
// What bounds it on the card: a sequential chain of T dependent steps per
// lane (~1.5k flops forward, ~3k backward, with IEEE divisions and square
// roots), so per-thread latency sets the time. ptxas (-Xptxas -v, sm_90a)
// gives the forward 254 registers and the backward 167, with no spills; at
// 254 registers two 128-thread blocks fit on an SM. The Pareto sweep gives
// 25 epsilons x 235 regions = 5,875 lanes per chunk, 46 blocks of 128
// threads on 132 SMs. The design: one thread per lane, the time loop inside
// the thread, (s, P) in registers, coalesced lanes-last loads and stores, no
// lane padding (the ragged edge is masked), no synchronisation. Spreading
// lanes over all SMs is later work.
#include "ekf_common.cuh"

namespace {

constexpr int M = 6;
constexpr int NPI = 12;
constexpr int MAXL = 64;
// scal rows: dt, beta, gamma, b, epsilon, sigma, alpha_min, alpha_max, q(6)
enum { R_DT, R_BETA, R_GAMMA, R_B, R_EPS, R_SIGMA, R_AMIN, R_AMAX, R_Q };
constexpr int NSCAL = 14;
// vecs planes: a, u_min, u_max, w
enum { V_A, V_UMIN, V_UMAX, V_W };

struct Params6 {
  float dt, beta, gam, b, eps, sig, amin, amax;
};

__device__ __forceinline__ Params6 load_params(const float* scal, int b,
                                               int B) {
  Params6 p;
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

__device__ __forceinline__ float vec(const float* vecs, int plane, int k,
                                     int b, int B) {
  return vecs[at3(plane, k, NPI, b, B)];
}

// Bang-bang fill of the NaN inputs + the SI-alpha/costate Euler step.
__device__ __forceinline__ void state_update(const float (&u)[NPI],
                                             const float (&s)[M],
                                             const Params6& p,
                                             const float* vecs, int b, int B,
                                             float (&uf)[NPI], float (&sn)[M]) {
  float drive = p.gam * p.b - p.gam * s[2];
#pragma unroll
  for (int k = 0; k < NPI; ++k) {
    const float a = vec(vecs, V_A, k, b, B);
    const float umax = vec(vecs, V_UMAX, k, b, B);
    const float phi = p.eps * vec(vecs, V_W, k, b, B) - p.gam * s[5] * a;
    const float cand = phi > 0.f ? vec(vecs, V_UMIN, k, b, B) : umax;
    uf[k] = isnan(u[k]) ? cand : u[k];
    drive += p.gam * a * (umax - uf[k]);
  }
  const float rho = s[3] - s[4] - (1.f - p.eps);
  sn[0] = clip_lo_hi(s[0] - p.dt * s[2] * s[0] * s[1], 0.f, 1.f);
  sn[1] = clip_lo_hi(s[1] + p.dt * (s[2] * s[0] * s[1] - p.beta * s[1]), 0.f,
                     1.f);
  sn[2] = clip_lo_hi(s[2] + p.dt * drive, p.amin, p.amax);
  sn[3] = s[3] + p.dt * rho * s[2] * s[1];
  sn[4] = s[4] + p.dt * (rho * s[2] * s[0] + p.beta * s[4]);
  sn[5] = s[5] + p.dt * (rho * s[0] * s[1] + p.gam * s[5]);
}

__device__ __forceinline__ void margins(float (&s)[M], const Params6& p) {
  s[0] = clip_hi_lo(s[0], 0.f, 1.f);
  s[1] = clip_hi_lo(s[1], 0.f, 1.f);
  s[2] = clip_hi_lo(s[2], p.amin, p.amax);
}

__device__ __forceinline__ void jacobian(const float (&u)[NPI],
                                         const float (&s)[M],
                                         const Params6& p, const float* vecs,
                                         int b, int B, float (&A)[M][M]) {
  const float rho = s[3] - s[4] - (1.f - p.eps);
  const float inv_sigma = 1.f / p.sig;
  float a36 = 0.f;
#pragma unroll
  for (int k = 0; k < NPI; ++k) {
    const float a = vec(vecs, V_A, k, b, B);
    const float phi = p.eps * vec(vecs, V_W, k, b, B) - p.gam * s[5] * a;
    const bool band = isnan(u[k]) && phi > -inv_sigma && phi < inv_sigma;
    a36 -= band ? p.gam * p.dt * (p.sig * 0.5f) * a *
                      (vec(vecs, V_UMAX, k, b, B) - vec(vecs, V_UMIN, k, b, B))
                : 0.f;
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) A[i][j] = 0.f;
  A[0][0] = 1.f - p.dt * s[2] * s[1];
  A[0][1] = -p.dt * s[2] * s[0];
  A[0][2] = -p.dt * s[0] * s[1];
  A[1][0] = p.dt * s[1] * s[2];
  A[1][1] = 1.f + p.dt * (s[0] * s[2] - p.beta);
  A[1][2] = p.dt * s[0] * s[1];
  A[2][2] = 1.f - p.dt * p.gam;
  A[2][5] = a36;
  A[3][1] = p.dt * s[2] * rho;
  A[3][2] = p.dt * s[1] * rho;
  A[3][3] = 1.f + p.dt * s[1] * s[2];
  A[3][4] = -p.dt * s[1] * s[2];
  A[4][0] = p.dt * s[2] * rho;
  A[4][2] = p.dt * s[0] * rho;
  A[4][3] = p.dt * s[0] * s[2];
  A[4][4] = 1.f - p.dt * (s[0] * s[2] - p.beta);
  A[5][0] = p.dt * s[1] * rho;
  A[5][1] = p.dt * s[0] * rho;
  A[5][3] = p.dt * s[0] * s[1];
  A[5][4] = -p.dt * s[0] * s[1];
  A[5][5] = 1.f + p.dt * p.gam;
}

template <bool ADAPTIVE>
__global__ void __launch_bounds__(EKF_THREADS)
ekf6_fwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
                const float* __restrict__ Rv, const float* __restrict__ scal,
                const float* __restrict__ vecs,
                const float* __restrict__ s_init,
                const float* __restrict__ Ps_init,
                float* __restrict__ S_MINUS, float* __restrict__ S_PLUS,
                float* __restrict__ P_MINUS, float* __restrict__ P_PLUS,
                int T, int B, float gd, int total_cases, float beta,
                float one_minus_beta, int L_mon) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;   // the ragged edge: no lane padding
  const Params6 p = load_params(scal, b, B);

  float s[M], P[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s[i] = s_init[at3(0, i, M, b, B)];
#pragma unroll
    for (int j = 0; j < M; ++j) P[i][j] = Ps_init[at3(0, i * M + j, M * M, b, B)];
  }
  AdaptiveR<ADAPTIVE ? MAXL : 1> ad;
  if constexpr (ADAPTIVE) ad.init(Rv[b], L_mon);

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      S_MINUS[at3(t, i, M, b, B)] = s[i];
#pragma unroll
      for (int j = 0; j < M; ++j) P_MINUS[at3(t, i * M + j, M * M, b, B)] = P[i][j];
    }
    const float xt = x[at3(t, 0, 1, b, B)];
    const float Rt = ADAPTIVE ? ad.R : Rv[at3(t, 0, 1, b, B)];

    // only the first three entries of C can be nonzero
    float C[3], xp;
    if (total_cases) {
      C[0] = -1.f; C[1] = 0.f; C[2] = 0.f;
      xp = 1.f - s[0];
    } else {
      C[0] = s[1] * s[2]; C[1] = s[0] * s[2]; C[2] = s[0] * s[1];
      xp = s[0] * s[1] * s[2];
    }
    xp = xp > 0.f ? xp : 0.f;
    const bool valid = !isnan(xt);
    const float innov = valid ? xt - xp : 0.f;

    float PCt[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      PCt[i] = P[i][0] * C[0] + P[i][1] * C[1] + P[i][2] * C[2];
    const float S = C[0] * PCt[0] + C[1] * PCt[1] + C[2] * PCt[2] + gd * Rt;
    float K[M];
#pragma unroll
    for (int i = 0; i < M; ++i) K[i] = valid ? PCt[i] / S : 0.f;

    float Pp[M][M];
    {
      float IKC[M][M], T1[M][M];
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          IKC[i][j] = (i == j ? 1.f : 0.f) - (j < 3 ? K[i] * C[j] : 0.f);
      matmul<M>(IKC, P, T1);
      matmul_t<M>(T1, IKC, Pp);
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j)
        Pp[i][j] = valid ? (Pp[i][j] + K[i] * K[j] * Rt) / gd : P[i][j];
    symmetrize<M>(Pp);
    float sp[M];
#pragma unroll
    for (int i = 0; i < M; ++i) sp[i] = valid ? s[i] + K[i] * innov : s[i];
    margins(sp, p);

#pragma unroll
    for (int i = 0; i < M; ++i) {
      S_PLUS[at3(t, i, M, b, B)] = sp[i];
#pragma unroll
      for (int j = 0; j < M; ++j) P_PLUS[at3(t, i * M + j, M * M, b, B)] = Pp[i][j];
    }

    // prediction
    float ut[NPI], uf[NPI];
#pragma unroll
    for (int k = 0; k < NPI; ++k) ut[k] = u[at3(t, k, NPI, b, B)];
    float sn[M];
    state_update(ut, sp, p, vecs, b, B, uf, sn);
    margins(sn, p);
    {
      float A[M][M], AP[M][M];
      jacobian(ut, sp, p, vecs, b, B, A);
      matmul<M>(A, Pp, AP);
      matmul_t<M>(AP, A, P);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) P[i][i] += scal[at3(0, R_Q + i, NSCAL, b, B)];
    symmetrize<M>(P);
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] = sn[i];

    if constexpr (ADAPTIVE)
      ad.update(t, innov, valid, L_mon, beta, one_minus_beta);
  }
}

__global__ void __launch_bounds__(EKF_THREADS)
ekf6_bwd_kernel(const float* __restrict__ u,
                const float* __restrict__ S_PLUS,
                const float* __restrict__ S_MINUS,
                const float* __restrict__ P_PLUS,
                const float* __restrict__ P_MINUS,
                const float* __restrict__ scal,
                const float* __restrict__ vecs,
                const float* __restrict__ s_final,
                const float* __restrict__ Ps_final,
                float* __restrict__ S_SMOOTH, float* __restrict__ U_SM, int T,
                int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Params6 p = load_params(scal, b, B);

  // terminal row: NaN entries of (s_final, Ps_final) take the last filtered
  // value element by element; U_OPT_SMOOTH's last row is 0
  float ssn[M], Psn[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float sf = s_final[at3(0, i, M, b, B)];
    ssn[i] = isnan(sf) ? S_PLUS[at3(T - 1, i, M, b, B)] : sf;
    S_SMOOTH[at3(T - 1, i, M, b, B)] = ssn[i];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float pf = Ps_final[at3(0, i * M + j, M * M, b, B)];
      Psn[i][j] = isnan(pf) ? P_PLUS[at3(T - 1, i * M + j, M * M, b, B)] : pf;
    }
  }
#pragma unroll
  for (int k = 0; k < NPI; ++k) U_SM[at3(T - 1, k, NPI, b, B)] = 0.f;

  for (int t = T - 2; t >= 0; --t) {
    float sp[M], Pp[M][M], Pm[M][M], ut[NPI];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      sp[i] = S_PLUS[at3(t, i, M, b, B)];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Pp[i][j] = P_PLUS[at3(t, i * M + j, M * M, b, B)];
        Pm[i][j] = P_MINUS[at3(t + 1, i * M + j, M * M, b, B)];
      }
    }
#pragma unroll
    for (int k = 0; k < NPI; ++k) ut[k] = u[at3(t, k, NPI, b, B)];

    float J[M][M];
    {
      float A[M][M], PAt[M][M];
      jacobian(ut, sp, p, vecs, b, B, A);
      matmul_t<M>(Pp, A, PAt);
      smoother_gain<M>(Pm, PAt, J);
    }
    float ss[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float dj = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j)
        dj += J[i][j] * (ssn[j] - S_MINUS[at3(t + 1, j, M, b, B)]);
      ss[i] = sp[i] + dj;
    }
    margins(ss, p);
    smoothed_cov<M>(Pp, Pm, J, Psn);

    float uf[NPI], unused[M];
    state_update(ut, ss, p, vecs, b, B, uf, unused);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      S_SMOOTH[at3(t, i, M, b, B)] = ss[i];
      ssn[i] = ss[i];
    }
#pragma unroll
    for (int k = 0; k < NPI; ++k) U_SM[at3(t, k, NPI, b, B)] = uf[k];
  }
}

inline int n_blocks(int B) { return (B + EKF_THREADS - 1) / EKF_THREADS; }

}  // namespace

extern "C" {

// u (T,12,B), x/Rv (T,B), scal (14,B), vecs (4,12,B), s_init (6,B),
// Ps_init (36,B) -> S_MINUS, S_PLUS (T,6,B), P_MINUS, P_PLUS (T,36,B).
// beta != 1 adapts the fixed prior Rv[0] over an L_mon-step window
// (L_mon <= 64). Returns cudaGetLastError() after the launch.
int ekf6_forward(const float* u, const float* x, const float* Rv,
                 const float* scal, const float* vecs, const float* s_init,
                 const float* Ps_init, float* S_MINUS, float* S_PLUS,
                 float* P_MINUS, float* P_PLUS, int T, int B,
                 float gamma_discount, int total_cases, float beta,
                 float one_minus_beta, int L_mon, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (beta != 1.f) {
    if (L_mon < 1 || L_mon > MAXL) return (int)cudaErrorInvalidValue;
    ekf6_fwd_kernel<true><<<n_blocks(B), EKF_THREADS, 0, st>>>(
        u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS, S_PLUS, P_MINUS,
        P_PLUS, T, B, gamma_discount, total_cases, beta, one_minus_beta,
        L_mon);
  } else {
    ekf6_fwd_kernel<false><<<n_blocks(B), EKF_THREADS, 0, st>>>(
        u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS, S_PLUS, P_MINUS,
        P_PLUS, T, B, gamma_discount, total_cases, beta, one_minus_beta,
        L_mon);
  }
  return (int)cudaGetLastError();
}

// u + forward outputs + scal, vecs, s_final (6,B), Ps_final (36,B)
//   -> S_SMOOTH (T,6,B), U_SM (T,12,B).
int ekf6_backward(const float* u, const float* S_PLUS, const float* S_MINUS,
                  const float* P_PLUS, const float* P_MINUS, const float* scal,
                  const float* vecs, const float* s_final,
                  const float* Ps_final, float* S_SMOOTH, float* U_SM, int T,
                  int B, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  ekf6_bwd_kernel<<<n_blocks(B), EKF_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      u, S_PLUS, S_MINUS, P_PLUS, P_MINUS, scal, vecs, s_final, Ps_final,
      S_SMOOTH, U_SM, T, B);
  return (int)cudaGetLastError();
}

const char* ekf6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
