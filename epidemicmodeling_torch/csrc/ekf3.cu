// 3-state SI-alpha EKF/EKS for Hopper (sm_90a): the CUDA port of the Pallas
// kernels _fwd3_kernel / _bwd3_kernel behind ekf3_pallas
// (epidemicmodeling_tpu/ops/pallas/ekf3_kernel.py:92, :198, :306).
//
// What it computes (Tools/SIAlphaModelEKF.m semantics, known inputs):
//   forward  - per step: store the priors; predict the observation
//              (NEWCASES x = s*i*alpha, TOTALCASES x = 1 - s) clipped >= 0;
//              on a non-NaN observation the gain K = PC'/(CPC' + gd*R) and
//              the Joseph update divided by gd, symmetrized; margins
//              [s_min,1] / [i_min,1] / [alpha_min,alpha_max]; the Euler step
//              and P = A P A' + diag(q); optional fixed-R adaptation.
//   backward - the RTS smoother from t = T-2 down to 0 with the gain
//              J = P+ A' inv(P-[t+1]) through an unrolled 3x3 Cholesky; the
//              terminal row is (s_final, Ps_final) with NaN entries taking
//              the last filtered value, element by element.
//
// What bounds it on the card: each lane is a sequential chain of T dependent
// steps of ~300 flops, so a thread's latency, not bandwidth or flops, sets
// the time. The train path has only 235 lanes: 2 blocks of 128 threads on
// 132 SMs. The design keeps the chain as short as it can be: one thread per
// lane, (s, P) in registers, the time loop inside the thread, every operand
// read straight from device memory with coalesced lanes-last loads, and no
// synchronisation at all. Filling the card (lanes over more SMs, or several
// lanes' steps interleaved per thread) is later work.
#include "ekf_common.cuh"

namespace {

constexpr int M = 3;
constexpr int NPI = 12;
constexpr int MAXL = 64;
// scal rows: dt, beta, gamma, b, s_min, i_min, alpha_min, alpha_max, q(3)
enum { R_DT, R_BETA, R_GAMMA, R_B, R_SMIN, R_IMIN, R_AMIN, R_AMAX, R_Q };
constexpr int NSCAL = 11;
// vecs planes: a, u_max
enum { V_A, V_UMAX };

struct Params3 {
  float dt, beta, gam, b, smin, imin, amin, amax;
};

__device__ __forceinline__ Params3 load_params(const float* scal, int b,
                                               int B) {
  Params3 p;
  p.dt = scal[at3(0, R_DT, NSCAL, b, B)];
  p.beta = scal[at3(0, R_BETA, NSCAL, b, B)];
  p.gam = scal[at3(0, R_GAMMA, NSCAL, b, B)];
  p.b = scal[at3(0, R_B, NSCAL, b, B)];
  p.smin = scal[at3(0, R_SMIN, NSCAL, b, B)];
  p.imin = scal[at3(0, R_IMIN, NSCAL, b, B)];
  p.amin = scal[at3(0, R_AMIN, NSCAL, b, B)];
  p.amax = scal[at3(0, R_AMAX, NSCAL, b, B)];
  return p;
}

__device__ __forceinline__ void margins(float (&s)[M], const Params3& p) {
  s[0] = clip_hi_lo(s[0], p.smin, 1.f);
  s[1] = clip_hi_lo(s[1], p.imin, 1.f);
  s[2] = clip_hi_lo(s[2], p.amin, p.amax);
}

__device__ __forceinline__ void jacobian(const float (&s)[M],
                                         const Params3& p, float (&A)[M][M]) {
  A[0][0] = 1.f - p.dt * s[2] * s[1];
  A[0][1] = -p.dt * s[2] * s[0];
  A[0][2] = -p.dt * s[0] * s[1];
  A[1][0] = p.dt * s[1] * s[2];
  A[1][1] = 1.f + p.dt * (s[0] * s[2] - p.beta);
  A[1][2] = p.dt * s[0] * s[1];
  A[2][0] = 0.f;
  A[2][1] = 0.f;
  A[2][2] = 1.f - p.dt * p.gam;
}

template <bool ADAPTIVE>
__global__ void __launch_bounds__(EKF_THREADS)
ekf3_fwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
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
  const Params3 p = load_params(scal, b, B);
  float q[M];
#pragma unroll
  for (int i = 0; i < M; ++i) q[i] = scal[at3(0, R_Q + i, NSCAL, b, B)];

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

    float C[M], xp;
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

    float IKC[M][M], T1[M][M], Pp[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) IKC[i][j] = (i == j ? 1.f : 0.f) - K[i] * C[j];
    matmul<M>(IKC, P, T1);
    matmul_t<M>(T1, IKC, Pp);
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

    // prediction: Euler step of the SI-alpha model with the known input
    float drive = p.gam * p.b - p.gam * sp[2];
#pragma unroll
    for (int k = 0; k < NPI; ++k)
      drive += p.gam * vecs[at3(V_A, k, NPI, b, B)] *
               (vecs[at3(V_UMAX, k, NPI, b, B)] - u[at3(t, k, NPI, b, B)]);
    float sn[M];
    sn[0] = clip_lo_hi(sp[0] - p.dt * sp[2] * sp[0] * sp[1], p.smin, 1.f);
    sn[1] = clip_lo_hi(sp[1] + p.dt * (sp[2] * sp[0] * sp[1] - p.beta * sp[1]),
                       p.imin, 1.f);
    sn[2] = clip_lo_hi(sp[2] + p.dt * drive, p.amin, p.amax);
    margins(sn, p);

    float A[M][M], AP[M][M];
    jacobian(sp, p, A);
    matmul<M>(A, Pp, AP);
    matmul_t<M>(AP, A, P);
#pragma unroll
    for (int i = 0; i < M; ++i) P[i][i] += q[i];
    symmetrize<M>(P);
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] = sn[i];

    if constexpr (ADAPTIVE)
      ad.update(t, innov, valid, L_mon, beta, one_minus_beta);
  }
}

__global__ void __launch_bounds__(EKF_THREADS)
ekf3_bwd_kernel(const float* __restrict__ S_PLUS,
                const float* __restrict__ S_MINUS,
                const float* __restrict__ P_PLUS,
                const float* __restrict__ P_MINUS,
                const float* __restrict__ scal,
                const float* __restrict__ s_final,
                const float* __restrict__ Ps_final,
                float* __restrict__ S_SMOOTH, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Params3 p = load_params(scal, b, B);

  // terminal row: NaN entries of (s_final, Ps_final) are unconstrained and
  // take the last filtered value, element by element
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

  for (int t = T - 2; t >= 0; --t) {
    float sp[M], smn[M], Pp[M][M], Pm[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      sp[i] = S_PLUS[at3(t, i, M, b, B)];
      smn[i] = S_MINUS[at3(t + 1, i, M, b, B)];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Pp[i][j] = P_PLUS[at3(t, i * M + j, M * M, b, B)];
        Pm[i][j] = P_MINUS[at3(t + 1, i * M + j, M * M, b, B)];
      }
    }
    float A[M][M], PAt[M][M], J[M][M];
    jacobian(sp, p, A);
    matmul_t<M>(Pp, A, PAt);
    smoother_gain<M>(Pm, PAt, J);

    float ss[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float dj = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) dj += J[i][j] * (ssn[j] - smn[j]);
      ss[i] = sp[i] + dj;
    }
    margins(ss, p);
    smoothed_cov<M>(Pp, Pm, J, Psn);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      S_SMOOTH[at3(t, i, M, b, B)] = ss[i];
      ssn[i] = ss[i];
    }
  }
}

inline int n_blocks(int B) { return (B + EKF_THREADS - 1) / EKF_THREADS; }

}  // namespace

extern "C" {

// u (T,12,B), x/Rv (T,B), scal (11,B), vecs (2,12,B), s_init (3,B),
// Ps_init (9,B) -> S_MINUS, S_PLUS (T,3,B), P_MINUS, P_PLUS (T,9,B).
// beta != 1 adapts the fixed prior Rv[0] over an L_mon-step window
// (L_mon <= 64). Returns cudaGetLastError() after the launch.
int ekf3_forward(const float* u, const float* x, const float* Rv,
                 const float* scal, const float* vecs, const float* s_init,
                 const float* Ps_init, float* S_MINUS, float* S_PLUS,
                 float* P_MINUS, float* P_PLUS, int T, int B,
                 float gamma_discount, int total_cases, float beta,
                 float one_minus_beta, int L_mon, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (beta != 1.f) {
    if (L_mon < 1 || L_mon > MAXL) return (int)cudaErrorInvalidValue;
    ekf3_fwd_kernel<true><<<n_blocks(B), EKF_THREADS, 0, st>>>(
        u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS, S_PLUS, P_MINUS,
        P_PLUS, T, B, gamma_discount, total_cases, beta, one_minus_beta,
        L_mon);
  } else {
    ekf3_fwd_kernel<false><<<n_blocks(B), EKF_THREADS, 0, st>>>(
        u, x, Rv, scal, vecs, s_init, Ps_init, S_MINUS, S_PLUS, P_MINUS,
        P_PLUS, T, B, gamma_discount, total_cases, beta, one_minus_beta,
        L_mon);
  }
  return (int)cudaGetLastError();
}

// forward outputs + scal, s_final (3,B), Ps_final (9,B) -> S_SMOOTH (T,3,B).
int ekf3_backward(const float* S_PLUS, const float* S_MINUS,
                  const float* P_PLUS, const float* P_MINUS, const float* scal,
                  const float* s_final, const float* Ps_final,
                  float* S_SMOOTH, int T, int B, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  ekf3_bwd_kernel<<<n_blocks(B), EKF_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      S_PLUS, S_MINUS, P_PLUS, P_MINUS, scal, s_final, Ps_final, S_SMOOTH, T,
      B);
  return (int)cudaGetLastError();
}

const char* ekf3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
