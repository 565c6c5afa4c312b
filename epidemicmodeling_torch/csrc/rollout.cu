// The controlled SI-alpha Euler rollout from the end-of-history state for
// Hopper (sm_90a): every schedule and region of a call in one launch, one
// thread a lane (Tools/SIalpha_Controlled.m semantics, as
// models/si_alpha.py's si_alpha_step_fields computes a step).
//
// It replaces no Pallas kernel: the JAX package runs these rollouts as
// lax.scan loops inside its compiled stages (the sweep's, the forecast
// scenarios' and the Monte Carlo's, epidemicmodeling_tpu/pipelines/
// core.py). The port ran them as eager Python loops: ~35 launches a step
// and a host sync for every clip bound made a device tensor, some 43,000
// launches and 5,000 syncs a float64 XPRIZE request.
//
// What it computes, per lane = g * R + r (schedule g, region r), from the
// region's state s0[r] = (s, i, alpha), for t = 0 .. H-1:
//   d     = sum_p a[r,p] (u_max[r,p] - u[g,r,t,p])            (p in order)
//   s'    = clip(s - dt (alpha s i + n_s s_std), 0, 1)
//   i'    = clip(i + dt (alpha s i - beta i + n_i i_std), 0, 1)
//   alpha'= clip(alpha + dt (-gamma alpha + gamma b + gamma d
//                            + n_a alpha_std), alpha_min, alpha_max)
// with clip(x, lo, hi) = fmax(lo, fmin(hi, x)): a NaN maps to hi, as
// MATLAB's max(lo, min(hi, x)) and utils/math.clip_lo_hi do, so a NaN in a
// prescribed u gives alpha_max. The noise terms are read only when a noise
// array is given (the stochastic forecast). Each product and sum rounds as
// the plain version's separate tensor ops do (built with --fmad=false);
// the only difference from it is the order of the sum over the NPIs.
// Outputs: each lane's horizon sum of s i alpha (cases, (s i) alpha summed
// from t = 0 in order, as the Monte Carlo's running sum), and optionally
// the trajectory, each field written through its own strides.
//
// Every array is read through the caller's strides: the sweep's
// batch-last prescription, the scenarios' (G, R, H, P) schedules and the
// Monte Carlo's (N, H, P) schedules at stride 0 over the regions, without
// a copy.
//
// What bounds it: the chain of H dependent steps a lane, each waiting on
// its P inputs from device memory. A sweep chunk (25 x 235 lanes, H = 92,
// P = 12, double) reads 52 MB of prescription, ~16 us at 3.35 TB/s, on 46
// blocks of 128 threads, too few warps to hide a load's latency. So each
// lane keeps its per-region parameters, a and u_max in registers (read
// once) and loads step t + 1's inputs while it computes step t: 3-4x
// faster than reading them at each step (PERF.md). P = NPI.
//
// Two instances of one template on the scalar type Real: float and double
// (entries rollout_f32 and rollout_f64).
//
// Registers (-Xptxas -v, sm_90a): printed by chip_smoke.py; PERF.md keeps
// the measured figures.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
// the NPIs, the OxCGRT's 12 as in ekf3/ekf6: a lane keeps its a, u_max
// and the next step's u in registers, NPI each (a runtime count up to 16
// or 12, masked, took 224 / 168 registers in double and ran the Monte
// Carlo 2.3x / 1.5x slower, PERF.md)
constexpr int NPI = 12;
// the per-region scalars, in the order of the C entry's `region` array
enum { DT, BETA, GAMMA, B, ALPHA_MIN, ALPHA_MAX, S_STD, I_STD, AL_STD,
       NPARAM };

template <typename Real>
struct Args {
  long long G, R, H;
  const Real* s0;
  long long s0_r, s0_k;
  const Real* par[NPARAM];
  long long par_r[NPARAM];
  const Real* a;
  long long a_r, a_p;
  const Real* u_max;
  long long m_r, m_p;
  const Real* u;
  long long u_g, u_r, u_t, u_p;
  const Real* noise;  // null: the deterministic rollout
  long long n_g, n_r, n_t, n_k;
  Real* traj[3];      // s, i, alpha (G, R, H); a null one is not written
  long long o_g[3], o_r[3], o_t[3];
  Real* cases;        // (G * R), lane order
};

template <typename Real>
__device__ __forceinline__ Real clip(Real x, Real lo, Real hi) {
  return fmax(lo, fmin(hi, x));
}

template <typename Real>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args<Real> A) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= A.G * A.R) return;
  const long long g = lane / A.R, r = lane - g * A.R;
  Real p[NPARAM];
#pragma unroll
  for (int k = 0; k < NPARAM; ++k) p[k] = A.par[k][r * A.par_r[k]];
  const Real* s0 = A.s0 + r * A.s0_r;
  Real s = s0[0], i = s0[A.s0_k], al = s0[2 * A.s0_k];
  const Real* u = A.u + g * A.u_g + r * A.u_r;
  const Real* nz = A.noise ? A.noise + g * A.n_g + r * A.n_r : nullptr;
  Real* out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = A.traj[k] ? A.traj[k] + g * A.o_g[k] + r * A.o_r[k] : nullptr;
  const Real gb = p[GAMMA] * p[B];
  // the lane's a and u_max, and the next step's inputs, in registers
  Real av[NPI], mv[NPI], un[NPI];
#pragma unroll
  for (int q = 0; q < NPI; ++q) {
    av[q] = A.a[r * A.a_r + q * A.a_p];
    mv[q] = A.u_max[r * A.m_r + q * A.m_p];
    un[q] = A.H > 0 ? u[q * A.u_p] : Real(0);
  }
  Real cases = Real(0);
  for (long long t = 0; t < A.H; ++t) {
    Real uc[NPI];
#pragma unroll
    for (int q = 0; q < NPI; ++q) uc[q] = un[q];
    if (t + 1 < A.H) {
      const Real* ut = u + (t + 1) * A.u_t;
#pragma unroll
      for (int q = 0; q < NPI; ++q) un[q] = ut[q * A.u_p];
    }
    Real d = Real(0);
#pragma unroll
    for (int q = 0; q < NPI; ++q) d = d + av[q] * (mv[q] - uc[q]);
    const Real flow = al * s * i;
    Real ds = flow, di = flow - p[BETA] * i;
    Real da = -p[GAMMA] * al + gb + p[GAMMA] * d;
    if (nz) {
      const Real* nt = nz + t * A.n_t;
      ds = ds + nt[0] * p[S_STD];
      di = di + nt[A.n_k] * p[I_STD];
      da = da + nt[2 * A.n_k] * p[AL_STD];
    }
    const Real s1 = clip(s - p[DT] * ds, Real(0), Real(1));
    const Real i1 = clip(i + p[DT] * di, Real(0), Real(1));
    al = clip(al + p[DT] * da, p[ALPHA_MIN], p[ALPHA_MAX]);
    s = s1;
    i = i1;
    cases = cases + s * i * al;
    if (out[0]) out[0][t * A.o_t[0]] = s;
    if (out[1]) out[1][t * A.o_t[1]] = i;
    if (out[2]) out[2][t * A.o_t[2]] = al;
  }
  A.cases[lane] = cases;
}

template <typename Real>
int rollout_launch(long long G, long long R, long long H, long long P,
                   const Real* s0, const long long* s0_st,
                   const Real* const* region, const long long* region_st,
                   const Real* a, const long long* a_st, const Real* u_max,
                   const long long* m_st, const Real* u, const long long* u_st,
                   const Real* noise, const long long* n_st,
                   Real* const* traj, const long long* traj_st, Real* cases,
                   void* stream) {
  if (G < 0 || R < 0 || H < 0 || P != NPI) return (int)cudaErrorInvalidValue;
  const long long lanes = G * R;
  if (lanes == 0) return (int)cudaSuccess;
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  Args<Real> A;
  A.G = G, A.R = R, A.H = H;
  A.s0 = s0, A.s0_r = s0_st[0], A.s0_k = s0_st[1];
  for (int k = 0; k < NPARAM; ++k)
    A.par[k] = region[k], A.par_r[k] = region_st[k];
  A.a = a, A.a_r = a_st[0], A.a_p = a_st[1];
  A.u_max = u_max, A.m_r = m_st[0], A.m_p = m_st[1];
  A.u = u, A.u_g = u_st[0], A.u_r = u_st[1], A.u_t = u_st[2],
  A.u_p = u_st[3];
  A.noise = noise;
  A.n_g = n_st[0], A.n_r = n_st[1], A.n_t = n_st[2], A.n_k = n_st[3];
  for (int k = 0; k < 3; ++k) {
    A.traj[k] = traj[k];
    A.o_g[k] = traj_st[3 * k], A.o_r[k] = traj_st[3 * k + 1],
    A.o_t[k] = traj_st[3 * k + 2];
  }
  A.cases = cases;
  rollout_kernel<Real><<<(unsigned)blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// G schedules x R regions, H steps, P = NPI NPIs. s0 (R, 3) at strides
// s0_st[2]; region: NPARAM pointers to (R,) arrays (dt, beta, gamma, b,
// alpha_min, alpha_max, s, i and alpha noise stds) at strides
// region_st[NPARAM]; a and u_max (R, P) at a_st[2], m_st[2]; u (G, R, H, P)
// at u_st[4]; noise (G, R, H, 3) at n_st[4], or null for the deterministic
// rollout; traj: 3 pointers (s, i, alpha: (G, R, H), row k of
// traj_st[3][3] their strides over g, r, t), each null or written; cases
// (G * R), contiguous. Strides in elements, any sign, 0 allowed. One
// launch on `stream` (none when G * R = 0); returns cudaGetLastError()
// after it, cudaErrorInvalidValue without a launch when P != NPI.
int rollout_f32(long long G, long long R, long long H, long long P,
                const float* s0, const long long* s0_st,
                const float* const* region, const long long* region_st,
                const float* a, const long long* a_st, const float* u_max,
                const long long* m_st, const float* u, const long long* u_st,
                const float* noise, const long long* n_st,
                float* const* traj, const long long* traj_st, float* cases,
                void* stream) {
  return rollout_launch(G, R, H, P, s0, s0_st, region, region_st, a, a_st,
                        u_max, m_st, u, u_st, noise, n_st, traj, traj_st,
                        cases, stream);
}

int rollout_f64(long long G, long long R, long long H, long long P,
                const double* s0, const long long* s0_st,
                const double* const* region, const long long* region_st,
                const double* a, const long long* a_st, const double* u_max,
                const long long* m_st, const double* u,
                const long long* u_st, const double* noise,
                const long long* n_st, double* const* traj,
                const long long* traj_st, double* cases, void* stream) {
  return rollout_launch(G, R, H, P, s0, s0_st, region, region_st, a, a_st,
                        u_max, m_st, u, u_st, noise, n_st, traj, traj_st,
                        cases, stream);
}

const char* rollout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
