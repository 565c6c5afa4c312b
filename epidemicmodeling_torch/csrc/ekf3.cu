// 3-state SI-alpha EKF/EKS for Hopper (sm_90a): the CUDA port of the Pallas
// kernels _fwd3_kernel / _bwd3_kernel behind ekf3_pallas
// (epidemicmodeling_tpu/ops/pallas/ekf3_kernel.py:92, :198, :306), forward
// and backward in one launch.
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
//              terminal row is s_final with NaN entries taking the last
//              filtered value. The smoothed covariance, which no output
//              reads, is not computed.
//
// What bounds it on the card: each lane is a chain of T dependent forward
// steps, so the chain's latency sets the time, not bytes or flops. The design
// works on the chain:
// - vecs and the scalar rows sit in registers, read once a lane; the
//   drive's sum over the 12 inputs, sum_k a_k (u_max_k - u_k), depends on
//   the inputs alone, so it is formed off the chain and then scaled by
//   gamma, the plain version's association (the first design summed
//   gamma * a_k * (...) onto the state's term, 12 dependent steps);
// - each lane's step inputs (u, x, R) are prefetched CHUNK steps at a time
//   into a ring of SLOTS chunks in shared memory with cp.async, one chunk
//   ahead of the chain;
// - K = PC' / S takes one IEEE division and three multiplies, and the Joseph
//   update multiplies by 1/gd formed once a lane (PERF.md: these are the
//   only divisions changed; every root and the smoother's divisions stay
//   IEEE);
// - forward and backward run in one launch. The forward writes each step's
//   record (S+ and P+ of step t, S- and P- of step t+1, P as lower
//   triangles: REC floats) to shared memory when the lanes' histories fit
//   there, else to a device-memory scratch; stores never wait. The
//   smoother's gain J(t) does not depend on the smoothed states, so after
//   the forward all THREADS threads of the block compute every J(t) of the
//   block's lanes in parallel (one (lane, step) item a thread at a time, in
//   place over the record's covariances), and the backward recursion left
//   on the chain is ss = margins(s+ + J (ss_next - s-)), about ten
//   operations a step, its records read straight from shared memory or
//   through a reverse cp.async ring from the scratch;
// - one thread runs a lane's chain: a team of three threads a lane, each
//   forming one matrix row and meeting the others by shuffles
//   (scripts/variants/ekf3_team.cu), measured slower (PERF.md), since the
//   chain is bound by its latency, not by a warp's instruction count.
// Lanes: up to MAX_LANES a block, one thread each in warp 0; the block takes
// as many lanes as their histories fit in SMEM_LIMIT, as long as the blocks
// still fit in one wave on SMS SMs, else MAX_LANES lanes and the scratch.
// A record's size follows the instance's width, so the lanes a block do
// too: B = 235 at T = 532 takes 5 lanes a block (47 blocks) in float, 2
// (118 blocks) in double; at T = 440, 7 (34 blocks) and 3 (79 blocks).
// ekf3_kernel.ekf3_geometry restates this choice, and
// tests/test_torch_kernel_layout.py checks the two agree.
//
// Two instances of one template on the scalar type Real: float and double
// (entries ekf3_smoother and ekf3_smoother_f64); the double one is the
// float one with every value, input and record twice as wide.
//
// Registers (-Xptxas -v, sm_90a): printed by chip_smoke.py; PERF.md keeps
// the measured figures.
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

constexpr int THREADS = 128;
constexpr int MAX_LANES = 32;
constexpr int SMS = 132;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may take
constexpr int CHUNK = 8;             // steps a ring slot holds
constexpr int SLOTS = 2;
constexpr int NIN = NPI + 2;         // a step's inputs: u (12), x, R
// a step's record: S+ (3), S- of the next step (3), P+ and P- of the next
// step as lower triangles (6 + 6); after the gain pass J (9) replaces the
// covariances, and the recursion reads the first RREC floats
enum { E_SP = 0, E_SMN = 3, E_PP = 6, E_PM = 12, E_J = 6, REC = 18 };
constexpr int RREC = 15;

__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }

template <typename Real>
struct Params3 {
  Real dt, beta, gam, b, smin, imin, amin, amax;
};

template <typename Real>
__device__ __forceinline__ Params3<Real> load_params(const Real* scal,
                                                     int b, int B) {
  Params3<Real> p;
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

template <typename Real>
__device__ __forceinline__ void margins(Real (&s)[M],
                                        const Params3<Real>& p) {
  s[0] = clip_hi_lo(s[0], p.smin, Real(1));
  s[1] = clip_hi_lo(s[1], p.imin, Real(1));
  s[2] = clip_hi_lo(s[2], p.amin, p.amax);
}

template <typename Real>
__device__ __forceinline__ void jacobian(const Real (&s)[M], Real dt,
                                         Real beta, Real gam,
                                         Real (&A)[M][M]) {
  A[0][0] = Real(1) - dt * s[2] * s[1];
  A[0][1] = -dt * s[2] * s[0];
  A[0][2] = -dt * s[0] * s[1];
  A[1][0] = dt * s[1] * s[2];
  A[1][1] = Real(1) + dt * (s[0] * s[2] - beta);
  A[1][2] = dt * s[0] * s[1];
  A[2][0] = Real(0);
  A[2][1] = Real(0);
  A[2][2] = Real(1) - dt * gam;
}

// The launch's shape: lanes a block, whether the records stay in shared
// memory, and the dynamic shared memory a block takes.
struct Geometry {
  int lanes, blocks, smem_hist;
  size_t smem_bytes;
};

template <typename Real>
inline Geometry geometry(int T, int B) {
  Geometry g;
  const size_t ring = (size_t)SLOTS * CHUNK * NIN;
  size_t fit = SMEM_LIMIT / (sizeof(Real) * (ring + (size_t)T * REC));
  if (fit > MAX_LANES) fit = MAX_LANES;
  g.smem_hist = fit >= 1 && (B + (int)fit - 1) / (int)fit <= SMS;
  g.lanes = g.smem_hist ? (int)fit : MAX_LANES;
  g.blocks = (B + g.lanes - 1) / g.lanes;
  g.smem_bytes = sizeof(Real) * (size_t)g.lanes *
                 (ring + (g.smem_hist ? (size_t)T * REC
                                      : (size_t)SLOTS * CHUNK * RREC));
  return g;
}

template <typename Real, bool ADAPTIVE, bool SMEM_HIST>
__global__ void __launch_bounds__(THREADS)
ekf3_kernel(const Real* __restrict__ u, const Real* __restrict__ x,
            const Real* __restrict__ Rv, const Real* __restrict__ scal,
            const Real* __restrict__ vecs, const Real* __restrict__ s_init,
            const Real* __restrict__ Ps_init,
            const Real* __restrict__ s_final, Real* __restrict__ S_MINUS,
            Real* __restrict__ S_PLUS, Real* __restrict__ S_SMOOTH,
            Real* __restrict__ hist_g, int T, int B, int LB, Real gd,
            int total_cases, Real beta, Real one_minus_beta, int L_mon) {
  // the dynamic shared memory, declared float in both instances (an extern
  // array keeps one type across a template's instances); it starts the
  // block's shared memory, aligned for either
  extern __shared__ float smem[];
  Real* const base = reinterpret_cast<Real*>(smem);
  Real* const in_ring = base;                          // (SLOTS, CHUNK, NIN, LB)
  Real* const hist_s = base + SLOTS * CHUNK * NIN * LB;  // (T, REC, LB)
  Real* const rec_ring = hist_s;                        // (SLOTS, CHUNK, RREC, LB)
  const int l = threadIdx.x;
  const int b0 = blockIdx.x * LB;
  const int nl = B - b0 < LB ? B - b0 : LB;   // live lanes of this block
  const int b = b0 + l;
  const bool chain = l < nl;                  // this thread runs lane b
  // element e of the record of step t, lane l (b in the scratch)
  auto rec = [&](int t, int e, int ll) -> Real* {
    return SMEM_HIST ? hist_s + ((size_t)t * REC + e) * LB + ll
                     : hist_g + ((size_t)t * REC + e) * B + b0 + ll;
  };
  Real sp_last[M];

  if (chain) {
    const Params3<Real> p = load_params(scal, b, B);
    Real q[M], av[NPI], umax[NPI];
#pragma unroll
    for (int i = 0; i < M; ++i) q[i] = scal[at3(0, R_Q + i, NSCAL, b, B)];
#pragma unroll
    for (int k = 0; k < NPI; ++k) {
      av[k] = vecs[at3(V_A, k, NPI, b, B)];
      umax[k] = vecs[at3(V_UMAX, k, NPI, b, B)];
    }
    const Real inv_gd = Real(1) / gd;
    auto prefetch = [&](int c) {
      Real* dst = in_ring + (c % SLOTS) * CHUNK * NIN * LB + l;
      const int t1 = (c + 1) * CHUNK < T ? (c + 1) * CHUNK : T;
      for (int t = c * CHUNK; t < t1; ++t) {
        Real* d = dst + (t - c * CHUNK) * NIN * LB;
#pragma unroll
        for (int k = 0; k < NPI; ++k)
          cp_async(d + k * LB, u + at3(t, k, NPI, b, B));
        cp_async(d + NPI * LB, x + at3(t, 0, 1, b, B));
        cp_async(d + (NPI + 1) * LB, Rv + at3(t, 0, 1, b, B));
      }
      cp_async_commit();
    };

    Real s[M], P[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s[i] = s_init[at3(0, i, M, b, B)];
#pragma unroll
      for (int j = 0; j < M; ++j)
        P[i][j] = Ps_init[at3(0, i * M + j, M * M, b, B)];
    }
    AdaptiveR<Real, ADAPTIVE ? MAXL : 1> ad;
    if constexpr (ADAPTIVE) ad.init(Rv[b], L_mon);
    prefetch(0);

    for (int t = 0; t < T; ++t) {
      if (t % CHUNK == 0) {
        // this chunk has landed; the next one streams in behind the chain
        cp_async_wait_all();
        if (t + CHUNK < T) prefetch(t / CHUNK + 1);
      }
      const Real* in =
          in_ring + ((t / CHUNK) % SLOTS * CHUNK + t % CHUNK) * NIN * LB + l;
#pragma unroll
      for (int i = 0; i < M; ++i) S_MINUS[at3(t, i, M, b, B)] = s[i];
      if (t > 0) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          *rec(t - 1, E_SMN + i, l) = s[i];
#pragma unroll
          for (int k = 0; k <= i; ++k) *rec(t - 1, E_PM + tri(i, k), l) = P[i][k];
        }
      }
      const Real xt = in[NPI * LB];
      const Real Rt = ADAPTIVE ? ad.R : in[(NPI + 1) * LB];
      // the known input's term of the drive, in input order
      Real dot = av[0] * (umax[0] - in[0]);
#pragma unroll
      for (int k = 1; k < NPI; ++k) dot += av[k] * (umax[k] - in[k * LB]);

      Real C[M], xp;
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
      const Real inv_S = Real(1) / S;
      Real K[M];
#pragma unroll
      for (int i = 0; i < M; ++i) K[i] = valid ? PCt[i] * inv_S : Real(0);

      Real IKC[M][M], T1[M][M], Pp[M][M];
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          IKC[i][j] = (i == j ? Real(1) : Real(0)) - K[i] * C[j];
      matmul<M>(IKC, P, T1);
      matmul_t<M>(T1, IKC, Pp);
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          Pp[i][j] = valid ? (Pp[i][j] + K[i] * K[j] * Rt) * inv_gd : P[i][j];
      symmetrize<M>(Pp);
      Real sp[M];
#pragma unroll
      for (int i = 0; i < M; ++i) sp[i] = valid ? s[i] + K[i] * innov : s[i];
      margins(sp, p);

#pragma unroll
      for (int i = 0; i < M; ++i) {
        S_PLUS[at3(t, i, M, b, B)] = sp[i];
        *rec(t, E_SP + i, l) = sp[i];
        sp_last[i] = sp[i];
#pragma unroll
        for (int k = 0; k <= i; ++k) *rec(t, E_PP + tri(i, k), l) = Pp[i][k];
      }

      // prediction: Euler step of the SI-alpha model with the known input
      const Real drive = (p.gam * p.b - p.gam * sp[2]) + p.gam * dot;
      Real sn[M];
      sn[0] = clip_lo_hi(sp[0] - p.dt * sp[2] * sp[0] * sp[1], p.smin, Real(1));
      sn[1] = clip_lo_hi(sp[1] + p.dt * (sp[2] * sp[0] * sp[1] - p.beta * sp[1]),
                         p.imin, Real(1));
      sn[2] = clip_lo_hi(sp[2] + p.dt * drive, p.amin, p.amax);
      margins(sn, p);

      Real A[M][M], AP[M][M];
      jacobian(sp, p.dt, p.beta, p.gam, A);
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
  __syncthreads();

  // the smoother gains J(t) = P+ A' inv(P-[t+1]), t = 0 .. T-2, of every
  // lane of the block, one (lane, step) item a thread, over the record
  for (int i = threadIdx.x; i < nl * (T - 1); i += THREADS) {
    const int ll = i % nl, t = i / nl, bb = b0 + ll;
    Real sp[M], Pp[M][M], Pm[M][M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      sp[r] = *rec(t, E_SP + r, ll);
#pragma unroll
      for (int k = 0; k <= r; ++k) {
        Pp[r][k] = Pp[k][r] = *rec(t, E_PP + tri(r, k), ll);
        Pm[r][k] = Pm[k][r] = *rec(t, E_PM + tri(r, k), ll);
      }
    }
    Real A[M][M], PAt[M][M], J[M][M];
    jacobian(sp, scal[at3(0, R_DT, NSCAL, bb, B)],
             scal[at3(0, R_BETA, NSCAL, bb, B)],
             scal[at3(0, R_GAMMA, NSCAL, bb, B)], A);
    matmul_t<M>(Pp, A, PAt);
    smoother_gain<M>(Pm, PAt, J);
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) *rec(t, E_J + r * M + c, ll) = J[r][c];
  }
  __syncthreads();
  if (!chain) return;

  // the recursion: terminal row, then ss = margins(s+ + J (ss_next - s-))
  const Params3<Real> p = load_params(scal, b, B);
  Real ssn[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const Real sf = s_final[at3(0, i, M, b, B)];
    ssn[i] = isnan(sf) ? sp_last[i] : sf;
    S_SMOOTH[at3(T - 1, i, M, b, B)] = ssn[i];
  }
  const int nrows = T - 1;
  // SMEM_HIST == false: records come through a reverse ring of CHUNK-row
  // slots, chunk c - 1 streaming in while chunk c is smoothed
  auto prefetch_rows = [&](int c) {
    Real* dst = rec_ring + (c % SLOTS) * CHUNK * RREC * LB + l;
    const int t1 = (c + 1) * CHUNK < nrows ? (c + 1) * CHUNK : nrows;
    for (int t = c * CHUNK; t < t1; ++t)
      for (int e = 0; e < RREC; ++e)
        cp_async(dst + ((t - c * CHUNK) * RREC + e) * LB, rec(t, e, l));
    cp_async_commit();
  };
  if (!SMEM_HIST && nrows > 0) prefetch_rows((nrows - 1) / CHUNK);
  for (int t = nrows - 1; t >= 0; --t) {
    const Real* row;
    if constexpr (SMEM_HIST) {
      row = rec(t, 0, l);
    } else {
      if (t == nrows - 1 || t % CHUNK == CHUNK - 1) {
        cp_async_wait_all();
        if (t >= CHUNK) prefetch_rows(t / CHUNK - 1);
      }
      row = rec_ring + ((t / CHUNK) % SLOTS * CHUNK + t % CHUNK) * RREC * LB + l;
    }
    Real ss[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Real dj = Real(0);
#pragma unroll
      for (int j = 0; j < M; ++j)
        dj += row[(E_J + i * M + j) * LB] * (ssn[j] - row[(E_SMN + j) * LB]);
      ss[i] = row[(E_SP + i) * LB] + dj;
    }
    margins(ss, p);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      S_SMOOTH[at3(t, i, M, b, B)] = ss[i];
      ssn[i] = ss[i];
    }
  }
}

template <typename Real, bool ADAPTIVE, bool SMEM_HIST>
int launch(const Geometry& g, cudaStream_t st, const Real* u,
           const Real* x, const Real* Rv, const Real* scal,
           const Real* vecs, const Real* s_init, const Real* Ps_init,
           const Real* s_final, Real* S_MINUS, Real* S_PLUS,
           Real* S_SMOOTH, Real* hist, int T, int B, Real gd,
           int total_cases, Real beta, Real one_minus_beta, int L_mon) {
  auto kernel = ekf3_kernel<Real, ADAPTIVE, SMEM_HIST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, THREADS, g.smem_bytes, st>>>(
      u, x, Rv, scal, vecs, s_init, Ps_init, s_final, S_MINUS, S_PLUS,
      S_SMOOTH, hist, T, B, g.lanes, gd, total_cases, beta, one_minus_beta,
      L_mon);
  return (int)cudaGetLastError();
}

// One call of either instance: the shape, the checks and the launch.
template <typename Real>
int smoother(const Real* u, const Real* x, const Real* Rv, const Real* scal,
             const Real* vecs, const Real* s_init, const Real* Ps_init,
             const Real* s_final, Real* S_MINUS, Real* S_PLUS,
             Real* S_SMOOTH, Real* hist, int T, int B, Real gamma_discount,
             int total_cases, Real beta, Real one_minus_beta, int L_mon,
             void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry<Real>(T, B);
  if (!g.smem_hist && hist == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool adaptive = beta != Real(1);
  if (adaptive && (L_mon < 1 || L_mon > MAXL))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto run) {
    return run(g, st, u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
               S_MINUS, S_PLUS, S_SMOOTH, hist, T, B, gamma_discount,
               total_cases, beta, one_minus_beta, L_mon);
  };
  if (adaptive)
    return g.smem_hist ? go(launch<Real, true, true>)
                       : go(launch<Real, true, false>);
  return g.smem_hist ? go(launch<Real, false, true>)
                     : go(launch<Real, false, false>);
}

}  // namespace

extern "C" {

// u (T,12,B), x/Rv (T,B), scal (11,B), vecs (2,12,B), s_init (3,B),
// Ps_init (9,B), s_final (3,B, NaN = unconstrained) -> S_MINUS, S_PLUS,
// S_SMOOTH (T,3,B). hist: a (T,18,B) scratch of the instance's type when
// the lanes' records do not stay in shared memory (ekf3_geometry:
// hist_floats > 0), else unused. beta != 1 adapts the fixed prior Rv[0]
// over an L_mon-step window (L_mon <= 64). One launch; returns
// cudaGetLastError() after it. ekf3_smoother is the float instance,
// ekf3_smoother_f64 the double one (every array and scalar double).
int ekf3_smoother(const float* u, const float* x, const float* Rv,
                  const float* scal, const float* vecs, const float* s_init,
                  const float* Ps_init, const float* s_final, float* S_MINUS,
                  float* S_PLUS, float* S_SMOOTH, float* hist, int T, int B,
                  float gamma_discount, int total_cases, float beta,
                  float one_minus_beta, int L_mon, void* stream) {
  return smoother<float>(u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
                         S_MINUS, S_PLUS, S_SMOOTH, hist, T, B,
                         gamma_discount, total_cases, beta, one_minus_beta,
                         L_mon, stream);
}

int ekf3_smoother_f64(const double* u, const double* x, const double* Rv,
                      const double* scal, const double* vecs,
                      const double* s_init, const double* Ps_init,
                      const double* s_final, double* S_MINUS,
                      double* S_PLUS, double* S_SMOOTH, double* hist, int T,
                      int B, double gamma_discount, int total_cases,
                      double beta, double one_minus_beta, int L_mon,
                      void* stream) {
  return smoother<double>(u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
                          S_MINUS, S_PLUS, S_SMOOTH, hist, T, B,
                          gamma_discount, total_cases, beta, one_minus_beta,
                          L_mon, stream);
}

// The float instance's launch shape for (T, B): lanes a block, blocks,
// whether the records stay in shared memory, its dynamic shared memory in
// bytes.
void ekf3_geometry(int T, int B, int* lanes, int* blocks, int* smem_hist,
                   long long* smem_bytes) {
  const Geometry g = geometry<float>(T, B);
  *lanes = g.lanes;
  *blocks = g.blocks;
  *smem_hist = g.smem_hist;
  *smem_bytes = (long long)g.smem_bytes;
}

const char* ekf3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
