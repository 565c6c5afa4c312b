// A design of epidemicmodeling_torch/csrc/ekf3.cu that was measured and not
// kept: the forward runs on a team of three threads a lane instead of one.
// scripts/kernel_ab.py --ekf3-variant times it against the port's kernel
// (PERF.md). Same C interface, geometry, gain pass and recursion as the
// port's; only the forward differs:
// - thread r of a lane's team (warp lanes 3 j + r, ten teams a warp) forms
//   row r of PC', of the Joseph update (I - KC) P (I - KC)' and of A P+ A',
//   every dot product in the port's order;
// - the rows meet by __shfl_sync: PC' (3 shuffles) before S, P+ (9) before
//   its symmetrization and the prediction, P- (9) before the next step; the
//   state, the gain and the Jacobian are formed by all three alike;
// - thread r copies the inputs e = r, r + 3, ... of each step into the ring
//   and stores row r of the outputs and the records;
// - after the forward, thread 0 of each team runs the lane's recursion.
// Its times beside the port's: PERF.md, Findings.
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

constexpr int TEAMS = 10;            // teams of M threads a warp
static_assert(MAX_LANES <= TEAMS * (THREADS / 32), "a block's lanes");

// v[r] without indexing a register array by a runtime value
__device__ __forceinline__ float pick(const float (&v)[M], int r) {
  return r == 0 ? v[0] : (r == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ void row_of(const float (&X)[M][M], int r,
                                       float (&row)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k)
    row[k] = r == 0 ? X[0][k] : (r == 1 ? X[1][k] : X[2][k]);
}

// X[i][k] = team member i's row[k]
__device__ __forceinline__ void gather_rows(unsigned mask, int base,
                                            const float (&row)[M],
                                            float (&X)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) X[i][k] = __shfl_sync(mask, row[k], base + i);
}

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

__device__ __forceinline__ void jacobian(const float (&s)[M], float dt,
                                         float beta, float gam,
                                         float (&A)[M][M]) {
  A[0][0] = 1.f - dt * s[2] * s[1];
  A[0][1] = -dt * s[2] * s[0];
  A[0][2] = -dt * s[0] * s[1];
  A[1][0] = dt * s[1] * s[2];
  A[1][1] = 1.f + dt * (s[0] * s[2] - beta);
  A[1][2] = dt * s[0] * s[1];
  A[2][0] = 0.f;
  A[2][1] = 0.f;
  A[2][2] = 1.f - dt * gam;
}

// The launch's shape: lanes a block, whether the records stay in shared
// memory, and the dynamic shared memory a block takes.
struct Geometry {
  int lanes, blocks, smem_hist;
  size_t smem_bytes;
};

inline Geometry geometry(int T, int B) {
  Geometry g;
  const size_t ring = (size_t)SLOTS * CHUNK * NIN;
  size_t fit = SMEM_LIMIT / (4 * (ring + (size_t)T * REC));
  if (fit > MAX_LANES) fit = MAX_LANES;
  g.smem_hist = fit >= 1 && (B + (int)fit - 1) / (int)fit <= SMS;
  g.lanes = g.smem_hist ? (int)fit : MAX_LANES;
  g.blocks = (B + g.lanes - 1) / g.lanes;
  g.smem_bytes = 4 * (size_t)g.lanes *
                 (ring + (g.smem_hist ? (size_t)T * REC
                                      : (size_t)SLOTS * CHUNK * RREC));
  return g;
}

template <bool ADAPTIVE, bool SMEM_HIST>
__global__ void __launch_bounds__(THREADS)
ekf3_kernel(const float* __restrict__ u, const float* __restrict__ x,
            const float* __restrict__ Rv, const float* __restrict__ scal,
            const float* __restrict__ vecs, const float* __restrict__ s_init,
            const float* __restrict__ Ps_init,
            const float* __restrict__ s_final, float* __restrict__ S_MINUS,
            float* __restrict__ S_PLUS, float* __restrict__ S_SMOOTH,
            float* __restrict__ hist_g, int T, int B, int LB, float gd,
            int total_cases, float beta, float one_minus_beta, int L_mon) {
  extern __shared__ float smem[];
  float* const in_ring = smem;                          // (SLOTS, CHUNK, NIN, LB)
  float* const hist_s = smem + SLOTS * CHUNK * NIN * LB;  // (T, REC, LB)
  float* const rec_ring = hist_s;                        // (SLOTS, CHUNK, RREC, LB)
  const int wp = threadIdx.x % 32;          // position in the warp
  const int r = wp % M;                       // this thread's matrix row
  const int base = wp - r;                    // warp position of the team's row 0
  const int l = (threadIdx.x / 32) * TEAMS + wp / M;   // the team's lane
  const int b0 = blockIdx.x * LB;
  const int nl = B - b0 < LB ? B - b0 : LB;   // live lanes of this block
  const int b = b0 + l;
  const bool chain = wp < TEAMS * M && l < nl;   // this thread's team runs lane b
  // the warp's live team members, for the shuffles
  const int live = nl - (l - wp / M);         // live lanes from this warp's first
  const unsigned mask =
      live >= TEAMS ? (1u << (TEAMS * M)) - 1u
                    : (live > 0 ? (1u << (live * M)) - 1u : 0u);
  // element e of the record of step t, lane l (b in the scratch)
  auto rec = [&](int t, int e, int ll) -> float* {
    return SMEM_HIST ? hist_s + ((size_t)t * REC + e) * LB + ll
                     : hist_g + ((size_t)t * REC + e) * B + b0 + ll;
  };
  float sp_last[M];

  if (chain) {
    const Params3 p = load_params(scal, b, B);
    float q[M], av[NPI], umax[NPI];
#pragma unroll
    for (int i = 0; i < M; ++i) q[i] = scal[at3(0, R_Q + i, NSCAL, b, B)];
#pragma unroll
    for (int k = 0; k < NPI; ++k) {
      av[k] = vecs[at3(V_A, k, NPI, b, B)];
      umax[k] = vecs[at3(V_UMAX, k, NPI, b, B)];
    }
    const float qr = pick(q, r);
    const float inv_gd = 1.f / gd;
    // team member r copies inputs r, r + M, ... of each step
    auto prefetch = [&](int c) {
      float* dst = in_ring + (c % SLOTS) * CHUNK * NIN * LB + l;
      const int t1 = (c + 1) * CHUNK < T ? (c + 1) * CHUNK : T;
      for (int t = c * CHUNK; t < t1; ++t) {
        float* d = dst + (t - c * CHUNK) * NIN * LB;
        for (int e = r; e < NIN; e += M) {
          const float* src = e < NPI ? u + at3(t, e, NPI, b, B)
                             : e == NPI ? x + at3(t, 0, 1, b, B)
                                        : Rv + at3(t, 0, 1, b, B);
          cp_async(d + e * LB, src);
        }
      }
      cp_async_commit();
    };

    float s[M], P[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s[i] = s_init[at3(0, i, M, b, B)];
#pragma unroll
      for (int j = 0; j < M; ++j)
        P[i][j] = Ps_init[at3(0, i * M + j, M * M, b, B)];
    }
    AdaptiveR<float, ADAPTIVE ? MAXL : 1> ad;
    if constexpr (ADAPTIVE) ad.init(Rv[b], L_mon);
    prefetch(0);

    for (int t = 0; t < T; ++t) {
      if (t % CHUNK == 0) {
        // this chunk has landed (each member waits for its own copies, the
        // warp sync shows them to the team and says the team has read the
        // slot the next chunk goes to)
        cp_async_wait_all();
        __syncwarp(mask);
        if (t + CHUNK < T) prefetch(t / CHUNK + 1);
      }
      const float* in =
          in_ring + ((t / CHUNK) % SLOTS * CHUNK + t % CHUNK) * NIN * LB + l;
      float Pr[M];
      row_of(P, r, Pr);
      S_MINUS[at3(t, r, M, b, B)] = pick(s, r);
      if (t > 0) {
        *rec(t - 1, E_SMN + r, l) = pick(s, r);
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (k <= r) *rec(t - 1, E_PM + tri(r, k), l) = Pr[k];
      }
      const float xt = in[NPI * LB];
      const float Rt = ADAPTIVE ? ad.R : in[(NPI + 1) * LB];
      // the known input's term of the drive, in input order
      float dot = av[0] * (umax[0] - in[0]);
#pragma unroll
      for (int k = 1; k < NPI; ++k) dot += av[k] * (umax[k] - in[k * LB]);

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

      // PC' row by row, one a team member, then gathered
      const float pc = Pr[0] * C[0] + Pr[1] * C[1] + Pr[2] * C[2];
      float PCt[M];
#pragma unroll
      for (int i = 0; i < M; ++i) PCt[i] = __shfl_sync(mask, pc, base + i);
      const float S = C[0] * PCt[0] + C[1] * PCt[1] + C[2] * PCt[2] + gd * Rt;
      const float inv_S = 1.f / S;
      float K[M];
#pragma unroll
      for (int i = 0; i < M; ++i) K[i] = valid ? PCt[i] * inv_S : 0.f;

      float IKC[M][M];
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          IKC[i][j] = (i == j ? 1.f : 0.f) - K[i] * C[j];
      // row r of (I - KC) P (I - KC)', then of the Joseph update
      float IKCr[M], T1r[M], Ppr[M];
      row_of(IKC, r, IKCr);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        float acc = IKCr[0] * P[0][k];
        acc += IKCr[1] * P[1][k];
        acc += IKCr[2] * P[2][k];
        T1r[k] = acc;
      }
      const float Kr = pick(K, r);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        float acc = T1r[0] * IKC[k][0];
        acc += T1r[1] * IKC[k][1];
        acc += T1r[2] * IKC[k][2];
        Ppr[k] = valid ? (acc + Kr * K[k] * Rt) * inv_gd : Pr[k];
      }
      float Pp[M][M];
      gather_rows(mask, base, Ppr, Pp);
      symmetrize<M>(Pp);
      float sp[M];
#pragma unroll
      for (int i = 0; i < M; ++i) sp[i] = valid ? s[i] + K[i] * innov : s[i];
      margins(sp, p);

      float Pps[M];
      row_of(Pp, r, Pps);
      S_PLUS[at3(t, r, M, b, B)] = pick(sp, r);
      *rec(t, E_SP + r, l) = pick(sp, r);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        sp_last[k] = sp[k];
        if (k <= r) *rec(t, E_PP + tri(r, k), l) = Pps[k];
      }

      // prediction: Euler step of the SI-alpha model with the known input
      const float drive = (p.gam * p.b - p.gam * sp[2]) + p.gam * dot;
      float sn[M];
      sn[0] = clip_lo_hi(sp[0] - p.dt * sp[2] * sp[0] * sp[1], p.smin, 1.f);
      sn[1] = clip_lo_hi(sp[1] + p.dt * (sp[2] * sp[0] * sp[1] - p.beta * sp[1]),
                         p.imin, 1.f);
      sn[2] = clip_lo_hi(sp[2] + p.dt * drive, p.amin, p.amax);
      margins(sn, p);

      // row r of A P+ A' + diag(q)
      float A[M][M], Ar[M], APr[M], Pnr[M];
      jacobian(sp, p.dt, p.beta, p.gam, A);
      row_of(A, r, Ar);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        float acc = Ar[0] * Pp[0][k];
        acc += Ar[1] * Pp[1][k];
        acc += Ar[2] * Pp[2][k];
        APr[k] = acc;
      }
#pragma unroll
      for (int k = 0; k < M; ++k) {
        float acc = APr[0] * A[k][0];
        acc += APr[1] * A[k][1];
        acc += APr[2] * A[k][2];
        Pnr[k] = k == r ? acc + qr : acc;
      }
      gather_rows(mask, base, Pnr, P);
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
    float sp[M], Pp[M][M], Pm[M][M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      sp[r] = *rec(t, E_SP + r, ll);
#pragma unroll
      for (int k = 0; k <= r; ++k) {
        Pp[r][k] = Pp[k][r] = *rec(t, E_PP + tri(r, k), ll);
        Pm[r][k] = Pm[k][r] = *rec(t, E_PM + tri(r, k), ll);
      }
    }
    float A[M][M], PAt[M][M], J[M][M];
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
  if (!chain || r != 0) return;   // thread 0 of a team runs the recursion

  // the recursion: terminal row, then ss = margins(s+ + J (ss_next - s-))
  const Params3 p = load_params(scal, b, B);
  float ssn[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float sf = s_final[at3(0, i, M, b, B)];
    ssn[i] = isnan(sf) ? sp_last[i] : sf;
    S_SMOOTH[at3(T - 1, i, M, b, B)] = ssn[i];
  }
  const int nrows = T - 1;
  // SMEM_HIST == false: records come through a reverse ring of CHUNK-row
  // slots, chunk c - 1 streaming in while chunk c is smoothed
  auto prefetch_rows = [&](int c) {
    float* dst = rec_ring + (c % SLOTS) * CHUNK * RREC * LB + l;
    const int t1 = (c + 1) * CHUNK < nrows ? (c + 1) * CHUNK : nrows;
    for (int t = c * CHUNK; t < t1; ++t)
      for (int e = 0; e < RREC; ++e)
        cp_async(dst + ((t - c * CHUNK) * RREC + e) * LB, rec(t, e, l));
    cp_async_commit();
  };
  if (!SMEM_HIST && nrows > 0) prefetch_rows((nrows - 1) / CHUNK);
  for (int t = nrows - 1; t >= 0; --t) {
    const float* row;
    if constexpr (SMEM_HIST) {
      row = rec(t, 0, l);
    } else {
      if (t == nrows - 1 || t % CHUNK == CHUNK - 1) {
        cp_async_wait_all();
        if (t >= CHUNK) prefetch_rows(t / CHUNK - 1);
      }
      row = rec_ring + ((t / CHUNK) % SLOTS * CHUNK + t % CHUNK) * RREC * LB + l;
    }
    float ss[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float dj = 0.f;
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

template <bool ADAPTIVE, bool SMEM_HIST>
int launch(const Geometry& g, cudaStream_t st, const float* u,
           const float* x, const float* Rv, const float* scal,
           const float* vecs, const float* s_init, const float* Ps_init,
           const float* s_final, float* S_MINUS, float* S_PLUS,
           float* S_SMOOTH, float* hist, int T, int B, float gd,
           int total_cases, float beta, float one_minus_beta, int L_mon) {
  auto kernel = ekf3_kernel<ADAPTIVE, SMEM_HIST>;
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

}  // namespace

extern "C" {

// u (T,12,B), x/Rv (T,B), scal (11,B), vecs (2,12,B), s_init (3,B),
// Ps_init (9,B), s_final (3,B, NaN = unconstrained) -> S_MINUS, S_PLUS,
// S_SMOOTH (T,3,B). hist: a (T,18,B) float32 scratch when the lanes'
// records do not stay in shared memory (ekf3_geometry: hist_floats > 0),
// else unused. beta != 1 adapts the fixed prior Rv[0] over an L_mon-step
// window (L_mon <= 64). One launch; returns cudaGetLastError() after it.
int ekf3_smoother(const float* u, const float* x, const float* Rv,
                  const float* scal, const float* vecs, const float* s_init,
                  const float* Ps_init, const float* s_final, float* S_MINUS,
                  float* S_PLUS, float* S_SMOOTH, float* hist, int T, int B,
                  float gamma_discount, int total_cases, float beta,
                  float one_minus_beta, int L_mon, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(T, B);
  if (!g.smem_hist && hist == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool adaptive = beta != 1.f;
  if (adaptive && (L_mon < 1 || L_mon > MAXL))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto run) {
    return run(g, st, u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
               S_MINUS, S_PLUS, S_SMOOTH, hist, T, B, gamma_discount,
               total_cases, beta, one_minus_beta, L_mon);
  };
  if (adaptive)
    return g.smem_hist ? go(launch<true, true>) : go(launch<true, false>);
  return g.smem_hist ? go(launch<false, true>) : go(launch<false, false>);
}

// The launch's shape for (T, B): lanes a block, blocks, whether the records
// stay in shared memory, its dynamic shared memory in bytes.
void ekf3_geometry(int T, int B, int* lanes, int* blocks, int* smem_hist,
                   long long* smem_bytes) {
  const Geometry g = geometry(T, B);
  *lanes = g.lanes;
  *blocks = g.blocks;
  *smem_hist = g.smem_hist;
  *smem_bytes = (long long)g.smem_bytes;
}

const char* ekf3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
