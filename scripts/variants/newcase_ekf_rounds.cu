// A design of epidemicmodeling_torch/csrc/newcase_ekf.cu that was measured
// and not kept: the smoother forms each step's gain in six pivot rounds
// with a block barrier after each, one gain at a time, where the port's
// kernel keeps six gains in flight, one round apart, with one barrier a
// step. scripts/kernel_ab.py --newcase-csrc times it against the port's
// kernel and holds it bit for bit against it (PERF.md). The same
// forward, geometry (16 lanes a block, six threads a lane and a monitor
// thread), scratch layout and scoring as the port's, and its
// device-pointer entry alone.
//
// The smoother, per step, seven block barriers: the gain J = (P+ A^T) / P-
// is mrdivide's Gauss-Jordan elimination of the 6 x 12 system
// [P-^T | (P+ A^T)^T], whose column j is row j of P- and row j of P+ A^T:
// thread j owns columns j and 6 + j. For each column c in turn the owner of
// column c scans it for the pivot (strict > on fabs, from row c + 1
// upward) and publishes the column and the pivot; after a barrier every
// thread swaps, divides and eliminates its own two columns. Column 6 + j is
// then row j of J, and thread j forms entry j of the smoothed state.

#include <cuda_runtime.h>

#include <cstddef>

#include "newcase_ekf.cuh"

namespace {

using nce::M;
using nce::Mat6;
using nce::Params;

constexpr int LANES = 16;                   // epsilon lanes a block
constexpr int MON = M;                      // the monitor's group (rows 0..5)
constexpr int BLOCK = (M + 1) * LANES;      // threads a block
constexpr int MAX_MONITOR = 64;             // longest innovation monitor
// doubles of device scratch a lane and step: S_MINUS, S_PLUS (6 each),
// P_MINUS, PAT = P+ A^T (36 each)
constexpr int SCRATCH_PER_LANE_STEP = 2 * M + 2 * M * M;
// the backward's inputs of one step in shared memory: S_PLUS[t],
// S_MINUS[t+1], then thread j's rows j of PAT[t] and of P_MINUS[t+1]
enum { B_SP = 0, B_SM = M, B_PAT = 2 * M, B_PM = 2 * M + M * M,
       NB = 2 * M + 2 * M * M };

struct SweepArgs {
    const double* u;  // (T, P), NaN = optimized
    const double* x;  // (T,)
    int T, P, T_hist;
    double dt, beta_model, gamma_model, b_coef, sigma, alpha_min, alpha_max;
    const double* eps;  // (E,)
    int E;
    const double *a, *u_min, *u_max, *w;  // (P,)
    const double *s_init, *Ps_init, *s_final, *Ps_final, *Q;  // 6, 36
    const double* R_v;  // (T,)
    double beta_ekf, gamma_ekf;
    int inv_monitor_len;
    const double* sia_hist;  // (T_hist, 3)
    double* scratch;         // T * SCRATCH_PER_LANE_STEP * E
    double* U_out;           // (E, T, P)
    double *J0, *J1;         // (E,); null: no re-simulation, no costs
    double *S_PLUS_out, *S_SMOOTH_out;  // (E, T, 6) or null
};

// The block's shared memory: the forward's and the backward's in turn. An
// array [k][LANES] keeps a half-warp's accesses on consecutive doubles.
struct ForwardShared {
    double in[2][nce::MAX_NPI + 2];  // step inputs u (P), x, R_v; by parity
    double Pm[M * M][LANES];         // rows of P-[t]
    double Pp[M * M][LANES];         // rows of P+[t]
    double sp[M][LANES];             // s+[t]
    double inn[MAX_MONITOR][LANES];  // the monitor's rings
    double cov[MAX_MONITOR][LANES];
    double R[LANES];                 // the adapted R of the next step
    double xp[LANES];                // the predicted observation of step t
    // input k's terms of the drive of alpha and of the band entry A[2][5]
    double terms[2][nce::MAX_NPI][LANES];
};
struct BackwardShared {
    double in[2][NB][LANES];  // the step's inputs, by parity
    double col[2][M][LANES];  // the pivot column, by column parity
    int piv[2][LANES];
    double ss[2][M][LANES];   // the smoothed state, by step parity
};
union Shared {
    ForwardShared f;
    BackwardShared b;
};

// An 8-byte asynchronous copy from device to shared memory (cp.async),
// waited for by cp_wait_all and a barrier. Outside device code (a host
// compiler's build of this file) the copy is made at once.
__device__ __forceinline__ void cp8(double* dst, const double* src) {
#ifdef __CUDA_ARCH__
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_wait_all() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// v[r] for a row r known only at run time, without indexing a register
// array (which would put it in local memory)
__device__ __forceinline__ double pick(const double (&v)[M], int r) {
    double out = v[0];
#pragma unroll
    for (int i = 1; i < M; ++i) out = (r == i) ? v[i] : out;
    return out;
}

// hard_margins applied to entry r of a state alone
__device__ __forceinline__ double margin_of(double v, int r,
                                            const Params& p) {
    if (r < 2) return nce::margin_unit(v);
    if (r == 2) return nce::margin_alpha(v, p);
    return v;
}

// mrdivide's step for pivot column col on one column X of the system: swap
// rows col and piv, divide row col by d, and take f = cs[r] times row col
// from every other row r whose f is not 0. cs: the pivot column, swapped.
__device__ __forceinline__ void eliminate(double (&X)[M], const double (&cs)[M],
                                          int col, int piv, double d) {
    const double xc = X[col];
    double xp = xc;
#pragma unroll
    for (int i = col + 1; i < M; ++i) xp = (i == piv) ? X[i] : xp;
#pragma unroll
    for (int i = col + 1; i < M; ++i) X[i] = (i == piv) ? xc : X[i];
    X[col] = xp / d;
#pragma unroll
    for (int r = 0; r < M; ++r) {
        if (r == col) continue;
        const double f = cs[r];
        if (f != 0.0) X[r] -= f * X[col];
    }
}

// A lane's (J0, J1): nce::horizon_costs' sums in its order, J0 in one
// thread and J1 in another. Each runs over batches of SCORE_BATCH values
// whose loads and products hold no branch and are issued a batch ahead of
// the dependent adds: U was written by the team just before, and a chain
// that waited on each load would take ~140 cycles a value.
constexpr int SCORE_BATCH = 32;

// x[0] w[0] + x[1] w[1 % P] + ... + x[n-1] w[(n-1) % P], added in that
// order to +0: J1's sum over U (t-major, k inner).
__device__ double weighted_sum(const double* x, int n, const double* w,
                               int P) {
    constexpr int B = SCORE_BATCH;
    const int full = n - n % B;
    double sum = 0.0, next[B];
    int k = 0;
    if (full > 0) {
#pragma unroll
        for (int j = 0; j < B; ++j) next[j] = x[j];
    }
    for (int i0 = 0; i0 < full; i0 += B) {
        double prod[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
            prod[j] = w[k] * next[j];
            k = (k + 1 == P) ? 0 : k + 1;
        }
        if (i0 + B < full) {
#pragma unroll
            for (int j = 0; j < B; ++j) next[j] = x[i0 + B + j];
        }
#pragma unroll
        for (int j = 0; j < B; ++j) sum += prod[j];
    }
    for (int i = full; i < n; ++i) {
        sum += w[k] * x[i];
        k = (k + 1 == P) ? 0 : k + 1;
    }
    return sum;
}

// J0: the history's new cases, then the re-simulated horizon's (rows
// T_hist..T-1 of U), over T.
__device__ double horizon_j0(const double* U, const SweepArgs& a,
                             const Params& p) {
    constexpr int B = SCORE_BATCH;
    const int T = a.T, P = a.P, T_hist = a.T_hist;
    const double* sia = a.sia_hist;
    double sum_cases = 0.0, v[B];
    const int full_hist = T_hist - T_hist % B;
    for (int t0 = 0; t0 < full_hist; t0 += B) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
            const double* d = sia + (size_t)(t0 + j) * 3;
            v[j] = d[0] * d[1] * d[2];
        }
#pragma unroll
        for (int j = 0; j < B; ++j) sum_cases += v[j];
    }
    for (int t = full_hist; t < T_hist; ++t)
        sum_cases += sia[t * 3 + 0] * sia[t * 3 + 1] * sia[t * 3 + 2];
    double sc = sia[(T_hist - 1) * 3 + 0];
    double ic = sia[(T_hist - 1) * 3 + 1];
    double al = sia[(T_hist - 1) * 3 + 2];
    auto step = [&](double drive_u) {
        nce::resim_step(drive_u, a.dt, a.beta_model, a.gamma_model,
                        a.b_coef, a.alpha_min, a.alpha_max, sc, ic, al);
        sum_cases += sc * ic * al;
    };
    if (P == 0) {
        for (int t = T_hist; t < T; ++t) step(0.0);
        return sum_cases / (double)T;
    }
    // the horizon's rows as one run of values, a row's drive the sum of its
    // P terms a[k] (u_max[k] - u), stepped at each row's end
    const double* u = U + (size_t)T_hist * P;
    const int n = (T - T_hist) * P, full = n - n % B;
    double drive_u = 0.0;
    int k = 0;
    for (int i0 = 0; i0 < full; i0 += B) {
        int kj[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
            v[j] = p.a[k] * (p.u_max[k] - u[i0 + j]);
            kj[j] = k;
            k = (k + 1 == P) ? 0 : k + 1;
        }
#pragma unroll
        for (int j = 0; j < B; ++j) {
            drive_u += v[j];
            if (kj[j] == P - 1) {
                step(drive_u);
                drive_u = 0.0;
            }
        }
    }
    for (int i = full; i < n; ++i) {
        drive_u += p.a[k] * (p.u_max[k] - u[i]);
        if (++k == P) {
            step(drive_u);
            drive_u = 0.0;
            k = 0;
        }
    }
    return sum_cases / (double)T;
}

__global__ void __launch_bounds__(BLOCK) newcase_ekf_kernel(const SweepArgs a) {
    __shared__ Shared sh;
    __shared__ double vecs[4][nce::MAX_NPI];  // a, u_min, u_max, w
    const int g = threadIdx.x / LANES;        // row r of the team, or MON
    const int l = threadIdx.x % LANES;
    const int lane = blockIdx.x * LANES + l;
    const bool live = lane < a.E;
    const int bl = live ? lane : a.E - 1;
    const int T = a.T, P = a.P;
    const size_t E = a.E;
    // lanes-last scratch: element k of step t at ((t * n + k) * E + lane)
    double* S_MINUS = a.scratch;
    double* S_PLUS = S_MINUS + (size_t)T * M * E;
    double* P_MINUS = S_PLUS + (size_t)T * M * E;
    double* PAT = P_MINUS + (size_t)T * M * M * E;
    const size_t vec_step = (size_t)M * E, mat_step = (size_t)M * M * E;

    for (int e = threadIdx.x; e < 4 * P; e += BLOCK) {
        const double* src[] = {a.a, a.u_min, a.u_max, a.w};
        vecs[e / P][e % P] = src[e / P][e % P];
    }
    const Params p{a.dt, a.beta_model, a.gamma_model, a.b_coef, a.eps[bl],
                   a.sigma, a.alpha_min, a.alpha_max, vecs[0], vecs[1],
                   vecs[2], vecs[3], P};
    const bool adaptive = (a.beta_ekf != 1.0);
    const int L = a.inv_monitor_len;

    // ---- forward ----
    double s[M];  // s-[t], in every thread of the team
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] = a.s_init[i];
    double q[M] = {0, 0, 0, 0, 0, 0};  // row g of Q
    if (g < M) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
            sh.f.Pm[g * M + j][l] = a.Ps_init[g * M + j];
            q[j] = a.Q[g * M + j];
        }
        if (g == 0) {
            double C[M], xp;
            nce::observe(s, C, xp);
            sh.f.xp[l] = xp;
        }
    } else if (adaptive) {
        for (int j = 0; j < L; ++j) sh.f.inn[j][l] = sh.f.cov[j][l] = 0.0;
        sh.f.R[l] = a.R_v[0];
    }
    auto prefetch_forward = [&](int t) {
        const int e = threadIdx.x;
        if (e < P + 2) {
            const double* src = e < P ? a.u + (size_t)t * P + e
                                : e == P ? a.x + t : a.R_v + t;
            cp8(&sh.f.in[t & 1][e], src);
        }
        cp_commit();
    };
    prefetch_forward(0);
    double R_mon = a.R_v[0];  // the monitor's adapted R
    int pos = 0, cnt = 1;     // the monitor's newest slot and count

    for (int t = 0; t < T; ++t) {
        // step t's inputs, the rows of P-[t], R and x_pred are in place
        cp_wait_all();
        __syncthreads();
        const double* in = sh.f.in[t & 1];
        const double x_t = in[P];
        const bool valid = !nce::is_nan(x_t);
        if (t + 1 < T) prefetch_forward(t + 1);

        double Ppr[M];  // row g of P+[t]
        if (g < M) {
            const int r = g;
            double C[M], xp;
            nce::observe(s, C, xp);
            double spr = pick(s, r);
            if (valid) {
                const double R = adaptive ? sh.f.R[l] : in[P + 1];
                double PCt[M];
#pragma unroll
                for (int i = 0; i < M; ++i) {
                    double acc = 0.0;
#pragma unroll
                    for (int j = 0; j < M; ++j) acc += sh.f.Pm[i * M + j][l] * C[j];
                    PCt[i] = acc;
                }
                double S = a.gamma_ekf * R;
#pragma unroll
                for (int i = 0; i < M; ++i) S += C[i] * PCt[i];
                const double innov = x_t - xp;
                const double K = pick(PCt, r) / S;
                // row r of (I - K C) P- / gamma
                double v[M];
#pragma unroll
                for (int k2 = 0; k2 < M; ++k2)
                    v[k2] = ((r == k2) ? 1.0 : 0.0) - K * C[k2];
#pragma unroll
                for (int j = 0; j < M; ++j) {
                    double ikc = 0.0;
#pragma unroll
                    for (int k2 = 0; k2 < M; ++k2)
                        ikc += v[k2] * sh.f.Pm[k2 * M + j][l];
                    Ppr[j] = ikc / a.gamma_ekf;
                }
                spr = spr + K * innov;
            } else {
#pragma unroll
                for (int j = 0; j < M; ++j) Ppr[j] = sh.f.Pm[r * M + j][l];
            }
            spr = margin_of(spr, r, p);
#pragma unroll
            for (int j = 0; j < M; ++j) sh.f.Pp[r * M + j][l] = Ppr[j];
            sh.f.sp[r][l] = spr;
            if (live) {
                S_PLUS[t * vec_step + r * E + lane] = spr;
                if (a.S_PLUS_out)
                    a.S_PLUS_out[((size_t)lane * T + t) * M + r] = spr;
            }
        } else if (adaptive) {
            // the monitor's first half: the innovation's ring and its mean
            pos = t % L;
            cnt = (t + 1 < L) ? (t + 1) : L;
            const double innov = valid ? x_t - sh.f.xp[l] : 0.0;
            sh.f.inn[pos][l] = innov;
            double mu = 0.0;
            for (int j = 0, k = pos; j < L; ++j, k = k ? k - 1 : L - 1)
                mu += sh.f.inn[k][l];
            mu /= cnt;
            sh.f.cov[pos][l] = valid ? (innov - mu) * (innov - mu) : mu * mu;
        }
        __syncthreads();  // P+[t] and s+[t] are in place

        double sp[M];
        if (g < M) {
#pragma unroll
            for (int i = 0; i < M; ++i) sp[i] = sh.f.sp[i][l];
            // the terms of inputs g, g + 6, ... in state_update's drive and
            // state_jacobian's band entry (+0 out of the band)
            for (int k = g; k < P; k += M) {
                double uk = in[k], band = 0.0;
                if (nce::is_nan(uk)) {
                    const double phi = nce::switching(p, sp[5], k);
                    if (nce::in_band(phi, p)) band = nce::band_term(p, k);
                    uk = (phi > 0.0) ? p.u_min[k] : p.u_max[k];
                }
                sh.f.terms[0][k][l] = p.a[k] * (p.u_max[k] - uk);
                sh.f.terms[1][k][l] = band;
            }
        }
        __syncthreads();  // the input terms are in place

        if (g < M) {
            const int r = g;
            // the sums over the inputs in input order; a36 starts at +0 and
            // is never -0, so taking +0 off it for a term out of the band
            // is the library's skipping it, bit for bit
            double drive = 0.0, a36 = 0.0;
            for (int k = 0; k < P; ++k) {
                drive += sh.f.terms[0][k][l];
                a36 -= sh.f.terms[1][k][l];
            }
            nce::state_step(sp, drive, p, s);
            nce::hard_margins(s, p);
            Mat6 A;
            nce::jacobian_at(sp, a36, p, A);
            double Ar[M];
#pragma unroll
            for (int j = 0; j < M; ++j) {
                Ar[j] = A.a[0][j];
#pragma unroll
                for (int i = 1; i < M; ++i) Ar[j] = (r == i) ? A.a[i][j] : Ar[j];
            }
            // row r of A P+, of (A P+) A^T + Q and of P+ A^T
            double tmp[M];
#pragma unroll
            for (int k = 0; k < M; ++k) {
                double acc = 0.0;
#pragma unroll
                for (int j = 0; j < M; ++j) acc += Ar[j] * sh.f.Pp[j * M + k][l];
                tmp[k] = acc;
            }
#pragma unroll
            for (int k = 0; k < M; ++k) {
                double acc = 0.0, pat = 0.0;
#pragma unroll
                for (int j = 0; j < M; ++j) {
                    acc += tmp[j] * A.a[k][j];
                    pat += Ppr[j] * A.a[k][j];
                }
                acc += q[k];
                sh.f.Pm[r * M + k][l] = acc;
                if (live) {
                    PAT[t * mat_step + (r * M + k) * E + lane] = pat;
                    if (t + 1 < T)
                        P_MINUS[(t + 1) * mat_step + (r * M + k) * E + lane] =
                            acc;
                }
            }
            if (live && t + 1 < T)
                S_MINUS[(t + 1) * vec_step + r * E + lane] = pick(s, r);
            if (r == 0) {
                double C[M], xp;
                nce::observe(s, C, xp);
                sh.f.xp[l] = xp;
            }
        } else if (adaptive && valid) {
            // the monitor's second half: the deviations' mean and R
            double rest = 0.0;
            for (int j = 0, k = pos; j < L; ++j, k = k ? k - 1 : L - 1)
                rest += sh.f.cov[k][l];
            rest /= cnt;
            R_mon = a.beta_ekf * R_mon + (1.0 - a.beta_ekf) * rest;
            sh.f.R[l] = R_mon;
        }
    }
    __syncthreads();  // the forward's scratch and shared memory are done

    // ---- backward ----
    double* U = a.U_out + (size_t)lane * T * P;
    // U_OPT_SMOOTH's row t, inputs g, g + 6, ...: the bang-bang fill at the
    // smoothed costate s5 (row T - 1 stays 0)
    auto store_u = [&](int t, double s5) {
        if (!live) return;
        for (int k = g; k < P; k += M)
            U[(size_t)t * P + k] =
                t == T - 1 ? 0.0
                           : nce::bang_bang(a.u[(size_t)t * P + k], s5, p, k);
    };
    auto prefetch_backward = [&](int t) {
        if (g < M) {
            double(*dst)[LANES] = sh.b.in[t & 1];
            cp8(&dst[B_SP + g][l], S_PLUS + t * vec_step + g * E + bl);
            cp8(&dst[B_SM + g][l], S_MINUS + (t + 1) * vec_step + g * E + bl);
#pragma unroll
            for (int j = 0; j < M; ++j) {
                const size_t k = (size_t)(g * M + j) * E + bl;
                cp8(&dst[B_PAT + g * M + j][l], PAT + t * mat_step + k);
                cp8(&dst[B_PM + g * M + j][l],
                    P_MINUS + (t + 1) * mat_step + k);
            }
        }
        cp_commit();
    };
    if (g < M) {
        // the terminal row: S_PLUS[T-1] with the non-NaN entries of s_final
        double v = S_PLUS[(T - 1) * vec_step + g * E + bl];
        if (!nce::is_nan(a.s_final[g])) v = a.s_final[g];
        sh.b.ss[(T - 1) & 1][g][l] = v;
        if (live && a.S_SMOOTH_out)
            a.S_SMOOTH_out[((size_t)lane * T + T - 1) * M + g] = v;
        store_u(T - 1, 0.0);
    }
    if (T >= 2) prefetch_backward(T - 2);

    for (int t = T - 2; t >= 0; --t) {
        // step t's inputs and the smoothed state of step t + 1 are in place
        cp_wait_all();
        __syncthreads();
        const double(*in)[LANES] = sh.b.in[t & 1];
        if (g < M && t + 1 < T - 1) store_u(t + 1, sh.b.ss[(t + 1) & 1][5][l]);
        if (t >= 1) prefetch_backward(t - 1);
        // columns g and 6 + g of the system: rows g of P-[t+1] and P+ A^T
        double Lc[M], Rc[M];
#pragma unroll
        for (int i = 0; i < M; ++i) {
            Lc[i] = g < M ? in[B_PM + g * M + i][l] : 0.0;
            Rc[i] = g < M ? in[B_PAT + g * M + i][l] : 0.0;
        }
#pragma unroll
        for (int col = 0; col < M; ++col) {
            if (g == col) {
                int piv = col;
                double best = fabs(Lc[col]);
#pragma unroll
                for (int r = col + 1; r < M; ++r) {
                    const double v = fabs(Lc[r]);
                    if (v > best) {
                        piv = r;
                        best = v;
                    }
                }
#pragma unroll
                for (int i = 0; i < M; ++i) sh.b.col[col & 1][i][l] = Lc[i];
                sh.b.piv[col & 1][l] = piv;
            }
            __syncthreads();  // the pivot column is in place
            if (g < M) {
                const int piv = sh.b.piv[col & 1][l];
                double cs[M];
#pragma unroll
                for (int i = 0; i < M; ++i) cs[i] = sh.b.col[col & 1][i][l];
                const double c_col = cs[col];
#pragma unroll
                for (int i = col + 1; i < M; ++i) {
                    const double ci = cs[i];
                    cs[col] = (i == piv) ? ci : cs[col];
                    cs[i] = (i == piv) ? c_col : ci;
                }
                double d = cs[col];
                if (d == 0.0) d = 1e-300;
                if (g > col) eliminate(Lc, cs, col, piv, d);
                eliminate(Rc, cs, col, piv, d);
            }
        }
        if (g < M) {
            // entry g of the smoothed state: row g of J is column 6 + g
            double acc = in[B_SP + g][l];
#pragma unroll
            for (int i = 0; i < M; ++i)
                acc += Rc[i] * (sh.b.ss[(t + 1) & 1][i][l] - in[B_SM + i][l]);
            acc = margin_of(acc, g, p);
            sh.b.ss[t & 1][g][l] = acc;
            if (live && a.S_SMOOTH_out)
                a.S_SMOOTH_out[((size_t)lane * T + t) * M + g] = acc;
        }
    }
    __syncthreads();
    if (g < M && T >= 2) store_u(0, sh.b.ss[0][5][l]);
    __syncthreads();  // U_OPT_SMOOTH is in place

    if (live && a.J0) {
        if (g == 0)
            a.J1[lane] = weighted_sum(U, T * P, p.w, P) / (double)(T * P);
        else if (g == MON)
            a.J0[lane] = horizon_j0(U, a, p);
    }
}

int launch(const SweepArgs& a, cudaStream_t stream) {
    if (a.T < 1 || a.E < 1 || a.P < 0 || a.P > nce::MAX_NPI
        || a.inv_monitor_len < 1 || a.inv_monitor_len > MAX_MONITOR
        || (a.J0 && (a.T_hist < 1 || a.T_hist > a.T)))
        return (int)cudaErrorInvalidValue;
    newcase_ekf_kernel<<<(a.E + LANES - 1) / LANES, BLOCK, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The device-pointer entry: every pointer lies on the card; the kernel runs
// on ``stream`` and is not waited for. J0_out and J1_out null skip the
// re-simulation and the costs (sia_hist unread); S_PLUS_out / S_SMOOTH_out
// (E, T, 6) may be null. scratch: T * SCRATCH_PER_LANE_STEP * E doubles. Requires
// 0 <= P <= 64, 1 <= inv_monitor_len <= MAX_MONITOR and, with J0_out,
// 1 <= T_hist <= T. Returns cudaGetLastError() after the launch.
int newcase_ekf_sweep_device(
    const double* u, const double* x, int T, int P, int T_hist,
    double dt, double beta_model, double gamma_model, double b_coef,
    double sigma, double alpha_min, double alpha_max,
    const double* eps_values, int n_eps,
    const double* a_coef, const double* u_min, const double* u_max,
    const double* w,
    const double* s_init, const double* Ps_init,
    const double* s_final, const double* Ps_final,
    const double* Q_in, const double* R_v,
    double beta_ekf, double gamma_ekf, int inv_monitor_len,
    const double* sia_hist, double* scratch,
    double* U_OPT_SMOOTH_out, double* J0_out, double* J1_out,
    double* S_PLUS_out, double* S_SMOOTH_out, void* stream) {
    SweepArgs a{u, x, T, P, T_hist, dt, beta_model, gamma_model, b_coef,
                sigma, alpha_min, alpha_max, eps_values, n_eps, a_coef,
                u_min, u_max, w, s_init, Ps_init, s_final, Ps_final, Q_in,
                R_v, beta_ekf, gamma_ekf, inv_monitor_len, sia_hist, scratch,
                U_OPT_SMOOTH_out, J0_out, J1_out, S_PLUS_out, S_SMOOTH_out};
    return launch(a, static_cast<cudaStream_t>(stream));
}

const char* newcase_ekf_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
