// The per-lane arithmetic of the pre-generic 6-state optimal-NPI EKF/EKS
// (Tools/NewCaseEKFEstimatorWithOptimalNPI.m), shared by the two builds of
// the port's native deployment artefact:
// - deploy/src/newcase_ekf.cpp, the CPU library (g++), the counterpart of
//   epidemicmodeling_tpu/deploy/src/newcase_ekf.cpp;
// - csrc/newcase_ekf.cu, the card library (nvcc, sm_90a), a team of threads
//   a lane, which calls the pieces below (observe, switching, bang_bang,
//   in_band, band_term, state_step, jacobian_at, margin_unit, margin_alpha,
//   resim_step) where it spreads a step over its team or batches its
//   loads.
//
// Every function is the JAX package's library's code (newcase_ekf.cpp:25-173
// for the helpers, :179-340 for the two passes) in the same operation order:
// the simple covariance update (I - K C) P- / gamma with no Joseph form and
// no symmetrization; R adapted on every valid step over the innovation
// monitor (shifted, then summed from j = 0 upward); the bang-bang fill; the
// sigma-band Jacobian term; a Gaussian-elimination mrdivide smoother gain
// with d == 0 -> 1e-300 in the pivot; the same NaN branches of clip and
// hard_margins. The CPU build then equals the JAX package's library bit for
// bit, and the card build (compiled with --fmad=false, IEEE division) equals
// the CPU build. A NaN test is v != v, the same predicate as std::isnan
// without a libm call that device code lacks; copies are element loops.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define NCE_FN __host__ __device__ inline
#else
#define NCE_FN inline
#endif

namespace nce {

constexpr int M = 6;         // state dim
constexpr int MAX_NPI = 64;  // the reference library's u_opt[64]

struct Mat6 {
    double a[M][M];
};

NCE_FN bool is_nan(double v) { return v != v; }

NCE_FN void zero(Mat6& X) {
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) X.a[i][j] = 0.0;
}

NCE_FN void load_mat(const double* src, Mat6& X) {  // row-major 6 x 6
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) X.a[i][j] = src[i * M + j];
}

NCE_FN void matmul(const Mat6& A, const Mat6& B, Mat6& C) {
    for (int i = 0; i < M; ++i)
        for (int k = 0; k < M; ++k) {
            double s = 0.0;
            for (int j = 0; j < M; ++j) s += A.a[i][j] * B.a[j][k];
            C.a[i][k] = s;
        }
}

NCE_FN void matmul_T(const Mat6& A, const Mat6& B, Mat6& C) {  // A * B^T
    for (int i = 0; i < M; ++i)
        for (int k = 0; k < M; ++k) {
            double s = 0.0;
            for (int j = 0; j < M; ++j) s += A.a[i][j] * B.a[k][j];
            C.a[i][k] = s;
        }
}

// Solve X * A = B  (MATLAB B/A) via Gaussian elimination with partial
// pivoting on A^T X^T = B^T.
NCE_FN void mrdivide(const Mat6& B, const Mat6& A, Mat6& X) {
    double aug[M][2 * M];
    for (int i = 0; i < M; ++i) {
        for (int j = 0; j < M; ++j) {
            aug[i][j] = A.a[j][i];        // A^T
            aug[i][M + j] = B.a[j][i];    // B^T columns as RHS
        }
    }
    for (int col = 0; col < M; ++col) {
        int piv = col;
        for (int r = col + 1; r < M; ++r)
            if (fabs(aug[r][col]) > fabs(aug[piv][col])) piv = r;
        if (piv != col)
            for (int j = 0; j < 2 * M; ++j) {
                double t = aug[col][j];
                aug[col][j] = aug[piv][j];
                aug[piv][j] = t;
            }
        double d = aug[col][col];
        if (d == 0.0) d = 1e-300;
        for (int j = 0; j < 2 * M; ++j) aug[col][j] /= d;
        for (int r = 0; r < M; ++r) {
            if (r == col) continue;
            double f = aug[r][col];
            if (f != 0.0)
                for (int j = 0; j < 2 * M; ++j) aug[r][j] -= f * aug[col][j];
        }
    }
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) X.a[j][i] = aug[i][M + j];  // (X^T)^T
}

NCE_FN double clip(double v, double lo, double hi) {
    // MATLAB max(lo, min(hi, v)) NaN semantics: NaN -> hi branch first
    double t = (v < hi) ? v : hi;      // min(hi, v): NaN -> hi
    if (is_nan(v)) t = hi;
    double r = (t > lo) ? t : lo;      // max(lo, .)
    return r;
}

struct Params {
    double dt, beta, gamma, b, epsilon, sigma, alpha_min, alpha_max;
    const double* a;      // P
    const double* u_min;  // P
    const double* u_max;  // P
    const double* w;      // P
    int P;
};

// The switching function of input k at costate s5.
NCE_FN double switching(const Params& p, double s5, int k) {
    return p.epsilon * p.w[k] - p.gamma * s5 * p.a[k];
}

// Input k with a NaN filled by the bang-bang law at costate s5.
NCE_FN double bang_bang(double uk, double s5, const Params& p, int k) {
    if (is_nan(uk)) {
        double phi = switching(p, s5, k);
        uk = (phi > 0.0) ? p.u_min[k] : p.u_max[k];
    }
    return uk;
}

// The Euler step of the SI-alpha/costate model, given the drive of alpha.
NCE_FN void state_step(const double* s, double drive_u, const Params& p,
                       double* s_next) {
    const double dt = p.dt;
    double rho = s[3] - s[4] - (1.0 - p.epsilon);
    s_next[0] = clip(s[0] - dt * s[2] * s[0] * s[1], 0.0, 1.0);
    s_next[1] = clip(s[1] + dt * (s[2] * s[0] * s[1] - p.beta * s[1]),
                     0.0, 1.0);
    s_next[2] = clip(s[2] + dt * (-p.gamma * s[2] + p.gamma * p.b
                                  + p.gamma * drive_u),
                     p.alpha_min, p.alpha_max);
    s_next[3] = s[3] + dt * rho * s[2] * s[1];
    s_next[4] = s[4] + dt * (rho * s[2] * s[0] + p.beta * s[4]);
    s_next[5] = s[5] + dt * (rho * s[0] * s[1] + p.gamma * s[5]);
}

// Bang-bang fill + state update (SIAlphaModelEKFOptControlled.m:39-74)
NCE_FN void state_update(const double* u_in, const double* s, const Params& p,
                         double* u_out, double* s_next) {
    double drive_u = 0.0;
    for (int k = 0; k < p.P; ++k) {
        double uk = bang_bang(u_in[k], s[5], p, k);
        u_out[k] = uk;
        drive_u += p.a[k] * (p.u_max[k] - uk);
    }
    state_step(s, drive_u, p, s_next);
}

// Whether a switching value lies in the sigma band, and input k's term of
// the band's Jacobian entry A[2][5].
NCE_FN bool in_band(double phi, const Params& p) {
    return phi > -1.0 / p.sigma && phi < 1.0 / p.sigma;
}

NCE_FN double band_term(const Params& p, int k) {
    return p.gamma * p.dt * (p.sigma / 2.0) * p.a[k]
           * (p.u_max[k] - p.u_min[k]);
}

// The Jacobian at s, its band entry A[2][5] = a36 given.
NCE_FN void jacobian_at(const double* s, double a36, const Params& p,
                        Mat6& A) {
    const double dt = p.dt;
    zero(A);
    A.a[0][0] = 1.0 - dt * s[2] * s[1];
    A.a[0][1] = -dt * s[2] * s[0];
    A.a[0][2] = -dt * s[0] * s[1];
    A.a[1][0] = dt * s[1] * s[2];
    A.a[1][1] = 1.0 + dt * (s[0] * s[2] - p.beta);
    A.a[1][2] = dt * s[0] * s[1];
    A.a[2][2] = 1.0 - dt * p.gamma;
    A.a[2][5] = a36;
    double rho = s[3] - s[4] - (1.0 - p.epsilon);
    A.a[3][1] = dt * s[2] * rho;
    A.a[3][2] = dt * s[1] * rho;
    A.a[3][3] = 1.0 + dt * s[1] * s[2];
    A.a[3][4] = -dt * s[1] * s[2];
    A.a[4][0] = dt * s[2] * rho;
    A.a[4][2] = dt * s[0] * rho;
    A.a[4][3] = dt * s[0] * s[2];
    A.a[4][4] = 1.0 - dt * (s[0] * s[2] - p.beta);
    A.a[5][0] = dt * s[1] * rho;
    A.a[5][1] = dt * s[0] * rho;
    A.a[5][3] = dt * s[0] * s[1];
    A.a[5][4] = -dt * s[0] * s[1];
    A.a[5][5] = 1.0 + dt * p.gamma;
}

NCE_FN void state_jacobian(const double* u_in, const double* s,
                           const Params& p, Mat6& A) {
    double a36 = 0.0;
    for (int k = 0; k < p.P; ++k) {
        if (is_nan(u_in[k])) {
            double phi = switching(p, s[5], k);
            if (in_band(phi, p)) a36 -= band_term(p, k);
        }
    }
    jacobian_at(s, a36, p, A);
}

// min(1, max(0, v)) — NaN -> 0 branch (clip_hi_lo order)
NCE_FN double margin_unit(double v) {
    double m = (v > 0.0) ? v : 0.0;   // max(0, v): NaN -> 0
    if (is_nan(v)) m = 0.0;
    return (m < 1.0) ? m : 1.0;
}

NCE_FN double margin_alpha(double v, const Params& p) {
    double m = (v > p.alpha_min) ? v : p.alpha_min;
    if (is_nan(v)) m = p.alpha_min;
    return (m < p.alpha_max) ? m : p.alpha_max;
}

NCE_FN void hard_margins(double* s, const Params& p) {
    s[0] = margin_unit(s[0]);
    s[1] = margin_unit(s[1]);
    s[2] = margin_alpha(s[2], p);
}

// The observation x = s i alpha at s, clipped below at 0 (NaN -> 0), and its
// row C = d(obs)/ds.
NCE_FN void observe(const double* s, double* C, double& x_pred) {
    C[0] = s[1] * s[2];
    C[1] = s[0] * s[2];
    C[2] = s[0] * s[1];
    C[3] = C[4] = C[5] = 0.0;
    x_pred = s[0] * s[1] * s[2];
    if (x_pred < 0.0 || is_nan(x_pred)) x_pred = 0.0;  // obs margin
}

// The innovation monitor: the last len innovations and their squared
// deviations, newest first, zeroed before step 0.
struct Monitor {
    double* inn;
    double* cov;
    int len;
};

// Step t of the forward filter. On entry sk_minus / Pk_minus hold the prior
// at t (the caller has stored them as S_MINUS[t] / P_MINUS[t]); on return
// sk_plus / Pk_plus hold the filtered state at t and sk_minus / Pk_minus
// the prior at t + 1. R carries the adapted noise from step to step.
NCE_FN void forward_step(int t, const double* u_t, double x_t, double R_t,
                         const Params& p, const Mat6& Q, double beta_ekf,
                         double gamma_ekf, Monitor mon, double& R,
                         double* sk_minus, Mat6& Pk_minus, double* sk_plus,
                         Mat6& Pk_plus) {
    const bool adaptive = (beta_ekf != 1.0);
    const int L = mon.len;
    if (!adaptive) R = R_t;

    double C[M], x_pred;
    observe(sk_minus, C, x_pred);

    double K[M] = {0, 0, 0, 0, 0, 0};
    bool valid = !is_nan(x_t);
    if (valid) {
        double PCt[M];
        for (int i = 0; i < M; ++i) {
            double s = 0.0;
            for (int j = 0; j < M; ++j) s += Pk_minus.a[i][j] * C[j];
            PCt[i] = s;
        }
        double S = gamma_ekf * R;
        for (int i = 0; i < M; ++i) S += C[i] * PCt[i];
        double innov = x_t - x_pred;
        for (int i = 0; i < M; ++i) K[i] = PCt[i] / S;
        // Pk_plus = (I - K C) Pk_minus / gamma  (simple form, :58)
        for (int i = 0; i < M; ++i)
            for (int j = 0; j < M; ++j) {
                double ikc = 0.0;
                for (int k2 = 0; k2 < M; ++k2) {
                    double v = ((i == k2) ? 1.0 : 0.0) - K[i] * C[k2];
                    ikc += v * Pk_minus.a[k2][j];
                }
                Pk_plus.a[i][j] = ikc / gamma_ekf;
            }
        for (int i = 0; i < M; ++i)
            sk_plus[i] = sk_minus[i] + K[i] * innov;
        // innovation monitor + adaptive R
        int cnt = (t + 1 < L) ? (t + 1) : L;
        for (int j = L - 1; j > 0; --j) mon.inn[j] = mon.inn[j - 1];
        mon.inn[0] = innov;
        double mu = 0.0;
        for (int j = 0; j < L; ++j) mu += mon.inn[j];
        mu /= cnt;
        double cc = (innov - mu) * (innov - mu);
        for (int j = L - 1; j > 0; --j) mon.cov[j] = mon.cov[j - 1];
        mon.cov[0] = cc;
        if (adaptive) {
            double rest = 0.0;
            for (int j = 0; j < L; ++j) rest += mon.cov[j];
            rest /= cnt;
            R = beta_ekf * R + (1.0 - beta_ekf) * rest;
        }
    } else {
        Pk_plus = Pk_minus;
        for (int i = 0; i < M; ++i) sk_plus[i] = sk_minus[i];
        for (int j = L - 1; j > 0; --j) {
            mon.inn[j] = mon.inn[j - 1];
            mon.cov[j] = mon.cov[j - 1];
        }
        mon.inn[0] = 0.0;
        int cnt = (t + 1 < L) ? (t + 1) : L;
        double mu = 0.0;
        for (int j = 0; j < L; ++j) mu += mon.inn[j];
        mu /= cnt;
        mon.cov[0] = mu * mu;
    }
    hard_margins(sk_plus, p);

    // prediction
    double u_opt[MAX_NPI];
    state_update(u_t, sk_plus, p, u_opt, sk_minus);
    Mat6 A, tmp;
    state_jacobian(u_t, sk_plus, p, A);
    matmul(A, Pk_plus, tmp);
    matmul_T(tmp, A, Pk_minus);
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) Pk_minus.a[i][j] += Q.a[i][j];
    hard_margins(sk_minus, p);
}

// The smoother's last step: S_PLUS[T-1] / P_PLUS[T-1] with the non-NaN
// entries of s_final / Ps_final written over them.
NCE_FN void backward_init(const double* s_plus_last, const Mat6& P_plus_last,
                          const double* s_final, const double* Ps_final,
                          double* s_smooth, Mat6& P_smooth) {
    for (int i = 0; i < M; ++i) {
        double v = s_plus_last[i];
        if (!is_nan(s_final[i])) v = s_final[i];
        s_smooth[i] = v;
    }
    P_smooth = P_plus_last;
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j)
            if (!is_nan(Ps_final[i * M + j]))
                P_smooth.a[i][j] = Ps_final[i * M + j];
}

// Step t (T-2 down to 0) of the backward smoother
// (NewCaseEKFEstimatorWithOptimalNPI.m:117-139). On entry s_smooth /
// P_smooth hold the smoothed state at t + 1, on return at t; u_sm_t gets
// the bang-bang inputs of the smoothed state at t.
NCE_FN void backward_step(const double* u_t, const double* s_plus_t,
                          const Mat6& P_plus_t, const double* s_minus_next,
                          const Mat6& P_minus_next, const Params& p,
                          double* s_smooth, Mat6& P_smooth, double* u_sm_t) {
    Mat6 A, PAt, J, tmp;
    state_jacobian(u_t, s_plus_t, p, A);
    matmul_T(P_plus_t, A, PAt);
    mrdivide(PAt, P_minus_next, J);
    double diff[M];
    for (int i = 0; i < M; ++i) diff[i] = s_smooth[i] - s_minus_next[i];
    double s_sm[M];
    for (int i = 0; i < M; ++i) {
        double s = s_plus_t[i];
        for (int j = 0; j < M; ++j) s += J.a[i][j] * diff[j];
        s_sm[i] = s;
    }
    hard_margins(s_sm, p);
    for (int i = 0; i < M; ++i) s_smooth[i] = s_sm[i];
    Mat6 Pd;
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j)
            Pd.a[i][j] = P_minus_next.a[i][j] - P_smooth.a[i][j];
    matmul(J, Pd, tmp);
    matmul_T(tmp, J, Pd);
    for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j)
            P_smooth.a[i][j] = P_plus_t.a[i][j] - Pd.a[i][j];
    double s_next_dummy[M];
    state_update(u_t, s_sm, p, u_sm_t, s_next_dummy);
}

// One noise-free Euler step of (s, i, alpha) under the drive drive_u
// (SIalpha_Controlled), in place.
NCE_FN void resim_step(double drive_u, double dt, double beta_model,
                       double gamma_model, double b_coef, double alpha_min,
                       double alpha_max, double& sc, double& ic, double& al) {
    double s1 = clip(sc - dt * al * sc * ic, 0.0, 1.0);
    double i1 = clip(ic + dt * (al * sc * ic - beta_model * ic), 0.0, 1.0);
    double a1 = clip(al + dt * (-gamma_model * al + gamma_model * b_coef
                                + gamma_model * drive_u),
                     alpha_min, alpha_max);
    sc = s1; ic = i1; al = a1;
}

// One epsilon lane's score (the JAX package's newcase_ekf.cpp:382-425):
// re-simulate the horizon rows T_hist..T-1 noise-free from the historic
// endpoint under the prescribed inputs u_out (T x P; SIalpha_Controlled
// semantics: Euler, outputs drop the initial condition), then NPICost
// (Tools/NPICost.m:5-10): J0 = mean(newcases) over all T days,
// J1 = mean over all (day, npi) entries of weights .* inputs.
NCE_FN void horizon_costs(const double* u_out, const double* sia_hist,
                          int T, int P, int T_hist, double dt,
                          double beta_model, double gamma_model,
                          double b_coef, double alpha_min, double alpha_max,
                          const double* a_coef, const double* u_max,
                          const double* w, double* J0, double* J1) {
    const int H = T - T_hist;
    double sc = sia_hist[(T_hist - 1) * 3 + 0];
    double ic = sia_hist[(T_hist - 1) * 3 + 1];
    double al = sia_hist[(T_hist - 1) * 3 + 2];
    double sum_cases = 0.0;
    for (int t = 0; t < T_hist; ++t)
        sum_cases += sia_hist[t * 3 + 0] * sia_hist[t * 3 + 1]
                     * sia_hist[t * 3 + 2];
    for (int t = 0; t < H; ++t) {
        const double* u_t = u_out + (size_t)(T_hist + t) * P;
        double drive_u = 0.0;
        for (int k = 0; k < P; ++k)
            drive_u += a_coef[k] * (u_max[k] - u_t[k]);
        resim_step(drive_u, dt, beta_model, gamma_model, b_coef, alpha_min,
                   alpha_max, sc, ic, al);
        sum_cases += sc * ic * al;
    }
    *J0 = sum_cases / (double)T;
    double sum_wu = 0.0;
    for (int t = 0; t < T; ++t)
        for (int k = 0; k < P; ++k)
            sum_wu += w[k] * u_out[(size_t)t * P + k];
    *J1 = sum_wu / (double)(T * P);
}

}  // namespace nce
