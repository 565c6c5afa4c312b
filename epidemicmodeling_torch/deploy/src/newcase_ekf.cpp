// The CPU build of the port's native deployment artefact: the pre-generic
// 6-state optimal-NPI EKF/EKS (Tools/NewCaseEKFEstimatorWithOptimalNPI.m)
// and its threaded Pareto epsilon sweep, behind the C interface of the JAX
// package's library (epidemicmodeling_tpu/deploy/src/newcase_ekf.cpp: the
// same two entry points, the same argument lists). It is the accelerator-
// free serving build, the counterpart of the reference's MATLAB Coder C++
// project (SURVEY.md 2.9); the card build of the same interface is
// csrc/newcase_ekf.cu. The per-lane arithmetic is csrc/newcase_ekf.cuh,
// shared by both builds, so this library equals the JAX package's bit for
// bit when built with the same flags (g++ -O3 -std=c++17 -shared -fPIC
// -pthread).
//
// Layouts: time-major row-major. u: T x P; x: T; outputs T x 6 / T x P.

#include <atomic>
#include <thread>
#include <vector>

#include "../../csrc/newcase_ekf.cuh"

using nce::M;
using nce::Mat6;
using nce::Params;

extern "C" {

// Returns 0 on success.
int newcase_ekf_optimal_npi(
    const double* u, const double* x, int T, int P,
    double dt, double beta_model, double gamma_model, double b_coef,
    double epsilon, double sigma, double alpha_min, double alpha_max,
    const double* a_coef, const double* u_min, const double* u_max,
    const double* w,
    const double* s_init, const double* Ps_init,
    const double* s_final, const double* Ps_final,
    const double* Q_in, const double* R_v,
    double beta_ekf, double gamma_ekf, int inv_monitor_len,
    double* S_PLUS_out, double* S_SMOOTH_out, double* U_OPT_SMOOTH_out) {
    Params p{dt, beta_model, gamma_model, b_coef, epsilon, sigma,
             alpha_min, alpha_max, a_coef, u_min, u_max, w, P};

    std::vector<double> S_MINUS(T * M), S_PLUS(T * M);
    std::vector<Mat6> P_MINUS(T), P_PLUS(T);
    Mat6 Q;
    nce::load_mat(Q_in, Q);

    double sk_minus[M];
    for (int i = 0; i < M; ++i) sk_minus[i] = s_init[i];
    Mat6 Pk_minus;
    nce::load_mat(Ps_init, Pk_minus);

    std::vector<double> inn_buf(inv_monitor_len, 0.0);
    std::vector<double> cov_buf(inv_monitor_len, 0.0);
    nce::Monitor mon{inn_buf.data(), cov_buf.data(), inv_monitor_len};
    double R = R_v[0];

    for (int t = 0; t < T; ++t) {
        for (int i = 0; i < M; ++i) S_MINUS[t * M + i] = sk_minus[i];
        P_MINUS[t] = Pk_minus;
        double sk_plus[M];
        Mat6 Pk_plus;
        nce::forward_step(t, &u[t * P], x[t], R_v[t], p, Q, beta_ekf,
                          gamma_ekf, mon, R, sk_minus, Pk_minus, sk_plus,
                          Pk_plus);
        for (int i = 0; i < M; ++i) S_PLUS[t * M + i] = sk_plus[i];
        P_PLUS[t] = Pk_plus;
    }

    // backward smoother; the last row of U_OPT_SMOOTH stays 0
    std::vector<double> U_SM(T * P, 0.0);
    double s_sm[M];
    Mat6 P_sm;
    nce::backward_init(&S_PLUS[(T - 1) * M], P_PLUS[T - 1], s_final,
                       Ps_final, s_sm, P_sm);
    for (int i = 0; i < M; ++i) S_SMOOTH_out[(T - 1) * M + i] = s_sm[i];
    for (int t = T - 2; t >= 0; --t) {
        nce::backward_step(&u[t * P], &S_PLUS[t * M], P_PLUS[t],
                           &S_MINUS[(t + 1) * M], P_MINUS[t + 1], p, s_sm,
                           P_sm, &U_SM[t * P]);
        for (int i = 0; i < M; ++i) S_SMOOTH_out[t * M + i] = s_sm[i];
    }

    for (int i = 0; i < T * M; ++i) S_PLUS_out[i] = S_PLUS[i];
    for (int i = 0; i < T * P; ++i) U_OPT_SMOOTH_out[i] = U_SM[i];
    return 0;
}

// Full Pareto epsilon sweep for ONE region, threaded across epsilon values
// (the serving-side equivalent of testScripts/testPrescribeXPRIZE01.m
// :160-240: per epsilon run the opt-controlled EKF/EKS, re-simulate the
// horizon with SIalpha_Controlled from the historic endpoint, score with
// NPICost). sia_hist: T_hist x 3 historic (s, i, alpha) trajectory;
// the prescribed window is rows T_hist..T-1 of u (NaN on input).
// Outputs: U_OPT_SMOOTH_out (n_eps x T x P), J0_out/J1_out (n_eps).
// Returns 1 when T_hist is not in [1, T].
int newcase_ekf_pareto_sweep(
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
    const double* sia_hist, int n_threads,
    double* U_OPT_SMOOTH_out, double* J0_out, double* J1_out) {
    if (T_hist < 1 || T_hist > T) return 1;
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    if (n_threads > n_eps) n_threads = n_eps;

    std::atomic<int> next_idx{0};
    std::atomic<int> status{0};

    auto worker = [&]() {
        std::vector<double> S_PLUS(T * M), S_SMOOTH(T * M);
        for (;;) {
            int ll = next_idx.fetch_add(1);
            if (ll >= n_eps) break;
            double* u_out = U_OPT_SMOOTH_out + (size_t)ll * T * P;
            int rc = newcase_ekf_optimal_npi(
                u, x, T, P, dt, beta_model, gamma_model, b_coef,
                eps_values[ll], sigma, alpha_min, alpha_max,
                a_coef, u_min, u_max, w, s_init, Ps_init, s_final,
                Ps_final, Q_in, R_v, beta_ekf, gamma_ekf,
                inv_monitor_len, S_PLUS.data(), S_SMOOTH.data(), u_out);
            if (rc != 0) { status.store(rc); continue; }
            nce::horizon_costs(u_out, sia_hist, T, P, T_hist, dt,
                               beta_model, gamma_model, b_coef, alpha_min,
                               alpha_max, a_coef, u_max, w, &J0_out[ll],
                               &J1_out[ll]);
        }
    };

    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return status.load();
}

}  // extern "C"
