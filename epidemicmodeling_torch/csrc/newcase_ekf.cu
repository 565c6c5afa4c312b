// The card build of the port's native deployment artefact (sm_90a): the
// pre-generic 6-state optimal-NPI EKF/EKS and its Pareto epsilon sweep for
// one region, behind a plain C interface driven through the CUDA runtime
// alone (no framework). It is not the port of a TPU kernel: the JAX
// package ships this artefact as a CPU library
// (epidemicmodeling_tpu/deploy/src/newcase_ekf.cpp:179 newcase_ekf_optimal_npi,
// :352 newcase_ekf_pareto_sweep), and the port runs it on the card unless
// the caller asks for the CPU build (deploy/src/newcase_ekf.cpp).
//
// What it computes: per epsilon lane the forward filter and the smoother of
// newcase_ekf.cuh (the JAX library's arithmetic in its operation order),
// then, in the same thread, the noise-free re-simulation of the horizon
// from the historic endpoint and NPICost's (J0, J1). This file is compiled
// with --fmad=false (ops/cuda/build.py) and keeps IEEE division, so a lane
// equals the CPU build's bit for bit: the prescriptions are bang-bang, and
// a one-ulp difference on the switching surface would flip a cell.
//
// Layout: one thread a lane, BLOCK lanes a block. The covariances are not
// symmetric in this estimator, so all 36 entries of P- and P+ are kept for
// the smoother, in a per-call device scratch, lanes last ((T, 36, E) and
// (T, 6, E) for s- and s+), so that a warp's stores are coalesced. U_OPT
// (E, T, P) and the optional S_PLUS / S_SMOOTH (E, T, 6) keep the C
// interface's lane-major layout. The inputs u, x, R_v and the parameters
// are the same for every lane (broadcast loads).
//
// What bounds it on the card: the function, by the float64 operations it
// needs (~2.4k a lane-step, 0.076 ms for 2,000 lanes x T = 532 at
// 34 TFLOP/s; this code does ~4.3k, its 6 x 6 products dense and I - K C
// formed inside the product: chip_smoke.newcase_ops and
// newcase_ops_as_written), its inputs and outputs coming after (0.03 ms);
// this design, by its own scratch traffic (1.4 kB a lane-step written once
// and read once, 0.43 ms at 3.35 TB/s). In fact
// each lane is a chain of T dependent forward steps and T backward steps
// in one thread, ~1k and ~2.4k operations each with IEEE divisions, its
// 6x6 matrices, monitor and u_opt[64] partly in local memory, and 2,000
// lanes fill 63 of 132 SMs with one warp each: latency sets the time. A
// team of threads a lane (as csrc/ekf6.cu has) is the design that would
// spread the chain.

#include <cuda_runtime.h>

#include <cstddef>

#include "newcase_ekf.cuh"

namespace {

using nce::M;
using nce::Mat6;
using nce::Params;

constexpr int BLOCK = 32;         // lanes (threads) a block
constexpr int MAX_MONITOR = 64;   // longest innovation monitor a lane keeps
// doubles of device scratch a lane and step: S_MINUS, S_PLUS (6 each),
// P_MINUS, P_PLUS (36 each)
constexpr int SCRATCH_PER_LANE_STEP = 2 * M + 2 * M * M;

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

__device__ void load_col(const double* base, size_t stride, int n,
                         double* v) {
    for (int k = 0; k < n; ++k) v[k] = base[k * stride];
}

__device__ void store_col(double* base, size_t stride, int n,
                          const double* v) {
    for (int k = 0; k < n; ++k) base[k * stride] = v[k];
}

__global__ void __launch_bounds__(BLOCK) newcase_ekf_kernel(const SweepArgs a) {
    const int l = blockIdx.x * BLOCK + threadIdx.x;
    if (l >= a.E) return;
    const int T = a.T, P = a.P;
    const size_t E = a.E;
    // lanes-last scratch: element k of step t at ((t * n + k) * E + l)
    double* S_MINUS = a.scratch + l;
    double* S_PLUS = S_MINUS + (size_t)T * M * E;
    double* P_MINUS = S_PLUS + (size_t)T * M * E;
    double* P_PLUS = P_MINUS + (size_t)T * M * M * E;
    const size_t vec_step = (size_t)M * E, mat_step = (size_t)M * M * E;

    Params p{a.dt, a.beta_model, a.gamma_model, a.b_coef, a.eps[l], a.sigma,
             a.alpha_min, a.alpha_max, a.a, a.u_min, a.u_max, a.w, P};
    Mat6 Q;
    nce::load_mat(a.Q, Q);
    double sk_minus[M];
    for (int i = 0; i < M; ++i) sk_minus[i] = a.s_init[i];
    Mat6 Pk_minus;
    nce::load_mat(a.Ps_init, Pk_minus);
    double inn_buf[MAX_MONITOR], cov_buf[MAX_MONITOR];
    for (int j = 0; j < a.inv_monitor_len; ++j) inn_buf[j] = cov_buf[j] = 0.0;
    nce::Monitor mon{inn_buf, cov_buf, a.inv_monitor_len};
    double R = a.R_v[0];

    for (int t = 0; t < T; ++t) {
        store_col(S_MINUS + t * vec_step, E, M, sk_minus);
        store_col(P_MINUS + t * mat_step, E, M * M, &Pk_minus.a[0][0]);
        double sk_plus[M];
        Mat6 Pk_plus;
        nce::forward_step(t, a.u + (size_t)t * P, a.x[t], a.R_v[t], p, Q,
                          a.beta_ekf, a.gamma_ekf, mon, R, sk_minus,
                          Pk_minus, sk_plus, Pk_plus);
        store_col(S_PLUS + t * vec_step, E, M, sk_plus);
        store_col(P_PLUS + t * mat_step, E, M * M, &Pk_plus.a[0][0]);
        if (a.S_PLUS_out)
            for (int i = 0; i < M; ++i)
                a.S_PLUS_out[((size_t)l * T + t) * M + i] = sk_plus[i];
    }

    double* U = a.U_out + (size_t)l * T * P;
    double s_sm[M], s_plus_t[M], s_minus_next[M];
    Mat6 P_sm, P_plus_t, P_minus_next;
    load_col(S_PLUS + (T - 1) * vec_step, E, M, s_plus_t);
    load_col(P_PLUS + (T - 1) * mat_step, E, M * M, &P_plus_t.a[0][0]);
    nce::backward_init(s_plus_t, P_plus_t, a.s_final, a.Ps_final, s_sm, P_sm);
    for (int k = 0; k < P; ++k) U[(size_t)(T - 1) * P + k] = 0.0;
    if (a.S_SMOOTH_out)
        for (int i = 0; i < M; ++i)
            a.S_SMOOTH_out[((size_t)l * T + T - 1) * M + i] = s_sm[i];
    for (int t = T - 2; t >= 0; --t) {
        load_col(S_PLUS + t * vec_step, E, M, s_plus_t);
        load_col(P_PLUS + t * mat_step, E, M * M, &P_plus_t.a[0][0]);
        load_col(S_MINUS + (t + 1) * vec_step, E, M, s_minus_next);
        load_col(P_MINUS + (t + 1) * mat_step, E, M * M,
                 &P_minus_next.a[0][0]);
        nce::backward_step(a.u + (size_t)t * P, s_plus_t, P_plus_t,
                           s_minus_next, P_minus_next, p, s_sm, P_sm,
                           U + (size_t)t * P);
        if (a.S_SMOOTH_out)
            for (int i = 0; i < M; ++i)
                a.S_SMOOTH_out[((size_t)l * T + t) * M + i] = s_sm[i];
    }

    if (a.J0)
        nce::horizon_costs(U, a.sia_hist, T, P, a.T_hist, a.dt,
                           a.beta_model, a.gamma_model, a.b_coef,
                           a.alpha_min, a.alpha_max, a.a, a.u_max, a.w,
                           &a.J0[l], &a.J1[l]);
}

int launch(const SweepArgs& a, cudaStream_t stream) {
    if (a.T < 1 || a.E < 1 || a.P < 0 || a.P > nce::MAX_NPI
        || a.inv_monitor_len < 1 || a.inv_monitor_len > MAX_MONITOR
        || (a.J0 && (a.T_hist < 1 || a.T_hist > a.T)))
        return (int)cudaErrorInvalidValue;
    newcase_ekf_kernel<<<(a.E + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// The host-pointer entries: copy the inputs into one device buffer, launch
// on the default stream, copy the outputs back and free.
struct DeviceBuffer {
    double* base = nullptr;
    size_t used = 0;
    ~DeviceBuffer() {
        if (base) cudaFree(base);
    }
    double* take(size_t n) {
        double* p = base + used;
        used += n;
        return p;
    }
};

int put(DeviceBuffer& buf, const double* host, size_t n, const double** dev) {
    double* d = buf.take(n);
    *dev = d;
    return (int)cudaMemcpy(d, host, n * sizeof(double),
                           cudaMemcpyHostToDevice);
}

// J0_host null: the single-epsilon entry (no history, no costs; the states
// copied out instead).
int run_host(SweepArgs a, const double* const* host_inputs,
             double* U_host, double* J0_host, double* J1_host,
             double* S_PLUS_host, double* S_SMOOTH_host) {
    if (a.T < 1 || a.E < 1 || a.P < 0 || a.P > nce::MAX_NPI
        || (J0_host && (a.T_hist < 1 || a.T_hist > a.T)))
        return (int)cudaErrorInvalidValue;
    const size_t T = a.T, P = a.P, E = a.E, H3 = J0_host ? 3 * a.T_hist : 0;
    const size_t sizes[] = {T * P, T, E, P, P, P, P, M, M * M, M, M * M,
                            M * M, T, H3};
    const double** fields[] = {&a.u, &a.x, &a.eps, &a.a, &a.u_min, &a.u_max,
                               &a.w, &a.s_init, &a.Ps_init, &a.s_final,
                               &a.Ps_final, &a.Q, &a.R_v, &a.sia_hist};
    const int n_in = sizeof(sizes) / sizeof(sizes[0]);
    size_t total = 0;
    for (int i = 0; i < n_in; ++i) total += sizes[i];
    const size_t n_out = E * T * P + 2 * E
                         + (S_PLUS_host ? 2 * E * T * M : 0);
    total += n_out + T * SCRATCH_PER_LANE_STEP * E;
    DeviceBuffer buf;
    int rc = (int)cudaMalloc(&buf.base, total * sizeof(double));
    if (rc) return rc;
    for (int i = 0; i < n_in; ++i) {
        if (sizes[i] == 0) continue;
        if ((rc = put(buf, host_inputs[i], sizes[i], fields[i]))) return rc;
    }
    a.U_out = buf.take(E * T * P);
    a.J0 = J0_host ? buf.take(E) : nullptr;
    a.J1 = J0_host ? buf.take(E) : nullptr;
    a.S_PLUS_out = S_PLUS_host ? buf.take(E * T * M) : nullptr;
    a.S_SMOOTH_out = S_PLUS_host ? buf.take(E * T * M) : nullptr;
    a.scratch = buf.take(T * SCRATCH_PER_LANE_STEP * E);
    if ((rc = launch(a, 0))) return rc;
    const size_t bytes = sizeof(double);
    if ((rc = (int)cudaMemcpy(U_host, a.U_out, E * T * P * bytes,
                              cudaMemcpyDeviceToHost)))
        return rc;
    if (J0_host) {
        if ((rc = (int)cudaMemcpy(J0_host, a.J0, E * bytes,
                                  cudaMemcpyDeviceToHost)))
            return rc;
        if ((rc = (int)cudaMemcpy(J1_host, a.J1, E * bytes,
                                  cudaMemcpyDeviceToHost)))
            return rc;
    }
    if (S_PLUS_host) {
        if ((rc = (int)cudaMemcpy(S_PLUS_host, a.S_PLUS_out,
                                  E * T * M * bytes, cudaMemcpyDeviceToHost)))
            return rc;
        if ((rc = (int)cudaMemcpy(S_SMOOTH_host, a.S_SMOOTH_out,
                                  E * T * M * bytes, cudaMemcpyDeviceToHost)))
            return rc;
    }
    return (int)cudaDeviceSynchronize();
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

// The host-pointer sweep: the CPU build's newcase_ekf_pareto_sweep without
// n_threads, all pointers on the host. Returns 0 or a cudaError_t.
int newcase_ekf_pareto_sweep_cuda(
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
    const double* sia_hist,
    double* U_OPT_SMOOTH_out, double* J0_out, double* J1_out) {
    SweepArgs a{nullptr, nullptr, T, P, T_hist, dt, beta_model, gamma_model,
                b_coef, sigma, alpha_min, alpha_max, nullptr, n_eps, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, beta_ekf, gamma_ekf,
                inv_monitor_len, sia_hist, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr};
    const double* host[] = {u, x, eps_values, a_coef, u_min, u_max, w,
                            s_init, Ps_init, s_final, Ps_final, Q_in, R_v,
                            sia_hist};
    return run_host(a, host, U_OPT_SMOOTH_out, J0_out, J1_out, nullptr,
                    nullptr);
}

// The host-pointer single-epsilon entry: the CPU build's
// newcase_ekf_optimal_npi, argument for argument (the kernel at E = 1).
int newcase_ekf_optimal_npi_cuda(
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
    SweepArgs a{nullptr, nullptr, T, P, 0, dt, beta_model, gamma_model,
                b_coef, sigma, alpha_min, alpha_max, nullptr, 1, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, beta_ekf, gamma_ekf,
                inv_monitor_len, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr};
    const double* host[] = {u, x, &epsilon, a_coef, u_min, u_max, w,
                            s_init, Ps_init, s_final, Ps_final, Q_in, R_v,
                            nullptr};
    return run_host(a, host, U_OPT_SMOOTH_out, nullptr, nullptr, S_PLUS_out,
                    S_SMOOTH_out);
}

const char* newcase_ekf_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
