// Batched non-negative least squares with the reference's intercept
// refinement for Hopper (sm_90a): the whole of regression/nnls.py's
// nnls_with_intercept, and nnls (the same with no intercept step), in one
// launch, one block a problem (a region).
//
// It replaces no TPU kernel: the JAX package runs these loops as nested
// lax.while_loops under vmap (epidemicmodeling_tpu/regression/nnls.py:86,
// :158). It was added because the port's eager version drives the active
// set from the host one batched step at a time: a host sync at every loop
// test (about 225 a backtest request at the XPRIZE size) and some 31
// launches a step.
//
// What it computes, per problem (X (n, p), y (n), p <= MAX_P), in the
// input's dtype, with the plain version's caps, thresholds and stopping
// rules:
//   G = X'X, c = X'y, tol = 10 eps ||X||_1 max(n, p) (MATLAB lsqnonneg);
//   a = nnls(c); b = 0; best = ||y - X a||^2; then up to `iterations`
//   intercept steps: a_cand = nnls(X'(y - b)); r = y - X a (the OLD a);
//   b_cand = mean(r); err = ||r - b_cand||^2; if err < best take a_cand,
//   b_cand and err, else stop (Tools/TrainPredictPrescribeNPI.m:263-278).
//   nnls(c): Lawson-Hanson from x = 0 and an empty passive set P, at most
//   3p outer steps (while a column is free and the largest free
//   w = c - G x exceeds tol, add it, the lowest index on ties) and p + 1
//   inner steps each (step from x toward the masked solve z until no
//   column of P has z <= 0, dropping the columns whose x falls to 10 eps or
//   below). The masked solve is G[P,P] z[P] = c[P], z = 0 outside P, by
//   Cholesky; a system that is not positive definite (a pivot <= 0 or NaN,
//   LAPACK's info != 0) gives NaN in every column, as the plain version
//   does. NaN propagates through the argmax and the step length as it does
//   through torch.amax and torch.amin.
//
// What bounds it on the card: the chain of dependent active-set steps, not
// bytes or flops. At the backtest's size (235 x 380 x 12, float32) X is
// 4.3 MB, ~1.3 us of memory time, and forming G ~14 MFLOP; but each problem
// walks ~100 dependent steps, each a masked Cholesky of up to p x p and two
// triangular solves. The design keeps that chain on one warp with nothing
// between its steps:
// - one block of THREADS threads a problem; 235 blocks fit one wave. The
//   block reads its X and y from device memory at each pass: a region's
//   X is 18 KB at the backtest's size and fits in L1. Staging them in
//   shared memory ran 2-4% faster there, 0.1% of a request, and was taken
//   out (PERF.md);
// - all warps form G, c and the column sums of |X| (one dot product a warp
//   at a time, lanes over the rows, a butterfly sum), and at each intercept
//   step X'(y - b) and the residual's sums (block reductions);
// - warp 0 runs the active set, lane k owning column k (its x, z, w, c and
//   whether k is in P, in registers): the argmax and the step length are
//   warp reductions; the masked Cholesky is right-looking in shared memory
//   (lane i owns row i: at pivot k each lane below scales its entry, then
//   updates its row), the two solves broadcast one unknown a step; only the
//   columns of P take part;
// - every loop test is a warp vote or a value every thread holds: no host
//   sync, one launch a regression. Each block writes its problem's outer,
//   inner and intercept iteration counts.
// Every sum runs in a fixed order, so two launches agree bit for bit.
//
// Registers (-Xptxas -v, sm_90a): printed by chip_smoke.py; PERF.md keeps
// the measured figures.
#include <cuda_runtime.h>

#include <math.h>

namespace {

// keep in step with ops/cuda/nnls_kernel.py (THREADS, MAX_P);
// tests/test_torch_kernel_layout.py checks that they agree
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_P = 32;
constexpr int LD = MAX_P + 1;  // row stride of the p x p matrices
constexpr unsigned FULL = 0xffffffffu;

// torch.finfo(dtype).eps, infinity, NaN and the square root of a dtype
template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float eps() {
    return 1.1920928955078125e-07f;
  }
  static __device__ __forceinline__ float inf() { return HUGE_VALF; }
  static __device__ __forceinline__ float nan() {
    return __int_as_float(0x7fffffff);
  }
  static __device__ __forceinline__ float root(float v) { return sqrtf(v); }
};
template <>
struct Num<double> {
  static __device__ __forceinline__ double eps() {
    return 2.220446049250313e-16;
  }
  static __device__ __forceinline__ double inf() { return HUGE_VAL; }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  static __device__ __forceinline__ double root(double v) { return sqrt(v); }
};

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// the warp's sum, the same in every lane (a butterfly: each pair adds the
// same two values)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// the warp's smallest value, NaN if any lane holds NaN (torch.amin)
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  if (__any_sync(FULL, is_nan(v))) return Num<T>::nan();
  for (int m = 16; m > 0; m >>= 1) {
    const T o = __shfl_xor_sync(FULL, v, m);
    v = o < v ? o : v;
  }
  return v;
}

// the warp's largest value and its lowest lane (torch.argmax); no lane
// holds NaN
template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& at) {
  for (int m = 16; m > 0; m >>= 1) {
    const T ov = __shfl_xor_sync(FULL, v, m);
    const int oa = __shfl_xor_sync(FULL, at, m);
    if (ov > v || (ov == v && oa < at)) {
      v = ov;
      at = oa;
    }
  }
}

__device__ __forceinline__ bool has(unsigned set, int k) {
  return (set >> k) & 1u;
}

// The masked solve G[P,P] z[P] = c[P], z = 0 outside P, for the lane's
// column: lane k holds c[k] and gets z[k]; NaN in every lane where a pivot
// is not positive. P: a bit a column. Warp-collective. G and A: p x p with
// row stride LD in shared memory; A holds the factor L (lane i owns row i).
template <typename T>
__device__ T masked_solve(const T* G, T* A, T c, unsigned P, int lane) {
  const bool in = has(P, lane);
  const unsigned upto = FULL >> (31 - lane);  // the columns 0..lane
  __syncwarp();
  if (in)
    for (unsigned js = P & upto; js; js &= js - 1) {
      const int j = __ffs(js) - 1;
      A[lane * LD + j] = G[lane * LD + j];
    }
  __syncwarp();
  T diag = T(1);  // lane k: L[k][k]
  for (unsigned ks = P; ks; ks &= ks - 1) {
    const int k = __ffs(ks) - 1;
    const T d = A[k * LD + k];
    if (!(d > T(0))) return Num<T>::nan();  // the same d in every lane
    const T l_kk = Num<T>::root(d);
    if (lane == k) diag = l_kk;
    const bool below = in && lane > k;
    T l_ik = T(0);
    if (below) {
      l_ik = A[lane * LD + k] / l_kk;
      A[lane * LD + k] = l_ik;
    }
    __syncwarp();
    if (below)
      for (unsigned js = (ks & (ks - 1)) & upto; js; js &= js - 1) {
        const int j = __ffs(js) - 1;
        A[lane * LD + j] -= l_ik * A[j * LD + k];
      }
    __syncwarp();
  }
  T v = in ? c : T(0);
  for (unsigned ks = P; ks; ks &= ks - 1) {  // L y = c, y_k to every lane
    const int k = __ffs(ks) - 1;
    const T yk = __shfl_sync(FULL, v / diag, k);
    if (lane == k)
      v = yk;
    else if (in && lane > k)
      v -= A[lane * LD + k] * yk;
  }
  for (unsigned ks = P; ks;) {  // L' z = y, from the last column of P
    const int k = 31 - __clz(ks);
    ks &= ~(1u << k);
    const T zk = __shfl_sync(FULL, v / diag, k);
    if (lane == k)
      v = zk;
    else if (in && lane < k)
      v -= A[k * LD + lane] * zk;
  }
  return in ? v : T(0);
}

// the inner loop's test: some column of P has z <= 0 (false on NaN)
template <typename T>
__device__ __forceinline__ bool inner_test(T z, unsigned P, int lane) {
  const T m = warp_min(has(P, lane) ? z : Num<T>::inf());
  return P != 0u && m <= T(0);
}

// Lawson-Hanson for c = X'(y - b) (lane k: c[k]; 0 beyond p), from x = 0;
// returns the lane's x and adds the outer and inner trips it ran to
// `outer` and `inner`. Warp-collective.
template <typename T>
__device__ T active_set(const T* G, T* A, T c, T tol, int p, int lane,
                        int& outer, int& inner) {
  const T inf = Num<T>::inf();
  const T drop = Num<T>::eps() * T(10);
  const unsigned all = FULL >> (32 - p);
  T x = T(0), z = T(0), w = c;
  unsigned P = 0u;
  for (int it = 0; it < 3 * p; ++it) {
    T wf = (has(P, lane) || lane >= p) ? -inf : w;
    if (__any_sync(FULL, is_nan(wf))) break;
    int j = lane;
    warp_argmax(wf, j);
    if (P == all || !(wf > tol)) break;
    ++outer;
    P |= 1u << j;
    z = masked_solve(G, A, c, P, lane);
    bool go = inner_test(z, P, lane);
    for (int q = 0; q <= p && go; ++q) {
      ++inner;
      const bool in = has(P, lane);
      const T ratio = (in && z <= T(0)) ? x / (x - z) : inf;
      const T alpha = warp_min(ratio);
      x = x + alpha * (z - x);
      P = __ballot_sync(FULL, in && x > drop);
      z = masked_solve(G, A, c, P, lane);
      go = inner_test(z, P, lane);
    }
    x = has(P, lane) ? z : T(0);
    T gx = T(0);  // (G x)[lane]
    for (int k = 0; k < p; ++k) {
      const T xk = __shfl_sync(FULL, x, k);
      if (lane < p) gx += G[lane * LD + k] * xk;
    }
    w = lane < p ? c - gx : T(0);
  }
  return x;
}

// One block a problem r: X[r] (n, p) and y[r] (n) at element strides
// (sxr, sxn, sxp) and (syr, syn) -> a[r] (p), b[r], counts[r] (outer,
// inner and intercept iterations).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    nnls_kernel(const T* __restrict__ X, long long sxr, long long sxn,
                long long sxp, const T* __restrict__ Y, long long syr,
                long long syn, int n, int p, int iterations, T* a_out,
                T* b_out, int* counts) {
  __shared__ T G[MAX_P * LD];
  __shared__ T A[MAX_P * LD];
  __shared__ T cvec[MAX_P];   // X'(y - b)
  __shared__ T csum[MAX_P];   // the column sums of |X|
  __shared__ T coef[MAX_P];   // the current a
  __shared__ T part[WARPS];
  const int r = blockIdx.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const T* Xr = X + r * sxr;
  const T* Yr = Y + r * syr;
  auto xv = [&](int i, int k) -> T { return Xr[i * sxn + k * sxp]; };
  auto yv = [&](int i) -> T { return Yr[i * syn]; };
  // a sum over the rows by one warp: lanes stride the rows, then a butterfly
  auto rows_sum = [&](auto f) -> T {
    T s = T(0);
    for (int i = lane; i < n; i += 32) s += f(i);
    return warp_sum(s);
  };
  // a sum over the rows by the block, the same in every thread
  auto block_sum = [&](auto f) -> T {
    T s = T(0);
    for (int i = tid; i < n; i += THREADS) s += f(i);
    s = warp_sum(s);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    T total = T(0);
    for (int w = 0; w < WARPS; ++w) total += part[w];
    __syncthreads();
    return total;
  };
  auto xty = [&](int k, T b) {  // X'(y - b), column k
    return rows_sum([&](int i) { return xv(i, k) * (yv(i) - b); });
  };
  auto resid = [&](int i) {  // y - X a, row i
    T s = T(0);
    for (int k = 0; k < p; ++k) s += xv(i, k) * coef[k];
    return yv(i) - s;
  };

  // G (its upper triangle, mirrored), the column sums of |X| and X'y
  const int tri = p * (p + 1) / 2;
  for (int t = warp; t < tri + 2 * p; t += WARPS) {
    if (t < tri) {
      int k = 0, u = t;
      while (u >= p - k) {
        u -= p - k;
        ++k;
      }
      const int l = k + u;
      const T s = rows_sum([&](int i) { return xv(i, k) * xv(i, l); });
      if (lane == 0) G[k * LD + l] = G[l * LD + k] = s;
    } else if (t < tri + p) {
      const int k = t - tri;
      const T s = rows_sum([&](int i) {
        const T v = xv(i, k);
        return v < T(0) ? -v : v;
      });
      if (lane == 0) csum[k] = s;
    } else {
      const T s = xty(t - tri - p, T(0));
      if (lane == 0) cvec[t - tri - p] = s;
    }
  }
  __syncthreads();

  int outer = 0, inner = 0, steps = 0;
  T a = T(0), b = T(0), tol = T(0);
  if (warp == 0) {
    T m = lane < p ? csum[lane] : -Num<T>::inf();  // ||X||_1, NaN-propagating
    if (__any_sync(FULL, is_nan(m))) {
      m = Num<T>::nan();
    } else {
      for (int s = 16; s > 0; s >>= 1) {
        const T o = __shfl_xor_sync(FULL, m, s);
        m = o > m ? o : m;
      }
    }
    tol = Num<T>::eps() * T(10) * m * T(n > p ? n : p);
    a = active_set(G, A, lane < p ? cvec[lane] : T(0), tol, p, lane, outer,
                   inner);
    if (lane < p) coef[lane] = a;
  }
  if (iterations > 0) {
    __syncthreads();  // coef written, cvec read
    T best = block_sum([&](int i) {
      const T q = resid(i);
      return q * q;
    });
    for (int it = 0; it < iterations; ++it) {
      ++steps;
      for (int k = warp; k < p; k += WARPS) {
        const T s = xty(k, b);
        if (lane == 0) cvec[k] = s;
      }
      // the residual of the OLD a; block_sum's barriers also publish cvec
      const T mean = block_sum(resid) / T(n);
      const T err = block_sum([&](int i) {
        const T q = resid(i) - mean;
        return q * q;
      });
      const bool improved = err < best;  // the same in every thread
      if (warp == 0) {
        const T cand = active_set(G, A, lane < p ? cvec[lane] : T(0), tol, p,
                                  lane, outer, inner);
        if (improved) {
          a = cand;
          if (lane < p) coef[lane] = a;
        }
      }
      if (!improved) break;
      b = mean;
      best = err;
      __syncthreads();  // coef written, cvec read
    }
  }
  if (warp == 0) {
    if (lane < p) a_out[(long long)r * p + lane] = a;
    if (lane == 0) {
      b_out[r] = b;
      counts[3 * r] = outer;
      counts[3 * r + 1] = inner;
      counts[3 * r + 2] = steps;
    }
  }
}

// The masked solve alone, one warp a problem: G (R, p, p), c (R, p), P
// (R, p) bytes -> z (R, p). For the tests only: no path of the port calls
// it. It runs masked_solve as the NNLS does, so that its singular case can
// be held against the plain version's _masked_ls. The NNLS cannot reach
// that case on demand: a column enters P only when its w exceeds tol, and
// a column in the span of P's columns has w = 0 up to rounding, far below
// tol; a pivot of 0 comes only from rounding on near-collinear columns.
template <typename T>
__global__ void __launch_bounds__(32)
    masked_solve_kernel(const T* __restrict__ G_in, const T* __restrict__ c,
                        const unsigned char* __restrict__ P, T* z, int p) {
  __shared__ T G[MAX_P * LD];
  __shared__ T A[MAX_P * LD];
  const int r = blockIdx.x, lane = threadIdx.x;
  const long long at = (long long)r * p;
  for (int e = lane; e < p * p; e += 32)
    G[(e / p) * LD + e % p] = G_in[at * p + e];
  const unsigned in = __ballot_sync(FULL, lane < p && P[at + lane] != 0);
  const T zl = masked_solve(G, A, lane < p ? c[at + lane] : T(0), in, lane);
  if (lane < p) z[at + lane] = zl;
}

template <typename T>
int nnls_launch(const T* X, long long sxr, long long sxn, long long sxp,
                const T* y, long long syr, long long syn, int R, int n, int p,
                int iterations, T* a, T* b, int* counts, void* stream) {
  if (R < 1 || n < 1 || p < 1 || p > MAX_P || iterations < 0)
    return (int)cudaErrorInvalidValue;
  nnls_kernel<T><<<R, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      X, sxr, sxn, sxp, y, syr, syn, n, p, iterations, a, b, counts);
  return (int)cudaGetLastError();
}

template <typename T>
int masked_solve_launch(const T* G, const T* c, const unsigned char* P, T* z,
                        int R, int p, void* stream) {
  if (R < 1 || p < 1 || p > MAX_P) return (int)cudaErrorInvalidValue;
  masked_solve_kernel<T><<<R, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      G, c, P, z, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X (R, n, p) and y (R, n) at element strides -> a (R, p), b (R), counts
// (R, 3) int32 (outer, inner and intercept iterations of each problem).
// iterations = 0: nnls alone (b = 0). One launch on `stream`; returns
// cudaGetLastError() after it.
int nnls_intercept_f32(const float* X, long long sxr, long long sxn,
                       long long sxp, const float* y, long long syr,
                       long long syn, int R, int n, int p, int iterations,
                       float* a, float* b, int* counts, void* stream) {
  return nnls_launch(X, sxr, sxn, sxp, y, syr, syn, R, n, p, iterations, a,
                     b, counts, stream);
}

int nnls_intercept_f64(const double* X, long long sxr, long long sxn,
                       long long sxp, const double* y, long long syr,
                       long long syn, int R, int n, int p, int iterations,
                       double* a, double* b, int* counts, void* stream) {
  return nnls_launch(X, sxr, sxn, sxp, y, syr, syn, R, n, p, iterations, a,
                     b, counts, stream);
}

// G (R, p, p), c (R, p), P (R, p) bytes, all contiguous -> z (R, p). For
// the tests only (masked_solve_kernel).
int nnls_masked_solve_f32(const float* G, const float* c,
                          const unsigned char* P, float* z, int R, int p,
                          void* stream) {
  return masked_solve_launch(G, c, P, z, R, p, stream);
}

int nnls_masked_solve_f64(const double* G, const double* c,
                          const unsigned char* P, double* z, int R, int p,
                          void* stream) {
  return masked_solve_launch(G, c, P, z, R, p, stream);
}

const char* nnls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
