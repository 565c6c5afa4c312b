// Pairwise social forces of the agent simulator for Hopper (sm_90a): the CUDA
// port of the Pallas kernel _pairwise_pallas behind social_forces_pallas
// (epidemicmodeling_tpu/ops/pallas/pairwise.py:79 with body _pairwise_kernel
// :33, entry :101).
//
// What it computes (testPopulation2DMotionDynamics.m:140-172, the Pallas
// kernel's law exactly): for every agent row i, the sum over all N + O
// sources k (the N agents, then the O obstacle points) of
//   coef * (p_i - s_k),  d2 = |p_i - s_k|^2, d = sqrt(d2),
//   sign = sign(opt_dist - d) for an agent source, -1 for an obstacle,
//          0 where d > cutoff (strictly greater);
//   w    = w_ss for an agent source, w_so for an obstacle, 0 where k == i;
//   coef = w * sign / (d2 * d) where d2 > 0, else 0 (coincident points).
// Everything in float32, with one IEEE division a pair.
//
// What bounds it on the card: operations. Each pair costs 14 float32
// operations counted as flops (two differences, the squared distance (3),
// opt_dist - d, w * sign, d2 * d, the two force products and sums (4), the
// square root and the division, one each), plus four compares and selects
// (sign, cutoff, self, d2 > 0). The IEEE square root and division are each
// a special-function (SFU) estimate, a few FMAs and a check that branches
// to a slow path, and no instruction of the next pair is scheduled across
// those branches (cuobjdump -sass): the chain of one pair, not the SMs'
// occupancy, sets the rate. N * (N + O) pairs, 4.2e8 at
// N = 20,000 in the default environment. The bytes are O(N + O): 8 bytes
// per agent in and out, 8 per obstacle.
//
// The design, two kernels on one stream:
// - pairwise_partial_kernel: the grid is (row tiles) x (source chunks). A
//   block of THREADS threads owns THREADS * ROWS agent rows, ROWS per thread
//   (register tiling: each source read from shared memory feeds ROWS
//   independent pairs), and one chunk of `chunk` consecutive sources. It
//   stages the whole chunk into shared memory with cp.async, waits once,
//   and then sums with no further synchronisation; every thread reads the
//   same source at the same time, a broadcast without bank conflicts. Each
//   row's partial sum runs over the chunk in source order and goes to the
//   scratch partial[chunk][row]. The coefficient is formed as
//   sign * (w / (d2 d)), so the division does not wait for the sign.
// - pairwise_sum_kernel: one thread per row sums its partial sums in chunk
//   order. Both orders are fixed, so two launches on the same input give
//   bitwise-equal forces. No atomics.
// The launch geometry (the chunk size and count) comes from the wrapper,
// ops/cuda/pairwise_kernel.pairwise_geometry, which sizes the grid so that
// every SM holds at least 8 warps at N = 20,000 and N = 100,000 and keeps a
// chunk under 48 KiB of shared memory. The ragged edges of the rows and of
// the last chunk are masked by index, where the TPU padded with positions
// parked at 1e9. No --use_fast_math: the IEEE sqrt and division and the
// d2 > 0 and d > cutoff masks are the semantics.
//
// Registers (-Xptxas -v, sm_90a): printed by chip_smoke.py; PERF.md keeps
// the measured figures.
#include <cuda_runtime.h>

namespace {

// keep in step with ops/cuda/pairwise_kernel.py (THREADS, ROWS_PER_THREAD,
// MAX_CHUNK); tests/test_torch_kernel_layout.py checks that they agree
constexpr int THREADS = 256;
constexpr int ROWS = 2;
constexpr int MIN_BLOCKS = 2;
constexpr int MAX_CHUNK = 4096;
constexpr int SUM_THREADS = 256;

// jnp.sign: +1, -1, and the argument itself for +-0 and NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ void stage(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Add the terms of the n sources src[0..n) (global indices k0..k0+n) to the
// ROWS rows' sums, in source order. SUBJECT: agent sources, else obstacles.
template <bool SUBJECT>
__device__ __forceinline__ void sum_sources(
    const float2* __restrict__ src, int n, int k0, const float (&xi)[ROWS],
    const float (&yi)[ROWS], const int (&ii)[ROWS], float w, float opt_dist,
    float cutoff, float (&fx)[ROWS], float (&fy)[ROWS]) {
#pragma unroll 2
  for (int c = 0; c < n; ++c) {
    const float2 q = src[c];
    const int k = k0 + c;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float dx = xi[r] - q.x;
      const float dy = yi[r] - q.y;
      const float d2 = dx * dx + dy * dy;
      const float d = sqrtf(d2);
      float sign = SUBJECT ? sign_of(opt_dist - d) : -1.f;
      if (d > cutoff) sign = 0.f;
      const float wk = (SUBJECT && k == ii[r]) ? 0.f : w;
      // sign * (wk / (d2 d)) is (wk sign) / (d2 d) to the bit, as sign is
      // +-1, +-0 or NaN, and lets the division start before the sign is known
      const float coef = d2 > 0.f ? sign * (wk / (d2 * d)) : 0.f;
      fx[r] += coef * dx;
      fy[r] += coef * dy;
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pairwise_partial_kernel(const float2* __restrict__ pos,
                        const float2* __restrict__ obs,
                        float2* __restrict__ partial, int N, int O, int chunk,
                        float w_ss, float w_so, float opt_dist,
                        float cutoff) {
  extern __shared__ float2 src[];
  const int k0 = blockIdx.y * chunk;
  const int n = min(chunk, N + O - k0);
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const int k = k0 + c;
    stage(&src[c], k < N ? pos + k : obs + (k - N));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float xi[ROWS], yi[ROWS], fx[ROWS], fy[ROWS];
  int ii[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    ii[r] = blockIdx.x * (THREADS * ROWS) + r * THREADS + threadIdx.x;
    const float2 p = ii[r] < N ? pos[ii[r]] : make_float2(0.f, 0.f);
    xi[r] = p.x;
    yi[r] = p.y;
    fx[r] = 0.f;
    fy[r] = 0.f;
  }
  // the chunk's agent sources first, then its obstacle points
  const int n_sub = max(0, min(n, N - k0));
  sum_sources<true>(src, n_sub, k0, xi, yi, ii, w_ss, opt_dist, cutoff, fx,
                    fy);
  sum_sources<false>(src + n_sub, n - n_sub, k0 + n_sub, xi, yi, ii, w_so,
                     opt_dist, cutoff, fx, fy);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (ii[r] < N)
      partial[(size_t)blockIdx.y * N + ii[r]] = make_float2(fx[r], fy[r]);
}

__global__ void __launch_bounds__(SUM_THREADS)
pairwise_sum_kernel(const float2* __restrict__ partial,
                    float2* __restrict__ force, int N, int chunks) {
  const int i = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= N) return;
  float2 acc = partial[i];
  for (int s = 1; s < chunks; ++s) {
    const float2 p = partial[(size_t)s * N + i];
    acc.x += p.x;
    acc.y += p.y;
  }
  force[i] = acc;
}

}  // namespace

extern "C" {

// pos (N,2), obs (O,2) -> force (N,2), all float32 row-major and 8-byte
// aligned; partial is a (chunks, N, 2) float32 scratch. The N + O sources
// are cut into `chunks` chunks of `chunk` (the last one ragged). Returns
// cudaGetLastError() after the two launches.
int pairwise_forces(const float* pos, const float* obs, float* partial,
                    float* force, int N, int O, int chunk, int chunks,
                    float w_ss, float w_so, float opt_dist, float cutoff,
                    void* stream) {
  const long long M = (long long)N + O;
  if (N < 1 || O < 0 || chunk < 1 || chunk > MAX_CHUNK || chunks < 1 ||
      chunks > 65535 || (long long)chunk * chunks < M ||
      (long long)chunk * (chunks - 1) >= M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + THREADS * ROWS - 1) / (THREADS * ROWS), chunks);
  pairwise_partial_kernel<<<grid, THREADS, chunk * sizeof(float2), st>>>(
      reinterpret_cast<const float2*>(pos),
      reinterpret_cast<const float2*>(obs),
      reinterpret_cast<float2*>(partial), N, O, chunk, w_ss, w_so, opt_dist,
      cutoff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pairwise_sum_kernel<<<(N + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                        st>>>(reinterpret_cast<const float2*>(partial),
                              reinterpret_cast<float2*>(force), N, chunks);
  return (int)cudaGetLastError();
}

const char* pairwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
