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
// Everything in float32, accumulated in registers in source order.
//
// What bounds it on the card: operations. Each pair costs 14 float32
// operations counted as flops (two differences, the squared distance (3),
// opt_dist - d, w * sign, d2 * d, the two force products and sums (4), the
// square root and the division, one each), plus four compares and selects
// (sign, cutoff, self, d2 > 0). The IEEE square root and division are each
// several instructions on the SFU (special-function unit) and FMA pipes, so
// the flop count understates the instruction slots. N * (N + O) pairs,
// 4.2e8 at N = 20,000 in the default environment. The bytes are O(N + O):
// 8 bytes per agent in and out, 8 per obstacle. The
// design: one thread owns one agent row and loops over every source, which
// the block stages through shared memory in tiles of 128 (one source per
// thread, read once per block); every thread of the block reads the same
// source at the same time, a broadcast without bank conflicts. No atomics,
// no cross-block reduction and no padding: the ragged edges of the rows and
// of the last source tile are masked by index, where the TPU padded with
// positions parked at 1e9. No --use_fast_math: the IEEE sqrt and division
// and the d2 > 0 and d > cutoff masks are the semantics.
//
// Left for later: at N = 20,000 the grid is 157 blocks of 128 threads on
// 132 SMs, one or two blocks (4-8 warps) per SM, too few warps to hide the
// SFU and shared-memory latency. Splitting the source axis over blocks (with
// a second reduction pass), several rows per thread, and a cell list that
// skips sources beyond the cutoff are the next steps.
//
// Registers (-Xptxas -v, sm_90a, measured on the H100 build): 28, 1 KiB of
// shared memory, no stack, no spills.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

// jnp.sign: +1, -1, and the argument itself for +-0 and NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ pos, const float* __restrict__ obs,
                float* __restrict__ force, int N, int O, float w_ss,
                float w_so, float opt_dist, float cutoff) {
  __shared__ float sx[THREADS];
  __shared__ float sy[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int M = N + O;
  const float xi = i < N ? pos[2 * i] : 0.f;
  const float yi = i < N ? pos[2 * i + 1] : 0.f;
  float fx = 0.f, fy = 0.f;
  for (int base = 0; base < M; base += THREADS) {
    const int k = base + threadIdx.x;
    if (k < N) {
      sx[threadIdx.x] = pos[2 * k];
      sy[threadIdx.x] = pos[2 * k + 1];
    } else if (k < M) {
      sx[threadIdx.x] = obs[2 * (k - N)];
      sy[threadIdx.x] = obs[2 * (k - N) + 1];
    }
    __syncthreads();
    const int n = min(THREADS, M - base);
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const int src = base + c;
      const float dx = xi - sx[c];
      const float dy = yi - sy[c];
      const float d2 = dx * dx + dy * dy;
      const float d = sqrtf(d2);
      const bool subject = src < N;
      float sign = subject ? sign_of(opt_dist - d) : -1.f;
      if (d > cutoff) sign = 0.f;
      const float w = src == i ? 0.f : (subject ? w_ss : w_so);
      const float coef = d2 > 0.f ? w * sign / (d2 * d) : 0.f;
      fx += coef * dx;
      fy += coef * dy;
    }
    __syncthreads();
  }
  if (i < N) {
    force[2 * i] = fx;
    force[2 * i + 1] = fy;
  }
}

}  // namespace

extern "C" {

// pos (N,2), obs (O,2) -> force (N,2), all float32 row-major. Returns
// cudaGetLastError() after the launch.
int pairwise_forces(const float* pos, const float* obs, float* force, int N,
                    int O, float w_ss, float w_so, float opt_dist,
                    float cutoff, void* stream) {
  if (N < 1 || O < 0) return (int)cudaErrorInvalidValue;
  pairwise_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      pos, obs, force, N, O, w_ss, w_so, opt_dist, cutoff);
  return (int)cudaGetLastError();
}

const char* pairwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
