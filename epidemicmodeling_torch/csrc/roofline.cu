// Roofline anchors of the card for Hopper (sm_90a): the CUDA counterpart of
// the Pallas microkernels behind bench.py's bench_kernel (bench.py:119, with
// fma_kernel :108 and copy_kernel :116), which anchor the TPU's roofline.
// They measure the machine; no path of the system runs them.
//
// What they compute, on float32 arrays of n elements (n a multiple of 4):
//   fma  - x <- x * a + b, DEPTH = 512 times an element (a = 1.0000001,
//          b = 1e-9, each step one fused multiply-add: 2 flops), so 1,024
//          flops for 8 bytes moved: far past the ridge, bound by the float32
//          rate;
//   copy - x + 1: one read and one write of the array, bound by device
//          memory (the stencil and every bytes-bound kernel are judged
//          against the rate this one reaches).
// The design: 16-byte float4 vectors, so every load and store is a full
// 16-byte access. The FMA chain is a grid-stride loop, each thread carrying
// four independent chains; the copy gives each thread UNROLL vectors, all
// loaded before the first store, over as many blocks as that takes.
#include <cuda_runtime.h>

namespace {

constexpr int DEPTH = 512;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
fma_kernel(const float4* __restrict__ in, float4* __restrict__ out,
           long long n4) {
  const float a = 1.0000001f, b = 1e-9f;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    float4 v = in[i];
#pragma unroll 16
    for (int d = 0; d < DEPTH; ++d) {
      v.x = fmaf(v.x, a, b);
      v.y = fmaf(v.y, a, b);
      v.z = fmaf(v.z, a, b);
      v.w = fmaf(v.w, a, b);
    }
    out[i] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float4* __restrict__ in, float4* __restrict__ out,
            long long n4) {
  // UNROLL vectors a thread, all loads in flight before the first store
  const long long i0 =
      blockIdx.x * (long long)(THREADS * UNROLL) + threadIdx.x;
  float4 v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    if (i0 + k * THREADS < n4) v[k] = in[i0 + k * THREADS];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    if (i0 + k * THREADS < n4) {
      v[k].x += 1.f;
      v[k].y += 1.f;
      v[k].z += 1.f;
      v[k].w += 1.f;
      out[i0 + k * THREADS] = v[k];
    }
}

// the FMA chain's grid: at most 8 blocks an SM, looping over the rest
int blocks_for(long long n4) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n4 + THREADS - 1) / THREADS;
  const long long cap = 8LL * (sms > 0 ? sms : 1);   // 8 blocks an SM
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" {

// in, out: n float32, 16-byte aligned, n a multiple of 4 and > 0.
int roofline_fma(const float* in, float* out, long long n, void* stream) {
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  fma_kernel<<<blocks_for(n / 4), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      n / 4);
  return (int)cudaGetLastError();
}

int roofline_copy(const float* in, float* out, long long n, void* stream) {
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)THREADS * UNROLL;
  const long long blocks = (n / 4 + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_kernel<<<(unsigned)blocks, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      n / 4);
  return (int)cudaGetLastError();
}

const char* roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
