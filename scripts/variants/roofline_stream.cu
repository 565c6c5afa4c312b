// A design of the copy (x + 1) in epidemicmodeling_torch/csrc/roofline.cu
// timed beside the port's persistent TMA ring: a persistent grid-stride
// copy through registers. BLOCKS_PER_SM blocks of THREADS threads an SM;
// each block walks tiles of THREADS * VEC float4s, tile t, t + gridDim.x,
// ...; a thread loads its VEC float4s of the tile (LDG.128, __ldcs:
// evict-first, the data is read once) before it adds 1 and stores the first
// (STG.128, __stcs: streaming). Only the last tile is guarded. Same C
// interface as the port's roofline_copy. scripts/kernel_ab.py
// --roofline-csrc times it against the port's kernel, the earlier design
// and PyTorch's x + 1; its times: PERF.md, Findings.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;
constexpr int BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
stream_kernel(const float4* __restrict__ in, float4* __restrict__ out,
              long long n4) {
  constexpr long long TILE = (long long)THREADS * VEC;
  const long long tiles = (n4 + TILE - 1) / TILE;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long i0 = t * TILE + threadIdx.x;
    float4 v[VEC];
    if (i0 + (VEC - 1) * THREADS < n4) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __ldcs(in + i0 + k * THREADS);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[k].x += 1.f;
        v[k].y += 1.f;
        v[k].z += 1.f;
        v[k].w += 1.f;
        __stcs(out + i0 + k * THREADS, v[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (i0 + k * THREADS < n4) v[k] = __ldcs(in + i0 + k * THREADS);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (i0 + k * THREADS < n4) {
          v[k].x += 1.f;
          v[k].y += 1.f;
          v[k].z += 1.f;
          v[k].w += 1.f;
          __stcs(out + i0 + k * THREADS, v[k]);
        }
    }
  }
}

}  // namespace

extern "C" {

// in, out: n float32, 16-byte aligned, n a multiple of 4 and > 0.
int roofline_copy(const float* in, float* out, long long n, void* stream) {
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long n4 = n / 4;
  const long long tiles = (n4 + (long long)THREADS * VEC - 1) /
                          ((long long)THREADS * VEC);
  const long long cap = (long long)BLOCKS_PER_SM * (sms > 0 ? sms : 1);
  stream_kernel<<<(unsigned)(tiles < cap ? tiles : cap), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      n4);
  return (int)cudaGetLastError();
}

const char* roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
