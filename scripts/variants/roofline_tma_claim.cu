// A design of the copy (x + 1) in epidemicmodeling_torch/csrc/roofline.cu
// timed beside the port's: the same persistent TMA ring (one block of 256
// threads an SM, 6 stages of 32 KiB, bulk loads on one mbarrier a stage,
// +1 in shared memory, bulk stores), but the chunks are claimed at run time
// from a device counter (atomicAdd) instead of the static walk b, b + 132,
// ...: an SM that streams faster takes more chunks, as the hardware's block
// scheduler balances a grid of many short blocks. Thread 0 claims a chunk
// for a stage before it loads it and records it in the stage's slot; once
// the counter passes the last chunk it arrives on the stage with no bytes
// and slot -1, where every thread of the block stops. The last block to
// finish sets the counters back to 0, so one launch at a time a device (on
// any stream) is all this variant takes. Same C interface as the port's
// roofline_copy. scripts/kernel_ab.py --roofline-csrc times it; its times:
// PERF.md, Findings.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int CHUNK = 32768;
constexpr int STAGES = 6;
constexpr long long WAIT_LIMIT = 1LL << 24;

__device__ unsigned long long next_chunk = 0;
__device__ unsigned int blocks_done = 0;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  for (long long polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == WAIT_LIMIT) __trap();
  }
}

__global__ void __launch_bounds__(COPY_THREADS, 1)
claim_kernel(const char* __restrict__ in, char* __restrict__ out,
             long long bytes) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ long long chunk_of[STAGES];
  const long long chunks = (bytes + CHUNK - 1) / CHUNK;
  const uint32_t ring0 = shared_addr(ring);
  auto size = [&](long long off) {
    return (uint32_t)(bytes - off < CHUNK ? bytes - off : CHUNK);
  };
  // thread 0: claim a chunk for stage s and load it, or mark the end
  auto claim = [&](int s) {
    const uint32_t bar = shared_addr(&full[s]);
    const long long c = (long long)atomicAdd(&next_chunk, 1ULL);
    if (c < chunks) {
      const long long off = c * CHUNK;
      chunk_of[s] = c;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(size(off)) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(ring0 + s * CHUNK), "l"(in + off), "r"(size(off)), "r"(bar)
          : "memory");
    } else {
      chunk_of[s] = -1;
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(bar) : "memory");
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(shared_addr(&full[s])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES - 1; ++s) claim(s);
  }
  __syncthreads();
  for (long long k = 0;; ++k) {
    const int s = (int)(k % STAGES);
    wait_parity(shared_addr(&full[s]), (uint32_t)((k / STAGES) & 1));
    const long long c = *static_cast<volatile long long*>(&chunk_of[s]);
    if (c < 0) break;
    const long long off = c * CHUNK;
    const uint32_t nb = size(off);
    float4* v = ring + s * (CHUNK / 16);
    const int nv = (int)(nb / 16);
#pragma unroll 8
    for (int i = threadIdx.x; i < nv; i += COPY_THREADS) {
      float4 t = v[i];
      t.x += 1.f;
      t.y += 1.f;
      t.z += 1.f;
      t.w += 1.f;
      v[i] = t;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                   "[%0], [%1], %2;\n"
                   :: "l"(out + off), "r"(ring0 + s * CHUNK), "r"(nb)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      claim((int)((k + STAGES - 1) % STAGES));
    }
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    __threadfence();
    // every block has stopped claiming once it counts itself done
    if (atomicAdd(&blocks_done, 1u) == gridDim.x - 1) {
      next_chunk = 0;
      blocks_done = 0;
      __threadfence();
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
  const cudaError_t err = cudaFuncSetAttribute(
      claim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STAGES * CHUNK);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (4 * n + CHUNK - 1) / CHUNK;
  const int blocks = (int)(chunks < sms ? chunks : sms);
  claim_kernel<<<blocks, COPY_THREADS, STAGES * CHUNK,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char*>(in), reinterpret_cast<char*>(out), 4 * n);
  return (int)cudaGetLastError();
}

const char* roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
