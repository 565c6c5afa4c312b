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
// The FMA chain: 16-byte float4 vectors in a grid-stride loop, each thread
// carrying four independent chains.
//
// The copy: a persistent ring of TMA bulk copies. One block of COPY_THREADS
// threads an SM (BLOCKS_PER_SM) walks the chunks c = blockIdx.x,
// blockIdx.x + gridDim.x, ... of CHUNK bytes; the last chunk of the array
// holds what is left, a multiple of 16 bytes since n % 4 == 0, which is the
// bulk copy's granularity. A ring of STAGES chunks sits in dynamic shared
// memory, one mbarrier a stage:
// - thread 0 (the producer) arms a stage's barrier with the chunk's bytes
//   (mbarrier.arrive.expect_tx) and issues the non-tensor bulk load
//   (cp.async.bulk ... mbarrier::complete_tx::bytes), STAGES - 1 chunks
//   ahead of the consumers;
// - every thread waits on the stage's barrier at the parity of its use
//   (k / STAGES) & 1, adds 1 to its float4s in place, then fences its
//   writes to the async proxy (fence.proxy.async.shared::cta) so that the
//   bulk store reads them, and the block meets at a barrier;
// - thread 0 stores the stage (cp.async.bulk ... bulk_group, one commit
//   group a chunk), then refills the stage the previous chunk used, once
//   cp.async.bulk.wait_group.read 1 shows that chunk's store has read it;
//   it waits for every store before the block exits.
// A wait that never completes (a wrong parity) traps after WAIT_LIMIT polls
// rather than hanging the card. copy_geometry is the launch's shape;
// ops/cuda/roofline_kernel.copy_geometry restates it, and the tests read
// the constants below from this file.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int DEPTH = 512;
constexpr int THREADS = 256;

constexpr int COPY_THREADS = 256;
constexpr int CHUNK = 32768;          // bytes a chunk, one stage of the ring
constexpr int STAGES = 6;
constexpr int BLOCKS_PER_SM = 1;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may take
constexpr long long WAIT_LIMIT = 1LL << 24;
constexpr int MAX_DEVICES = 64;
static_assert(STAGES * CHUNK <= SMEM_LIMIT, "the ring must fit in a block");
static_assert(CHUNK % (16 * COPY_THREADS) == 0,
              "a full chunk is whole float4s for every thread");

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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// arm the stage's barrier for `bytes` and load them into the stage
__device__ __forceinline__ void bulk_load(uint32_t stage, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(stage), "l"(src), "r"(bytes), "r"(bar) : "memory");
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
copy_kernel(const char* __restrict__ in, char* __restrict__ out,
            long long bytes) {
  extern __shared__ __align__(128) float4 ring[];   // STAGES x CHUNK bytes
  __shared__ __align__(8) uint64_t full[STAGES];
  const long long chunks = (bytes + CHUNK - 1) / CHUNK;
  // this block's chunks k = 0 .. count - 1 (gridDim.x <= chunks)
  const long long count = (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const uint32_t ring0 = shared_addr(ring);
  auto offset = [&](long long k) {
    return (blockIdx.x + k * gridDim.x) * (long long)CHUNK;
  };
  auto size = [&](long long off) {
    return (uint32_t)(bytes - off < CHUNK ? bytes - off : CHUNK);
  };
  auto load = [&](long long k) {
    const int s = (int)(k % STAGES);
    const long long off = offset(k);
    bulk_load(ring0 + s * CHUNK, in + off, size(off), shared_addr(&full[s]));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(shared_addr(&full[s])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long k = 0; k < STAGES - 1 && k < count; ++k) load(k);
  }
  __syncthreads();
  for (long long k = 0; k < count; ++k) {
    const int s = (int)(k % STAGES);
    const long long off = offset(k);
    const uint32_t nb = size(off);
    wait_parity(shared_addr(&full[s]), (uint32_t)((k / STAGES) & 1));
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
    // the bulk store reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                   "[%0], [%1], %2;\n"
                   :: "l"(out + off), "r"(ring0 + s * CHUNK), "r"(nb)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (k + STAGES - 1 < count) {
        // chunk k + STAGES - 1 goes where chunk k - 1 was: every store but
        // this chunk's must have read its stage
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load(k + STAGES - 1);
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

struct CopyGeometry {
  int blocks, stages, chunk, smem;
};

// The copy's launch for n floats: BLOCKS_PER_SM blocks an SM of the current
// device, no more than there are chunks. The SM count is read once a device,
// and the kernel's shared-memory limit raised once a device.
int copy_geometry(long long n, CopyGeometry* g) {
  static int sms_of[MAX_DEVICES];
  static bool opted_in[MAX_DEVICES];
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && sms_of[dev] > 0) {
    sms = sms_of[dev];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (cached) sms_of[dev] = sms;
  }
  if (!(cached && opted_in[dev])) {
    err = cudaFuncSetAttribute(copy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGES * CHUNK);
    if (err != cudaSuccess) return (int)err;
    if (cached) opted_in[dev] = true;
  }
  const long long chunks = (4 * n + CHUNK - 1) / CHUNK;
  const long long cap = (long long)BLOCKS_PER_SM * sms;
  g->blocks = (int)(chunks < cap ? chunks : cap);
  g->stages = STAGES;
  g->chunk = CHUNK;
  g->smem = STAGES * CHUNK;
  return (int)cudaSuccess;
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
  CopyGeometry g;
  const int err = copy_geometry(n, &g);
  if (err != (int)cudaSuccess) return err;
  copy_kernel<<<g.blocks, COPY_THREADS, g.smem,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char*>(in), reinterpret_cast<char*>(out),
      4 * n);
  return (int)cudaGetLastError();
}

// The copy's launch for n floats on the current device: out[0..3] = blocks,
// stages, chunk bytes, dynamic shared bytes. Returns a cudaError_t.
int roofline_copy_geometry(long long n, int* out) {
  CopyGeometry g;
  const int err = copy_geometry(n, &g);
  if (err != (int)cudaSuccess) return err;
  out[0] = g.blocks;
  out[1] = g.stages;
  out[2] = g.chunk;
  out[3] = g.smem;
  return (int)cudaSuccess;
}

const char* roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
