// One explicit step of the 2-D diffusion cellular automaton for Hopper
// (sm_90a): the CUDA port of the Pallas kernels _diffusion_pallas and
// _diffusion_pallas_tiled behind diffusion_step_pallas
// (epidemicmodeling_tpu/ops/pallas/stencil.py:44 with body _stencil_kernel
// :29, :82 with body _stencil_tiled_kernel :56, entry :114).
//
// What it computes: the 9-point update of every interior cell,
//   out = c0*C + ax*(up + down) + ay*(left + right)
//         + axy*(up-left + down-right + up-right + down-left),
// c0 = 1 - 2ax - 2ay - 4axy, with "up"/"down" the neighbours along the first
// axis (Lx, spacing dx) and "left"/"right" along the second (Ly, spacing dy).
// axy = 0 is the 4-neighbour scheme (the EIGHT = false instantiation skips
// the diagonals). Boundary rows and columns are copied unchanged (Dirichlet,
// testCellularAutomataForPDESolution.m:43-49); a grid with Lx < 3 or Ly < 3
// has no interior, and the output is a copy.
//
// What bounds it on the card: bytes. Each step reads the field once and
// writes it once, 2 * sizeof(T) * Lx * Ly bytes (2 * 4 * Lx * Ly in
// float32), against ~10 flops per cell, so the time is that traffic over
// the 3.35 TB/s of device memory. The design: a 2-D grid of 32 x 8 blocks
// over (Lx, Ly), threads along the contiguous Ly axis so that every warp
// reads and writes 32 neighbouring cells of one row, one cell per thread.
// The eight neighbours are read straight from device memory through the
// read-only L1/L2 path (__ldg): the three rows a block touches are reused
// there, so device memory sees each cell about once. The Pallas split into a
// whole-grid kernel and row panels existed because of the TPU's VMEM; it
// has no counterpart here. Left for later: a shared-memory tile with a
// one-cell halo, several cells per thread with vector loads, and fusing
// several time steps (or the source injection) into one pass, which is the
// only way below the one-read-one-write bound per step.
//
// Registers (-Xptxas -v, sm_90a, measured on the H100 build): float32
// 4-neighbour 18, 8-neighbour 22; float64 26 and 30; no stack, no spills.
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads along Ly, the contiguous axis
constexpr int BY = 8;   // threads along Lx

template <typename T, bool EIGHT>
__global__ void __launch_bounds__(BX * BY)
stencil_kernel(const T* __restrict__ C, T* __restrict__ out, int Lx, int Ly,
               T c0, T ax, T ay, T axy) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= Lx || j >= Ly) return;
  const size_t k = (size_t)i * Ly + j;
  if (i == 0 || j == 0 || i == Lx - 1 || j == Ly - 1) {
    out[k] = __ldg(C + k);
    return;
  }
  const T* up = C + k - Ly;  // row i - 1
  const T* dn = C + k + Ly;  // row i + 1
  T acc = c0 * __ldg(C + k);
  acc += ax * (__ldg(up) + __ldg(dn));
  acc += ay * (__ldg(C + k - 1) + __ldg(C + k + 1));
  if (EIGHT) {
    acc += axy * (__ldg(up - 1) + __ldg(dn + 1) + __ldg(up + 1) +
                  __ldg(dn - 1));
  }
  out[k] = acc;
}

template <typename T>
int launch(const T* C, T* out, int Lx, int Ly, double c0, double ax,
           double ay, double axy, void* stream) {
  if (Lx < 1 || Ly < 1 || (Lx + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Ly + BX - 1) / BX, (Lx + BY - 1) / BY);
  const dim3 block(BX, BY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axy != 0.0) {
    stencil_kernel<T, true><<<grid, block, 0, st>>>(
        C, out, Lx, Ly, (T)c0, (T)ax, (T)ay, (T)axy);
  } else {
    stencil_kernel<T, false><<<grid, block, 0, st>>>(
        C, out, Lx, Ly, (T)c0, (T)ax, (T)ay, (T)axy);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C, out: (Lx, Ly) row-major, distinct buffers. c0 = 1 - 2ax - 2ay - 4axy,
// computed by the caller in double and rounded once, as the Pallas kernel's
// Python scalars are. Returns cudaGetLastError() after the launch.
int stencil_f32(const float* C, float* out, int Lx, int Ly, double c0,
                double ax, double ay, double axy, void* stream) {
  return launch<float>(C, out, Lx, Ly, c0, ax, ay, axy, stream);
}

int stencil_f64(const double* C, double* out, int Lx, int Ly, double c0,
                double ax, double ay, double axy, void* stream) {
  return launch<double>(C, out, Lx, Ly, c0, ax, ay, axy, stream);
}

const char* stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
