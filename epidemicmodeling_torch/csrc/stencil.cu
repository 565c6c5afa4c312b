// Explicit steps of the 2-D diffusion cellular automaton for Hopper (sm_90a),
// many steps per launch: the CUDA port of the Pallas kernels _diffusion_pallas
// and _diffusion_pallas_tiled behind diffusion_step_pallas
// (epidemicmodeling_tpu/ops/pallas/stencil.py:44 with body _stencil_kernel
// :29, :82 with body _stencil_tiled_kernel :56, entry :114).
//
// What it computes, n times: add the step's sources to the field (a dense
// (Lx, Ly) frame, as diffusion_rollout's C + src, and/or sparse (cell,
// amount) injections summed in walker order, as walkers.py's
// C.at[pos].add), then the 9-point update of every interior cell,
//   out = c0*C + ax*(up + down) + ay*(left + right)
//         + axy*(up-left + down-right + up-right + down-left),
// c0 = 1 - 2ax - 2ay - 4axy, per-step weights, "up"/"down" along the first
// axis (Lx) and "left"/"right" along the second (Ly). axy = 0 is the
// 4-neighbour scheme. Boundary rows and columns keep their value (Dirichlet,
// testCellularAutomataForPDESolution.m:43-49); a grid with Lx < 3 or Ly < 3
// has no interior. Every cell is computed by the same expression, in the
// plain version's order and without contraction into FMAs (explicit _rn
// intrinsics), so a launch of K steps equals K launches of one step bit for
// bit, and the kernel equals the plain PyTorch version on the card.
//
// What bounds it on the card: bytes. One step reads the field once and
// writes it once (2 * 4 * Lx * Ly in float32, ~10 flops a cell); a rollout
// that keeps every frame must still write each one. The design is temporal
// blocking: a block loads its tile plus a halo of K cells into shared memory
// once, runs K steps there (two buffers, ping-pong), recomputing the halo as
// it shrinks by one cell a step, and writes the frames the caller keeps
// straight from registers. So a step moves 1/K of a read of the field, one
// write when frames are kept (else none but the last), and the dense source
// when there is one; ceil(n / KMAX) launches replace n. A block is NT = 256
// threads, one box column each: the box is ROWS x NT cells, the tile
// (ROWS - 2K) x (NT - 2K). The load is 16-byte cp.async copies along Ly:
// each box row sits in shared memory shifted by its global address modulo
// 16 bytes (0..V-1 elements), so every full vector is aligned on both sides
// whatever Ly and the field's offset; the ragged ends go element by element.
// Each thread then walks its column down the box's rows on the field with a
// 3 x 3 register window (three shared loads a cell, the next row loaded
// before this one is stored). On the card the row loop's instruction
// count, not the bytes, sets a multi-step launch's time: integer offsets
// into one shared array, the sources and the last step as compile-time
// flags, and one unsigned compare each for the boundary and the frame rows
// keep it short, and it is unrolled four rows deep, which hides more of
// each row's latency than two (PERF.md). Sparse injections are applied by
// warp 0 between steps, 32 walkers at a time: lanes hitting one cell are
// grouped (__match_any_sync) and the lowest adds their amounts in lane
// order.
//
// Registers and shared memory (-Xptxas -v, sm_90a): printed by
// chip_smoke.py; PERF.md keeps the measured figures.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;       // threads of a block = columns of its box
constexpr int KCAP = 8;       // step slots of one launch's weights
// box rows and steps per launch: two float32 buffers of (54 + 1) x
// (256 + 4) cells (the box and a spare row) take 114,400 bytes, so two
// blocks fit an SM; float64 halves both
constexpr int ROWS_F32 = 54;
constexpr int KMAX_F32 = 8;
constexpr int ROWS_F64 = 26;
constexpr int KMAX_F64 = 4;

template <typename T> struct Box;
template <> struct Box<float> {
  static constexpr int ROWS = ROWS_F32, KMAX = KMAX_F32;
};
template <> struct Box<double> {
  static constexpr int ROWS = ROWS_F64, KMAX = KMAX_F64;
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// One interior cell, in stencil_plain's order, no FMA contraction; EIGHT
// adds the diagonals (axy != 0).
template <typename T, bool EIGHT>
__device__ __forceinline__ T cell_update(T ul, T u, T ur, T l, T m, T r,
                                         T dl, T d, T dr, T c0, T ax, T ay,
                                         T axy) {
  T acc = add_rn(mul_rn(c0, m), mul_rn(ax, add_rn(u, d)));
  acc = add_rn(acc, mul_rn(ay, add_rn(l, r)));
  if constexpr (EIGHT)
    acc = add_rn(acc,
                 mul_rn(axy, add_rn(add_rn(add_rn(ul, dr), ur), dl)));
  return acc;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst,
                                              const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One launch: K steps from `in`, frames (keep) or the last field to `out`.
template <typename T>
struct Launch {
  const T* in;      // (Lx, Ly), the field before the launch's first step
  T* out;           // keep ? (K, Lx, Ly) frames : (Lx, Ly)
  const T* src;     // (K, Lx, Ly) dense sources, or null
  const int* cell;  // (n_inj, W) flat cells (< 0: none), or null
  const T* amt;     // (n_inj, W) amounts
  int W, n_inj, Lx, Ly, K, keep;
  T c0[KCAP], ax[KCAP], ay[KCAP], axy[KCAP];
};

template <typename T, bool SRC>
__global__ void __launch_bounds__(NT, 2) rollout_kernel(const Launch<T> a) {
  constexpr int ROWS = Box<T>::ROWS;
  constexpr int V = 16 / sizeof(T);   // elements of a 16-byte vector
  constexpr int P = NT + V;           // a box row's pitch, room for its shift
  constexpr int BUF = (ROWS + 1) * P; // a buffer: the box and a spare row
  constexpr int NQ = NT / V + 1;      // vectors covering a shifted row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T w_s[4][KCAP];
  __shared__ T amt_s[32];
  T* const buf0 = reinterpret_cast<T*>(smem_raw);

  const int K = a.K, Lx = a.Lx, Ly = a.Ly;
  const int TX = ROWS - 2 * K, TY = NT - 2 * K;
  const int gx0 = blockIdx.y * TX - K;    // global row of box row 0
  const int gy0 = blockIdx.x * TY - K;    // global column of box column 0
  const long long LxLy = (long long)Lx * Ly;
  // box row r sits at r * P + sh(r): sh(r) is the misalignment, in
  // elements, of the row's first global cell
  const long long first =
      (long long)(reinterpret_cast<uintptr_t>(a.in) / sizeof(T)) +
      (long long)gx0 * Ly + gy0;
  const int sh0 = (int)(first & (V - 1));
  const int dly = Ly & (V - 1);
  auto shift = [&](int r) { return (sh0 + r * dly) & (V - 1); };

#pragma unroll
  for (int t = 0; t < KCAP; ++t)
    if (threadIdx.x == t) {
      w_s[0][t] = a.c0[t];
      w_s[1][t] = a.ax[t];
      w_s[2][t] = a.ay[t];
      w_s[3][t] = a.axy[t];
    }

  // the box: full 16-byte vectors by cp.async, the ragged ends element by
  // element, cells off the field zero
  for (int i = threadIdx.x; i < ROWS * NQ; i += NT) {
    const int r = i / NQ, q = i - r * NQ;
    T* dst = buf0 + r * P + V * q;
    const int g = gx0 + r;
    const int gy = gy0 + V * q - shift(r);   // global column of dst[0]
    const T* src = a.in + (long long)g * Ly + gy;
    if (g < 0 || g >= Lx) {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = T(0);
    } else if (gy >= 0 && gy + V <= Ly) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (gy + e >= 0 && gy + e < Ly) cp_async_elem(dst + e, src + e);
        else dst[e] = T(0);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int c = threadIdx.x;             // this thread's box column
  const int gy = gy0 + c;
  const bool col_in = gy >= 0 && gy < Ly;
  const bool col_edge = gy == 0 || gy == Ly - 1;
  const bool col_tile = c >= K && c < NT - K;

  if constexpr (SRC) {                   // the first step's dense source
    if (col_in)
      for (int r = 0; r < ROWS; ++r) {
        const int g = gx0 + r;
        if (g >= 0 && g < Lx) {
          const int off = r * P + shift(r) + c;
          buf0[off] = add_rn(buf0[off], a.src[(long long)g * Ly + gy]);
        }
      }
    __syncthreads();
  }

  for (int s = 0; s < K; ++s) {
    // this step reads buffer cb and writes buffer nb (offsets into buf0)
    const int cb = (s & 1) ? BUF : 0, nb = BUF - cb;
    if (s < a.n_inj) {
      // the step's injections, 32 walkers at a time in walker order
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const int* cells = a.cell + (long long)s * a.W;
        const T* amts = a.amt + (long long)s * a.W;
        for (int w0 = 0; w0 < a.W; w0 += 32) {
          const int w = w0 + lane;
          int key = -1, off = 0;
          T am = T(0);
          if (w < a.W && cells[w] >= 0) {
            const int k = cells[w];
            const int r = k / Ly - gx0, cc = k % Ly - gy0;
            if (r >= 0 && r < ROWS && cc >= 0 && cc < NT) {
              key = k;
              am = amts[w];
              off = cb + r * P + shift(r) + cc;
            }
          }
          amt_s[lane] = am;
          const unsigned same = __match_any_sync(0xffffffffu, key);
          __syncwarp();
          if (key >= 0 && lane == __ffs(same) - 1) {
            T v = buf0[off];
            for (unsigned m = same; m; m &= m - 1)
              v = add_rn(v, amt_s[__ffs(m) - 1]);
            buf0[off] = v;
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }

    const T c0 = w_s[0][s], ax = w_s[1][s], ay = w_s[2][s], axy = w_s[3][s];
    const bool last = s == K - 1;
    const int lo = s + 1, hi = ROWS - s - 1;   // rows computed this step
    // the field's rows among them: cells off the field are never read by a
    // cell on it (a boundary cell keeps its value), so they are skipped
    const int r0 = lo > -gx0 ? lo : -gx0;
    const int r1 = hi < Lx - gx0 ? hi : Lx - gx0;
    if (col_in && c >= lo && c < NT - s - 1 && r0 < r1) {
      // box rows [rt0, rt1) are this step's frame rows of the tile (none
      // when the frame is not kept); rows [ri0, ri0 + ni) the field's
      // interior rows (none in a boundary column)
      const int rt0 = K, nt = (a.keep || last) && col_tile ? ROWS - 2 * K : 0;
      const int ri0 = 1 - gx0, ni = col_edge || Lx < 3 ? 0 : Lx - 2;
      const long long g_r0 = (long long)(gx0 + r0) * Ly + gy;
      T* fp = a.out + (a.keep ? s * LxLy : 0) + g_r0;
      const T* sp = SRC && !last ? a.src + (s + 1) * LxLy + g_r0 : nullptr;
      const int to_nxt = nb - cb;
      // the window holds rows r - 1, r, r + 1; row r + 2 (at most row
      // ROWS, the spare) is loaded before row r is stored, so its latency
      // overlaps the update
      int sh = shift(r0 - 1);
      const int off_u = cb + (r0 - 1) * P + sh + c;
      sh = (sh + dly) & (V - 1);
      int off_m = cb + r0 * P + sh + c;
      sh = (sh + dly) & (V - 1);
      int off_d = cb + (r0 + 1) * P + sh + c;
      T ul = buf0[off_u - 1], u = buf0[off_u], ur = buf0[off_u + 1];
      T ml = buf0[off_m - 1], m = buf0[off_m], mr = buf0[off_m + 1];
      T dl = buf0[off_d - 1], d = buf0[off_d], dr = buf0[off_d + 1];
      auto rows = [&](auto eight, auto store_nxt) {
#pragma unroll 4
        for (int r = r0; r < r1; ++r) {
          const int sh_n = (sh + dly) & (V - 1);
          const int off_n = off_d + P + sh_n - sh;
          sh = sh_n;
          const T nl = buf0[off_n - 1], nc = buf0[off_n],
                  nr = buf0[off_n + 1];
          T v = cell_update<T, decltype(eight)::value>(
              ul, u, ur, ml, m, mr, dl, d, dr, c0, ax, ay, axy);
          if ((unsigned)(r - ri0) >= (unsigned)ni) v = m;
          if constexpr (decltype(store_nxt)::value) {
            if constexpr (SRC) {
              buf0[off_m + to_nxt] = add_rn(v, *sp);
              sp += Ly;
            } else {
              buf0[off_m + to_nxt] = v;
            }
          }
          if ((unsigned)(r - rt0) < (unsigned)nt) *fp = v;
          fp += Ly;
          ul = ml; u = m; ur = mr;
          ml = dl; m = d; mr = dr;
          dl = nl; d = nc; dr = nr;
          off_m = off_d;
          off_d = off_n;
        }
      };
      if (axy != T(0)) {
        if (last) rows(std::true_type{}, std::false_type{});
        else rows(std::true_type{}, std::true_type{});
      } else {
        if (last) rows(std::false_type{}, std::false_type{});
        else rows(std::false_type{}, std::true_type{});
      }
    }
    if (!last) __syncthreads();
  }
}

// one buffer: the box's rows and a spare one, each NT + V cells
template <typename T>
constexpr size_t box_bytes() {
  return (size_t)(Box<T>::ROWS + 1) * (NT + 16 / sizeof(T)) * sizeof(T);
}

template <typename T>
int rollout(const T* C, T* out, T* scratch, const T* src, const int* cell,
            const T* amt, int W, int n_inj, int Lx, int Ly, int n,
            const double* weights, int keep, int* launched, void* stream) {
  constexpr int ROWS = Box<T>::ROWS, KMAX = Box<T>::KMAX;
  *launched = 0;
  const int L = (n + KMAX - 1) / KMAX;
  if (Lx < 1 || Ly < 1 || n < 1 || (long long)Lx * Ly >= (1LL << 31) ||
      (cell == nullptr) != (amt == nullptr) || n_inj < 0 || n_inj > n ||
      (cell == nullptr) != (n_inj == 0) || (cell != nullptr && W < 1) ||
      (!keep && L > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  // two boxes a block, and the whole carveout for shared memory so that
  // two blocks fit an SM
  auto kernel = src != nullptr ? rollout_kernel<T, true>
                                : rollout_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * box_bytes<T>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long LxLy = (long long)Lx * Ly;
  const T* in = C;
  for (int j = 0; j < L; ++j) {
    const int s0 = j * KMAX, K = n - s0 < KMAX ? n - s0 : KMAX;
    Launch<T> a;
    a.in = in;
    // without frames the launches ping-pong so that the last writes `out`
    a.out = keep ? out + s0 * LxLy : ((L - 1 - j) % 2 == 0 ? out : scratch);
    a.src = src != nullptr ? src + s0 * LxLy : nullptr;
    const int inj = n_inj - s0 < 0 ? 0 : (n_inj - s0 < K ? n_inj - s0 : K);
    a.cell = inj > 0 ? cell + (long long)s0 * W : nullptr;
    a.amt = inj > 0 ? amt + (long long)s0 * W : nullptr;
    a.W = W;
    a.n_inj = inj;
    a.Lx = Lx;
    a.Ly = Ly;
    a.K = K;
    a.keep = keep;
    for (int t = 0; t < KCAP; ++t) {
      const double* w = weights + 3 * (s0 + (t < K ? t : 0));
      // c0 in double, rounded once, as the plain version's Python scalar
      a.c0[t] = (T)(1.0 - 2.0 * w[0] - 2.0 * w[1] - 4.0 * w[2]);
      a.ax[t] = (T)w[0];
      a.ay[t] = (T)w[1];
      a.axy[t] = (T)w[2];
    }
    const int TX = ROWS - 2 * K, TY = NT - 2 * K;
    const dim3 grid((Ly + TY - 1) / TY, (Lx + TX - 1) / TX);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<grid, NT, (K == 1 ? 1 : 2) * box_bytes<T>(), st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    in = keep ? a.out + (K - 1) * LxLy : a.out;
  }
  return 0;
}

}  // namespace

extern "C" {

// n steps of the field C (Lx, Ly) row-major. weights: n x 3 doubles (ax,
// ay, axy) a step; c0 = 1 - 2ax - 2ay - 4axy is formed in double and rounded
// once, as the plain version's Python scalar is. src: (n, Lx, Ly) dense
// sources or null; cell/amt: (n_inj, W) flat cells (< 0: none) and amounts
// added before steps 0 .. n_inj - 1, or null. keep: out is (n, Lx, Ly) and
// receives every frame; else out is (Lx, Ly) and receives the last, and
// scratch, an (Lx, Ly) buffer, is needed when n > KMAX. No output may overlap
// C. *launched: the kernel launches made. Returns the first CUDA error.
int stencil_rollout_f32(const float* C, float* out, float* scratch,
                        const float* src, const int* cell, const float* amt,
                        int W, int n_inj, int Lx, int Ly, int n,
                        const double* weights, int keep, int* launched,
                        void* stream) {
  return rollout<float>(C, out, scratch, src, cell, amt, W, n_inj, Lx, Ly, n,
                        weights, keep, launched, stream);
}

int stencil_rollout_f64(const double* C, double* out, double* scratch,
                        const double* src, const int* cell, const double* amt,
                        int W, int n_inj, int Lx, int Ly, int n,
                        const double* weights, int keep, int* launched,
                        void* stream) {
  return rollout<double>(C, out, scratch, src, cell, amt, W, n_inj, Lx, Ly,
                         n, weights, keep, launched, stream);
}

const char* stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
