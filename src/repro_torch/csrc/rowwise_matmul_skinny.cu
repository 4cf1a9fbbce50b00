// The skinny design of the row-wise matmul: up to 16 rows, fp32, bf16 or
// int8; the wrapper sends it fp32 calls of M <= 16 and bf16 and int8
// calls of M <= 4, where it beats the other designs (see
// rowwise_matmul.cu for the whole kernel and its TPU origin).
//
// Bound: bytes. At M <= 16 every weight element is used by at most 16
// rows, far below the card's ~20 (fp32) to ~295 (bf16) operations per
// byte, so the least time is one read of w. The design streams w once:
//  * A block owns 64 columns. A lane loads V of them (4 fp32 or 8 bf16
//    in 16 bytes, 8 int8 in 8 bytes), so a warp reads 2-4 rows of the
//    tile per instruction, each a whole 128- or 256-byte run. A thread
//    keeps 4 to 8 loads in flight, packed as loaded: the next four rows
//    load while it multiplies the last four, and its first loads go out
//    while x is staged. Bytes in flight set the rate here: on the H100,
//    four unpacked loads a thread streamed bf16 at 1.2 TB/s (fp32, with
//    twice the blocks resident, at 2.65 TB/s).
//  * Every one of the M rows' partial sums stays in registers
//    (MAXM x V per thread); x, the small operand, is staged in shared
//    memory (normalized there for the norm prologue) and broadcast.
//  * K is split across blocks so that the grid is about one wave of
//    two blocks per SM, each split at least 256 rows: N = 2560 gives 40
//    column tiles and 7 splits of 384 rows. A block sums its lanes'
//    rows with shuffles, its warps through shared memory in a fixed
//    order, and writes its partial (M x 64) to a workspace. The block
//    that finishes a column tile last, found with a counter (threadfence,
//    then one atomicAdd per block), sums the splits in split order and
//    runs the epilogue, then zeroes the counter for the next call. No
//    atomic touches a sum, so results repeat bitwise from run to run.
//  * Gated: the gate weight's blocks are a third grid axis; a column
//    tile's counter waits for both weights' splits.
#include <cstdint>

#include "rowwise_matmul.cuh"

namespace {

constexpr int STHREADS = 256, SWARPS = STHREADS / 32, SUB = 512, NB = 64;

template <typename T> struct Skinny;
template <> struct Skinny<float> {
  static constexpr int V = 4;  // columns per lane, one 16-byte load
  using Acc = float;
  using Vec = float4;
};
template <> struct Skinny<__nv_bfloat16> {
  static constexpr int V = 8;
  using Acc = float;
  using Vec = uint4;
};
template <> struct Skinny<int8_t> {
  static constexpr int V = 8;  // one 8-byte load
  using Acc = int;
  using Vec = uint2;
};

__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int as_f(int8_t v) { return v; }

template <typename T, int MAXM>
__global__ void __launch_bounds__(STHREADS)
    rowwise_matmul_kernel_skinny(const rk::MatmulArgs a) {
  using S = Skinny<T>;
  using Acc = typename S::Acc;
  constexpr int V = S::V;
  constexpr int LPR = NB / V;             // lanes per row of the tile
  constexpr int RPW = 32 / LPR;           // rows a warp loads at once
  constexpr int RSTEP = SWARPS * RPW;     // rows a block loads at once
  constexpr int RG = MAXM < 4 ? MAXM : 4;  // rows per reduction round
  constexpr bool INT8 = sizeof(T) == 1;
  __shared__ Acc xs[SUB][MAXM];
  __shared__ Acc red[SWARPS][RG][NB];
  __shared__ rk::RowStats stats[MAXM];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, cl = (lane % LPR) * V;
  const int tile = blockIdx.x, split = blockIdx.y, z = blockIdx.z;
  const int n0 = tile * NB, col0 = n0 + cl;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(z ? a.wg : a.w);
  const long long ldw = z ? a.ldwg : a.ldw;
  const int k_lo = split * a.kc, k_hi = min(a.k, k_lo + a.kc);
  const bool vec = (reinterpret_cast<size_t>(w) % sizeof(typename S::Vec)) ==
                       0 &&
                   (ldw * sizeof(T)) % sizeof(typename S::Vec) == 0 &&
                   col0 + V <= a.n;

  if (a.norm != rk::NORM_NONE) {
    for (int r = warp; r < a.m; r += SWARPS) {
      const rk::RowStats s = rk::row_stats(x + r * a.ldx, a.k, a.norm, a.eps);
      if (lane == 0) stats[r] = s;
    }
  }

  Acc acc[MAXM][V];
#pragma unroll
  for (int i = 0; i < MAXM; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0;

  // U rows of w in flight per thread (RSTEP apart), packed as loaded;
  // the next U are loaded while these are multiplied
  using Vec = typename S::Vec;
  constexpr int U = 4;
  auto load_rows = [&](Vec (&raw)[U], int r0, int rows, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RSTEP;
      const T* src = w + (s0 + r) * ldw + col0;
      if (r < rows && vec) {
        raw[u] = *reinterpret_cast<const Vec*>(src);
      } else {
        Vec v{};
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (r < rows && col0 + j < a.n) e[j] = src[j];
        raw[u] = v;
      }
    }
  };
  auto fma_rows = [&](const Vec (&raw)[U], int r0, int rows) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RSTEP;
      if (r >= rows) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      Acc wf[V];
#pragma unroll
      for (int j = 0; j < V; ++j) wf[j] = as_f(e[j]);
#pragma unroll
      for (int i = 0; i < MAXM; ++i) {
        const Acc xv = xs[r][i];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] += xv * wf[j];
      }
    }
  };

  for (int s0 = k_lo; s0 < k_hi; s0 += SUB) {
    const int rows = min(SUB, k_hi - s0);
    int r0 = warp * RPW + sub;
    Vec raw[U];
    load_rows(raw, r0, rows, s0);  // in flight while x is staged
    __syncthreads();  // stats ready; the last sub-chunk's xs consumed
    for (int i = tid; i < rows * MAXM; i += STHREADS) {
      const int r = i / MAXM, mm = i % MAXM, kk = s0 + r;
      Acc v = 0;
      if (mm < a.m) {
        if constexpr (INT8) {
          v = x[mm * a.ldx + kk];
        } else {
          float f = as_f(x[mm * a.ldx + kk]);
          if (a.norm != rk::NORM_NONE)
            f = rk::norm_elem<T>(f, stats[mm], rk::gain(a, kk));
          v = f;
        }
      }
      xs[r][mm] = v;
    }
    __syncthreads();
    while (r0 < rows) {
      Vec cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = raw[u];
      const int next = r0 + U * RSTEP;
      if (next < rows) load_rows(raw, next, rows, s0);
      fma_rows(cur, r0, rows);
      r0 = next;
    }
  }

  // the lanes of a warp that share columns hold different rows of K:
  // sum them with a butterfly (every lane ends with the same sum, the
  // same on every run)
#pragma unroll
  for (int off = LPR; off < 32; off *= 2)
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  // the block's partial: warps summed in order, RG rows a round
  Acc* part = static_cast<Acc*>(a.work) +
              (static_cast<long long>(z * a.splits + split) * a.m) * a.n;
#pragma unroll
  for (int i0 = 0; i0 < MAXM; i0 += RG) {
    if (i0 >= a.m) break;
    __syncthreads();
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) red[warp][i][cl + j] = acc[i0 + i][j];
    }
    __syncthreads();
    for (int e = tid; e < RG * NB; e += STHREADS) {
      const int i = e / NB, c = e % NB;
      if (i0 + i >= a.m || n0 + c >= a.n) continue;
      Acc s = red[0][i][c];
#pragma unroll
      for (int q = 1; q < SWARPS; ++q) s += red[q][i][c];
      part[(i0 + i) * a.n + n0 + c] = s;
    }
  }

  // the last block of this column tile to finish sums the splits, in
  // split order, a thread per output element
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int total = a.splits * (a.wg ? 2 : 1);
    last = atomicAdd(&a.counters[tile], 1) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const Acc* work = static_cast<const Acc*>(a.work);
  const long long plane = static_cast<long long>(a.m) * a.n;
  for (int e = tid; e < a.m * NB; e += STHREADS) {
    const int row = e / NB, col = n0 + e % NB;
    if (col >= a.n) continue;
    const Acc* p = work + static_cast<long long>(row) * a.n + col;
    Acc h = 0, g = 0;
#pragma unroll 8
    for (int s = 0; s < a.splits; ++s) h += __ldcg(p + s * plane);
    if (a.wg) {
      p += a.splits * plane;
#pragma unroll 8
      for (int s = 0; s < a.splits; ++s) g += __ldcg(p + s * plane);
    }
    const float v =
        a.wg ? rk::post<true, INT8>(a, static_cast<float>(h),
                                    static_cast<float>(g), row, col)
             : rk::post<false, INT8>(a, static_cast<float>(h), 0.f, row, col);
    rk::finish(a, row, col, v);
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <typename T>
void launch(const rk::MatmulArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n + NB - 1) / NB, a.splits, a.wg ? 2 : 1);
  if (a.m <= 4)
    rowwise_matmul_kernel_skinny<T, 4><<<grid, STHREADS, 0, stream>>>(a);
  else
    rowwise_matmul_kernel_skinny<T, 16><<<grid, STHREADS, 0, stream>>>(a);
}

}  // namespace

void rk_launch_skinny(const rk::MatmulArgs& a, cudaStream_t stream) {
  if (a.dtype == rk::I8)
    launch<int8_t>(a, stream);
  else if (a.dtype == rk::BF16)
    launch<__nv_bfloat16>(a, stream);
  else
    launch<float>(a, stream);
}

// The kernels and constants of this file, for the shared-memory audit
// (analysis/smem.py): as rk_query_wgmma.
extern "C" const char* rk_query_skinny(int i, long long* out, int* err) {
  *err = 0;
  if (i < 0) {
    const long long c[] = {STHREADS, SUB, NB};
    return rk::query_constants(c, 3, "STHREADS,SUB,NB", out);
  }
  switch (i) {
    case 0:
      *err = rk::query_kernel(rowwise_matmul_kernel_skinny<float, 4>,
                              STHREADS, 1, 0, out);
      return "rowwise_matmul_kernel_skinny<fp32,4>";
    case 1:
      *err = rk::query_kernel(rowwise_matmul_kernel_skinny<float, 16>,
                              STHREADS, 1, 0, out);
      return "rowwise_matmul_kernel_skinny<fp32,16>";
    case 2:
      *err = rk::query_kernel(rowwise_matmul_kernel_skinny<__nv_bfloat16, 4>,
                              STHREADS, 1, 0, out);
      return "rowwise_matmul_kernel_skinny<bf16,4>";
    case 3:
      *err = rk::query_kernel(rowwise_matmul_kernel_skinny<__nv_bfloat16, 16>,
                              STHREADS, 1, 0, out);
      return "rowwise_matmul_kernel_skinny<bf16,16>";
    case 4:
      *err = rk::query_kernel(rowwise_matmul_kernel_skinny<int8_t, 4>,
                              STHREADS, 1, 0, out);
      return "rowwise_matmul_kernel_skinny<int8,4>";
    case 5:
      *err = rk::query_kernel(rowwise_matmul_kernel_skinny<int8_t, 16>,
                              STHREADS, 1, 0, out);
      return "rowwise_matmul_kernel_skinny<int8,16>";
    default:
      return nullptr;
  }
}
