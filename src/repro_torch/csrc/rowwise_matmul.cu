// Row-wise matmul with the fused sublayer pipeline, for Hopper: the C
// entry point, and the fp32 design for M > 16.
//
// Replaces the TPU kernel rowwise_matmul_p
// (src/repro/kernels/rowwise_matmul.py: body _pipeline_kernel, epilogue
// _apply_epilogue), every mode: optional LayerNorm/RMSNorm prologue,
// x(M,K) @ w(K,N) accumulated in fp32 (int32 for int8 W8A8), then int8
// dequant -> bias -> activation (or the gated act(x@wg + bg) *
// (x@w + b)) -> residual -> cast to the output dtype. The wrapper
// (kernels/rowwise_matmul.py) picks one of three designs by M and dtype
// (rowwise_matmul.cuh); each call is one launch.
//
// What all three do against what the TPU kernel relied on:
//  * The TPU carried the accumulator across its innermost k grid axis.
//    Here a block loops over K itself (ffma, wgmma), or the K splits of
//    a column tile are summed by the last block to finish, in a fixed
//    order (skinny), so the epilogue runs once per element.
//  * The TPU norm prologue held a full-K row panel in VMEM. Here a
//    block first takes its rows' statistics in fp32 (rk::row_stats, one
//    warp per row, rows read through L2), then normalizes each x
//    element as its tile enters shared memory, rounding it to the
//    streaming dtype before the dot as the TPU did. No K limit.
//  * The TPU padded ragged shapes in HBM. Here every load and store is
//    masked at the edge (K=48 patch-embed, N=1000 head, M=49B rows).
//  * Operands are read with their row strides, so the halves of a
//    pre-fused [wg | wi] panel need no copy.
//
// The ffma design (fp32, M > 16). Bound: operations, on the CUDA cores
// (67 TFLOP/s): the products stay exact fp32 FFMA, no TF32, so fp32
// parity holds at 1e-4. A block owns a 64 x 64 output tile, each of its
// 256 threads 4 x 4 outputs (x 2 gated, with two accumulators) in
// registers, read from shared memory as float4s. The next 16-deep k
// tile is loaded into registers while the current one is multiplied
// from shared memory, then stored into the other of two shared buffers:
// one barrier per k tile. Three blocks share an SM (two gated), so one
// block's fill and epilogue overlap the others' products. A 128 x 128
// tile (8 x 8 a thread, one block per SM) measured no faster at
// RWKV6-3B's prefill shapes and slower at Swin-T's, where its grids
// leave SMs idle (PERF.md, the matmul's findings).
#include "rowwise_matmul.cuh"

namespace {

constexpr int FT = 64, FK = 16, FTHREADS = 256;  // tile, k tile, threads

struct F4 {
  float v[4];
};

// Four consecutive floats of row `row` from column `col` of an (rows,
// cols) operand with row stride ld, masked at the edges; one 16-byte load
// where the whole quad is inside and aligned.
__device__ __forceinline__ F4 load4(const float* p, long long ld, int row,
                                    int col, int rows, int cols, bool vec) {
  F4 r = {{0.f, 0.f, 0.f, 0.f}};
  if (row >= rows) return r;
  const float* src = p + row * ld + col;
  if (vec && col + 3 < cols) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    r.v[0] = v.x, r.v[1] = v.y, r.v[2] = v.z, r.v[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < cols) r.v[j] = __ldg(src + j);
  }
  return r;
}

__device__ __forceinline__ void store4(float* dst, const F4& q) {
  *reinterpret_cast<float4*>(dst) = make_float4(q.v[0], q.v[1], q.v[2],
                                                q.v[3]);
}

__device__ __forceinline__ F4 read4(const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  return {{v.x, v.y, v.z, v.w}};
}

// Thread (ty, tx) of 16 x 16 owns rows 4 ty .. 4 ty + 3 and columns
// 4 tx .. 4 tx + 3 of the tile. Loads: thread t brings x row t / 4,
// columns 4 (t % 4) .. + 3 of the k tile (stored transposed), and w row
// t / 16, columns 4 (t % 16) .. + 3.
template <bool GATED>
__global__ void __launch_bounds__(FTHREADS, GATED ? 2 : 3)
    rowwise_matmul_kernel(const rk::MatmulArgs a) {
  __shared__ __align__(16) float xs[2][FK][FT + 4];  // x tile, transposed
  __shared__ __align__(16) float ws[2][FK][FT];
  __shared__ __align__(16) float wgs[GATED ? 2 : 1][GATED ? FK : 1][FT];
  __shared__ rk::RowStats stats[FT];

  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const float* wg = static_cast<const float*>(a.wg);
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool norm = a.norm != rk::NORM_NONE;
  auto aligned = [](const void* p, long long ld) {
    return (reinterpret_cast<size_t>(p) & 15) == 0 && (ld & 3) == 0;
  };
  const bool vx = aligned(x, a.ldx), vw = aligned(w, a.ldw),
             vwg = GATED && aligned(wg, a.ldwg);

  if (norm) {
    // each of the 8 warps takes 8 rows, their loads interleaved
    rk::row_stats_rows<8>(x, a.ldx, m0 + 8 * (tid / 32), a.m, a.k, a.norm,
                          a.eps, stats + 8 * (tid / 32));
    __syncthreads();
  }

  const int xr = tid / 4, xc = 4 * (tid % 4);    // this thread's x quad
  const int wr = tid / 16, wc = 4 * (tid % 16);  // and w quad
  F4 rx, rw, rwg;
  auto load_tile = [&](int k0) {
    rx = load4(x, a.ldx, m0 + xr, k0 + xc, a.m, a.k, vx);
    rw = load4(w, a.ldw, k0 + wr, n0 + wc, a.k, a.n, vw);
    if constexpr (GATED) rwg = load4(wg, a.ldwg, k0 + wr, n0 + wc, a.k, a.n,
                                     vwg);
  };
  auto store_tile = [&](int buf, int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = rx.v[j];
      if (norm && m0 + xr < a.m && k0 + xc + j < a.k)
        v = rk::norm_elem<float>(v, stats[xr], rk::gain(a, k0 + xc + j));
      xs[buf][xc + j][xr] = v;
    }
    store4(&ws[buf][wr][wc], rw);
    if constexpr (GATED) store4(&wgs[buf][wr][wc], rwg);
  };

  float acc[4][4] = {}, accg[GATED ? 4 : 1][GATED ? 4 : 1] = {};
  const int nt = (a.k + FK - 1) / FK;
  load_tile(0);
  store_tile(0, 0);
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) load_tile((t + 1) * FK);
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const F4 xa = read4(&xs[buf][kk][4 * ty]);
      const F4 wb = read4(&ws[buf][kk][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(xa.v[i], wb.v[j], acc[i][j]);
      if constexpr (GATED) {
        const F4 gb = read4(&wgs[buf][kk][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            accg[i][j] = fmaf(xa.v[i], gb.v[j], accg[i][j]);
      }
    }
    if (t + 1 < nt) store_tile(buf ^ 1, (t + 1) * FK);
    __syncthreads();
  }

  // the post-processing unit, once per output element
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col >= a.n) continue;
      const float g = GATED ? accg[GATED ? i : 0][GATED ? j : 0] : 0.f;
      rk::finish(a, row, col, rk::post<GATED, false>(a, acc[i][j], g, row,
                                                     col));
    }
  }
}

}  // namespace

void rk_launch_ffma(const rk::MatmulArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n + FT - 1) / FT, (a.m + FT - 1) / FT);
  if (a.wg)
    rowwise_matmul_kernel<true><<<grid, FTHREADS, 0, stream>>>(a);
  else
    rowwise_matmul_kernel<false><<<grid, FTHREADS, 0, stream>>>(a);
}

// Designs, as the wrapper numbers them.
enum Design { FFMA = 0, SKINNY = 1, WGMMA = 2 };

extern "C" int rk_rowwise_matmul(
    const void* x, const void* w, const void* wg, const void* bias,
    const void* bias_g, const void* res, const void* gamma, const void* beta,
    const void* x_scale, const void* w_scale, const void* wg_scale,
    void* out, void* work, void* counters, long long ldx, long long ldw,
    long long ldwg, long long ldres, long long ldout, int m, int n, int k,
    int norm, int act, int dtype, int res_dt, int out_dt, int vec_f32,
    int splits, int kc, float eps, int design, void* stream) {
  rk::MatmulArgs a;
  a.x = x;
  a.w = w;
  a.wg = wg;
  a.bias = bias;
  a.bias_g = bias_g;
  a.res = res;
  a.gamma = gamma;
  a.beta = beta;
  a.x_scale = static_cast<const float*>(x_scale);
  a.w_scale = static_cast<const float*>(w_scale);
  a.wg_scale = static_cast<const float*>(wg_scale);
  a.out = out;
  a.work = work;
  a.counters = static_cast<int*>(counters);
  a.ldx = ldx;
  a.ldw = ldw;
  a.ldwg = ldwg;
  a.ldres = ldres;
  a.ldout = ldout;
  a.m = m;
  a.n = n;
  a.k = k;
  a.norm = norm;
  a.act = act;
  a.dtype = dtype;
  a.res_dt = res_dt;
  a.out_dt = out_dt;
  a.vec_f32 = vec_f32;
  a.splits = splits;
  a.kc = kc;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case SKINNY:
      rk_launch_skinny(a, s);
      break;
    case WGMMA: {
      const int err = rk_launch_wgmma(a, s);
      if (err) return err;
      break;
    }
    default:
      if (dtype != rk::F32) return static_cast<int>(cudaErrorInvalidValue);
      rk_launch_ffma(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
