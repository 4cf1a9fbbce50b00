// Row-wise matmul with the fused sublayer pipeline, for Hopper.
//
// Replaces the TPU kernel rowwise_matmul_p
// (src/repro/kernels/rowwise_matmul.py: body _pipeline_kernel, epilogue
// _apply_epilogue), float modes: optional LayerNorm/RMSNorm prologue,
// x(M,K) @ w(K,N) accumulated in fp32, then bias -> activation (or the
// gated act(x@wg + bg) * (x@w + b)) -> residual -> cast to the output
// dtype. The int8 mode is not ported yet (the Python wrapper raises).
//
// Design, against what the TPU kernel relied on:
//  * The TPU carried the accumulator across its innermost k grid axis.
//    Here one block owns a 64 x 64 output tile and loops over the
//    whole K itself, so the epilogue runs once after the loop and no
//    block ever needs another's partial sums.
//  * The TPU norm prologue held a full-K row panel in VMEM. A block's
//    shared memory cannot hold 64 rows of K=768 fp32 beside its tiles,
//    so the block first takes each of its rows' statistics in fp32
//    (rk::row_stats, one warp per row, reading the rows through L2),
//    then normalizes every x element as its tile enters shared memory,
//    rounding it to the streaming dtype before the dot as the TPU did.
//    There is no K above which the prologue cannot run.
//  * The TPU padded ragged shapes in HBM. Here every load and store is
//    masked at the edge (K=48 patch-embed, N=1000 head, M=49B rows).
//  * Operands are read with their row strides, so the halves of a
//    pre-fused [wg | wi] panel need no copy.
//
// Bound: operations at Swin-T's shapes (the products run on the CUDA
// cores in fp32 FFMA, also for bf16 inputs, which keeps fp32 parity:
// no TF32). Each thread holds a 4 x 4 (x2 when gated) accumulator tile
// in registers and reads 8 operands from shared memory per 16 FMAs.
// The global loads are not double-buffered; the small tile's few
// registers let several blocks share an SM and hide their latency (a
// 128 x 128 tile with 8 x 8 per thread runs slower on the H100 at 2
// blocks per SM, see PERF.md). wgmma/TMA pipelines and split-K are
// later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4, TN = 4;

struct MatmulArgs {
  const void* x;
  const void* w;
  const void* wg;
  const float* bias;
  const float* bias_g;
  const void* res;
  const float* gamma;
  const float* beta;
  void* out;
  long long ldx, ldw, ldwg, ldres, ldout;
  int m, n, k, norm, act, res_f32, out_f32;
  float eps;
};

// A BM x BN output tile per block; thread (ty, tx) of 16 x 16 owns rows
// ty + 16 i and columns tx + 16 j, so reads of a shared tile row are
// conflict-free and stores coalesce in runs of 16.
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
    rowwise_matmul_kernel(const MatmulArgs a) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed, padded
  __shared__ __align__(16) float ws[BK][BN];
  __shared__ __align__(16) float wgs[GATED ? BK : 1][BN];
  __shared__ rk::RowStats stats[BM];

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* wg = static_cast<const T*>(a.wg);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  if (a.norm != rk::NORM_NONE) {
    for (int r = tid / 32; r < BM; r += THREADS / 32) {
      const int row = m0 + r;
      if (row < a.m) {
        const rk::RowStats s = rk::row_stats(x + row * a.ldx, a.k, a.norm,
                                             a.eps);
        if ((tid & 31) == 0) stats[r] = s;
      }
    }
    __syncthreads();
  }

  float acc[TM][TN] = {};
  float accg[GATED ? TM : 1][GATED ? TN : 1] = {};

  for (int k0 = 0; k0 < a.k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, row = m0 + r, col = k0 + c;
      float v = 0.f;
      if (row < a.m && col < a.k) {
        v = rk::to_f32(x[row * a.ldx + col]);
        if (a.norm != rk::NORM_NONE)
          v = rk::round_to<T>(rk::normalize(v, stats[r], a.gamma, a.beta,
                                            col));
      }
      xs[c][r] = v;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, row = k0 + r, col = n0 + c;
      const bool in = row < a.k && col < a.n;
      ws[r][c] = in ? rk::to_f32(w[row * a.ldw + col]) : 0.f;
      if constexpr (GATED)
        wgs[r][c] = in ? rk::to_f32(wg[row * a.ldwg + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xa[TM], wb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xa[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wb[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
      if constexpr (GATED) {
#pragma unroll
        for (int j = 0; j < TN; ++j) wb[j] = wgs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            accg[i][j] = fmaf(xa[i], wb[j], accg[i][j]);
      }
    }
    __syncthreads();
  }

  // The post-processing unit, once per output element.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= a.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= a.n) continue;
      float h = acc[i][j];
      if (a.bias) h += a.bias[col];
      if constexpr (GATED) {
        float g = accg[i][j];
        if (a.bias_g) g += a.bias_g[col];
        h = rk::activate(g, a.act) * h;
      } else {
        h = rk::activate(h, a.act);
      }
      if (a.res) {
        const long long o = row * a.ldres + col;
        h += a.res_f32 ? static_cast<const float*>(a.res)[o]
                       : rk::to_f32(static_cast<const T*>(a.res)[o]);
      }
      const long long o = row * a.ldout + col;
      if (a.out_f32)
        static_cast<float*>(a.out)[o] = h;
      else
        static_cast<T*>(a.out)[o] = rk::from_f32<T>(h);
    }
  }
}

template <typename T>
void launch(const MatmulArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  if (a.wg)
    rowwise_matmul_kernel<T, true><<<grid, THREADS, 0, stream>>>(a);
  else
    rowwise_matmul_kernel<T, false><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" int rk_rowwise_matmul(
    const void* x, const void* w, const void* wg, const void* bias,
    const void* bias_g, const void* res, const void* gamma, const void* beta,
    void* out, long long ldx, long long ldw, long long ldwg, long long ldres,
    long long ldout, int m, int n, int k, int norm, int act, int res_f32,
    int out_f32, float eps, int dtype, void* stream) {
  MatmulArgs a;
  a.x = x;
  a.w = w;
  a.wg = wg;
  a.bias = static_cast<const float*>(bias);
  a.bias_g = static_cast<const float*>(bias_g);
  a.res = res;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = out;
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
  a.res_f32 = res_f32;
  a.out_f32 = out_f32;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rk::BF16)
    launch<__nv_bfloat16>(a, s);
  else
    launch<float>(a, s);
  return static_cast<int>(cudaGetLastError());
}
