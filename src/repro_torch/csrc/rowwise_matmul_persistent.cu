// The persistent design of the row-wise matmul: the bf16 calls of more
// rows than the skinny design takes, with no norm prologue and operands
// TMA can take (kernels/rowwise_matmul.py::pick_design; rowwise_matmul.cu
// has the whole kernel and its TPU origin). The wgmma design
// (rowwise_matmul_wgmma.cu) keeps int8, the norm prologue and operands
// TMA cannot take.
//
// Bound: operations at the LM prefill's shapes (989 TFLOP/s bf16 on the
// tensor cores), as long as L2 feeds the SMs and the epilogue does not
// hold the tensor cores: on an H100 the products of a 128 x 256 tile ran
// at ~95% of the SM's peak between epilogues, and L2 served the SMs' TMA
// loads at ~5 TB/s (probes, PERF.md). The design:
//  * Persistent clusters of 2 blocks, min(units, clusters the card
//    holds), each walking unit indices with a stride of the grid. A unit
//    is 2 adjacent row panels (one a block) by one column panel; an index
//    maps to a unit in groups of G = min(units along M, GROUP / 2) that
//    advance along N together (origin below), so a wave covers 2 G row
//    panels x about 66 / G column panels and the L2 serves the operands.
//  * The two blocks of a cluster share the weights' tile: each loads
//    half of its 64-column panels by TMA multicast into both blocks'
//    stage, so a block draws 32 KB a stage from L2 instead of 48.
//  * Tiles of 128 x 256 where N is a multiple of 256, else 128 x 128;
//    gated 128 x 128 with two accumulators, w's and wg's. Warpgroup 0
//    produces (one thread issues every TMA load); warpgroups 1 and 2
//    each own 64 rows and issue m64n256k16 (m64n128k16) from shared
//    memory, one wgmma group in flight. setmaxnreg hands the producer's
//    registers (down to 40) to the consumers (up to 232).
//  * A ring of 4 stages of 64 K: the x tile (16 KB) and the weights'
//    (32 KB: 256 columns, or 128 of w and 128 of wg), TMA in the 128-byte
//    swizzle, full / empty mbarriers (an empty stage waits for the
//    consumers of both blocks of the cluster). The ring runs on across a
//    block's tiles: the producer fills the next tile's stages while the
//    consumers run the epilogue.
//  * Epilogue (epilogue below): through a 16 KB buffer of each
//    consumer's own, the post-processing unit in rk::post's order, the
//    residual in fp32 and the cast, 16-byte loads and stores.
// Each output element is summed in K order by one block: no split-K.
#include <cuda.h>

#include <cstdint>

#include "rowwise_matmul.cuh"
#include "tma.cuh"

namespace {

using namespace rk::sm90;

constexpr int TM = 128;                     // tile rows
constexpr int KB = 128;                     // bytes of K a stage
constexpr int KE = KB / 2;                  // K elements a stage (bf16)
constexpr int STAGES = 4;
constexpr int BN_WIDE = 256;                // tile columns, N % 256 == 0
constexpr int BN_NARROW = 128;              // else, and gated
constexpr int CLUSTER = 2;                  // blocks sharing a weight tile
constexpr int GROUP = 16;                   // row panels a group, at most
constexpr int A_BYTES = TM * KB;            // 16 KB
constexpr int STAGE_BYTES = A_BYTES + BN_WIDE * KB;  // 48 KB
constexpr int EPI_COLS = 64;                // columns an epilogue pass
constexpr int EPI_BYTES = 64 * EPI_COLS * 4;         // a consumer's buffer
constexpr int PTHREADS = 384;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + 2 * EPI_BYTES + 2 * STAGES * 8;

// The tile walk of one call. A unit is CLUSTER row panels (one a block
// of the cluster) by one column panel.
struct Walk {
  int units;   // units along M x column panels
  int mu;      // units along M: ceil(row panels / CLUSTER)
  int nt;      // column panels
  int group;   // units along M a group
  int vec;     // output and residual rows take 16-byte accesses
};

// The first row and column of block `rank`'s tile of unit `u`: groups
// of `group` units along M, each walked down its units, then along N
// (the last group may hold fewer). core/rowwise.py::persistent_walk
// mirrors it.
__device__ __forceinline__ void origin(const Walk& w, int u, int rank,
                                       int bn, int& m0, int& n0) {
  const int per_group = w.group * w.nt;
  const int g = u / per_group, in = u - g * per_group;
  const int first = g * w.group;
  const int rows = min(w.group, w.mu - first);
  m0 = ((first + in % rows) * CLUSTER + rank) * TM;
  n0 = (in / rows) * bn;
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A consumer warpgroup's release of a stage: an arrival on the stage's
// empty barrier in every block of the cluster, whose producers all write
// the stage (the weights' panels, multicast).
__device__ __forceinline__ void release(uint64_t* b) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r)
    asm volatile(
        "{\n.reg .b32 ra;\n"
        "mapa.shared::cluster.u32 ra, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(su32(b)),
        "r"(r)
        : "memory");
}

// One weight panel into this stage of every block of the cluster (TMA
// multicast), completing on each block's barrier at the same offset.
__device__ __forceinline__ void load_b(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  const uint16_t mask = (1u << CLUSTER) - 1;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          su32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(su32(bar)), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// The wgmma calls: bf16 with fp32 accumulators and B N-major (the
// transpose bit, the last immediate, set). scale_d 0 overwrites d (a
// tile's first product), else accumulates into it.
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    mma_n256(d, da, db, scale_d);
  else
    mma_n128(d, da, db, scale_d);
}

// Float i of row r of a consumer's epilogue buffer (64 rows of 64 fp32):
// 16-byte chunk c of row r sits at chunk c ^ 2 (r % 8).
__device__ __forceinline__ int epi_at(int r, int i) {
  return r * EPI_COLS + ((((i >> 2) ^ ((r & 7) << 1))) << 2) + (i & 3);
}

// The post-processing unit up to the residual (rk::post's order: bias,
// then the activation, or act(g + bias_g) * (h + bias)), the activation
// fixed at compile time and the biases loaded by the caller.
template <bool GATED, int ACT>
__device__ __forceinline__ float post_at(const rk::MatmulArgs& a, float h,
                                         float g, float b, float bg) {
  if (a.bias) h += b;
  if constexpr (GATED) {
    if (a.bias_g) g += bg;
    return rk::activate(g, ACT) * h;
  } else {
    return rk::activate(h, ACT);
  }
}

// The residual in fp32 (rv: a bf16 residual's 16 bytes, loaded ahead),
// the cast and one 16-byte store (two fp32), eight columns from col.
__device__ __forceinline__ void store8(const rk::MatmulArgs& a, int row,
                                       int col, float (&h)[8],
                                       const uint4& rv) {
  if (a.res) {
    if (a.res_dt == rk::F32) {
      const float4* r = reinterpret_cast<const float4*>(
          static_cast<const float*>(a.res) + row * a.ldres + col);
      const float4 r0 = r[0], r1 = r[1];
      h[0] += r0.x, h[1] += r0.y, h[2] += r0.z, h[3] += r0.w;
      h[4] += r1.x, h[5] += r1.y, h[6] += r1.z, h[7] += r1.w;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] += __bfloat162float(e[j]);
    }
  }
  if (a.out_dt == rk::F32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                          row * a.ldout + col);
    o[0] = make_float4(h[0], h[1], h[2], h[3]);
    o[1] = make_float4(h[4], h[5], h[6], h[7]);
  } else {
    uint4 u;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      e[j] = __floats2bfloat162_rn(h[2 * j], h[2 * j + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) +
                              row * a.ldout + col) = u;
  }
}

// The epilogue of a consumer warpgroup's 64 x BN tile (rows from row0,
// columns from n0), a pass of PASS columns at a time through its buffer:
// the pass's accumulators stored raw (fp32; gated, w's and wg's side by
// side), then each thread takes 8 columns of ITS rows: the
// post-processing unit, the residual, the cast, one 16-byte store a row.
// The passes are a loop and the fragment moves down by a pass's
// accumulators after each, the activation is a template argument, and
// each thread loads its columns' biases once a pass and its rows'
// residuals before the pass's barrier. So the code of the unit is
// compiled once a row, with no branch on the activation: unrolled over
// all 128 accumulators with the activation's switch inside, it missed
// the instruction cache and the epilogue took a third of the tile's time
// (probe, PERF.md).
template <bool GATED, int BN, int ACT, int NA>
__device__ __forceinline__ void epilogue(const rk::MatmulArgs& a,
                                         const Walk& wk, float (&acc)[NA],
                                         float (&accg)[GATED ? NA : 1],
                                         float* buf, int row0, int n0,
                                         int ci, int t) {
  constexpr int PASS = GATED ? 32 : 64;  // output columns a pass
  constexpr int PA = PASS / 2;           // accumulators a pass, a weight
  constexpr int TPR = PASS / 8;          // threads a row
  constexpr int RPI = 128 / TPR;         // rows apart
  constexpr int ITS = 64 / RPI;          // rows a thread
  constexpr int PF = NA > 64 ? 2 : ITS;  // residual rows loaded at once
  const int warp = t >> 5, lane = t & 31;
  const int p = t % TPR, rr = t / TPR;
#pragma unroll 1
  for (int q = 0; q < BN / PASS; ++q) {
    const int col = n0 + PASS * q + 8 * p;
    const bool vec = wk.vec && col + 8 <= a.n;
    float b[8], bg[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = col + j < a.n;
      b[j] = a.bias && in ? rk::vec_at(a.bias, col + j,
                                       a.vec_f32 & rk::VEC_BIAS) : 0.f;
      bg[j] = GATED && a.bias_g && in
                  ? rk::vec_at(a.bias_g, col + j, a.vec_f32 & rk::VEC_BIAS_G)
                  : 0.f;
    }
    // bf16 residuals of PF of the thread's rows at a time, the first
    // loaded before the barrier (PF = 2 where the 128 accumulators leave
    // no room for more)
    uint4 rv[PF];
    auto residuals = [&](int i0) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int row = row0 + rr + RPI * (i0 + i);
        rv[i] = make_uint4(0, 0, 0, 0);
        if (vec && a.res && a.res_dt == rk::BF16 && row < a.m)
          rv[i] = *reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(a.res) + row * a.ldres +
              col);
      }
    };
    residuals(0);
    bar_sync(1 + ci, 128);  // the pass before has read the buffer
    // element e of the fragment's pass is row 16 warp + lane / 4 (+ 8
    // for e % 4 >= 2), column 8 (e / 4) + 2 (lane % 4) + e % 2; gated,
    // four columns of w's sums, then the same four of wg's
#pragma unroll
    for (int e = 0; e < PA; e += 2) {
      const int r = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
      const int c = 8 * (e >> 2) + 2 * (lane & 3);
      if constexpr (GATED) {
        const int f = 8 * (c >> 2) + (c & 3);
        *reinterpret_cast<float2*>(buf + epi_at(r, f)) =
            make_float2(acc[e], acc[e + 1]);
        *reinterpret_cast<float2*>(buf + epi_at(r, f + 4)) =
            make_float2(accg[e], accg[e + 1]);
      } else {
        *reinterpret_cast<float2*>(buf + epi_at(r, c)) =
            make_float2(acc[e], acc[e + 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < NA - PA; ++e) {
      acc[e] = acc[e + PA];
      if constexpr (GATED) accg[e] = accg[e + PA];
    }
    bar_sync(1 + ci, 128);
#pragma unroll
    for (int i = 0; i < ITS; ++i) {
      if (i % PF == 0 && i > 0) residuals(i);
      const int r = rr + RPI * i, row = row0 + r;
      // the chunks in an order that spreads each quarter-warp's loads
      // over all 32 banks
      float h[8], g[8];
      if constexpr (GATED) {
        const int o = (p >> 1) & 1;
        float4 u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          u[k] = *reinterpret_cast<const float4*>(
              buf + epi_at(r, 16 * p + 4 * (k ^ o)));
        const float4 h0 = o ? u[1] : u[0], g0 = o ? u[0] : u[1];
        const float4 h1 = o ? u[3] : u[2], g1 = o ? u[2] : u[3];
        h[0] = h0.x, h[1] = h0.y, h[2] = h0.z, h[3] = h0.w;
        h[4] = h1.x, h[5] = h1.y, h[6] = h1.z, h[7] = h1.w;
        g[0] = g0.x, g[1] = g0.y, g[2] = g0.z, g[3] = g0.w;
        g[4] = g1.x, g[5] = g1.y, g[6] = g1.z, g[7] = g1.w;
      } else {
        const int o = (p >> 2) & 1;
        const float4 u = *reinterpret_cast<const float4*>(
            buf + epi_at(r, 8 * p + 4 * o));
        const float4 v = *reinterpret_cast<const float4*>(
            buf + epi_at(r, 8 * p + 4 * (1 - o)));
        const float4 lo = o ? v : u, hi = o ? u : v;
        h[0] = lo.x, h[1] = lo.y, h[2] = lo.z, h[3] = lo.w;
        h[4] = hi.x, h[5] = hi.y, h[6] = hi.z, h[7] = hi.w;
      }
      if (row >= a.m || col >= a.n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[j] = post_at<GATED, ACT>(a, h[j], GATED ? g[j] : 0.f, b[j], bg[j]);
      if (vec) {
        store8(a, row, col, h, rv[i % PF]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col + j < a.n) rk::finish(a, row, col + j, h[j]);
      }
    }
  }
}

template <bool GATED, int BN>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(PTHREADS, 1)
    rowwise_matmul_kernel_persistent(const __grid_constant__ CUtensorMap map_a,
                                     const __grid_constant__ CUtensorMap map_b,
                                     const __grid_constant__ CUtensorMap map_bg,
                                     const rk::MatmulArgs a, const Walk wk) {
  constexpr int B_BYTES = BN * KB;   // one weight's tile
  constexpr int NA = BN / 2;         // accumulators a thread, a weight
  constexpr int PANELS = BN / 64;    // 64-column TMA boxes a weight's tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (su32(smem_raw) & 1023)) & 1023);
  float* epi = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * EPI_BYTES / 4);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int nk = (a.k + KE - 1) / KE;
  const int rank = static_cast<int>(cluster_rank());
  const int first_unit = blockIdx.x / CLUSTER;
  const int unit_stride = gridDim.x / CLUSTER;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // each consumer warpgroup of each block of the cluster releases a
      // stage: the weights' tiles land in every block of the cluster
      mbar_init(&empty[s], 2 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {  // the producer: one thread keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      int it = 0;  // the ring's stage count, across the block's tiles
      for (int u = first_unit; u < wk.units; u += unit_stride) {
        int m0, n0;
        origin(wk, u, rank, BN, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES, k0 = kt * KE;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          uint8_t* st = ring + s * STAGE_BYTES;
          mbar_expect(&full[s], A_BYTES + (GATED ? 2 : 1) * B_BYTES);
          tma_load(st, &map_a, &full[s], k0, m0);
          // the weights' panels, each loaded by one block of the cluster
          // into every block's stage
#pragma unroll
          for (int p = 0; p < PANELS; ++p) {
            if (p % CLUSTER != rank) continue;
            load_b(st + A_BYTES + p * 8192, &map_b, &full[s], n0 + 64 * p,
                   k0);
            if constexpr (GATED)
              load_b(st + A_BYTES + B_BYTES + p * 8192, &map_bg, &full[s],
                     n0 + 64 * p, k0);
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup 1 + ci owns rows 64 ci .. 64 ci + 63
    setmaxnreg_inc<CONSUMER_REGS>();
    const int ci = wg - 1;
    float acc[NA], accg[GATED ? NA : 1];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (GATED ? NA : 1); ++i) accg[i] = 0.f;
    float* buf = epi + ci * (EPI_BYTES / 4);
    const uint32_t ring_s = su32(ring);
    int it = 0;
    for (int u = first_unit; u < wk.units; u += unit_stride) {
      int m0, n0;
      origin(wk, u, rank, BN, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t sa = ring_s + s * STAGE_BYTES + ci * 64 * KB;
        const uint32_t sb = ring_s + s * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart,
          // a k step of 16 is 32 bytes along the row. B N-major: 64-column
          // panels 8 KB apart (leading offset), 8-row groups of k 1024
          // bytes apart, a k step 16 rows.
          const int scale = kt > 0 || j > 0;
          const uint64_t da = desc(sa + 32 * j, 16, 1024);
          mma<BN>(acc, da, desc(sb + 2048 * j, 8192, 1024), scale);
          if constexpr (GATED)
            mma<BN>(accg, da, desc(sb + B_BYTES + 2048 * j, 8192, 1024),
                    scale);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of the stage before has retired
        if (kt > 0 && t == 0) release(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if (t == 0) release(&empty[(it - 1) % STAGES]);
      fence_regs(acc);
      if constexpr (GATED) fence_regs(accg);
      const int row0 = m0 + 64 * ci;
      switch (a.act) {
        case rk::ACT_GELU:
          epilogue<GATED, BN, rk::ACT_GELU>(a, wk, acc, accg, buf, row0, n0,
                                            ci, t);
          break;
        case rk::ACT_SILU:
          epilogue<GATED, BN, rk::ACT_SILU>(a, wk, acc, accg, buf, row0, n0,
                                            ci, t);
          break;
        case rk::ACT_RELU:
          epilogue<GATED, BN, rk::ACT_RELU>(a, wk, acc, accg, buf, row0, n0,
                                            ci, t);
          break;
        case rk::ACT_RELU2:
          epilogue<GATED, BN, rk::ACT_RELU2>(a, wk, acc, accg, buf, row0, n0,
                                             ci, t);
          break;
        default:
          epilogue<GATED, BN, rk::ACT_NONE>(a, wk, acc, accg, buf, row0, n0,
                                            ci, t);
      }
    }
  }
  // no block leaves while its cluster's peers may still write its ring
  // or arrive on its barriers
  cluster_sync();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// the clusters of a kernel the card holds at once (SMs / CLUSTER where
// every SM can take a block of one)
template <typename K>
int active_clusters(K kernel) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 64, 1, 1);
  cfg.blockDim = dim3(PTHREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess ||
      n <= 0) {
    cudaGetLastError();
    n = sm_count() / CLUSTER;
  }
  return n;
}

template <bool GATED, int BN>
int launch(const rk::MatmulArgs& a, const CUtensorMap& ma,
           const CUtensorMap& mb, const CUtensorMap& mbg, int vec,
           cudaStream_t stream) {
  auto kernel = rowwise_matmul_kernel_persistent<GATED, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int clusters = active_clusters(kernel);
  Walk wk;
  wk.mu = (a.m + CLUSTER * TM - 1) / (CLUSTER * TM);
  wk.nt = (a.n + BN - 1) / BN;
  wk.units = wk.mu * wk.nt;
  wk.group = wk.mu < GROUP / CLUSTER ? wk.mu : GROUP / CLUSTER;
  wk.vec = vec;
  const int grid = CLUSTER * (wk.units < clusters ? wk.units : clusters);
  kernel<<<grid, PTHREADS, SMEM_BYTES, stream>>>(ma, mb, mbg, a, wk);
  return 0;
}

// whether the rows of p (row stride ld elements of es bytes) start
// 16-byte aligned
bool rows16(const void* p, long long ld, int es) {
  return !(reinterpret_cast<size_t>(p) & 15) && !((ld * es) & 15);
}

}  // namespace

int rk_launch_persistent(const rk::MatmulArgs& a, cudaStream_t stream) {
  if (a.dtype != rk::BF16 || a.norm != rk::NORM_NONE)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma{}, mb{}, mbg{};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const bool tma = encode(&ma, a.x, bf, 2, a.k, a.m, a.ldx, KE, TM) &&
                   encode(&mb, a.w, bf, 2, a.n, a.k, a.ldw, 64, 64) &&
                   (!a.wg || encode(&mbg, a.wg, bf, 2, a.n, a.k, a.ldwg, 64,
                                    64));
  // the wrapper routes here only operands TMA takes
  if (!tma) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = rows16(a.out, a.ldout, a.out_dt == rk::F32 ? 4 : 2) &&
                  (!a.res || rows16(a.res, a.ldres, a.res_dt == rk::F32 ? 4
                                                                         : 2));
  if (a.wg) return launch<true, BN_NARROW>(a, ma, mb, mbg, vec, stream);
  return a.n % BN_WIDE == 0
             ? launch<false, BN_WIDE>(a, ma, mb, mbg, vec, stream)
             : launch<false, BN_NARROW>(a, ma, mb, mbg, vec, stream);
}

// The kernels and constants of this file, for the shared-memory audit
// (analysis/smem.py): as rk_query_wgmma.
extern "C" const char* rk_query_persistent(int i, long long* out, int* err) {
  *err = 0;
  if (i < 0) {
    const long long c[] = {TM, KB, STAGES, BN_WIDE, BN_NARROW, GROUP,
                           CLUSTER, PTHREADS, SMEM_BYTES};
    return rk::query_constants(c, 9,
                               "TM,KB,STAGES,BN,BN_NARROW,GROUP,CLUSTER,"
                               "PTHREADS,SMEM_BYTES", out);
  }
  switch (i) {
    case 0:
      *err = rk::query_kernel(rowwise_matmul_kernel_persistent<false, 256>,
                              PTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_persistent<false,256>";
    case 1:
      *err = rk::query_kernel(rowwise_matmul_kernel_persistent<false, 128>,
                              PTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_persistent<false,128>";
    case 2:
      *err = rk::query_kernel(rowwise_matmul_kernel_persistent<true, 128>,
                              PTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_persistent<true,128>";
    default:
      return nullptr;
  }
}
