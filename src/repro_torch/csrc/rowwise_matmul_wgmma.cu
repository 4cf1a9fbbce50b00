// The tensor-core design of the row-wise matmul: bf16 and int8 calls of
// more rows than the skinny design takes (M > 4; see rowwise_matmul.cu
// for the whole kernel and its TPU origin).
//
// Bound: operations at the prefill and Swin-T shapes (bf16 on the tensor
// cores: 989 TFLOP/s; int8: 1979 TOP/s). The design:
//  * A 128 x 128 output tile per block (128 x 64 gated, whose two
//    accumulators share the registers), three warpgroups: warpgroup 0
//    produces, warpgroups 1 and 2 each own 64 rows and run wgmma
//    (m64n128k16 bf16 -> fp32, m64n128k32 s8 -> s32) from shared memory.
//  * A ring of 5 stages of 128 bytes of K (64 bf16 or 128 int8): per
//    stage the A tile (128 rows) and the B tile, each in the 128-byte
//    swizzle that wgmma reads without bank conflicts. Full / empty
//    mbarriers pass the stages between producer and consumers; a
//    consumer keeps one wgmma group in flight and releases a stage when
//    the group that read it has retired.
//  * Loads: TMA (one thread, cp.async.bulk.tensor with complete_tx) for
//    every operand it can take: 16-byte aligned base and row stride. bf16
//    w is N-major and wgmma reads it so (transpose bit). Where TMA cannot
//    take an operand (x or w rows not a multiple of 16 bytes: K = 70,
//    N = 1000 int8), the producer's 128 threads copy it with masked
//    element loads into the same swizzled layout.
//  * int8 w: wgmma takes 8-bit operands only K-major, and w is (K, N)
//    N-major. The producer threads transpose it on the way in: 4 x 4
//    byte blocks loaded as four 32-bit words, transposed with byte
//    permutes, stored K-major. The weight is never copied in device
//    memory.
//  * Norm prologue (bf16): the consumer warps take their 128 rows'
//    fp32 statistics first, from the ring where the whole K fits in it,
//    else from global memory; each consumer normalizes its 64 rows of
//    every A stage in place, rounds to bf16 (where the JAX kernel casts
//    the normed panel), fences the generic-proxy writes for the async
//    proxy, then runs wgmma.
//  * Epilogue: each thread runs the post-processing unit on its
//    accumulator fragment (dequant, bias, activation or gate) and puts
//    the fp32 result in shared memory; then the warpgroup walks its rows
//    so that residual reads and output stores coalesce.
#include <cuda.h>

#include <cstdint>
#include <type_traits>

#include "rowwise_matmul.cuh"
#include "tma.cuh"

namespace {

using namespace rk::sm90;

constexpr int TM = 128;                    // tile rows
constexpr int KB = 128;                    // bytes of K per stage
constexpr int STAGES = 5;
constexpr int A_BYTES = TM * KB;           // 16 KB
constexpr int STAGE_BYTES = 2 * A_BYTES;   // A, then B (and Bg, gated)
constexpr int WTHREADS = 384;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 +
                           TM * static_cast<int>(sizeof(rk::RowStats));
// tile columns: two weights' tiles share a stage when gated
__host__ __device__ constexpr int bn_of(bool gated) {
  return gated ? 64 : 128;
}

// How the producer fills a stage.
struct Loads {
  int tma_a;  // x through TMA, else masked element copies
  int tma_b;  // bf16 w (and wg) through TMA, else masked copies
};

// byte b of row r of a tile of 128-byte rows in the 128-byte swizzle
// (16-byte chunk c of row r sits at chunk c ^ (r % 8)), as TMA writes it
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// The wgmma calls: bf16 with fp32 accumulators and B N-major (the
// transpose bit, the last immediate, set); s8 with s32 accumulators, both
// operands K-major. Each accumulates into d.
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n64(int (&d)[32], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// A 4 x 4 block of bytes held as four words, one per k row (four
// columns each), turned into four words, one per column, each holding the
// column's four k values.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The x tile (rows m0.., 128 bytes of K from element k0) by masked
// element copies: producer thread t copies row t.
template <typename T>
__device__ void copy_a(uint8_t* dst, const rk::MatmulArgs& a, int m0, int k0,
                       int t) {
  constexpr int E = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  const int row = m0 + t;
  for (int c = 0; c < 8; ++c) {
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int k = k0 + c * E + j;
      e[j] = (row < a.m && k < a.k) ? x[row * a.ldx + k] : T{};
    }
    *reinterpret_cast<uint4*>(dst + swz(t, c * 16)) = v;
  }
}

// A bf16 weight tile (k rows k0..k0+63, columns n0..n0+BN-1) N-major, as
// TMA writes it: 64-column panels of 64 rows of 128 bytes, by masked
// element copies.
template <int BN>
__device__ void copy_b_mn(uint8_t* dst, const __nv_bfloat16* w,
                          long long ldw, const rk::MatmulArgs& a, int n0,
                          int k0, int t) {
  const int r = t & 63, k = k0 + r;
  for (int cc = t >> 6; cc < BN / 8; cc += 2) {
    uint4 v;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cc * 8 + j;
      e[j] = (k < a.k && n < a.n) ? w[k * ldw + n] : __nv_bfloat16{};
    }
    *reinterpret_cast<uint4*>(dst + (cc >> 3) * 8192 + swz(r, (cc & 7) * 16)) =
        v;
  }
}

// An int8 weight tile (128 k rows from k0, columns n0..n0+BN-1)
// K-major: BN rows of 128 bytes, one per column, transposed on the way
// in. A warp takes 8 x 4 blocks of 4 x 4 bytes per step: its global reads
// are 32-byte runs of 4 rows, its shared stores at most 4-way conflicted.
template <int BN>
__device__ void copy_b_k(uint8_t* dst, const int8_t* w, long long ldw,
                         const rk::MatmulArgs& a, int n0, int k0, int t,
                         bool word_ok) {
  constexpr int NG = BN / 32, IT = NG * 8 / 4;
  const int warp = t >> 5, lane = t & 31;
  uint32_t v[IT][4];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int tile = warp + 4 * i;
    const int n = n0 + 4 * (8 * (tile % NG) + (lane & 7));
    const int kg = 4 * (tile / NG) + (lane >> 3);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 4 * kg + e;
      const int8_t* src = w + k * ldw + n;
      if (word_ok && k < a.k && n + 4 <= a.n) {
        v[i][e] = __ldg(reinterpret_cast<const unsigned int*>(src));
      } else {
        uint32_t u = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k < a.k && n + j < a.n)
            u |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
        v[i][e] = u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int tile = warp + 4 * i;
    const int ng = 8 * (tile % NG) + (lane & 7);
    const int kg = 4 * (tile / NG) + (lane >> 3);
    uint32_t c[4];
    transpose4(v[i], c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(dst + swz(4 * ng + j, 4 * kg)) = c[j];
  }
}

// T: __nv_bfloat16 (w read N-major) or int8_t (w transposed to K-major).
template <typename T, bool GATED>
__global__ void __launch_bounds__(WTHREADS, 1)
    rowwise_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                                const __grid_constant__ CUtensorMap map_b,
                                const __grid_constant__ CUtensorMap map_bg,
                                const rk::MatmulArgs a, const Loads ld) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr bool KMAJOR = INT8;
  constexpr int BN = bn_of(GATED);
  constexpr int KE = KB / sizeof(T);   // K elements per stage
  constexpr int B_BYTES = BN * KB;     // one weight's tile
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (su32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  rk::RowStats* stats = reinterpret_cast<rk::RowStats*>(empty + STAGES);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const int nk = (a.k + KE - 1) / KE;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    const T* w = static_cast<const T*>(a.w);
    const T* wgt = static_cast<const T*>(a.wg);
    auto word_ok = [](const void* p, long long ld_) {
      return (reinterpret_cast<size_t>(p) & 3) == 0 &&
             ((ld_ * static_cast<long long>(sizeof(T))) & 3) == 0;
    };
    const bool wok = word_ok(w, a.ldw), wgok = GATED && word_ok(wgt, a.ldwg);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES, k0 = kt * KE;
      if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      uint8_t* st = ring + s * STAGE_BYTES;
      bool manual = false;
      if (!ld.tma_a) {
        copy_a<T>(st, a, m0, k0, t);
        manual = true;
      }
      if constexpr (KMAJOR) {
        copy_b_k<BN>(st + A_BYTES, w, a.ldw, a, n0, k0, t, wok);
        if constexpr (GATED)
          copy_b_k<BN>(st + A_BYTES + B_BYTES, wgt, a.ldwg, a, n0, k0, t,
                       wgok);
        manual = true;
      } else if (!ld.tma_b) {
        copy_b_mn<BN>(st + A_BYTES, reinterpret_cast<const __nv_bfloat16*>(w),
                      a.ldw, a, n0, k0, t);
        if constexpr (GATED)
          copy_b_mn<BN>(st + A_BYTES + B_BYTES,
                        reinterpret_cast<const __nv_bfloat16*>(wgt), a.ldwg,
                        a, n0, k0, t);
        manual = true;
      }
      if (manual) fence_async_smem();
      const bool tma_b = !KMAJOR && ld.tma_b;
      const uint32_t tx = (ld.tma_a ? A_BYTES : 0) +
                          (tma_b ? B_BYTES * (GATED ? 2 : 1) : 0);
      if (t == 0 && tx) {
        mbar_expect(&full[s], tx);
        if (ld.tma_a) tma_load(st, &map_a, &full[s], k0, m0);
        if (tma_b) {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load(st + A_BYTES + p * 8192, &map_b, &full[s], n0 + 64 * p,
                     k0);
          if constexpr (GATED)
            tma_load(st + A_BYTES + B_BYTES, &map_bg, &full[s], n0, k0);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumers: warpgroup 1 + ci owns rows 64 ci .. 64 ci + 63
  const int ci = wg - 1, warp = t >> 5, lane = t & 31;
  if constexpr (!INT8) {
    if (a.norm != rk::NORM_NONE && nk <= STAGES) {
      // the whole K is in the ring (K <= 320): each warpgroup takes its
      // rows' statistics there, two threads a row, the same two passes
      // (mean, then the centred squares) as rk::row_stats
      for (int kt = 0; kt < nk; ++kt) mbar_wait(&full[kt], 0);
      const int r = 64 * ci + (t >> 1), half = t & 1;
      auto pass = [&](float mean, bool square) {
        float acc_ = 0.f;
        for (int kt = 0; kt < nk; ++kt)
#pragma unroll
          for (int c = half; c < 8; c += 2) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                ring + kt * STAGE_BYTES + r * 128 + ((c ^ (r & 7)) << 4));
            const __nv_bfloat16* e =
                reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (kt * KE + c * 8 + j < a.k) {
                const float d = __bfloat162float(e[j]) - mean;
                acc_ += square ? d * d : d;
              }
          }
        return acc_ + __shfl_xor_sync(0xffffffffu, acc_, 1);
      };
      const float mean =
          a.norm == rk::NORM_LAYER ? pass(0.f, false) / a.k : 0.f;
      const float var = pass(mean, true) / a.k;
      if (half == 0) stats[r] = {mean, rsqrtf(var + a.eps)};
      bar_sync(2 + ci, 128);
    } else if (a.norm != rk::NORM_NONE) {
      // the 8 consumer warps take 16 rows each from global memory, 8
      // rows' loads at a time
      const int w8 = (tid - 128) >> 5;
#pragma unroll 1
      for (int r = 16 * w8; r < 16 * w8 + 16; r += 8)
        rk::row_stats_rows<8>(static_cast<const T*>(a.x), a.ldx, m0 + r,
                              a.m, a.k, a.norm, a.eps, stats + r);
      bar_sync(1, 256);
    }
  }

  Acc acc[BN / 2], accg[GATED ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (GATED ? BN / 2 : 1); ++i) accg[i] = 0;
  const uint32_t ring_s = su32(ring);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    uint8_t* st = ring + s * STAGE_BYTES;
    if constexpr (!INT8) {
      if (a.norm != rk::NORM_NONE) {
        // normalize this warpgroup's 64 rows of the A stage in place.
        // Thread t takes 16-byte chunk t % 8 of rows t / 8 + 16 i; the
        // swizzle puts the same 8 columns there in each of its rows
        // (r % 8 = (t / 8) % 8), so it loads their gains once a stage.
        const int pc = t & 7, lc = pc ^ ((t >> 3) & 7);
        const int kc = kt * KE + lc * 8;
        rk::Gain gn[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (kc + j < a.k) gn[j] = rk::gain(a, kc + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 64 * ci + (t >> 3) + 16 * i, row = m0 + r;
          uint4* p = reinterpret_cast<uint4*>(st + r * 128 + pc * 16);
          uint4 v = *p;
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (row < a.m && kc + j < a.k)
              e[j] = __float2bfloat16(rk::norm_elem<T>(
                  __bfloat162float(e[j]), stats[r], gn[j]));
          *p = v;
        }
        fence_async_smem();
        bar_sync(2 + ci, 128);
      }
    }
    const uint32_t sa = ring_s + s * STAGE_BYTES + ci * 64 * KB;
    const uint32_t sb = ring_s + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; a
      // k step (16 bf16 or 32 int8) is 32 bytes along the row. B K-major
      // the same; B N-major: 64-column panels 8 KB apart (leading
      // offset), 8-row groups of k 1024 bytes apart, a k step 16 rows.
      const uint64_t da = desc(sa + 32 * j, 16, 1024);
      const uint32_t bj = KMAJOR ? 32 * j : 2048 * j;
      const uint64_t db = KMAJOR ? desc(sb + bj, 16, 1024)
                                 : desc(sb + bj, 8192, 1024);
      if constexpr (BN == 128)
        mma_n128(acc, da, db);
      else
        mma_n64(acc, da, db);
      if constexpr (GATED)
        mma_n64(accg, da,
                KMAJOR ? desc(sb + B_BYTES + bj, 16, 1024)
                       : desc(sb + B_BYTES + bj, 8192, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of stage kt - 1 has retired
    if (kt > 0 && t == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (GATED) fence_regs(accg);

  // epilogue: fragment -> post-processing -> shared -> coalesced rows.
  // Element i of a thread's m64nN fragment is row 16 warp + lane / 4
  // (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
  bar_sync(1, 256);  // both warpgroups are done with the ring
  constexpr int LD = BN + 4;
  float* out_s = reinterpret_cast<float*>(ring) + ci * 64 * LD;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const int row = m0 + 64 * ci + r, col = n0 + c;
    float v = 0.f;
    if (row < a.m && col < a.n)
      v = rk::post<GATED, INT8>(
          a, static_cast<float>(acc[i]),
          GATED ? static_cast<float>(accg[GATED ? i : 0]) : 0.f, row, col);
    out_s[r * LD + c] = v;
  }
  bar_sync(2 + ci, 128);
  // four columns a thread, BN / 4 threads a row; unrolled so that the
  // residual loads of several rows are in flight together
  constexpr int TPR = BN / 4, RPP = 128 / TPR;
  const int c = (t % TPR) * 4;
#pragma unroll 4
  for (int r = t / TPR; r < 64; r += RPP) {
    const int row = m0 + 64 * ci + r;
    if (row >= a.m) break;
    const float4 v = *reinterpret_cast<const float4*>(&out_s[r * LD + c]);
    const float h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < a.n) rk::finish(a, row, n0 + c + j, h[j]);
  }
}

template <typename T, bool GATED>
int launch(const rk::MatmulArgs& a, const Loads& ld, const CUtensorMap& ma,
           const CUtensorMap& mb, const CUtensorMap& mbg,
           cudaStream_t stream) {
  auto kernel = rowwise_matmul_kernel_wgmma<T, GATED>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn = bn_of(GATED);
  const dim3 grid((a.n + bn - 1) / bn, (a.m + TM - 1) / TM);
  kernel<<<grid, WTHREADS, SMEM_BYTES, stream>>>(ma, mb, mbg, a, ld);
  return 0;
}

}  // namespace

int rk_launch_wgmma(const rk::MatmulArgs& a, cudaStream_t stream) {
  CUtensorMap ma{}, mb{}, mbg{};
  Loads ld{};
  if (a.dtype == rk::I8) {
    ld.tma_a = encode(&ma, a.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.k, a.m,
                      a.ldx, KB, TM);
    return a.wg ? launch<int8_t, true>(a, ld, ma, mb, mbg, stream)
                : launch<int8_t, false>(a, ld, ma, mb, mbg, stream);
  }
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  ld.tma_a = encode(&ma, a.x, bf, 2, a.k, a.m, a.ldx, KB / 2, TM);
  ld.tma_b = encode(&mb, a.w, bf, 2, a.n, a.k, a.ldw, 64, 64) &&
             (!a.wg || encode(&mbg, a.wg, bf, 2, a.n, a.k, a.ldwg, 64, 64));
  return a.wg ? launch<__nv_bfloat16, true>(a, ld, ma, mb, mbg, stream)
              : launch<__nv_bfloat16, false>(a, ld, ma, mb, mbg, stream);
}

// The kernels and constants of this file, for the shared-memory audit
// (analysis/smem.py): kernel i's name (nullptr past the last) and its
// build in out[0..7] (rk::query_kernel), the CUDA error in *err; i = -1
// gives the tile constants' names and their values in out.
extern "C" const char* rk_query_wgmma(int i, long long* out, int* err) {
  *err = 0;
  if (i < 0) {
    const long long c[] = {TM, KB, STAGES, bn_of(false), bn_of(true),
                           WTHREADS, SMEM_BYTES};
    return rk::query_constants(c, 7,
                               "TM,KB,STAGES,BN,BN_GATED,WTHREADS,"
                               "SMEM_BYTES", out);
  }
  switch (i) {
    case 0:
      *err = rk::query_kernel(rowwise_matmul_kernel_wgmma<__nv_bfloat16, false>,
                              WTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_wgmma<bf16,false>";
    case 1:
      *err = rk::query_kernel(rowwise_matmul_kernel_wgmma<__nv_bfloat16, true>,
                              WTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_wgmma<bf16,true>";
    case 2:
      *err = rk::query_kernel(rowwise_matmul_kernel_wgmma<int8_t, false>,
                              WTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_wgmma<int8,false>";
    case 3:
      *err = rk::query_kernel(rowwise_matmul_kernel_wgmma<int8_t, true>,
                              WTHREADS, 1, SMEM_BYTES, out);
      return "rowwise_matmul_kernel_wgmma<int8,true>";
    default:
      return nullptr;
  }
}
