// Flash attention (online softmax) for Hopper: two designs, one per dtype.
//
// Replaces the TPU kernel flash_attention_p
// (src/repro/kernels/flash_attention.py, body _attn_kernel): q (B,Hq,Sq,hd),
// k/v (B,Hkv,Skv,hd); causal mask, sliding window, GQA (query head h reads
// kv head h / (Hq/Hkv)), a query offset, keys past Skv masked, and an
// additive score bias (nb,Hq,Sq,Skv), fp32 or bf16 as stored, that batch b
// reads at row b % nb. Masked scores are -1e30 and take no weight, the
// denominator is floored at 1e-30, and the probabilities are rounded to
// the value dtype before the PV product (the running sum takes them
// unrounded), as on the TPU. exp is __expf (ex2.approx): relative error
// about 1e-6 on these arguments, far inside either tolerance.
//
// Both designs share one skeleton. Work items are (batch, head, 64-query
// tile); a persistent CTA walks a contiguous run of them, so at Swin's
// 49-token windows each CTA packs many (window, head) pairs, ordered so
// that the pairs of one (head, window position) follow each other and
// share one bias tile, which the mma design keeps in shared memory. A
// two-stage cp.async ring (16-byte copies, zero-filled past the valid
// rows) holds one K/V tile of 64 keys, and a Q tile per item (two, by the
// item's parity); the next step (the item's next key tile, or the next
// item's Q and first tile) is in flight while the current one computes.
// Each item walks only the keys its rows can see (the causal diagonal
// and the window bound the range), the TPU kernel's block skipping; an
// item with none writes zeros. Each row's visible keys in a tile are one
// interval, so a mask is two compares.
//
// mma (bf16): 4 warps, 16 query rows each. QK^T and PV on the tensor
// cores, mma.sync m16n8k16 (bf16 in, fp32 sums) from ldmatrix fragments;
// the scale, bias and masks are applied to the score fragments, the
// running max and sum per row are reduced across each lane quad, and the
// probabilities become the PV product's A fragments in registers. The
// score sums start at bias / scale (a score is scale * (q . k + bias /
// scale), the TPU's q . k * scale + bias to within an fp32 rounding), so
// the bias takes no registers of its own; for one-tile items it comes
// from the CTA's cached tile. At t = 49 the rows pad to 64 (the m16
// tiles) and the keys to 56 (QK^T) and 64 (PV), not to 64 x 64 of FFMA
// work.
// ffma (fp32): exact fp32 products, no TF32. 128 threads, two phases per
// key tile: each thread takes a 4-row x 8-key tile of the scores (every
// 16-byte load of Q or K feeds 8 FMAs), the softmax reduces each row
// across its 8 lanes, the probabilities go to shared memory transposed,
// and each thread takes a 4-row x hd/8-dim tile of the output (every
// 16-byte load of V feeds 16 FMAs).
//
// Bound: bytes at Swin's windows (q, k, v and the bias read once, the
// output written once); the scores never reach device memory. q, k, v
// and the bias are read with their strides, so head views of a fused qkv
// output need no copy (rows 16-byte aligned).
#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int BQ = 64;  // query rows per item
constexpr int BK = 64;  // keys per tile
// row pitch of the cached bias tile: the 32 lanes of an mma score
// fragment read it with at most 2-way bank conflicts
constexpr int BIAS_PITCH = BK + 8;
constexpr unsigned FULL = 0xffffffffu;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  void* out;
  int B, Hq, Hkv, Sq, Skv, nb, group;  // group = Hq / Hkv
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs;
  long long sbn, sbh, sbq;
  int sbk;
  float scale, inv_scale;
  int causal, window, q_offset, bias_f32;
  int q_tiles, n_items;
};

// One step's K/V tiles and an item's Q tile, rows padded by 16 bytes
// (conflict-free ldmatrix and LDS.128).
template <typename T, int HD>
struct Stage {
  static constexpr int PITCH = HD + 16 / sizeof(T);
  T k[BK][PITCH];
  T v[BK][PITCH];
};

template <typename T, int HD>
struct QTile {
  T q[BQ][Stage<T, HD>::PITCH];
};

struct Item {
  int b, h, hk, q0, lo, hi, n_tiles, bias_key;
};

// Items in the order (head, b % nb, b / nb, query tile): the items of one
// (head, bias row) follow each other, and each CTA walks a contiguous run
// of them, so at Swin's windows a CTA reads the bias of few (head, window
// position) pairs (kept in shared memory) for many images.
__device__ __forceinline__ Item item_at(const AttnArgs& a, int idx) {
  Item it;
  const int qt = idx % a.q_tiles, r = idx / a.q_tiles;
  const int per_row = a.B / a.nb;  // images per bias row
  const int bq = r % per_row;
  it.bias_key = r / per_row;       // h * nb + b % nb
  it.h = it.bias_key / a.nb;
  it.b = bq * a.nb + it.bias_key % a.nb;
  it.hk = it.h / a.group;
  it.q0 = qt * BQ;
  const int last = min(it.q0 + BQ, a.Sq) - 1 + a.q_offset;
  it.lo = 0;
  it.hi = a.Skv;
  if (a.causal) it.hi = min(it.hi, last + 1);
  if (a.window > 0) it.lo = max(0, it.q0 + a.q_offset - a.window + 1);
  it.n_tiles = it.hi > it.lo ? (it.hi - it.lo + BK - 1) / BK : 1;
  return it;
}

// Keys of tile kt that lie in the item's range (0 .. BK).
__device__ __forceinline__ int tile_keys(const Item& it, int kt) {
  return max(0, min(BK, it.hi - it.lo - kt * BK));
}

// The K/V tile kt of an item into a stage, and its Q tile into qt when
// given.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_step(Stage<T, HD>& st, QTile<T, HD>* qt,
                                          const AttnArgs& a, const Item& it,
                                          int kt) {
  constexpr int EPP = 16 / sizeof(T);
  constexpr int PR = HD / EPP;  // 16-byte pieces per row
  const int tid = threadIdx.x;
  if (qt) {
    const T* qb = static_cast<const T*>(a.q) + it.b * a.sqb + it.h * a.sqh;
    for (int e = tid; e < BQ * PR; e += NT) {
      const int row = e / PR, col = e % PR * EPP, qi = it.q0 + row;
      const bool in = qi < a.Sq;
      rk::cp_async16(&qt->q[row][col], qb + (in ? qi * a.sqs : 0) + col, in);
    }
  }
  const T* kb = static_cast<const T*>(a.k) + it.b * a.skb + it.hk * a.skh;
  const T* vb = static_cast<const T*>(a.v) + it.b * a.svb + it.hk * a.svh;
  const int k0 = it.lo + kt * BK, nk = tile_keys(it, kt);
  for (int e = tid; e < BK * PR; e += NT) {
    const int row = e / PR, col = e % PR * EPP;
    const bool in = row < nk;
    const long long kj = k0 + row;
    rk::cp_async16(&st.k[row][col], kb + (in ? kj * a.sks : 0) + col, in);
    rk::cp_async16(&st.v[row][col], vb + (in ? kj * a.svs : 0) + col, in);
  }
}

// The keys of tile kt that query row qi sees, as the interval [lo, hi]
// of indices into the tile (empty when hi < lo).
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span span(const AttnArgs& a, const Item& it,
                                     int kt, int qi) {
  const int k0 = it.lo + kt * BK, qpos = qi + a.q_offset;
  Span sp{0, tile_keys(it, kt) - 1};
  if (qi >= a.Sq) sp.hi = -1;
  if (a.causal) sp.hi = min(sp.hi, qpos - k0);
  if (a.window > 0) sp.lo = max(0, qpos - a.window + 1 - k0);
  return sp;
}

__device__ __forceinline__ bool in_span(Span sp, int j) {
  return j >= sp.lo && j <= sp.hi;
}

// Query row qi's bias at the tile's first key (k0); key k0 + j lies j *
// a.sbk elements further.
__device__ __forceinline__ const void* bias_row(const AttnArgs& a,
                                                const Item& it, int qi,
                                                int k0) {
  const long long off = (it.b % a.nb) * a.sbn + it.h * a.sbh +
                        static_cast<long long>(qi) * a.sbq +
                        static_cast<long long>(k0) * a.sbk;
  if (a.bias_f32) return static_cast<const float*>(a.bias) + off;
  return static_cast<const __nv_bfloat16*>(a.bias) + off;
}

// ---------------------------------------------------------------- mma --

template <int HD>
struct MmaTile {
  static constexpr int NT = 128;
  static constexpr int SCRATCH = 0;
  static constexpr bool CACHES_BIAS = true;
  using T = __nv_bfloat16;
  unsigned qa[HD / 16][4];  // Q fragments of this warp's 16 rows
  float o[HD / 8][4];       // output accumulators
  float m[2], l[2];         // running max and (lane-partial) sum, 2 rows
  bool live;                // the warp has a row below Sq

  __device__ __forceinline__ void begin(const QTile<T, HD>& qt,
                                        const AttnArgs& a, const Item& it) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    live = it.q0 + 16 * warp < a.Sq;
    m[0] = m[1] = rk::NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    if (!live) return;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      rk::ldmatrix_x4(
          qa[ks], &qt.q[16 * warp + (lane & 15)][16 * ks + (lane >> 4) * 8]);
  }

  __device__ __forceinline__ void tile(const Stage<T, HD>& st,
                                       const QTile<T, HD>&, float*,
                                       const float* bias_tile,
                                       const AttnArgs& a, const Item& it,
                                       int kt) {
    if (!live) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int nk = tile_keys(it, kt), k0 = it.lo + kt * BK;
    const int rows[2] = {it.q0 + 16 * warp + g, it.q0 + 16 * warp + g + 8};
    const Span sp[2] = {span(a, it, kt, rows[0]), span(a, it, kt, rows[1])};

    // the score accumulators start at bias / scale, so that scale * sum
    // adds the bias without registers of its own
    float sc[BK / 8][4] = {};
    if (bias_tile) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, jj = 8 * nt + 2 * tq + (e & 1);
          sc[nt][e] = bias_tile[(rows[h] - it.q0) * BIAS_PITCH + jj] *
                      a.inv_scale;
        }
    } else if (a.bias) {
      const void* br[2] = {bias_row(a, it, rows[0], k0),
                           bias_row(a, it, rows[1], k0)};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, jj = 8 * nt + 2 * tq + (e & 1);
          if (in_span(sp[h], jj))
            sc[nt][e] =
                rk::vec_at(br[h], jj * a.sbk, a.bias_f32) * a.inv_scale;
        }
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      if (16 * np >= nk) continue;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        unsigned kf[4];
        rk::ldmatrix_x4(kf, &st.k[16 * np + (lane & 7) + (lane >> 4) * 8]
                                 [16 * ks + ((lane >> 3) & 1) * 8]);
        rk::mma_bf16(sc[2 * np], qa[ks], kf[0], kf[1]);
        rk::mma_bf16(sc[2 * np + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // scale, bias, masks; the running max over this tile's keys
    float mx[2] = {rk::NEG_INF, rk::NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, jj = 8 * nt + 2 * tq + (e & 1);
        sc[nt][e] = in_span(sp[h], jj) ? sc[nt][e] * a.scale : rk::NEG_INF;
        mx[h] = fmaxf(mx[h], sc[nt][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      const float alpha = __expf(m[h] - m_new);
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, jj = 8 * nt + 2 * tq + (e & 1);
        const float p = in_span(sp[h], jj) ? __expf(sc[nt][e] - m[h]) : 0.f;
        l[h] += p;
        sc[nt][e] = p;
      }

    // PV: the probabilities, rounded to bf16, as A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (16 * kk >= nk) continue;
      const unsigned pa[4] = {
          rk::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          rk::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          rk::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          rk::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned vf[4];
        rk::ldmatrix_x4_trans(
            vf, &st.v[16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                     [16 * np + (lane >> 4) * 8]);
        rk::mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        rk::mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }

  __device__ __forceinline__ void finish(const AttnArgs& a, const Item& it) {
    if (!live) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l_row = l[h] + __shfl_xor_sync(FULL, l[h], 1);
      l_row += __shfl_xor_sync(FULL, l_row, 2);
      const float inv = 1.f / fmaxf(l_row, 1e-30f);
      const int qi = it.q0 + 16 * warp + g + 8 * h;
      if (qi >= a.Sq) continue;
      T* op = static_cast<T*>(a.out) +
              ((static_cast<long long>(it.b) * a.Hq + it.h) * a.Sq + qi) * HD +
              2 * tq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) = __floats2bfloat162_rn(
            o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
};

// --------------------------------------------------------------- ffma --

template <int HD>
struct FfmaTile {
  static constexpr int NT = 128;
  static constexpr int DV = HD / 8;   // output dims per thread
  static constexpr int PP = 16 * 4 + 4;  // row pitch of the P^T tile
  static constexpr int SCRATCH = BK * PP * sizeof(float);
  static constexpr bool CACHES_BIAS = false;
  using T = float;
  float o[4][DV], m[4], l[4];  // rows rg + 16 r; l lane-partial

  // rows rg + 16 r (r < 4) of the tile; keys kg + 8 j (j < 8) in the
  // scores; in the output, head dims 4 kg + 32 i + {0..3} (2 kg + {0, 1}
  // at hd 16), so that the 8 lanes of a row read a row of V at once
  __device__ __forceinline__ int rg() const { return threadIdx.x >> 3; }
  __device__ __forceinline__ int kg() const { return threadIdx.x & 7; }

  __device__ __forceinline__ void load_dims(const float* row,
                                            float (&x)[DV]) const {
    if constexpr (HD >= 32) {
#pragma unroll
      for (int i = 0; i < DV / 4; ++i) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(row + 4 * kg() + 32 * i);
        x[4 * i] = v4.x;
        x[4 * i + 1] = v4.y;
        x[4 * i + 2] = v4.z;
        x[4 * i + 3] = v4.w;
      }
    } else {
      const float2 v2 = *reinterpret_cast<const float2*>(row + 2 * kg());
      x[0] = v2.x;
      x[1] = v2.y;
    }
  }

  __device__ __forceinline__ void store_dims(float* row,
                                             const float (&x)[DV]) const {
    if constexpr (HD >= 32) {
#pragma unroll
      for (int i = 0; i < DV / 4; ++i)
        *reinterpret_cast<float4*>(row + 4 * kg() + 32 * i) = make_float4(
            x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    } else {
      *reinterpret_cast<float2*>(row + 2 * kg()) = make_float2(x[0], x[1]);
    }
  }

  __device__ __forceinline__ void begin(const QTile<T, HD>&, const AttnArgs&,
                                        const Item&) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = rk::NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int d = 0; d < DV; ++d) o[r][d] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const Stage<T, HD>& st,
                                       const QTile<T, HD>& qt, float* pt,
                                       const float*, const AttnArgs& a,
                                       const Item& it, int kt) {
    const int nk = tile_keys(it, kt), k0 = it.lo + kt * BK;
    Span sp[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) sp[r] = span(a, it, kt, it.q0 + rg() + 16 * r);
    // the bias at this thread's scores, loaded ahead of the products
    float bv[4][8] = {};
    if (a.bias)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const void* br = bias_row(a, it, it.q0 + rg() + 16 * r, k0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = kg() + 8 * j;
          if (in_span(sp[r], jj))
            bv[r][j] = rk::vec_at(br, jj * a.sbk, a.bias_f32);
        }
      }

    // phase 1: the 4 x 8 score tile
    float s[4][8] = {};
#pragma unroll 1
    for (int d = 0; d < HD; d += 4) {
      float4 q4[4], k4[8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        q4[r] = *reinterpret_cast<const float4*>(&qt.q[rg() + 16 * r][d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        k4[j] = *reinterpret_cast<const float4*>(&st.k[kg() + 8 * j][d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[r][j] = fmaf(q4[r].x, k4[j].x, s[r][j]);
          s[r][j] = fmaf(q4[r].y, k4[j].y, s[r][j]);
          s[r][j] = fmaf(q4[r].z, k4[j].z, s[r][j]);
          s[r][j] = fmaf(q4[r].w, k4[j].w, s[r][j]);
        }
    }
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = rk::NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool keep = in_span(sp[r], kg() + 8 * j);
        s[r][j] = keep ? s[r][j] * a.scale + bv[r][j] : rk::NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = __expf(m[r] - m_new);
      l[r] *= alpha[r];
      m[r] = m_new;
    }
    // the probabilities, key-major: one 16-byte store per key
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = kg() + 8 * j;
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = in_span(sp[r], jj) ? __expf(s[r][j] - m[r]) : 0.f;
        l[r] += p[r];
      }
      *reinterpret_cast<float4*>(pt + jj * PP + rg() * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // phase 2: the 4 x hd/8 output tile
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int d = 0; d < DV; ++d) o[r][d] *= alpha[r];
    for (int jj = 0; jj < nk; ++jj) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + jj * PP +
                                                         rg() * 4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DV];
      load_dims(&st.v[jj][0], vv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int d = 0; d < DV; ++d) o[r][d] = fmaf(p[r], vv[d], o[r][d]);
    }
  }

  __device__ __forceinline__ void finish(const AttnArgs& a, const Item& it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float l_row = l[r];
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        l_row += __shfl_xor_sync(FULL, l_row, o);
      const int qi = it.q0 + rg() + 16 * r;
      if (qi >= a.Sq) continue;
      const float inv = 1.f / fmaxf(l_row, 1e-30f);
      float* op = static_cast<float*>(a.out) +
                  ((static_cast<long long>(it.b) * a.Hq + it.h) * a.Sq + qi) *
                      HD;
      float out[DV];
#pragma unroll
      for (int d = 0; d < DV; ++d) out[d] = o[r][d] * inv;
      store_dims(op, out);
    }
  }
};

// ----------------------------------------------------------- skeleton --

template <typename Tile, int HD>
constexpr int smem_bytes() {
  using T = typename Tile::T;
  return 2 * sizeof(Stage<T, HD>) + 2 * sizeof(QTile<T, HD>) + Tile::SCRATCH +
         (Tile::CACHES_BIAS ? BQ * BIAS_PITCH * sizeof(float) : 0);
}

// The bias of a one-tile item (every query row and key in one tile, as
// in Swin's windows) into the CTA's cache, in fp32; every thread calls
// it.
template <int NT>
__device__ __forceinline__ void cache_bias(float* tile, const AttnArgs& a,
                                           const Item& it) {
  const int nr = min(BQ, a.Sq - it.q0), nk = tile_keys(it, 0);
  for (int e = threadIdx.x; e < nr * nk; e += NT) {
    const int r = e / nk, j = e % nk;
    tile[r * BIAS_PITCH + j] = rk::vec_at(
        bias_row(a, it, it.q0 + r, it.lo), j * a.sbk, a.bias_f32);
  }
}

template <typename Tile, int HD>
__device__ __forceinline__ void run(const AttnArgs& a) {
  using T = typename Tile::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* stages = reinterpret_cast<Stage<T, HD>*>(smem_raw);
  auto* qts = reinterpret_cast<QTile<T, HD>*>(stages + 2);
  float* scratch = reinterpret_cast<float*>(qts + 2);
  float* bias_tile = scratch + Tile::SCRATCH / sizeof(float);
  // this CTA's run of items
  const int per = (a.n_items + gridDim.x - 1) / gridDim.x;
  int idx = blockIdx.x * per;
  const int end = min(a.n_items, idx + per);
  if (idx >= end) return;
  Item it = item_at(a, idx);
  // the bias is cached for one-tile items (a.q_tiles == 1 and one key
  // tile): cached_key is the (head, bias row) it holds, -1 none
  const bool cache = Tile::CACHES_BIAS && a.bias && a.q_tiles == 1 &&
                     a.Skv <= BK && !a.causal && a.window <= 0;
  int cached_key = -1;
  int kt = 0, s = 0, qp = 0;  // key tile, stage, Q tile (item parity)
  load_step<T, HD, Tile::NT>(stages[0], &qts[0], a, it, 0);
  rk::cp_async_commit();
  Tile t;
  while (true) {
    // the next step: this item's next key tile, or the next item's first
    int nidx = idx, nkt = kt + 1;
    Item nit = it;
    bool more = true;
    if (nkt == it.n_tiles) {
      nidx += 1;
      nkt = 0;
      more = nidx < end;
      if (more) nit = item_at(a, nidx);
    }
    if (more)
      load_step<T, HD, Tile::NT>(stages[s ^ 1], nkt ? nullptr : &qts[qp ^ 1],
                                 a, nit, nkt);
    rk::cp_async_commit();
    if (cache && it.bias_key != cached_key) {
      cache_bias<Tile::NT>(bias_tile, a, it);
      cached_key = it.bias_key;
    }
    rk::cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) t.begin(qts[qp], a, it);
    t.tile(stages[s], qts[qp], scratch, cache ? bias_tile : nullptr, a, it,
           kt);
    if (kt == it.n_tiles - 1) t.finish(a, it);
    if (!more) break;
    __syncthreads();  // stage s (and after an item's last tile, its Q and
                      // the bias cache) is refilled next
    if (nkt == 0) qp ^= 1;
    idx = nidx;
    it = nit;
    kt = nkt;
    s ^= 1;
  }
}

// at most 128 registers up to hd 64: four CTAs an SM
template <int HD>
__global__ void __launch_bounds__(MmaTile<HD>::NT, HD <= 64 ? 4 : 2)
    attention_kernel_mma(const AttnArgs a) {
  run<MmaTile<HD>, HD>(a);
}

template <int HD>
__global__ void __launch_bounds__(FfmaTile<HD>::NT)
    attention_kernel_ffma(const AttnArgs a) {
  run<FfmaTile<HD>, HD>(a);
}

// Launch the persistent grid: at most as many CTAs as fit on the card at
// once, none without an item.
template <typename Tile, int HD>
int launch(AttnArgs a, void (*kernel)(AttnArgs), cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tile, HD>();
  static int per_sm = -1, sms = 0;
  if (per_sm < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                          Tile::NT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm = n;
  }
  a.q_tiles = static_cast<int>((a.Sq + BQ - 1) / BQ);
  a.n_items = a.B * a.Hq * a.q_tiles;
  const int grid = min(a.n_items, sms * per_sm);
  kernel<<<grid, Tile::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_dtype(const AttnArgs& a, int dtype, cudaStream_t stream) {
  if (dtype == rk::BF16)
    return launch<MmaTile<HD>, HD>(a, attention_kernel_mma<HD>, stream);
  return launch<FfmaTile<HD>, HD>(a, attention_kernel_ffma<HD>, stream);
}

}  // namespace

// d: B, Hq, Hkv, Sq, Skv, nb, then the batch/head/row strides of q, k and
// v (3 each), the four bias strides, and hd. q, k, v rows 16-byte aligned
// (pointers and strides); bias_f32: the bias is fp32 (else bf16).
extern "C" int rk_flash_attention(const void* q, const void* k, const void* v,
                                  const void* bias, int bias_f32, void* out,
                                  const long long* d, float scale,
                                  int causal, int window, int q_offset,
                                  int dtype, void* stream) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.bias_f32 = bias_f32;
  a.out = out;
  a.B = static_cast<int>(d[0]);
  a.Hq = static_cast<int>(d[1]);
  a.Hkv = static_cast<int>(d[2]);
  a.Sq = static_cast<int>(d[3]);
  a.Skv = static_cast<int>(d[4]);
  a.nb = d[5] > 0 ? static_cast<int>(d[5]) : 1;
  a.group = a.Hq / a.Hkv;
  a.sqb = d[6];
  a.sqh = d[7];
  a.sqs = d[8];
  a.skb = d[9];
  a.skh = d[10];
  a.sks = d[11];
  a.svb = d[12];
  a.svh = d[13];
  a.svs = d[14];
  a.sbn = d[15];
  a.sbh = d[16];
  a.sbq = d[17];
  a.sbk = static_cast<int>(d[18]);
  a.scale = scale;
  a.inv_scale = 1.f / scale;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d[19]) {
    case 16: return dispatch_dtype<16>(a, dtype, s);
    case 32: return dispatch_dtype<32>(a, dtype, s);
    case 64: return dispatch_dtype<64>(a, dtype, s);
    case 128: return dispatch_dtype<128>(a, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
