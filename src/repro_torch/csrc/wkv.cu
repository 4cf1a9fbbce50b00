// WKV6 recurrence (RWKV6 "Finch" time-mix) for Hopper: two designs.
//
// Replaces the TPU kernel wkv_p (src/repro/kernels/wkv.py, body
// _wkv_kernel). Per (batch, head) the state S (P x P, fp32) stays on chip
// for the whole sequence, optionally starting from s0 (the decode step's
// cache); y is written in the input dtype, the final S in fp32. All math
// is fp32 with expf, not __expf: exp(-cs) reaches exp(56) inside a chunk
// and must keep fp32 accuracy.
//
// chunk (wkv_kernel_chunk), for prefill: 16-token chunks, as the TPU
// kernel and models/rwkv6.wkv_chunked walk them. Per chunk:
//   cs    = inclusive cumsum of the log decays lw, cs_prev = cs - lw
//   rd    = r * exp(cs_prev),  kd = k * exp(-cs),  tk = exp(cs_L - cs) * k
//   A     = rd @ kd^T, strictly lower triangle, plus the bonus diagonal
//           sum_c r[i,c] u[c] k[i,c]
//   y     = A @ v + rd @ S
//   S     = exp(cs_L) * S + tk^T @ v
// A cluster of P/16 CTAs serves one (b, h), so B x H x P/16 CTAs fill the
// card even at B=1 (40 heads of 64). CTA rank j owns channels c0 = 16j ..
// c0+15: the element pass (the exps) of those channels, A's partial sums
// over them, and rows c0 .. c0+15 of S, kept in registers across the
// sequence (a 2 x 4 tile a thread). Both are computed once per (b, h) per
// chunk. Row c of S takes only channel c's decays and keys, so the
// recurrence stays inside the CTA; y is linear in the channels, so each
// CTA writes its part, A_j @ v + rd_j @ S_j (16 tokens x P columns), to
// distributed shared memory and sums the cluster's parts (in rank order,
// the same bits on every run) for its own 16 columns. The cluster barrier
// is split around the state update and the next element pass, and the
// parts are read while the next A is computed, which hides the barrier's
// and distributed shared memory's latency. Products
// come from register tiles (4 x 2 of y, 2 x 4 of S, 4 x 4 of A with its
// sums split over 8 lanes and reduced by shuffles) over padded rows that
// keep shared loads free of bank conflicts; each 16-byte load feeds 8 or
// more FMAs. cp.async stages the next chunk's r, k, lw (this CTA's
// channels) and v (all columns) while the current one computes. Four CTA
// barriers and one cluster barrier per chunk.
// Bound: bytes. One launch reads r, k, v, lw once and writes y and S once;
// at B=4, S=512, 40 heads of 64, ~84 MB in and ~24 MB out (~32 us at
// 3.35 TB/s) against ~1.7 GFLOP (~25 us at 67 TFLOP/s fp32).
//
// step (wkv_kernel_step), for decode (a few tokens): the recurrence one
// token at a time, y = r . (S + u k v^T), S = exp(lw) S + k v^T, with S in
// registers: one CTA of 4P threads per (b, h), each thread a P/16-row x
// 4-column tile, y summed over the rows by shuffles. One pass that reads
// s0 and writes the new state once (~5 MB at B=4: ~1.6 us).
//
// Against the TPU kernel: its grid walked one (b, h)'s chunks in order
// with S in VMEM scratch; here a loop inside the CTA walks them. Its
// wrapper transposed r, k, v, lw to (B*H, S, P) and padded the ragged
// tail in HBM with lw = 0; here they are read in place with their
// (B, S, H) strides, the loads past S are zero-filled (r = k = v = 0 and
// lw = 0 leave y and S exact) and the stores past S skipped.
#include <cooperative_groups.h>

#include "common.cuh"
#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int L = 16;          // tokens per chunk
constexpr int W = 16;          // channels and state columns per CTA
constexpr int THREADS = 128;   // chunk design
constexpr unsigned FULL = 0xffffffffu;

enum Design { CHUNK = 0, STEP = 1 };

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* lw;
  const float* u;
  const float* s0;
  void* y;
  float* s_fin;
  long long sr[3], sk[3], sv[3], sw[3];  // (B, S, H) strides, in elements
  int b, s, h;
};

// One chunk of this CTA's operands as loaded: r, k, lw at its channels,
// v at every column; rows of 16 tokens, padded by 16 bytes.
template <typename T, int P>
struct Stage {
  static constexpr int PAD = 16 / sizeof(T);
  T x[3][L][W + PAD];  // r, k, lw
  T v[L][P + PAD];
};

// Rows padded by 4 floats: the 8 lanes of a quarter warp that read 8
// consecutive rows at one column hit 8 distinct bank groups.
template <typename T, int P>
struct ChunkSmem {
  Stage<T, P> stage[2];
  float ypart[2][L][P + 4];  // this CTA's part of y, by chunk parity: read
                             // by the whole cluster
  float rd_t[W][L + 4];      // rd, channel-major
  float kd_t[W][L + 4];      // kd, channel-major
  float ruk_t[W][L + 4];     // r * u * k, channel-major
  float tk[L][W + 4];        // exp(cs_L - cs) * k
  float dec[W];              // exp(cs_L)
  float a_t[L][L + 4];       // A over this CTA's channels, transposed (j, i)
  float s_t[W][P + 4];       // this CTA's rows of S, for rd @ S
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// N consecutive elements at p (fp32 or bf16), in fp32
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = p[i];
}
template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
}

__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(x[m], y[n], acc[m][n]);
}

// A 4 x 4 tile whose sums 8 lanes (lane % 8 = s) hold parts of, summed
// across them: lane s keeps row s >> 1, columns 2 (s & 1) + {0, 1}.
__device__ __forceinline__ void reduce_tile8(const float (&acc)[4][4],
                                             float (&out)[2], int s) {
  const bool b2 = s & 4, b1 = s & 2, b0 = s & 1;
  float h[2][4], q[4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float mine = b2 ? acc[m + 2][n] : acc[m][n];
      const float give = b2 ? acc[m][n] : acc[m + 2][n];
      h[m][n] = mine + __shfl_xor_sync(FULL, give, 4);
    }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float mine = b1 ? h[1][n] : h[0][n];
    const float give = b1 ? h[0][n] : h[1][n];
    q[n] = mine + __shfl_xor_sync(FULL, give, 2);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float mine = b0 ? q[n + 2] : q[n];
    const float give = b0 ? q[n] : q[n + 2];
    out[n] = mine + __shfl_xor_sync(FULL, give, 1);
  }
}

// The parts of y that the cluster's NQ CTAs hold at the same place p of
// their shared memory.
template <int NQ>
__device__ __forceinline__ void read_parts(cg::cluster_group& cluster,
                                           float* p, float2 (&part)[NQ]) {
#pragma unroll
  for (int r = 0; r < NQ; ++r) part[r] = ld2(cluster.map_shared_rank(p, r));
}

// Six CTAs an SM (80 registers) for fp32 at P = 64, RWKV6-3B's recurrence:
// all 160 clusters of a B=4 prefill fit at once. Four elsewhere.
template <typename T, int P>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(T) == 4 && P == 64 ? 6 : 4)
    wkv_kernel_chunk(const WkvArgs a) {
  static_assert(P % W == 0 && P <= 64, "P in {16, 32, 64}");
  constexpr int NQ = P / W;            // CTAs per (b, h)
  constexpr int EPP = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int ACT = 2 * P;           // threads with a tile of y and S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<ChunkSmem<T, P>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / NQ, b = bh / a.h, hh = bh % a.h;
  const int c0 = rank * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (a.s + L - 1) / L;

  const T* src[4] = {
      static_cast<const T*>(a.r) + b * a.sr[0] + hh * a.sr[2] + c0,
      static_cast<const T*>(a.k) + b * a.sk[0] + hh * a.sk[2] + c0,
      static_cast<const T*>(a.lw) + b * a.sw[0] + hh * a.sw[2] + c0,
      static_cast<const T*>(a.v) + b * a.sv[0] + hh * a.sv[2]};
  const long long step[4] = {a.sr[1], a.sk[1], a.sw[1], a.sv[1]};

  // chunk ci into its stage: one commit group, empty past the last chunk
  auto load = [&](int ci) {
    if (ci < n_chunks) {
      Stage<T, P>& st = sm.stage[ci & 1];
#pragma unroll
      for (int x = 0; x < 3; ++x)
        for (int e = tid; e < L * W / EPP; e += THREADS) {
          const int row = e / (W / EPP), col = e % (W / EPP) * EPP;
          const int t = ci * L + row;
          const bool in = t < a.s;
          rk::cp_async16(&st.x[x][row][col],
                         src[x] + (in ? t * step[x] : 0) + col, in);
        }
      for (int e = tid; e < L * P / EPP; e += THREADS) {
        const int row = e / (P / EPP), col = e % (P / EPP) * EPP;
        const int t = ci * L + row;
        const bool in = t < a.s;
        rk::cp_async16(&st.v[row][col],
                       src[3] + (in ? t * step[3] : 0) + col, in);
      }
    }
    rk::cp_async_commit();
  };

  // this thread's tile of S: rows sr0, sr0 + 1 (of this CTA's 16),
  // columns sq0 .. sq0 + 3
  const bool owner = tid < ACT;
  const int sr0 = 2 * (tid / (P / 4)), sq0 = 4 * (tid % (P / 4));
  float sreg[2][4];
  const long long sbase =
      (static_cast<long long>(bh) * P + c0 + sr0) * P + sq0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float4 x = owner && a.s0 ? ld4(&a.s0[sbase + m * P])
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    sreg[m][0] = x.x;
    sreg[m][1] = x.y;
    sreg[m][2] = x.z;
    sreg[m][3] = x.w;
    if (owner)
      *reinterpret_cast<float4*>(&sm.s_t[sr0 + m][sq0]) = x;
  }

  // element pass: token ti of channels ech and ech + 8
  const int ti = lane % L, ech = warp * 2 + lane / L;
  float ue[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) ue[e] = a.u[hh * P + c0 + ech + 8 * e];
  // A's 4 x 4 tile tid / 8, its channels split over the 8 lanes tid % 8
  const int sp = tid & 7, ai0 = (tid >> 5) * 4, aj0 = ((tid >> 3) & 3) * 4;
  // y's 4 x 2 tile: tokens yi0 .., columns yq0, yq0 + 1
  const int yi0 = 4 * (tid / (P / 2)), yq0 = 2 * (tid % (P / 2));
  // the sum of y's parts: token gi, columns c0 + gq, c0 + gq + 1 (its
  // part read as a float2 from each CTA)
  const int gi = tid >> 3, gq = 2 * (tid & 7);

  // 5. y at this CTA's columns, token gi of chunk ci: the cluster's parts
  // summed in rank order (read after the cluster barrier of chunk ci)
  auto store_y = [&](const float2 (&part)[NQ], int ci) {
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int p = 0; p < NQ; ++p) {
      y0 += part[p].x;
      y1 += part[p].y;
    }
    const int t = ci * L + gi;
    if (t < a.s) {
      T* y = static_cast<T*>(a.y) +
             ((static_cast<long long>(b) * a.s + t) * a.h + hh) * P + c0 + gq;
      y[0] = rk::from_f32<T>(y0);
      y[1] = rk::from_f32<T>(y1);
    }
  };

  load(0);
  rk::cp_async_wait<0>();
  __syncthreads();

  for (int ci = 0; ci < n_chunks; ++ci) {
    const Stage<T, P>& st = sm.stage[ci & 1];
    load(ci + 1);  // its stage was last read before the previous barrier

    // 1. the element pass over this CTA's 16 channels
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = ech + 8 * e;
      const float rr = rk::to_f32(st.x[0][ti][ch]);
      const float kk = rk::to_f32(st.x[1][ti][ch]);
      const float ww = rk::to_f32(st.x[2][ti][ch]);
      float cs = ww;
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {
        const float n = __shfl_up_sync(FULL, cs, o, L);
        if (ti >= o) cs += n;
      }
      const float cl = __shfl_sync(FULL, cs, L - 1, L);
      const float kd = kk * expf(-cs), dec = expf(cl);
      sm.rd_t[ch][ti] = rr * expf(cs - ww);
      sm.kd_t[ch][ti] = kd;
      sm.tk[ti][ch] = kd * dec;  // exp(cs_L - cs) * k
      sm.ruk_t[ch][ti] = rr * ue[e] * kk;
      if (ti == 0) sm.dec[ch] = dec;
    }
    // the previous chunk's parts of y, read while A is computed
    float2 part[NQ];
    if (ci > 0) {
      rk::cluster_wait();
      read_parts(cluster, &sm.ypart[(ci - 1) & 1][gi][c0 + gq], part);
    }
    __syncthreads();

    // 2. A over this CTA's channels (sp, sp + 8 in this lane): strictly
    // below the diagonal rd . kd, on it r . u k
    {
      float acc[4][4] = {}, dg[4] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = sp + 8 * e;
        outer4(acc, ld4(&sm.rd_t[c][ai0]), ld4(&sm.kd_t[c][aj0]));
        const float4 ru = ld4(&sm.ruk_t[c][ai0]);
        dg[0] += ru.x;
        dg[1] += ru.y;
        dg[2] += ru.z;
        dg[3] += ru.w;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int i = ai0 + m, j = aj0 + n;
          acc[m][n] = j < i ? acc[m][n] : (j == i ? dg[m] : 0.f);
        }
      float out[2];
      reduce_tile8(acc, out, sp);
      const int i = ai0 + (sp >> 1), j = aj0 + 2 * (sp & 1);
      sm.a_t[j][i] = out[0];
      sm.a_t[j + 1][i] = out[1];
    }
    if (ci > 0) store_y(part, ci - 1);
    __syncthreads();

    // 3. this CTA's part of y: A @ v + rd @ S over its channels, all
    // columns, into its exchange slot
    if (owner) {
      float acc[4][2] = {};
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float4 a4 = ld4(&sm.a_t[j][yi0]);
        float vv[2];
        load_f(&st.v[j][yq0], vv);
        const float x[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) acc[m][n] = fmaf(x[m], vv[n], acc[m][n]);
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const float4 r4 = ld4(&sm.rd_t[c][yi0]);
        const float2 s2 = ld2(&sm.s_t[c][yq0]);
        const float x[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m][0] = fmaf(x[m], s2.x, acc[m][0]);
          acc[m][1] = fmaf(x[m], s2.y, acc[m][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<float2*>(&sm.ypart[ci & 1][yi0 + m][yq0]) =
            make_float2(acc[m][0], acc[m][1]);
    }
    rk::cluster_arrive();
    __syncthreads();  // every read of S is done

    // 4. this CTA's rows of S: exp(cs_L) S + tk^T @ v; the cluster barrier
    // completes meanwhile, and is waited for after the next element pass
    if (owner) {
      float kv[2][4] = {};
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float2 t2 = ld2(&sm.tk[j][sr0]);
        float vv[4];
        load_f(&st.v[j][sq0], vv);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          kv[0][n] = fmaf(t2.x, vv[n], kv[0][n]);
          kv[1][n] = fmaf(t2.y, vv[n], kv[1][n]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          sreg[m][n] = sm.dec[sr0 + m] * sreg[m][n] + kv[m][n];
        *reinterpret_cast<float4*>(&sm.s_t[sr0 + m][sq0]) =
            make_float4(sreg[m][0], sreg[m][1], sreg[m][2], sreg[m][3]);
      }
    }
    rk::cp_async_wait<0>();  // chunk ci + 1 has landed
    __syncthreads();
  }

  if (owner)
#pragma unroll
    for (int m = 0; m < 2; ++m)
      *reinterpret_cast<float4*>(&a.s_fin[sbase + m * P]) =
          make_float4(sreg[m][0], sreg[m][1], sreg[m][2], sreg[m][3]);
  {
    float2 part[NQ];
    rk::cluster_wait();
    read_parts(cluster, &sm.ypart[(n_chunks - 1) & 1][gi][c0 + gq], part);
    store_y(part, n_chunks - 1);
  }
  // no CTA leaves while another may still read its part of y
  rk::cluster_arrive();
  rk::cluster_wait();
}

// The step design: CTA (b, h) of 4P threads; warp w owns columns 8w ..
// 8w+7, lane l columns 8w + 4 (l & 1) + {0..3} of rows l / 2 + 16 m.
template <typename T, int P>
__global__ void __launch_bounds__(4 * P) wkv_kernel_step(const WkvArgs a) {
  constexpr int R = P / 16;  // rows per thread
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = warp * 8 + (lane & 1) * 4, rg = lane >> 1;
  const T* r = static_cast<const T*>(a.r) + b * a.sr[0] + hh * a.sr[2];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + hh * a.sk[2];
  const T* lw = static_cast<const T*>(a.lw) + b * a.sw[0] + hh * a.sw[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + hh * a.sv[2];
  const long long sbase = static_cast<long long>(bh) * P * P + q;

  float s[R][4], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int c = rg + 16 * m;
    uu[m] = a.u[hh * P + c];
    const float4 x = a.s0 ? ld4(&a.s0[sbase + c * P])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    s[m][0] = x.x;
    s[m][1] = x.y;
    s[m][2] = x.z;
    s[m][3] = x.w;
  }

  // token t's operands, fetched one token ahead
  float nr[R], nk[R], nw[R], nv[4];
  auto fetch = [&](int t) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int c = rg + 16 * m;
      nr[m] = rk::to_f32(r[t * a.sr[1] + c]);
      nk[m] = rk::to_f32(k[t * a.sk[1] + c]);
      nw[m] = rk::to_f32(lw[t * a.sw[1] + c]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) nv[n] = rk::to_f32(v[t * a.sv[1] + q + n]);
  };
  fetch(0);
  for (int t = 0; t < a.s; ++t) {
    float rr[R], kk[R], ww[R], vv[4];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      rr[m] = nr[m];
      kk[m] = nk[m];
      ww[m] = nw[m];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) vv[n] = nv[n];
    if (t + 1 < a.s) fetch(t + 1);

    float y[4] = {};
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float uk = uu[m] * kk[m];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        y[n] = fmaf(rr[m], fmaf(uk, vv[n], s[m][n]), y[n]);
    }
#pragma unroll
    for (int o = 2; o < 32; o <<= 1)
#pragma unroll
      for (int n = 0; n < 4; ++n) y[n] += __shfl_xor_sync(FULL, y[n], o);
    if (rg == 0) {
      T* yp = static_cast<T*>(a.y) +
              ((static_cast<long long>(b) * a.s + t) * a.h + hh) * P + q;
#pragma unroll
      for (int n = 0; n < 4; ++n) yp[n] = rk::from_f32<T>(y[n]);
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float dw = expf(ww[m]);
#pragma unroll
      for (int n = 0; n < 4; ++n) s[m][n] = fmaf(dw, s[m][n], kk[m] * vv[n]);
    }
  }

#pragma unroll
  for (int m = 0; m < R; ++m)
    *reinterpret_cast<float4*>(&a.s_fin[sbase + (rg + 16 * m) * P]) =
        make_float4(s[m][0], s[m][1], s[m][2], s[m][3]);
}

template <typename T, int P>
cudaError_t launch_chunk(const WkvArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.h * (P / W));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(ChunkSmem<T, P>);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P / W;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wkv_kernel_chunk<T, P>, a);
}

template <typename T, int P>
cudaError_t launch(const WkvArgs& a, int design, cudaStream_t stream) {
  if (design == CHUNK) return launch_chunk<T, P>(a, stream);
  wkv_kernel_step<T, P><<<a.b * a.h, 4 * P, 0, stream>>>(a);
  return cudaSuccess;
}

template <typename T>
int launch_p(const WkvArgs& a, int p, int design, cudaStream_t stream) {
  cudaError_t err;
  switch (p) {
    case 16: err = launch<T, 16>(a, design, stream); break;
    case 32: err = launch<T, 32>(a, design, stream); break;
    case 64: err = launch<T, 64>(a, design, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: (B, S, H) strides of r, k, v, lw in turn (12 values); the
// head dim has unit stride. y is written contiguous (B, S, H, P).
// design: 0 chunk (r, k, v, lw 16-byte aligned, with strides to match),
// 1 step.
extern "C" int rk_wkv(const void* r, const void* k, const void* v,
                      const void* lw, const void* u, const void* s0, void* y,
                      void* s_fin, const long long* strides, int b, int s,
                      int h, int p, int dtype, int design, void* stream) {
  WkvArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.lw = lw;
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = y;
  a.s_fin = static_cast<float*>(s_fin);
  for (int i = 0; i < 3; ++i) {
    a.sr[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sw[i] = strides[9 + i];
  }
  a.b = b;
  a.s = s;
  a.h = h;
  if (design != CHUNK && design != STEP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rk::BF16) return launch_p<__nv_bfloat16>(a, p, design, st);
  return launch_p<float>(a, p, design, st);
}
