// Flash attention backward for Hopper (sm_90a): dq, dk, dv of the
// forward in flash_attention.cu, FlashAttention-2's schedule, with no
// atomics, so two calls give the same bits.
//
// The TPU side has no backward kernel: the reference trains through the
// jnp twin of `flash_attention_pallas` (src/repro/models/attention.py,
// `flash_attention`), differentiated by JAX.  This computes that gradient
// for the port's K1, with the forward's contract: q (b, sq, h, hd), k/v
// (b, skv, h, hd) with GQA heads already repeated, scale 1/sqrt(hd), an
// optional tanh softcap, a causal mask aligned from position 0, a sliding
// window, the finite -1e30 mask value, f32 statistics, gradients in q's
// type.  With S the masked scores, P = softmax(S) and o, dO the forward's
// output and its gradient:
//   D = rowsum(dO * o), dS = P (dO V^T - D) (times 1 - tanh^2(s / c)
//   under a softcap), dV = P^T dO, dQ = dS K scale, dK = dS^T Q scale.
//
// Three kernels, launched in order on the caller's stream:
//   (a) stats: one block per (64-row q tile, head, batch); recomputes each
//       row's log-sum-exp over the kv tiles the forward visits, and D, in
//       f32, into (b, h, sq) scratch;
//   (b) dK/dV: one block per (64-row kv tile, head, batch); walks the q
//       tiles that see its kv tile (the forward's causal and window tile
//       skipping, turned around), recomputes S and P = exp(S - LSE), and
//       accumulates dV and dK in registers;
//   (c) dQ: one block per (q tile, head, batch); walks the kv tiles and
//       accumulates dQ in registers.
// Each output element is written by one thread, once.
//
// What bounds it: 5 products of 2 hd FLOPs per unmasked (query, key)
// pair (S twice, dP twice, and dV, dK, dQ: S and dP are each computed in
// (b) and in (c)), at the training shape (4, 2048, 36, 64) bf16 causal
// 193 GFLOP, 0.196 ms at 989 TFLOP/s, above its 302 MB of q/k/v/o/dO/
// dq/dk/dv (0.090 ms).  This first design is simple and right: bf16
// products through mma.sync m16n8k16 with f32 accumulators from 4 warps
// (each owning 16 rows), tiles loaded between barriers with no overlap;
// f32 through FMAs on the CUDA cores (TF32 would not hold f32 to its
// tolerance).  wgmma and TMA are later work (ROADMAP Queue 2).
//
// Head dims up to 128, padded to 16/32/64/128 lanes in shared memory
// (zero-filled, masked on store), so hd 120 works.  q/k/v/o/dO are read
// through their strides (head-dim stride 1), so expanded GQA views need no
// copy.  The scale: f32 scales q in shared memory before its products, as
// the twin does; bf16 scales the f32 product afterwards (q scaled in bf16
// would round; for a power-of-two scale, as at hd 64, the two agree
// exactly).
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // key/value rows per tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // (b, h, sq) f32 scratch
  float* delta;   // (b, h, sq) f32 scratch
  int b, sq, skv, h, hd;
  // (batch, seq, head) element strides of q, k, v, o, dO, dq, dk, dv
  long long s[8][3];
  float scale, softcap;
  int causal, window;
  int vec;   // q/k/v/dO allow 16-byte loads: aligned pointers, strides % 8
};

// which tensor's strides (Params::s)
enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

template <typename T>
__device__ __forceinline__ const T* slice(const Params& p, const void* base,
                                          int which, int bb, int hh) {
  return static_cast<const T*>(base) + bb * p.s[which][0] +
         hh * p.s[which][2];
}

template <typename T>
__device__ __forceinline__ T* slice_out(const Params& p, void* base,
                                        int which, int bb, int hh) {
  return static_cast<T*>(base) + bb * p.s[which][0] + hh * p.s[which][2];
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The kv tiles that hold an unmasked key for some row of the q tile at q0
// (the forward's kv_tile_range).
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0,
                                              int* begin, int* end) {
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int kt_end = (p.skv + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;
    if (lo > 0) kt_begin = lo / BK;
  }
  *begin = kt_begin;
  *end = kt_end;
}

// The q tiles that hold a row with an unmasked key in the kv tile at k0:
// causal rows start at k0; a window ends them at the tile's last key +
// window - 1.
__device__ __forceinline__ void q_tile_range(const Params& p, int k0,
                                             int* begin, int* end) {
  int qt_end = (p.sq + BQ - 1) / BQ;
  if (p.window > 0) {
    const int k_last = min(k0 + BK, p.skv) - 1;
    qt_end = min(qt_end, (k_last + p.window - 1) / BQ + 1);
  }
  *begin = p.causal ? k0 / BQ : 0;
  *end = qt_end;
}

// The score of one (query, key) pair from its scaled product x: softcap
// and the masks of the forward.  *dcap is d score / d x under the softcap
// (1 - tanh^2), else 1.
__device__ __forceinline__ float masked_score(const Params& p, float x,
                                              int qp, int kp, float* dcap) {
  float g = 1.f;
  if (p.softcap != 0.f) {
    const float t = tanhf(x / p.softcap);
    x = t * p.softcap;
    g = 1.f - t * t;
  }
  bool ok = kp < p.skv && qp < p.sq;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window > 0) ok = ok && qp - kp < p.window;
  *dcap = g;
  return ok ? x : NEG_INF;
}

// Offset of (batch, head) in the (b, h, sq) statistics.
__device__ __forceinline__ long long stat_base(const Params& p, int bb,
                                               int hh) {
  return (static_cast<long long>(bb) * p.h + hh) * p.sq;
}

// D = rowsum(dO * o) of the q tile at q0, one warp a row.
template <typename T>
__device__ void tile_delta(const Params& p, int q0, int bb, int hh) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* og = slice<T>(p, p.o, O, bb, hh);
  const T* dg = slice<T>(p, p.dout, DO, bb, hh);
  float* out = p.delta + stat_base(p, bb, hh);
  for (int i = threadIdx.x >> 5; i < BQ; i += warps) {
    const int row = q0 + i;
    if (row >= p.sq) break;
    float acc = 0.f;
    for (int d = lane; d < p.hd; d += 32)
      acc = fmaf(to_f(og[row * p.s[O][1] + d]),
                 to_f(dg[row * p.s[DO][1] + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = acc;
  }
}

// ------------------------------------------------------------ f32 path
//
// 256 threads as a 16 x 16 grid; thread (ty, tx) owns a 4 x 4 block of
// each 64 x 64 score tile (rows ty*4.., columns tx*4..) and 4 rows x
// HDP/16 columns (tx + 16c) of its gradient tile.  Tiles are staged
// transposed (d-major, row stride TS) so the score loop reads float4s.

constexpr int FMA_THREADS = 256;
constexpr int TS = 64 + 4;        // stride of transposed tiles

// rows [row0, row0 + 64) of a (seq, hd) slice, times `mul`, into a
// transposed tile dst[d * TS + i]; rows past `nrows`, lanes past hd zero
template <int HDP>
__device__ __forceinline__ void load_t_f32(float* dst, const float* src,
                                           long long ss, int row0, int nrows,
                                           int hd, float mul) {
  for (int e = threadIdx.x; e < 64 * HDP; e += FMA_THREADS) {
    const int i = e / HDP, d = e % HDP;
    const int row = row0 + i;
    dst[d * TS + i] = (row < nrows && d < hd) ? src[row * ss + d] * mul : 0.f;
  }
}

// c[r][j] = sum_d a[d][ty*4 + r] * b[d][tx*4 + j] over transposed tiles
template <int HDP>
__device__ __forceinline__ void tile_dot_f32(const float* a, const float* b,
                                             int ty, int tx, float c[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[r][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HDP; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * TS + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + d * TS + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[r][j] = fmaf(xv[r], yv[j], c[r][j]);
  }
}

// c[r][j] of the 4 x 4 block, transposed into m[(tx*4 + j) * TS + ty*4 + r]
__device__ __forceinline__ void store_t_f32(float* m, const float c[4][4],
                                            int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(m + (tx * 4 + j) * TS + ty * 4) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
}

// acc[r][c] += sum_i m[i][ty*4 + r] * x[tx + 16c][i]: m is (64 x TS) with
// the contracted index first, x a transposed (HDP x TS) tile
template <int HDP>
__device__ __forceinline__ void tile_acc_f32(const float* m, const float* x,
                                             int ty, int tx,
                                             float acc[4][HDP / 16]) {
#pragma unroll 4
  for (int i = 0; i < 64; ++i) {
    const float4 mi = *reinterpret_cast<const float4*>(m + i * TS + ty * 4);
    const float mv[4] = {mi.x, mi.y, mi.z, mi.w};
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) {
      const float xv = x[(tx + 16 * c) * TS + i];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(mv[r], xv, acc[r][c]);
    }
  }
}

// rows [row0, row0 + 64) of an output slice from acc[r][c] (row ty*4 + r,
// column tx + 16c), times `mul`
template <int HDP>
__device__ __forceinline__ void store_rows_f32(float* dst, long long ss,
                                               int row0, int nrows, int hd,
                                               const float acc[4][HDP / 16],
                                               int ty, int tx, float mul) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) dst[row * ss + col] = acc[r][c] * mul;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(FMA_THREADS)
    bwd_stats_f32(const Params p) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + HDP * TS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  load_t_f32<HDP>(qt, slice<float>(p, p.q, Q, bb, hh), p.s[Q][1], q0, p.sq,
                  p.hd, p.scale);
  const float* kg = slice<float>(p, p.k, K, bb, hh);
  int kt_begin, kt_end;
  kv_tile_range(p, q0, &kt_begin, &kt_end);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  for (int t = kt_begin; t < kt_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_t_f32<HDP>(kt, kg, p.s[K][1], k0, p.skv, p.hd, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot_f32<HDP>(qt, kt, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      float mx = NEG_INF, g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = masked_score(p, s[r][j], qp, k0 + tx * 4 + j, &g);
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[r][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * expf(m[r] - m_new) + rs;
      m[r] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      if (row < p.sq) p.lse[stat_base(p, bb, hh) + row] = m[r] + logf(l[r]);
    }
  }
  tile_delta<float>(p, q0, bb, hh);
}

template <int HDP>
__global__ void __launch_bounds__(FMA_THREADS)
    bwd_dkdv_f32(const Params p) {
  constexpr int NC = HDP / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + HDP * TS;
  float* qt = vt + HDP * TS;     // q scaled
  float* dt = qt + HDP * TS;     // dO
  float* pt = dt + HDP * TS;     // P^T, then dS^T: [q i][kv j]
  float* st = pt + 64 * TS;
  float* lse_s = st + 64 * TS;
  float* dl_s = lse_s + BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BK;   // causal: the first kv tiles see most
  const int hh = blockIdx.y, bb = blockIdx.z;
  load_t_f32<HDP>(kt, slice<float>(p, p.k, K, bb, hh), p.s[K][1], k0, p.skv,
                  p.hd, 1.f);
  load_t_f32<HDP>(vt, slice<float>(p, p.v, V, bb, hh), p.s[V][1], k0, p.skv,
                  p.hd, 1.f);
  const float* qg = slice<float>(p, p.q, Q, bb, hh);
  const float* dg = slice<float>(p, p.dout, DO, bb, hh);
  const long long base = stat_base(p, bb, hh);
  int qt_begin, qt_end;
  q_tile_range(p, k0, &qt_begin, &qt_end);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;
  for (int it = qt_begin; it < qt_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_t_f32<HDP>(qt, qg, p.s[Q][1], q0, p.sq, p.hd, p.scale);
    load_t_f32<HDP>(dt, dg, p.s[DO][1], q0, p.sq, p.hd, 1.f);
    for (int e = threadIdx.x; e < BQ; e += FMA_THREADS) {
      const bool in = q0 + e < p.sq;
      lse_s[e] = in ? p.lse[base + q0 + e] : 0.f;
      dl_s[e] = in ? p.delta[base + q0 + e] : 0.f;
    }
    __syncthreads();
    // S^T (kv rows ty*4 + r, q columns tx*4 + j), then dP^T
    float s[4][4], dp[4][4];
    tile_dot_f32<HDP>(kt, qt, ty, tx, s);
    tile_dot_f32<HDP>(vt, dt, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx * 4 + j;
        float g;
        const float x =
            masked_score(p, s[r][j], q0 + qi, k0 + ty * 4 + r, &g);
        const float pr = expf(x - lse_s[qi]);
        s[r][j] = pr;
        dp[r][j] = pr * (dp[r][j] - dl_s[qi]) * g;
      }
    store_t_f32(pt, s, ty, tx);
    store_t_f32(st, dp, ty, tx);
    __syncthreads();
    tile_acc_f32<HDP>(pt, dt, ty, tx, dv);   // dV += P^T dO
    tile_acc_f32<HDP>(st, qt, ty, tx, dk);   // dK += dS^T (q scale)
  }
  store_rows_f32<HDP>(slice_out<float>(p, p.dk, DK, bb, hh), p.s[DK][1], k0,
                      p.skv, p.hd, dk, ty, tx, 1.f);
  store_rows_f32<HDP>(slice_out<float>(p, p.dv, DV, bb, hh), p.s[DV][1], k0,
                      p.skv, p.hd, dv, ty, tx, 1.f);
}

template <int HDP>
__global__ void __launch_bounds__(FMA_THREADS)
    bwd_dq_f32(const Params p) {
  constexpr int NC = HDP / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // q scaled
  float* dt = qt + HDP * TS;                     // dO
  float* kt = dt + HDP * TS;
  float* vt = kt + HDP * TS;
  float* st = vt + HDP * TS;                     // dS^T: [kv j][q i]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  load_t_f32<HDP>(qt, slice<float>(p, p.q, Q, bb, hh), p.s[Q][1], q0, p.sq,
                  p.hd, p.scale);
  load_t_f32<HDP>(dt, slice<float>(p, p.dout, DO, bb, hh), p.s[DO][1], q0,
                  p.sq, p.hd, 1.f);
  const float* kg = slice<float>(p, p.k, K, bb, hh);
  const float* vg = slice<float>(p, p.v, V, bb, hh);
  const long long base = stat_base(p, bb, hh);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    lse_r[r] = row < p.sq ? p.lse[base + row] : 0.f;
    dl_r[r] = row < p.sq ? p.delta[base + row] : 0.f;
  }
  int kt_begin, kt_end;
  kv_tile_range(p, q0, &kt_begin, &kt_end);
  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;
  for (int t = kt_begin; t < kt_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_t_f32<HDP>(kt, kg, p.s[K][1], k0, p.skv, p.hd, 1.f);
    load_t_f32<HDP>(vt, vg, p.s[V][1], k0, p.skv, p.hd, 1.f);
    __syncthreads();
    // S (q rows ty*4 + r, kv columns tx*4 + j), then dP
    float s[4][4], dp[4][4];
    tile_dot_f32<HDP>(qt, kt, ty, tx, s);
    tile_dot_f32<HDP>(dt, vt, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float g;
        const float x =
            masked_score(p, s[r][j], q0 + ty * 4 + r, k0 + tx * 4 + j, &g);
        dp[r][j] = expf(x - lse_r[r]) * (dp[r][j] - dl_r[r]) * g;
      }
    store_t_f32(st, dp, ty, tx);
    __syncthreads();
    tile_acc_f32<HDP>(st, kt, ty, tx, dq);   // dQ += dS K
  }
  store_rows_f32<HDP>(slice_out<float>(p, p.dq, DQ, bb, hh), p.s[DQ][1], q0,
                      p.sq, p.hd, dq, ty, tx, p.scale);
}

// ----------------------------------------------------------- bf16 path
//
// 128 threads, 4 warps, each owning 16 rows of the block's tile (q rows in
// (a) and (c), kv rows in (b)).  mma.sync m16n8k16 fragments as in the
// forward's general variant: a thread holds rows g and g + 8 (g = lane /
// 4) at columns t*2, t*2 + 1 (t = lane % 4) of each 8-column n-tile.  A
// product whose B operand has the contracted index along rows (P^T dO,
// dS^T Q, dS K) reads B with ldmatrix.trans; the others read it as stored.

constexpr int MMA_THREADS = 128;

template <int HDP>
__host__ __device__ constexpr int mma_ld() { return HDP + 8; }  // smem row

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [row0, row0 + 64) of a (seq, hd) slice with row stride `ss` into a
// padded smem tile; rows past `nrows` and lanes past `hd` are zero.
template <int HDP>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int row0,
    int nrows, int hd, bool vec) {
  constexpr int LD = mma_ld<HDP>();
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {   // 8 lanes per 16-byte chunk; hd % 8 == 0 here
    constexpr int CPR = HDP / 8;   // chunks per row
    for (int c = threadIdx.x; c < 64 * CPR; c += MMA_THREADS) {
      const int i = c / CPR, d = (c % CPR) * 8;
      const int row = row0 + i;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows && d < hd)
        x = *reinterpret_cast<const uint4*>(src + row * ss + d);
      *reinterpret_cast<uint4*>(dst + i * LD + d) = x;
    }
  } else {
    for (int e = threadIdx.x; e < 64 * HDP; e += MMA_THREADS) {
      const int i = e / HDP, d = e % HDP;
      const int row = row0 + i;
      dst[i * LD + d] = (row < nrows && d < hd) ? src[row * ss + d] : zero;
    }
  }
}

// c (this warp's 16 rows x 64 columns) = A B^T, where A's rows are rows
// `r0`.. of tile a and B's are the 64 rows of tile b, both (rows, hd)
template <int HDP>
__device__ __forceinline__ void mma_abt(float c[8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int r0) {
  constexpr int LD = mma_ld<HDP>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const __nv_bfloat16* pa = a + (r0 + g) * LD + kk * 16 + t * 2;
    const uint32_t af[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                            ld_u32(pa + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* pb = b + (n * 8 + g) * LD + kk * 16 + t * 2;
      mma_bf16(c[n], af, ld_u32(pb), ld_u32(pb + 8));
    }
  }
}

// acc (this warp's 16 rows x HDP) += M X, where M (16 x 64) is held in
// score-fragment form (c[n] of mma_abt) and X is a (64, hd) tile whose
// rows are the contracted index
template <int HDP>
__device__ __forceinline__ void mma_acc(float acc[HDP / 8][4],
                                        const float m[8][4],
                                        const __nv_bfloat16* x) {
  constexpr int LD = mma_ld<HDP>();
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;    // the 8x8 matrix this lane addresses
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(m[2 * j][0], m[2 * j][1]),
                           pack_bf16(m[2 * j][2], m[2 * j][3]),
                           pack_bf16(m[2 * j + 1][0], m[2 * j + 1][1]),
                           pack_bf16(m[2 * j + 1][2], m[2 * j + 1][3])};
    const __nv_bfloat16* row =
        x + (16 * j + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int np = 0; np < HDP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + np * 16);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 + g and r0 + g + 8 of acc into rows [row0, ...) of an output
// slice, times `mul`
template <int HDP>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                long long ss, int row0,
                                                int nrows, int hd,
                                                const float acc[HDP / 8][4],
                                                int r0, float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + r0 + g + half * 8;
    if (row >= nrows) continue;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + t * 2 + e;
        if (col < hd)
          dst[row * ss + col] = __float2bfloat16(acc[n][half * 2 + e] * mul);
      }
  }
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_stats_bf16(const Params p) {
  constexpr int LD = mma_ld<HDP>();
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ks = qs + BQ * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const bool vec = p.vec != 0;
  load_tile_bf16<HDP>(qs, slice<__nv_bfloat16>(p, p.q, Q, bb, hh),
                      p.s[Q][1], q0, p.sq, p.hd, vec);
  const __nv_bfloat16* kg = slice<__nv_bfloat16>(p, p.k, K, bb, hh);
  int kt_begin, kt_end;
  kv_tile_range(p, q0, &kt_begin, &kt_end);
  const int r0 = warp * 16;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_bf16<HDP>(ks, kg, p.s[K][1], k0, p.skv, p.hd, vec);
    __syncthreads();
    float s[8][4];
    mma_abt<HDP>(s, qs, ks, r0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = q0 + r0 + g + half * 8;
      float mx = NEG_INF, gc;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][half * 2 + e];
          x = masked_score(p, x * p.scale, qp, k0 + n * 8 + t * 2 + e, &gc);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) rs += expf(s[n][half * 2 + e] - m_new);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[half] = l[half] * expf(m[half] - m_new) + rs;
      m[half] = m_new;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + g + half * 8;
      if (row < p.sq)
        p.lse[stat_base(p, bb, hh) + row] = m[half] + logf(l[half]);
    }
  }
  tile_delta<__nv_bfloat16>(p, q0, bb, hh);
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_dkdv_bf16(const Params p) {
  constexpr int LD = mma_ld<HDP>();
  constexpr int NT_O = HDP / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ks + BK * LD;
  __nv_bfloat16* qs = vs + BK * LD;
  __nv_bfloat16* ds = qs + BQ * LD;    // dO
  float* lse_s = reinterpret_cast<float*>(ds + BQ * LD);
  float* dl_s = lse_s + BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;   // causal: the first kv tiles see most
  const int hh = blockIdx.y, bb = blockIdx.z;
  const bool vec = p.vec != 0;
  load_tile_bf16<HDP>(ks, slice<__nv_bfloat16>(p, p.k, K, bb, hh),
                      p.s[K][1], k0, p.skv, p.hd, vec);
  load_tile_bf16<HDP>(vs, slice<__nv_bfloat16>(p, p.v, V, bb, hh),
                      p.s[V][1], k0, p.skv, p.hd, vec);
  const __nv_bfloat16* qg = slice<__nv_bfloat16>(p, p.q, Q, bb, hh);
  const __nv_bfloat16* dg = slice<__nv_bfloat16>(p, p.dout, DO, bb, hh);
  const long long base = stat_base(p, bb, hh);
  int qt_begin, qt_end;
  q_tile_range(p, k0, &qt_begin, &qt_end);
  const int r0 = warp * 16;   // this warp's kv rows
  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int it = qt_begin; it < qt_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_tile_bf16<HDP>(qs, qg, p.s[Q][1], q0, p.sq, p.hd, vec);
    load_tile_bf16<HDP>(ds, dg, p.s[DO][1], q0, p.sq, p.hd, vec);
    for (int e = threadIdx.x; e < BQ; e += MMA_THREADS) {
      const bool in = q0 + e < p.sq;
      lse_s[e] = in ? p.lse[base + q0 + e] : 0.f;
      dl_s[e] = in ? p.delta[base + q0 + e] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<HDP>(s, ks, qs, r0);    // S^T = K Q^T
    mma_abt<HDP>(dp, vs, ds, r0);   // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + t * 2 + (e & 1);
        const int kp = k0 + r0 + g + (e >> 1) * 8;
        float gc;
        const float x = masked_score(p, s[n][e] * p.scale, q0 + qi, kp, &gc);
        const float pr = expf(x - lse_s[qi]);
        s[n][e] = pr;                                    // P^T
        dp[n][e] = pr * (dp[n][e] - dl_s[qi]) * gc;      // dS^T
      }
    mma_acc<HDP>(dv, s, ds);    // dV += P^T dO
    mma_acc<HDP>(dk, dp, qs);   // dK += dS^T Q
  }
  store_rows_bf16<HDP>(slice_out<__nv_bfloat16>(p, p.dk, DK, bb, hh),
                       p.s[DK][1], k0, p.skv, p.hd, dk, r0, p.scale);
  store_rows_bf16<HDP>(slice_out<__nv_bfloat16>(p, p.dv, DV, bb, hh),
                       p.s[DV][1], k0, p.skv, p.hd, dv, r0, 1.f);
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_dq_bf16(const Params p) {
  constexpr int LD = mma_ld<HDP>();
  constexpr int NT_O = HDP / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ds = qs + BQ * LD;    // dO
  __nv_bfloat16* ks = ds + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const bool vec = p.vec != 0;
  load_tile_bf16<HDP>(qs, slice<__nv_bfloat16>(p, p.q, Q, bb, hh),
                      p.s[Q][1], q0, p.sq, p.hd, vec);
  load_tile_bf16<HDP>(ds, slice<__nv_bfloat16>(p, p.dout, DO, bb, hh),
                      p.s[DO][1], q0, p.sq, p.hd, vec);
  const __nv_bfloat16* kg = slice<__nv_bfloat16>(p, p.k, K, bb, hh);
  const __nv_bfloat16* vg = slice<__nv_bfloat16>(p, p.v, V, bb, hh);
  const int r0 = warp * 16;   // this warp's q rows
  const long long base = stat_base(p, bb, hh);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + half * 8;
    lse_r[half] = row < p.sq ? p.lse[base + row] : 0.f;
    dl_r[half] = row < p.sq ? p.delta[base + row] : 0.f;
  }
  int kt_begin, kt_end;
  kv_tile_range(p, q0, &kt_begin, &kt_end);
  float dq[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_bf16<HDP>(ks, kg, p.s[K][1], k0, p.skv, p.hd, vec);
    load_tile_bf16<HDP>(vs, vg, p.s[V][1], k0, p.skv, p.hd, vec);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<HDP>(s, qs, ks, r0);    // S = Q K^T
    mma_abt<HDP>(dp, ds, vs, r0);   // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qp = q0 + r0 + g + half * 8;
        const int kp = k0 + n * 8 + t * 2 + (e & 1);
        float gc;
        const float x = masked_score(p, s[n][e] * p.scale, qp, kp, &gc);
        dp[n][e] = expf(x - lse_r[half]) * (dp[n][e] - dl_r[half]) * gc;
      }
    mma_acc<HDP>(dq, dp, ks);   // dQ += dS K
  }
  store_rows_bf16<HDP>(slice_out<__nv_bfloat16>(p, p.dq, DQ, bb, hh),
                       p.s[DQ][1], q0, p.sq, p.hd, dq, r0, p.scale);
}

// ------------------------------------------------------------- launch

template <typename Kern>
cudaError_t launch_one(Kern kernel, dim3 grid, int threads, int smem,
                       cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int f = static_cast<int>(sizeof(float));
  const dim3 qgrid((p.sq + BQ - 1) / BQ, p.h, p.b);
  const dim3 kgrid((p.skv + BK - 1) / BK, p.h, p.b);
  cudaError_t err = launch_one(bwd_stats_f32<HDP>, qgrid, FMA_THREADS,
                               2 * HDP * TS * f, stream, p);
  if (err == cudaSuccess)
    err = launch_one(bwd_dkdv_f32<HDP>, kgrid, FMA_THREADS,
                     (4 * HDP * TS + 2 * 64 * TS + 2 * BQ) * f, stream, p);
  if (err == cudaSuccess)
    err = launch_one(bwd_dq_f32<HDP>, qgrid, FMA_THREADS,
                     (4 * HDP * TS + 64 * TS) * f, stream, p);
  return err;
}

template <int HDP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const int tile = 64 * mma_ld<HDP>() * 2;   // bytes of one bf16 tile
  const dim3 qgrid((p.sq + BQ - 1) / BQ, p.h, p.b);
  const dim3 kgrid((p.skv + BK - 1) / BK, p.h, p.b);
  cudaError_t err = launch_one(bwd_stats_bf16<HDP>, qgrid, MMA_THREADS,
                               2 * tile, stream, p);
  if (err == cudaSuccess)
    err = launch_one(bwd_dkdv_bf16<HDP>, kgrid, MMA_THREADS,
                     4 * tile + 2 * BQ * static_cast<int>(sizeof(float)),
                     stream, p);
  if (err == cudaSuccess)
    err = launch_one(bwd_dq_bf16<HDP>, qgrid, MMA_THREADS, 4 * tile, stream,
                     p);
  return err;
}

template <bool BF16>
cudaError_t launch_for_head_dim(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16)
    return BF16 ? launch_bf16<16>(p, stream) : launch_f32<16>(p, stream);
  if (p.hd <= 32)
    return BF16 ? launch_bf16<32>(p, stream) : launch_f32<32>(p, stream);
  if (p.hd <= 64)
    return BF16 ? launch_bf16<64>(p, stream) : launch_f32<64>(p, stream);
  if (p.hd <= 128)
    return BF16 ? launch_bf16<128>(p, stream) : launch_f32<128>(p, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr, const long long* s) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s[0] % 8 == 0 &&
         s[1] % 8 == 0 && s[2] % 8 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor.  q/k/v/o/dout are
// read, dq/dk/dv written (shapes of q, k, v); lse and delta are (b, h, sq)
// f32 scratch.  strides: 24 element strides, the (batch, seq, head)
// strides of q, k, v, o, dout, dq, dk, dv in that order; the head-dim
// stride of each must be 1.  hd <= 128.  Returns a cudaError_t (0 = all
// three kernels launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* lse, float* delta,
                                   int dtype, int b, int sq, int skv, int h,
                                   int hd, const long long* strides,
                                   float scale, int causal, int window,
                                   float softcap, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hd < 1 || hd > 128 ||
      (window > 0 && sq > skv + window - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.hd = hd;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.s[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  p.vec = hd % 8 == 0 && aligned16(q, p.s[Q]) && aligned16(k, p.s[K]) &&
          aligned16(v, p.s[V]) && aligned16(dout, p.s[DO]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_for_head_dim<false>(p, s);
  else if (dtype == 1)
    err = launch_for_head_dim<true>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
