// Flash attention backward for Hopper (sm_90a): dq, dk, dv of the
// forward in flash_attention.cu, with no atomics, so two calls give the
// same bits.
//
// The TPU side has no backward kernel: the reference trains through the
// jnp twin of `flash_attention_pallas` (src/repro/models/attention.py,
// `flash_attention`), differentiated by JAX.  This computes that gradient
// for the port's K1, with the forward's contract: q (b, sq, h, hd), k
// (b, skv, h, hd) and v (b, skv, h, dv) with dv <= hd and GQA heads
// already repeated, scale 1/sqrt(hd), an optional tanh softcap, a causal
// mask aligned from position 0, a sliding window, the finite -1e30 mask
// value, f32 statistics, gradients in q's type.  With S the masked
// scores, P = softmax(S) and o, dO (b, sq, h, dv) the forward's output
// and its gradient:
//   D = rowsum(dO * o), dS = P (dO V^T - D) (times 1 - tanh^2(s / c)
//   under a softcap), dV = P^T dO, dQ = dS K scale, dK = dS^T Q scale.
// D, dP = dO V^T and dV run over v's dv columns, S, dQ and dK over hd.
//
// Two variants, three kernels each, launched in order on the caller's
// stream; kernel_bwd.py::plan picks one before the forward runs, and
// neither falls back to the other.
//
// General variant (the first design; f32, any hd <= 256 and dv <= hd,
// any strides with head-dim stride 1):
//   (a) stats: one block per (q tile, head, batch); recomputes each row's
//       log-sum-exp over the kv tiles the forward visits, and D, in f32,
//       into (b, h, ls) scratch; where the caller hands it the forward's
//       LSE (bf16 at hd 256, whose Hopper forward has a training mode),
//       it computes D alone and (b), (c) read the forward's LSE;
//   (b) dK/dV: one block per (kv tile, head, batch); walks the q tiles
//       that see its kv tile (the forward's causal and window tile
//       skipping, turned around), recomputes S and P = exp(S - LSE), and
//       accumulates dV and dK in registers;
//   (c) dQ: one block per (q tile, head, batch); walks the kv tiles and
//       accumulates dQ in registers.
// Each output element is written by one thread, once.  bf16 products
// through mma.sync m16n8k16 with f32 accumulators from warps each owning
// 16 rows of a 64-row tile, tiles loaded between barriers with no
// overlap; f32 through FMAs on the CUDA cores (TF32 would not hold f32 to
// its tolerance).  Head dims padded to 16/32/64/128/192/256 lanes in
// shared memory (HDP, zero-filled, masked on store), so hd 120 works; v's
// to DVP, which is HDP but at MLA's (192, 128), where it is 128 (v's
// columns past dv zero-filled otherwise).  q/k/v/o/dO are read through
// their strides, so expanded GQA views need no copy.  The scale: f32
// scales q in shared memory before its products, as the twin does; bf16
// scales the f32 product afterwards (q scaled in bf16 would round; for a
// power-of-two scale, as at hd 64, the two agree exactly).
//
// Above hd 128 (gemma3's 256, MLA's 192) the accumulators of the first
// design no longer fit: a bf16 warp's 16 kv rows of dK and dV at hd 256
// are 256 f32 registers a lane before S^T and dP^T, and f32's four
// transposed 64-row tiles of 256 lanes are 278 KB of shared memory.  So:
//   - bf16 runs twice the warps (col_split 2): the two warps of a 16-row
//     slice each recompute its S and dP (S^T and dP^T in (b)) and own one
//     half of the columns of its dK and dV (of dQ in (c)), which halves
//     the accumulators (dK, dV at hd 256: 128 registers a lane, as at hd
//     128) and puts 8 warps on the SM that one block's 135 KB of tiles
//     fills.  S and dP cost twice their products, a simple form chosen
//     over one that shares P^T and dS^T through shared memory;
//   - f32 takes 32-row tiles (f32_rows), 157 KB at hd 256 in (b).
//
// Hopper variant (bf16, hd 64 or 128, strides TMA reads: every training
// call of the dense decoders at those head dims): FlashAttention-3's
// schedule on TMA, an mbarrier ring and wgmma, with LSE from the
// forward's training mode; described above its code, below.
//
// What bounds it: 5 products of 2 hd FLOPs per unmasked (query, key)
// pair are the function's least (S, dP, dV, dK, dQ): at the training
// shape (4, 2048, 36, 64) bf16 causal 193 GFLOP, 0.196 ms at 989 TFLOP/s,
// above its 302 MB of q/k/v/o/dO/dq/dk/dv (0.090 ms).  The general
// variant computes 8 (S in all three kernels, dP in two), 12 with
// col_split 2, 11 with the forward's LSE at hd 256 (no S in stats); the
// Hopper one 7 (S and dP in both of its product kernels), a floor of
// 0.274 ms.  Measured times stand in PERF.md.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; each entry point returns a cudaError_t (the Hopper one
// also the codes of a failed tensor-map encode).

#include <cuda.h>   // CUtensorMap and its enums; no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BQ = 64;           // query rows per bf16 tile
constexpr int BK = 64;           // key/value rows per bf16 tile
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
  float* lse;     // (b, h, ls) f32: scratch, or the forward's (lse_in)
  float* delta;   // (b, h, ls) f32 scratch
  long long ls;   // row stride of lse and delta, at least sq
  int lse_in;     // lse holds the forward's: stats computes D alone
  int b, sq, skv, h, hd;
  int hdv;        // columns of v, o, dO and dv (<= hd)
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

// The kv tiles (of R rows) that hold an unmasked key for some row of the
// q tile (of R rows) at q0 (the forward's kv_tile_range).
template <int R>
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0,
                                              int* begin, int* end) {
  const int q_last = min(q0 + R, p.sq) - 1;
  int kt_end = (p.skv + R - 1) / R;
  if (p.causal) kt_end = min(kt_end, q_last / R + 1);
  int kt_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;
    if (lo > 0) kt_begin = lo / R;
  }
  *begin = kt_begin;
  *end = kt_end;
}

// The q tiles that hold a row with an unmasked key in the kv tile at k0:
// causal rows start at k0; a window ends them at the tile's last key +
// window - 1.
template <int R>
__device__ __forceinline__ void q_tile_range(const Params& p, int k0,
                                             int* begin, int* end) {
  int qt_end = (p.sq + R - 1) / R;
  if (p.window > 0) {
    const int k_last = min(k0 + R, p.skv) - 1;
    qt_end = min(qt_end, (k_last + p.window - 1) / R + 1);
  }
  *begin = p.causal ? k0 / R : 0;
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

// Offset of (batch, head) in the (b, h, ls) statistics.
__device__ __forceinline__ long long stat_base(const Params& p, int bb,
                                               int hh) {
  return (static_cast<long long>(bb) * p.h + hh) * p.ls;
}

// D = rowsum(dO * o) over v's columns of the R-row q tile at q0, one warp
// a row.
template <typename T, int R>
__device__ void tile_delta(const Params& p, int q0, int bb, int hh) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* og = slice<T>(p, p.o, O, bb, hh);
  const T* dg = slice<T>(p, p.dout, DO, bb, hh);
  float* out = p.delta + stat_base(p, bb, hh);
  for (int i = threadIdx.x >> 5; i < R; i += warps) {
    const int row = q0 + i;
    if (row >= p.sq) break;
    float acc = 0.f;
    for (int d = lane; d < p.hdv; d += 32)
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
// 256 threads as a 16 x 16 grid; with tiles of R rows (64, or 32 above hd
// 128, f32_rows), thread (ty, tx) owns an RB x RB block (RB = R / 16) of
// each R x R score tile (rows ty*RB.., columns tx*RB..) and RB rows x
// W/16 columns (tx + 16c) of its gradient tile of W columns.  Tiles are
// staged transposed (d-major, row stride R + 4) so the score loop reads
// RB floats at once.

constexpr int FMA_THREADS = 256;

template <int HDP>
__host__ __device__ constexpr int f32_rows() { return HDP <= 128 ? 64 : 32; }

template <int R>
__host__ __device__ constexpr int tstride() { return R + 4; }

// RB consecutive floats (16-byte or 8-byte aligned) into v
template <int RB>
__device__ __forceinline__ void load_rb(const float* ptr, float v[RB]) {
  if constexpr (RB == 4) {
    const float4 x = *reinterpret_cast<const float4*>(ptr);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(ptr);
    v[0] = x.x, v[1] = x.y;
  }
}

template <int RB>
__device__ __forceinline__ void store_rb(float* ptr, const float v[RB]) {
  if constexpr (RB == 4)
    *reinterpret_cast<float4*>(ptr) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(ptr) = make_float2(v[0], v[1]);
}

// rows [row0, row0 + R) of a (seq, W) slice, times `mul`, into a
// transposed tile dst[d * TS + i]; rows past `nrows`, lanes past `w` zero
template <int W, int R>
__device__ __forceinline__ void load_t_f32(float* dst, const float* src,
                                           long long ss, int row0, int nrows,
                                           int w, float mul) {
  constexpr int TS = tstride<R>();
  for (int e = threadIdx.x; e < R * W; e += FMA_THREADS) {
    const int i = e / W, d = e % W;
    const int row = row0 + i;
    dst[d * TS + i] = (row < nrows && d < w) ? src[row * ss + d] * mul : 0.f;
  }
}

// c[r][j] = sum_d a[d][ty*RB + r] * b[d][tx*RB + j] over transposed tiles
// of W lanes
template <int W, int R>
__device__ __forceinline__ void tile_dot_f32(const float* a, const float* b,
                                             int ty, int tx,
                                             float c[R / 16][R / 16]) {
  constexpr int RB = R / 16, TS = tstride<R>();
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < RB; ++j) c[r][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < W; ++d) {
    float xv[RB], yv[RB];
    load_rb<RB>(a + d * TS + ty * RB, xv);
    load_rb<RB>(b + d * TS + tx * RB, yv);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < RB; ++j) c[r][j] = fmaf(xv[r], yv[j], c[r][j]);
  }
}

// c[r][j] of the RB x RB block, transposed into
// m[(tx*RB + j) * TS + ty*RB + r]
template <int R>
__device__ __forceinline__ void store_t_f32(float* m,
                                            const float c[R / 16][R / 16],
                                            int ty, int tx) {
  constexpr int RB = R / 16, TS = tstride<R>();
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    float col[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) col[r] = c[r][j];
    store_rb<RB>(m + (tx * RB + j) * TS + ty * RB, col);
  }
}

// acc[r][c] += sum_i m[i][ty*RB + r] * x[tx + 16c][i]: m is (R x TS) with
// the contracted index first, x a transposed (W x TS) tile
template <int W, int R>
__device__ __forceinline__ void tile_acc_f32(const float* m, const float* x,
                                             int ty, int tx,
                                             float acc[R / 16][W / 16]) {
  constexpr int RB = R / 16, TS = tstride<R>();
#pragma unroll 4
  for (int i = 0; i < R; ++i) {
    float mv[RB];
    load_rb<RB>(m + i * TS + ty * RB, mv);
#pragma unroll
    for (int c = 0; c < W / 16; ++c) {
      const float xv = x[(tx + 16 * c) * TS + i];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r][c] = fmaf(mv[r], xv, acc[r][c]);
    }
  }
}

// rows [row0, row0 + R) of an output slice from acc[r][c] (row ty*RB + r,
// column tx + 16c; columns past `w` not stored), times `mul`
template <int W, int R>
__device__ __forceinline__ void store_rows_f32(float* dst, long long ss,
                                               int row0, int nrows, int w,
                                               const float acc[R / 16][W / 16],
                                               int ty, int tx, float mul) {
  constexpr int RB = R / 16;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = row0 + ty * RB + r;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < W / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < w) dst[row * ss + col] = acc[r][c] * mul;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(FMA_THREADS)
    bwd_stats_f32(const Params p) {
  constexpr int R = f32_rows<HDP>(), RB = R / 16, TS = tstride<R>();
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + HDP * TS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int hh = blockIdx.y, bb = blockIdx.z;
  load_t_f32<HDP, R>(qt, slice<float>(p, p.q, Q, bb, hh), p.s[Q][1], q0,
                     p.sq, p.hd, p.scale);
  const float* kg = slice<float>(p, p.k, K, bb, hh);
  int kt_begin, kt_end;
  kv_tile_range<R>(p, q0, &kt_begin, &kt_end);
  float m[RB], l[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  for (int t = kt_begin; t < kt_end; ++t) {
    const int k0 = t * R;
    __syncthreads();
    load_t_f32<HDP, R>(kt, kg, p.s[K][1], k0, p.skv, p.hd, 1.f);
    __syncthreads();
    float s[RB][RB];
    tile_dot_f32<HDP, R>(qt, kt, ty, tx, s);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int qp = q0 + ty * RB + r;
      float mx = NEG_INF, g;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        s[r][j] = masked_score(p, s[r][j], qp, k0 + tx * RB + j, &g);
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RB; ++j) rs += expf(s[r][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * expf(m[r] - m_new) + rs;
      m[r] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = q0 + ty * RB + r;
      if (row < p.sq) p.lse[stat_base(p, bb, hh) + row] = m[r] + logf(l[r]);
    }
  }
  tile_delta<float, R>(p, q0, bb, hh);
}

template <int HDP, int DVP>
__global__ void __launch_bounds__(FMA_THREADS)
    bwd_dkdv_f32(const Params p) {
  constexpr int R = f32_rows<HDP>(), RB = R / 16, TS = tstride<R>();
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + HDP * TS;
  float* qt = vt + DVP * TS;     // q scaled
  float* dt = qt + HDP * TS;     // dO
  float* pt = dt + DVP * TS;     // P^T, then dS^T: [q i][kv j]
  float* st = pt + R * TS;
  float* lse_s = st + R * TS;
  float* dl_s = lse_s + R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * R;   // causal: the first kv tiles see most
  const int hh = blockIdx.y, bb = blockIdx.z;
  load_t_f32<HDP, R>(kt, slice<float>(p, p.k, K, bb, hh), p.s[K][1], k0,
                     p.skv, p.hd, 1.f);
  load_t_f32<DVP, R>(vt, slice<float>(p, p.v, V, bb, hh), p.s[V][1], k0,
                     p.skv, p.hdv, 1.f);
  const float* qg = slice<float>(p, p.q, Q, bb, hh);
  const float* dg = slice<float>(p, p.dout, DO, bb, hh);
  const long long base = stat_base(p, bb, hh);
  int qt_begin, qt_end;
  q_tile_range<R>(p, k0, &qt_begin, &qt_end);
  float dk[RB][HDP / 16], dv[RB][DVP / 16];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) dk[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DVP / 16; ++c) dv[r][c] = 0.f;
  }
  for (int it = qt_begin; it < qt_end; ++it) {
    const int q0 = it * R;
    __syncthreads();
    load_t_f32<HDP, R>(qt, qg, p.s[Q][1], q0, p.sq, p.hd, p.scale);
    load_t_f32<DVP, R>(dt, dg, p.s[DO][1], q0, p.sq, p.hdv, 1.f);
    for (int e = threadIdx.x; e < R; e += FMA_THREADS) {
      const bool in = q0 + e < p.sq;
      lse_s[e] = in ? p.lse[base + q0 + e] : 0.f;
      dl_s[e] = in ? p.delta[base + q0 + e] : 0.f;
    }
    __syncthreads();
    // S^T (kv rows ty*RB + r, q columns tx*RB + j), then dP^T
    float s[RB][RB], dp[RB][RB];
    tile_dot_f32<HDP, R>(kt, qt, ty, tx, s);
    tile_dot_f32<DVP, R>(vt, dt, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int qi = tx * RB + j;
        float g;
        const float x =
            masked_score(p, s[r][j], q0 + qi, k0 + ty * RB + r, &g);
        const float pr = expf(x - lse_s[qi]);
        s[r][j] = pr;
        dp[r][j] = pr * (dp[r][j] - dl_s[qi]) * g;
      }
    store_t_f32<R>(pt, s, ty, tx);
    store_t_f32<R>(st, dp, ty, tx);
    __syncthreads();
    tile_acc_f32<DVP, R>(pt, dt, ty, tx, dv);   // dV += P^T dO
    tile_acc_f32<HDP, R>(st, qt, ty, tx, dk);   // dK += dS^T (q scale)
  }
  store_rows_f32<HDP, R>(slice_out<float>(p, p.dk, DK, bb, hh), p.s[DK][1],
                         k0, p.skv, p.hd, dk, ty, tx, 1.f);
  store_rows_f32<DVP, R>(slice_out<float>(p, p.dv, DV, bb, hh), p.s[DV][1],
                         k0, p.skv, p.hdv, dv, ty, tx, 1.f);
}

template <int HDP, int DVP>
__global__ void __launch_bounds__(FMA_THREADS)
    bwd_dq_f32(const Params p) {
  constexpr int R = f32_rows<HDP>(), RB = R / 16, TS = tstride<R>();
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // q scaled
  float* dt = qt + HDP * TS;                     // dO
  float* kt = dt + DVP * TS;
  float* vt = kt + HDP * TS;
  float* st = vt + DVP * TS;                     // dS^T: [kv j][q i]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // longest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  load_t_f32<HDP, R>(qt, slice<float>(p, p.q, Q, bb, hh), p.s[Q][1], q0,
                     p.sq, p.hd, p.scale);
  load_t_f32<DVP, R>(dt, slice<float>(p, p.dout, DO, bb, hh), p.s[DO][1],
                     q0, p.sq, p.hdv, 1.f);
  const float* kg = slice<float>(p, p.k, K, bb, hh);
  const float* vg = slice<float>(p, p.v, V, bb, hh);
  const long long base = stat_base(p, bb, hh);
  float lse_r[RB], dl_r[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = q0 + ty * RB + r;
    lse_r[r] = row < p.sq ? p.lse[base + row] : 0.f;
    dl_r[r] = row < p.sq ? p.delta[base + row] : 0.f;
  }
  int kt_begin, kt_end;
  kv_tile_range<R>(p, q0, &kt_begin, &kt_end);
  float dq[RB][HDP / 16];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) dq[r][c] = 0.f;
  for (int t = kt_begin; t < kt_end; ++t) {
    const int k0 = t * R;
    __syncthreads();
    load_t_f32<HDP, R>(kt, kg, p.s[K][1], k0, p.skv, p.hd, 1.f);
    load_t_f32<DVP, R>(vt, vg, p.s[V][1], k0, p.skv, p.hdv, 1.f);
    __syncthreads();
    // S (q rows ty*RB + r, kv columns tx*RB + j), then dP
    float s[RB][RB], dp[RB][RB];
    tile_dot_f32<HDP, R>(qt, kt, ty, tx, s);
    tile_dot_f32<DVP, R>(dt, vt, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        float g;
        const float x = masked_score(p, s[r][j], q0 + ty * RB + r,
                                     k0 + tx * RB + j, &g);
        dp[r][j] = expf(x - lse_r[r]) * (dp[r][j] - dl_r[r]) * g;
      }
    store_t_f32<R>(st, dp, ty, tx);
    __syncthreads();
    tile_acc_f32<HDP, R>(st, kt, ty, tx, dq);   // dQ += dS K
  }
  store_rows_f32<HDP, R>(slice_out<float>(p, p.dq, DQ, bb, hh), p.s[DQ][1],
                         q0, p.sq, p.hd, dq, ty, tx, p.scale);
}

// ----------------------------------------------------------- bf16 path
//
// 4 warps each owning 16 rows of the block's 64-row tile (q rows in (a)
// and (c), kv rows in (b)); above hd 128, 8 warps in (b) and (c), the two
// warps of a 16-row slice each owning half of its gradient's columns
// (col_split).  mma.sync m16n8k16 fragments as in the forward's general
// variant: a thread holds rows g and g + 8 (g = lane / 4) at columns t*2,
// t*2 + 1 (t = lane % 4) of each 8-column n-tile.  A product whose B
// operand has the contracted index along rows (P^T dO, dS^T Q, dS K)
// reads B with ldmatrix.trans; the others read it as stored.

constexpr int MMA_THREADS = 128;

// warps a 16-row slice of dK/dV (of dQ) is split across by columns
template <int HDP>
__host__ __device__ constexpr int col_split() { return HDP <= 128 ? 1 : 2; }

template <int W>
__host__ __device__ constexpr int mma_ld() { return W + 8; }  // smem row

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

// rows [row0, row0 + 64) of a (seq, w) slice with row stride `ss` into a
// padded smem tile of W lanes; rows past `nrows` and lanes past `w` are
// zero.
template <int W>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int row0,
    int nrows, int w, bool vec) {
  constexpr int LD = mma_ld<W>();
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {   // 8 lanes per 16-byte chunk; w % 8 == 0 here
    constexpr int CPR = W / 8;   // chunks per row
    for (int c = threadIdx.x; c < 64 * CPR; c += blockDim.x) {
      const int i = c / CPR, d = (c % CPR) * 8;
      const int row = row0 + i;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows && d < w)
        x = *reinterpret_cast<const uint4*>(src + row * ss + d);
      *reinterpret_cast<uint4*>(dst + i * LD + d) = x;
    }
  } else {
    for (int e = threadIdx.x; e < 64 * W; e += blockDim.x) {
      const int i = e / W, d = e % W;
      const int row = row0 + i;
      dst[i * LD + d] = (row < nrows && d < w) ? src[row * ss + d] : zero;
    }
  }
}

// c (this warp's 16 rows x 64 columns) = A B^T, where A's rows are rows
// `r0`.. of tile a and B's are the 64 rows of tile b, both (rows, W)
template <int W>
__device__ __forceinline__ void mma_abt(float c[8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int r0) {
  constexpr int LD = mma_ld<W>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
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

// acc (this warp's 16 rows x NC columns) += M X, where M (16 x 64) is
// held in score-fragment form (c[n] of mma_abt) and X is NC columns, from
// x on, of a (64, W) tile whose rows are the contracted index
template <int W, int NC>
__device__ __forceinline__ void mma_acc(float acc[NC / 8][4],
                                        const float m[8][4],
                                        const __nv_bfloat16* x) {
  constexpr int LD = mma_ld<W>();
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
    for (int np = 0; np < NC / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + np * 16);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 + g and r0 + g + 8 of acc (NC columns) into rows [row0, ...) of
// an output slice, times `mul`; columns past `w` are not stored
template <int NC>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                long long ss, int row0,
                                                int nrows, int w,
                                                const float acc[NC / 8][4],
                                                int r0, float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + r0 + g + half * 8;
    if (row >= nrows) continue;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + t * 2 + e;
        if (col < w)
          dst[row * ss + col] = __float2bfloat16(acc[n][half * 2 + e] * mul);
      }
  }
}

// Each row's LSE of the q tile at q0, recomputed: a third S = Q K^T over
// the kv tiles the forward visits.
template <int HDP>
__device__ void stats_lse_bf16(const Params& p, int q0, int bb, int hh) {
  constexpr int LD = mma_ld<HDP>();
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ks = qs + BQ * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = p.vec != 0;
  load_tile_bf16<HDP>(qs, slice<__nv_bfloat16>(p, p.q, Q, bb, hh),
                      p.s[Q][1], q0, p.sq, p.hd, vec);
  const __nv_bfloat16* kg = slice<__nv_bfloat16>(p, p.k, K, bb, hh);
  int kt_begin, kt_end;
  kv_tile_range<BQ>(p, q0, &kt_begin, &kt_end);
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
}

// Each row's LSE and D.  LSE_IN: the caller handed the forward's LSE (its
// training mode, at hd 256), so the S loop and the LSE store are skipped
// and D alone is written.
template <int HDP, bool LSE_IN>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_stats_bf16(const Params p) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  if constexpr (!LSE_IN) stats_lse_bf16<HDP>(p, q0, bb, hh);
  tile_delta<__nv_bfloat16, BQ>(p, q0, bb, hh);
}

template <int HDP, int DVP>
__global__ void __launch_bounds__(MMA_THREADS * col_split<HDP>())
    bwd_dkdv_bf16(const Params p) {
  constexpr int LDK = mma_ld<HDP>(), LDV = mma_ld<DVP>();
  constexpr int CS = col_split<HDP>();
  constexpr int NK = HDP / CS, NV = DVP / CS;   // a warp's columns
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ks + BK * LDK;
  __nv_bfloat16* qs = vs + BK * LDV;
  __nv_bfloat16* ds = qs + BQ * LDK;    // dO
  float* lse_s = reinterpret_cast<float*>(ds + BQ * LDV);
  float* dl_s = lse_s + BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;   // causal: the first kv tiles see most
  const int hh = blockIdx.y, bb = blockIdx.z;
  const bool vec = p.vec != 0;
  load_tile_bf16<HDP>(ks, slice<__nv_bfloat16>(p, p.k, K, bb, hh),
                      p.s[K][1], k0, p.skv, p.hd, vec);
  load_tile_bf16<DVP>(vs, slice<__nv_bfloat16>(p, p.v, V, bb, hh),
                      p.s[V][1], k0, p.skv, p.hdv, vec);
  const __nv_bfloat16* qg = slice<__nv_bfloat16>(p, p.q, Q, bb, hh);
  const __nv_bfloat16* dg = slice<__nv_bfloat16>(p, p.dout, DO, bb, hh);
  const long long base = stat_base(p, bb, hh);
  int qt_begin, qt_end;
  q_tile_range<BQ>(p, k0, &qt_begin, &qt_end);
  const int r0 = (warp & 3) * 16;   // this warp's kv rows
  const int part = warp >> 2;       // and its share of the columns
  float dk[NK / 8][4], dv[NV / 8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) dk[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) dv[n][e] = 0.f;
  }
  for (int it = qt_begin; it < qt_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_tile_bf16<HDP>(qs, qg, p.s[Q][1], q0, p.sq, p.hd, vec);
    load_tile_bf16<DVP>(ds, dg, p.s[DO][1], q0, p.sq, p.hdv, vec);
    for (int e = threadIdx.x; e < BQ; e += blockDim.x) {
      const bool in = q0 + e < p.sq;
      lse_s[e] = in ? p.lse[base + q0 + e] : 0.f;
      dl_s[e] = in ? p.delta[base + q0 + e] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<HDP>(s, ks, qs, r0);    // S^T = K Q^T
    mma_abt<DVP>(dp, vs, ds, r0);   // dP^T = V dO^T
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
    mma_acc<DVP, NV>(dv, s, ds + part * NV);    // dV += P^T dO
    mma_acc<HDP, NK>(dk, dp, qs + part * NK);   // dK += dS^T Q
  }
  store_rows_bf16<NK>(
      slice_out<__nv_bfloat16>(p, p.dk, DK, bb, hh) + part * NK,
      p.s[DK][1], k0, p.skv, p.hd - part * NK, dk, r0, p.scale);
  store_rows_bf16<NV>(
      slice_out<__nv_bfloat16>(p, p.dv, DV, bb, hh) + part * NV,
      p.s[DV][1], k0, p.skv, p.hdv - part * NV, dv, r0, 1.f);
}

template <int HDP, int DVP>
__global__ void __launch_bounds__(MMA_THREADS * col_split<HDP>())
    bwd_dq_bf16(const Params p) {
  constexpr int LDK = mma_ld<HDP>(), LDV = mma_ld<DVP>();
  constexpr int CS = col_split<HDP>();
  constexpr int NQ = HDP / CS;    // a warp's columns
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ds = qs + BQ * LDK;    // dO
  __nv_bfloat16* ks = ds + BQ * LDV;
  __nv_bfloat16* vs = ks + BK * LDK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const bool vec = p.vec != 0;
  load_tile_bf16<HDP>(qs, slice<__nv_bfloat16>(p, p.q, Q, bb, hh),
                      p.s[Q][1], q0, p.sq, p.hd, vec);
  load_tile_bf16<DVP>(ds, slice<__nv_bfloat16>(p, p.dout, DO, bb, hh),
                      p.s[DO][1], q0, p.sq, p.hdv, vec);
  const __nv_bfloat16* kg = slice<__nv_bfloat16>(p, p.k, K, bb, hh);
  const __nv_bfloat16* vg = slice<__nv_bfloat16>(p, p.v, V, bb, hh);
  const int r0 = (warp & 3) * 16;   // this warp's q rows
  const int part = warp >> 2;       // and its share of the columns
  const long long base = stat_base(p, bb, hh);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + half * 8;
    lse_r[half] = row < p.sq ? p.lse[base + row] : 0.f;
    dl_r[half] = row < p.sq ? p.delta[base + row] : 0.f;
  }
  int kt_begin, kt_end;
  kv_tile_range<BQ>(p, q0, &kt_begin, &kt_end);
  float dq[NQ / 8][4];
#pragma unroll
  for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_bf16<HDP>(ks, kg, p.s[K][1], k0, p.skv, p.hd, vec);
    load_tile_bf16<DVP>(vs, vg, p.s[V][1], k0, p.skv, p.hdv, vec);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<HDP>(s, qs, ks, r0);    // S = Q K^T
    mma_abt<DVP>(dp, ds, vs, r0);   // dP = dO V^T
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
    mma_acc<HDP, NQ>(dq, dp, ks + part * NQ);   // dQ += dS K
  }
  store_rows_bf16<NQ>(
      slice_out<__nv_bfloat16>(p, p.dq, DQ, bb, hh) + part * NQ,
      p.s[DQ][1], q0, p.sq, p.hd - part * NQ, dq, r0, p.scale);
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

// `which`: a mask of the kernels to launch (1 stats, 2 dK/dV, 4 dQ), all
// three on the training path; one alone is for timing and for the tests.
template <int HDP, int DVP>
cudaError_t launch_f32(const Params& p, int which, cudaStream_t stream) {
  constexpr int R = f32_rows<HDP>(), TS = tstride<R>();
  const int f = static_cast<int>(sizeof(float));
  const dim3 qgrid((p.sq + R - 1) / R, p.h, p.b);
  const dim3 kgrid((p.skv + R - 1) / R, p.h, p.b);
  cudaError_t err = cudaSuccess;
  if (which & 1)
    err = launch_one(bwd_stats_f32<HDP>, qgrid, FMA_THREADS,
                     2 * HDP * TS * f, stream, p);
  if (err == cudaSuccess && (which & 2))
    err = launch_one(bwd_dkdv_f32<HDP, DVP>, kgrid, FMA_THREADS,
                     (2 * (HDP + DVP) * TS + 2 * R * TS + 2 * R) * f, stream,
                     p);
  if (err == cudaSuccess && (which & 4))
    err = launch_one(bwd_dq_f32<HDP, DVP>, qgrid, FMA_THREADS,
                     (2 * (HDP + DVP) * TS + R * TS) * f, stream, p);
  return err;
}

template <int HDP, int DVP>
cudaError_t launch_bf16(const Params& p, int which, cudaStream_t stream) {
  // bytes of one 64-row bf16 tile of q/k and of v/dO
  const int tk = 64 * mma_ld<HDP>() * 2, tv = 64 * mma_ld<DVP>() * 2;
  const int threads = MMA_THREADS * col_split<HDP>();
  const dim3 qgrid((p.sq + BQ - 1) / BQ, p.h, p.b);
  const dim3 kgrid((p.skv + BK - 1) / BK, p.h, p.b);
  cudaError_t err = cudaSuccess;
  if (which & 1)
    err = p.lse_in ? launch_one(bwd_stats_bf16<HDP, true>, qgrid,
                                MMA_THREADS, 0, stream, p)
                   : launch_one(bwd_stats_bf16<HDP, false>, qgrid,
                                MMA_THREADS, 2 * tk, stream, p);
  if (err == cudaSuccess && (which & 2))
    err = launch_one(bwd_dkdv_bf16<HDP, DVP>, kgrid, threads,
                     2 * (tk + tv) + 2 * BQ * static_cast<int>(sizeof(float)),
                     stream, p);
  if (err == cudaSuccess && (which & 4))
    err = launch_one(bwd_dq_bf16<HDP, DVP>, qgrid, threads, 2 * (tk + tv),
                     stream, p);
  return err;
}

template <bool BF16, int HDP, int DVP>
cudaError_t launch_dims(const Params& p, int which, cudaStream_t stream) {
  return BF16 ? launch_bf16<HDP, DVP>(p, which, stream)
              : launch_f32<HDP, DVP>(p, which, stream);
}

// HDP: hd padded to 16/32/64/128/192/256 lanes; DVP: HDP, or 128 at HDP
// 192 where v has at most 128 columns (MLA).
template <bool BF16>
cudaError_t launch_for_head_dim(const Params& p, int which,
                                cudaStream_t stream) {
  if (p.hd <= 16) return launch_dims<BF16, 16, 16>(p, which, stream);
  if (p.hd <= 32) return launch_dims<BF16, 32, 32>(p, which, stream);
  if (p.hd <= 64) return launch_dims<BF16, 64, 64>(p, which, stream);
  if (p.hd <= 128) return launch_dims<BF16, 128, 128>(p, which, stream);
  if (p.hd <= 192)
    return p.hdv <= 128 ? launch_dims<BF16, 192, 128>(p, which, stream)
                        : launch_dims<BF16, 192, 192>(p, which, stream);
  if (p.hd <= 256) return launch_dims<BF16, 256, 256>(p, which, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr, const long long* s) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s[0] % 8 == 0 &&
         s[1] % 8 == 0 && s[2] % 8 == 0;
}

// ------------------------------------------------ bf16, Hopper variant
//
// FlashAttention-3's schedule for the backward, kept deterministic (no
// atomics): three kernels, launched in order by
// flash_attention_bwd_hopper.  (b) and (c) are persistent: one block per
// SM walks its share of the units in a fixed order (unit i of block j is
// j + i x grid), so two calls give the same bits.
//   (a) preprocess: D = rowsum(dO * o) in f32 into (b, h, ls), 0 on rows
//       past sq; LSE comes from the forward's training mode, not from a
//       third S = Q K^T.
//   (b) dK/dV: a unit is a kv tile of 128 rows (UNIT_ROWS) of one (batch,
//       head); its q tiles (DkdvCfg::RING rows) are the ones the causal
//       and window masks let see it (the general variant's tile
//       skipping, turned into the unit's q range).
//   (c) dQ: a unit is a q tile of 128 rows; its kv tiles (DqCfg::RING
//       rows) those the forward visits.
// Block: 3 warpgroups.  Warpgroup 0 is the producer: after giving up
// registers (setmaxnreg) one thread issues every TMA load.  Warpgroups 1
// and 2 are consumers, each owning 64 of the unit's 128 rows, with 240
// registers a thread.  Shared memory: the unit's two tiles (K and V in
// (b), Q and dO in (c)), loaded once a unit into one of UBUFS buffers
// (two where shared memory allows, so the next unit's land while this
// one's last tiles run); a ring of STAGES stages of
// the streamed pair (Q and dO with their LSE and D values in (b), K and
// V in (c)), each stage with a "full" barrier (the TMA bytes landed)
// and an "empty" one every consumer thread arrives on once the products
// that read it completed; each unit buffer has the same pair.  A unit's
// tiles are released before its epilogue.
// Products, all wgmma with f32 accumulators, 7 of 2 hd FLOPs per unmasked
// pair:
//   (b) S^T = K Q^T and dP^T = V dO^T (m64nRINGk16, both operands from
//       shared memory, K-major); P^T = exp2(S^T scale log2 e - LSE log2
//       e) and dS^T = P^T (dP^T - D), times 1 - tanh^2 under a softcap,
//       in registers; dV += P^T dO and dK += dS^T Q with P^T and dS^T
//       from registers (rounded to bf16) and dO, Q read MN-major;
//   (c) S = Q K^T, dP = dO V^T, then dQ += dS K (K read MN-major).
// Masks: only on the tiles that cross the causal diagonal, the window's
// edge or the end of q (in (b): rows past sq hold TMA's zeros and an
// unwritten LSE, so their P is masked to 0) or of kv (in (c)); a masked
// pair's P and dS are 0, as exp(-1e30 - LSE) is in the forward.  Rows of
// the unit past sq or skv are computed and never stored.
// Tiles are TMA boxes of 64 columns (128 bytes) x rows, swizzled 128B,
// as the forward's (hd 128 is two boxes side by side); the wgmma
// descriptors are the forward's (K-major: SBO 1024, 32 bytes a k step;
// MN-major: SBO 1024, LBO the distance between the two boxes, 2048 bytes
// a k step of 16 rows).  Streamed tiles are 128 rows (m64n128 products,
// half the ring handshakes of 64-row ones) where the accumulators fit in
// a consumer's 240 registers; dK/dV at hd 128 streams 64-row tiles (S^T,
// dP^T, dK and dV of 128 columns would take 256).
// Phase bits: the i-th ring tile of the block uses stage i % STAGES in
// round i / STAGES; its consumers wait with parity (i / STAGES) & 1, the
// producer on the empty barrier with the opposite parity; the j-th unit
// with work uses unit buffer j % UBUFS in round j / UBUFS, the same way.
// A stale parity would read an earlier round's tile without an error:
// chip_smoke.py's stale-stage fault shows the checks see one.

namespace hopper {

constexpr int THREADS = 384;
constexpr int UNIT_ROWS = 128;           // rows of a unit: 2 consumers x 64
constexpr int BOX = 64;                  // columns of a TMA box
constexpr int BOX_ROW_BYTES = BOX * 2;   // 128: the swizzle width
constexpr int PRODUCER_REGS = 24;        // 128 x 24 + 256 x 240 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int PRE_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
// bytes of the streamed operands of the (batch, head) pairs whose units
// run together, so that they stay in L2 (the forward's choice)
constexpr long long GROUP_BYTES = 8ll << 20;

// Rows of a streamed tile (RING), ring stages, and buffers of a unit's
// own tiles (UBUFS: with 2, the next unit's land while this one's last
// tiles run), by kernel and head dim, as shared memory allows.
template <int HD>
struct DkdvCfg {
  static constexpr int RING = HD == 64 ? 128 : 64;
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int UBUFS = 2;
};

template <int HD>
struct DqCfg {
  static constexpr int RING = 128;
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int UBUFS = HD == 64 ? 2 : 1;   // 192 KB at hd 128
};

template <int HD, typename Cfg>
struct Smem {
  static constexpr int NB = HD / BOX;                   // boxes per row
  static constexpr int UNIT_TILE = UNIT_ROWS * HD * 2;  // K or V / Q or dO
  static constexpr int RING_TILE = Cfg::RING * HD * 2;
  static constexpr int RING_OFF = Cfg::UBUFS * 2 * UNIT_TILE;
  // LSE and D: RING each a ring stage in (b), 128 each a unit buffer in (c)
  static constexpr int VEC_OFF = RING_OFF + Cfg::STAGES * 2 * RING_TILE;
  static constexpr int VEC_RING = Cfg::STAGES * 2 * Cfg::RING * 4;
  static constexpr int VEC_UNIT = Cfg::UBUFS * 2 * UNIT_ROWS * 4;
  static constexpr int VEC_BYTES = VEC_RING > VEC_UNIT ? VEC_RING : VEC_UNIT;
  // barriers: unit full and unit empty x UBUFS, then full and empty x
  // STAGES
  static constexpr int BAR_OFF = VEC_OFF + VEC_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * Cfg::UBUFS + 2 * Cfg::STAGES)
                               + 1024;                  // alignment slack
};

struct Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;     // (b, h, ls): the forward's, natural log units
  const float* delta;   // (b, h, ls): D, 0 past sq
  long long ls;         // row stride of lse and delta, a multiple of 128
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int b, sq, skv, h, causal, window;
  int group;            // (batch, head) pairs whose units go together
  float scale;          // 1 / sqrt(hd)
  float scale_log2;     // scale x log2(e)
  float cap_in;         // softcap: tanh(s x scale / cap) x cap x log2(e)
  float cap_out;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The forward's wait: a spin inside the asm (a C++ loop around try_wait
// made ptxas serialise the wgmma), which traps after 2^34 clocks (about
// 10 s), so a pipeline fault fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 17179869184;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a rank-4 {hd, h, s, b} tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c_hd, int c_h, int c_s, int c_b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c_hd), "r"(c_h), "r"(c_s),
      "r"(c_b), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both from shared memory
// through descriptors, K-major; scale_d = 0 zeroes D first.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), both from shared
// memory through descriptors, K-major; scale_d = 0 zeroes D first.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_m64n64(d, da, db, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_m64n128(d, da, db, scale_d);
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128), B
// from shared memory MN-major (transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B
// from shared memory MN-major (transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_m64n64(d, a, db);
}

// acc (64 x N) = A B^T over hd: A's 64 rows start at `a_rows` inside a
// unit tile (boxes of UNIT_ROWS rows), B is a ring tile (boxes of N
// rows); HD / 16 k steps of 32 bytes along a 128-byte box row, every 4th
// on the next 64-column box.
template <int HD, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2],
                                           uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(
        a_rows + (kk / 4) * UNIT_ROWS * BOX_ROW_BYTES + off, 16, 1024);
    const uint64_t db = sw128_desc(
        b_tile + (kk / 4) * N * BOX_ROW_BYTES + off, 16, 1024);
    wgmma_ss<N>(acc, da, db, kk > 0);
  }
}

// acc (64 x HD) += A X, A (64 x K) in registers as K / 16 k steps of 16,
// X a ring tile (K rows x HD) read MN-major: a k step of 16 rows is 2048
// bytes, the second 64-column box K x 128 bytes further.
template <int HD, int K>
__device__ __forceinline__ void rs_product(float (&acc)[HD / 2],
                                           const uint32_t (&a)[K / 16][4],
                                           uint32_t x_tile) {
#pragma unroll
  for (int jj = 0; jj < K / 16; ++jj)
    wgmma_rs<HD>(acc, a[jj],
                 sw128_desc(x_tile + jj * 16 * BOX_ROW_BYTES,
                            K * BOX_ROW_BYTES, 1024));
}

// A 64 x N accumulator as the A operand of N / 16 k steps of 16 columns,
// rounded to bf16 (accumulator n-tiles 2 jj and 2 jj + 1).
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4],
                                           const float (&s)[N / 2]) {
#pragma unroll
  for (int jj = 0; jj < N / 16; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[jj][r] = pack_bf16(s[8 * jj + 2 * r], s[8 * jj + 2 * r + 1]);
}

// P and dS of one 64 x 64 tile held as two wgmma accumulators, in place:
// s (raw scores) becomes P = exp2(s scale log2 e - LSE log2 e), with the
// softcap first; dp becomes dS = P (dp - D), times 1 - tanh^2 under a
// softcap.  Element 4j + 2h + e of this thread is at accumulator row
// `row0` + 8h, column `col0` + 8j + 2t + e.  TRANS (the dK/dV kernel):
// rows are kv positions and columns q positions, and the per-q LSE and D
// come from shared memory by column; else rows are q and columns kv,
// with the row's LSE x log2 e and D in l2[h] and d[h].  MASK: the tile
// crosses the causal diagonal, the window's edge or the end of q (TRANS)
// or kv; a masked pair's P and dS are 0.
template <bool TRANS, bool MASK, bool SOFTCAP, int N>
__device__ __forceinline__ void probs_and_grads(
    float (&s)[N / 2], float (&dp)[N / 2], const Params& p, int row0,
    int col0, int t, const float* lse_col, const float* d_col,
    const float (&l2)[2], const float (&d)[2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      const float cl2 = TRANS ? lse_col[col] * LOG2E : 0.f;
      const float cd = TRANS ? d_col[col] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        const float lse2 = TRANS ? cl2 : l2[h];
        const float dd = TRANS ? cd : d[h];
        float pr, g = 1.f;
        if (SOFTCAP) {
          const float th = tanhf(s[i] * p.cap_in);
          g = 1.f - th * th;
          pr = fast_exp2(th * p.cap_out - lse2);
        } else {
          pr = fast_exp2(fmaf(s[i], p.scale_log2, -lse2));
        }
        if (MASK) {
          const int qp = TRANS ? col0 + col : row0 + 8 * h;
          const int kp = TRANS ? row0 + 8 * h : col0 + col;
          bool ok = TRANS ? qp < p.sq : kp < p.skv;
          if (p.causal) ok = ok && qp >= kp;
          if (p.window > 0) ok = ok && qp - kp < p.window;
          pr = ok ? pr : 0.f;
        }
        s[i] = pr;
        float ds = pr * (dp[i] - dd);
        if (SOFTCAP) ds *= g;
        dp[i] = ds;
      }
    }
}

// Without a softcap, P and dS in two passes: P as soon as S has landed
// (while the tensor cores still compute dP), then dS = P (dp - D).
template <bool TRANS, bool MASK, int N>
__device__ __forceinline__ void probs(float (&s)[N / 2], const Params& p,
                                      int row0, int col0, int t,
                                      const float* lse_col,
                                      const float (&l2)[2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      const float cl2 = TRANS ? lse_col[col] * LOG2E : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        float pr = fast_exp2(fmaf(s[i], p.scale_log2, -(TRANS ? cl2 : l2[h])));
        if (MASK) {
          const int qp = TRANS ? col0 + col : row0 + 8 * h;
          const int kp = TRANS ? row0 + 8 * h : col0 + col;
          bool ok = TRANS ? qp < p.sq : kp < p.skv;
          if (p.causal) ok = ok && qp >= kp;
          if (p.window > 0) ok = ok && qp - kp < p.window;
          pr = ok ? pr : 0.f;
        }
        s[i] = pr;
      }
    }
}

template <bool TRANS, int N>
__device__ __forceinline__ void grads(const float (&s)[N / 2],
                                      float (&dp)[N / 2], int t,
                                      const float* d_col,
                                      const float (&d)[2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cd = TRANS ? d_col[8 * j + 2 * t + e] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        dp[i] = s[i] * (dp[i] - (TRANS ? cd : d[h]));
      }
    }
}

// P and dS of a tile whose S and dP products were committed as two wgmma
// groups, in that order: without a softcap P is formed once S has landed
// and dS once dP has; under a softcap both once dP has (dS needs the
// softcap's derivative beside P).  Masks only where `mask` (a test on the
// unit's and the tile's rows, the same for every thread of the block).
template <bool TRANS, bool SOFTCAP, int N>
__device__ __forceinline__ void tile_grads(bool mask, float (&s)[N / 2],
                                           float (&dp)[N / 2],
                                           const Params& p, int row0,
                                           int col0, int t,
                                           const float* lse_col,
                                           const float* d_col,
                                           const float (&l2)[2],
                                           const float (&d)[2]) {
  if (SOFTCAP) {
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (mask)
      probs_and_grads<TRANS, true, true, N>(s, dp, p, row0, col0, t, lse_col,
                                            d_col, l2, d);
    else
      probs_and_grads<TRANS, false, true, N>(s, dp, p, row0, col0, t,
                                             lse_col, d_col, l2, d);
  } else {
    wgmma_wait<1>();
    fence_regs(s);
    if (mask)
      probs<TRANS, true, N>(s, p, row0, col0, t, lse_col, l2);
    else
      probs<TRANS, false, N>(s, p, row0, col0, t, lse_col, l2);
    wgmma_wait<0>();
    fence_regs(dp);
    grads<TRANS, N>(s, dp, t, d_col, d);
  }
}

// Stores rows row0 and row0 + 8 of a 64 x HD accumulator times `mul` as
// bf16, two columns a store, through the output's strides; rows at or
// past `nrows` are dropped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ss,
                                           int row0, int nrows, int t,
                                           const float (&acc)[HD / 2],
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < nrows) {
      __nv_bfloat16* out = dst + row * ss + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(
            acc[4 * n + 2 * h] * mul, acc[4 * n + 2 * h + 1] * mul);
    }
  }
}

// Units are numbered group by group (a group is `p.group` (batch, head)
// pairs, chosen on the host so that their streamed operands stay in L2),
// inside a group tile by tile; the caller turns the tile number around
// where that puts the longest units first.
__device__ __forceinline__ void unit_of(const Params& p, int w, int n_t,
                                        int* tile, int* bh) {
  const int n_bh = p.b * p.h;
  const int group = w / (p.group * n_t);
  const int first = group * p.group;
  const int size = min(p.group, n_bh - first);
  const int idx = w - group * p.group * n_t;
  *bh = first + idx % size;
  *tile = idx / size;
}

struct DkdvUnit {
  int k0, hh, bb, bh, qt_begin, qt_end;
};

// A dK/dV unit, the first kv tiles (which the causal mask lets the most q
// rows see) first; its 64-row q tiles are those with a row that has an
// unmasked key in the kv tile (the general variant's q_tile_range):
// causal rows start at k0; a window ends them at the tile's last key +
// window - 1.  Empty when causal kv rows lie past every q row (skv > sq).
template <int RING>
__device__ __forceinline__ DkdvUnit dkdv_unit(const Params& p, int w,
                                              int n_kt) {
  DkdvUnit u;
  int kt;
  unit_of(p, w, n_kt, &kt, &u.bh);
  u.k0 = kt * UNIT_ROWS;
  u.hh = u.bh % p.h;
  u.bb = u.bh / p.h;
  u.qt_end = (p.sq + RING - 1) / RING;
  if (p.window > 0) {
    const int k_last = min(u.k0 + UNIT_ROWS, p.skv) - 1;
    u.qt_end = min(u.qt_end, (k_last + p.window - 1) / RING + 1);
  }
  u.qt_begin = p.causal ? u.k0 / RING : 0;
  return u;
}

struct DqUnit {
  int q0, hh, bb, bh, kt_begin, kt_end;
};

// A dQ unit, the last q tiles first; its 64-row kv tiles are those the
// forward visits for the same rows.
template <int RING>
__device__ __forceinline__ DqUnit dq_unit(const Params& p, int w, int n_qt) {
  DqUnit u;
  int i;
  unit_of(p, w, n_qt, &i, &u.bh);
  u.q0 = (n_qt - 1 - i) * UNIT_ROWS;
  u.hh = u.bh % p.h;
  u.bb = u.bh / p.h;
  const int q_last = min(u.q0 + UNIT_ROWS, p.sq) - 1;
  u.kt_end = (p.skv + RING - 1) / RING;
  if (p.causal) u.kt_end = min(u.kt_end, q_last / RING + 1);
  u.kt_begin = 0;
  if (p.window > 0 && u.q0 - p.window + 1 > 0)
    u.kt_begin = (u.q0 - p.window + 1) / RING;
  return u;
}

// (a) D = rowsum(dO * o) for every row of (b, h, ls), 0 past sq: HD / 8
// threads a row, 16 bytes each, summed by shuffles in a fixed order.
// Rows are taken in the order (batch, position, head), o's and dO's
// memory order when they are contiguous, so neighbouring threads read
// neighbouring bytes; D is stored at (batch, head, position).
template <int HD>
__global__ void __launch_bounds__(PRE_THREADS)
    bwd_preprocess_hopper(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                          float* delta, long long o_sb, long long o_ss,
                          long long o_sh, long long d_sb, long long d_ss,
                          long long d_sh, int sq, int h, long long ls,
                          long long rows) {
  constexpr int TPR = HD / 8;   // threads a row
  const long long r =
      (static_cast<long long>(blockIdx.x) * PRE_THREADS + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  const long long bs = r / h;              // batch x ls + position
  const int hh = static_cast<int>(r - bs * h);
  const long long bb = bs / ls;
  const int row = static_cast<int>(bs - bb * ls);
  float acc = 0.f;
  if (r < rows && row < sq) {
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + bb * o_sb + row * o_ss + hh * o_sh + part * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + bb * d_sb + row * d_ss + hh * d_sh + part * 8);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xa[i]);
      const float2 b = __bfloat1622float2(ya[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && r < rows) delta[(bb * h + hh) * ls + row] = acc;
}

// (b) dK and dV, one kv tile of 128 rows a unit.  The producer loads the
// unit's K and V once it has work, then every q tile's Q, dO, LSE and D
// into the ring.  Each consumer, per q tile: S^T and dP^T (two wgmma
// groups), P^T and dS^T in registers, then dV += P^T dO and dK += dS^T
// Q, and the stage goes back to the producer.  The unit's K and V go back
// before the epilogue (dK x scale and dV stored as bf16).
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_hopper_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const Params p) {
  using C = DkdvCfg<HD>;
  constexpr int RING = C::RING;
  constexpr int STAGES = C::STAGES;
  constexpr int UBUFS = C::UBUFS;
  using L = Smem<HD, C>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128B swizzle
  const uint32_t bars = base + L::BAR_OFF;
  auto k_s = [&](int ub) { return base + ub * 2 * L::UNIT_TILE; };
  auto v_s = [&](int ub) { return k_s(ub) + L::UNIT_TILE; };
  auto q_s = [&](int s) { return base + L::RING_OFF + s * 2 * L::RING_TILE; };
  auto do_s = [&](int s) { return q_s(s) + L::RING_TILE; };
  auto vec_s = [&](int s) { return base + L::VEC_OFF + s * 2 * RING * 4; };
  auto unit_full = [&](int ub) { return bars + 8 * ub; };
  auto unit_empty = [&](int ub) { return bars + 8 * (UBUFS + ub); };
  auto full = [&](int s) { return bars + 8 * (2 * UBUFS + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * UBUFS + STAGES + s); };
  const float* vec = reinterpret_cast<const float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::VEC_OFF);
  const int n_kt = (p.skv + UNIT_ROWS - 1) / UNIT_ROWS;
  const int n_units = n_kt * p.b * p.h;

  if (threadIdx.x == 0) {
    for (int ub = 0; ub < UBUFS; ++ub) {
      mbar_init(unit_full(ub), 1);
      mbar_init(unit_empty(ub), 256);   // every consumer thread arrives
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t it = 0, u = 0;   // ring tiles and units with work so far
      for (int w = blockIdx.x; w < n_units; w += gridDim.x) {
        const DkdvUnit wk = dkdv_unit<RING>(p, w, n_kt);
        if (wk.qt_begin >= wk.qt_end) continue;
        const int ub = u % UBUFS;
        mbar_wait(unit_empty(ub), ((u / UBUFS) & 1) ^ 1);
        mbar_expect_tx(unit_full(ub), 2 * L::UNIT_TILE);
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          tma_load(k_s(ub) + b * UNIT_ROWS * BOX_ROW_BYTES, &map_k, b * BOX,
                   wk.hh, wk.k0, wk.bb, unit_full(ub));
          tma_load(v_s(ub) + b * UNIT_ROWS * BOX_ROW_BYTES, &map_v, b * BOX,
                   wk.hh, wk.k0, wk.bb, unit_full(ub));
        }
        ++u;
        for (int qt = wk.qt_begin; qt < wk.qt_end; ++qt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * L::RING_TILE + 2 * RING * 4);
#pragma unroll
          for (int b = 0; b < L::NB; ++b) {
            tma_load(q_s(s) + b * RING * BOX_ROW_BYTES, &map_q, b * BOX,
                     wk.hh, qt * RING, wk.bb, full(s));
            tma_load(do_s(s) + b * RING * BOX_ROW_BYTES, &map_do, b * BOX,
                     wk.hh, qt * RING, wk.bb, full(s));
          }
          const long long off = wk.bh * p.ls + qt * RING;
          bulk_load(vec_s(s), p.lse + off, RING * 4, full(s));
          bulk_load(vec_s(s) + RING * 4, p.delta + off, RING * 4, full(s));
        }
      }
    }
  } else {
    // ------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;       // consumer 0 or 1
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const float none[2] = {0.f, 0.f};
    uint32_t it = 0, u = 0;
    for (int w = blockIdx.x; w < n_units; w += gridDim.x) {
      const DkdvUnit wk = dkdv_unit<RING>(p, w, n_kt);
      const int n_tiles = max(wk.qt_end - wk.qt_begin, 0);
      const int row0 = wk.k0 + 64 * c + 16 * warp + g;   // this thread's kv
      const int ub = u % UBUFS;
      const uint32_t k_rows = k_s(ub) + 64 * c * BOX_ROW_BYTES;
      const uint32_t v_rows = v_s(ub) + 64 * c * BOX_ROW_BYTES;
      float dk[HD / 2], dv[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
      if (n_tiles > 0) mbar_wait(unit_full(ub), (u / UBUFS) & 1);
      for (int i = 0; i < n_tiles; ++i) {
        const uint32_t n = it + i;
        const int s = n % STAGES;
        const int q0 = (wk.qt_begin + i) * RING;
        float sacc[RING / 2], dpacc[RING / 2];
        mbar_wait(full(s), (n / STAGES) & 1);
        wgmma_fence();
        ss_product<HD, RING>(sacc, k_rows, q_s(s));    // S^T = K Q^T
        wgmma_commit();
        ss_product<HD, RING>(dpacc, v_rows, do_s(s));  // dP^T = V dO^T
        wgmma_commit();
        const bool mask = q0 + RING > p.sq ||
                          (p.causal && q0 < wk.k0 + UNIT_ROWS - 1) ||
                          (p.window > 0 && q0 + RING - 1 - wk.k0 >= p.window);
        const float* lse_col = vec + s * 2 * RING;
        tile_grads<true, SOFTCAP, RING>(mask, sacc, dpacc, p, row0, q0, t,
                                        lse_col, lse_col + RING, none, none);
        uint32_t pa[RING / 16][4], da[RING / 16][4];
        pack_frags<RING>(pa, sacc);
        pack_frags<RING>(da, dpacc);
        wgmma_fence();
        rs_product<HD, RING>(dv, pa, do_s(s));   // dV += P^T dO
        rs_product<HD, RING>(dk, da, q_s(s));    // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(empty(s));
      }
      if (n_tiles > 0) {
        mbar_arrive(unit_empty(ub));
        ++u;
      }
      it += n_tiles;
      store_rows<HD>(p.dk + wk.bb * p.dk_sb + wk.hh * p.dk_sh, p.dk_ss, row0,
                     p.skv, t, dk, p.scale);
      store_rows<HD>(p.dv + wk.bb * p.dv_sb + wk.hh * p.dv_sh, p.dv_ss, row0,
                     p.skv, t, dv, 1.f);
    }
  }
}

// (c) dQ, one q tile of 128 rows a unit.  The producer loads the unit's
// Q, dO, LSE and D, then every kv tile's K and V into the ring.  Each
// consumer, per kv tile: S and dP (two wgmma groups), dS in registers,
// dQ += dS K, and the stage goes back.  Epilogue: dQ x scale as bf16.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const Params p) {
  using C = DqCfg<HD>;
  constexpr int RING = C::RING;
  constexpr int STAGES = C::STAGES;
  constexpr int UBUFS = C::UBUFS;
  using L = Smem<HD, C>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto q_s = [&](int ub) { return base + ub * 2 * L::UNIT_TILE; };
  auto do_s = [&](int ub) { return q_s(ub) + L::UNIT_TILE; };
  auto k_s = [&](int s) { return base + L::RING_OFF + s * 2 * L::RING_TILE; };
  auto v_s = [&](int s) { return k_s(s) + L::RING_TILE; };
  auto vec_s = [&](int ub) { return base + L::VEC_OFF + ub * 2 * UNIT_ROWS * 4; };
  auto unit_full = [&](int ub) { return bars + 8 * ub; };
  auto unit_empty = [&](int ub) { return bars + 8 * (UBUFS + ub); };
  auto full = [&](int s) { return bars + 8 * (2 * UBUFS + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * UBUFS + STAGES + s); };
  const float* vec = reinterpret_cast<const float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::VEC_OFF);
  const int n_qt = (p.sq + UNIT_ROWS - 1) / UNIT_ROWS;
  const int n_units = n_qt * p.b * p.h;

  if (threadIdx.x == 0) {
    for (int ub = 0; ub < UBUFS; ++ub) {
      mbar_init(unit_full(ub), 1);
      mbar_init(unit_empty(ub), 256);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t it = 0, u = 0;
      for (int w = blockIdx.x; w < n_units; w += gridDim.x, ++u) {
        const DqUnit wk = dq_unit<RING>(p, w, n_qt);
        const int ub = u % UBUFS;
        mbar_wait(unit_empty(ub), ((u / UBUFS) & 1) ^ 1);
        mbar_expect_tx(unit_full(ub), 2 * L::UNIT_TILE + 2 * UNIT_ROWS * 4);
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          tma_load(q_s(ub) + b * UNIT_ROWS * BOX_ROW_BYTES, &map_q, b * BOX,
                   wk.hh, wk.q0, wk.bb, unit_full(ub));
          tma_load(do_s(ub) + b * UNIT_ROWS * BOX_ROW_BYTES, &map_do, b * BOX,
                   wk.hh, wk.q0, wk.bb, unit_full(ub));
        }
        const long long off = wk.bh * p.ls + wk.q0;
        bulk_load(vec_s(ub), p.lse + off, UNIT_ROWS * 4, unit_full(ub));
        bulk_load(vec_s(ub) + UNIT_ROWS * 4, p.delta + off, UNIT_ROWS * 4,
                  unit_full(ub));
        for (int kt = wk.kt_begin; kt < wk.kt_end; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * L::RING_TILE);
#pragma unroll
          for (int b = 0; b < L::NB; ++b) {
            tma_load(k_s(s) + b * RING * BOX_ROW_BYTES, &map_k, b * BOX,
                     wk.hh, kt * RING, wk.bb, full(s));
            tma_load(v_s(s) + b * RING * BOX_ROW_BYTES, &map_v, b * BOX,
                     wk.hh, kt * RING, wk.bb, full(s));
          }
        }
      }
    }
  } else {
    // ------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r = 64 * c + 16 * warp + g;   // this thread's row in the unit
    uint32_t it = 0, u = 0;
    for (int w = blockIdx.x; w < n_units; w += gridDim.x, ++u) {
      const DqUnit wk = dq_unit<RING>(p, w, n_qt);
      const int n_tiles = wk.kt_end - wk.kt_begin;   // >= 1
      const int ub = u % UBUFS;
      const uint32_t q_rows = q_s(ub) + 64 * c * BOX_ROW_BYTES;
      const uint32_t do_rows = do_s(ub) + 64 * c * BOX_ROW_BYTES;
      const float* uvec = vec + ub * 2 * UNIT_ROWS;
      mbar_wait(unit_full(ub), (u / UBUFS) & 1);
      float l2[2], d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l2[h] = uvec[r + 8 * h] * LOG2E;
        d[h] = uvec[UNIT_ROWS + r + 8 * h];
      }
      float dq[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
      for (int i = 0; i < n_tiles; ++i) {
        const uint32_t n = it + i;
        const int s = n % STAGES;
        const int k0 = (wk.kt_begin + i) * RING;
        float sacc[RING / 2], dpacc[RING / 2];
        mbar_wait(full(s), (n / STAGES) & 1);
        wgmma_fence();
        ss_product<HD, RING>(sacc, q_rows, k_s(s));    // S = Q K^T
        wgmma_commit();
        ss_product<HD, RING>(dpacc, do_rows, v_s(s));  // dP = dO V^T
        wgmma_commit();
        const bool mask = k0 + RING > p.skv ||
                          (p.causal && k0 + RING - 1 > wk.q0) ||
                          (p.window > 0 &&
                           wk.q0 + UNIT_ROWS - 1 - k0 >= p.window);
        tile_grads<false, SOFTCAP, RING>(mask, sacc, dpacc, p, wk.q0 + r, k0,
                                         t, nullptr, nullptr, l2, d);
        uint32_t da[RING / 16][4];
        pack_frags<RING>(da, dpacc);
        wgmma_fence();
        rs_product<HD, RING>(dq, da, k_s(s));    // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        mbar_arrive(empty(s));
      }
      mbar_arrive(unit_empty(ub));
      it += n_tiles;
      store_rows<HD>(p.dq + wk.bb * p.dq_sb + wk.hh * p.dq_sh, p.dq_ss,
                     wk.q0 + r, p.sq, t, dq, p.scale);
    }
  }
}

// Tensor map of a (b, s, h, hd) bf16 tensor with element strides st[0..2]
// = (batch, seq, head) (hd stride 1): rank 4, dims {hd, h, s, b}, boxes
// of 64 x 1 x rows x 1, 128B swizzle, zero fill out of bounds (the
// forward's maps).  cuTensorMapEncodeTiled is looked up at run time
// through the CUDA runtime's entry point query: no libcuda is linked.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

CUresult make_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr,
                  int b, int s, int h, int hd, const long long* st,
                  int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {BOX, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <typename Kern>
cudaError_t launch_persistent(Kern kernel, const Maps& m, const Params& p,
                              int n_units, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0;
  int n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  kernel<<<min(n_units, n_sm), THREADS, smem, stream>>>(m.q, m.k, m.v,
                                                         m.dout, p);
  return cudaGetLastError();
}

// The tensor maps of (b) or (c): its streamed operands (`ring` rows a
// box) and its unit's (UNIT_ROWS); `dkdv` streams Q and dO past K and V,
// else K and V past Q and dO.  Returns 1000 + the CUresult of a map that
// failed to encode, else 0.
int make_maps(Maps* m, EncodeTiledFn encode, const void* const* ptrs,
              const long long* strides, int b, int sq, int skv, int h,
              int hd, bool dkdv, int ring) {
  const int q_rows = dkdv ? ring : UNIT_ROWS;
  const int kv_rows = dkdv ? UNIT_ROWS : ring;
  const struct {
    CUtensorMap* map;
    int which;   // q, k, v, o, dout
    int s, rows;
  } maps[4] = {{&m->q, 0, sq, q_rows}, {&m->k, 1, skv, kv_rows},
               {&m->v, 2, skv, kv_rows}, {&m->dout, 4, sq, q_rows}};
  for (const auto& x : maps) {
    const CUresult res = make_map(x.map, encode, ptrs[x.which], b, x.s, h,
                                  hd, strides + 3 * x.which, x.rows);
    if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  }
  return 0;
}

template <int HD, bool SOFTCAP>
int launch(EncodeTiledFn encode, const void* const* ptrs,
           const long long* strides, int hd, const Params& p, int which,
           cudaStream_t stream) {
  const int n_bh = p.b * p.h;
  Maps m;
  if (which & 2) {
    constexpr int RING = DkdvCfg<HD>::RING;
    const int bad = make_maps(&m, encode, ptrs, strides, p.b, p.sq, p.skv,
                              p.h, hd, true, RING);
    if (bad) return bad;
    const cudaError_t err = launch_persistent(
        bwd_dkdv_hopper_kernel<HD, SOFTCAP>, m, p,
        (p.skv + UNIT_ROWS - 1) / UNIT_ROWS * n_bh,
        Smem<HD, DkdvCfg<HD>>::BYTES, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (which & 4) {
    constexpr int RING = DqCfg<HD>::RING;
    const int bad = make_maps(&m, encode, ptrs, strides, p.b, p.sq, p.skv,
                              p.h, hd, false, RING);
    if (bad) return bad;
    const cudaError_t err = launch_persistent(
        bwd_dq_hopper_kernel<HD, SOFTCAP>, m, p,
        (p.sq + UNIT_ROWS - 1) / UNIT_ROWS * n_bh,
        Smem<HD, DqCfg<HD>>::BYTES, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int HD>
cudaError_t launch_preprocess(const void* o, const void* dout, float* delta,
                              const long long* st, int b, int sq, int h,
                              long long ls, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * h * ls;
  const long long blocks = (rows * (HD / 8) + PRE_THREADS - 1) / PRE_THREADS;
  bwd_preprocess_hopper<HD>
      <<<static_cast<unsigned>(blocks), PRE_THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), delta, st[9], st[10],
          st[11], st[12], st[13], st[14], sq, h, ls, rows);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor.  q/k/v/o/dout are
// read, dq/dk/dv written (shapes of q, k, v); q and k have hd columns, v,
// o, dout and dv hdv; lse and delta are (b, h, ls) f32, ls >= sq: both
// scratch the stats kernel writes, or (lse_in, bf16 only) lse the
// forward's training-mode log-sum-exp, which the stats kernel then does
// not recompute (it writes delta alone).  strides:
// 24 element strides, the (batch, seq, head) strides of q, k, v, o, dout,
// dq, dk, dv in that order; the head-dim stride of each must be 1.  hd <=
// 256, 1 <= hdv <= hd.  which: the kernels to launch (1
// stats, 2 dK/dV, 4 dQ; 7 for a whole backward).  Returns a cudaError_t
// (0 = every kernel asked for launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* lse, float* delta,
                                   long long ls, int lse_in,
                                   int dtype, int b, int sq, int skv, int h,
                                   int hd, int hdv,
                                   const long long* strides,
                                   float scale, int causal, int window,
                                   float softcap, int which, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hd < 1 || hd > 256 || hdv < 1 ||
      hdv > hd || (window > 0 && sq > skv + window - 1) || ls < sq ||
      (lse_in && dtype != 1))
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
  p.ls = ls;
  p.lse_in = lse_in;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.hd = hd;
  p.hdv = hdv;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.s[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  p.vec = hd % 8 == 0 && hdv % 8 == 0 && aligned16(q, p.s[Q]) && aligned16(k, p.s[K]) &&
          aligned16(v, p.s[V]) && aligned16(dout, p.s[DO]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_for_head_dim<false>(p, which, s);
  else if (dtype == 1)
    err = launch_for_head_dim<true>(p, which, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The Hopper variant, bf16 only: hd 64 or 128; q/k/v/o/dout 16-byte
// aligned with (batch, seq, head) strides that are multiples of 8
// elements (kernel_bwd.py::plan); dq/dk/dv with even strides.  lse: the
// forward's training-mode log-sum-exp, (b, h, ls) f32; delta: (b, h, ls)
// f32 scratch, written by the preprocess kernel; ls a multiple of 128 and
// at least sq.  strides as for flash_attention_bwd.  which: the kernels
// to launch (1 preprocess, 2 dK/dV, 4 dQ; 7 for a whole backward).
// Returns a cudaError_t (0 = every kernel asked for launched), or 1000 +
// the CUresult of a tensor map that failed to encode, or 2000 if libcuda
// has no cuTensorMapEncodeTiled.
extern "C" int flash_attention_bwd_hopper(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, long long ls, int b, int sq, int skv, int h, int hd,
    const long long* strides, float scale, int causal, int window,
    float softcap, int which, void* stream) {
  if ((hd != 64 && hd != 128) || b < 1 || sq < 1 || skv < 1 ||
      ls % hopper::UNIT_ROWS != 0 || ls < sq ||
      (window > 0 && sq > skv + window - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which & 1) {
    const cudaError_t err =
        hd == 64 ? hopper::launch_preprocess<64>(o, dout, delta, strides, b,
                                                 sq, h, ls, s)
                 : hopper::launch_preprocess<128>(o, dout, delta, strides, b,
                                                  sq, h, ls, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((which & 6) == 0) return 0;
  // cuTensorMapEncodeTiled, a libcuda call, needs a current context; the
  // runtime makes the device's primary context current in this thread
  // here.  Autograd runs a backward on a thread of its own, where this
  // may be the first CUDA call (CUDA_ERROR_INVALID_CONTEXT otherwise).
  const cudaError_t ctx = cudaFree(nullptr);
  if (ctx != cudaSuccess) return static_cast<int>(ctx);
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return 2000;
  const void* const ptrs[5] = {q, k, v, o, dout};
  hopper::Params p;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = lse;
  p.delta = delta;
  p.ls = ls;
  p.dq_sb = strides[15];
  p.dq_ss = strides[16];
  p.dq_sh = strides[17];
  p.dk_sb = strides[18];
  p.dk_ss = strides[19];
  p.dk_sh = strides[20];
  p.dv_sb = strides[21];
  p.dv_ss = strides[22];
  p.dv_sh = strides[23];
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.causal = causal;
  p.window = window;
  // (batch, head) pairs a group: their Q and dO (streamed by (b)), or K
  // and V (streamed by (c)), together about GROUP_BYTES
  const long long streamed = 4ll * std::max(sq, skv) * hd;
  p.group = static_cast<int>(
      std::max(1ll, std::min(static_cast<long long>(b) * h,
                             hopper::GROUP_BYTES / streamed)));
  p.scale = scale;
  p.scale_log2 = scale * hopper::LOG2E;
  p.cap_in = softcap != 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap * hopper::LOG2E;
  const auto run = hd == 64 ? (softcap != 0.f ? hopper::launch<64, true>
                                               : hopper::launch<64, false>)
                            : (softcap != 0.f ? hopper::launch<128, true>
                                              : hopper::launch<128, false>);
  return run(encode, ptrs, strides, hd, p, which, s);
}
