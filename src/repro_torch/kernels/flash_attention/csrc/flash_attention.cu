// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention/kernel.py, with the same contract:
// q (b, sq, h, hd), k/v (b, skv, h, hd) with GQA heads already repeated,
// scale 1/sqrt(hd), optional tanh softcap, a causal mask aligned from
// position 0, a sliding window, f32 statistics and accumulator, a finite
// -1e30 mask value, the denominator clamped at 1e-30, output in q's type.
// v may have dv <= hd columns: the function is the TPU kernel's on v
// zero-padded to hd, and o (b, sq, h, dv) is its first dv columns.
//
// What bounds it: at the serving shape, (4, <=1024, 32 or 64, 128) bf16
// causal, reading q, k, v and writing o once takes about as long at 3.35
// TB/s as the products of the unmasked (query, key) pairs at the 989
// TFLOP/s of the bf16 tensor cores (0.040 against 0.035 ms at 32 heads
// and s = 1024).  Only wgmma reaches that tensor-core rate, and only
// loads that overlap the products keep both near their bounds.  Two
// variants; kernel.py::plan picks one before launch from the dtype, the
// head dim and the strides, and neither falls back to the other.
//
// Hopper variant (bf16, hd 64, 120, 128 or 256, or q/k at 192 with v/o at
// 128 (MLA), TMA-compatible strides: every serving call; hd 120 is stored
// and multiplied at 128 columns, the last 8 of them zeros that TMA
// writes; hd 256 runs 64-row kv tiles and one Q buffer).
// Persistent blocks, one per SM, each
// with a producer warpgroup and two consumer warpgroups of 64 query rows;
// units of 128 query rows are handed out by an atomic counter, longest
// first within groups of heads whose K and V stay in L2 (taking the
// longest tiles of all heads first streamed K and V from device memory
// once per q tile, which bounded the whole kernel).  Q, K and V arrive by TMA into double
// buffers guarded by mbarriers while the consumers multiply; S = Q K^T
// and O += P V are wgmma (m64n128k16, P from registers), tile i's S
// started beside tile i-1's P V and the two consumers taking turns, so
// the softmax overlaps products; the softmax is in the log2 domain (one
// FMA and one ex2 a score) and takes masks only on tiles that cross the
// diagonal, the window's edge or the end of kv; 128-row kv tiles halve
// the re-reads of K and V against 64-row ones.  What still bounds it
// (PERF.md): its products run at about half the tensor cores' peak, and
// the softmax is not wholly hidden behind them.  Details above its code,
// below.  Training mode, a separate instantiation the serving calls never
// run: the epilogue also writes each row's log-sum-exp, which the
// backward (flash_attention_bwd.cu) reads: its Hopper variant at hd 64
// and 128, its general one at hd 256.
//
// General variant (every other call: f32, bf16 with other head dims or
// strides TMA refuses).  Shared by its two paths:
//   * one thread block per (q tile of 64 rows, head, batch); the TPU's
//     sequential kv grid dimension becomes a loop over 64-row kv tiles
//     inside the block; tiles wholly above the causal diagonal or wholly
//     before the window are skipped (their rows' contributions are
//     exactly zero in the TPU kernel too, for every row that has one
//     unmasked key; the dispatcher refuses calls with a row that has
//     none); the longest q tiles go first;
//   * head dims up to 256 are padded to 16/32/64/128/256 lanes,
//     zero-filled, and masked on store; v may be narrower than q and k
//     (dv < hd): its columns dv.. are loaded as zeros, o's never stored;
//   * q/k/v/o are read and written through their strides (innermost
//     stride 1), so the caller makes no transpose copy.
//
// General bf16 path: tensor cores through mma.sync m16n8k16, bf16
// operands, f32 accumulators.  4 warps, each owning 16 query rows: S = Q
// K^T from fragments of the bf16 Q/K tiles in shared memory, the online
// softmax on the S fragments in registers, then P (rounded to bf16, as
// the tensor cores take it) times V with V's fragments read by
// ldmatrix.trans.  Tiles are loaded with 16-byte vector loads where
// pointers and strides allow, between two barriers: no overlap of loads
// and products.
//
// General f32 path: f32 FMAs on the CUDA cores (the tensor cores' TF32
// would not hold f32 to its tolerance).  256 threads as a 16 x 16 grid,
// each owning 4 query rows x 4 keys of the score tile and 4 rows x hd/16
// columns of the output; Q (scaled) and K staged transposed so the score
// loop reads float4s; V row-major; P transposed.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; each entry point returns a cudaError_t (the Hopper one
// also the codes of a failed tensor-map encode).  Measured times stand in
// PERF.md.

#include <cuda.h>   // CUtensorMap and its enums; no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key/value rows per tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, skv, h, hd;
  int dv;    // columns of v and o, <= hd: v's columns dv..hd-1 read as zeros
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale, softcap;
  int causal, window;
  int vec;   // q/k/v allow 16-byte loads: aligned pointers, strides % 8,
             // hd and dv % 8
};

// The kv tiles that hold an unmasked key for some row of this q tile.
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

// Softcap and the masks of the TPU kernel, on one score.
__device__ __forceinline__ float masked_score(const Params& p, float x,
                                              int qp, int kp) {
  if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
  bool ok = kp < p.skv && qp < p.sq;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window > 0) ok = ok && qp - kp < p.window;
  return ok ? x : NEG_INF;
}

// -------------------------------------------- f32, general variant

constexpr int FMA_THREADS = 256;  // 16 x 16
constexpr int TS = BQ + 4;        // stride of transposed tiles (float4-aligned)

template <int HDP>
constexpr int fma_smem_floats() {
  return HDP * TS      // qs: Q^T tile, pre-scaled
         + HDP * TS    // ks: K^T tile
         + BK * HDP    // vs: V tile
         + BK * TS;    // ps: P^T tile
}

template <int HDP>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int NC = HDP / 16;   // output columns per thread: tx + 16 * c
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + HDP * TS;
  float* vs = ks + HDP * TS;
  float* ps = vs + BK * HDP;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;

  const float* qg = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  float* og = static_cast<float*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  for (int e = tid; e < BQ * HDP; e += FMA_THREADS) {
    const int i = e / HDP, d = e % HDP;
    const int row = q0 + i;
    float x = 0.f;
    if (row < p.sq && d < p.hd) x = qg[row * p.q_ss + d] * p.scale;
    qs[d * TS + i] = x;
  }

  int kt_begin, kt_end;
  kv_tile_range(p, q0, &kt_begin, &kt_end);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < BK * HDP; e += FMA_THREADS) {
      const int i = e / HDP, d = e % HDP;
      const int row = k0 + i;
      const bool ok = row < p.skv && d < p.hd;
      ks[d * TS + i] = ok ? kg[row * p.k_ss + d] : 0.f;
      vs[i * HDP + d] = ok && d < p.dv ? vg[row * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores: s[r][c] = q[ty*4+r] . k[tx*4+c]
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * TS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(ks + d * TS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // masks and online softmax; a row's 64 keys live in 16 lanes
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = masked_score(p, s[r][c], qp, k0 + tx * 4 + c);
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        rs += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (tx * 4 + c) * TS + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc[r][c] += sum_j p[ty*4+r][j] * v[j][tx + 16c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(ps + j * TS + ty * 4);
      const float pv[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[j * HDP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= p.sq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.dv) og[row * p.o_ss + col] = acc[r][c] / lr;
    }
  }
}

// ------------------------------------------- bf16, general variant

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int HDP>
__host__ __device__ constexpr int mma_ld() { return HDP + 8; }  // smem row, bf16

template <int HDP>
constexpr int mma_smem_bytes() {
  return 3 * 64 * mma_ld<HDP>() * 2;        // Q, K, V tiles
}

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
// padded smem tile; rows past `nrows` and lanes past `hd` are zero (for
// V, `hd` is dv: its columns dv..HDP-1 are zeros, which P V multiplies).
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

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = mma_ld<HDP>();
  constexpr int NT_S = BK / 8;     // score n-tiles per warp (keys)
  constexpr int NT_O = HDP / 8;    // output n-tiles per warp (head dim)
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;         // fragment row group
  const int t = lane & 3;          // thread in group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const bool vec = p.vec != 0;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  load_tile_bf16<HDP>(qs, qg, p.q_ss, q0, p.sq, p.hd, vec);

  int kt_begin, kt_end;
  kv_tile_range(p, q0, &kt_begin, &kt_end);

  // this thread's two rows: r (c0, c1 of every fragment) and r + 8 (c2, c3)
  const int r = warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile_bf16<HDP>(ks, kg, p.k_ss, k0, p.skv, p.hd, vec);
    load_tile_bf16<HDP>(vs, vg, p.v_ss, k0, p.skv, p.dv, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const __nv_bfloat16* qa = qs + r * LD + kk * 16 + t * 2;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                             ld_u32(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const __nv_bfloat16* kb = ks + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // scale, softcap, masks, online softmax; a row lives in 4 lanes
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = q0 + r + half * 8;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][half * 2 + e];
          x = masked_score(p, x * p.scale, qp, k0 + n * 8 + t * 2 + e);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float corr = expf(m[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][half * 2 + e];
          x = expf(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[half] = l[half] * corr + rs;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        o[n][half * 2] *= corr;
        o[n][half * 2 + 1] *= corr;
      }
      m[half] = m_new;
    }

    // O += P V: the S fragments of key tiles (2j, 2j+1) are the A
    // fragment of key step j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int mi = lane >> 3;    // the 8x8 matrix this lane addresses
      const __nv_bfloat16* vrow =
          vs + (16 * j + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + np * 16);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r + half * 8;
    if (row >= p.sq) continue;
    const float lr = fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + t * 2 + e;
        if (col < p.dv)
          og[row * p.o_ss + col] = __float2bfloat16(o[n][half * 2 + e] / lr);
      }
  }
}

// ------------------------------------------------------------- launch

template <int HDP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = fma_smem_floats<HDP>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  flash_fwd_f32_kernel<HDP><<<grid, FMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = mma_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  flash_fwd_bf16_kernel<HDP><<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16, int HDP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return BF16 ? launch_bf16<HDP>(p, stream) : launch_f32<HDP>(p, stream);
}

template <bool BF16>
cudaError_t launch_for_head_dim(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch<BF16, 16>(p, stream);
  if (p.hd <= 32) return launch<BF16, 32>(p, stream);
  if (p.hd <= 64) return launch<BF16, 64>(p, stream);
  if (p.hd <= 128) return launch<BF16, 128>(p, stream);
  if (p.hd <= 256) return launch<BF16, 256>(p, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

// ------------------------------------------------ bf16, Hopper variant
//
// Block: 3 warpgroups, one block per SM, persistent (see the kernel).
// Warpgroup 0 is the producer: after giving up registers (setmaxnreg) one
// thread starts every TMA load of the block.  Warpgroups 1 and 2 are
// consumers, each owning 64 query rows of a unit's 128 (BQ), with 232
// registers a thread for the S and O accumulators and P; they take turns
// at issuing their products (ping-pong, named barriers 1 and 2), so one's
// softmax runs while the other's products do.  Shared memory (192 KB at
// hd 128): two Q tiles (this unit's and the next's), then rings of
// STAGES K and STAGES V tiles of 128 rows (BK).  Each K and V stage has a
// "full" barrier (the TMA bytes landed) and an "empty" one that every
// consumer thread arrives on once the product that read it has completed
// (K after S, V after P V).  A third stage measured no faster, and does
// not fit beside the second Q tile.  (MLA and hd 256 take one Q tile and
// other kv tiles: below.)
//
// MLA (DeepSeek-V3's prefill: q and k 192 columns, 128 nope + 64 rope; v
// and o 128) is the function of v zero-padded to 192 columns with o's
// first 128 kept, as the reference computes it: o's first 128 columns do
// not depend on v's zero ones, so V is read and multiplied at 128
// columns.  S = Q K^T runs 12 k steps over three boxes a row; P V, O (64
// accumulator registers a thread) and the epilogue are hd 128's.  At 128
// kv rows a tile, two Q buffers and two stages would need 96 + 96 + 64 =
// 256 KB of the 227 a block has; MlaTile keeps 128-row kv tiles and
// drops the second Q buffer (208 KB), so the next unit's Q loads only
// once this unit's last S has landed.  The other candidate, two Q
// buffers and 64-row kv tiles (S m64n64, P half as wide) in three stages
// (216 KB), is timed beside it by experiments/time_flash_mla_tiles_torch.py
// (PERF.md).
//
// hd 256 (gemma3-4b: 8 heads of 256, serving and training) takes
// Hd256Tile: 64-row kv tiles, one Q buffer, two stages, 192 KB.  A Q tile
// alone is 64 KB, so 128-row K and V tiles in two stages (256 KB) do not
// fit beside it; and a consumer thread's O is 128 f32 registers, beside
// which S and P of 64 keys (32 + 16) fit the 232 of CONSUMER_REGS, those
// of 128 keys (64 + 32) do not.  S = Q K^T is m64n64k16 over 16 k steps
// across four 64-column boxes; P V is m64n256k16 with V read MN-major
// over four boxes (LBO = BK x 128 bytes).  With one Q buffer the next
// unit's Q loads once this unit's last S has landed, as MlaTile's does.
// Its training mode writes the LSE that the general backward reads at
// hd 256 (kernel_bwd.py), in place of recomputing it.
//
// Tiles are TMA boxes of 64 columns (128 bytes, the widest swizzle) by
// 128 rows, swizzled 128B; hd 128 is two boxes side by side, each box
// 16 KB and 1024-byte aligned.  hd 120 (h2o-danube-3-4b) takes the layout
// of hd 128 (HDP, hd rounded up to whole boxes): its second box's
// columns 120..127 lie past the tensor map's head-dim extent of 120, so
// TMA fills them with zeros (and counts their bytes towards the
// barrier's transaction count, as for any box).  The zero columns add
// nothing to S = Q K^T, which runs all HDP / 16 k steps; O's columns
// 120..127 are P times zeros and are never stored.  The map keeps hd a
// dimension of its own: with {hd, h} flattened into one, columns
// 120..127 would be the next head's first eight.  The wgmma descriptors
// use the same 128B swizzle mode (bits 62-63 = 1):
//   * Q and K, K-major: SBO 1024 bytes (8 rows of 128 bytes), LBO unused
//     (16); one k step of 16 columns moves the start address by 32
//     bytes inside a box, and the 5th k step starts on the second box
//     (the 9th on the third, at hd 192).
//     The swizzle is a function of the address bits, so a start 32, 64
//     or 96 bytes into a 1024-byte-aligned box reads the right columns.
//   * V, read MN-major (transposed B, the (kv, hd) layout as loaded):
//     SBO 1024 bytes (8 kv rows), LBO the distance between the two
//     64-column boxes (BK x 128 bytes); one k step of 16 kv rows moves
//     the start by 2048 bytes.
// Phase bits: the i-th kv tile of the block uses stage i % STAGES in
// round r = i / STAGES (unit j's Q buffer j % QBUF in round j / QBUF).  A
// consumer waits on full barriers with parity r & 1; the producer waits
// on empty barriers with parity (r & 1) ^ 1, which passes at once in
// round 0 (no consumer has arrived yet).  A stale parity would read the
// previous round's tile without an error, which chip_smoke.py's
// stale-stage check is there to catch.
// Ordering of wgmma: wgmma.fence before each batch of products (the
// accumulators and P were written by ordinary instructions since),
// commit_group, then wait_group 1 before the softmax reads S (the P V
// started after it may still run) and wait_group 0 before O is rescaled
// and the V stage released; ptxas tracks the registers an in-flight
// wgmma reads.  What makes ptxas serialise every wgmma of the kernel
// (its warning C7520) instead: a C++ loop around mbarrier.try_wait (the
// wait is a loop inside its asm), and a branch whose condition depends on
// the thread index (the mask test uses the unit's rows, not the
// consumer's).
// Out-of-bounds rows of a box (the ragged ends of q and kv) are filled
// with zeros by TMA; the kv ones are masked in the softmax, the q ones
// are never stored.
// TMA preconditions (kernel.py::plan routes calls that miss them to the
// general variant): base address 16-byte aligned, every (batch, seq,
// head) stride a multiple of 16 bytes, rank 4 with dims {hd, h, s, b}.

namespace hopper {

constexpr int BQ = 128;
constexpr int THREADS = 384;
constexpr int BOX = 64;                  // columns of a TMA box
constexpr int BOX_ROW_BYTES = BOX * 2;   // 128: the swizzle width
constexpr int PRODUCER_REGS = 40;        // 128 x 40 + 256 x 232 = 384 x 168
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
// K and V bytes of the (batch, head) pairs whose units run together: 8 MB
// (16 pairs at s = 1024, hd 128); 4 and 16 measured no faster, 64 slower
constexpr long long GROUP_KV_BYTES = 8ll << 20;
constexpr int MAX_SMEM = 232448;   // dynamic shared memory of a block

// The tiles of one instantiation and its shared-memory layout: q·k width
// HD and v/o width HDV, each held as whole 64-column boxes (HDP, HDVP);
// BK kv rows a K or V tile; QBUF Q buffers (with 2, the next unit's Q
// lands while this unit's last tiles run); STAGES K and STAGES V tiles.
template <int HD_, int HDV_, int BK_, int QBUF_, int STAGES_>
struct Tile {
  static constexpr int HD = HD_, HDV = HDV_, BK = BK_, QBUF = QBUF_,
                       STAGES = STAGES_;
  static constexpr int NB = (HD + BOX - 1) / BOX;      // q/k boxes a row
  static constexpr int NBV = (HDV + BOX - 1) / BOX;    // v boxes a row
  static constexpr int HDP = NB * BOX;                 // q/k columns held
  static constexpr int HDVP = NBV * BOX;               // v/o columns held
  // whole boxes: TMA counts the zero-filled columns' bytes too
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int K_BYTES = BK * HDP * 2;         // one K tile
  static constexpr int V_BYTES = BK * HDVP * 2;        // one V tile
  static constexpr int K_OFF = QBUF * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  // barriers: Q full and Q empty x QBUF, then full K, full V, empty K and
  // empty V x STAGES; then the numbers of the units whose Q is loaded
  static constexpr int WORK_OFF = BAR_OFF + 8 * (2 * QBUF + 4 * STAGES);
  static constexpr int BYTES = WORK_OFF + 16
                               + 1024;                 // alignment slack
  static_assert(BYTES <= MAX_SMEM, "the tiles exceed a block's shared memory");
  static_assert(BK == 64 || BK == 128, "S = Q K^T is m64n64 or m64n128");
  static_assert(QBUF == 1 || QBUF == 2, "one or two Q buffers");
};

// hd 64, 120 and 128: 128-row kv tiles, two Q buffers, two stages (192 KB
// at hd 128).  A third stage measured no faster, and does not fit beside
// the second Q buffer.
template <int HD>
using SquareTile = Tile<HD, HD, 128, 2, 2>;
// MLA (q·k 192, v and o 128): 128-row kv tiles and two stages as at hd
// 128, and one Q buffer (208 KB; two would need 256).  The candidate with
// two Q buffers and 64-row kv tiles in three stages (216 KB) measured
// slower (PERF.md, experiments/time_flash_mla_tiles_torch.py).
using MlaTile = Tile<192, 128, 128, 1, 2>;
// hd 256 (gemma3): 64-row kv tiles, one Q buffer, two stages (64 + 2 x
// (32 + 32) = 192 KB).  128-row kv tiles would need 320 KB with one Q
// buffer, and a consumer thread's O alone is 128 f32 registers: beside
// it S (32) and P (16) fit the 232 of CONSUMER_REGS, S and P of 128 keys
// (64 and 32) would not.
using Hd256Tile = Tile<256, 256, 64, 1, 2>;

struct Params {
  __nv_bfloat16* o;
  float* lse;         // training mode: (b, h, lse_stride) f32, else unused
  long long lse_stride;
  int* counter;       // next unit of work, 0 at launch
  long long o_sb, o_ss, o_sh;
  int b, sq, skv, h, causal, window;
  int group;          // (batch, head) pairs whose units go together
  float scale_log2;   // scale x log2(e): exp2 of scaled scores
  float cap_in;       // softcap: tanh(s x scale / cap) x cap x log2(e)
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

// Waits until the barrier's phase of parity `parity` has completed.  The
// spin is a loop inside the asm: a loop in C++ around try_wait made ptxas
// spill and serialise every wgmma of the kernel.  A wait that lasts 2^34
// clocks (about 10 s) can only be a fault of the kernel (a lost arrival,
// a wrong byte count or phase): it traps, so the launch fails with an
// error instead of hanging the card.
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

// One box of a rank-4 {hd, h, s, b} tensor map into shared memory; the
// barrier's transaction count drops by the box's bytes when it lands.
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

// wgmma shared-memory descriptor, 128B swizzle; offsets in bytes.
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

// Waits until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// across the asm statements that start and wait for a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Named barriers 1 and 2 order the two consumers' products (ping-pong):
// consumer c starts its wgmma batch after bar.sync on 1 + c and then
// arrives on 2 - c, handing the tensor cores to the other consumer while
// it runs its softmax.
__device__ __forceinline__ void wait_turn(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void pass_turn(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), A and B from shared
// memory through descriptors, both K-major; scale_d = 0 zeroes D first.
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

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), as wgmma_ss_m64n128.
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

// D (64 x 256, f32) += A (64 x 16, bf16 in registers) B (16 x 256), B
// from shared memory MN-major over four 64-column boxes (hd 256's P V).
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T's product at N = BK keys (both operands from shared memory)
// and P V's at N = HDVP columns (P from registers).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_m64n128(d, da, db, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_m64n64(d, da, db, scale_d);
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
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n256(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_m64n64(d, a, db);
}

// Softcap, masks and the online softmax of one 64 x BK score tile held
// as a wgmma accumulator: this thread's rows are row0 and row0 + 8 (s[4j
// + 2h + e] is row row0 + 8h, key k0 + 8j + 2t + e), and each row is
// spread over the 4 lanes of a quad.  The maxima m are kept in the log2
// domain (scores x scale x log2 e), so each probability is one FMA and
// one ex2.  On a tile without masks or softcap, the raw scores' maximum
// is scaled once and the scale folded into the FMA.  With softcap,
// tanh(s x scale / cap) x cap x log2 e comes first; on a masked tile the
// scores are scaled first, then masked to -1e30.  MASK: the tile crosses
// the causal diagonal, the window's edge or the end of kv; tiles wholly
// inside take no comparisons.  On return s holds the probabilities, m
// the running maxima, l this thread's partial row sums, and corr the
// factor by which O must be rescaled (once the P V product in flight has
// landed in it).  A row with no unmasked key in the tile gets
// probabilities of exactly 1 against a maximum of -1e30; its first
// unmasked key's corr of 0 wipes them, as in the TPU kernel (every row
// has such a key).  That needs -1e30 - m to be exactly 0 there, which the
// folded FMA would not give (it keeps the rounding error of -1e30 x
// scale, up to 2^73, and ex2 of it is infinite): hence no fold on masked
// tiles.
template <bool MASK, bool SOFTCAP, int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2],
                                               const Params& p, int row0,
                                               int k0, int t) {
  const float mul = SOFTCAP || MASK ? 1.f : p.scale_log2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row0 + 8 * h;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * h + e];
        if (SOFTCAP)
          x = tanhf(x * p.cap_in) * p.cap_out;
        else if (MASK)
          x *= p.scale_log2;
        if (MASK) {
          const int kp = k0 + 8 * j + 2 * t + e;
          bool ok = kp < p.skv;
          if (p.causal) ok = ok && qp >= kp;
          if (p.window > 0) ok = ok && qp - kp < p.window;
          x = ok ? x : NEG_INF;
        }
        s[4 * j + 2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * mul);
    corr[h] = fast_exp2(m[h] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = fast_exp2(fmaf(x, mul, -m_new));
        rs += x;
      }
    l[h] = l[h] * corr[h] + rs;
    m[h] = m_new;
  }
}

// online_softmax of the tile at k0 in the block whose rows start at q0,
// with masks only if the tile crosses the causal diagonal, the window's
// edge or the end of kv.  The test uses the block's rows, not the
// consumer's: a branch on a value that depends on the thread index made
// ptxas serialise the wgmma in flight across it.  (For tiles of 128 rows
// it differs from the consumer's own test only at a window's edge.)
template <bool SOFTCAP, int BK>
__device__ __forceinline__ void softmax_scores(float (&s)[BK / 2],
                                               float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2],
                                               const Params& p, int row0,
                                               int q0, int k0, int t) {
  const bool mask = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > q0) ||
                    (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
  if (mask)
    online_softmax<true, SOFTCAP, BK>(s, m, l, corr, p, row0, k0, t);
  else
    online_softmax<false, SOFTCAP, BK>(s, m, l, corr, p, row0, k0, t);
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * n + 2 * h] *= corr[h];
      o[4 * n + 2 * h + 1] *= corr[h];
    }
}

// The first tile: no P V in flight, so O is rescaled at once.
template <bool SOFTCAP, int BK, int HDVP>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[HDVP / 2],
                                             const Params& p, int row0,
                                             int q0, int k0, int t) {
  float corr[2];
  softmax_scores<SOFTCAP, BK>(s, m, l, corr, p, row0, q0, k0, t);
  rescale<HDVP>(o, corr);
}

// S = Q K^T for this consumer's 64 rows and one K stage: HDP / 16 k steps;
// each moves 32 bytes along a 128-byte box row, and every 4th starts the
// next 64-column box (the 5th the second, the 9th the third at hd 192,
// the 13th the fourth at hd 256).
template <class T>
__device__ __forceinline__ void qk_product(float (&sacc)[T::BK / 2],
                                           uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < T::HDP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da =
        sw128_desc(q_rows + (kk / 4) * BQ * BOX_ROW_BYTES + off, 16, 1024);
    const uint64_t db = sw128_desc(
        k_tile + (kk / 4) * T::BK * BOX_ROW_BYTES + off, 16, 1024);
    wgmma_ss<T::BK>(sacc, da, db, kk > 0);
  }
}

// O += P V for one V stage: BK / 16 k steps of 16 kv rows (2048 bytes);
// the V tile's 64-column boxes lie BK x 128 bytes apart (LBO), two of
// them at hd 128, four at hd 256 (m64n256k16).
template <class T>
__device__ __forceinline__ void pv_product(float (&o)[T::HDVP / 2],
                                           const uint32_t (&pa)[T::BK / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int jj = 0; jj < T::BK / 16; ++jj)
    wgmma_rs<T::HDVP>(o, pa[jj],
                      sw128_desc(v_tile + jj * 16 * BOX_ROW_BYTES,
                                 T::BK * BOX_ROW_BYTES, 1024));
}

// The probabilities as the A operand of P V's k step jj (keys 16 jj .. 16
// jj + 15): the accumulator's n-tiles 2 jj and 2 jj + 1, rounded to bf16.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int jj = 0; jj < BK / 16; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[jj][r] = pack_bf16(s[8 * jj + 2 * r], s[8 * jj + 2 * r + 1]);
}

// One unit of work: a q tile of 128 rows of one (batch, head), and the
// kv tiles that hold an unmasked key for one of its rows.  Units are
// numbered group by group: a group is `p.group` (batch, head) pairs,
// chosen on the host so that their K and V (read by every q tile of the
// pair) stay in L2 while the group runs; inside a group, the longest q
// tiles come first, so the blocks that take the last units of a group
// take short ones.  Taking the longest tiles of all heads first instead
// streamed K and V from device memory again for every q tile.
struct Work {
  int q0, hh, bb, kt_begin, kt_end;
};

template <int BK>
__device__ __forceinline__ Work work_item(const Params& p, int w) {
  const int n_qt = (p.sq + BQ - 1) / BQ;
  const int n_bh = p.b * p.h;
  const int group = w / (p.group * n_qt);
  const int first = group * p.group;
  const int size = min(p.group, n_bh - first);
  const int idx = w - group * p.group * n_qt;
  const int bh = first + idx % size;
  Work wk;
  wk.q0 = (n_qt - 1 - idx / size) * BQ;
  wk.hh = bh % p.h;
  wk.bb = bh / p.h;
  const int q_last = min(wk.q0 + BQ, p.sq) - 1;
  wk.kt_end = (p.skv + BK - 1) / BK;
  if (p.causal) wk.kt_end = min(wk.kt_end, q_last / BK + 1);
  wk.kt_begin = 0;
  if (p.window > 0 && wk.q0 - p.window + 1 > 0)
    wk.kt_begin = (wk.q0 - p.window + 1) / BK;
  return wk;
}

// Persistent: one block per SM.  The producer takes the next unit from
// a counter in device memory (atomicAdd; a block that finishes early
// takes more), writes its number to shared memory and loads its Q into
// Q buffer j % QBUF (unit j's) as soon as the consumers are done with the
// unit that used it last, then its K and V as the ring frees.  With two
// buffers the next unit's Q lands while the current one's last tiles run;
// with one (MLA's tile) it is loaded once every S of the current unit has
// landed, beside its last P V and its stores.  The next unit's first K and
// V land while the last P V products and the stores run.
// The consumers read the number once Q has landed; a number past the
// last unit ends the block.  Ring stages and phases run on across units
// (`it` counts the kv tiles of the block so far).
//
// LSE (training mode, a separate instantiation): the epilogue also writes
// each row's log-sum-exp of its scaled, capped, masked scores in natural
// units, (m + log2 l) / log2 e with the maxima m in the log2 domain and l
// clamped as o's denominator is, into p.lse[(bb h + hh) lse_stride + row]
// for rows below sq; K1's Hopper backward reads it instead of recomputing
// it.  The serving instantiation (LSE false) compiles to the code it had.
template <class T, bool SOFTCAP, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const Params p) {
  constexpr int BK = T::BK;
  constexpr int STAGES = T::STAGES;
  constexpr int QBUF = T::QBUF;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128B swizzle
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t ring = bars + 8 * 2 * QBUF;   // the K and V barriers
  auto q_s = [&](int qb) { return base + qb * T::Q_BYTES; };
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (QBUF + qb); };
  auto k_s = [&](int s) { return base + T::K_OFF + s * T::K_BYTES; };
  auto v_s = [&](int s) { return base + T::V_OFF + s * T::V_BYTES; };
  auto full_k = [&](int s) { return ring + 8 * s; };
  auto full_v = [&](int s) { return ring + 8 * (STAGES + s); };
  auto empty_k = [&](int s) { return ring + 8 * (2 * STAGES + s); };
  auto empty_v = [&](int s) { return ring + 8 * (3 * STAGES + s); };
  volatile int* const work_slot = reinterpret_cast<volatile int*>(
      smem_raw + (base - smem_u32(smem_raw)) + T::WORK_OFF);
  const int n_work = (p.sq + BQ - 1) / BQ * p.b * p.h;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < QBUF; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 256);   // every consumer thread arrives
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 256);
      mbar_init(empty_v(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (uint32_t j = 0;; ++j) {
        const int w = atomicAdd(p.counter, 1);
        const int qb = j % QBUF;   // Q buffer of unit j
        mbar_wait(q_empty(qb), ((j / QBUF) & 1) ^ 1);
        work_slot[qb] = w;   // ordered before the arrival below (release)
        if (w >= n_work) {
          mbar_arrive(q_full(qb));
          break;
        }
        const Work wk = work_item<BK>(p, w);
        mbar_expect_tx(q_full(qb), T::Q_BYTES);
#pragma unroll
        for (int b = 0; b < T::NB; ++b)
          tma_load(q_s(qb) + b * BQ * BOX_ROW_BYTES, &map_q, b * BOX, wk.hh,
                   wk.q0, wk.bb, q_full(qb));
        // K of tile i, then V of tile i - 1: the order the consumers read
        // them in (S of tile i beside P V of tile i - 1)
        auto load_k = [&](uint32_t n, int kt) {
          const int s = n % STAGES;
          mbar_wait(empty_k(s), ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(full_k(s), T::K_BYTES);
#pragma unroll
          for (int b = 0; b < T::NB; ++b)
            tma_load(k_s(s) + b * BK * BOX_ROW_BYTES, &map_k, b * BOX, wk.hh,
                     kt * BK, wk.bb, full_k(s));
        };
        auto load_v = [&](uint32_t n, int kt) {
          const int s = n % STAGES;
          mbar_wait(empty_v(s), ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(full_v(s), T::V_BYTES);
#pragma unroll
          for (int b = 0; b < T::NBV; ++b)
            tma_load(v_s(s) + b * BK * BOX_ROW_BYTES, &map_v, b * BOX, wk.hh,
                     kt * BK, wk.bb, full_v(s));
        };
        for (int kt = wk.kt_begin; kt < wk.kt_end; ++kt, ++it) {
          load_k(it, kt);
          if (kt > wk.kt_begin) load_v(it - 1, kt - 1);
        }
        load_v(it - 1, wk.kt_end - 1);
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
    // Consumer 0 takes the first turn.  Both run the same units and tiles,
    // so each passes as many turns as the other waits for, but for this
    // first one, which consumer 0 absorbs at the end.
    if (c == 1) pass_turn(c);
    uint32_t it = 0;
    for (uint32_t j = 0;; ++j) {
      const int qb = j % QBUF;
      mbar_wait(q_full(qb), (j / QBUF) & 1);
      const int w = work_slot[qb];
      if (w >= n_work) break;
      // this consumer's Q rows, box 0
      const uint32_t q_rows = q_s(qb) + 64 * c * BOX_ROW_BYTES;
      const Work wk = work_item<BK>(p, w);
      const int row0 = wk.q0 + 64 * c + 16 * warp + g;   // this thread's
      const int n_tiles = wk.kt_end - wk.kt_begin;        // >= 1
      float o[T::HDVP / 2];
#pragma unroll
      for (int i = 0; i < T::HDVP / 2; ++i) o[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};

      // Tile i's S = Q K^T is started before tile i-1's O += P V, so that
      // the softmax of tile i runs while the tensor cores do P V of tile
      // i-1.  K of tile i goes back to the producer as soon as S has
      // landed; V of tile i-1 and the rescale of O wait for P V.  The
      // first S and the last P V are peeled off the loop: a wgmma under a
      // branch makes ptxas serialise every wgmma of the kernel.  Every
      // unit has at least one kv tile (the entry point refuses calls that
      // leave a row without a key).
      uint32_t pa[BK / 16][4];
      {
        const int s = it % STAGES;
        float sacc[BK / 2];   // written by the first k step (scale_d = 0)
        mbar_wait(full_k(s), (it / STAGES) & 1);
        wait_turn(c);
        wgmma_fence();
        qk_product<T>(sacc, q_rows, k_s(s));
        wgmma_commit();
        pass_turn(c);
        wgmma_wait<0>();
        fence_regs(sacc);
        mbar_arrive(empty_k(s));
        softmax_tile<SOFTCAP, BK, T::HDVP>(sacc, m, l, o, p, row0, wk.q0,
                                           wk.kt_begin * BK, t);
        pack_p<BK>(pa, sacc);
      }
      for (int i = 1; i < n_tiles; ++i) {
        const uint32_t cur = it + i;
        const int s = cur % STAGES;
        const int ps = (cur - 1) % STAGES;   // stage of tile i-1
        float sacc[BK / 2];
        mbar_wait(full_k(s), (cur / STAGES) & 1);
        mbar_wait(full_v(ps), ((cur - 1) / STAGES) & 1);
        wait_turn(c);
        wgmma_fence();
        qk_product<T>(sacc, q_rows, k_s(s));
        wgmma_commit();
        pv_product<T>(o, pa, v_s(ps));
        wgmma_commit();
        pass_turn(c);
        wgmma_wait<1>();   // S of tile i has landed; P V may still run
        fence_regs(sacc);
        mbar_arrive(empty_k(s));
        float corr[2];
        softmax_scores<SOFTCAP, BK>(sacc, m, l, corr, p, row0, wk.q0,
                                    (wk.kt_begin + i) * BK, t);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(ps));
        rescale<T::HDVP>(o, corr);
        pack_p<BK>(pa, sacc);
      }
      mbar_arrive(q_empty(qb));   // every S of this unit has landed
      {
        const uint32_t last = it + n_tiles - 1;
        const int s = last % STAGES;
        mbar_wait(full_v(s), (last / STAGES) & 1);
        wait_turn(c);
        wgmma_fence();
        pv_product<T>(o, pa, v_s(s));
        wgmma_commit();
        pass_turn(c);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(s));
      }
      it += n_tiles;

      // Epilogue: o / max(l, 1e-30) rounded to bf16, stored from the
      // accumulator's layout (rows row0 and row0 + 8, two columns a
      // store) through the output's strides; rows past sq are dropped,
      // and so are columns past HDV (hd 120: the next head's columns or
      // past the end of o).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = fmaxf(l[h], 1e-30f);
        if (LSE) {
          const int row = row0 + 8 * h;
          if (t == 0 && row < p.sq)
            p.lse[(static_cast<long long>(wk.bb) * p.h + wk.hh) *
                      p.lse_stride + row] = (m[h] + log2f(l[h])) / LOG2E;
        }
        l[h] = 1.f / l[h];
      }
      __nv_bfloat16* og = p.o + wk.bb * p.o_sb + wk.hh * p.o_sh;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < p.sq) {
          __nv_bfloat16* orow = og + row * p.o_ss + 2 * t;
#pragma unroll
          for (int n = 0; n < T::HDV / 8; ++n)
            *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(
                o[4 * n + 2 * h] * l[h], o[4 * n + 2 * h + 1] * l[h]);
        }
      }
    }
    if (c == 0) wait_turn(c);   // consumer 1's last pass
  }
}

// Tensor map of a (b, s, h, hd) bf16 tensor with element strides sb, ss,
// sh (hd stride 1): rank 4, dims {hd, h, s, b}, boxes of 64 x 1 x rows x
// 1, 128B swizzle, zero fill out of bounds (the NaN fill would poison
// every score of hd 120's padding columns).  The extent of dim 0 is hd,
// not the head stride: a (b, s, h, 128) storage seen as hd 120 keeps its
// columns 120..127 unread.  cuTensorMapEncodeTiled is a libcuda
// function; it is looked up at run time through the CUDA runtime's entry
// point query, so the library links no libcuda.
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
                  int b, int s, int h, int hd, long long sb, long long ss,
                  long long sh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {BOX, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <class T, bool SOFTCAP, bool LSE>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const Params& p, int b,
                   cudaStream_t stream) {
  const int smem = T::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hopper_kernel<T, SOFTCAP, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0;
  int n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int n_work = (p.sq + BQ - 1) / BQ * b * p.h;
  flash_fwd_hopper_kernel<T, SOFTCAP, LSE>
      <<<min(n_work, n_sm), THREADS, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <class T, bool SOFTCAP>
cudaError_t launch_lse(const CUtensorMap& mq, const CUtensorMap& mk,
                       const CUtensorMap& mv, const Params& p, int b,
                       cudaStream_t stream) {
  return p.lse != nullptr ? launch<T, SOFTCAP, true>(mq, mk, mv, p, b, stream)
                          : launch<T, SOFTCAP, false>(mq, mk, mv, p, b,
                                                      stream);
}

// The serving instantiations of a tile: softcap or not, no LSE.
template <class T>
cudaError_t launch_serving(const CUtensorMap& mq, const CUtensorMap& mk,
                           const CUtensorMap& mv, const Params& p, int b,
                           float softcap, cudaStream_t stream) {
  return softcap != 0.f ? launch<T, true, false>(mq, mk, mv, p, b, stream)
                        : launch<T, false, false>(mq, mk, mv, p, b, stream);
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: the columns of q and k; dv
// (1 <= dv <= hd): those of v and o (the function of v zero-padded to hd,
// o's first dv columns).  strides: 12 element strides, the (batch, seq,
// head) strides of q, k, v and o in that order; the head-dim stride of
// each must be 1.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int b,
                                   int sq, int skv, int h, int hd, int dv,
                                   const long long* strides, float scale,
                                   int causal, int window, float softcap,
                                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.hd = hd;
  p.dv = dv;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  if (dv < 1 || dv > hd) return static_cast<int>(cudaErrorInvalidValue);
  p.vec = hd % 8 == 0 && dv % 8 == 0 && aligned16(q, p.q_sb, p.q_ss, p.q_sh) &&
          aligned16(k, p.k_sb, p.k_ss, p.k_sh) &&
          aligned16(v, p.v_sb, p.v_ss, p.v_sh);
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

// The Hopper variant, bf16 only: (hd, dv) (64, 64), (120, 120), (128, 128),
// (192, 128) (MLA: q and k 192 columns, v and o 128) or (256, 256); q/k/v
// 16-byte aligned with (batch, seq, head) strides that are multiples of 8
// elements; o contiguous.  strides as above.  lse: null (serving), or
// (training mode, hd = dv = 64, 128 or 256 only: the head dims a main
// path trains at) f32 (b, h, lse_stride) with lse_stride >= sq, where
// each row's log-sum-exp is written.  counter: one int in device memory,
// 0.  Returns a cudaError_t (0 = launched), or 1000 + the CUresult of a
// tensor map that failed to encode, or 2000 if libcuda has no
// cuTensorMapEncodeTiled.
extern "C" int flash_attention_fwd_hopper(const void* q, const void* k,
                                          const void* v, void* o, int b,
                                          int sq, int skv, int h, int hd,
                                          int dv, const long long* strides,
                                          float scale, int causal,
                                          int window, float softcap,
                                          float* lse, long long lse_stride,
                                          int* counter, void* stream) {
  const bool square =
      hd == dv && (hd == 64 || hd == 120 || hd == 128 || hd == 256);
  const bool training = square && hd != 120;
  if (!(square || (hd == 192 && dv == 128)) || (lse != nullptr && !training))
    return static_cast<int>(cudaErrorInvalidValue);
  // every row needs a key (each block then has a kv tile to wait for)
  if (b < 1 || sq < 1 || skv < 1 || (window > 0 && sq > skv + window - 1) ||
      (lse != nullptr && lse_stride < sq))
    return static_cast<int>(cudaErrorInvalidValue);
  // cuTensorMapEncodeTiled, a libcuda call, needs a current context; the
  // runtime makes the device's primary context current in this thread
  // here.  Autograd runs a backward on a thread of its own, where this
  // may be the first CUDA call (CUDA_ERROR_INVALID_CONTEXT otherwise).
  const cudaError_t ctx = cudaFree(nullptr);
  if (ctx != cudaSuccess) return static_cast<int>(ctx);
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return 2000;
  // kv rows of a K or V box: the tile's
  const int bk = hd == 192   ? hopper::MlaTile::BK
                 : hd == 256 ? hopper::Hd256Tile::BK
                             : hopper::SquareTile<128>::BK;
  CUtensorMap mq, mk, mv;
  CUresult res = hopper::make_map(&mq, encode, q, b, sq, h, hd, strides[0],
                                  strides[1], strides[2], hopper::BQ);
  if (res == CUDA_SUCCESS)
    res = hopper::make_map(&mk, encode, k, b, skv, h, hd, strides[3],
                           strides[4], strides[5], bk);
  if (res == CUDA_SUCCESS)
    res = hopper::make_map(&mv, encode, v, b, skv, h, dv, strides[6],
                           strides[7], strides[8], bk);
  if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  hopper::Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.lse_stride = lse_stride;
  p.counter = counter;
  // (batch, head) pairs a group: their K and V together about
  // GROUP_KV_BYTES, which L2 (50 MB) holds with room to spare
  const long long kv_bytes = 2ll * skv * (hd + dv);
  p.group = static_cast<int>(
      std::max(1ll, std::min(static_cast<long long>(b) * h,
                             hopper::GROUP_KV_BYTES / kv_bytes)));
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * hopper::LOG2E;
  p.cap_in = softcap != 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap * hopper::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using hopper::Hd256Tile;
  using hopper::SquareTile;
  cudaError_t err;
  if (hd == 64)
    err = softcap != 0.f
              ? hopper::launch_lse<SquareTile<64>, true>(mq, mk, mv, p, b, s)
              : hopper::launch_lse<SquareTile<64>, false>(mq, mk, mv, p, b, s);
  else if (hd == 120)   // serving only
    err = hopper::launch_serving<SquareTile<120>>(mq, mk, mv, p, b, softcap,
                                                  s);
  else if (hd == 192)   // serving only
    err = hopper::launch_serving<hopper::MlaTile>(mq, mk, mv, p, b, softcap,
                                                  s);
  else if (hd == 256)
    err = softcap != 0.f
              ? hopper::launch_lse<Hd256Tile, true>(mq, mk, mv, p, b, s)
              : hopper::launch_lse<Hd256Tile, false>(mq, mk, mv, p, b, s);
  else
    err = softcap != 0.f
              ? hopper::launch_lse<SquareTile<128>, true>(mq, mk, mv, p, b, s)
              : hopper::launch_lse<SquareTile<128>, false>(mq, mk, mv, p, b,
                                                          s);
  return static_cast<int>(err);
}
