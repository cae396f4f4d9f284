// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention/kernel.py, with the same contract:
// q (b, sq, h, hd), k/v (b, skv, h, hd) with GQA heads already repeated,
// scale 1/sqrt(hd), optional tanh softcap, a causal mask aligned from
// position 0, a sliding window, f32 statistics and accumulator, a finite
// -1e30 mask value, the denominator clamped at 1e-30, output in q's type.
//
// Shared by both paths (see kernel.py for what bounds them):
//   * one thread block per (q tile of 64 rows, head, batch); the TPU's
//     sequential kv grid dimension becomes a loop over 64-row kv tiles
//     inside the block; tiles wholly above the causal diagonal or wholly
//     before the window are skipped (their rows' contributions are
//     exactly zero in the TPU kernel too, for every row that has one
//     unmasked key; the dispatcher refuses calls with a row that has
//     none); the longest q tiles go first;
//   * head dims up to 256 are padded to 16/32/64/128/256 lanes,
//     zero-filled, and masked on store;
//   * q/k/v/o are read and written through their strides (innermost
//     stride 1), so the caller makes no transpose copy.
//
// bf16 path (the serving path): tensor cores through mma.sync m16n8k16,
// bf16 operands, f32 accumulators.  4 warps, each owning 16 query rows:
// S = Q K^T from fragments of the bf16 Q/K tiles in shared memory, the
// online softmax on the S fragments in registers, then P (rounded to
// bf16, as the tensor cores take it) times V with V's fragments read by
// ldmatrix.trans.  Tiles are loaded with 16-byte vector loads where
// pointers and strides allow.
//
// f32 path: f32 FMAs on the CUDA cores (the tensor cores' TF32 would not
// hold f32 to its tolerance).  256 threads as a 16 x 16 grid, each owning
// 4 query rows x 4 keys of the score tile and 4 rows x hd/16 columns of
// the output; Q (scaled) and K staged transposed so the score loop reads
// float4s; V row-major; P transposed.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale, softcap;
  int causal, window;
  int vec;   // q/k/v allow 16-byte loads: aligned pointers, strides % 8
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

// ------------------------------------------------------------ f32 path

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
      vs[i * HDP + d] = ok ? vg[row * p.v_ss + d] : 0.f;
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
      if (col < p.hd) og[row * p.o_ss + col] = acc[r][c] / lr;
    }
  }
}

// ----------------------------------------------------------- bf16 path

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
    load_tile_bf16<HDP>(vs, vg, p.v_ss, k0, p.skv, p.hd, vec);
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
        if (col < p.hd)
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, seq, head) strides of q, k, v and o in that order; the head-dim
// stride of each must be 1.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int b,
                                   int sq, int skv, int h, int hd,
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
  p.vec = hd % 8 == 0 && aligned16(q, p.q_sb, p.q_ss, p.q_sh) &&
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
