// WKV6 (RWKV-6 "Finch") recurrence backward for Hopper (sm_90a): dr, dk,
// dw and du.
//
// The gradient of the TPU kernel `wkv6_pallas` (src/repro/kernels/rwkv6/
// kernel.py), which has no backward: the reference trains through the
// jnp twin `wkv6_chunked` (src/repro/kernels/rwkv6/ops.py).  For each
// (batch, head), with S_t the (hd, hd) f32 state after step t and
// G_t = dL/dS_t (G_T = dS_T, the final state's gradient),
//     G_{t-1} = diag(w_t) G_t + r_t^T dy_t
//     dr_t = S_{t-1} dy_t + u . k_t (v_t . dy_t)
//     dk_t = G_t v_t + u . r_t (v_t . dy_t)
//     dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//     du_bh = sum_t r_t . k_t (v_t . dy_t)   (summed over b by the caller)
// r/k/v/dy (b, s, H, hd) in T, w (b, s, H, hd) f32, u (H, hd), S_0 and
// dS_T (b, H, hd, hd) f32; dr/dk out in T, dw and du in f32.  The loop
// runs exactly s steps.  The rest of the gradient, dv_t = G_t^T k_t +
// (sum u . r_t . k_t) dy_t and dS_0 = G_0, is the forward recurrence run
// backward in time (r <- k, k <- r, v <- dy, state <- dS_T), which the
// caller launches with the forward kernel (kernel_bwd.py).
//
// Design.  Every row i of S and G evolves on its own (row i decays by
// w_t[i]), and every gradient here contracts within a row, so blocks
// share nothing.  A block owns 16 rows of one (head, batch): grid (H, b,
// HDP / 16), HDP = hd padded to 16, 32 or 64.  Its 128 threads hold the
// rows, 8 threads a row, each C = HDP / 8 columns in registers (column c
// of thread g is (c / VW) 8 VW + g VW + c % VW, VW = min(C, 4), so that
// the 8 threads of a row read 8 neighbouring vectors of a step's v and
// dy).  Time is cut into sub-chunks of kSub steps.  Two passes:
//   1. forward: S from S_0; at each sub-chunk's start S_{t-1} is stored
//      to a scratch buffer (a checkpoint); each step's partial sums of
//      dr_t over a thread's columns go to shared memory.  After the
//      sub-chunk each warp takes 4 of its steps, forms v_t . dy_t of each,
//      sums each (step, row)'s 8 partials in a fixed order, adds the u
//      term and writes dr, the block's 16 rows of a step from 16 lanes,
//      and adds the row's du terms r_t k_t (v_t . dy_t);
//   2. reverse, sub-chunk by sub-chunk from the last: the sub-chunk's S
//      recomputed from its checkpoint into registers (kSub states of the
//      thread's C entries), then its steps walked back: dk_t's and dw_t's
//      partial sums from G_t and S_{t-1} to shared memory (summed and
//      written after the sub-chunk, as dr), then G <- w_t G + r_t^T dy_t.
// No atomics: two calls give the same bits.  dw needs S_{t-1} beside
// G_t; the recompute from checkpoints gives it exactly, at w down to 0
// (the pair-sum identity dw = d(log w) / w would divide by w there).  A
// full sub-chunk's steps are unrolled with no bound check, so the
// compiler can overlap their chains.
//
// Staging.  Each sub-chunk's rows of r, k, w (the block's 16 rows), v and
// dy (every column), and in the reverse pass its checkpoint, are copied
// with cp.async into a ring of three shared-memory buffers, two
// sub-chunks ahead of the one computed (r, k, v, dy stay in T and become
// f32 as they are read).  The host picks each tensor's copy size (16, 8,
// 4 or 2 bytes) from the alignment of its base, strides and rows; where
// every row is whole and every copy 16 bytes (the main path), each copy's
// place follows from compile-time counts, with no division at run time.
// Padded rows and columns (hd < HDP) are zeroed once and never copied:
// their state and gradient entries stay 0.
//
// What bounds the whole backward (this kernel and the forward kernel's
// dv pass): per (b, h, t) it must read r/k/v/dy (2 bytes each in bf16)
// and w (f32) and write dr/dk/dv (bf16) and dw (f32); at the training
// shape (4, 2048, 32, 64) that is about 375 MB, 0.11 ms at 3.35 TB/s.
// The least arithmetic is 5 f32 FMAs per state entry and step (the S and
// G recurrences, with the states kept scaled by running decay products,
// and the dr, dk and dv contractions; dw comes from the pair-sum identity
// at O(hd) a step): 10.7 GFLOP, 0.16 ms at 67 TFLOP/s.  This kernel
// issues 9 FP32 instructions per entry and step (S twice, G twice, three
// contractions), and writes and reads the checkpoints (256 MB each way at
// that shape); measured times are in PERF.md beside the card's name and
// power limit.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads of a block
constexpr int kRows = 16;         // rows of S a block owns
constexpr int kSub = 16;          // steps of a sub-chunk (a checkpoint)
constexpr int kRing = 3;          // staging buffers

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const void* dy;
  const float* u;    // (H, hd), contiguous
  const float* s0;   // (b, H, hd, hd), contiguous
  const float* dsT;  // (b, H, hd, hd), contiguous, or null (zeros)
  void* dr;          // (b, s, H, hd), contiguous, T
  void* dk;
  float* dw;         // (b, s, H, hd), contiguous
  float* du;         // (b, H, hd): per-(b, h) partial sums
  float* ck;         // (b, H, nsub, HDP, HDP) scratch: the checkpoints
  int b, s, h, hd;
  int vec[5];        // copy size in bytes of r, k, v, w, dy rows
  long long sb[5], ss[5], sh[5];   // (batch, seq, head) strides, same order
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N neighbouring elements of T in shared memory as f32 (N = 1, 2 or 4,
// aligned to N elements); a bf16 is the top half of the f32 it becomes.
template <int N>
__device__ __forceinline__ void load_n(const float* src, float* out) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *src;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* src,
                                       float* out) {
  if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(src);
    out[0] = __uint_as_float(a.x << 16);
    out[1] = __uint_as_float(a.x & 0xffff0000u);
    out[2] = __uint_as_float(a.y << 16);
    out[3] = __uint_as_float(a.y & 0xffff0000u);
  } else if constexpr (N == 2) {
    const unsigned a = *reinterpret_cast<const unsigned*>(src);
    out[0] = __uint_as_float(a << 16);
    out[1] = __uint_as_float(a & 0xffff0000u);
  } else {
    out[0] = __bfloat162float(*src);
  }
}
__device__ __forceinline__ float load1(const float* src) { return *src; }
__device__ __forceinline__ float load1(const __nv_bfloat16* src) {
  return __bfloat162float(*src);
}

// N neighbouring floats to memory (N = 1, 2 or 4, aligned).
template <int N>
__device__ __forceinline__ void st_vec(float* dst, const float* in) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(in[0], in[1]);
  } else {
    *dst = in[0];
  }
}

// One copy of BYTES from global to shared memory: cp.async (16: .cg, L2
// only; 8 and 4: .ca), or a plain load and store for 2.
template <int BYTES>
__device__ __forceinline__ void copy_async(char* dst, const char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else if constexpr (BYTES == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  else
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until every copy group of this thread but the newest has landed.
__device__ __forceinline__ void copy_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issues the copies of n rows of `row_bytes` each, `ss` bytes apart from
// src, into dst (rows `pitch` bytes apart), BYTES at a time, spread over
// the block's threads; (row, piece) of each copy advances without a
// division.
template <int BYTES>
__device__ __forceinline__ void copy_rows_n(char* dst, int pitch,
                                            const char* src, long long ss,
                                            int row_bytes, int n, int tid) {
  const int per_row = row_bytes / BYTES;
  const int dt = kThreads / per_row, dq = kThreads - dt * per_row;
  int t = tid / per_row, q = tid - t * per_row;
  for (int idx = tid; idx < n * per_row; idx += kThreads) {
    copy_async<BYTES>(dst + t * pitch + q * BYTES, src + t * ss + q * BYTES);
    t += dt;
    q += dq;
    if (q >= per_row) {
      q -= per_row;
      ++t;
    }
  }
}

// Not inlined: one body serves every instantiation of the kernel.
__device__ __noinline__ void copy_rows(char* dst, int pitch, const char* src,
                                       long long ss, int row_bytes, int n,
                                       int bytes, int tid) {
  switch (bytes) {
    case 16:
      copy_rows_n<16>(dst, pitch, src, ss, row_bytes, n, tid);
      break;
    case 8:
      copy_rows_n<8>(dst, pitch, src, ss, row_bytes, n, tid);
      break;
    case 4:
      copy_rows_n<4>(dst, pitch, src, ss, row_bytes, n, tid);
      break;
    default:
      copy_rows_n<2>(dst, pitch, src, ss, row_bytes, n, tid);
  }
}

// Shared memory of a block, in bytes from its start: kRing staging
// buffers (the rows of a sub-chunk: r, k of the block's rows in T, w of
// them in f32, v, dy of every column in T; the checkpoint's 16 x HDP
// floats), then the partial sums of dr (pass 1) or of dk and dw (pass 2)
// by (step, row, thread of the row).
template <typename T, int HDP>
struct Layout {
  static constexpr int C = HDP / 8;              // columns a thread holds
  static constexpr int VW = C < 4 ? C : 4;       // their vector width
  static constexpr int ES = sizeof(T);
  static constexpr int R = 0;                            // r: kSub x 16 T
  static constexpr int K = R + kSub * kRows * ES;        // k: kSub x 16 T
  static constexpr int W = K + kSub * kRows * ES;        // w: kSub x 16 f32
  static constexpr int V = W + kSub * kRows * 4;         // v: kSub x HDP T
  static constexpr int D = V + kSub * HDP * ES;          // dy: kSub x HDP
  static constexpr int CK = (D + kSub * HDP * ES + 15) / 16 * 16;  // f32
  static constexpr int BUF = CK + kRows * HDP * 4;
  static constexpr int PART = kRing * BUF;       // 2 x kSub x 16 x 8 f32
  static constexpr int PART_Q = kSub * kRows * 8;         // floats a sum
  static constexpr int BYTES = PART + 2 * PART_Q * 4;
  // column of entry c of thread g
  __device__ static int col(int g, int c) {
    return (c / VW) * (8 * VW) + g * VW + c % VW;
  }
};

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads) wkv6_bwd_kernel(Params p) {
  using Lay = Layout<T, HDP>;
  constexpr int C = Lay::C, VW = Lay::VW;
  extern __shared__ __align__(16) unsigned char smem[];

  const int z = blockIdx.z;               // row block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & 7;                 // thread of the row
  const int rl = tid >> 3;                // row in the block
  const int i = z * kRows + rl;           // row in the head
  const int h = blockIdx.x, bi = blockIdx.y;
  const int hd = p.hd, s = p.s;
  const int nsub = (s + kSub - 1) / kSub;
  const bool row_ok = i < hd;
  const long long bh = (long long)bi * p.h + h;
  const int rows_ok = max(0, min(kRows, hd - z * kRows));  // valid rows

  auto buffer = [&](int c) { return smem + (c % kRing) * Lay::BUF; };
  float* const part = reinterpret_cast<float*>(smem + Lay::PART);

  // padded rows and columns stay zero: zero the buffers once
  if (hd < HDP) {
    float4* zero = reinterpret_cast<float4*>(smem);
    for (int q = tid; q < kRing * Lay::BUF / 16; q += kThreads)
      zero[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // Every row whole and every tensor copied in 16-byte pieces (the main
  // path's contiguous tensors): each copy's (step, piece) follows from
  // compile-time counts.  Otherwise the general row copies.
  const bool fast = hd == HDP && p.vec[0] == 16 && p.vec[1] == 16 &&
                    p.vec[2] == 16 && p.vec[3] == 16 && p.vec[4] == 16;
  // the copies of sub-chunk c (and with `ck` its checkpoint) into its
  // buffer, as one group; an empty group for c out of range
  auto issue = [&](int c, bool ck) {
    if (c >= 0 && c < nsub) {
      unsigned char* buf = buffer(c);
      const long long t0 = (long long)c * kSub;
      const int n = min(kSub, s - c * kSub);
      auto base = [&](const void* src, int a, int es, int offset) {
        return static_cast<const char*>(src) +
               (bi * p.sb[a] + t0 * p.ss[a] + h * p.sh[a] + offset) * es;
      };
      const char* br = base(p.r, 0, Lay::ES, z * kRows);
      const char* bk = base(p.k, 1, Lay::ES, z * kRows);
      const char* bv = base(p.v, 2, Lay::ES, 0);
      const char* bw = base(p.w, 3, 4, z * kRows);
      const char* bd = base(p.dy, 4, Lay::ES, 0);
      if (fast) {
        // 16-byte pieces a step: r, k (the block's rows), w, v, dy
        constexpr int PR = kRows * Lay::ES / 16, PW = kRows * 4 / 16;
        constexpr int PV = HDP * Lay::ES / 16;
        constexpr int PER = 2 * PR + PW + 2 * PV, TOTAL = kSub * PER;
#pragma unroll
        for (int idx0 = 0; idx0 < TOTAL; idx0 += kThreads) {
          const int idx = idx0 + tid;
          const int t = idx / PER, q = idx - t * PER;
          if (idx < TOTAL && t < n) {
            char* d;
            const char* src;
            if (q < 2 * PR) {
              const int a = q / PR, piece = q - a * PR;
              d = reinterpret_cast<char*>(buf) + (a ? Lay::K : Lay::R) +
                  t * kRows * Lay::ES + piece * 16;
              src = (a ? bk + t * p.ss[1] * Lay::ES
                       : br + t * p.ss[0] * Lay::ES) + piece * 16;
            } else if (q < 2 * PR + PW) {
              const int piece = q - 2 * PR;
              d = reinterpret_cast<char*>(buf) + Lay::W + t * kRows * 4 +
                  piece * 16;
              src = bw + t * p.ss[3] * 4 + piece * 16;
            } else {
              const int a = (q - 2 * PR - PW) / PV;
              const int piece = q - 2 * PR - PW - a * PV;
              d = reinterpret_cast<char*>(buf) + (a ? Lay::D : Lay::V) +
                  t * HDP * Lay::ES + piece * 16;
              src = (a ? bd + t * p.ss[4] * Lay::ES
                       : bv + t * p.ss[2] * Lay::ES) + piece * 16;
            }
            copy_async<16>(d, src);
          }
        }
      } else {
        const char* bases[5] = {br, bk, bv, bw, bd};
        const int dst[5] = {Lay::R, Lay::K, Lay::V, Lay::W, Lay::D};
        const int es[5] = {Lay::ES, Lay::ES, Lay::ES, 4, Lay::ES};
#pragma unroll
        for (int a = 0; a < 5; ++a) {
          const bool rowwise = a != 2 && a != 4;   // r, k, w: the rows only
          const int len = (rowwise ? rows_ok : hd) * es[a];
          if (len > 0)
            copy_rows(reinterpret_cast<char*>(buf + dst[a]),
                      (rowwise ? kRows : HDP) * es[a], bases[a],
                      p.ss[a] * es[a], len, n, p.vec[a], tid);
        }
      }
      if (ck) {
        const char* src = reinterpret_cast<const char*>(
            p.ck + ((bh * nsub + c) * HDP + z * kRows) * HDP);
        for (int q = tid; q < kRows * HDP / 4; q += kThreads)
          copy_async<16>(reinterpret_cast<char*>(buf + Lay::CK) + q * 16,
                         src + q * 16);
      }
    }
    copy_commit();
  };
  // waits for sub-chunk c's copies (every group but the newest); nothing
  // for c out of range
  auto land = [&](int c) {
    if (c < 0 || c >= nsub) return;
    copy_wait_older();
    __syncthreads();
  };
  // a step's operands from a sub-chunk's buffer
  struct Ops {
    float r, k, w, v[C], dy[C];
  };
  auto operands = [&](const unsigned char* buf, int j, Ops& o) {
    const T* sv = reinterpret_cast<const T*>(buf + Lay::V) + j * HDP;
    const T* sd = reinterpret_cast<const T*>(buf + Lay::D) + j * HDP;
    o.r = load1(reinterpret_cast<const T*>(buf + Lay::R) + j * kRows + rl);
    o.k = load1(reinterpret_cast<const T*>(buf + Lay::K) + j * kRows + rl);
    o.w = reinterpret_cast<const float*>(buf + Lay::W)[j * kRows + rl];
#pragma unroll
    for (int c = 0; c < C; c += VW) {
      load_n<VW>(sv + Lay::col(g, c), o.v + c);
      load_n<VW>(sd + Lay::col(g, c), o.dy + c);
    }
  };
  // the sum of the 8 partials of (step, row) `idx` of partial sums q
  auto part_sum = [&](int q, int idx) {
    const float* src = part + q * Lay::PART_Q + idx * 8;
    float x[8];
    load_n<4>(src, x);
    load_n<4>(src + 4, x + 4);
    return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
  };
  auto out_index = [&](long long t, int idx) {
    return ((bi * (long long)s + t) * p.h + h) * hd + idx;
  };
  // this thread's entries of a (hd, hd) f32 matrix of (b, h), or zeros
  auto load_entries = [&](const float* m, float* out) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = Lay::col(g, c);
      out[c] = (m != nullptr && row_ok && col < hd)
                   ? m[(bh * hd + i) * hd + col] : 0.f;
    }
  };
  // After a sub-chunk: warp w takes its steps [4 w, 4 w + 4), forms v.dy
  // of each from its lanes, then hands each of its 64 (step, row) outputs
  // to a lane, two a lane, the block's 16 rows of a step to 16 lanes:
  // out(j, row, v.dy) for the valid ones.  A lane's rows are always row
  // lane % 16.
  constexpr int kStepsPerWarp = kSub / (kThreads / 32);
  const int brow = lane & 15;
  const bool brow_ok = brow < rows_ok;
  const float u_brow = brow_ok ? p.u[h * hd + z * kRows + brow] : 0.f;
  auto each_output = [&](const unsigned char* buf, int n, auto out) {
    const T* sv = reinterpret_cast<const T*>(buf + Lay::V);
    const T* sd = reinterpret_cast<const T*>(buf + Lay::D);
    float vd[kStepsPerWarp];
#pragma unroll
    for (int e = 0; e < kStepsPerWarp; ++e) {
      const int j = warp * kStepsPerWarp + e;
      float x = 0.f;
#pragma unroll
      for (int col = lane; col < HDP; col += 32)
        x = fmaf(load1(sv + j * HDP + col), load1(sd + j * HDP + col), x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      vd[e] = x;
    }
#pragma unroll
    for (int e = 0; e < kStepsPerWarp; e += 2) {
      const int el = e + (lane >> 4);
      const int j = warp * kStepsPerWarp + el;
      if (j < n && brow_ok)
        out(j, (lane & 16) ? vd[e + 1] : vd[e]);
    }
  };

  // ------------------------------------------------ pass 1: forward
  float S[C];
  load_entries(p.s0, S);
  float du_acc = 0.f;     // du of row brow, over this lane's outputs
  issue(0, false);
  issue(1, false);
  land(0);
  for (int c = 0; c < nsub; ++c) {
    const unsigned char* buf = buffer(c);
    issue(c + 2, false);
    float* ckp = p.ck + ((bh * nsub + c) * HDP + i) * HDP;
#pragma unroll
    for (int q = 0; q < C; q += VW) st_vec<VW>(ckp + Lay::col(g, q), S + q);
    const int n = min(kSub, s - c * kSub);
    auto step = [&](int j) {
      Ops o;
      operands(buf, j, o);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        acc = fmaf(S[q], o.dy[q], acc);
        S[q] = fmaf(o.w, S[q], o.k * o.v[q]);
      }
      part[(j * kRows + rl) * 8 + g] = acc;
    };
    if (n == kSub) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) step(j);
    } else {
      for (int j = 0; j < n; ++j) step(j);
    }
    __syncthreads();
    // dr of the sub-chunk, with the u term; du's terms
    each_output(buf, n, [&](int j, float vd) {
      const float rr = load1(reinterpret_cast<const T*>(buf + Lay::R) +
                             j * kRows + brow);
      const float kk = load1(reinterpret_cast<const T*>(buf + Lay::K) +
                             j * kRows + brow);
      static_cast<T*>(p.dr)[out_index(c * kSub + j, z * kRows + brow)] =
          from_f32<T>(fmaf(u_brow * kk, vd, part_sum(0, j * kRows + brow)));
      du_acc = fmaf(rr * kk, vd, du_acc);
    });
    land(c + 1);
  }
  // du of each row: the 8 lanes that hold it (two a warp), in order
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 16);
  __syncthreads();
  if (lane < kRows) part[warp * kRows + lane] = du_acc;
  __syncthreads();   // and the checkpoints are written before they are read
  if (tid < rows_ok) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) sum += part[q * kRows + tid];
    p.du[bh * hd + z * kRows + tid] = sum;
  }
  __syncthreads();

  // ------------------------------------------------ pass 2: reverse
  float G[C];
  load_entries(p.dsT, G);
  issue(nsub - 1, true);
  issue(nsub - 2, true);
  land(nsub - 1);
  for (int c = nsub - 1; c >= 0; --c) {
    const unsigned char* buf = buffer(c);
    issue(c - 2, true);
    const int n = min(kSub, s - c * kSub);
    // S_{t-1} of every step of the sub-chunk, from its checkpoint; past n
    // the staged rows are stale, and nothing reads those states
    float stash[kSub][C];
    {
      float Sx[C];
#pragma unroll
      for (int q = 0; q < C; q += VW)
        load_n<VW>(reinterpret_cast<const float*>(buf + Lay::CK) +
                       rl * HDP + Lay::col(g, q), Sx + q);
      const T* sk = reinterpret_cast<const T*>(buf + Lay::K);
      const float* sw = reinterpret_cast<const float*>(buf + Lay::W);
      const T* sv = reinterpret_cast<const T*>(buf + Lay::V);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int q = 0; q < C; ++q) stash[j][q] = Sx[q];
        const float kk = load1(sk + j * kRows + rl), ww = sw[j * kRows + rl];
        float vv[C];
#pragma unroll
        for (int q = 0; q < C; q += VW)
          load_n<VW>(sv + j * HDP + Lay::col(g, q), vv + q);
#pragma unroll
        for (int q = 0; q < C; ++q) Sx[q] = fmaf(ww, Sx[q], kk * vv[q]);
      }
    }
    auto step = [&](int j) {
      Ops o;
      operands(buf, j, o);
      float dk_acc = 0.f, dw_acc = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        dk_acc = fmaf(G[q], o.v[q], dk_acc);
        dw_acc = fmaf(G[q], stash[j][q], dw_acc);
        G[q] = fmaf(o.w, G[q], o.r * o.dy[q]);
      }
      part[(j * kRows + rl) * 8 + g] = dk_acc;
      part[Lay::PART_Q + (j * kRows + rl) * 8 + g] = dw_acc;
    };
    if (n == kSub) {
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) step(j);
    } else {
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j)
        if (j < n) step(j);
    }
    __syncthreads();
    // dk (with the u term) and dw of the sub-chunk
    each_output(buf, n, [&](int j, float vd) {
      const float rr = load1(reinterpret_cast<const T*>(buf + Lay::R) +
                             j * kRows + brow);
      const long long o = out_index(c * kSub + j, z * kRows + brow);
      static_cast<T*>(p.dk)[o] =
          from_f32<T>(fmaf(u_brow * rr, vd, part_sum(0, j * kRows + brow)));
      p.dw[o] = part_sum(1, j * kRows + brow);
    });
    land(c - 1);
  }
}

template <typename T, int HDP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Layout<T, HDP>::BYTES;
  auto kernel = wkv6_bwd_kernel<T, HDP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.h, p.b, HDP / kRows), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_head_dim(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch<T, 16>(p, stream);
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  return launch<T, 64>(p, stream);
}

// The largest cp.async size (16, 8 or 4 bytes; 2: plain copies) that
// divides the address of every row copied: the base, the strides and the
// row's length (`row_elems`) in bytes, and `offset_elems` (r, k, w: a
// block's rows start 16 elements apart).
int copy_bytes(const void* base, const long long* strides, int esize,
               int row_elems, int offset_elems) {
  unsigned long long bits =
      reinterpret_cast<uintptr_t>(base) |
      static_cast<unsigned long long>(row_elems * esize) |
      static_cast<unsigned long long>(offset_elems * esize);
  for (int q = 0; q < 3; ++q)
    bits |= static_cast<unsigned long long>(strides[q] * esize);
  for (int bytes = 16; bytes >= 4; bytes /= 2)
    if (bits % bytes == 0) return bytes;
  return 2;
}

}  // namespace

// dtype (of r, k, v, dy and dr, dk): 0 = float32, 1 = bfloat16; w, u, the
// states, dw, du and the scratch are float32.  strides: 15 element
// strides, the (batch, seq, head) strides of r, k, v, w and dy in that
// order; the head-dim stride of each must be 1.  dr, dk, dw (b, s, H,
// hd), du (b, H, hd), s0 (b, H, hd, hd) and u (H, hd) are contiguous; dsT
// is contiguous or null; ck holds b H ceil(s / 16) HDP^2 floats, HDP = hd
// padded to 16, 32 or 64.  Returns a cudaError_t (0 = launched).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* dy, const void* u,
                        const void* s0, const void* dsT, void* dr, void* dk,
                        void* dw, void* du, void* ck, int dtype, int b, int s,
                        int h, int hd, const long long* strides,
                        void* stream) {
  if (hd < 1 || hd > 64 || s < 1 || b < 1 || b > 65535 || h < 1 ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.dy = dy;
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.dsT = static_cast<const float*>(dsT);
  p.dr = dr;
  p.dk = dk;
  p.dw = static_cast<float*>(dw);
  p.du = static_cast<float*>(du);
  p.ck = static_cast<float*>(ck);
  p.b = b;
  p.s = s;
  p.h = h;
  p.hd = hd;
  const int esize = dtype == 0 ? 4 : 2;
  // r, k, v, w, dy: element sizes; r, k, w copy a block's rows (16, or
  // hd % 16 in the last block), v and dy whole rows
  const void* bases[5] = {r, k, v, w, dy};
  const int sizes[5] = {esize, esize, esize, 4, esize};
  const int last = hd % 16 ? hd % 16 : 16;
  const int elems[5] = {last, last, hd, last, hd};
  const int offsets[5] = {16, 16, 0, 16, 0};
  for (int a = 0; a < 5; ++a) {
    p.sb[a] = strides[3 * a];
    p.ss[a] = strides[3 * a + 1];
    p.sh[a] = strides[3 * a + 2];
    p.vec[a] = copy_bytes(bases[a], strides + 3 * a, sizes[a], elems[a],
                          offsets[a]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_for_head_dim<float>(p, st)
                              : launch_for_head_dim<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}
