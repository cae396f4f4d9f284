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
// Two routes, which kernel_bwd.plan picks before the forward runs: the
// "general" kernel described next (entry point wkv6_bwd; every head dim
// up to 64, any strides), and the "hopper" kernel at the end of the file
// (entry point wkv6_bwd_hopper; hd 64, views TMA can read), which reads
// the state checkpoints that K2's forward stores in training mode.
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

// ---------------------------------------------------------------------
// The "hopper" route: dr, dk, dw, du from the forward's checkpoints.
//
// K2's forward in training mode (csrc/wkv6.cu, CKPT) stores S_{t-1} at
// the start of every SUB-step sub-chunk into ck (b, H, ceil(s / SUB), 64,
// 64) f32, each row's 16-byte chunks permuted by ck_swizzle (below).  So
// this kernel has no forward pass: it walks the sub-chunks from the last,
// and for each
//   1. recomputes its SUB states from the checkpoint into registers (the
//      stash), forming dr_t's partial sums on the way:
//        dr_t = S_{t-1} dy_t (+ u . k_t (v_t . dy_t), added once summed);
//   2. walks them back with G = dL/dS_t:
//        dk_t = G_t v_t (+ u . r_t (v_t . dy_t)),
//        dw_t = rowsum(G_t . S_{t-1}),
//        G_{t-1} = diag(w_t) G_t + r_t^T dy_t.
// That is 7 f32 instructions an entry and step (k v, S, dr; dk, dw, r dy,
// G), against the general kernel's 9 and the bound's 5 (above): about
// 0.22 ms of FMA issue at (4, 2048, 32, 64) on 132 SMs.  dw takes S_{t-1}
// and G_t together, exactly, at any w in [0, 1].  Measured times, per
// tile, are in PERF.md beside the card's name and power limit.
//
// Tiles.  A block owns one (batch, head) and all 64 rows: grid (H, b).
// Its NT = 64 x 64 / (R C) consumer threads each hold R rows x C columns
// of G and of SUB stashed states (SUB R C registers), thread (rg, cg) =
// (tid % NRG, tid / NRG) rows rg R .. rg R + R - 1 and the C columns of
// 16-byte chunks x NCG + cg (x < C / 4), so that a warp's lanes read
// neighbouring rows of r, k, w and one column group of v, dy (a
// broadcast).  Each step's row sums over a thread's C columns go to
// shared memory as partials (q, step, column group, row); after the
// sub-chunk every (step, row) sums its NCG partials in the order cg = 0,
// 1, .., adds the u term and writes dr, dk (in T) and dw (f32), and its
// thread adds r k (v . dy) to du of its row.  No atomics: two calls give
// the same bits.  Where two sets of partials fit, the next sub-chunk's
// steps write the other set while the sums read this one.
//
// Staging.  One producer warp: lane 0 loads each sub-chunk with TMA into
// a ring of STAGES stages guarded by mbarriers (full: the copies landed;
// ready: the producer prepared them; empty: every consumer is done): r,
// k, v, dy and w as boxes of (SUB steps, 64) from rank-4 {hd, h, s, b}
// tensor maps, and the checkpoint as one bulk copy of 16 KB.  Then the
// warp turns bf16 r, k, v, dy into f32 arrays of the stage (the
// consumers read f32 and convert nothing), sums v_t . dy_t of each step,
// and in a ragged last sub-chunk sets w = 1 past s: TMA fills those steps
// with zeros, so with w = 1 they leave S and G as they are (a zero w
// would erase them) and no consumer tests a bound.
//
// The checkpoint's swizzle: chunk q (columns 4q .. 4q + 3) of row i is
// stored at chunk q ^ ck_swizzle(i), which differs mod 8 across the 8
// rows {l R + e} that 8 lanes read together for R in {1, 2, 4}, so each
// 16-byte load of the stash's first state is free of bank conflicts.
//
// Preconditions (kernel_bwd.plan routes every other call to the general
// kernel above): hd 64; r, k, v, dy in one of f32, bf16 and w f32, each
// with base address and (batch, seq, head) strides in bytes multiples of
// 16.

#include <cuda.h>   // CUtensorMap and its enums; no libcuda is linked

namespace {
namespace hopper {

constexpr int HD = 64;
constexpr int STAGES = 3;
constexpr int PRODUCER = 32;           // one warp
constexpr int SMEM_MAX = 232448;       // a block's shared memory, at most
constexpr int ALIGN = 128;             // TMA destinations

__host__ __device__ constexpr int ck_swizzle(int row) {
  return (row & 7) ^ ((row >> 3) & 3);
}

// Shared memory of a block, in bytes from its 128-byte aligned base:
// STAGES stages (f32 (SUB, 64) arrays of r, k, v, dy, w; v . dy of each
// step; the checkpoint's 64 x 64 f32; with bf16 inputs the TMA boxes of
// r, k, v, dy as they land), then NPART sets of partials, du's partials
// and the barriers.
template <typename T, int R, int C, int SUB>
struct Cfg {
  static constexpr int NCG = HD / C;         // column groups
  static constexpr int NRG = HD / R;         // row groups
  static constexpr int NT = NCG * NRG;       // consumer threads
  static constexpr int THREADS = NT + PRODUCER;
  static constexpr bool RAW = sizeof(T) == 2;
  static constexpr int ROWF = SUB * HD * 4;
  static constexpr int ROWT = SUB * HD * static_cast<int>(sizeof(T));
  static constexpr int F_R = 0, F_K = ROWF, F_V = 2 * ROWF, F_D = 3 * ROWF;
  static constexpr int F_W = 4 * ROWF;
  static constexpr int VD = 5 * ROWF;
  static constexpr int CK = VD + (SUB * 4 + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int RAW_OFF = CK + HD * HD * 4;
  static constexpr int STAGE = RAW_OFF + (RAW ? 4 * ROWT : 0);
  static constexpr int PART_Q = SUB * NCG * HD;       // floats a quantity
  static constexpr int PART = 3 * PART_Q * 4;         // bytes a set
  static constexpr int DU = NT * 4;
  static constexpr int BARS = 3 * STAGES * 8;
  static constexpr int NPART =
      STAGES * STAGE + 2 * PART + DU + BARS + ALIGN <= SMEM_MAX ? 2 : 1;
  static constexpr int PART_OFF = STAGES * STAGE;
  static constexpr int DU_OFF = PART_OFF + NPART * PART;
  static constexpr int BAR_OFF = DU_OFF + DU;
  static constexpr int BYTES = BAR_OFF + BARS + ALIGN;   // + base alignment
  // bytes a stage's copies bring: 4 boxes of T, w's box, the checkpoint
  static constexpr uint32_t TX = 4 * ROWT + ROWF + HD * HD * 4;
  static_assert(C % 4 == 0 && HD % C == 0 && HD % R == 0 && R <= 4 &&
                    NT % HD == 0 && NT % 32 == 0,
                "tile");
  static_assert(STAGE % ALIGN == 0 && ROWT % ALIGN == 0, "alignment");
  static_assert(BYTES <= SMEM_MAX, "shared memory");
};

struct Params {
  const float* u;     // (H, 64)
  const float* dsT;   // (b, H, 64, 64) or null (zeros)
  const float* ck;    // (b, H, nsub, 64, 64), swizzled rows
  void* dr;           // (b, s, H, 64), contiguous, T
  void* dk;
  float* dw;          // (b, s, H, 64), contiguous
  float* du;          // (b, H, 64): per-(b, h) partial sums
  int b, s, h, nsub;
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

// Waits until the barrier's phase of parity `parity` has completed.  A
// wait of 2^34 clocks (about 10 s) can only be a fault of the kernel (a
// lost arrival, a wrong byte count or phase): it traps, so the launch
// fails with an error instead of hanging the card.
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
                                         int c_s, int c_h, int c_b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c_h), "r"(c_s),
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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// N neighbouring floats of shared memory (N = 1, 2 or 4, aligned).
template <int N>
__device__ __forceinline__ void lds(const float* src, float* out) {
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
__device__ __forceinline__ void sts(float* dst, const float* in) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(in[0], in[1]);
  } else {
    *dst = in[0];
  }
}

template <typename T, int R, int C, int SUB>
__global__ void __launch_bounds__(Cfg<T, R, C, SUB>::THREADS, 1)
    wkv6_bwd_hopper_kernel(const __grid_constant__ CUtensorMap map_r,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_dy,
                           const __grid_constant__ CUtensorMap map_w,
                           const Params p) {
  using L = Cfg<T, R, C, SUB>;
  constexpr int NCG = L::NCG, NRG = L::NRG, NT = L::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base_u32 = (raw_u32 + ALIGN - 1) & ~(ALIGN - 1u);
  unsigned char* const base = smem_raw + (base_u32 - raw_u32);
  const uint32_t bars = base_u32 + L::BAR_OFF;
  auto full = [&](int st) { return bars + 8 * st; };
  auto ready = [&](int st) { return bars + 8 * (STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * STAGES + st); };
  const int tid = threadIdx.x;
  const int h = blockIdx.x, bi = blockIdx.y;
  const long long bh = static_cast<long long>(bi) * p.h + h;
  const int nsub = p.nsub;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(ready(st), PRODUCER);
      mbar_init(empty(st), NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NT) {
    // ------------------------------------------------------- producer
    const int lane = tid - NT;
    // the copies of the i-th sub-chunk walked (c = nsub - 1 - i) into
    // stage i % STAGES, once every consumer is done with its last use
    auto issue = [&](int i) {
      if (lane != 0) return;
      const int st = i % STAGES, c = nsub - 1 - i;
      mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
      // the producer's own writes to the stage (w past s) come before
      // the copies that overwrite it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sb = base_u32 + st * L::STAGE;
      const uint32_t bar = full(st);
      const uint32_t in = sb + (L::RAW ? L::RAW_OFF : 0);
      const uint32_t step = L::RAW ? L::ROWT : L::ROWF;
      mbar_expect_tx(bar, L::TX);
      tma_load(in, &map_r, c * SUB, h, bi, bar);
      tma_load(in + step, &map_k, c * SUB, h, bi, bar);
      tma_load(in + 2 * step, &map_v, c * SUB, h, bi, bar);
      tma_load(in + 3 * step, &map_dy, c * SUB, h, bi, bar);
      tma_load(sb + L::F_W, &map_w, c * SUB, h, bi, bar);
      bulk_load(sb + L::CK, p.ck + (bh * nsub + c) * HD * HD, HD * HD * 4,
                bar);
    };
    issue(0);
    if (nsub > 1) issue(1);
    for (int i = 0; i < nsub; ++i) {
      const int st = i % STAGES, c = nsub - 1 - i;
      const int n = min(SUB, p.s - c * SUB);
      mbar_wait(full(st), (i / STAGES) & 1);
      float* const f = reinterpret_cast<float*>(base + st * L::STAGE);
      float* const fr = f + L::F_R / 4;
      float* const fk = f + L::F_K / 4;
      float* const fv = f + L::F_V / 4;
      float* const fd = f + L::F_D / 4;
      float* const fw = f + L::F_W / 4;
      float* const vd = f + L::VD / 4;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int o = j * HD + 2 * lane;     // columns 2 lane, 2 lane + 1
        float2 vv, dd;
        if constexpr (L::RAW) {
          // a bf16 pair: the element at the even index in the low half
          const unsigned* in = reinterpret_cast<const unsigned*>(
              base + st * L::STAGE + L::RAW_OFF);
          const unsigned x[4] = {in[o / 2], in[(SUB * HD + o) / 2],
                                 in[(2 * SUB * HD + o) / 2],
                                 in[(3 * SUB * HD + o) / 2]};
          float2 y[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            y[a] = make_float2(__uint_as_float(x[a] << 16),
                               __uint_as_float(x[a] & 0xffff0000u));
          *reinterpret_cast<float2*>(fr + o) = y[0];
          *reinterpret_cast<float2*>(fk + o) = y[1];
          *reinterpret_cast<float2*>(fv + o) = y[2];
          *reinterpret_cast<float2*>(fd + o) = y[3];
          vv = y[2];
          dd = y[3];
        } else {
          vv = *reinterpret_cast<const float2*>(fv + o);
          dd = *reinterpret_cast<const float2*>(fd + o);
        }
        float x = fmaf(vv.y, dd.y, vv.x * dd.x);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) vd[j] = x;
        if (j >= n) *reinterpret_cast<float2*>(fw + o) = make_float2(1.f, 1.f);
      }
      mbar_arrive(ready(st));   // release: the f32 arrays, v . dy, w past s
      if (i + 2 < nsub) issue(i + 2);
      __syncwarp();
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int rg = tid % NRG, cg = tid / NRG;
  const int row0 = rg * R;
  // G of this thread's entries: rows row0 + e, columns 4 (x NCG + cg) + m
  float G[R][C];
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int x = 0; x < C / 4; ++x) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p.dsT != nullptr)
        a = *reinterpret_cast<const float4*>(
            p.dsT + (bh * HD + row0 + e) * HD + 4 * (x * NCG + cg));
      G[e][4 * x] = a.x; G[e][4 * x + 1] = a.y;
      G[e][4 * x + 2] = a.z; G[e][4 * x + 3] = a.w;
    }
  const int my_row = tid % HD;            // the row of this thread's sums
  const float u_row = p.u[h * HD + my_row];
  float du_acc = 0.f;
  T* const dr = static_cast<T*>(p.dr);
  T* const dk = static_cast<T*>(p.dk);

  for (int i = 0; i < nsub; ++i) {
    const int st = i % STAGES, c = nsub - 1 - i;
    const int n = min(SUB, p.s - c * SUB);
    mbar_wait(ready(st), (i / STAGES) & 1);
    const float* const f =
        reinterpret_cast<const float*>(base + st * L::STAGE);
    const float* const fr = f + L::F_R / 4;
    const float* const fk = f + L::F_K / 4;
    const float* const fv = f + L::F_V / 4;
    const float* const fd = f + L::F_D / 4;
    const float* const fw = f + L::F_W / 4;
    float* const part = reinterpret_cast<float*>(base + L::PART_OFF) +
                        (L::NPART == 2 ? (i & 1) * 3 * L::PART_Q : 0);
    // partial sums of quantity q (0 dr, 1 dk, 2 dw) of step j, this thread
    auto part_at = [&](int q, int j) {
      return part + ((q * SUB + j) * NCG + cg) * HD + row0;
    };
    // a step's columns of v and dy
    auto columns = [&](const float* a, int j, float* out) {
#pragma unroll
      for (int x = 0; x < C / 4; ++x)
        lds<4>(a + j * HD + 4 * (x * NCG + cg), out + 4 * x);
    };

    // 1. the sub-chunk's states from its checkpoint, and dr's partials
    float stash[SUB][R][C];
    {
      float S[R][C];
      const float* ck = f + L::CK / 4;
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const int row = row0 + e;
#pragma unroll
        for (int x = 0; x < C / 4; ++x)
          lds<4>(ck + row * HD + 4 * ((x * NCG + cg) ^ ck_swizzle(row)),
                 &S[e][4 * x]);
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        float kk[R], ww[R], vv[C], dd[C], acc[R];
        lds<R>(fk + j * HD + row0, kk);
        lds<R>(fw + j * HD + row0, ww);
        columns(fv, j, vv);
        columns(fd, j, dd);
#pragma unroll
        for (int e = 0; e < R; ++e) {
          acc[e] = 0.f;
#pragma unroll
          for (int m = 0; m < C; ++m) {
            stash[j][e][m] = S[e][m];
            acc[e] = fmaf(S[e][m], dd[m], acc[e]);
            S[e][m] = fmaf(ww[e], S[e][m], kk[e] * vv[m]);
          }
        }
        sts<R>(part_at(0, j), acc);
      }
    }
    // 2. back through the sub-chunk: dk's and dw's partials, G
#pragma unroll
    for (int j = SUB - 1; j >= 0; --j) {
      float rr[R], ww[R], vv[C], dd[C], ak[R], aw[R];
      lds<R>(fr + j * HD + row0, rr);
      lds<R>(fw + j * HD + row0, ww);
      columns(fv, j, vv);
      columns(fd, j, dd);
#pragma unroll
      for (int e = 0; e < R; ++e) {
        ak[e] = 0.f;
        aw[e] = 0.f;
#pragma unroll
        for (int m = 0; m < C; ++m) {
          ak[e] = fmaf(G[e][m], vv[m], ak[e]);
          aw[e] = fmaf(G[e][m], stash[j][e][m], aw[e]);
          G[e][m] = fmaf(ww[e], G[e][m], rr[e] * dd[m]);
        }
      }
      sts<R>(part_at(1, j), ak);
      sts<R>(part_at(2, j), aw);
    }
    bar_sync(1, NT);   // every partial of the sub-chunk is written

    // 3. each (step, row): its partials summed in order, the u terms
    const float* vd = f + L::VD / 4;
    const float* const ps = reinterpret_cast<const float*>(base + L::PART_OFF) +
                            (L::NPART == 2 ? (i & 1) * 3 * L::PART_Q : 0);
    for (int idx = tid; idx < SUB * HD; idx += NT) {
      const int j = idx / HD;
      if (j >= n) break;
      float sum[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* src = ps + (q * SUB + j) * NCG * HD + my_row;
        sum[q] = src[0];
#pragma unroll
        for (int g = 1; g < NCG; ++g) sum[q] += src[g * HD];
      }
      const float vdj = vd[j];
      const float rr = fr[j * HD + my_row], kk = fk[j * HD + my_row];
      const long long o =
          ((static_cast<long long>(bi) * p.s + c * SUB + j) * p.h + h) * HD +
          my_row;
      dr[o] = from_f32<T>(fmaf(u_row * kk, vdj, sum[0]));
      dk[o] = from_f32<T>(fmaf(u_row * rr, vdj, sum[1]));
      p.dw[o] = sum[2];
      du_acc = fmaf(rr * kk, vdj, du_acc);
    }
    mbar_arrive(empty(st));               // the stage is read
    if constexpr (L::NPART == 1) bar_sync(1, NT);   // and the partials
  }

  // du of each row: the NT / 64 threads that hold it, in order
  float* const dup = reinterpret_cast<float*>(base + L::DU_OFF);
  dup[tid] = du_acc;
  bar_sync(1, NT);
  if (tid < HD) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < NT / HD; ++q) sum += dup[q * HD + tid];
    p.du[bh * HD + tid] = sum;
  }
}

// The (R, C, SUB) tiles instantiated: the serving library holds
// kernel_bwd.PLAN alone, the sweep library (built with -DWKV6_BWD_SWEEP,
// only when chip_smoke.py times the candidates) kernel_bwd.SWEEP_TILES.
#ifdef WKV6_BWD_SWEEP
#define WKV6_BWD_TILES(X) \
  X(2, 8, 8) X(4, 4, 8) X(1, 16, 8) X(1, 8, 8) X(2, 4, 8) X(4, 8, 4)
#else
#define WKV6_BWD_TILES(X) X(1, 16, 8)
#endif

template <typename T, int R, int C, int SUB>
cudaError_t launch(const CUtensorMap* maps, const Params& p,
                   cudaStream_t stream) {
  using L = Cfg<T, R, C, SUB>;
  auto kernel = wkv6_bwd_hopper_kernel<T, R, C, SUB>;
  if (p.nsub != (p.s + SUB - 1) / SUB) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.h, p.b), L::THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_tile(const CUtensorMap* maps, const Params& p,
                            int rows, int cols, int sub,
                            cudaStream_t stream) {
#define WKV6_BWD_CASE(R, C, SUB)                    \
  if (rows == R && cols == C && sub == SUB)         \
    return launch<T, R, C, SUB>(maps, p, stream);
  WKV6_BWD_TILES(WKV6_BWD_CASE)
#undef WKV6_BWD_CASE
  return cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled is a libcuda function; it is looked up at run
// time through the CUDA runtime's entry point query, so the library links
// no libcuda.
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

// Tensor map of a (b, s, h, 64) tensor with element strides sb, ss, sh
// (hd stride 1): rank 4, dims {64, h, s, b}, boxes of 64 x 1 x sub x 1,
// no swizzle, zero fill past s.
CUresult make_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr,
                  bool f32, int b, int s, int h, const long long* st,
                  int sub) {
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * es,
                                 static_cast<cuuint64_t>(st[1]) * es,
                                 static_cast<cuuint64_t>(st[0]) * es};
  const cuuint32_t box[4] = {HD, 1, static_cast<cuuint32_t>(sub), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
}  // namespace

// The "hopper" route.  dtype (of r, k, v, dy and dr, dk): 0 = float32, 1 =
// bfloat16; w, u, dsT, ck, dw and du float32.  hd must be 64.  strides:
// 15 element strides, the (batch, seq, head) strides of r, k, v, w and dy
// in that order (head-dim stride 1; base addresses and strides in bytes
// multiples of 16).  ck (b, H, ceil(s / sub_steps), 64, 64) holds the
// states the forward kernel stored in training mode with ck_steps =
// sub_steps.  dr, dk, dw (b, s, H, 64), du (b, H, 64) and u (H, 64) are
// contiguous; dsT is contiguous or null.  (rows, cols, sub_steps) is one
// of WKV6_BWD_TILES.  Returns a cudaError_t (0 = launched), or 1000 + the
// CUresult of a tensor map that failed to encode, or 2000 if libcuda has
// no cuTensorMapEncodeTiled.
extern "C" int wkv6_bwd_hopper(const void* r, const void* k, const void* v,
                               const void* w, const void* dy, const void* u,
                               const void* dsT, const void* ck, void* dr,
                               void* dk, void* dw, void* du, int dtype, int b,
                               int s, int h, int hd,
                               const long long* strides, int rows, int cols,
                               int sub_steps, void* stream) {
  if (hd != hopper::HD || s < 1 || b < 1 || b > 65535 || h < 1 ||
      dtype < 0 || dtype > 1 || sub_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // cuTensorMapEncodeTiled, a driver call, needs a current context; the
  // runtime makes the device's primary context current in this thread
  // here.  Autograd runs a backward on a thread of its own, where this
  // may be the first CUDA call (it then failed with
  // CUDA_ERROR_INVALID_CONTEXT).
  const cudaError_t ctx = cudaFree(nullptr);
  if (ctx != cudaSuccess) return static_cast<int>(ctx);
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return 2000;
  CUtensorMap maps[5];
  // r, k, v, dy in T; w in f32
  const void* ptrs[5] = {r, k, v, dy, w};
  const int which[5] = {0, 1, 2, 4, 3};   // their strides' place
  for (int a = 0; a < 5; ++a) {
    const CUresult res = hopper::make_map(
        &maps[a], encode, ptrs[a], a == 4 || dtype == 0, b, s, h,
        strides + 3 * which[a], sub_steps);
    if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  }
  hopper::Params p;
  p.u = static_cast<const float*>(u);
  p.dsT = static_cast<const float*>(dsT);
  p.ck = static_cast<const float*>(ck);
  p.dr = dr;
  p.dk = dk;
  p.dw = static_cast<float*>(dw);
  p.du = static_cast<float*>(du);
  p.b = b;
  p.s = s;
  p.h = h;
  p.nsub = (s + sub_steps - 1) / sub_steps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? hopper::launch_for_tile<float>(maps, p, rows, cols,
                                                  sub_steps, st)
                 : hopper::launch_for_tile<__nv_bfloat16>(maps, p, rows, cols,
                                                          sub_steps, st);
  return static_cast<int>(err);
}
