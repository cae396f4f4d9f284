// WKV6 (RWKV-6 "Finch") recurrence forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv6_pallas` (body `_kernel`) in
// src/repro/kernels/rwkv6/kernel.py, with the same contract: for each
// (batch, head), with S the (hd, hd) f32 state,
//     y_t = r_t . (S + diag(u) k_t^T v_t)
//     S   <- diag(w_t) S + k_t^T v_t
// r/k/v/w (b, s, H, hd), u (H, hd), state (b, H, hd, hd) f32 in and out,
// y in r's type.  The loop runs exactly s steps: the final state is the
// state after step s (the TPU kernel pads time with w = 1, k = 0, which
// leaves it the same; here the last chunk is s mod CH steps long and no
// step past s runs).
//
// Design.  A block owns one (head, batch) and HDP / CB of its columns
// (HDP = hd padded to 16, 32 or 64; CB blocks per head, grid (H, b,
// CB)).  The state is split into tiles of R = HDP / G rows by C columns:
// consumer thread (cg, g) keeps the tile of row group g and column group
// cg in registers for the whole sequence, its rows i = V (q G + g) + e
// (V = min(R, 4)), so that at each q the G row groups of a warp read G
// neighbouring vectors of a step's r, k and w.  Per step it computes
//     part_j = sum_{i in its rows} r_i S_ij   (+ a v_j in row group 0,
//                                              a = sum_i r_i u_i k_i)
//     S_ij   = fmaf(w_i, S_ij, k_i * v_j)
// and stores its C partials to shared memory; at the end of each chunk
// the consumers sum the G partials of every (step, column), in the order
// g = 0 .. G - 1, and write y as whole rows.  Each state entry is
// computed exactly as in a thread-per-column kernel; only the order of
// y's hd-term sum differs.  r, k, v stay in their type in shared memory
// and become f32 as a consumer loads them (a bf16 is the top half of its
// f32).  A consumer loads step t + 1's operands into registers before
// step t's products, where R and C leave room.
//
// Warp specialisation.  128 producer threads per block copy chunks of CH
// steps of r/k/v/w rows with cp.async straight into one of two buffers,
// and sum a_t of each step once the chunk has landed.  Named barriers
// hand the buffers over: FULL[b] (producers arrive, consumers wait) and
// EMPTY[b] (consumers arrive, producers wait before refilling b);
// producers alone use a fifth (every producer's copies landed), consumers
// alone a sixth (around reading the partials).  With `pipe`, chunk c + 1
// is summed and handed over while the consumers run chunk c, and chunk c
// + 2's copies start as soon as they finish it.  The cp.async order: one
// commit_group per chunk (an empty one past the end); wait_group 0 and
// the producers' barrier before a buffer is read; a buffer is refilled
// only after its EMPTY barrier.  Without `pipe` there is one buffer and
// nothing overlaps: a yardstick of chip_smoke.py's sweep, which serving
// never takes.  CH is as many steps as fit the
// shared-memory budget of a head's CB blocks (kernel.py::chunk_steps), at
// most 64.
//
// Copy sizes.  A row of r/k/v/w is hd elements at base + b sb + t ss +
// h sh.  The host picks, per tensor, the largest of 16, 8, 4 bytes that
// divides the base address, every stride in bytes and the row's bytes,
// and cp.async copies that many (16: .cg, L2 only; 8 and 4: .ca).  A
// bf16 row that is only 2-byte aligned (a view at an odd element) is
// copied with plain 2-byte loads and stores, which the thread waits for.
//
// Padding.  hd 24 runs as HDP 32, hd below 16 as 16: the producers zero
// both buffers first and the copies fill only the first hd elements of a
// row, so padded rows hold r = k = w = 0 and padded columns v = 0; their
// state entries start at 0, so they stay 0 and add 0 to every partial; y
// and the state are stored only for i, j < hd.
//
// What CB costs: every block of a head copies the whole rows of r/k/v/w
// of every step, so CB = 2 doubles (CB = 4 quadruples) that traffic,
// mostly from L2 (67 MB more per call at CB = 2 at (4, 1024, 32, 64)
// bf16), and splits the shared-memory budget, so chunks are shorter;
// what it buys is more, smaller blocks per SM.  The sweep found it never
// pays (PERF.md); the plan keeps CB = 1.
//
// What bounds it: per (b, h, t) it must read r/k/v (2 bytes each in
// bf16) and w (f32) and write y, and needs 4 hd^2 + O(hd) operations:
// with the state kept scaled by the running product of the decays, S +=
// k^T v is one FMA per entry and y = (r*D).S one more.  At the serving
// shape (4, 1024, 32, 64) that is 105 MB (31 us at 3.35 TB/s) and 2.19
// GFLOP (33 us at 67 TFLOP/s of f32 FMA, H100 SXM data sheet).  This
// design issues 3 FP32 instructions per entry and step (the multiply k
// v, the FMA of the state, the FMA of y), so its own floor is 1.5x the
// bound, about 48 us.  Beyond it: 128 (batch, head) chains fill 128 SMs
// with 4 consumer warps each at the plan (8, 4, 1) (one per scheduler, so
// every stall shows), and every thread reads its rows of r, k, w from
// shared memory every step (3 R + C values for R C entries).  Measured
// times, per (G, C, CB), are in PERF.md beside the card's name and power
// limit.
//
// Training mode (CKPT, the serving tile (8, 4) at HDP 64 only): the
// consumers also store the state S_{t-1} at the start of every
// ck_steps-step sub-chunk (t a multiple of ck_steps) into ck (b, H,
// ceil(s / ck_steps), 64, 64) f32, the checkpoints from which the
// backward's "hopper" route (csrc/wkv6_bwd.cu) recomputes each
// sub-chunk's states.  A thread stores its 8 rows x 4 columns as 8
// 16-byte stores, chunk q (columns 4q .. 4q + 3) of row i at chunk q ^
// ck_swizzle(i), the permutation the backward reads without bank
// conflicts.  The chunk is a multiple of ck_steps (kernel.py), so a
// sub-chunk never straddles two; each one's steps run as in serving
// mode, so y and the final state are the same bits.  The serving
// instantiation (CKPT false) is the code it was: Params' new fields come
// last.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;   // (H, hd), contiguous
  const float* s0;  // (b, H, hd, hd), contiguous
  void* y;
  float* sT;        // (b, H, hd, hd), contiguous
  int b, s, h, hd;
  int cb;           // column blocks per head
  int ch;           // steps per chunk
  int pipe;         // two buffers: copies and a_t sums overlap the steps
  int vec[4];       // copy size in bytes of r, k, v, w rows
  int y_vec;        // y rows take 4-column stores (hd % 4 == 0, aligned)
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  float* ck;        // training mode: (b, H, nck, 64, 64) f32, else unused
  int ck_steps;     // steps a checkpoint (training mode)
  int nck;          // ceil(s / ck_steps)
};

// The chunk of 4 columns of row `row` at which the checkpoint stores its
// chunk 0 is chunk ck_swizzle(row); chunk q at q ^ ck_swizzle(row) (the
// same function as the backward's).
__host__ __device__ constexpr int ck_swizzle(int row) {
  return (row & 7) ^ ((row >> 3) & 3);
}

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

// Waits until every copy group of this thread has landed.
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of n rows of `row_bytes` each, `ss` bytes apart from
// src, into dst (rows `pitch` bytes apart), BYTES at a time, spread over
// nt threads; (row, piece) of each copy advances without a division.
template <int BYTES>
__device__ __forceinline__ void copy_rows_n(char* dst, int pitch,
                                            const char* src, long long ss,
                                            int row_bytes, int n, int tid,
                                            int nt) {
  const int per_row = row_bytes / BYTES;
  const int dt = nt / per_row, dq = nt - dt * per_row;
  int t = tid / per_row, q = tid - t * per_row;
  for (int idx = tid; idx < n * per_row; idx += nt) {
    copy_async<BYTES>(dst + t * pitch + q * BYTES, src + t * ss + q * BYTES);
    t += dt;
    q += dq;
    if (q >= per_row) {
      q -= per_row;
      ++t;
    }
  }
}

// Not inlined: one body serves every instantiation of the kernel (inlined
// into each, it made the build take minutes).
__device__ __noinline__ void copy_rows(char* dst, int pitch,
                                       const char* src, long long ss,
                                       int row_bytes, int n, int bytes,
                                       int tid, int nt) {
  switch (bytes) {
    case 16:
      copy_rows_n<16>(dst, pitch, src, ss, row_bytes, n, tid, nt);
      break;
    case 8:
      copy_rows_n<8>(dst, pitch, src, ss, row_bytes, n, tid, nt);
      break;
    case 4:
      copy_rows_n<4>(dst, pitch, src, ss, row_bytes, n, tid, nt);
      break;
    default:
      copy_rows_n<2>(dst, pitch, src, ss, row_bytes, n, tid, nt);
  }
}

// N neighbouring elements of T in shared memory as f32 (N = 1, 2, 4 or 8;
// aligned to N elements).
template <int N>
__device__ __forceinline__ void load_n(const float* src, float out[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(src + q);
      out[q] = a.x; out[q + 1] = a.y; out[q + 2] = a.z; out[q + 3] = a.w;
    }
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *src;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* src,
                                       float out[N]) {
  // a bf16 is the top half of the f32 it converts to exactly
  if constexpr (N >= 8) {
#pragma unroll
    for (int q = 0; q < N; q += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(src + q);
      const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[q + 2 * e] = __uint_as_float(u[e] << 16);
        out[q + 2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
      }
    }
  } else if constexpr (N == 4) {
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

// 4 neighbouring values of y, as one 16- (f32) or 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* dst, const float in[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float in[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// N neighbouring floats to shared memory (N = 1, 2, 4 or 8; aligned).
template <int N>
__device__ __forceinline__ void store_n(float* dst, const float in[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(dst + q) =
          make_float4(in[q], in[q + 1], in[q + 2], in[q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(in[0], in[1]);
  } else {
    *dst = in[0];
  }
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

constexpr int kProducers = 128;   // threads of the producer warps
// named barriers: FULL[b] = 1 + b, EMPTY[b] = 3 + b, producers only 5,
// consumers only 6
constexpr int kFull = 1, kEmpty = 3, kProd = 5, kCons = 6;
constexpr int kMaxSmem = 232448;          // a block's shared memory, at most

// Shared memory of a block, in bytes from its start, for chunks of `ch`
// steps: two buffers b, each the rows of w (f32), a of each step, and the
// rows of r, k, v (T) of a chunk, as copied from device memory (ch x HDP
// each; padded rows and columns hold zeros); then the consumers' partial
// sums of y of one chunk (ch x G rows of PS floats: row g holds row group
// g's partials of the block's columns, padded by 4 floats so that the G
// rows start on different banks).  kernel.py::chunk_steps sizes chunks
// by this layout.  Pointers are formed at the point of use from the
// kernel's __shared__ base, so that every access compiles to a
// shared-memory instruction.
template <typename T, int HDP, int G>
struct Layout {
  static constexpr int PS = HDP + 4;
  int ch, rows, buf;
  __host__ __device__ explicit Layout(int ch_) : ch(ch_) {
    rows = ch * HDP * (int)sizeof(T);          // one (ch, HDP) array of T
    buf = ch * HDP * 4 + (ch + 3) / 4 * 16 + 3 * rows;
  }
  __host__ __device__ int sw(int b) const { return b * buf; }
  __host__ __device__ int sa(int b) const { return b * buf + ch * HDP * 4; }
  __host__ __device__ int srkv(int which, int b) const {   // r, k, v: 0..2
    return b * buf + ch * HDP * 4 + (ch + 3) / 4 * 16 + which * rows;
  }
  __host__ __device__ int part() const { return 2 * buf; }
  __host__ __device__ int bytes() const { return 2 * buf + ch * G * PS * 4; }
};

// Threads of a block at CB = 1, capped at the 1024 a block may have (the
// launch refuses a plan that needs more).
constexpr int max_threads(int hdp, int g, int c) {
  return (hdp / c * g + 31) / 32 * 32 + kProducers < 1024
             ? (hdp / c * g + 31) / 32 * 32 + kProducers
             : 1024;
}

// One block: nct consumer threads, which hold the state and write y (nc =
// HDP / CB / C * G of them work, the rest pad the last warp), then
// kProducers producer threads, which copy the steps and sum a_t.
// One block an SM at least: ptxas may give a thread up to 255 registers
// (at 128 it spills the (8, 4) tile's prefetched operands).
template <typename T, int HDP, int G, int C, bool CKPT>
__global__ void __launch_bounds__(max_threads(HDP, G, C), 1)
    wkv6_kernel(Params p) {
  constexpr int R = HDP / G;           // state rows per thread
  constexpr int V = R < 4 ? R : 4;     // rows per shared-memory load
  constexpr int NQ = R / V;
  constexpr int NA = C >= 4 ? 1 : (V < 4 / C ? V : 4 / C);  // sums a column
  constexpr int LPS = HDP / 8;         // a_t: lanes per step
  constexpr int ES = sizeof(T);
  // a consumer holds its next step's operands in registers while it
  // computes this one, where they are few enough
  constexpr bool PREFETCH = 3 * R + C <= 48;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CH = p.ch;                 // steps per chunk
  const Layout<T, HDP, G> L(CH);

  const int cols = HDP / p.cb;                 // columns of the block
  const int ncg = cols / C;                    // column groups of the block
  const int nc = ncg * G;                      // working consumer threads
  const int nct = (nc + 31) / 32 * 32;
  const int n_all = nct + kProducers;          // every thread of the block
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int j0 = blockIdx.z * cols;            // first column of block
  const int hd = p.hd;
  const int nbuf = p.pipe ? 2 : 1;
  const int nchunks = (p.s + CH - 1) / CH;

  if (tid >= nct) {
    // ------------------------------------------------------- producers
    const int ptid = tid - nct;
    const int lane = ptid % 32, pwarp = ptid / 32;
    const char* r = static_cast<const char*>(p.r) +
                    (bi * p.r_sb + h * p.r_sh) * ES;
    const char* k = static_cast<const char*>(p.k) +
                    (bi * p.k_sb + h * p.k_sh) * ES;
    const char* v = static_cast<const char*>(p.v) +
                    (bi * p.v_sb + h * p.v_sh) * ES;
    const char* w = reinterpret_cast<const char*>(p.w) +
                    (bi * p.w_sb + h * p.w_sh) * 4;
    if (hd < HDP) {
      // the copies fill the first hd elements of a row; the rest stay 0
      float4* zero = reinterpret_cast<float4*>(smem);
      for (int i = ptid; i < 2 * L.buf / 16; i += kProducers)
        zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      bar_sync(kProd, kProducers);
    }
    // the copies of chunk c into buffer c % nbuf, as one group (an empty
    // one past the last chunk)
    auto issue = [&](int c) {
      const int t0 = c * CH, n = max(0, min(CH, p.s - t0));
      const int b = c % nbuf;
      copy_rows(reinterpret_cast<char*>(smem + L.srkv(0, b)), HDP * ES,
                r + t0 * p.r_ss * ES, p.r_ss * ES, hd * ES, n, p.vec[0],
                ptid, kProducers);
      copy_rows(reinterpret_cast<char*>(smem + L.srkv(1, b)), HDP * ES,
                k + t0 * p.k_ss * ES, p.k_ss * ES, hd * ES, n, p.vec[1],
                ptid, kProducers);
      copy_rows(reinterpret_cast<char*>(smem + L.srkv(2, b)), HDP * ES,
                v + t0 * p.v_ss * ES, p.v_ss * ES, hd * ES, n, p.vec[2],
                ptid, kProducers);
      copy_rows(reinterpret_cast<char*>(smem + L.sw(b)), HDP * 4,
                w + t0 * p.w_ss * 4, p.w_ss * 4, hd * 4, n, p.vec[3], ptid,
                kProducers);
      copy_commit();
    };
    // lane (step, i8) sums r u k over elements [i8, i8 + 8) of a step
    const int i8 = 8 * (lane % LPS);
    float uu[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      uu[e] = i8 + e < hd ? p.u[h * hd + i8 + e] : 0.f;
    // waits for chunk c's copies, sums its a_t, hands buffer c % nbuf over
    auto fill = [&](int c) {
      const int b = c % nbuf;
      const int n = min(CH, p.s - c * CH);
      copy_wait_all();
      bar_sync(kProd, kProducers);   // every producer's copies landed
      const T* sr = reinterpret_cast<const T*>(smem + L.srkv(0, b));
      const T* sk = reinterpret_cast<const T*>(smem + L.srkv(1, b));
      float* sa = reinterpret_cast<float*>(smem + L.sa(b));
      constexpr int SPW = 32 / LPS;  // steps per warp and pass
      for (int tb = pwarp * SPW; tb < n; tb += kProducers / 32 * SPW) {
        const int t = tb + lane / LPS;
        float part = 0.f;
        if (t < n) {
          float rr[8], kk[8];
          load_n<8>(sr + t * HDP + i8, rr);
          load_n<8>(sk + t * HDP + i8, kk);
#pragma unroll
          for (int e = 0; e < 8; ++e) part += rr[e] * uu[e] * kk[e];
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (t < n && i8 == 0) sa[t] = part;
      }
      bar_arrive(kFull + b, n_all);  // buffer b holds chunk c
    };

    if (p.pipe) {
      // chunk c + 1 is filled while the consumers run chunk c, and its
      // buffer is refilled with chunk c + 2 as soon as they are done
      issue(0);
      issue(1);
      fill(0);
      for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) fill(c + 1);
        bar_sync(kEmpty + c % 2, n_all);   // the consumers are done with c
        issue(c + 2);
      }
    } else {
      for (int c = 0; c < nchunks; ++c) {
        issue(c);
        fill(c);
        bar_sync(kEmpty, n_all);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const bool active = tid < nc;
  const int g = tid % G;
  const int cg = tid / G;                      // column group, in block
  const int jb = j0 + cg * C;                  // first column, in head
  const long long sbase = ((long long)bi * p.h + h) * hd * hd;
  const int log_nq = __ffs(cols / 4) - 1;      // float4s of a block's row
  T* y = static_cast<T*>(p.y) + bi * p.y_sb + h * p.y_sh;

  float S[R * C];  // S[(q V + e) C + m]: row V (q G + g) + e, column jb + m
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = V * (q * G + g) + e;
#pragma unroll
      for (int m = 0; m < C; ++m)
        S[(q * V + e) * C + m] =
            (active && i < hd && jb + m < hd)
                ? p.s0[sbase + (long long)i * hd + jb + m] : 0.f;
    }

  // A step's operands: r, k, w of this thread's rows, v of its columns,
  // and a (row group 0 only: it carries the rank-1 u term a v_j).
  struct Ops {
    float r[R], k[R], w[R], v[C], a;
  };
  for (int c = 0; c < nchunks; ++c) {
    const int b = c % nbuf;
    const int n = min(CH, p.s - c * CH);
    bar_sync(kFull + b, n_all);
    if (active) {
      const T* sr = reinterpret_cast<const T*>(smem + L.srkv(0, b));
      const T* sk = reinterpret_cast<const T*>(smem + L.srkv(1, b));
      const T* sv = reinterpret_cast<const T*>(smem + L.srkv(2, b));
      const float* sw = reinterpret_cast<const float*>(smem + L.sw(b));
      const float* sa = reinterpret_cast<const float*>(smem + L.sa(b));
      float* part = reinterpret_cast<float*>(smem + L.part()) + g * L.PS +
                    cg * C;
      auto load = [&](int t, Ops& o) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int i = t * HDP + V * (q * G + g);
          load_n<V>(sr + i, o.r + q * V);
          load_n<V>(sk + i, o.k + q * V);
          load_n<V>(sw + i, o.w + q * V);
        }
        load_n<C>(sv + t * HDP + jb, o.v);
        o.a = g == 0 ? sa[t] : 0.f;
      };
      // step t's partial sums of y over this thread's rows, to shared
      // memory, and its state update
      auto step = [&](int t, const Ops& o) {
        float acc[C][NA];
#pragma unroll
        for (int m = 0; m < C; ++m) {
          acc[m][0] = o.a * o.v[m];
#pragma unroll
          for (int x = 1; x < NA; ++x) acc[m][x] = 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int m = 0; m < C; ++m) {
            float& st = S[rr * C + m];
            acc[m][rr % NA] = fmaf(o.r[rr], st, acc[m][rr % NA]);
            st = fmaf(o.w[rr], st, o.k[rr] * o.v[m]);
          }
        float sum[C];
#pragma unroll
        for (int m = 0; m < C; ++m) {
          sum[m] = acc[m][0];
#pragma unroll
          for (int x = 1; x < NA; ++x) sum[m] += acc[m][x];
        }
        store_n<C>(part + t * G * L.PS, sum);
      };
      if constexpr (CKPT) {
        static_assert(HDP == 64 && C % 4 == 0 && PREFETCH, "checkpoints");
        const long long bh = static_cast<long long>(bi) * p.h + h;
        for (int t0 = 0; t0 < n; t0 += p.ck_steps) {
          // S_{t0 - 1}: this thread's rows, chunk by chunk
          float* ck = p.ck +
                      (bh * p.nck + (c * CH + t0) / p.ck_steps) * HDP * HDP;
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const int i = V * (q * G + g) + e;
#pragma unroll
              for (int m = 0; m < C; m += 4)
                store_n<4>(ck + i * HDP +
                               4 * (((jb + m) >> 2) ^ ck_swizzle(i)),
                           &S[(q * V + e) * C + m]);
            }
          const int n1 = min(n, t0 + p.ck_steps);
          Ops o0, o1;
          load(t0, o0);
          int t = t0;
          for (; t + 1 < n1; t += 2) {
            load(t + 1, o1);
            step(t, o0);
            load(min(t + 2, n1 - 1), o0);
            step(t + 1, o1);
          }
          if (t < n1) step(t, o0);
        }
      } else {
        if constexpr (PREFETCH) {
          // two sets of operands in turn: step t + 1's load is issued
          // before step t's products
          Ops o0, o1;
          load(0, o0);
          int t = 0;
          for (; t + 1 < n; t += 2) {
            load(t + 1, o1);
            step(t, o0);
            load(min(t + 2, n - 1), o0);
            step(t + 1, o1);
          }
          if (t < n) step(t, o0);
        } else {
          for (int t = 0; t < n; ++t) {
            Ops cur;
            load(t, cur);
            step(t, cur);
          }
        }
      }
    }
    bar_arrive(kEmpty + b, n_all);   // buffer b is read
    // y of the chunk: for each step and 4 neighbouring columns, the sum of
    // the G row groups' partials (in the order g = 0 .. G - 1);
    // neighbouring threads read neighbouring float4s.  The barriers keep
    // the partials whole while they are read.
    bar_sync(kCons, nct);
    const float* parts = reinterpret_cast<const float*>(smem + L.part());
    for (int idx = tid; idx < n << log_nq; idx += nct) {
      const int t = idx >> log_nq;
      const int j = 4 * (idx & ((cols >> 2) - 1));   // column, in block
      const float* src = parts + t * G * L.PS + j;
      float sum[4];
      load_n<4>(src, sum);
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        float x[4];
        load_n<4>(src + gg * L.PS, x);
#pragma unroll
        for (int m = 0; m < 4; ++m) sum[m] += x[m];
      }
      T* dst = y + (long long)(c * CH + t) * p.y_ss + j0 + j;
      if (p.y_vec) {                 // 4 columns, aligned: one store
        if (j0 + j < hd) store4(dst, sum);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (j0 + j + m < hd) dst[m] = from_f32<T>(sum[m]);
      }
    }
    bar_sync(kCons, nct);
  }

  if (!active) return;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = V * (q * G + g) + e;
#pragma unroll
      for (int m = 0; m < C; ++m)
        if (i < hd && jb + m < hd)
          p.sT[sbase + (long long)i * hd + jb + m] = S[(q * V + e) * C + m];
    }
}

template <typename T, int HDP, int G, int C, bool CKPT>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int cols = HDP / p.cb;
  const int threads = (cols / C * G + 31) / 32 * 32 + kProducers;
  const int smem = Layout<T, HDP, G>(p.ch).bytes();
  if (cols % C != 0 || p.ch < 1 || threads > 1024 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (CKPT && (p.ck_steps < 1 || p.ch % p.ck_steps != 0 ||
               p.nck != (p.s + p.ck_steps - 1) / p.ck_steps))
    return cudaErrorInvalidValue;
  auto kernel = wkv6_kernel<T, HDP, G, C, CKPT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.h, p.b, p.cb);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The (G, C) instantiated: G threads per column, C columns per thread.
// The serving library holds kernel.py::PLAN's tile alone; the sweep
// library (built with -DWKV6_SWEEP, only when chip_smoke.py times the
// candidates) every tile of at most 64 state entries a thread at hd 64
// (HDP / G * C <= 64), kernel.py::SWEEP_TILES.
#ifdef WKV6_SWEEP
#define WKV6_PLANS(X) \
  X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(16, 1) X(2, 2) X(4, 2) X(4, 4) \
  X(8, 2) X(8, 4) X(8, 8) X(16, 2) X(16, 4) X(16, 8)
#else
#define WKV6_PLANS(X) X(8, 4)
#endif

template <typename T, int HDP>
cudaError_t launch_for_plan(const Params& p, int groups, int cols,
                            cudaStream_t stream) {
  if (p.ck != nullptr) {   // training mode: the serving tile at HDP 64
    if constexpr (HDP == 64)
      if (groups == 8 && cols == 4)
        return launch<T, 64, 8, 4, true>(p, stream);
    return cudaErrorInvalidValue;
  }
#define WKV6_CASE(G, C) \
  if (groups == G && cols == C) \
    return launch<T, HDP, G, C, false>(p, stream);
  WKV6_PLANS(WKV6_CASE)
#undef WKV6_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_for_head_dim(const Params& p, int groups, int cols,
                                cudaStream_t stream) {
  const int hdp = p.hd <= 16 ? 16 : p.hd <= 32 ? 32 : 64;
  if (p.hd > 64 || p.cb < 1 || hdp % p.cb != 0) return cudaErrorInvalidValue;
  if (hdp == 16) return launch_for_plan<T, 16>(p, groups, cols, stream);
  if (hdp == 32) return launch_for_plan<T, 32>(p, groups, cols, stream);
  return launch_for_plan<T, 64>(p, groups, cols, stream);
}

// The largest cp.async size (16, 8 or 4 bytes; 2: plain copies) that
// divides the address of every row: the base, the strides in bytes and
// the row's length in bytes.
int copy_bytes(const void* base, const long long* strides, int esize,
               int hd) {
  unsigned long long bits = reinterpret_cast<uintptr_t>(base) |
                            static_cast<unsigned long long>(hd * esize);
  for (int i = 0; i < 3; ++i)
    bits |= static_cast<unsigned long long>(strides[i] * esize);
  for (int bytes = 16; bytes >= 4; bytes /= 2)
    if (bits % bytes == 0) return bytes;
  return 2;
}

}  // namespace

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16; w, u and both
// states are float32.  strides: 15 element strides, the (batch, seq,
// head) strides of r, k, v, w and y in that order; the head-dim stride of
// each must be 1.  u (H, hd) and the states (b, H, hd, hd) are
// contiguous.  The plan: groups (G, threads per state column) and
// cols_per_thread (C) one of WKV6_PLANS, col_blocks (CB, blocks per head)
// in {1, 2, 4}, C dividing hd padded to 16, 32 or 64 over CB;
// chunk_steps (CH) whose layout fits a block's shared memory; pipe: 1
// overlaps copies, conversion and steps.  ck: null (serving), or
// (training mode: hd 64, plan (8, 4, CB), pipe 1, CH a multiple of
// ck_steps) f32 (b, H, ceil(s / ck_steps), 64, 64), where the states at
// the start of every ck_steps steps are stored.  Returns a cudaError_t (0
// = launched).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* sT, int dtype, int b, int s, int h,
                        int hd, const long long* strides, int groups,
                        int cols_per_thread, int col_blocks,
                        int chunk_steps, int pipe, void* ck, int ck_steps,
                        void* stream) {
  if (ck != nullptr && (hd != 64 || !pipe || ck_steps < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.sT = static_cast<float*>(sT);
  p.b = b;
  p.s = s;
  p.h = h;
  p.hd = hd;
  p.cb = col_blocks;
  p.ch = chunk_steps;
  p.pipe = pipe;
  p.r_sb = strides[0];
  p.r_ss = strides[1];
  p.r_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.w_sb = strides[9];
  p.w_ss = strides[10];
  p.w_sh = strides[11];
  p.y_sb = strides[12];
  p.y_ss = strides[13];
  p.y_sh = strides[14];
  p.ck = static_cast<float*>(ck);
  p.ck_steps = ck_steps;
  p.nck = ck != nullptr ? (s + ck_steps - 1) / ck_steps : 0;
  const int esize = dtype == 0 ? 4 : 2;
  p.vec[0] = copy_bytes(r, strides, esize, hd);
  p.vec[1] = copy_bytes(k, strides + 3, esize, hd);
  p.vec[2] = copy_bytes(v, strides + 6, esize, hd);
  p.vec[3] = copy_bytes(w, strides + 9, 4, hd);
  p.y_vec = hd % 4 == 0 && copy_bytes(y, strides + 12, esize, hd) >= 4 * esize;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_for_head_dim<float>(p, groups, cols_per_thread, st);
  else if (dtype == 1)
    err = launch_for_head_dim<__nv_bfloat16>(p, groups, cols_per_thread,
                                             st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
