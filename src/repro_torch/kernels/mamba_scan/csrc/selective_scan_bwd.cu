// Mamba selective scan (S6) backward for Hopper (sm_90a).
//
// The TPU side has no backward kernel: the reference trains through
// jax.vjp of `selective_scan_chunked` (src/repro/kernels/mamba_scan/
// ops.py), the jnp twin of `selective_scan_pallas` (kernel.py), which
// this is the gradient of.  Its plain version is ref.py::
// selective_scan_bwd_ref.  For each (batch, channel c), with e_t =
// exp(dt_t A_c) and g_t = dL/dh_t:
//     g_t   = e_{t+1} g_{t+1} + dy_t C_t         (g after step s: dh_T)
//     dx_t  = dt_t (g_t . B_t) + D_c dy_t
//     ddt_t = sum_n g_t A_c e_t h_{t-1} + x_t (g_t . B_t)
//     dA_c  = sum_{b,t} dt_t g_t e_t h_{t-1},   dD_c = sum_{b,t} dy_t x_t
//     dB_t  = sum_c g_t dt_t x_t,               dC_t = sum_c dy_t h_t
//     dh_0  = e_1 g_1
// x, B, C, dy in one type T (f32 or bf16), dt, A, D, the states f32; dx,
// dB, dC come out in T, ddt, dA, dD, dh_0 in f32.
//
// What bounds it: per (batch, step, channel) it must read x, dt and dy
// and write dx and ddt (14 bytes in bf16: 1.9 GB at the training shape
// (4, 2048, 16384, N = 16), 0.56 ms at 3.35 TB/s); per state entry and
// step one exponential (2.15e9, 0.51 ms on the SFUs at 16 a clock per
// SM) and about 10 f32 operations.  This design is held by the dispatch
// slots (the instructions a lane issues per entry and step: chip_smoke.py's
// phase sass counts them; a MUFU.EX2 holds its scheduler about 4 clocks),
// the shared-memory pipe its shuffles and B, C loads share, and the
// staging and write-out between its two barriers a sub-chunk
// (experiments/scan_bwd_knockouts_torch.py; PERF.md).
//
// Design (scan_bwd_pipe_kernel, then scan_bwd_sum_kernel; `which` picks
// them, for timing):
// * Checkpoints from the forward.  The forward kernel in training mode
//   (selective_scan.cu, scan_pipe_kernel<.., true>) stores the state
//   before every K-th step into ck (b, ceil(s / K), di, NP) f32, with the
//   instructions it scans with, so the states recomputed here from them
//   are the forward's own, bit for bit.
// * One reverse pass.  Four lanes hold a channel, NQ = NP/4 state entries
//   each; a block is 64 channels of one batch, 2 blocks an SM (128
//   registers a thread).  For each K-step sub-chunk, last first, a lane
//   recomputes its K + 1 states into registers from the checkpoint with
//   the forward's exponential and update, then walks them back with g,
//   forming each decay e_t again with the same instruction (two
//   exponentials an entry and step).  Keeping the decays of the recompute
//   in shared memory instead (64 KB a block, one exponential) was timed
//   and is slower: the SFUs have room, the shared-memory pipe the
//   shuffles and loads share does not (PERF.md, PR 25).  The channel's
//   two sums over its entries (g . B for dx, and ddt's decay term plus x
//   (g . B)) take one select-and-shuffle step and one shuffle.
// * dB and dC without selects.  A lane holds its quarter's entries in an
//   order of its own: register i holds entry q NQ + (i ^ p), p the low
//   bits of the lane's channel within the warp.  So in the reduce-scatter
//   over a warp's 8 channels each lane keeps the same registers and sends
//   the same others: dB and dC each take log2(NQ) halving steps of
//   shuffle and add, then full sums, no select (4 shuffles each at N = 16
//   against PR 24's 7 shuffles, 7 adds and 14 selects for both).  B_t and
//   C_t are staged once in each of the NQ lane orders, each order's tile
//   padded by 16 floats so that the two orders a quarter-warp reads fall
//   in other banks.  A warp writes its sums of each step (dB, dC, dx,
//   ddt) to shared memory, every lane (no branch); the block sums its 8
//   warps in a fixed order and writes dB and dC as per-block partials (b,
//   s, di / 64, 2 NP) f32.  dA and dD stay in registers over t and are
//   written per batch.
// * Staging that overlaps the walk back.  While a sub-chunk is recomputed
//   and walked back, cp.async copies the next (earlier) sub-chunk's x, dt,
//   dy, B and C rows (16, 8 or 4 bytes a copy, as the forward) and each
//   lane's quarter of its checkpoint into shared memory.  After the walk
//   back and one barrier the block writes the sub-chunk's dx, ddt and
//   dB/dC partials and converts the next sub-chunk into packed (dt, dt x,
//   dy, x) f32 rows and B, C in the lane orders; a second barrier.
// * scan_bwd_sum_kernel: each (b, t, n) of dB and dC, the block partials
//   summed in order.
// No atomics: two calls give the same bits.  A step past s is staged as
// dt = x = dy = 0 and B = C = 0, which leaves the state and g as they
// were, so each sub-chunk runs K steps; N <= 16 is padded to NP = 4, 8 or
// 16 entries with A = B = C = 0 and zero states.
//
// The library the training path loads holds this design alone.  Built
// with -DSCAN_BWD_SWEEP, the sweep library adds the backward's first
// design, the yardstick: scan_bwd_ckpt_kernel (the forward scan again,
// storing the checkpoints), scan_bwd_kernel (a sub-chunk's states
// recomputed into registers, each decay formed again in the walk back, a
// reduce-scatter with selects, staging between two barriers).
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4;               // lanes a channel
constexpr int CH = 64;                 // channels a block
constexpr int THREADS = CH * LANES;    // 256
constexpr int WARPS = THREADS / 32;    // 8
constexpr int K = 16;                  // steps a checkpoint and a sub-chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;
  const float* dt;
  const float* A;    // (di, n), contiguous
  const void* B;
  const void* C;
  const float* D;    // (di,)
  const float* h0;   // (b, di, n), contiguous
  const void* dy;
  const float* dhT;  // (b, di, n), contiguous, or null (zeros)
  float* ck;         // (b, nck, di, NP): the forward's checkpoints
  float* dbc;        // (b, s, nblk, 2 NP) scratch: dB, dC block partials
  void* dx;          // (b, s, di), contiguous
  float* ddt;        // (b, s, di), contiguous
  void* dB;          // (b, s, n), contiguous
  void* dC;          // (b, s, n), contiguous
  float* dA;         // (b, di, n): per-batch partials
  float* dD;         // (b, di): per-batch partials
  float* dh0;        // (b, di, n)
  int b, s, di, n, nck, nblk;
  int wx, wdt, wdy, wb, wc;  // copy widths of x, dt, dy, B, C in bytes
  long long x_sb, x_ss, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss, dy_sb, dy_ss;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// 2^x on the SFU: one MUFU.EX2, denormal results flushed to 0 (the
// forward kernel's exponential)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NQ floats of f32 memory, as one vector access where NQ allows
template <int NQ>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[NQ]) {
  if constexpr (NQ == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (NQ == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = *src;
  }
}

template <int NQ>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[NQ]) {
  if constexpr (NQ == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (NQ == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    *dst = v[0];
}

// ------------------------------------------------ 1. the reverse pass

// One copy unit of W bytes from global to shared memory, `valid` of them
// read and the rest zero-filled: cp.async (16: .cg, L2 only; 8 and 4:
// .ca); W = 2 (a bf16 tensor with an odd element offset or stride) is a
// plain load and store, since cp.async copies no fewer than 4 bytes.
__device__ __forceinline__ void copy_unit(void* dst, const void* src, int w,
                                          int valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  switch (w) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(valid));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(valid));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(valid));
      break;
    default:
      *static_cast<uint16_t*>(dst) =
          valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies K rows of ROW elements of a (b, s, m) tensor (row stride ss) into
// a (K, ROW) tile in units of w bytes (a power of two, 2..16, cut to a
// row) with the block's threads; rows at or past `rows` and elements at or
// past `cols` are zero-filled.
template <typename E, int ROW>
__device__ __forceinline__ void copy_rows(void* dst, const E* src,
                                          long long ss, int rows, int cols,
                                          int w) {
  constexpr int S = sizeof(E);
  w = min(w, ROW * S);
  const int lw = __ffs(w) - 1;                       // w = 2^lw
  const int lu = __ffs(ROW * S) - 1 - lw;            // 2^lu units a row
  for (int u = threadIdx.x; u < K << lu; u += THREADS) {
    const int r = u >> lu;
    const int e0 = (u & ((1 << lu) - 1)) * (w / S);  // first element
    const int valid = r < rows ? min(w, max(0, (cols - e0) * S)) : 0;
    copy_unit(static_cast<unsigned char*>(dst) + (r * ROW + e0) * S,
              valid ? src + r * ss + e0 : src, w, valid);
  }
}

// The reverse pass's dynamic shared memory, in bytes from its start: each
// warp's sums of each step of the sub-chunk (dB and dC at their slots, dx
// and ddt of its 8 channels); the packed rows (dt, dt x, dy, x); B_t and
// C_t in each of the NQ lane orders, each order's (K, NP) tile padded by
// 16 floats so that the orders a warp reads fall in other banks; the next
// sub-chunk's raw x, dt, dy, B and C rows and checkpoint quarters, which
// cp.async fills while this one is walked back.
template <typename T, int NP>
struct PipeLayout {
  static constexpr int NQ = NP / LANES;
  static constexpr int SUMW = 2 * NP + 16;    // floats of a warp's sums
  static constexpr int ORDER = K * NP + 16;   // floats of one lane order
  static constexpr int S = 0;
  static constexpr int P = S + K * WARPS * SUMW * 4;
  static constexpr int BC = P + K * CH * 16;
  static constexpr int RX = BC + 2 * NQ * ORDER * 4;
  static constexpr int RDT = RX + K * CH * sizeof(T);
  static constexpr int RDY = RDT + K * CH * 4;
  static constexpr int RB = RDY + K * CH * sizeof(T);
  static constexpr int RC = RB + K * NP * sizeof(T);
  static constexpr int RCK = RC + K * NP * sizeof(T);
  static constexpr int BYTES = RCK + THREADS * NQ * 4;
};

// Sums NQ values over the 8 lanes of a warp that share lane % 4 (lane
// bits 2..4, the channel w within the warp) and scatters the sums: while
// more than one value is left, each lane adds its partner's upper half to
// its own lower half; past that, the last value is summed in full.  With
// register i holding entry i ^ (w & (NQ - 1)) of the lane's quarter,
// every lane keeps and sends the same registers, and ends with the sum of
// entry w & (NQ - 1).
template <int NQ>
__device__ __forceinline__ float sum_scatter(float (&v)[NQ]) {
#pragma unroll
  for (int half = NQ / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int j = 0; j < half; ++j)
      v[j] += __shfl_xor_sync(FULL, v[j + half], 4 * half);
  }
#pragma unroll
  for (int mask = 4 * NQ; mask <= 16; mask *= 2)
    v[0] += __shfl_xor_sync(FULL, v[0], mask);
  return v[0];
}

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 2)
    scan_bwd_pipe_kernel(Params p) {
  constexpr int NQ = NP / LANES;
  constexpr int LOGQ = NQ == 4 ? 2 : NQ == 2 ? 1 : 0;
  using L = PipeLayout<T, NP>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sums = reinterpret_cast<float*>(smem + L::S);  // [K][WARPS][SUMW]
  float4* pk = reinterpret_cast<float4*>(smem + L::P);    // [K][CH]
  float* sB = reinterpret_cast<float*>(smem + L::BC);  // [NQ][ORDER]
  float* sC = sB + NQ * L::ORDER;
  const T* rx = reinterpret_cast<const T*>(smem + L::RX);  // [K][CH]
  const float* rdt = reinterpret_cast<const float*>(smem + L::RDT);
  const T* rdy = reinterpret_cast<const T*>(smem + L::RDY);
  const T* rawb = reinterpret_cast<const T*>(smem + L::RB);  // [K][NP]
  const T* rawc = reinterpret_cast<const T*>(smem + L::RC);
  float* rck = reinterpret_cast<float*>(smem + L::RCK);   // [THREADS][NQ]

  const int tid = threadIdx.x, ch = tid / LANES, q = tid % LANES;
  const int lane = tid % 32, warp = tid / 32, w = lane / LANES;
  const int perm = w & (NQ - 1);     // register i holds entry q NQ + (i ^ perm)
  const int c0 = blockIdx.x * CH, c = c0 + ch, bi = blockIdx.y;
  const bool live = c < p.di;
  const int cols = min(CH, p.di - c0);
  const long long sbase = ((long long)bi * p.di + c) * p.n;

  float a2[NQ], Af[NQ], G[NQ], dA[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int e = q * NQ + (i ^ perm);
    const bool on = live && e < p.n;
    Af[i] = on ? p.A[(long long)c * p.n + e] : 0.f;
    a2[i] = Af[i] * LOG2E;
    G[i] = on && p.dhT != nullptr ? p.dhT[sbase + e] : 0.f;
    dA[i] = 0.f;
  }
  const float Dc = live ? p.D[c] : 0.f;
  float dD = 0.f;
  // the lane's dB/dC sums are of entry q NQ + perm; the lanes whose other
  // channel bits are 0 store dB's, those with only the top one set dC's
  const int hi = w >> LOGQ;
  const int own = q * NQ + perm;
  const int slot = hi == 0 ? own : hi == (4 >> LOGQ) ? NP + own : -1;

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + c0;
  const float* dt = p.dt + bi * p.dt_sb + c0;
  const T* dy = static_cast<const T*>(p.dy) + bi * p.dy_sb + c0;
  const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb;
  const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb;
  const float* ck = p.ck + ((long long)bi * p.nck * p.di + c) * NP + q * NQ;

  // copies of sub-chunk k: cp.async of x, dt, dy, B, C and the lane's
  // checkpoint quarter
  auto issue = [&](int k) {
    const int t0 = k * K, rows = min(K, p.s - t0);
    copy_rows<T, CH>(smem + L::RX, x + t0 * p.x_ss, p.x_ss, rows, cols,
                     p.wx);
    copy_rows<float, CH>(smem + L::RDT, dt + t0 * p.dt_ss, p.dt_ss, rows,
                         cols, p.wdt);
    copy_rows<T, CH>(smem + L::RDY, dy + t0 * p.dy_ss, p.dy_ss, rows, cols,
                     p.wdy);
    copy_rows<T, NP>(smem + L::RB, Bp + t0 * p.B_ss, p.B_ss, rows, p.n,
                     p.wb);
    copy_rows<T, NP>(smem + L::RC, Cp + t0 * p.C_ss, p.C_ss, rows, p.n,
                     p.wc);
    copy_unit(rck + tid * NQ, live ? ck + (long long)k * p.di * NP : p.ck,
              NQ * 4, live ? NQ * 4 : 0);
    copy_commit();
  };
  // sub-chunk k's copies, once landed, into the packed rows, B and C in
  // the lane orders, and the lane's checkpoint into hck
  float hck[NQ];
  auto convert = [&]() {
#pragma unroll
    for (int m = 0; m < K * CH / THREADS; ++m) {
      const int u = tid + m * THREADS;
      const float xv = to_f32(rx[u]), dtv = rdt[u];
      pk[u] = make_float4(dtv, dtv * xv, to_f32(rdy[u]), xv);
    }
    static_assert(K * NP <= THREADS, "one value of B and C a thread");
    if (tid < K * NP) {
      const int tt = tid / NP, j = tid % NP, base = j - j % NQ, i0 = j % NQ;
      const float bv = to_f32(rawb[tid]), cv = to_f32(rawc[tid]);
#pragma unroll
      for (int pp = 0; pp < NQ; ++pp) {
        const int at = pp * L::ORDER + tt * NP + base + (i0 ^ pp);
        sB[at] = bv;
        sC[at] = cv;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) hck[i] = rck[tid * NQ + (i ^ perm)];
  };

  issue(p.nck - 1);
  copy_wait_all();
  __syncthreads();
  convert();
  __syncthreads();

  T* dxo = static_cast<T*>(p.dx);
  constexpr int BROW = NP;    // floats a step of B or C
  const float* Bl = sB + perm * L::ORDER + q * NQ;
  const float* Cl = sC + perm * L::ORDER + q * NQ;
  for (int k = p.nck - 1; k >= 0; --k) {
    const int t0 = k * K;
    if (k > 0) issue(k - 1);

    // the sub-chunk's states h_{t0-1} .. h_{t0+K-1}, recomputed from its
    // checkpoint with the forward's instructions
    float hs[K + 1][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) hs[0][i] = hck[i];
#pragma unroll
    for (int tt = 0; tt < K; ++tt) {
      const float2 v = *reinterpret_cast<const float2*>(&pk[tt * CH + ch]);
      float bq[NQ], e[NQ];
      load_vec<NQ>(Bl + tt * BROW, bq);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        e[i] = ex2_approx(v.x * a2[i]);
        hs[tt + 1][i] = fmaf(e[i], hs[tt][i], v.y * bq[i]);
      }
    }

    // walked back with g, each decay formed again with the recompute's
    // instruction (the same bits)
#pragma unroll
    for (int tt = K - 1; tt >= 0; --tt) {
      const float4 v = pk[tt * CH + ch];
      const float dtv = v.x, dtx = v.y, dyv = v.z, xv = v.w;
      float e[NQ], bq[NQ], cq[NQ], vb[NQ], vc[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) e[i] = ex2_approx(dtv * a2[i]);
      load_vec<NQ>(Bl + tt * BROW, bq);
      load_vec<NQ>(Cl + tt * BROW, cq);
      float gB = 0.f, gEH = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float g = fmaf(dyv, cq[i], G[i]);
        vb[i] = g * dtx;                  // dB
        vc[i] = dyv * hs[tt + 1][i];      // dC
        gB = fmaf(g, bq[i], gB);
        const float ge = g * e[i];        // g_{t-1}'s carried part
        const float qv = ge * hs[tt][i];
        dA[i] = fmaf(dtv, qv, dA[i]);
        gEH = fmaf(Af[i], qv, gEH);
        G[i] = ge;
      }
      // over the channel's 4 lanes: g . B to lanes 0 and 2, and ddt's
      // sum (the decay term plus x (g . B), both linear in the lanes'
      // parts) to lanes 1 and 3: one select-and-shuffle step, one sum
      const float u = gB, vd = fmaf(xv, gB, gEH);
      float r = (q & 1 ? vd : u) + __shfl_xor_sync(FULL, q & 1 ? u : vd, 1);
      r += __shfl_xor_sync(FULL, r, 2);
      dD = fmaf(dyv, xv, dD);
      const float rb = sum_scatter<NQ>(vb);
      const float rc = sum_scatter<NQ>(vc);
      // the warp's sums of the step: dB, dC at their slots, then dx and
      // ddt of its 8 channels (lanes 2 and 3 of a channel store what lanes
      // 0 and 1 do, so no lane branches)
      float* at = sums + (tt * WARPS + warp) * L::SUMW;
      if (slot >= 0) at[slot] = hi == 0 ? rb : rc;
      at[2 * NP + (q & 1) * 8 + w] = q & 1 ? r : fmaf(dtv, r, Dc * dyv);
    }
    copy_wait_all();
    __syncthreads();

    // dB/dC block partials (the warps summed in order): a thread sums
    // value j = tid % 2 NP of steps tid / 2 NP, + PER, ..
    {
      constexpr int PER = THREADS / (2 * NP);  // steps a pass
      const int j = tid % (2 * NP), r = tid / (2 * NP);
      float* dst = p.dbc + (((long long)bi * p.s + t0 + r) * p.nblk +
                            blockIdx.x) * 2 * NP + j;
#pragma unroll
      for (int m = 0; m < (K + PER - 1) / PER; ++m) {
        const int tt = r + m * PER;
        if (tt < K && t0 + tt < p.s) {
          const float* at = sums + tt * WARPS * L::SUMW + j;
          float sum = 0.f;
#pragma unroll
          for (int wp = 0; wp < WARPS; ++wp) sum += at[wp * L::SUMW];
          dst[(long long)m * PER * p.nblk * 2 * NP] = sum;
        }
      }
    }
    // dx and ddt: channel tid % CH of rows tid / CH, + 4, + 8, + 12
    {
      constexpr int ROWS = THREADS / CH;
      const int cc = tid % CH, r0 = tid / CH;
      const bool col = c0 + cc < p.di;
      const long long o = ((long long)bi * p.s + t0 + r0) * p.di + c0 + cc;
      const float* from = sums + (cc / 8) * L::SUMW + 2 * NP + cc % 8;
#pragma unroll
      for (int j = 0; j < K / ROWS; ++j) {
        const int tt = r0 + ROWS * j;
        if (col && t0 + tt < p.s) {
          const float* at = from + tt * WARPS * L::SUMW;
          dxo[o + (long long)j * ROWS * p.di] = from_f32<T>(at[0]);
          p.ddt[o + (long long)j * ROWS * p.di] = at[8];
        }
      }
    }
    if (k > 0) convert();
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int e = q * NQ + (i ^ perm);
      if (e < p.n) {
        p.dh0[sbase + e] = G[i];
        p.dA[sbase + e] = dA[i];
      }
    }
    if (q == 0) p.dD[(long long)bi * p.di + c] = dD;
  }
}

// ------------------------------------------- 2. dB and dC, summed in order

template <typename T, int NP>
__global__ void __launch_bounds__(256) scan_bwd_sum_kernel(Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.b * p.s * 2 * NP) return;
  const long long bt = i / (2 * NP);
  const int j = static_cast<int>(i % (2 * NP));
  const float* src = p.dbc + bt * p.nblk * 2 * NP + j;
  float sum = 0.f;
  for (int k = 0; k < p.nblk; ++k) sum += src[(long long)k * 2 * NP];
  if (j < NP) {
    if (j < p.n) static_cast<T*>(p.dB)[bt * p.n + j] = from_f32<T>(sum);
  } else if (j - NP < p.n) {
    static_cast<T*>(p.dC)[bt * p.n + j - NP] = from_f32<T>(sum);
  }
}

// ---------------------------------- the first design, the yardstick (PR 24)

#ifdef SCAN_BWD_SWEEP
// One sub-chunk's inputs in f32: K steps of the block's CH channels, and
// of B_t and C_t padded to NP entries; zeros past s and past di.
template <int NP>
struct Stage {
  float x[K][CH];
  float dt[K][CH];
  float dy[K][CH];
  __align__(16) float B[K][NP];
  __align__(16) float C[K][NP];
};

// Stages the sub-chunk of steps t0 .. t0 + K.  A thread copies channel
// cc = tid % CH of rows tid / CH, + 4, + 8, + 12 of x, dt (and dy), each
// row's address one stride on from the last, and with tid < K NP one
// value of B (and C); rows past s and channels past di read as 0.
template <typename T, int NP, bool BWD>
__device__ __forceinline__ void stage(Stage<NP>& st, const Params& p, int bi,
                                      int c0, int t0) {
  constexpr int ROWS = THREADS / CH;   // rows a pass
  const int cc = threadIdx.x % CH, r0 = threadIdx.x / CH;
  const bool col = c0 + cc < p.di;
  const long long t = t0 + r0;
  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + t * p.x_ss + c0 + cc;
  const float* dt = p.dt + bi * p.dt_sb + t * p.dt_ss + c0 + cc;
  const T* dy =
      static_cast<const T*>(p.dy) + bi * p.dy_sb + t * p.dy_ss + c0 + cc;
#pragma unroll
  for (int j = 0; j < K / ROWS; ++j) {
    const int tt = r0 + ROWS * j;
    const bool on = col && t0 + tt < p.s;
    float xv = 0.f, dtv = 0.f, dyv = 0.f;
    if (on) {
      xv = to_f32(x[j * ROWS * p.x_ss]);
      dtv = dt[j * ROWS * p.dt_ss];
      if (BWD) dyv = to_f32(dy[j * ROWS * p.dy_ss]);
    }
    st.x[tt][cc] = xv;
    st.dt[tt][cc] = dtv;
    if (BWD) st.dy[tt][cc] = dyv;
  }
  static_assert(K * NP <= THREADS, "one value of B and C a thread");
  if (threadIdx.x < K * NP) {
    const int tt = threadIdx.x / NP, j = threadIdx.x % NP;
    const long long tb = t0 + tt;
    const bool on = tb < p.s && j < p.n;
    float bv = 0.f, cv = 0.f;
    if (on) {
      bv = to_f32(static_cast<const T*>(p.B)[bi * p.B_sb + tb * p.B_ss + j]);
      if (BWD)
        cv = to_f32(static_cast<const T*>(p.C)[bi * p.C_sb + tb * p.C_ss + j]);
    }
    st.B[tt][j] = bv;
    if (BWD) st.C[tt][j] = cv;
  }
}

// One step of the forward recurrence on a lane's NQ entries, with the
// forward kernel's instructions: e = ex2(dt * a2), h = e h + (dt x) B.
template <int NQ>
__device__ __forceinline__ void forward_step(float (&h)[NQ],
                                             const float (&a2)[NQ],
                                             float dtv, float dx,
                                             const float* Bq) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float e = ex2_approx(dtv * a2[i]);
    h[i] = fmaf(e, h[i], dx * Bq[i]);
  }
}

// Sums each of V values over the 8 lanes of a warp that share lane % 4
// (lane bits 2..4) and scatters the sums: while more than one value is
// left, a lane keeps the half its lane bit names and adds its partner's
// copy of that half; past that, the last value is summed in full.
// Returns the lane's sum; `index` of it among the V values is
// vindex<V>(lane).
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int mask = 16 >> step;
    const int half = V >> (step + 1);
    if (half >= 1) {
      const bool up = lane & mask;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float keep = up ? v[half + j] : v[j];
        const float send = up ? v[j] : v[half + j];
        v[j] = keep + __shfl_xor_sync(FULL, send, mask);
      }
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], mask);
    }
  }
  return v[0];
}

template <int V>
__device__ __forceinline__ int vindex(int lane) {
  int idx = 0;
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int half = V >> (step + 1);
    if (half >= 1 && (lane & (16 >> step))) idx += half;
  }
  return idx;
}

// Whether a lane's reduce_scatter result is its own (false where a lane
// with the bit of a full-sum step clear holds the same sum).
template <int V>
__device__ __forceinline__ bool vwriter(int lane) {
  bool own = true;
#pragma unroll
  for (int step = 0; step < 3; ++step)
    if ((V >> (step + 1)) < 1 && (lane & (16 >> step))) own = false;
  return own;
}

// The checkpoints: the forward scan again, the state before every K-th
// step into ck.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS) scan_bwd_ckpt_kernel(Params p) {
  constexpr int NQ = NP / LANES;
  __shared__ Stage<NP> st;
  const int tid = threadIdx.x, ch = tid / LANES, q = tid % LANES;
  const int c0 = blockIdx.x * CH, c = c0 + ch, bi = blockIdx.y;
  const bool live = c < p.di;
  float a2[NQ], h[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int e = q * NQ + i;
    const bool on = live && e < p.n;
    a2[i] = on ? p.A[(long long)c * p.n + e] * LOG2E : 0.f;
    h[i] = on ? p.h0[((long long)bi * p.di + c) * p.n + e] : 0.f;
  }
  for (int k = 0; k < p.nck; ++k) {
    if (live)
      store_vec<NQ>(p.ck + (((long long)bi * p.nck + k) * p.di + c) * NP +
                        q * NQ,
                    h);
    __syncthreads();  // every thread is done with the previous sub-chunk
    stage<T, NP, false>(st, p, bi, c0, k * K);
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < K; ++tt) {
      const float dtv = st.dt[tt][ch];
      forward_step<NQ>(h, a2, dtv, dtv * st.x[tt][ch], &st.B[tt][q * NQ]);
    }
  }
}

// The reverse pass of the first design: the sub-chunk's states recomputed
// into registers from ck, each decay formed again in the walk back.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 2) scan_bwd_kernel(Params p) {
  constexpr int NQ = NP / LANES;
  constexpr int V = 2 * NQ;   // a lane's dB and dC values a step
  __shared__ Stage<NP> st;
  __shared__ float sdx[K][CH];
  __shared__ float sddt[K][CH];
  __shared__ float sred[K][WARPS][2 * NP];
  const int tid = threadIdx.x, ch = tid / LANES, q = tid % LANES;
  const int lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * CH, c = c0 + ch, bi = blockIdx.y;
  const bool live = c < p.di;
  const long long sbase = ((long long)bi * p.di + c) * p.n;

  float a2[NQ], Af[NQ], G[NQ], dA[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int e = q * NQ + i;
    const bool on = live && e < p.n;
    Af[i] = on ? p.A[(long long)c * p.n + e] : 0.f;
    a2[i] = Af[i] * LOG2E;
    G[i] = on && p.dhT != nullptr ? p.dhT[sbase + e] : 0.f;
    dA[i] = 0.f;
  }
  const float Dc = live ? p.D[c] : 0.f;
  float dD = 0.f;
  // where this lane's share of the dB/dC sums goes among a step's 2 NP
  const int vi = vindex<V>(lane);
  const int slot = vi < NQ ? q * NQ + vi : NP + q * NQ + (vi - NQ);
  const bool writer = vwriter<V>(lane);

  T* dx = static_cast<T*>(p.dx);
  for (int k = p.nck - 1; k >= 0; --k) {
    const int t0 = k * K;
    __syncthreads();  // the previous sub-chunk's shared memory is read
    stage<T, NP, true>(st, p, bi, c0, t0);
    float hck[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) hck[i] = 0.f;
    if (live)
      load_vec<NQ>(
          p.ck + (((long long)bi * p.nck + k) * p.di + c) * NP + q * NQ, hck);
    __syncthreads();

    // the sub-chunk's states, recomputed from its checkpoint
    float hs[K][NQ];
    {
      float h[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) h[i] = hck[i];
#pragma unroll
      for (int tt = 0; tt < K; ++tt) {
        const float dtv = st.dt[tt][ch];
        forward_step<NQ>(h, a2, dtv, dtv * st.x[tt][ch], &st.B[tt][q * NQ]);
#pragma unroll
        for (int i = 0; i < NQ; ++i) hs[tt][i] = h[i];
      }
    }

    // walked back with g
#pragma unroll
    for (int tt = K - 1; tt >= 0; --tt) {
      const float dtv = st.dt[tt][ch];
      const float xv = st.x[tt][ch];
      const float dyv = st.dy[tt][ch];
      const float dtx = dtv * xv;
      const float* Bq = &st.B[tt][q * NQ];
      const float* Cq = &st.C[tt][q * NQ];
      float v[V];
      float gB = 0.f, gEH = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float hp = tt > 0 ? hs[tt - 1][i] : hck[i];
        const float e = ex2_approx(dtv * a2[i]);
        const float g = fmaf(dyv, Cq[i], G[i]);
        v[i] = g * dtx;                 // dB
        v[NQ + i] = dyv * hs[tt][i];    // dC
        gB = fmaf(g, Bq[i], gB);
        const float qv = g * e * hp;
        dA[i] = fmaf(dtv, qv, dA[i]);
        gEH = fmaf(Af[i], qv, gEH);
        G[i] = e * g;
      }
      gB += __shfl_xor_sync(FULL, gB, 1);
      gB += __shfl_xor_sync(FULL, gB, 2);
      gEH += __shfl_xor_sync(FULL, gEH, 1);
      gEH += __shfl_xor_sync(FULL, gEH, 2);
      // every lane of the channel holds both sums: lane 0 stores dx,
      // lane 1 ddt
      if (q < 2)
        (q == 0 ? sdx : sddt)[tt][ch] =
            q == 0 ? fmaf(dtv, gB, Dc * dyv) : fmaf(xv, gB, gEH);
      dD = fmaf(dyv, xv, dD);
      const float r = reduce_scatter<V>(v, lane);
      if (writer) sred[tt][warp][slot] = r;
    }
    __syncthreads();

    // dB/dC block partials (the warps summed in order): a thread sums
    // value j = tid % 2 NP of steps tid / 2 NP, + PER, ..
    {
      constexpr int PER = THREADS / (2 * NP);  // steps a pass
      const int j = tid % (2 * NP), r = tid / (2 * NP);
      float* dst = p.dbc + (((long long)bi * p.s + t0 + r) * p.nblk +
                            blockIdx.x) * 2 * NP + j;
#pragma unroll
      for (int m = 0; m < (K + PER - 1) / PER; ++m) {
        const int tt = r + m * PER;
        if (tt < K && t0 + tt < p.s) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += sred[tt][w][j];
          dst[(long long)m * PER * p.nblk * 2 * NP] = sum;
        }
      }
    }
    // dx and ddt: channel tid % CH of rows tid / CH, + 4, + 8, + 12
    {
      constexpr int ROWS = THREADS / CH;
      const int cc = tid % CH, r0 = tid / CH;
      const bool col = c0 + cc < p.di;
      const long long o = ((long long)bi * p.s + t0 + r0) * p.di + c0 + cc;
#pragma unroll
      for (int j = 0; j < K / ROWS; ++j) {
        const int tt = r0 + ROWS * j;
        if (col && t0 + tt < p.s) {
          dx[o + (long long)j * ROWS * p.di] = from_f32<T>(sdx[tt][cc]);
          p.ddt[o + (long long)j * ROWS * p.di] = sddt[tt][cc];
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int e = q * NQ + i;
      if (e < p.n) {
        p.dh0[sbase + e] = G[i];
        p.dA[sbase + e] = dA[i];
      }
    }
    if (q == 0) p.dD[(long long)bi * p.di + c] = dD;
  }
}
#endif

// which: 1 the first design's checkpoints, 2 the reverse pass, 4 the dB/dC
// sum, 8 the first design's reverse pass
template <typename T, int NP>
cudaError_t launch(const Params& p, int which, cudaStream_t stream) {
  const dim3 grid(p.nblk, p.b);
#ifdef SCAN_BWD_SWEEP
  if (which & 1) {
    scan_bwd_ckpt_kernel<T, NP><<<grid, THREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (which & 8) {
    scan_bwd_kernel<T, NP><<<grid, THREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#else
  if (which & 9) return cudaErrorInvalidValue;
#endif
  if (which & 2) {
    auto kern = scan_bwd_pipe_kernel<T, NP>;
    constexpr int bytes = PipeLayout<T, NP>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, bytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (which & 4) {
    const long long total = (long long)p.b * p.s * 2 * NP;
    const int blocks = static_cast<int>((total + 255) / 256);
    scan_bwd_sum_kernel<T, NP><<<blocks, 256, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_for_state(const Params& p, int which,
                             cudaStream_t stream) {
  if (p.n <= 4) return launch<T, 4>(p, which, stream);
  if (p.n <= 8) return launch<T, 8>(p, which, stream);
  if (p.n <= 16) return launch<T, 16>(p, which, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C, dy and dx, dB, dC): 0 = float32, 1 = bfloat16; dt,
// A, D, the states and ddt, dA, dD, dh0 are float32.  strides: 10
// element strides, the (batch, seq) strides of x, dt, B, C and dy in that
// order; the last dim of each must have stride 1.  A (di, n), D (di,),
// h0 and dhT (b, di, n; dhT may be null: zeros) are contiguous.  ck (b,
// ceil(s / 16), di, NP) f32, NP the state size padded to 4, 8 or 16: the
// checkpoints the reverse pass reads (the forward's, or those the first
// design's checkpoint kernel writes).  Scratch: dbc (b, s, ceil(di / 64),
// 2 NP) f32.  Outputs, contiguous: dx, ddt (b, s, di); dB, dC (b, s, n);
// dA (b, di, n) and dD (b, di), per-batch partials; dh0 (b, di, n).
// which: the kernels to launch (2 the reverse pass, 4 the dB/dC sum: 6
// for a whole backward; in the sweep library also 1 the first design's
// checkpoints and 8 its reverse pass: 13 for its whole backward).  wx,
// wdt, wdy, wb, wc: the reverse pass's copy widths of x, dt, dy, B and C
// in bytes (16, 8, 4; 2 for bf16), each dividing its tensor's address and
// strides.
// Returns a cudaError_t (0 = every kernel asked for launched).
extern "C" int selective_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, const void* dy,
    const void* dhT, void* ck, void* dbc, void* dx, void* ddt, void* dB,
    void* dC, void* dA, void* dD, void* dh0, int dtype, int b, int s,
    int di, int n, const long long* strides, int which, int wx, int wdt,
    int wdy, int wb, int wc, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || di < 1 || n < 1 || n > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = C;
  p.D = static_cast<const float*>(D);
  p.h0 = static_cast<const float*>(h0);
  p.dy = dy;
  p.dhT = static_cast<const float*>(dhT);
  p.ck = static_cast<float*>(ck);
  p.dbc = static_cast<float*>(dbc);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dB = dB;
  p.dC = dC;
  p.dA = static_cast<float*>(dA);
  p.dD = static_cast<float*>(dD);
  p.dh0 = static_cast<float*>(dh0);
  p.b = b;
  p.s = s;
  p.di = di;
  p.n = n;
  p.nck = (s + K - 1) / K;
  p.nblk = (di + CH - 1) / CH;
  p.wx = wx;
  p.wdt = wdt;
  p.wdy = wdy;
  p.wb = wb;
  p.wc = wc;
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.dt_sb = strides[2];
  p.dt_ss = strides[3];
  p.B_sb = strides[4];
  p.B_ss = strides[5];
  p.C_sb = strides[6];
  p.C_ss = strides[7];
  p.dy_sb = strides[8];
  p.dy_ss = strides[9];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_for_state<float>(p, which, st);
  else if (dtype == 1)
    err = launch_for_state<__nv_bfloat16>(p, which, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
