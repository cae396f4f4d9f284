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
// SM) and about 10 f32 operations.
//
// Design, three kernels a call (`which` picks them, for timing):
// 1. scan_bwd_ckpt_kernel: the forward scan again, storing the state
//    before every K-th step into scratch ck (b, ceil(s / K), di, NP) f32:
//    537 MB at the training shape.  Its exponential and update are the
//    forward kernel's instructions (ex2.approx.ftz of dt * (A log2 e),
//    then one FMA), so it stores the forward's own states.
// 2. scan_bwd_kernel: one reverse pass.  Four lanes hold a channel, NP/4
//    state entries each, so a sub-chunk's K states (K x NP/4 = 64 floats
//    at N = 16) stay in registers: for each sub-chunk, last first, the
//    lane recomputes its states from the checkpoint with the forward's
//    instructions, then walks them back with g.  The channel's sums over
//    its entries (g . B and the ddt term) take two shuffles; dB and dC,
//    sums over every channel for each (b, t, n), are reduce-scattered
//    over a warp's 8 channels (7 shuffles for 8 values a lane at N = 16),
//    summed over the block's 8 warps in shared memory in a fixed order
//    and written as per-block partials (b, s, di / 64, 2 NP) f32.  dA and
//    dD stay in registers over t and are written per batch.  A block is
//    64 channels of one batch; its inputs are staged in shared memory a
//    sub-chunk at a time, and dx and ddt are written from shared memory
//    a sub-chunk at a time, 64 channels a row.
// 3. scan_bwd_sum_kernel: each (b, t, n) of dB and dC, the block partials
//    summed in order.
// No atomics: two calls give the same bits.  A step past s is staged as
// dt = x = dy = 0 and B = C = 0, which leaves the state and g as they
// were, so each sub-chunk runs K steps; N <= 16 is padded to NP = 4, 8 or
// 16 entries with A = B = C = 0 and zero states.
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
  float* ck;         // (b, nck, di, NP) scratch
  float* dbc;        // (b, s, nblk, 2 NP) scratch: dB, dC block partials
  void* dx;          // (b, s, di), contiguous
  float* ddt;        // (b, s, di), contiguous
  void* dB;          // (b, s, n), contiguous
  void* dC;          // (b, s, n), contiguous
  float* dA;         // (b, di, n): per-batch partials
  float* dD;         // (b, di): per-batch partials
  float* dh0;        // (b, di, n)
  int b, s, di, n, nck, nblk;
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

// ------------------------------------------------------ 1. checkpoints

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

// ---------------------------------------------------- 2. reverse pass

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

// ------------------------------------------- 3. dB and dC, summed in order

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

template <typename T, int NP>
cudaError_t launch(const Params& p, int which, cudaStream_t stream) {
  const dim3 grid(p.nblk, p.b);
  if (which & 1) {
    scan_bwd_ckpt_kernel<T, NP><<<grid, THREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (which & 2) {
    scan_bwd_kernel<T, NP><<<grid, THREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
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
// h0 and dhT (b, di, n; dhT may be null: zeros) are contiguous.  Scratch:
// ck (b, ceil(s / 16), di, NP) and dbc (b, s, ceil(di / 64), 2 NP) f32,
// NP the state size padded to 4, 8 or 16.  Outputs, contiguous: dx, ddt
// (b, s, di); dB, dC (b, s, n); dA (b, di, n) and dD (b, di), per-batch
// partials; dh0 (b, di, n).  which: the kernels to launch (1 checkpoints,
// 2 the reverse pass, 4 the dB/dC sum; 7 for a whole backward).  Returns a
// cudaError_t (0 = every kernel asked for launched).
extern "C" int selective_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, const void* dy,
    const void* dhT, void* ck, void* dbc, void* dx, void* ddt, void* dB,
    void* dC, void* dA, void* dD, void* dh0, int dtype, int b, int s,
    int di, int n, const long long* strides, int which, void* stream) {
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
