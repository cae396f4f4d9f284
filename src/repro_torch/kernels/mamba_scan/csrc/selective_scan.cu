// Mamba selective scan (S6) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `selective_scan_pallas` (body `_kernel`) in
// src/repro/kernels/mamba_scan/kernel.py, with the same contract: for
// each (batch, channel c), with h the N-entry f32 state of the channel,
//     h_t = exp(dt_t A_c) * h_{t-1} + (dt_t x_t) B_t
//     y_t = h_t . C_t + D_c x_t
// x (b, s, di) and B, C (b, s, N) in one type (f32 or bf16), dt (b, s,
// di) f32, A (di, N) f32, D (di,) f32, state (b, di, N) f32 in and out,
// y (b, s, di) in x's type.  The final state is the state after step s.
//
// What bounds it: per (batch, step, channel) it must read x (2 bytes in
// bf16) and dt (4) and write y (2); per state entry and step it needs one
// exponential and about 4 f32 operations.  At the serving shape (4, 1024,
// 16384, N = 16) that is 545 MB (0.163 ms at 3.35 TB/s), 6.6 GFLOP
// (0.099 ms at 67 TFLOP/s) and 1.07e9 exponentials, which the SFUs
// compute at 16 a clock per SM (CUDA C++ programming guide, compute
// capability 9.0; chip_smoke.py measures 15.99): 0.257 ms at 132 SMs and
// 1.98 GHz.  The exponentials bound it.  But a MUFU.EX2 also holds its
// warp scheduler about 4 clocks (chip_smoke.py's probe), so with the 4
// FMA-pipe instructions an entry needs, the dispatch slots take about as
// long as the SFUs: this design's floor is ~0.266 ms.
//
// Design (scan_pipe_kernel).  Channels are independent and share only
// B_t and C_t.  One thread per (batch, channel) keeps the channel's N
// state entries and its row of A (pre-scaled by log2 e) in registers for
// the whole sequence; a block is 128 channels of one batch, and at the
// serving shape its 512 blocks (56 KB of shared memory each) are all
// resident at once, 4 an SM.  Per entry and step the thread dispatches 4
// FMA-pipe instructions (dt*A, dx*B, the state's FMA, y's FMA) and one
// `ex2.approx.ftz.f32`: one MUFU.EX2 with no range fix-up (the argument
// is <= 0 for every Mamba layer; results below 2^-126 flush to 0).
// Time is staged in chunks of CHUNK steps.  While chunk k is scanned,
// the block's threads copy chunk k + 1 of x and dt into the other of two
// shared-memory buffers with cp.async (16-byte copies where the pointers
// and strides allow, rows past s zero-filled); after the scan they load
// its B_t and C_t, converted to f32, and store them beside it (loaded
// after the scan, their registers are free during it); one barrier per
// chunk.  A zero-filled step (dt = 0, x = 0, B = 0) leaves the state
// exactly as it was, so every chunk runs CHUNK steps; a chunk that is
// whole and whose 128 channels are all live stores y at every step
// without a predicate.  N <= 16 is padded to 4, 8 or 16 entries with
// A = B = C = 0 and a zero state; a ragged last block of channels is
// masked.
//
// Training mode (TRAIN, a template argument): the same kernel also
// stores the state before every CK-th step into ck (b, ceil(s / CK), di,
// NP) f32, the checkpoints from which the backward (selective_scan_bwd.cu)
// recomputes the states: with the instructions it scans with, so they are
// the forward's own states, bit for bit.  A thread stores its channel's NP
// entries as float4s, neighbouring threads neighbouring channels: 537 MB
// at the training shape (4, 2048, 16384, N = 16), 0.16 ms at 3.35 TB/s.
// The serving instantiation (TRAIN false) compiles to the code it had
// before the training mode; its ck parameter is unused and comes after the
// others.
//
// The serving library holds this kernel alone.  Built with -DSCAN_SWEEP,
// the sweep library adds the kernel's first design (scan_kernel: exp2f,
// one buffer, two barriers a chunk) as the yardstick, the same with
// ex2.approx, and a probe of the SFUs' ex2 rate, for chip_smoke.py and
// the card tests.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHANNELS = 128;  // channels per block
constexpr int CHUNK = 32;      // steps a chunk
constexpr int UNROLL = 4;      // of the step loop
constexpr int CK = 16;         // steps a checkpoint (training mode)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;
  const float* dt;
  const float* A;   // (di, n), contiguous
  const void* B;
  const void* C;
  const float* D;   // (di,)
  const float* h0;  // (b, di, n), contiguous
  void* y;          // (b, s, di), contiguous
  float* hT;        // (b, di, n), contiguous
  int b, s, di, n;
  long long x_sb, x_ss;
  long long dt_sb, dt_ss;
  long long B_sb, B_ss;
  long long C_sb, C_ss;
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

// 2^x on the SFU: one MUFU.EX2, denormal results flushed to 0
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------- the pipelined kernel

// One copy unit of W bytes from global to shared memory, `valid` of them
// read and the rest zero-filled: cp.async (16: .cg, L2 only; 8 and 4:
// .ca); W = 2 (a bf16 tensor with an odd element offset or stride) is a
// plain load and store, since cp.async copies no fewer than 4 bytes.
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src, int w,
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
      *reinterpret_cast<uint16_t*>(dst) =
          valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies CHUNK rows of one block's channels of a (b, s, di) tensor into
// a (CHUNK, CHANNELS) tile with the block's threads: rows t0 .. t0 +
// CHUNK, channels c0 .. c0 + CHANNELS, in units of w bytes.  Rows at or
// past s and channels at or past di are zero-filled.  Each thread copies
// one unit column of every (w / sizeof(E))-th row.
template <typename E>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const E* src,
                                           long long ss, int rows, int cols,
                                           int w) {
  constexpr int S = sizeof(E);
  const int per_row = CHANNELS * S / w;        // units per row
  const int step = CHANNELS / per_row;         // rows per pass
  const int j = threadIdx.x % per_row;
  const int e0 = j * (w / S);                  // first element of the unit
  const int col_bytes = min(w, max(0, (cols - e0) * S));
  for (int r = threadIdx.x / per_row; r < CHUNK; r += step) {
    const int valid = r < rows ? col_bytes : 0;
    const E* s = valid ? src + r * ss + e0 : src;
    copy_unit(dst + (r * CHANNELS + e0) * S,
              reinterpret_cast<const unsigned char*>(s), w, valid);
  }
}

template <typename T, int NP>
struct Layout {
  static constexpr int X = CHUNK * CHANNELS * sizeof(T);  // one buffer of x
  static constexpr int DT = CHUNK * CHANNELS * 4;         // one of dt
  static constexpr int BC = CHUNK * 2 * NP * 4;           // one of B_t, C_t
  static constexpr int BYTES = 2 * (X + DT + BC);
  __device__ static unsigned char* x(unsigned char* s, int b) {
    return s + b * X;
  }
  __device__ static unsigned char* dt(unsigned char* s, int b) {
    return s + 2 * X + b * DT;
  }
  __device__ static float* bc(unsigned char* s, int b) {
    return reinterpret_cast<float*>(s + 2 * (X + DT) + b * BC);
  }
};

// The pipelined kernel: a block of CHANNELS channels of one batch, a
// thread a channel with its NP entries; chunks of CHUNK steps,
// double-buffered; with TRAIN the checkpoints into ck.
template <typename T, int NP, bool TRAIN>
__global__ void __launch_bounds__(CHANNELS, 4)
    scan_pipe_kernel(Params p, int wx, int wdt, float* ck) {
  constexpr int R = (CHUNK * NP + CHANNELS - 1) / CHANNELS;  // B/C values
                                                              // a thread
  using L = Layout<T, NP>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CHANNELS;
  const int c = c0 + tid;
  const int bi = blockIdx.y;
  const bool live = c < p.di;
  const int cols = min(CHANNELS, p.di - c0);

  const long long hbase = ((long long)bi * p.di + c) * p.n;
  float a2[NP], h[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const bool on = live && i < p.n;
    a2[i] = on ? p.A[(long long)c * p.n + i] * LOG2E : 0.f;
    h[i] = on ? p.h0[hbase + i] : 0.f;
  }
  const float Dc = live ? p.D[c] : 0.f;

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + c0;
  const float* dt = p.dt + bi * p.dt_sb + c0;
  const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb;
  const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb;
  T* y = static_cast<T*>(p.y) + (long long)bi * p.s * p.di + c;

  auto stage = [&](int t0, int buf) {
    const int rows = min(CHUNK, p.s - t0);
    stage_tile<T>(L::x(smem, buf), x + t0 * p.x_ss, p.x_ss, rows, cols, wx);
    stage_tile<float>(L::dt(smem, buf), dt + t0 * p.dt_ss, p.dt_ss, rows,
                      cols, wdt);
    copy_commit();
  };
  // B_t and C_t of a chunk: value i = tid + r * CHANNELS of the chunk's
  // (CHUNK, NP) values, loaded as f32 and stored for the scan
  auto stage_bc = [&](int t0, float* dst) {
    float nb[R], nc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * CHANNELS;
      const int tt = i / NP, j = i % NP;
      const bool on = i < CHUNK * NP && t0 + tt < p.s && j < p.n;
      const long long t = t0 + tt;
      nb[r] = on ? to_f32(Bp[t * p.B_ss + j]) : 0.f;
      nc[r] = on ? to_f32(Cp[t * p.C_ss + j]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * CHANNELS;
      if (i < CHUNK * NP) {
        const int tt = i / NP, j = i % NP;
        dst[tt * 2 * NP + j] = nb[r];
        dst[tt * 2 * NP + NP + j] = nc[r];
      }
    }
  };

  const int chunks = (p.s + CHUNK - 1) / CHUNK;
  stage(0, 0);
  stage_bc(0, L::bc(smem, 0));
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    const bool more = k + 1 < chunks;
    copy_wait_all();
    // chunk k's copies and B/C are visible; every thread is done with
    // chunk k - 1, so its buffers take chunk k + 1
    __syncthreads();
    if (more) stage((k + 1) * CHUNK, buf ^ 1);
    const T* sx = reinterpret_cast<const T*>(L::x(smem, buf));
    const float* sdt = reinterpret_cast<const float*>(L::dt(smem, buf));
    const float* sbc = L::bc(smem, buf);
    const int nt = min(CHUNK, p.s - k * CHUNK);
    T* yk = y + (long long)k * CHUNK * p.di;
    // with `all` true (a whole chunk, every channel of the block live)
    // every thread stores y at every step, so the stores need no
    // predicate and the loop no branch around them
    auto scan_chunk = [&](auto all) {
#pragma unroll UNROLL
      for (int tt = 0; tt < CHUNK; ++tt) {
        if constexpr (TRAIN) {
          // the state before step k CHUNK + tt, where that is a multiple
          // of CK and before s
          if (tt % CK == 0 && (decltype(all)::value || (live && tt < nt))) {
            float* dst = ck + (((long long)bi * ((p.s + CK - 1) / CK) +
                                (k * CHUNK + tt) / CK) * p.di + c) * NP;
#pragma unroll
            for (int i = 0; i < NP; i += 4)
              *reinterpret_cast<float4*>(dst + i) =
                  make_float4(h[i], h[i + 1], h[i + 2], h[i + 3]);
          }
        }
        const float dtv = sdt[tt * CHANNELS + tid];
        const float xv = to_f32(sx[tt * CHANNELS + tid]);
        const float dx = dtv * xv;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int i = 0; i < NP; i += 4) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(&sbc[tt * 2 * NP + i]);
          const float4 c4 =
              *reinterpret_cast<const float4*>(&sbc[tt * 2 * NP + NP + i]);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float e = ex2_approx(dtv * a2[i + q]);
            h[i + q] = fmaf(e, h[i + q], dx * bv[q]);
            if (q % 2 == 0)
              acc0 = fmaf(h[i + q], cv[q], acc0);
            else
              acc1 = fmaf(h[i + q], cv[q], acc1);
          }
        }
        const T yv = from_f32<T>(fmaf(Dc, xv, acc0 + acc1));
        if (decltype(all)::value || (live && tt < nt)) yk[tt * p.di] = yv;
      }
    };
    if (nt == CHUNK && cols == CHANNELS)
      scan_chunk(std::true_type{});
    else
      scan_chunk(std::false_type{});
    if (more) stage_bc((k + 1) * CHUNK, L::bc(smem, buf ^ 1));
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < p.n) p.hT[hbase + i] = h[i];
  }
}

template <typename T, int NP>
cudaError_t launch_pipe(const Params& p, int wx, int wdt, float* ck,
                        cudaStream_t stream) {
  auto kern = ck != nullptr ? scan_pipe_kernel<T, NP, true>
                            : scan_pipe_kernel<T, NP, false>;
  constexpr int bytes = Layout<T, NP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.di + CHANNELS - 1) / CHANNELS, p.b);
  kern<<<grid, CHANNELS, bytes, stream>>>(p, wx, wdt, ck);
  return cudaGetLastError();
}

// ------------------------------- the kernel's first design, the yardstick

#ifdef SCAN_SWEEP
constexpr int THREADS = 128;  // threads of the first design, one a channel

// One thread per (batch, channel) as above; 32 steps of x and dt staged
// per pair of barriers with nothing overlapping the loads; exp2f (FAST
// false, as the first design built it) or ex2.approx (FAST true).
template <typename T, int NP, bool FAST>
__global__ void __launch_bounds__(THREADS) scan_kernel(Params p) {
  __shared__ float sx[CHUNK][THREADS];
  __shared__ float sdt[CHUNK][THREADS];
  __shared__ __align__(16) float sB[CHUNK][NP];
  __shared__ __align__(16) float sC[CHUNK][NP];

  const int tid = threadIdx.x;
  const int c = blockIdx.x * THREADS + tid;
  const int bi = blockIdx.y;
  const bool live = c < p.di;

  const long long hbase = ((long long)bi * p.di + c) * p.n;
  float a2[NP], h[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const bool on = live && i < p.n;
    a2[i] = on ? p.A[(long long)c * p.n + i] * LOG2E : 0.f;
    h[i] = on ? p.h0[hbase + i] : 0.f;
  }
  const float Dc = live ? p.D[c] : 0.f;

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + c;
  const float* dt = p.dt + bi * p.dt_sb + c;
  const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb;
  const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb;
  T* y = static_cast<T*>(p.y) + (long long)bi * p.s * p.di + c;

  for (int t0 = 0; t0 < p.s; t0 += CHUNK) {
    const int nt = min(CHUNK, p.s - t0);
    __syncthreads();  // the previous chunk has been consumed
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const long long t = t0 + tt;
      sx[tt][tid] = live ? to_f32(x[t * p.x_ss]) : 0.f;
      sdt[tt][tid] = live ? dt[t * p.dt_ss] : 0.f;
    }
    for (int i = tid; i < nt * NP; i += THREADS) {
      const int tt = i / NP, j = i % NP;
      const long long t = t0 + tt;
      sB[tt][j] = j < p.n ? to_f32(Bp[t * p.B_ss + j]) : 0.f;
      sC[tt][j] = j < p.n ? to_f32(Cp[t * p.C_ss + j]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = sdt[tt][tid];
      const float xv = sx[tt][tid];
      const float dx = dtv * xv;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int i = 0; i < NP; i += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sB[tt][i]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sC[tt][i]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float arg = dtv * a2[i + q];
          const float e = FAST ? ex2_approx(arg) : exp2f(arg);
          h[i + q] = fmaf(e, h[i + q], dx * bv[q]);
          if (q % 2 == 0)
            acc0 = fmaf(h[i + q], cv[q], acc0);
          else
            acc1 = fmaf(h[i + q], cv[q], acc1);
        }
      }
      if (live)
        y[(long long)(t0 + tt) * p.di] = from_f32<T>(fmaf(Dc, xv, acc0 + acc1));
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < p.n) p.hT[hbase + i] = h[i];
  }
}

template <typename T, int NP>
cudaError_t launch_first(const Params& p, bool fast, cudaStream_t stream) {
  const dim3 grid((p.di + THREADS - 1) / THREADS, p.b);
  if (fast)
    scan_kernel<T, NP, true><<<grid, THREADS, 0, stream>>>(p);
  else
    scan_kernel<T, NP, false><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The SFUs' ex2 rate: every thread runs 8 independent chains of
// `iters` ex2.approx each; beside each ex2 F independent FFMAs (their
// own 8 chains) and, per 8 ex2, L broadcast LDS.128 from shared memory,
// to see what the SFUs share with the FMA pipe and the shared-memory
// path.  Thread 0 of each block records the SM's clock cycles over the
// loop and the SM it ran on.
template <int F, int L>
__global__ void __launch_bounds__(1024)
    ex2_probe_kernel(float* out, long long* cycles, int* sm, int iters) {
  extern __shared__ __align__(16) float4 probe_smem[];
  float v[8], w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = 1e-3f * ((threadIdx.x & 31) + j);
    w[j] = v[j];
  }
  if (threadIdx.x < 64) probe_smem[threadIdx.x] = make_float4(0.f, 0.f, 0.f,
                                                              0.f);
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 2
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = ex2_approx(-v[j]);
#pragma unroll
      for (int f = 0; f < F; ++f) w[(j + f) & 7] = fmaf(w[(j + f) & 7],
                                                        0.999f, 1e-3f);
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 q = probe_smem[(it + l) & 63];
      w[l & 7] += q.x + q.y;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += v[j] + w[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) {
    int id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    cycles[blockIdx.x] = t1 - t0;
    sm[blockIdx.x] = id;
  }
}

// (F, L) of the probe's instantiations
#define SCAN_PROBES(X) X(0, 0) X(8, 0)
#endif

template <typename T>
cudaError_t launch_for_state(const Params& p, int design, int wx, int wdt,
                             float* ck, cudaStream_t stream) {
  if (design == 2) {
    if (p.n <= 4) return launch_pipe<T, 4>(p, wx, wdt, ck, stream);
    if (p.n <= 8) return launch_pipe<T, 8>(p, wx, wdt, ck, stream);
    if (p.n <= 16) return launch_pipe<T, 16>(p, wx, wdt, ck, stream);
    return cudaErrorInvalidValue;
  }
#ifdef SCAN_SWEEP
  if ((design == 0 || design == 1) && ck == nullptr) {
    const bool fast = design == 1;
    if (p.n <= 4) return launch_first<T, 4>(p, fast, stream);
    if (p.n <= 8) return launch_first<T, 8>(p, fast, stream);
    if (p.n <= 16) return launch_first<T, 16>(p, fast, stream);
  }
#endif
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, A, D and both
// states are float32.  strides: 8 element strides, the (batch, seq)
// strides of x, dt, B and C in that order; the last dim of each must have
// stride 1.  A (di, n), D (di,), the states (b, di, n) and y (b, s, di)
// are contiguous.  design: 2 = the pipelined kernel, with copy widths
// wx, wdt (bytes: 16, 8, 4, or 2 for bf16 x); in the sweep library also
// 0 = the first design, 1 = the same with ex2.approx (widths unread).
// ck: null (serving), or for design 2 the training mode's checkpoints,
// (b, ceil(s / 16), di, NP) contiguous f32, NP the state size padded to
// 4, 8 or 16.  Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for a design the library does not hold).
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* B,
                                  const void* C, const void* D,
                                  const void* h0, void* y, void* hT,
                                  int dtype, int b, int s, int di, int n,
                                  const long long* strides, int design,
                                  int wx, int wdt, void* ck, void* stream) {
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = C;
  p.D = static_cast<const float*>(D);
  p.h0 = static_cast<const float*>(h0);
  p.y = y;
  p.hT = static_cast<float*>(hT);
  p.b = b;
  p.s = s;
  p.di = di;
  p.n = n;
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.dt_sb = strides[2];
  p.dt_ss = strides[3];
  p.B_sb = strides[4];
  p.B_ss = strides[5];
  p.C_sb = strides[6];
  p.C_ss = strides[7];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  float* cp = static_cast<float*>(ck);
  if (dtype == 0)
    err = launch_for_state<float>(p, design, wx, wdt, cp, st);
  else if (dtype == 1)
    err = launch_for_state<__nv_bfloat16>(p, design, wx, wdt, cp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

#ifdef SCAN_SWEEP
// Launches the ex2 probe with F FFMAs beside each ex2 and L LDS.128 per
// 8 ex2 (an (F, L) of SCAN_PROBES): `blocks` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory each (enough that
// an SM holds one block), `iters` iterations.  out: blocks * threads
// f32; cycles: blocks int64; sm: blocks int32.  Returns a cudaError_t.
extern "C" int ex2_rate_probe(void* out, void* cycles, void* sm, int blocks,
                              int threads, int iters, int smem, int fmas,
                              int lds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SCAN_PROBE(F, L)                                                    \
  if (fmas == F && lds == L) {                                              \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        ex2_probe_kernel<F, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        smem);                                                              \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    ex2_probe_kernel<F, L><<<blocks, threads, smem, st>>>(                  \
        static_cast<float*>(out), static_cast<long long*>(cycles),          \
        static_cast<int*>(sm), iters);                                      \
    return static_cast<int>(cudaGetLastError());                            \
  }
  SCAN_PROBES(SCAN_PROBE)
#undef SCAN_PROBE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
