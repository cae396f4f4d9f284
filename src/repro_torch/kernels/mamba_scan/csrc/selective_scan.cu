// Mamba selective scan (S6) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `selective_scan_pallas` (body `_kernel`) in
// src/repro/kernels/mamba_scan/kernel.py, with the same contract: for
// each (batch, channel c), with h the N-entry f32 state of the channel,
//     h_t = exp(dt_t A_c) * h_{t-1} + (dt_t x_t) B_t
//     y_t = h_t . C_t + D_c x_t
// x (b, s, di) and B, C (b, s, N) in one type (f32 or bf16), dt (b, s,
// di) f32, A (di, N) f32, D (di,) f32, state (b, di, N) f32 in and out,
// y (b, s, di) in x's type.  The loop runs exactly s steps: the final
// state is the state after step s (the TPU kernel pads time with dt = 0,
// which leaves it the same).
//
// Design.  Channels are independent and share only B_t and C_t (N values
// per batch and step).  The TPU kernel tiles (batch, channel block, time
// chunk) and carries the (block, N) state in VMEM across its sequential
// time-chunk grid axis; on Hopper nothing carries between blocks, so the
// time loop runs inside the block.  One thread per (batch, channel)
// keeps the channel's N state entries and its row of A (pre-scaled by
// log2 e, so that exp(dt A) is one ex2) in registers for the whole
// sequence; a block is 128 channels of one batch.  Time is staged in
// chunks of 32 steps per __syncthreads: each thread loads its own column
// of x and dt for the whole chunk (coalesced rows, 32 independent loads
// in flight), and the block loads the chunk's B_t and C_t once, read back
// as shared-memory broadcasts.  B and C are read through their strides
// (the model hands them as column slices of one projection).  N <= 16 is
// padded to 4, 8 or 16 entries with A = B = C = 0 and a zero state, which
// leaves the padding at 0; a ragged last block of channels is masked.
//
// What bounds it: per (batch, step, channel) it must read x (2 bytes in
// bf16) and dt (4) and write y (2); per state entry and step it needs one
// exponential and about 6 f32 operations.  At the serving shape (4, 1024,
// 16384, N = 16) that is 545 MB (0.163 ms at 3.35 TB/s), 6.4 GFLOP
// (0.096 ms at 67 TFLOP/s) and 1.07e9 exponentials, which the SFUs compute
// at 16 a clock per SM (CUDA C++ programming guide, arithmetic
// instruction throughput, compute capability 9.0): 0.257 ms at 132 SMs
// and 1.98 GHz.  The exponentials bound it.  At that shape there are
// 65,536 independent chains (512 blocks, about 16 warps per SM), so
// unlike WKV6 the step latency is hidden by other warps.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int CHUNK = 32;     // time steps staged per barrier
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

template <typename T, int NP>
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
        h[i] = fmaf(exp2f(dtv * a2[i]), h[i], dx * b4.x);
        h[i + 1] = fmaf(exp2f(dtv * a2[i + 1]), h[i + 1], dx * b4.y);
        h[i + 2] = fmaf(exp2f(dtv * a2[i + 2]), h[i + 2], dx * b4.z);
        h[i + 3] = fmaf(exp2f(dtv * a2[i + 3]), h[i + 3], dx * b4.w);
        acc0 = fmaf(h[i], c4.x, acc0);
        acc1 = fmaf(h[i + 1], c4.y, acc1);
        acc0 = fmaf(h[i + 2], c4.z, acc0);
        acc1 = fmaf(h[i + 3], c4.w, acc1);
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

template <typename T>
cudaError_t launch_for_state(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.di + THREADS - 1) / THREADS, p.b);
  if (p.n <= 4)
    scan_kernel<T, 4><<<grid, THREADS, 0, stream>>>(p);
  else if (p.n <= 8)
    scan_kernel<T, 8><<<grid, THREADS, 0, stream>>>(p);
  else if (p.n <= 16)
    scan_kernel<T, 16><<<grid, THREADS, 0, stream>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, A, D and both
// states are float32.  strides: 8 element strides, the (batch, seq)
// strides of x, dt, B and C in that order; the last dim of each must have
// stride 1.  A (di, n), D (di,), the states (b, di, n) and y (b, s, di)
// are contiguous.  Returns a cudaError_t (0 = launched).
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* B,
                                  const void* C, const void* D,
                                  const void* h0, void* y, void* hT,
                                  int dtype, int b, int s, int di, int n,
                                  const long long* strides, void* stream) {
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
  if (dtype == 0)
    err = launch_for_state<float>(p, st);
  else if (dtype == 1)
    err = launch_for_state<__nv_bfloat16>(p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
