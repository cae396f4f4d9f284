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
// leaves it the same).
//
// Design: one block per (head, batch) and one thread per state column
// (hd threads; head dims below 16/32/64 are padded with zero lanes).  The
// TPU kernel keeps S in VMEM across its sequential time-chunk grid axis;
// here the time loop runs inside the block and thread j keeps column j
// of S in registers (hd floats) for the whole sequence, so the state
// never touches memory between the first load and the last store.  Per
// step, thread j computes
//     y_j  = sum_i r_i S_ij + a v_j,   a = sum_i r_i u_i k_i
//     S_ij = w_i S_ij + k_i v_j
// with no cross-thread reduction: r, k, w of the step are read from
// shared memory as broadcasts (float4), v_j from its own lane.  Time is
// staged in chunks of 2048 / hd steps per __syncthreads: every thread
// loads its lane of r/k/v/w for the whole chunk (coalesced rows, read
// through the caller's strides), and the rank-1 scalar a of each step is
// reduced once per chunk with warp shuffles, not once per thread.
//
// What bounds it: per (b, h, t) it must read r/k/v (2 bytes each in bf16)
// and w (f32) and write y, and needs 4 hd^2 + O(hd) floating-point
// operations: with the state kept scaled by the running product of the
// decays (rescaled once per chunk), S += k^T v is one FMA per entry and
// y = (r*D).S one more.  At the serving shape (4, 1024, 32, 64) that is
// 105 MB (31 us at 3.35 TB/s) and 2.19 GFLOP (33 us at 67 TFLOP/s of f32
// FMA).  This kernel spends one more multiply per entry on the decay
// (w S + k v, as the reference writes it).  But the 1024 steps are a
// dependent chain, and 128 blocks of 64 threads put two warps on each SM:
// the kernel is bound by the latency of that chain (about 250
// instructions per step per warp), not by bytes or operations.  Splitting
// a column over more threads (with a shuffle reduction of y) and
// overlapping the next chunk's loads are a later step.
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
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
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

template <typename T, int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(Params p) {
  constexpr int CHUNK = 2048 / HD;        // 32 KB of staged inputs
  constexpr int NW = (HD + 31) / 32;      // warps in the block
  constexpr int LANES = HD < 32 ? HD : 32;
  constexpr unsigned MASK = HD < 32 ? (1u << HD) - 1u : 0xffffffffu;
  __shared__ __align__(16) float sr[CHUNK][HD];
  __shared__ __align__(16) float sk[CHUNK][HD];
  __shared__ __align__(16) float sw[CHUNK][HD];
  __shared__ float sv[CHUNK][HD];
  __shared__ float sa[CHUNK][NW];         // per-warp parts of a

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const bool live = j < p.hd;

  const T* r = static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh + j;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh + j;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + h * p.v_sh + j;
  const float* w = p.w + bi * p.w_sb + h * p.w_sh + j;
  T* y = static_cast<T*>(p.y) + bi * p.y_sb + h * p.y_sh + j;
  const long long sbase = ((long long)bi * p.h + h) * p.hd * p.hd + j;
  const float uj = live ? p.u[h * p.hd + j] : 0.f;

  float S[HD];  // column j of the state
#pragma unroll
  for (int i = 0; i < HD; ++i)
    S[i] = (live && i < p.hd) ? p.s0[sbase + (long long)i * p.hd] : 0.f;

  for (int t0 = 0; t0 < p.s; t0 += CHUNK) {
    const int n = min(CHUNK, p.s - t0);
    __syncthreads();  // the previous chunk has been consumed
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      sr[tt][j] = live ? to_f32(r[t * p.r_ss]) : 0.f;
      sk[tt][j] = live ? to_f32(k[t * p.k_ss]) : 0.f;
      sv[tt][j] = live ? to_f32(v[t * p.v_ss]) : 0.f;
      sw[tt][j] = live ? w[t * p.w_ss] : 0.f;
    }
    // a_t = sum_i r_i u_i k_i; each thread reads back only its own lane
    for (int tt = 0; tt < n; ++tt) {
      float part = sr[tt][j] * uj * sk[tt][j];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(MASK, part, off);
      if (j % 32 == 0) sa[tt][j / 32] = part;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float a = sa[tt][0];
#pragma unroll
      for (int q = 1; q < NW; ++q) a += sa[tt][q];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i]);
        acc0 = fmaf(r4.x, S[i], acc0);
        acc1 = fmaf(r4.y, S[i + 1], acc1);
        acc2 = fmaf(r4.z, S[i + 2], acc2);
        acc3 = fmaf(r4.w, S[i + 3], acc3);
        S[i] = fmaf(w4.x, S[i], k4.x * vj);
        S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
        S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
        S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
      }
      const float out = ((acc0 + acc1) + (acc2 + acc3)) + a * vj;
      if (live) y[(long long)(t0 + tt) * p.y_ss] = from_f32<T>(out);
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i)
    if (live && i < p.hd) p.sT[sbase + (long long)i * p.hd] = S[i];
}

template <typename T>
cudaError_t launch_for_head_dim(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.h, p.b);
  if (p.hd <= 16)
    wkv6_kernel<T, 16><<<grid, 16, 0, stream>>>(p);
  else if (p.hd <= 32)
    wkv6_kernel<T, 32><<<grid, 32, 0, stream>>>(p);
  else if (p.hd <= 64)
    wkv6_kernel<T, 64><<<grid, 64, 0, stream>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16; w, u and both
// states are float32.  strides: 15 element strides, the (batch, seq,
// head) strides of r, k, v, w and y in that order; the head-dim stride of
// each must be 1.  u (H, hd) and the states (b, H, hd, hd) are
// contiguous.  Returns a cudaError_t (0 = launched).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* sT, int dtype, int b, int s, int h,
                        int hd, const long long* strides, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_for_head_dim<float>(p, st);
  else if (dtype == 1)
    err = launch_for_head_dim<__nv_bfloat16>(p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
