// K1 pair_sums_fwd: per-sample masked pixel-pair similarity sums,
//     out[b] = ( sum_ij (q_i . k_j) * M_ij ,  sum_ij M_ij ),
//     M_ij   = (sqrt(dx*dx + dy*dy) * inv_diag[b] < pos_ratio) * pts_mask[b, i],
// with (dx, dy) the offset between warped query bin center i and key bin
// center j. The loss is -2 * mean(lsum / (msum + 1e-6)).
//
// Replaces the TPU kernel pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel
// (launched by _pair_sums_pallas, wrapped by fused_pair_sums). As in the JAX
// package, the backward pass is not a kernel: dq = (g*M) @ k and
// dk = (g*M)^T @ q are two batched matrix products in PyTorch.
//
// What bounds it on an H100: launch latency, then bytes. At the recipe's
// shapes (B=64, N=49, C=256) a launch reads 3.2 MB of bf16 q/k (6.4 MB in
// f32), about 1 us (2 us) of HBM time at 3.35 TB/s, and does at most
// 2*N*N*C = 1.2 MFLOP per sample, 79 MFLOP in all, which f32 CUDA cores
// finish in about 1.2 us. Both are below one launch.
//
// Design. One block per sample (B=64 blocks on 132 SMs is enough for now),
// sixteen warps, one mask row i at a time per warp. The lanes of a warp
// evaluate M_ij for 32 key bins j at once, in the TPU kernel's own f32
// arithmetic (this file is compiled with --fmad=false, so dx*dx + dy*dy is
// not contracted and the mask matches the PyTorch plain version bit for
// bit). A ballot then lists the positive pairs of those 32 bins, about 5%
// of them at the recipe's geometry, and for each one the warp reads q_i and
// k_j with coalesced loads (lane l owns channels l, l + 32, ...) and adds
// M_ij (q_i . k_j) to per-lane partial sums. So the N x N logit matrix is
// never formed and zero mask entries cost one comparison, no loads. q/k are
// read as bf16 or f32 and accumulated in f32. The block reduction is a fixed
// shared-memory tree with no atomics, so two runs give identical bits.
//
// It takes about 10 us a launch on an H100 (chip_smoke.py, phase
// kernel_pair_sums), against a bound of 1-2 us: what is left is latency,
// each warp walking three or four rows one after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void pair_sums_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const float* __restrict__ qx,
                                 const float* __restrict__ qy,
                                 const float* __restrict__ kx,
                                 const float* __restrict__ ky,
                                 const float* __restrict__ inv_diag,
                                 const float* __restrict__ pts_mask,
                                 float* __restrict__ out, int N, int C,
                                 float pos_ratio) {
  __shared__ float red_l[kThreads];
  __shared__ float red_m[kThreads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inv = inv_diag[b];
  const int64_t row0 = (int64_t)b * N;
  const T* bq = q + row0 * C;
  const T* bk = k + row0 * C;

  float lsum = 0.0f;
  float msum = 0.0f;
  for (int i = warp; i < N; i += kWarps) {
    const float qxi = qx[row0 + i];
    const float qyi = qy[row0 + i];
    const T* qi = bq + (int64_t)i * C;
    for (int j0 = 0; j0 < N; j0 += 32) {
      const int j = j0 + lane;
      float m = 0.0f;
      if (j < N) {
        const float dx = qxi - kx[row0 + j];
        const float dy = qyi - ky[row0 + j];
        const float dist = sqrtf(dx * dx + dy * dy) * inv;
        m = dist < pos_ratio ? 1.0f : 0.0f;
        if (pts_mask != nullptr) m = m * pts_mask[row0 + i];
      }
      msum = msum + m;
      // positive pairs of these 32 bins, ascending j; warp-uniform loop
      unsigned nz = __ballot_sync(kFull, m != 0.0f);
      while (nz != 0u) {
        const int bit = __ffs(nz) - 1;
        nz &= nz - 1u;
        const float mj = __shfl_sync(kFull, m, bit);
        const T* kj = bk + (int64_t)(j0 + bit) * C;
        float dot = 0.0f;
#pragma unroll 8
        for (int c = lane; c < C; c += 32)
          dot = dot + to_float(qi[c]) * to_float(kj[c]);
        lsum = lsum + mj * dot;
      }
    }
  }

  red_l[tid] = lsum;
  red_m[tid] = msum;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red_l[tid] = red_l[tid] + red_l[tid + s];
      red_m[tid] = red_m[tid] + red_m[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * b] = red_l[0];
    out[2 * b + 1] = red_m[0];
  }
}

template <typename T>
int launch(const void* q, const void* k, const float* qx, const float* qy,
           const float* kx, const float* ky, const float* inv_diag,
           const float* pts_mask, float* out, int B, int N, int C,
           float pos_ratio, cudaStream_t stream) {
  pair_sums_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), qx, qy, kx, ky,
      inv_diag, pts_mask, out, N, C, pos_ratio);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k [B, N, C] (bf16 when is_bf16, else f32); qx, qy, kx, ky, pts_mask
// [B, N] f32 (pts_mask may be null); inv_diag [B] f32; out [B, 2] f32. All
// contiguous on one device. Returns cudaGetLastError() after the launch.
extern "C" int pixflow_pair_sums(const void* q, const void* k, const float* qx,
                                 const float* qy, const float* kx,
                                 const float* ky, const float* inv_diag,
                                 const float* pts_mask, float* out, int B,
                                 int N, int C, float pos_ratio, int is_bf16,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, qx, qy, kx, ky, inv_diag, pts_mask,
                                 out, B, N, C, pos_ratio, s);
  return launch<float>(q, k, qx, qy, kx, ky, inv_diag, pts_mask, out, B, N, C,
                       pos_ratio, s);
}
