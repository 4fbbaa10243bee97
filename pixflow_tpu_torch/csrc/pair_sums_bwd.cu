// K1 pair_sums_bwd: the backward pass of the pair sums,
//     dq[b] = (g_b M) @ k[b],   dk[b] = (g_b M)^T @ q[b],
// each only when asked for, with M the forward's positive-pair mask and g_b
// the cotangent of sample b's logit sum (the mask sum gets no gradient).
// Results are accumulated in f32 and written in the inputs' dtype.
//
// Replaces the JAX package's analytic VJP
// pixflow_tpu/ops/pallas/pair_loss.py:_bwd (with _recompute_mask), which XLA
// fuses into a few ops. PRs 1-2 ran it as ~17 PyTorch ops per direction (the
// mask rebuilt over [B, N, N], casts, two f32 bmm, casts back), dk included,
// though the pair loss's key features are targets and need no gradient.
//
// What bounds it on an H100: latency. dq alone at the recipe's shapes (B=64,
// N=49, C=256, bf16) reads k and writes dq, 3.2 MB, about 1 us at
// 3.35 TB/s; its products are 2*C flops per positive pair (~5% of the pairs).
//
// Design: one launch per direction, one CTA of 16 warps per (sample, dq or
// dk); CTAs write disjoint outputs, so there are no atomics.
//   - A dq CTA reduces over the keys, a dk CTA over the queries. Thread 0
//     stages the other side's rows (64 at a time, 256 channels at a time:
//     all of them at the recipe's shapes) with one TMA tensor copy as the
//     kernel starts and, while it is in flight, the CTA evaluates its 64 x 64
//     slice of M from the centers into a bitmask (one ballot per row and 32
//     columns). M is never written to global memory.
//   - CUDA cores for both dtypes, over the positive pairs only. Warp w owns
//     the output rows w, w + 16, ...; lane l owns channels [8l, 8l + 8) of
//     the chunk. For each row the warp walks the row's bits t in ascending
//     order: acc += (g_b * M_it) * X_t with __fmaf_rn. That is the plain
//     version's f32 FMA chain (cuBLAS's order at these shapes) with its
//     zero terms left out, which add nothing to it, so the result is the
//     plain version's to the bit; bf16 is rounded once, as Tensor.to does.
//     A tensor-core product (mma.sync with M as 0/1 bf16, g applied after
//     the sum) was tried first: where the positive pairs' key values cancel
//     exactly it gives the exact 0, while the plain version, which rounds
//     g * k_t per term, leaves a residue, so the two differed by more than
//     one bf16 ulp there.
//   - A lane writes its 8 channels of a row with one 16-byte (bf16) or two
//     (f32) stores: a warp writes a row's 256 channels in one pass.
//   - The mask's arithmetic is not contracted (--fmad=false).

#include "pair_sums.cuh"

using namespace pixflow_pair;

namespace {

constexpr int kRowsPerWarp = kBlock / kWarps;  // 4

// acc += (g_b M) @ X over one staged block: acc[8r + u] is row w + 16r,
// channel 8l + u of the chunk, for warp w and lane l.
template <typename T>
__device__ __forceinline__ void accumulate_rows(const MaskBits bits, const float* rp,
                                                const float* cp, const T* xs, int rows,
                                                int width, float gb,
                                                float acc[8 * kRowsPerWarp]) {
  const int c = 8 * (threadIdx.x & 31);
  if (c >= width) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = (int)(threadIdx.x >> 5) + kWarps * r;
    if (i >= rows) break;
    // g_b * M_it = (g_b * rp[i]) * cp[t]: one of rp[i], cp[t] is exactly 1
    const float gi = gb * rp[i];
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) {
      uint32_t word = bits[i][w];
      while (word != 0) {
        const int t = 32 * w + __ffs(word) - 1;
        word &= word - 1;
        const float gm = gi * cp[t];
        float x[8];
        load8(xs, t, c, x);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[8 * r + u] = __fmaf_rn(gm, x[u], acc[8 * r + u]);
      }
    }
  }
}

__device__ __forceinline__ void store8(float* o, const float v[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* o, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
    w[u] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Writes the warp's rows [0, rows) x the lane's 8 channels of the chunk at
// c0 to out (rows of C channels, starting at the block's first row).
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float acc[8 * kRowsPerWarp], int rows,
                                           int C, int c0, int width) {
  const int ch = c0 + 8 * (threadIdx.x & 31);
  if (ch >= c0 + width) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = (int)(threadIdx.x >> 5) + kWarps * r;
    if (i >= rows) break;
    T* o = out + (int64_t)i * C + ch;
    if (C % 8 == 0 && ch + 8 <= C)
      store8(o, acc + 8 * r);
    else
      for (int u = 0; u < 8 && ch + u < C; ++u) o[u] = from_float<T>(acc[8 * r + u]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_sums_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map, const T* __restrict__ q,
                         const T* __restrict__ k, const float* __restrict__ qx,
                         const float* __restrict__ qy, const float* __restrict__ kx,
                         const float* __restrict__ ky, const float* __restrict__ inv_diag,
                         const float* __restrict__ pts_mask, const float* __restrict__ g,
                         int g_stride, T* __restrict__ dq, T* __restrict__ dk, int N, int C,
                         float pos_ratio, int tma) {
  extern __shared__ unsigned char smem[];
  __shared__ float s_rx[kBlock], s_ry[kBlock], s_rp[kBlock];
  __shared__ float s_cx[kBlock], s_cy[kBlock], s_cp[kBlock];
  __shared__ uint32_t s_bits[kBlock][kBlock / 32];
  __shared__ uint64_t s_bar;

  // before any load, which the init's fence would wait for
  if (threadIdx.x == 0) mbar_init(&s_bar);
  const int b = blockIdx.y;
  const bool to_dk = dq == nullptr || blockIdx.x == 1;
  // output rows: queries for dq, keys for dk; the reduction runs over the
  // other side, and the queries carry pts_mask
  const float* rx = to_dk ? kx : qx;
  const float* ry = to_dk ? ky : qy;
  const float* cx = to_dk ? qx : kx;
  const float* cy = to_dk ? qy : ky;
  const float* rpm = to_dk ? nullptr : pts_mask;
  const float* cpm = to_dk ? pts_mask : nullptr;
  const CUtensorMap* x_map = to_dk ? &q_map : &k_map;
  const T* x = to_dk ? q : k;
  const int64_t row0 = (int64_t)b * N;
  T* out = (to_dk ? dk : dq) + row0 * C;
  T* xs = aligned_tiles<T>(smem);
  unsigned round = 0;

  for (int r0 = 0; r0 < N; r0 += kBlock) {
    const int rows = min(kBlock, N - r0);
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int width = chunk_width(C - c0);
      float acc[8 * kRowsPerWarp];
#pragma unroll
      for (int e = 0; e < 8 * kRowsPerWarp; ++e) acc[e] = 0.0f;
      for (int t0 = 0; t0 < N; t0 += kBlock) {
        const int cols = min(kBlock, N - t0);
        if (round > 0) __syncthreads();  // the previous block's readers are done
        const unsigned bytes = stage_block(xs, x_map, x, row0 + t0, cols, C, c0, width,
                                           tma != 0, round > 0, &s_bar);
        if (threadIdx.x == 0) mbar_arrive_expect(&s_bar, bytes);
        const float inv = inv_diag[b];
        load_centers(s_rx, s_ry, s_rp, rx, ry, rpm, row0 + r0, rows, kBlock);
        load_centers(s_cx, s_cy, s_cp, cx, cy, cpm, row0 + t0, cols, 2 * kBlock);
        __syncthreads();  // centers visible; the copies are still in flight
        mask_bits(s_bits, s_rx, s_ry, s_rp, s_cx, s_cy, s_cp, rows, cols, inv, pos_ratio);
        mbar_wait(&s_bar, round & 1u);
        ++round;
        __syncthreads();  // element copies and mask bits visible
        accumulate_rows(s_bits, s_rp, s_cp, xs, rows, width, g[(int64_t)b * g_stride], acc);
      }
      store_rows(out + (int64_t)r0 * C, acc, rows, C, c0, width);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const float* qx, const float* qy, const float* kx,
           const float* ky, const float* inv_diag, const float* pts_mask, const float* g,
           int g_stride, void* dq, void* dk, int B, int N, int C, float pos_ratio,
           cudaStream_t stream) {
  static size_t granted[64];
  const int dirs = (dq != nullptr) + (dk != nullptr);
  if (B == 0 || N == 0 || C == 0 || dirs == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)block_bytes<T>(C) + 1024;
  cudaError_t e = allow_shared(pair_sums_bwd_kernel<T>, smem, granted);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap q_map, k_map;
  const int tma = row_tensor_map<T>(&q_map, q, (int64_t)B * N, C) &&
                  row_tensor_map<T>(&k_map, k, (int64_t)B * N, C);
  pair_sums_bwd_kernel<T><<<dim3(dirs, B, 1), kThreads, smem, stream>>>(
      q_map, k_map, static_cast<const T*>(q), static_cast<const T*>(k), qx, qy, kx, ky,
      inv_diag, pts_mask, g, g_stride, static_cast<T*>(dq), static_cast<T*>(dk), N, C,
      pos_ratio, tma);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k [B, N, C] (bf16 when is_bf16, else f32); qx, qy, kx, ky, pts_mask
// [B, N] f32 (pts_mask may be null); inv_diag [B] f32; g [B] f32 with
// element stride g_stride; dq, dk [B, N, C] in q's dtype, either may be null
// (not computed). All contiguous on one device, B <= 65535, B * N < 2^31.
// Returns the launch's cudaError_t.
extern "C" int pixflow_pair_sums_bwd(const void* q, const void* k, const float* qx,
                                     const float* qy, const float* kx, const float* ky,
                                     const float* inv_diag, const float* pts_mask,
                                     const float* g, int g_stride, void* dq, void* dk, int B,
                                     int N, int C, float pos_ratio, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, qx, qy, kx, ky, inv_diag, pts_mask, g, g_stride, dq, dk,
                                 B, N, C, pos_ratio, s);
  return launch<float>(q, k, qx, qy, kx, ky, inv_diag, pts_mask, g, g_stride, dq, dk, B, N, C,
                       pos_ratio, s);
}
