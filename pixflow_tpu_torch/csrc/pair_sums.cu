// K1 pair_sums_fwd: per-sample masked pixel-pair similarity sums,
//     out[b] = ( sum_ij (q_i . k_j) * M_ij ,  sum_ij M_ij ),
//     M_ij   = (sqrt(dx*dx + dy*dy) * inv_diag[b] < pos_ratio) * pts_mask[b, i],
// with (dx, dy) the offset between warped query bin center i and key bin
// center j. The loss is -2 * mean(lsum / (msum + 1e-6)).
//
// Replaces the TPU kernel pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel
// (launched by _pair_sums_pallas, wrapped by fused_pair_sums). The backward
// pass, which the JAX package leaves to XLA (_bwd), is the kernel of
// pair_sums_bwd.cu.
//
// What bounds it on an H100: latency. At the recipe's shapes (B=64, N=49,
// C=256) a launch reads 3.2 MB of bf16 q/k (6.4 MB in f32), about 1 us (2 us)
// of HBM time at 3.35 TB/s, and its products are 2*N*N*C = 1.2 MFLOP per
// sample. The first design (PRs 1-2: a warp per mask row, q_i and k_j read
// from L2 for each of the ~5% positive pairs behind a ballot) took 0.0100 ms
// in bf16: a chain of ~15 dependent L2 round trips per warp.
//
// Design: one CTA of 16 warps per sample.
//   - Thread 0 stages the sample's query and key rows (64 of each, 256
//     channels at a time: the whole sample at the recipe's shapes) into
//     shared memory with one TMA tensor copy each as the kernel starts; the
//     other threads load the centers, and the copies land while the mask is
//     evaluated. Splitting a sample over a cluster of CTAs by query tiles,
//     which fills more of the card, was slower: every CTA stages all the
//     keys, so L2 traffic grows with the split, and a cluster launch costs
//     about a microsecond.
//   - M is evaluated once per (query, key) from the staged centers into a
//     bitmask (one ballot per row and 32 keys), which also gives sum(M).
//   - bf16: the 64 x 64 logit tile on tensor cores (mma.sync m16n8k16, f32
//     accumulators, fragments by ldmatrix from the swizzled tiles). Warp w
//     owns 32 query rows and 32 keys over a quarter of the channels (so
//     each fragment is read from shared memory twice, not four times, which
//     bounded this phase); each accumulator's (i, j) follows from the
//     fragment layout, so the warp adds its share of sum(logit * M) from the
//     fragments, and logits of rows or keys past N are never added.
//   - f32 (the parity mode) stays on CUDA cores, since TF32 is not f32, and
//     visits the positive pairs only: warp w takes query rows w, w + 16, ...,
//     walks the row's bits, and lane l adds M_ij * (its __fmaf_rn chain of
//     q_ic k_jc over channels [8l, 8l + 8)) to a per-lane sum.
//   - Reduction in a fixed order with no atomics: warp butterflies, then the
//     warps in order. Two runs give identical bits. The mask's arithmetic is
//     not contracted (--fmad=false).

#include "pair_sums.cuh"

using namespace pixflow_pair;

namespace {

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A(16x16, row-major) * B(16x8, column-major), bf16 in, f32 accumulate.
// Lane l (g = l / 4, t = l % 4) holds a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]} and
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tile {
  const MaskBits bits;
  const float* qp;  // the query rows' pts_mask (1 without one)
  int rows, keys, width;
};

// bf16: acc += warp w's share of the chunk's logits: rows [32 (w % 2), +32)
// as 2 m-tiles, keys [32 (w / 2 % 2), +32) as 4 n-tiles, and the chunk's
// 16-channel steps w / 4, w / 4 + 4, ... (the channels are split four ways,
// so every fragment is read by two warps, not four). acc[16 t + 4 s + e] is
// m-tile t, n-tile s, fragment element e. One ldmatrix.x4 gives an A
// fragment, one gives the B fragments of two n-tiles (keys are rows of k, so
// B needs no transpose).
__device__ __forceinline__ void accumulate_logits(const __nv_bfloat16* qs,
                                                  const __nv_bfloat16* ks, const Tile& tl,
                                                  float acc[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = 32 * (warp & 1);
  const int j0 = 32 * ((warp >> 1) & 1);
  if (i0 >= tl.rows || j0 >= tl.keys) return;  // warp-uniform: all padding
  // A: lanes 0-15 rows 0-15 at channel c, lanes 16-31 the same rows at c + 8
  const int ra = i0 + (lane & 15), ca = (lane >> 4) * 8;
  // B: lanes 0-7 keys 0-7 at c, 8-15 keys 0-7 at c + 8, 16-31 keys 8-15 likewise
  const int rb = j0 + (lane & 7) + ((lane >> 4) << 3), cb = ((lane >> 3) & 1) * 8;
  for (int c = 16 * (warp >> 2); c < tl.width; c += 64) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) ldmatrix_x4(a[t], chunk_at(qs, ra + 16 * t, c + ca));
#pragma unroll
    for (int h = 0; h < 2; ++h) ldmatrix_x4(b[h], chunk_at(ks, rb + 16 * h, c + cb));
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_bf16(acc + 16 * t + 4 * s, a[t], b[s / 2][2 * (s % 2)], b[s / 2][2 * (s % 2) + 1]);
  }
}

// bf16: sum(logit * M) over warp w's fragments (its channels' share of the
// logits), once the chunks are summed. The warp's 32 keys are one word of a
// row's bits; the lane's 4 rows are i0 + 16 t + g + 8 h.
__device__ __forceinline__ float masked_logits(const float acc[32], const Tile& tl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int word = (warp >> 1) & 1;
  float lsum = 0.0f;
#pragma unroll
  for (int th = 0; th < 4; ++th) {
    const int t = th >> 1, h = th & 1;
    const int i = 32 * (warp & 1) + 16 * t + (lane >> 2) + 8 * h;
    const uint32_t bits = tl.bits[i][word];
    const float pm = tl.qp[i];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((bits >> (8 * s + 2 * (lane & 3) + e)) & 1u)
          lsum = lsum + acc[16 * t + 4 * s + 2 * h + e] * pm;
  }
  return lsum;
}

// f32: lsum += M_ij * (this lane's part of q_i . k_j) over the chunk, for
// the positive pairs of warp w's query rows w, w + 16, ...; lane l owns the
// chunk's channels [8l, 8l + 8).
__device__ __forceinline__ float positive_pair_logits(const float* qs, const float* ks,
                                                      const Tile& tl) {
  const int c = 8 * (threadIdx.x & 31);
  float lsum = 0.0f;
  if (c >= tl.width) return lsum;
  for (int i = threadIdx.x >> 5; i < tl.rows; i += kWarps) {
    float qv[8];
    load8(qs, i, c, qv);
    uint64_t bits = row_bits(tl.bits, i);
    while (bits != 0) {
      const int j = __ffsll((long long)bits) - 1;
      bits &= bits - 1;
      float kv[8];
      load8(ks, j, c, kv);
      float dot = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) dot = __fmaf_rn(qv[u], kv[u], dot);
      lsum = lsum + tl.qp[i] * dot;
    }
  }
  return lsum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_sums_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map, const T* __restrict__ q,
                     const T* __restrict__ k, const float* __restrict__ qx,
                     const float* __restrict__ qy, const float* __restrict__ kx,
                     const float* __restrict__ ky, const float* __restrict__ inv_diag,
                     const float* __restrict__ pts_mask, float* __restrict__ out, int N, int C,
                     float pos_ratio, int tma) {
  constexpr bool kTensorCores = sizeof(T) == 2;
  extern __shared__ unsigned char smem[];
  __shared__ float s_qx[kBlock], s_qy[kBlock], s_qp[kBlock];
  __shared__ float s_kx[kBlock], s_ky[kBlock], s_kp[kBlock];
  __shared__ uint32_t s_bits[kBlock][kBlock / 32];
  __shared__ float s_warp[2][kWarps];
  __shared__ uint64_t s_bar;

  const int tid = threadIdx.x;
  // before any load, which the init's fence would wait for
  if (tid == 0) mbar_init(&s_bar);
  const int b = blockIdx.x;
  T* qs = aligned_tiles<T>(smem);
  T* ks = qs + block_bytes<T>(C) / sizeof(T);
  const int64_t row0 = (int64_t)b * N;
  unsigned round = 0;

  float lsum = 0.0f;
  float msum = 0.0f;
  for (int i0 = 0; i0 < N; i0 += kBlock) {
    for (int j0 = 0; j0 < N; j0 += kBlock) {
      Tile tl{s_bits, s_qp, min(kBlock, N - i0), min(kBlock, N - j0), 0};
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
      // one pass even when C == 0: it evaluates the mask for the mask sum
      for (int c0 = 0; c0 < max(C, 1); c0 += kChunk) {
        tl.width = chunk_width(C - c0);
        if (round > 0) __syncthreads();  // the previous chunk's readers are done
        unsigned bytes = stage_block(qs, &q_map, q, row0 + i0, tl.rows, C, c0, tl.width,
                                     tma != 0, round > 0, &s_bar);
        bytes += stage_block(ks, &k_map, k, row0 + j0, tl.keys, C, c0, tl.width, tma != 0,
                             round > 0, &s_bar);
        if (tid == 0) mbar_arrive_expect(&s_bar, bytes);
        if (c0 == 0) {
          const float inv = inv_diag[b];
          load_centers(s_qx, s_qy, s_qp, qx, qy, pts_mask, row0 + i0, tl.rows, kBlock);
          load_centers(s_kx, s_ky, s_kp, kx, ky, nullptr, row0 + j0, tl.keys, 2 * kBlock);
          __syncthreads();  // centers visible; the copies are still in flight
          msum = msum + mask_bits(s_bits, s_qx, s_qy, s_qp, s_kx, s_ky, s_kp, tl.rows,
                                  tl.keys, inv, pos_ratio);
        }
        mbar_wait(&s_bar, round & 1u);
        ++round;
        __syncthreads();  // element copies and mask bits visible
        if constexpr (kTensorCores)
          accumulate_logits(qs, ks, tl, acc);
        else
          lsum = lsum + positive_pair_logits(qs, ks, tl);
      }
      if constexpr (kTensorCores) lsum = lsum + masked_logits(acc, tl);
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lsum = lsum + __shfl_xor_sync(kFull, lsum, o);
    msum = msum + __shfl_xor_sync(kFull, msum, o);
  }
  if ((tid & 31) == 0) {
    s_warp[0][tid >> 5] = lsum;
    s_warp[1][tid >> 5] = msum;
  }
  __syncthreads();
  if (tid == 0) {
    float l = 0.0f, m = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      l = l + s_warp[0][w];
      m = m + s_warp[1][w];
    }
    out[2 * b] = l;
    out[2 * b + 1] = m;
  }
}

template <typename T>
int launch(const void* q, const void* k, const float* qx, const float* qy, const float* kx,
           const float* ky, const float* inv_diag, const float* pts_mask, float* out, int B,
           int N, int C, float pos_ratio, cudaStream_t stream) {
  static size_t granted[64];
  const size_t smem = 2 * (size_t)block_bytes<T>(C) + 1024;
  cudaError_t e = allow_shared(pair_sums_kernel<T>, smem, granted);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap q_map, k_map;
  const int tma = row_tensor_map<T>(&q_map, q, (int64_t)B * N, C) &&
                  row_tensor_map<T>(&k_map, k, (int64_t)B * N, C);
  pair_sums_kernel<T><<<B, kThreads, smem, stream>>>(
      q_map, k_map, static_cast<const T*>(q), static_cast<const T*>(k), qx, qy, kx, ky,
      inv_diag, pts_mask, out, N, C, pos_ratio, tma);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k [B, N, C] (bf16 when is_bf16, else f32); qx, qy, kx, ky, pts_mask
// [B, N] f32 (pts_mask may be null); inv_diag [B] f32; out [B, 2] f32. All
// contiguous on one device, B * N < 2^31. Returns the launch's cudaError_t.
extern "C" int pixflow_pair_sums(const void* q, const void* k, const float* qx,
                                 const float* qy, const float* kx, const float* ky,
                                 const float* inv_diag, const float* pts_mask, float* out, int B,
                                 int N, int C, float pos_ratio, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, qx, qy, kx, ky, inv_diag, pts_mask, out, B, N, C,
                                 pos_ratio, s);
  return launch<float>(q, k, qx, qy, kx, ky, inv_diag, pts_mask, out, B, N, C, pos_ratio, s);
}
