// The gradient of K2's grid-sample entry with respect to the sampled field:
//
//   grad_img[n, y, x, c] = sum over the taps of row n's points that read
//                          texel (y, x) of  tap weight * grad_out[n, p, c]
//
// for img [N, H, W, C], grid [N, P, 2] (normalised, align_corners=True, zeros
// padding) and grad_out [N, P, C]. No gradient for the grid: RAFT detaches its
// coordinates every iteration (pixflow_tpu/models/raft/raft.py:131), so the
// wrapper refuses a grid that requires one.
//
// Replaces no Pallas kernel: in the JAX package this is XLA's autodiff of
// lookup_corr_mxu's einsums / grid_sample's gather (pixflow_tpu/models/raft/
// corr.py:85-128, ops/resample.py:grid_sample). In the port it is the
// backward of RAFT's correlation lookup (models/raft/corr.py), 4 launches a
// refinement iteration of a RAFT train step.
//
// What bounds it on an H100: bytes. The whole gradient field is written,
// zeros included (at RAFT-basic's chairs crop, batch 8, 343.6 MB a lookup of
// four levels), against 88.7 MB of grad_out and grid read.
//
// Design: one warp a row n (a RAFT query pixel), several rows a block. The
// warp zeroes its row in shared memory, adds every tap's contribution there,
// and writes the row out once with coalesced stores: no atomics, no zero-fill
// pass over device memory, and no other warp touches the row. The sums run in
// the plain version's order (ops/kernels/point_sample.py:
// grid_sample_backward_plain, four index_add_ calls): tap 0 of every point in
// point order, then tap 1, tap 2, tap 3. Points are taken 32 at a time, a lane
// each (a round). When the round's lanes hit distinct texels, each lane adds
// its own term. When some share a texel (a general grid with many points on
// one texel), those lanes are grouped by __match_any_sync and the group's
// lowest lane adds their terms in lane order. So each texel's sum has a fixed
// order, the same from run to run, whatever the grid. Which case a round is
// takes a byte per texel in shared memory: every lane writes its lane number
// at its texel, and a lane that reads back another's has company.
// __match_any_sync is the slow instruction here (32 distinct values a round
// cost about as much as the rest of the round several times over), and RAFT's
// window, a regular integer grid about one centroid, never needs it: a tap of
// two of its points never meets on one texel. Each term is the tap weight
// times grad_out, as the plain version forms it; compiled with --fmad=false,
// so no product is fused into the following add.
//
// Limits (the wrapper checks): H * W * C floats of a row, H * W bytes and 32
// floats of scratch fit the block's shared memory (227 KB: a 90 x 160
// level-0 row of a 720 x 1280 RAFT is 57.6 KB + 14.4 KB); every element count
// below 2^31 (32-bit offsets, as the forward).

#include <cuda_runtime.h>

#include "point_sample.cuh"

namespace {

constexpr int kMaxRowsPerBlock = 4;
constexpr int kMaxSharedBytes = 232448;  // an H100 block's opt-in maximum

// Shared memory of one row, in floats: the row's sums, 32 terms, a byte a
// texel rounded up to whole floats.
__host__ __device__ __forceinline__ int row_floats(int H, int W, int C) {
  return H * W * C + 32 + (H * W + 3) / 4;
}

// Rows a block for an H x W x C row: as many as fit the shared memory, at most
// kMaxRowsPerBlock; 0 when one row does not fit.
int rows_per_block(int H, int W, int C) {
  const long long rows = kMaxSharedBytes / (4LL * row_floats(H, W, C));
  return (int)(rows < kMaxRowsPerBlock ? rows : kMaxRowsPerBlock);
}

__global__ void grid_sample_bwd_kernel(const float* __restrict__ grad_out,
                                       const float2* __restrict__ grid,
                                       float* __restrict__ grad_img, int N,
                                       int H, int W, int C, int P) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= N) return;  // the whole warp: no block-wide barrier follows
  const int row_len = H * W * C;
  float* acc = smem + warp * row_floats(H, W, C);
  float* terms = acc + row_len;  // one term a lane
  unsigned char* owner = reinterpret_cast<unsigned char*>(terms + 32);  // a byte a texel
  for (int i = lane; i < row_len; i += 32) acc[i] = 0.0f;
  __syncwarp();

  const float2* g = grid + row * P;
  const float* go = grad_out + row * P * C;
  for (int t = 0; t < 4; ++t) {
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      int key = -1 - lane;  // unique: a lane with no tap matches no other
      float wt = 0.0f;
      if (p < P) {
        float tw[4];
        int off[4];
        bool ok[4];
        pixflow::grid_taps(__ldg(g + p), H, W, tw, off, ok);
        if (ok[t]) {
          key = off[t];
          wt = tw[t];
        }
      }
      if (key >= 0) owner[key] = (unsigned char)lane;
      __syncwarp();
      const bool shared = __any_sync(0xffffffffu, key >= 0 && owner[key] != lane);
      if (!shared) {  // distinct texels: each lane adds its own terms
        if (key >= 0) {
          for (int c = 0; c < C; ++c)
            acc[key * C + c] = acc[key * C + c] + wt * __ldg(go + p * C + c);
        }
        __syncwarp();
        continue;
      }
      const unsigned group = __match_any_sync(0xffffffffu, key);
      const bool leader = key >= 0 && __ffs(group) - 1 == lane;
      for (int c = 0; c < C; ++c) {
        terms[lane] = key >= 0 ? wt * __ldg(go + p * C + c) : 0.0f;
        __syncwarp();
        if (leader) {
          float v = acc[key * C + c];
          for (unsigned m = group; m; m &= m - 1) v = v + terms[__ffs(m) - 1];
          acc[key * C + c] = v;
        }
        __syncwarp();
      }
    }
  }

  float* out = grad_img + row * row_len;
  for (int i = lane; i < row_len; i += 32) out[i] = acc[i];
}

}  // namespace

// grad_out [N, P, C] f32, grid [N, P, 2] normalised (x, y) f32, grad_img
// [N, H, W, C] f32 (written whole), all contiguous on one device, every
// element count below 2^31 (the wrapper checks). Returns cudaGetLastError()
// after the launch.
extern "C" int pixflow_grid_sample_bwd(const float* grad_out, const float* grid,
                                       float* grad_img, int N, int H, int W,
                                       int C, int P, void* stream) {
  const int rows = rows_per_block(H, W, C);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = rows * row_floats(H, W, C) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_sample_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + rows - 1) / rows;
  grid_sample_bwd_kernel<<<blocks, 32 * rows, smem, (cudaStream_t)stream>>>(
      grad_out, reinterpret_cast<const float2*>(grid), grad_img, N, H, W, C,
      P);
  return (int)cudaGetLastError();
}
