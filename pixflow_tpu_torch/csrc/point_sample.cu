// K2 point_sample: bilinear reads of the align-corners `up`x upsample of a
// coarse channels-last field, at fine-pixel points, without materialising the
// upsample (zeros padding, no magnitude scale).
//
// Replaces the TPU kernel pixflow_tpu/ops/pallas/warp.py:_warp_kernel
// (launched by tent_warp_pallas): up == 1 is exactly that kernel's function,
// grid_sample(align_corners=True, padding='zeros') at pixel points. up == 8 is
// pixflow_tpu/ops/flow_points.py:sample_up, which the JAX package evaluates
// with dense composite-weight einsums over the whole coarse axis. The train
// step's lazy flow_up path no longer calls it: flow_up_points.cu runs all of
// that path's reads in one launch per direction, with the same tap logic
// (point_sample.cuh).
//
// What bounds it on an H100: launch latency, then bytes. Each point touches
// at most 3 coarse indices per axis (2 when up == 1), so a point reads at
// most 9 taps x C floats and writes C floats: 12544 points x 9 taps x 2
// channels is under 1 MB, well under a microsecond of HBM time at 3.35 TB/s.
// The TPU kernel's tent matrices ([chunk, H] x [H, C*W] on the MXU) do ~H*W/9
// times the arithmetic this gather does, and its sequential grid has no
// counterpart here: one thread per (b, n) point, weights in registers, no
// shared memory, no atomics. What the design does about the latency: 32-bit
// index arithmetic, a two-tap path for up == 1 (for C == 2 the plain bilinear
// pair, which the composite weights equal there), and for C == 2 (flows) one
// 8-byte load per tap and one 8-byte store per point.
//
// Numerics: see point_sample.cuh; compiled with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "point_sample.cuh"

namespace {

constexpr int kThreads = 128;

template <int NT>
__global__ void point_sample_kernel_c2(const float* __restrict__ field,
                                       const float2* __restrict__ pts,
                                       float2* __restrict__ out, int total,
                                       int H, int W, int N, int up,
                                       float scale_y, float scale_x) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int b = idx / N;
  const float2 p = __ldg(pts + idx);
  const float* fb = field + b * H * W * 2;
  if constexpr (NT == 2) {
    out[idx] = pixflow::sample2_bilinear(fb, H, W, p.x, p.y);
  } else {
    out[idx] = pixflow::sample2<NT>(fb, H, W, up, scale_y, scale_x, p.x, p.y);
  }
}

template <int NT>
__global__ void point_sample_kernel(const float* __restrict__ field,
                                    const float* __restrict__ pts,
                                    float* __restrict__ out, int total, int H,
                                    int W, int C, int N, int up, float scale_y,
                                    float scale_x) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int b = idx / N;
  int jy[NT], jx[NT];
  float wy[NT], wx[NT];
  pixflow::axis_taps<NT>(pts[2 * idx + 1], up * H, H, scale_y, jy, wy);
  pixflow::axis_taps<NT>(pts[2 * idx], up * W, W, scale_x, jx, wx);
  const float* fb = field + b * H * W * C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int tx = 0; tx < NT; ++tx) {
      if (jx[tx] < 0) continue;
      float col = 0.0f;
#pragma unroll
      for (int ty = 0; ty < NT; ++ty) {
        if (jy[ty] < 0) continue;
        col = col + wy[ty] * __ldg(fb + (jy[ty] * W + jx[tx]) * C + c);
      }
      acc = acc + wx[tx] * col;
    }
    out[idx * C + c] = acc;
  }
}

template <int NT>
void launch(const float* field, const float* pts, float* out, int B, int H,
            int W, int C, int N, int up, float scale_y, float scale_x,
            cudaStream_t stream) {
  const int total = B * N;
  const int blocks = (total + kThreads - 1) / kThreads;
  const uintptr_t addr = (uintptr_t)field | (uintptr_t)pts | (uintptr_t)out;
  if (C == 2 && addr % 8 == 0) {
    point_sample_kernel_c2<NT><<<blocks, kThreads, 0, stream>>>(
        field, reinterpret_cast<const float2*>(pts),
        reinterpret_cast<float2*>(out), total, H, W, N, up, scale_y, scale_x);
  } else {
    point_sample_kernel<NT><<<blocks, kThreads, 0, stream>>>(
        field, pts, out, total, H, W, C, N, up, scale_y, scale_x);
  }
}

}  // namespace

// field [B, H, W, C] f32, pts [B, N, 2] (x, y) f32, out [B, N, C] f32, all
// contiguous on one device, every element count below 2^31 (the wrapper
// checks). Returns cudaGetLastError() after the launch.
extern "C" int pixflow_point_sample(const float* field, const float* pts,
                                    float* out, int B, int H, int W, int C,
                                    int N, int up, float scale_y,
                                    float scale_x, void* stream) {
  if (up == 1) {
    launch<2>(field, pts, out, B, H, W, C, N, up, scale_y, scale_x,
              (cudaStream_t)stream);
  } else {
    launch<3>(field, pts, out, B, H, W, C, N, up, scale_y, scale_x,
              (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
