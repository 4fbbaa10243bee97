// K2 point_sample: bilinear reads of the align-corners `up`x upsample of a
// coarse channels-last field, at fine-pixel points, without materialising the
// upsample (zeros padding, no magnitude scale).
//
// Replaces the TPU kernel pixflow_tpu/ops/pallas/warp.py:_warp_kernel
// (launched by tent_warp_pallas): up == 1 is exactly that kernel's function,
// grid_sample(align_corners=True, padding='zeros') at pixel points. up == 8 is
// pixflow_tpu/ops/flow_points.py:sample_up, which the lazy flow_up path calls
// K times per advect_up and which the JAX package evaluates with dense
// composite-weight einsums over the whole coarse axis.
//
// What bounds it on an H100: bytes and launch latency. Each point touches at
// most 3 coarse indices per axis (2 when up == 1), so a point reads at most
// 9 taps x C floats and writes C floats: 12544 points x 9 taps x 2 channels
// is under 1 MB, well under a microsecond of HBM time at 3.35 TB/s, and the
// field (7.4 MB at 64 x 90 x 160 x 2) stays in the 50 MB L2 across the K
// launches. The TPU kernel's tent matrices ([chunk, H] x [H, C*W] on the MXU)
// do ~H*W/9 times the arithmetic this gather does, and its sequential grid
// has no counterpart here: one thread per (b, n) point, weights in
// registers, no shared memory, no atomics.
//
// Numerics. The lazy flow_up composition amplifies ulp-level position noise
// chaotically (flow_points.py, advect_up), so the weights are computed with
// the exact float32 op order of composite_weights_1d: i0 = floor(p),
// a = p - i0, the v0/v1 validity tests on n_fine, s = i * scale with `scale`
// the float32 value of (n_coarse-1)/(n_fine-1) handed in by the wrapper,
// t = max(0, 1 - |s - j|), w = (v0 ? (1-a)*t0 : 0) + (v1 ? a*t1 : 0). The sum
// runs over y first, then over x, each in ascending index, like the two
// einsums. This file is compiled with --fmad=false so that no a*b+c is
// contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 3;
constexpr int kThreads = 256;

// Coarse indices and composite weights of one axis; j[t] = -1 marks a tap
// outside [0, n_coarse - 1], which the dense weight row does not have.
__device__ __forceinline__ void axis_taps(float p, int n_fine, int n_coarse,
                                          float scale, int ntaps, int* j,
                                          float* w) {
  const float i0 = floorf(p);
  const float a = p - i0;
  const bool v0 = (i0 >= 0.0f) && (i0 <= (float)(n_fine - 1));
  const bool v1 = (i0 >= -1.0f) && (i0 <= (float)(n_fine - 2));
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    j[t] = -1;
    w[t] = 0.0f;
  }
  if (!v0 && !v1) return;  // i0 is bounded from here on
  const float s0 = i0 * scale;
  const float s1 = (i0 + 1.0f) * scale;
  const int j0 = (int)floorf(s0);
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    const int jj = j0 + t;
    if (t >= ntaps || jj < 0 || jj > n_coarse - 1) continue;
    const float jf = (float)jj;
    const float t0 = fmaxf(0.0f, 1.0f - fabsf(s0 - jf));
    const float t1 = fmaxf(0.0f, 1.0f - fabsf(s1 - jf));
    const float w0 = v0 ? (1.0f - a) * t0 : 0.0f;
    const float w1 = v1 ? a * t1 : 0.0f;
    j[t] = jj;
    w[t] = w0 + w1;
  }
}

__global__ void point_sample_kernel(const float* __restrict__ field,
                                    const float* __restrict__ pts,
                                    float* __restrict__ out, int B, int H,
                                    int W, int C, int N, int up, float scale_y,
                                    float scale_x) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * N) return;
  const int64_t b = idx / N;
  const float px = pts[2 * idx];
  const float py = pts[2 * idx + 1];
  // scale == 1 (up == 1): taps i0 and i0 + 1; otherwise scale < 1 and the
  // two tents around s0 and s1 = s0 + scale cover floor(s0) .. floor(s0) + 2
  const int ntaps = up == 1 ? 2 : 3;

  int jy[kMaxTaps], jx[kMaxTaps];
  float wy[kMaxTaps], wx[kMaxTaps];
  axis_taps(py, up * H, H, scale_y, ntaps, jy, wy);
  axis_taps(px, up * W, W, scale_x, ntaps, jx, wx);

  const float* fb = field + b * H * W * C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int tx = 0; tx < kMaxTaps; ++tx) {
      if (jx[tx] < 0) continue;
      float col = 0.0f;
#pragma unroll
      for (int ty = 0; ty < kMaxTaps; ++ty) {
        if (jy[ty] < 0) continue;
        col = col + wy[ty] * fb[((int64_t)jy[ty] * W + jx[tx]) * C + c];
      }
      acc = acc + wx[tx] * col;
    }
    out[idx * C + c] = acc;
  }
}

}  // namespace

// field [B, H, W, C] f32, pts [B, N, 2] (x, y) f32, out [B, N, C] f32, all
// contiguous on one device. Returns cudaGetLastError() after the launch.
extern "C" int pixflow_point_sample(const float* field, const float* pts,
                                    float* out, int B, int H, int W, int C,
                                    int N, int up, float scale_y,
                                    float scale_x, void* stream) {
  const int64_t total = (int64_t)B * N;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  point_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      field, pts, out, B, H, W, C, N, up, scale_y, scale_x);
  return (int)cudaGetLastError();
}
