// Tap logic shared by the K2 family (point_sample.cu, flow_up_points.cu,
// grid_sample_bwd.cu): the composite weights of one axis of the align-corners
// `up`x upsample, the two-channel read built from them, and the four taps of a
// read at a normalised grid point. Every kernel of the family includes this
// header, so a point's weights and sums are computed the same way wherever it
// is read, and its backward scatters to the texels its forward read.
//
// Numerics. The weights follow the float32 op order of the plain version's
// composite_weights_1d: i0 = floor(p), a = p - i0, the v0/v1 validity tests
// on n_fine, s = i * scale with `scale` the float32 value of
// (n_coarse-1)/(n_fine-1), t = max(0, 1 - |s - j|),
// w = (v0 ? (1-a)*t0 : 0) + (v1 ? a*t1 : 0). The sum runs over y first, then
// over x, each in ascending index, like the plain version's two contractions.
// Every including file is compiled with --fmad=false, so no a*b+c becomes an
// FMA.

#pragma once

#include <cuda_runtime.h>

namespace pixflow {

// Coarse indices and composite weights of one axis; j[t] = -1 marks a tap
// outside [0, n_coarse - 1], which the dense weight row does not have. NT = 2
// serves up == 1 (scale 1: taps i0 and i0 + 1); NT = 3 serves up > 1, where
// the tents around s0 and s1 = s0 + scale cover floor(s0) .. floor(s0) + 2.
template <int NT>
__device__ __forceinline__ void axis_taps(float p, int n_fine, int n_coarse,
                                          float scale, int* j, float* w) {
  const float i0 = floorf(p);
  const float a = p - i0;
  const bool v0 = (i0 >= 0.0f) && (i0 <= (float)(n_fine - 1));
  const bool v1 = (i0 >= -1.0f) && (i0 <= (float)(n_fine - 2));
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    j[t] = -1;
    w[t] = 0.0f;
  }
  if (!v0 && !v1) return;  // i0 is bounded from here on
  const float s0 = i0 * scale;
  const float s1 = (i0 + 1.0f) * scale;
  const int j0 = (int)floorf(s0);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int jj = j0 + t;
    if (jj < 0 || jj > n_coarse - 1) continue;
    const float jf = (float)jj;
    const float t0 = fmaxf(0.0f, 1.0f - fabsf(s0 - jf));
    const float t1 = fmaxf(0.0f, 1.0f - fabsf(s1 - jf));
    const float w0 = v0 ? (1.0f - a) * t0 : 0.0f;
    const float w1 = v1 ? a * t1 : 0.0f;
    j[t] = jj;
    w[t] = w0 + w1;
  }
}

// U_up(field)(px, py) of one sample's two-channel field fb [H, W, 2], one
// 8-byte load per tap through the read-only path. Each channel is summed as
// the scalar loop of point_sample.cu sums it.
template <int NT>
__device__ __forceinline__ float2 sample2(const float* __restrict__ fb, int H,
                                          int W, int up, float scale_y,
                                          float scale_x, float px, float py) {
  int jy[NT], jx[NT];
  float wy[NT], wx[NT];
  axis_taps<NT>(py, up * H, H, scale_y, jy, wy);
  axis_taps<NT>(px, up * W, W, scale_x, jx, wx);
  const float2* f2 = reinterpret_cast<const float2*>(fb);
  float ax = 0.0f, ay = 0.0f;
#pragma unroll
  for (int tx = 0; tx < NT; ++tx) {
    if (jx[tx] < 0) continue;
    float cx = 0.0f, cy = 0.0f;
#pragma unroll
    for (int ty = 0; ty < NT; ++ty) {
      if (jy[ty] < 0) continue;
      const float2 v = __ldg(f2 + jy[ty] * W + jx[tx]);
      cx = cx + wy[ty] * v.x;
      cy = cy + wy[ty] * v.y;
    }
    ax = ax + wx[tx] * cx;
    ay = ay + wx[tx] * cy;
  }
  return make_float2(ax, ay);
}

// up == 1: the composite weights reduce to the bilinear pair (1 - a, a) at
// i0 and i0 + 1, bit for bit (scale is 1, so the tents there are exactly 1
// and 0), and a tap is valid exactly when its index is inside the field.
__device__ __forceinline__ float2 sample2_bilinear(const float* __restrict__ fb,
                                                   int H, int W, float px,
                                                   float py) {
  const float ix = floorf(px), iy = floorf(py);
  const float ax = px - ix, ay = py - iy;
  const float wx[2] = {1.0f - ax, ax}, wy[2] = {1.0f - ay, ay};
  // clamped before the conversion, so that a far point misses every tap
  const int jx = (int)fmaxf(fminf(ix, (float)W), -2.0f);
  const int jy = (int)fmaxf(fminf(iy, (float)H), -2.0f);
  const float2* f2 = reinterpret_cast<const float2*>(fb);
  float sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int tx = 0; tx < 2; ++tx) {
    const int x = jx + tx;
    if (x < 0 || x > W - 1) continue;
    float cx = 0.0f, cy = 0.0f;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      const int y = jy + ty;
      if (y < 0 || y > H - 1) continue;
      const float2 v = __ldg(f2 + y * W + x);
      cx = cx + wy[ty] * v.x;
      cy = cy + wy[ty] * v.y;
    }
    sx = sx + wx[tx] * cx;
    sy = sy + wx[tx] * cy;
  }
  return make_float2(sx, sy);
}

// The four bilinear taps of one read of grid_sample (align_corners=True,
// zeros padding) at the normalised point g of an H x W field, in the plain
// gather's op order (ops/resample.py:grid_sample): x = ((g + 1) * 0.5) *
// (W - 1), weights (1-wy)(1-wx), (1-wy)wx, wy(1-wx), wy*wx for the taps
// (x0, y0), (x1, y0), (x0, y1), (x1, y1). ok[t] says whether tap t lies
// inside the field; off[t] is its texel index y * W + x there (else 0). The
// grid-sample entry's forward and its backward (grid_sample_bwd.cu) take
// their taps from here, so both see the same texels and weights.
__device__ __forceinline__ void grid_taps(float2 g, int H, int W, float* tw,
                                          int* off, bool* ok) {
  const float x = (g.x + 1.0f) * 0.5f * (float)(W - 1);
  const float y = (g.y + 1.0f) * 0.5f * (float)(H - 1);
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wx = x - x0, wy = y - y0;
  tw[0] = (1.0f - wy) * (1.0f - wx);
  tw[1] = (1.0f - wy) * wx;
  tw[2] = wy * (1.0f - wx);
  tw[3] = wy * wx;
  const float tx[4] = {x0, x1, x0, x1};
  const float ty[4] = {y0, y0, y1, y1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    ok[t] = tx[t] >= 0.0f && tx[t] <= (float)(W - 1) && ty[t] >= 0.0f &&
            ty[t] <= (float)(H - 1);
    off[t] = ok[t] ? ((int)ty[t] * W + (int)tx[t]) : 0;
  }
}

}  // namespace pixflow
