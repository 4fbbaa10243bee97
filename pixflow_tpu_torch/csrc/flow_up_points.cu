// flow_up_points: the lazy full-res flow_up evaluation of one direction in one
// launch. The H100 redesign of K2's only use on the train step's path.
//
// Replaces, for the port's main path, the K2 launches of the TPU kernel
// pixflow_tpu/ops/pallas/warp.py:_warp_kernel as pixflow_tpu/ops/
// flow_points.py:flow_up_warp_points uses its function (sample_up inside
// advect_up): 3 advects x K flows = 15 point_sample launches per direction,
// each with ~20 small PyTorch ops around it. One launch computes, per query
// point (mode "warp", flow_up_warp_points):
//   - the query mapped from original-image pixels to fine pixels;
//   - the composed flow there, a 4-tap blend of K-step trajectories
//     (composed_flow_at), and the warped point out = x + f / (wf / w_orig);
//   - the nearest fine pixel (round half to even), its validity, and the
//     cycle test of cycle_mask_at there: the forward trajectory, in_bounds,
//     the 4-tap blend of backward trajectories at its end, the alpha test.
// Mode "mask" (mask_ratio_estimate) evaluates the cycle test alone at given
// fine points.
//
// What bounds it on an H100: dependent gather latency, and before this
// kernel, launches. A point's 9 trajectories (4 composed-flow taps, the
// forward cycle trajectory, 4 backward taps) are K = 5 dependent reads each;
// the bytes are small (at most 9 taps x 8 B per read, the recipe's 3136
// points read < 10 MB, mostly the same coarse cells, from a 7.4 MB field that
// stays in the 50 MB L2). The design:
//   - 8 lanes per query point. Lanes 0-3 advect the 4 composed-flow taps;
//     lanes 4-7 all advect the forward cycle trajectory (the same addresses,
//     so one load serves the four), then each advects one backward tap from
//     that trajectory's end. The critical path is 2K dependent reads, not 9K.
//   - The blends gather the 4 products of a group with __shfl_sync and add
//     them in ascending tap order, the order of the plain version.
//   - 8-byte float2 tap loads through the read-only path (C = 2), 32-bit
//     offsets inside a (k, b) slab.
//   - Outputs in K1's input layout: out_x, out_y and the mask as float32
//     [B, N], so nothing sits between this kernel and pair_sums.
// Mode "mask" uses groups of 4 lanes, all on the cycle test.
//
// Numerics. Composition amplifies ulp-level position differences, so every
// step repeats the plain version's float32 op order (ops/kernels/
// flow_up_points.py): the normalise -> denormalise round trip before each
// read, p + 8 * s, the bilinear taps, round half to even (rintf), strict
// < 1 for in_bounds, and the threshold constant a2 rounded to float32 by the
// wrapper. A division by a constant is a multiplication by its float32
// reciprocal, as XLA compiles the JAX package's jitted step; a division by
// data (the original image size) is a true IEEE division. Compiled with
// --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "point_sample.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* flows;      // [K, B, H, W, 2]
  const float* flows_rev;  // [K, B, H, W, 2], or null: no cycle mask
  const float* x;          // warp mode: [B, N] original-image pixels
  const float* y;
  const float* w_orig;     // warp mode: [B], element stride orig_stride
  const float* h_orig;
  const float* pts;        // mask mode: [B, N, 2] fine pixels
  float* out_x;            // warp mode: [B, N]
  float* out_y;
  float* mask;             // [B, N], 1.0 where trusted; null when unmasked
  int K, B, N, H, W, orig_stride, is_norm;
  float scale_y, scale_x;  // float32 (H-1)/(8H-1), (W-1)/(8W-1)
  float alpha1, a2;
};

struct Grid {  // the fine grid's constants, as the plain version rounds them
  float wfm1, hfm1, inv_w, inv_h;
};

// One fine point through the K flows (advect_up): the composed flow there,
// in fine pixels, or in normalized units when is_norm.
__device__ float2 advect(const Params& p, const Grid& g,
                         const float* __restrict__ flows, int b, float px,
                         float py) {
  const int slab = p.H * p.W * 2;
  const size_t kstride = (size_t)p.B * slab;
  const float* fb = flows + (size_t)b * slab;
  if (p.is_norm) {
    const float c0x = (2.0f * px) * g.inv_w - 1.0f;
    const float c0y = (2.0f * py) * g.inv_h - 1.0f;
    float cx = c0x, cy = c0y;
    for (int k = 0; k < p.K; ++k, fb += kstride) {
      const float qx = ((cx + 1.0f) * 0.5f) * g.wfm1;
      const float qy = ((cy + 1.0f) * 0.5f) * g.hfm1;
      const float2 s =
          pixflow::sample2<3>(fb, p.H, p.W, 8, p.scale_y, p.scale_x, qx, qy);
      cx = cx + (2.0f * (8.0f * s.x)) * g.inv_w;
      cy = cy + (2.0f * (8.0f * s.y)) * g.inv_h;
    }
    return make_float2(cx - c0x, cy - c0y);
  }
  float x = px, y = py;
  for (int k = 0; k < p.K; ++k, fb += kstride) {
    const float nx = (2.0f * x) * g.inv_w - 1.0f;
    const float ny = (2.0f * y) * g.inv_h - 1.0f;
    const float qx = ((nx + 1.0f) * 0.5f) * g.wfm1;
    const float qy = ((ny + 1.0f) * 0.5f) * g.hfm1;
    const float2 s =
        pixflow::sample2<3>(fb, p.H, p.W, 8, p.scale_y, p.scale_x, qx, qy);
    x = x + 8.0f * s.x;
    y = y + 8.0f * s.y;
  }
  return make_float2(x - px, y - py);
}

// Tap t (x-fastest: (x0,y0), (x1,y0), (x0,y1), (x1,y1)) of the bilinear read
// at (px, py) on an (n_y, n_x) grid, with zeros-padding validity folded into
// its weight (_taps_1d / _bilinear_taps).
__device__ __forceinline__ float tap(float px, float py, int n_x, int n_y,
                                     int t, float* tx, float* ty) {
  const float ix = floorf(px), iy = floorf(py);
  const float ax = px - ix, ay = py - iy;
  const bool hi_x = t & 1, hi_y = t >> 1;
  const float wx = hi_x ? ((ix >= -1.0f && ix <= (float)(n_x - 2)) ? ax : 0.0f)
                        : ((ix >= 0.0f && ix <= (float)(n_x - 1)) ? 1.0f - ax : 0.0f);
  const float wy = hi_y ? ((iy >= -1.0f && iy <= (float)(n_y - 2)) ? ay : 0.0f)
                        : ((iy >= 0.0f && iy <= (float)(n_y - 1)) ? 1.0f - ay : 0.0f);
  *tx = hi_x ? ix + 1.0f : ix;
  *ty = hi_y ? iy + 1.0f : iy;
  return wx * wy;
}

// ((v0 + v1) + v2) + v3 over the lanes first .. first+3 of a group of G.
template <int G>
__device__ __forceinline__ float blend4(float v, int first) {
  const float v0 = __shfl_sync(kFull, v, first, G);
  const float v1 = __shfl_sync(kFull, v, first + 1, G);
  const float v2 = __shfl_sync(kFull, v, first + 2, G);
  const float v3 = __shfl_sync(kFull, v, first + 3, G);
  return ((v0 + v1) + v2) + v3;
}

template <bool kWarp>
__global__ void __launch_bounds__(kThreads)
    flow_up_points_kernel(const Params p) {
  constexpr int G = kWarp ? 8 : 4;  // lanes per query point
  constexpr int kCyc = kWarp ? 4 : 0;  // first lane of the cycle test
  const int wf = 8 * p.W, hf = 8 * p.H;
  Grid g;
  g.wfm1 = (float)(wf - 1);
  g.hfm1 = (float)(hf - 1);
  g.inv_w = 1.0f / g.wfm1;
  g.inv_h = 1.0f / g.hfm1;

  const int total = p.B * p.N;
  const int gid = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool live = gid < total;
  // a group past the end computes the last point and stores nothing, so that
  // every lane of the warp reaches the shuffles
  const int pt = live ? gid : total - 1;
  const int lane = threadIdx.x & (G - 1);
  const int t = lane & 3;
  const bool cyc = lane >= kCyc;
  const bool masked = p.flows_rev != nullptr;
  const int b = pt / p.N;

  // --- phase 1: the start points and the trajectories through `flows` ---
  float xo = 0.0f, yo = 0.0f, wo = 0.0f, ho = 0.0f, sx = 0.0f, sy = 0.0f, tw = 0.0f;
  if (kWarp) {
    xo = __ldg(p.x + pt);
    yo = __ldg(p.y + pt);
    wo = __ldg(p.w_orig + b * p.orig_stride);
    ho = __ldg(p.h_orig + b * p.orig_stride);
    // original-image px -> fine px (normalize by the original size, then
    // denormalize by the fine size)
    const float gx = (2.0f * xo) / (wo - 1.0f) - 1.0f;
    const float gy = (2.0f * yo) / (ho - 1.0f) - 1.0f;
    const float cx = ((gx + 1.0f) * 0.5f) * g.wfm1;
    const float cy = ((gy + 1.0f) * 0.5f) * g.hfm1;
    if (cyc) {
      sx = rintf(cx);
      sy = rintf(cy);
    } else {
      tw = tap(cx, cy, wf, hf, t, &sx, &sy);
    }
  } else {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p.pts) + pt);
    sx = q.x;
    sy = q.y;
  }
  float2 v = make_float2(0.0f, 0.0f);
  if (!cyc || masked) v = advect(p, g, p.flows, b, sx, sy);

  // --- the composed flow and the warped point (warp mode, lanes 0-3) ---
  if (kWarp) {
    float fx = v.x, fy = v.y;
    if (p.is_norm) {  // normalized -> pixel units
      fx = fx * (g.wfm1 * 0.5f);
      fy = fy * (g.hfm1 * 0.5f);
    }
    const float bx = blend4<G>(fx * tw, 0);
    const float by = blend4<G>(fy * tw, 0);
    if (live && lane == 0) {
      p.out_x[pt] = xo + bx / ((float)wf / wo);
      p.out_y[pt] = yo + by / ((float)hf / ho);
    }
  }
  if (!masked) return;

  // --- phase 2: the cycle test (lanes kCyc..kCyc+3) ---
  float fnx = 0.0f, fny = 0.0f, qx = 0.0f, qy = 0.0f;
  bool in_bounds = false;
  if (cyc) {
    fnx = p.is_norm ? v.x : (2.0f * v.x) * g.inv_w;
    fny = p.is_norm ? v.y : (2.0f * v.y) * g.inv_h;
    const float c1x = ((2.0f * sx) * g.inv_w - 1.0f) + fnx;
    const float c1y = ((2.0f * sy) * g.inv_h - 1.0f) + fny;
    in_bounds = fabsf(c1x) < 1.0f && fabsf(c1y) < 1.0f;
    const float rx = ((c1x + 1.0f) * 0.5f) * g.wfm1;
    const float ry = ((c1y + 1.0f) * 0.5f) * g.hfm1;
    float ux, uy;
    const float w = tap(rx, ry, wf, hf, t, &ux, &uy);
    const float2 bw = advect(p, g, p.flows_rev, b, ux, uy);
    qx = (p.is_norm ? bw.x : (2.0f * bw.x) * g.inv_w) * w;
    qy = (p.is_norm ? bw.y : (2.0f * bw.y) * g.inv_h) * w;
  }
  const float bx = blend4<G>(qx, kCyc);
  const float by = blend4<G>(qy, kCyc);
  if (!live || lane != kCyc) return;
  const float dx = fnx + bx, dy = fny + by;
  const float cycle_sq = dx * dx + dy * dy;
  const float eps =
      p.alpha1 * ((fnx * fnx + fny * fny) + (bx * bx + by * by)) + p.a2;
  bool m = in_bounds && (cycle_sq - eps) <= 0.0f;
  if (kWarp) {  // the nearest read's zeros padding
    m = m && sx >= 0.0f && sx <= g.wfm1 && sy >= 0.0f && sy <= g.hfm1;
  }
  p.mask[pt] = m ? 1.0f : 0.0f;
}

int launch(const Params& p, bool warp, cudaStream_t stream) {
  const int groups = p.B * p.N;
  const int lanes = warp ? 8 : 4;
  const long threads = (long)groups * lanes;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (warp) {
    flow_up_points_kernel<true><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    flow_up_points_kernel<false><<<blocks, kThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Warp mode. flows, flows_rev [K, B, H, W, 2] f32 contiguous (flows_rev and
// mask null when unmasked); x, y, out_x, out_y, mask [B, N] f32 contiguous;
// w_orig, h_orig [B] f32 with element stride orig_stride. Returns
// cudaGetLastError() after the launch.
extern "C" int pixflow_flow_up_points(const float* flows,
                                      const float* flows_rev, const float* x,
                                      const float* y, const float* w_orig,
                                      const float* h_orig, int orig_stride,
                                      float* out_x, float* out_y, float* mask,
                                      int K, int B, int N, int H, int W,
                                      float scale_y, float scale_x,
                                      float alpha1, float a2, int is_norm,
                                      void* stream) {
  Params p{flows, flows_rev, x, y, w_orig, h_orig, nullptr, out_x, out_y,
           mask, K, B, N, H, W, orig_stride, is_norm, scale_y, scale_x,
           alpha1, a2};
  return launch(p, true, (cudaStream_t)stream);
}

// Mask mode: the cycle test alone at fine points pts [B, N, 2] f32
// contiguous -> mask [B, N] f32.
extern "C" int pixflow_cycle_mask_points(const float* flows,
                                         const float* flows_rev,
                                         const float* pts, float* mask, int K,
                                         int B, int N, int H, int W,
                                         float scale_y, float scale_x,
                                         float alpha1, float a2, int is_norm,
                                         void* stream) {
  Params p{flows, flows_rev, nullptr, nullptr, nullptr, nullptr, pts,
           nullptr, nullptr, mask, K, B, N, H, W, 0, is_norm, scale_y,
           scale_x, alpha1, a2};
  return launch(p, false, (cudaStream_t)stream);
}
