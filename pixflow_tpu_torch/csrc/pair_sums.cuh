// Pieces shared by K1's forward (pair_sums.cu) and backward (pair_sums_bwd.cu):
// the positive-pair mask in the TPU kernel's float32 op order and as a
// bitmask in shared memory, and the staging of feature rows with Hopper's
// tensor memory accelerator (TMA).
//
// Both kernels give a sample (and, in the backward, a direction) one CTA of
// 16 warps. It stages rows kBlock = 64 at a time and kChunk = 256 channels at
// a time: at the recipe's shapes (N = 49, C = 256) that is one block and one
// chunk, so every load of the CTA is issued before the first use, each row
// is read from memory once, and the CTA waits once.
//
// A staged block is a tile of boxes: kBlock rows x 128 bytes each, the
// 16-byte chunks of row r stored in the order chunk ^ (r % 8) (TMA's 128-byte
// swizzle), so that 8 rows read at one channel hit 8 different bank groups.
// One thread issues one tensor copy per block, with no per-row work. Rows past a sample's N hold the next sample's rows
// (or zeros): the mask's bits are 0 there, so nothing reads them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace pixflow_pair {

constexpr int kBlock = 64;
constexpr int kChunk = 256;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxBytes = kBlock * 128;
constexpr unsigned kFull = 0xffffffffu;

// A kBlock x kBlock slice of M as bits: bits[i][w] bit b is M(i, 32w + b) != 0.
using MaskBits = uint32_t (*)[kBlock / 32];

// M_ij = (sqrt(dx*dx + dy*dy) * inv_diag < pos_ratio) * pm, with (dx, dy)
// the offset between query center i and key center j (its sign does not
// change dx*dx) and pm the query's pts_mask (1 without one). sqrtf and the
// product are correctly rounded, and these sources are compiled with
// --fmad=false, so dx*dx + dy*dy is not contracted and M matches the plain
// version bit for bit.
__device__ __forceinline__ float pair_mask(float xi, float yi, float xj, float yj, float pm,
                                           float inv, float pos_ratio) {
  const float dx = xi - xj;
  const float dy = yi - yj;
  const bool pos = sqrtf(dx * dx + dy * dy) * inv < pos_ratio;
  return (pos ? 1.0f : 0.0f) * pm;
}

// Evaluates M for the block's rows i < rows and columns j < cols (centers in
// shared memory; rp/cp are the rows'/columns' pts_mask, 1 on the key side),
// writes its bits and returns this thread's sum of the M values. A set bit's
// value is rp[i] * cp[j]. The thread keeps column j = tid % 64 and walks 8
// rows, unrolled so that their chains overlap; a warp's 32 lanes are 32
// columns of one row, so one ballot gives one word.
__device__ __forceinline__ float mask_bits(MaskBits bits, const float* rx, const float* ry,
                                           const float* rp, const float* cx, const float* cy,
                                           const float* cp, int rows, int cols, float inv,
                                           float pos_ratio) {
  const int j = threadIdx.x & (kBlock - 1);
  const bool col_in = j < cols;
  const float xj = cx[j], yj = cy[j], pj = cp[j];
  float msum = 0.0f;
#pragma unroll
  for (int r = 0; r < kBlock * kBlock / kThreads; ++r) {
    const int i = (int)(threadIdx.x / kBlock) + r * (kThreads / kBlock);
    float m = 0.0f;
    if (col_in && i < rows)
      m = pair_mask(rx[i], ry[i], xj, yj, rp[i] * pj, inv, pos_ratio);
    msum = msum + m;
    const unsigned b = __ballot_sync(kFull, m != 0.0f);
    if ((threadIdx.x & 31) == 0) bits[i][j >> 5] = b;
  }
  return msum;
}

__device__ __forceinline__ uint64_t row_bits(const MaskBits bits, int i) {
  return ((uint64_t)bits[i][1] << 32) | bits[i][0];
}

// Threads [t0, t0 + kBlock) load the centers (and pts_mask, or 1) of rows
// [r0, r0 + n), n <= kBlock, into shared memory, zero past n.
__device__ __forceinline__ void load_centers(float* sx, float* sy, float* sp, const float* x,
                                             const float* y, const float* pm, int64_t r0, int n,
                                             int t0) {
  const int t = (int)threadIdx.x - t0;
  if (t < 0 || t >= kBlock) return;
  const bool in = t < n;
  sx[t] = in ? x[r0 + t] : 0.0f;
  sy[t] = in ? y[r0 + t] : 0.0f;
  sp[t] = in && pm != nullptr ? pm[r0 + t] : 1.0f;
}

// Channels of one staged chunk, a multiple of 16 (the forward's mma depth);
// the tail past C is zero in shared memory.
__host__ __device__ inline int chunk_width(int channels) {
  const int c = (channels + 15) / 16 * 16;
  return c < kChunk ? c : kChunk;
}

// Boxes of 128 bytes a row that hold `width` channels, and the bytes of a
// staged block of the widest chunk.
template <typename T>
__host__ __device__ inline int boxes(int width) {
  return (width * (int)sizeof(T) + 127) / 128;
}
template <typename T>
__host__ __device__ inline int block_bytes(int C) {
  return boxes<T>(chunk_width(C)) * kBoxBytes;
}

// The 16-byte chunk of a staged block that holds row r, channels [c, c + V),
// V = 16 / sizeof(T), c a multiple of V.
template <typename T>
__device__ __forceinline__ T* chunk_at(T* tile, int r, int c) {
  constexpr int kRow = 128 / (int)sizeof(T);  // channels in a box row
  constexpr int V = 16 / (int)sizeof(T);
  const int box = c / kRow;
  const int chunk = (c - box * kRow) / V;
  return tile + box * (kBlock * kRow) + r * kRow + ((chunk ^ (r & 7)) * V);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as Tensor.to(bfloat16)
}

// Channels [c, c + 8) of row r of a staged block as floats (c a multiple
// of 8): one 16-byte chunk in bf16, two in f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* tile, int r, int c, float v[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(chunk_at(tile, r, c));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[u]));
    v[2 * u] = f.x;
    v[2 * u + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* tile, int r, int c, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(chunk_at(tile, r, c));
  const float4 b = *reinterpret_cast<const float4*>(chunk_at(tile, r, c + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to the 1024 bytes a 128-byte
// swizzled TMA destination needs (the launch asks for 1024 bytes more).
template <typename T>
__device__ __forceinline__ T* aligned_tiles(unsigned char* smem) {
  const unsigned pad = (1024u - (smem_addr(smem) & 1023u)) & 1023u;
  return reinterpret_cast<T*>(smem + pad);
}

// A CTA barrier in shared memory whose phase completes when its one arrival
// and the bytes it was told to expect (from tensor copies) are in.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Boxes one tensor copy brings: the 128-byte groups of a chunk.
template <typename T>
__host__ __device__ inline int copy_boxes(int C) {
  const int groups = C * (int)sizeof(T) / 128;
  return groups < kChunk * (int)sizeof(T) / 128 ? groups : kChunk * (int)sizeof(T) / 128;
}

// Stages rows [row, row + kBlock) x channels [c0, c0 + width) of a [rows, C]
// tensor into `tile` and returns the bytes `bar` must expect. tma: thread 0
// issues one tensor copy for the block (after a proxy fence when the CTA has
// read the tile before, `reused`); the part of the box past the tensor's
// last row or last group arrives as zeros. Otherwise every thread copies
// elements of the block's first `valid` rows, zero past C, and it returns 0.
template <typename T>
__device__ unsigned stage_block(T* tile, const CUtensorMap* map, const T* src, int64_t row,
                                int valid, int C, int c0, int width, bool tma, bool reused,
                                uint64_t* bar) {
  constexpr int kRow = 128 / (int)sizeof(T);
  if (tma) {
    if (threadIdx.x == 0) {
      if (reused) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(tile)),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"((int)row), "r"(c0 / kRow),
          "r"(smem_addr(bar))
          : "memory");
    }
    return (unsigned)(copy_boxes<T>(C) * kBoxBytes);
  }
  constexpr int V = 16 / (int)sizeof(T);
  const int n = min(C - c0, width);
  const T* s = src + row * C + c0;
  for (int e = threadIdx.x; e < valid * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    chunk_at(tile, r, c - c % V)[c % V] =
        c < n ? s[(int64_t)r * C + c] : from_float<T>(0.0f);
  }
  return 0u;
}

// The tensor map stage_block copies with: a [rows, C] row-major matrix of T
// at `base` seen as [C / 128 bytes groups][rows][128 bytes], in boxes of a
// chunk's groups x kBlock rows x 128 bytes with the 128-byte swizzle, which
// land in the tile's box order. False (the kernels then copy elements) when
// C does not fill whole groups, the rows are not 16-byte aligned, or the
// driver refuses the map.
template <typename T>
bool row_tensor_map(CUtensorMap* map, const void* base, int64_t rows, int C) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  if (C <= 0 || rows <= 0 || (C * sizeof(T)) % 128 != 0 ||
      (reinterpret_cast<uintptr_t>(base) & 15u) != 0)
    return false;
  const cuuint32_t row_elems = 128 / (cuuint32_t)sizeof(T);
  const cuuint64_t dims[3] = {row_elems, (cuuint64_t)rows, (cuuint64_t)C / row_elems};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T), 128};
  const cuuint32_t box[3] = {row_elems, (cuuint32_t)kBlock, (cuuint32_t)copy_boxes<T>(C)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the kernel's dynamic shared memory limit once per device and size.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (granted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) granted[dev] = bytes;
  return e;
}

}  // namespace pixflow_pair
