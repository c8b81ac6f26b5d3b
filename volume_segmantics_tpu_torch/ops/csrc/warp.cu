// K1: batched bilinear image + nearest mask warp of uint8 tiles.
//
// Replaces the TPU kernel volume_segmantics_tpu/ops/warp.py:_warp_kernel_body
// (launched by warp_batch_u8_mxu). Same function as the plain version
// volume_segmantics_tpu_torch/ops/warp.py:warp_pair_u8: for each output pixel,
// the four taps around the f32 source coordinate (y, x) with integer
// reflect-101 borders; image = x-lerp, then y-lerp, then /255; mask = the tap
// picked by (wy > 0.5, wx > 0.5).
//
// What bounds it on an H100: bytes. Per pixel it reads 8 B of coordinates
// and 2 B of source taps (image and mask, each read once from HBM) and
// writes 5 B (f32 image, u8 mask): 15 B. There are ~40 flops per pixel,
// far below the compute roofline. What holds it back in practice is the
// gather: a warp's load instruction costs one L1 pass per distinct 128-byte
// line its 32 lanes touch, and half the augmentation's samples are
// transposed or turned by 90 degrees, so 32 pixels along an output row read
// 32 different source rows.
//
// Design: a block warps an 8 x 32 tile of one sample's output (blockIdx.x
// the tile, blockIdx.y the sample: no division by a runtime h*w), and each
// warp a 4 x 8 patch of it, one pixel a lane. A patch reads about 5 source
// rows whichever way the sample is turned (a 1 x 32 row: 2 rows unturned,
// 32 turned), and its coordinate loads and image stores are whole 32-byte
// sectors. The reflect-101 modulo runs only for a tap outside
// [0, size - 1]; in range (nearly every tap of the augmentation's
// coordinates) the taps are i and i + 1, which is what reflect-101 gives
// there. Edge tiles mask their lanes, so any (N, H, W) and any alignment
// take the same path.
// The TPU kernel's one-hot int8 matmuls and its separable/windowed
// branches worked around the TPU's slow gather and are not needed here.
// The blend uses __fmul_rn/__fadd_rn/__fdiv_rn so nvcc cannot contract it
// into FMAs: it rounds exactly like the elementwise PyTorch version.
//
// Measured against the alternatives (PERF.md): the first design's one pixel
// a thread over a flat grid (a 64-bit division by h*w and a modulo in every
// reflect) ran no faster once both were gone, and 4 neighbouring pixels a
// thread with float4 loads and stores ran slower: each gather instruction
// then spans 128 output pixels.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

// A block warps a kTileH x kTileW tile of one sample's output, each warp a
// kWarpH x kWarpW patch of it (one pixel a lane).
constexpr int kWarpH = 4, kWarpW = 8;
constexpr int kTileH = 8, kTileW = 32;
constexpr int kWarpThreads = kTileH * kTileW;
static_assert(kWarpH * kWarpW == 32 && kTileH % kWarpH == 0 &&
              kTileW % kWarpW == 0, "a warp is one whole patch of the tile");

__device__ __forceinline__ int reflect101(int i, int size) {
  if (size == 1) return 0;
  const int period = 2 * (size - 1);
  i = abs(i) % period;
  return i >= size ? period - i : i;
}

// reflect101(i) and reflect101(i + 1); no modulo when both are in range.
__device__ __forceinline__ void axis_taps(int i, int size, int& a, int& b) {
  if ((unsigned)i < (unsigned)(size - 1)) {
    a = i;
    b = i + 1;
  } else {
    a = reflect101(i, size);
    b = reflect101(i + 1, size);
  }
}

// blockIdx.x = output tile (row-major over tiles_x columns); blockIdx.y
// strides over samples.
__global__ void __launch_bounds__(kWarpThreads)
    warp_u8_kernel(const uint8_t* __restrict__ img,
                   const uint8_t* __restrict__ msk,
                   const float* __restrict__ coords,
                   float* __restrict__ out_img, uint8_t* __restrict__ out_msk,
                   int n, int h, int w, int tiles_x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps_x = kTileW / kWarpW;
  const int tile_y = blockIdx.x / tiles_x, tile_x = blockIdx.x - tile_y * tiles_x;
  const int py = tile_y * kTileH + (warp / warps_x) * kWarpH + lane / kWarpW;
  const int px = tile_x * kTileW + (warp % warps_x) * kWarpW + lane % kWarpW;
  if (py >= h || px >= w) return;
  const int hw = h * w, q = py * w + px;
  for (int b = blockIdx.y; b < n; b += gridDim.y) {
    const size_t s0 = (size_t)b * hw;
    const uint8_t* im = img + s0;
    const float y = __ldg(coords + 2 * s0 + q), x = __ldg(coords + 2 * s0 + hw + q);
    const float y0f = floorf(y), x0f = floorf(x);
    const float wy = __fsub_rn(y, y0f), wx = __fsub_rn(x, x0f);
    int y0r, y1r, x0r, x1r;
    axis_taps((int)y0f, h, y0r, y1r);
    axis_taps((int)x0f, w, x0r, x1r);
    const int r0 = y0r * w, r1 = y1r * w;
    const float v00 = __ldg(im + r0 + x0r), v01 = __ldg(im + r0 + x1r);
    const float v10 = __ldg(im + r1 + x0r), v11 = __ldg(im + r1 + x1r);
    const float ox = __fsub_rn(1.f, wx), oy = __fsub_rn(1.f, wy);
    const float top = __fadd_rn(__fmul_rn(v00, ox), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ox), __fmul_rn(v11, wx));
    out_img[s0 + q] =
        __fdiv_rn(__fadd_rn(__fmul_rn(top, oy), __fmul_rn(bot, wy)), 255.f);
    out_msk[s0 + q] =
        __ldg(msk + s0 + (wy > 0.5f ? r1 : r0) + (wx > 0.5f ? x1r : x0r));
  }
}

}  // namespace

extern "C" int volseg_warp_u8(const void* img, const void* msk,
                              const void* coords, void* out_img, void* out_msk,
                              int n, int h, int w, void* stream) {
  if ((long long)h * w > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n > 0 && h > 0 && w > 0) {
    const int tiles_x = (w + kTileW - 1) / kTileW;
    const int tiles_y = (h + kTileH - 1) / kTileH;
    const dim3 grid((unsigned)tiles_x * tiles_y, (unsigned)std::min(n, 65535));
    warp_u8_kernel<<<grid, kWarpThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, (const uint8_t*)msk, (const float*)coords,
        (float*)out_img, (uint8_t*)out_msk, n, h, w, tiles_x);
  }
  return (int)cudaGetLastError();
}
