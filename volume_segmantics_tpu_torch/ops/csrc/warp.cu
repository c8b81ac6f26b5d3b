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
// and writes 5 B (f32 image, u8 mask); the 64 KB uint8 image and mask of a
// sample stay in L2, so the 4 + 1 tap gathers cost L2 hits, not DRAM. There
// are ~40 flops per pixel, far below the card's compute roofline.
// Design: one thread per output pixel; neighbouring threads take
// neighbouring pixels, so coordinate loads and the two stores coalesce.
// The TPU kernel's one-hot int8 matmuls and its separable/windowed
// branches worked around the TPU's slow gather and are not needed here.
// The blend uses __fmul_rn/__fadd_rn/__fdiv_rn so nvcc cannot contract it
// into FMAs: it rounds exactly like the elementwise PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect101(int i, int size) {
  if (size == 1) return 0;
  const int period = 2 * (size - 1);
  i = abs(i) % period;
  return i >= size ? period - i : i;
}

__global__ void warp_u8_kernel(const uint8_t* __restrict__ img,
                               const uint8_t* __restrict__ msk,
                               const float* __restrict__ coords,
                               float* __restrict__ out_img,
                               uint8_t* __restrict__ out_msk, int n, int h,
                               int w) {
  const long long hw = (long long)h * w;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n * hw) return;
  const long long b = p / hw;
  const long long q = p - b * hw;
  const float y = coords[2 * b * hw + q];
  const float x = coords[(2 * b + 1) * hw + q];
  const float y0f = floorf(y), x0f = floorf(x);
  const float wy = __fsub_rn(y, y0f), wx = __fsub_rn(x, x0f);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const int y0r = reflect101(y0, h), y1r = reflect101(y0 + 1, h);
  const int x0r = reflect101(x0, w), x1r = reflect101(x0 + 1, w);
  const uint8_t* im = img + b * hw;
  const float v00 = im[y0r * w + x0r], v01 = im[y0r * w + x1r];
  const float v10 = im[y1r * w + x0r], v11 = im[y1r * w + x1r];
  const float ox = __fsub_rn(1.f, wx), oy = __fsub_rn(1.f, wy);
  const float top = __fadd_rn(__fmul_rn(v00, ox), __fmul_rn(v01, wx));
  const float bot = __fadd_rn(__fmul_rn(v10, ox), __fmul_rn(v11, wx));
  out_img[p] =
      __fdiv_rn(__fadd_rn(__fmul_rn(top, oy), __fmul_rn(bot, wy)), 255.f);
  const int ty = wy > 0.5f ? y1r : y0r;
  const int tx = wx > 0.5f ? x1r : x0r;
  out_msk[p] = msk[b * hw + ty * w + tx];
}

}  // namespace

extern "C" int volseg_warp_u8(const void* img, const void* msk,
                              const void* coords, void* out_img, void* out_msk,
                              int n, int h, int w, void* stream) {
  const long long total = (long long)n * h * w;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    warp_u8_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, (const uint8_t*)msk, (const float*)coords,
        (float*)out_img, (uint8_t*)out_msk, n, h, w);
  }
  return (int)cudaGetLastError();
}
