// K2 and K3: batched CLAHE (OpenCV semantics) as a LUT kernel and a blend
// kernel.
//
// K2 replaces the TPU kernel volume_segmantics_tpu/ops/clahe.py:
// _clahe_lut_kernel_body; K3 replaces _clahe_blend_kernel_body (both
// launched by clahe_batch_fused). Plain versions:
// volume_segmantics_tpu_torch/ops/clahe.py:clahe_luts_plain and
// clahe_blend_plain.
//
// What bounds them on an H100: bytes. K2 reads each applied image once
// (4 B/pixel) and writes 16 KB of LUTs per sample; K3 reads and writes each
// image once (8 B/pixel) plus 4 KB of LUTs per block. Both do a handful of
// integer or f32 operations per pixel.
//
// K2 design: one block of 256 threads per (sample, tile), one thread per
// histogram bin. The tile's histogram of clip(rint(px*255), 0, 255) is built
// with shared-memory atomics in integers; the OpenCV clip limit is computed
// in f32 in the reference's order, floor(clip * area / 256); excess and CDF
// come from one block scan. Every count is an exact integer, so the LUT
// clip(rint(cdf * (255/area)), 0, 255) equals the reference's bit for bit.
// rintf rounds half to even, as jnp.rint and torch.round do. Samples whose
// `apply` flag is 0 are skipped (their LUT rows are left unwritten).
//
// K3 design: one block per (sample, half-tile row band). Every row of a
// band blends the same two tile rows, so the block stages those 2 x grid_w
// LUTs (4 KB for an 8x8 grid) in shared memory and then walks the band's
// pixels, one thread per pixel, computing the OpenCV bilinear weights in
// the kernel (fraction taken before clamping, the two neighbour indices
// clamped separately): (v00*(1-fx) + v01*fx)*(1-fy) + (v10*(1-fx) + v11*fx)*fy,
// then /255, with explicitly rounded f32 operations (no FMA contraction).
// The TPU kernel's static (n_bands, 64, band_h*S) weight tensor is not
// needed. Samples whose `apply` flag is 0 are copied through bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;

__device__ __forceinline__ int bin_of(float px) {
  const float v = rintf(__fmul_rn(px, 255.f));
  return (int)fminf(fmaxf(v, 0.f), 255.f);
}

// Inclusive prefix sum over a block of exactly kBins threads.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int s = lane < kBins / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kBins / 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < kBins / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  if (wid > 0) v += warp_sums[wid - 1];
  __syncthreads();  // warp_sums may be reused by the next scan
  return v;
}

__global__ void __launch_bounds__(kBins)
    clahe_luts_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w) {
  const int b = blockIdx.y, tile = blockIdx.x;
  if (apply[b] == 0) return;
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  __shared__ int hist[kBins];
  __shared__ int warp_sums[kBins / 32];
  const int t = threadIdx.x;
  hist[t] = 0;
  __syncthreads();
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
  for (int i = t; i < area; i += kBins) {
    const int r = i / tw, c = i - r * tw;
    atomicAdd(&hist[bin_of(base[(size_t)r * s + c])], 1);
  }
  __syncthreads();

  const float clip = clips[b];
  const int limit = (int)fmaxf(
      floorf(__fdiv_rn(__fmul_rn(clip, (float)area), (float)kBins)), 1.f);
  const int h = hist[t];
  const int clipped = min(h, limit);
  const int excess = block_inclusive_scan(h - clipped, warp_sums);
  __shared__ int total_excess;
  if (t == kBins - 1) total_excess = excess;
  __syncthreads();
  const int redist = total_excess / kBins;
  const int residual = total_excess - redist * kBins;
  const int step = max(kBins / max(residual, 1), 1);
  const int gets_one = (t % step == 0) && (t < residual * step);
  const int cdf = block_inclusive_scan(clipped + redist + gets_one, warp_sums);
  const float scale = (float)(255.0 / (double)area);
  const float lut = fminf(fmaxf(rintf(__fmul_rn((float)cdf, scale)), 0.f), 255.f);
  luts[((size_t)b * grid_h * grid_w + tile) * kBins + t] = (uint8_t)lut;
}

// OpenCV tile coordinate of a pixel: t = pos / tile - 0.5.
__device__ __forceinline__ float tile_coord(int pos, int tile) {
  return __fsub_rn(__fdiv_rn((float)pos, (float)tile), 0.5f);
}

__global__ void clahe_blend_kernel(const float* __restrict__ imgs,
                                   const int* __restrict__ apply,
                                   const uint8_t* __restrict__ luts,
                                   float* __restrict__ out, int s, int grid_h,
                                   int grid_w) {
  extern __shared__ uint8_t lut_sh[];  // [2][grid_w][kBins]
  const int b = blockIdx.y;
  const int th = s / grid_h, tw = s / grid_w, band_h = th / 2;
  const int y_start = blockIdx.x * band_h;
  const size_t off = (size_t)b * s * s + (size_t)y_start * s;
  const int npx = band_h * s;
  if (apply[b] == 0) {
    for (int i = threadIdx.x; i < npx; i += blockDim.x) out[off + i] = imgs[off + i];
    return;
  }
  const int ty0f = (int)floorf(tile_coord(y_start, th));
  const int ty0 = min(max(ty0f, 0), grid_h - 1);
  const int ty1 = min(max(ty0f + 1, 0), grid_h - 1);
  const int row_bytes = grid_w * kBins;
  const uint8_t* L = luts + (size_t)b * grid_h * row_bytes;
  for (int i = threadIdx.x; i < row_bytes; i += blockDim.x) {
    lut_sh[i] = L[(size_t)ty0 * row_bytes + i];
    lut_sh[row_bytes + i] = L[(size_t)ty1 * row_bytes + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npx; i += blockDim.x) {
    const int yy = y_start + i / s, x = i - (i / s) * s;
    const int bin = bin_of(imgs[off + i]);
    const float tyv = tile_coord(yy, th);
    const float fy = __fsub_rn(tyv, floorf(tyv));
    const float txv = tile_coord(x, tw);
    const float txf = floorf(txv);
    const float fx = __fsub_rn(txv, txf);
    const int tx0 = min(max((int)txf, 0), grid_w - 1);
    const int tx1 = min(max((int)txf + 1, 0), grid_w - 1);
    const float v00 = lut_sh[tx0 * kBins + bin];
    const float v01 = lut_sh[tx1 * kBins + bin];
    const float v10 = lut_sh[row_bytes + tx0 * kBins + bin];
    const float v11 = lut_sh[row_bytes + tx1 * kBins + bin];
    const float ox = __fsub_rn(1.f, fx), oy = __fsub_rn(1.f, fy);
    const float top = __fadd_rn(__fmul_rn(v00, ox), __fmul_rn(v01, fx));
    const float bot = __fadd_rn(__fmul_rn(v10, ox), __fmul_rn(v11, fx));
    out[off + i] =
        __fdiv_rn(__fadd_rn(__fmul_rn(top, oy), __fmul_rn(bot, fy)), 255.f);
  }
}

}  // namespace

extern "C" int volseg_clahe_luts(const void* imgs, const void* clips,
                                 const void* apply, void* luts, int n, int s,
                                 int grid_h, int grid_w, void* stream) {
  if (n > 0) {
    const dim3 grid(grid_h * grid_w, n);
    clahe_luts_kernel<<<grid, kBins, 0, (cudaStream_t)stream>>>(
        (const float*)imgs, (const float*)clips, (const int*)apply,
        (uint8_t*)luts, s, grid_h, grid_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int volseg_clahe_blend(const void* imgs, const void* apply,
                                  const void* luts, void* out, int n, int s,
                                  int grid_h, int grid_w, void* stream) {
  if (n > 0) {
    const int band_h = (s / grid_h) / 2;
    const dim3 grid(s / band_h, n);
    const size_t smem = 2 * (size_t)grid_w * kBins;
    clahe_blend_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
        (const float*)imgs, (const int*)apply, (const uint8_t*)luts,
        (float*)out, s, grid_h, grid_w);
  }
  return (int)cudaGetLastError();
}
