// K2 and K3: batched CLAHE (OpenCV semantics) as a LUT kernel and a blend
// kernel, at any square side S >= grid, as the JAX package's XLA `clahe`
// computes it: th = S / grid_h, tw = S / grid_w, pixel (y, x) counts in
// tile (y / th) * grid_w + x / tw, so where S % grid_w != 0 the last
// columns of tile row r count in tile row r + 1's first tiles and (with
// S % grid_h != 0) the last rows in none; the clip limit and the LUT
// scale use th * tw whatever a tile holds.
//
// K2 replaces the TPU kernel volume_segmantics_tpu/ops/clahe.py:
// _clahe_lut_kernel_body; K3 replaces _clahe_blend_kernel_body (both
// launched by clahe_batch_fused). Plain versions:
// volume_segmantics_tpu_torch/ops/clahe.py:clahe_luts_plain and
// clahe_blend_plain.
//
// What bounds them on an H100: bytes. K2 reads each applied image once
// (4 B/pixel) and writes 16 KB of LUTs per sample; K3 reads and writes each
// image once (8 B/pixel) and reads the LUTs (16 KB per applied sample; the
// 196 KB of a batch stay in L2, so restaging them per block costs L2 reads,
// not HBM bytes). Both do a handful of integer or f32 operations per pixel.
//
// K2 design: a block of 4 warps per (sample, tile), so that the per-pixel
// work of a tile spreads over 128 threads, and one scan. Each thread issues
// its first loads of the tile (16 bytes a thread where tiles are whole
// float4 groups and the image is 16-byte aligned, at S=256 two float4 of a
// 32x32 tile; one float a thread otherwise) before the shared histogram of
// clip(rint(px*255), 0, 255) is cleared; shared-memory atomics build it in
// integers. A tile of a side the grid does not divide then adds, one pixel
// a thread, the columns from (grid_w + tx) * tw of the tile row above. After
// the second barrier warp 0 alone makes the LUTs: lane l
// takes bins 8l..8l+7, and a warp shuffle scan joins the lanes. One scan
// suffices: the histogram sums to the pixels counted (th * (tw + spill)),
// so the OpenCV excess is that count - sum(clipped), and the
// redistribution's prefix has a closed form
// (bins 0, step, 2 step, ... below residual * step get one more, so bins
// <= t get min(t / step + 1, residual)). The clip limit is computed in f32
// in the reference's order, floor(clip * area / 256); every count is an
// exact integer, so the LUT rint(cdf * (255/area)) equals the reference's
// bit for bit (rounding half to even, as jnp.rint and torch.round do).
// Samples whose `apply` flag is 0 are skipped (their LUT rows are left
// unwritten). Measured and dropped (PERF.md, tools/k2_designs.cu): the
// previous design (a block of 256 threads, thread = bin, two block scans),
// a warp per tile (one warp's serial pixel work), warp aggregation with
// __match_any_sync (twice as slow), per-warp and interleaved histogram
// replicas, reading the flag alongside speculative image loads, and warps
// dealt to applied tiles only.
//
// K3 design: many small blocks, 16-byte accesses, taps computed once. A
// block takes `rows` rows of one band of one sample, a band being rows
// that blend the same two tile rows: half tiles where S % (2 grid_h) == 0,
// else the grid_h + 1 runs of rows whose clamped floor(y / th - 0.5) is
// the same, the last from ~(grid_h - 1/2) th to the end (at S=256: 4 rows
// of 64 float4 column groups, 256 threads, one float4 a thread; 768
// blocks for a batch of 12, against the ~5 of 256 threads that fit on
// each of the 132 SMs). So the block stages only those 2 x grid_w LUTs
// (4 KB for an 8x8 grid) in shared memory with 16-byte loads, after it has
// started its own image loads so the two are in flight together. Beside them it computes each
// column's OpenCV taps once (tx0, tx1, fx: fraction taken before clamping,
// neighbours clamped separately), which a thread then reads for its 4
// columns with two 16-byte shared loads; each row's fy is computed once a
// row, all with the same tile_coord arithmetic as the plain version. Per
// pixel: bin, four shared-memory byte lookups,
// (v00*(1-fx) + v01*fx)*(1-fy) + (v10*(1-fx) + v11*fx)*fy, /255, with
// explicitly rounded f32 operations (no FMA contraction) in the same order
// as the one-block-per-band design before it, so the two are bit-equal.
// Samples whose `apply` flag is 0 are a float4 copy, bit-exact. Rows that
// are not whole float4 groups, or images that are not 16-byte aligned,
// take a scalar instance of the same kernel (one pixel a thread). The TPU
// kernel's static (n_bands, 64, band_h*S) weight tensor is not needed.
// The host finds the bands' rows with the plain version's float32 row
// arithmetic and passes them as a kernel parameter (see Bands); each band
// takes as many blocks as the longest needs, those past a shorter band's
// end returning at once. Measured and dropped (PERF.md): each
// block searching its band's rows (0.00909 ms at S=256, against 0.00703)
// and each band dealt only the blocks it needs, a block finding its band
// by a scan of the table (0.00799 against the parent's 0.00690: the scan's
// dependent constant loads delay the first image load); the general
// bands at S=256 too, 8 of 72 blocks empty, 0.00711.
//
// The one-block-per-band design took one block per band (192 blocks of 256
// threads, ~18% of the card's thread slots), each thread walking 16 pixels
// with 4-byte accesses, two integer and two IEEE divisions a pixel, and
// staged the LUTs a byte at a time. Measured and dropped (PERF.md): the
// LUTs laid out [row][bin][tile] for one 8-byte lookup a row (its staging
// costs more than it saves), 6 blocks an SM forced by launch bounds (it
// spills), and two float4 a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kBins = 256;

__device__ __forceinline__ int bin_of(float px) {
  const float v = rintf(__fmul_rn(px, 255.f));
  return (int)fminf(fmaxf(v, 0.f), 255.f);
}

// V neighbouring pixels: one 16-byte access for V == 4.
template <int V>
__device__ __forceinline__ void load_px(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLutThreads = 128;  // 4 warps a tile
constexpr int kLutRound = 2;      // pixel groups a thread loads at once

// OpenCV clip limit, in f32 in the reference's order, at least 1.
__device__ __forceinline__ int clip_limit(float clip, int area) {
  return (int)fmaxf(
      floorf(__fdiv_rn(__fmul_rn(clip, (float)area), (float)kBins)), 1.f);
}

// A thread's group of V pixels in its tile: row r, group c of qn groups a
// row. Moving `stride` groups on is dr rows and dc groups (no division).
struct Cursor {
  int r, c;
  __device__ __forceinline__ void advance(int dr, int dc, int qn) {
    r += dr;
    c += dc;
    if (c >= qn) c -= qn, ++r;
  }
};

// Loads G groups of V pixels, at group indices idx, idx + stride, ...;
// ok[g] is false past the tile's n_groups.
template <int V, int G>
__device__ __forceinline__ void load_round(const float* base, int s, int idx,
                                           int stride, int n_groups,
                                           Cursor& cur, int dr, int dc, int qn,
                                           float (&v)[G][V], bool (&ok)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ok[g] = idx + g * stride < n_groups;
    if (ok[g]) {
      load_px<V>(base + (size_t)cur.r * s + cur.c * V, v[g]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[g][j] = 0.f;
    }
    cur.advance(dr, dc, qn);
  }
}

// One warp turns a tile's histogram into its LUT: lane l scans bins
// 8l..8l+7 of the clipped counts, a shuffle scan joins the lanes, and the
// excess is count - total, `count` being the pixels the histogram holds
// (the tile's area where S is a multiple of the grid). The count of bins <= t that get one more is
// min(t / step + 1, residual); (t + 0.5) / step lies at least 0.5 / 256
// from an integer, far beyond the product's rounding, so the floor of
// (t + 0.5) * (1 / step) is t / step. `scale` is (float)(255.0 / area);
// `lut` is 8-byte aligned.
__device__ __forceinline__ void warp_luts(const int4* hist4, int lane,
                                          int limit, int count, float scale,
                                          uint8_t* lut) {
  const int4 h0 = hist4[2 * lane], h1 = hist4[2 * lane + 1];
  const int h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  int p[8], run = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = run += min(h[k], limit);
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  const int total = __shfl_sync(kFull, incl, 31), below = incl - run;
  const int excess = count - total, redist = excess >> 8, residual = excess & 255;
  const float inv_step = __fdiv_rn(1.f, (float)(kBins / max(residual, 1)));
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = 8 * lane + k;
    const int ones = min((int)__fmul_rn((float)t + 0.5f, inv_step) + 1, residual);
    const int cdf = below + p[k] + redist * (t + 1) + ones;
    // round half to even, as rintf; clamped, as cdf may pass the area
    word[k >> 2] |= min(__float2uint_rn(__fmul_rn((float)cdf, scale)), 255u)
                    << (8 * (k & 3));
  }
  reinterpret_cast<uint2*>(lut)[lane] = make_uint2(word[0], word[1]);
}

template <int V>
__global__ void __launch_bounds__(kLutThreads)
    clahe_luts_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w, float scale) {
  static_assert(kLutThreads >= kBins / 4, "one int4 of the histogram a thread");
  __shared__ __align__(16) int hist[kBins];
  const int b = blockIdx.y, tile = blockIdx.x;
  if (apply[b] == 0) return;  // uniform per block
  const float clip = clips[b];
  const int t = threadIdx.x;
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
  // Pixel (y, x) counts in tile (y / th) * grid_w + x / tw, as the JAX
  // package numbers tiles: where S % grid_w != 0 the columns from
  // (grid_w + tx) * tw of the tile row above count here too (at most tw of
  // them, and only from the row above, as S < grid_w * (tw + 1)).
  const int spill_x = (grid_w + tx) * tw;
  const int spill_w = ty > 0 ? min(max(s - spill_x, 0), tw) : 0;
  const int qn = tw / V, n_groups = th * qn;
  const int dr = kLutThreads / qn, dc = kLutThreads - dr * qn;
  Cursor cur{t / qn, t - t / qn * qn};
  float v[kLutRound][V];
  bool ok[kLutRound];
  load_round<V, kLutRound>(base, s, t, kLutThreads, n_groups, cur, dr, dc, qn,
                           v, ok);
  int4* hist4 = reinterpret_cast<int4*>(hist);
  if (t < kBins / 4) hist4[t] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int next = t + kLutRound * kLutThreads;; next += kLutRound * kLutThreads) {
#pragma unroll
    for (int g = 0; g < kLutRound; ++g) {
      if (ok[g]) {
#pragma unroll
        for (int j = 0; j < V; ++j) atomicAdd(&hist[bin_of(v[g][j])], 1);
      }
    }
    if (next >= n_groups) break;
    load_round<V, kLutRound>(base, s, next, kLutThreads, n_groups, cur, dr, dc,
                             qn, v, ok);
  }
  if (spill_w > 0) {  // uniform per block
    const float* spill = base - (size_t)th * s - tx * tw + spill_x;
    for (int i = t; i < th * spill_w; i += kLutThreads) {
      const int r = i / spill_w;
      atomicAdd(&hist[bin_of(__ldg(spill + (size_t)r * s + (i - r * spill_w)))],
                1);
    }
  }
  __syncthreads();
  if (t >= 32) return;
  warp_luts(hist4, t, clip_limit(clip, area), th * (tw + spill_w), scale,
            luts + ((size_t)b * grid_h * grid_w + tile) * kBins);
}

// OpenCV tile coordinate of a pixel: t = pos / tile - 0.5.
__device__ __forceinline__ float tile_coord(int pos, int tile) {
  return __fsub_rn(__fdiv_rn((float)pos, (float)tile), 0.5f);
}

// K3's bands of rows, every row of a band blending the same two tile rows:
// in general band j (0..grid_h) holds the rows y whose clamped floor(t),
// t = y / th - 0.5 in f32, is j - 1 (it blends tile rows max(j - 1, 0)
// and min(j, grid_h - 1)), band grid_h every row from about
// (grid_h - 1/2) th to the end (the rows past grid_h * th too, which take
// the edge tile row alone); where S % (2 grid_h) == 0, the 2 grid_h half
// tiles of th / 2 rows, which all hold as many rows. The host finds the
// rows with the same IEEE f32 arithmetic as tile_coord (x86-64 float
// division and subtraction round as __fdiv_rn and __fsub_rn do).
constexpr int kMaxBands = 128;  // grid_h <= 64
struct Bands {
  int row[kMaxBands + 1];  // band j: rows [row[j], row[j + 1])
};

constexpr int kBlendThreads = 256;

template <int V>
__device__ __forceinline__ void store_px(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <int V, typename T>
__device__ __forceinline__ void load_shared(const T* p, T (&v)[V]) {
  if constexpr (V == 4) {
    const auto t = *reinterpret_cast<const typename Vec4<T>::type*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

// One pixel's blend from the two staged tile rows of LUTs; `taps` holds
// the byte offsets (tile * kBins) of its column's two tiles, o0 | o1 << 16.
__device__ __forceinline__ float blend_px(const uint8_t* lut_sh, int row_bytes,
                                          float px, int taps, float fx,
                                          float fy) {
  const int bin = bin_of(px), o0 = taps & 0xffff, o1 = taps >> 16;
  const float v00 = lut_sh[o0 + bin];
  const float v01 = lut_sh[o1 + bin];
  const float v10 = lut_sh[row_bytes + o0 + bin];
  const float v11 = lut_sh[row_bytes + o1 + bin];
  const float ox = __fsub_rn(1.f, fx), oy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, ox), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, ox), __fmul_rn(v11, fx));
  return __fdiv_rn(__fadd_rn(__fmul_rn(top, oy), __fmul_rn(bot, fy)), 255.f);
}

// Block (bx, by) = (column groups of V pixels, rows); blockIdx.x = (band,
// split of `rows` rows of it; see Bands: a split past a short band's end
// has no rows); blockIdx.y strides over samples.
// Dynamic shared memory: the band's two LUT rows [2][grid_w][kBins], then
// each column's taps (int, o0 | o1 << 16) and fraction (float), [s] each.
template <int V>
__global__ void __launch_bounds__(kBlendThreads)
    clahe_blend_kernel(const float* __restrict__ imgs,
                       const int* __restrict__ apply,
                       const uint8_t* __restrict__ luts, float* __restrict__ out,
                       int n, int s, int grid_h, int grid_w, int rows,
                       int splits, const Bands bands) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int th = s / grid_h, tw = s / grid_w;
  const int band = blockIdx.x / splits;
  const int r0 = (blockIdx.x - band * splits) * rows;
  const int y_band = bands.row[band];
  const int nrows = min(rows, bands.row[band + 1] - y_band - r0);
  if (nrows <= 0) return;  // uniform per block
  const int nq = s / V, row_bytes = grid_w * kBins;
  uint8_t* lut_sh = smem;
  int* col_taps = reinterpret_cast<int*>(smem + 2 * row_bytes);
  float* col_fx = reinterpret_cast<float*>(col_taps + s);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * blockDim.y;
  // Every row of a band blends the same two tile rows.
  const int tyf = (int)floorf(tile_coord(y_band, th));
  const int ty0 = min(max(tyf, 0), grid_h - 1);
  const int ty1 = min(max(tyf + 1, 0), grid_h - 1);
  for (int b = blockIdx.y; b < n; b += gridDim.y) {
    const size_t base = ((size_t)b * s + y_band + r0) * s;
    const float* src = imgs + base;
    float* dst = out + base;
    // The thread's first pixels are loaded before the LUT staging, so the
    // two loads are in flight together.
    const bool has_first = tx < nq && ty < nrows;
    float first[V];
    if (has_first) load_px<V>(src + (size_t)ty * s + tx * V, first);
    if (apply[b] == 0) {  // pass through, bit-exact (uniform per block)
      for (int q = tx; q < nq; q += blockDim.x) {
        for (int r = ty; r < nrows; r += blockDim.y) {
          float v[V];
          if (q == tx && r == ty) {
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = first[j];
          } else {
            load_px<V>(src + (size_t)r * s + q * V, v);
          }
          store_px<V>(dst + (size_t)r * s + q * V, v);
        }
      }
      continue;
    }
    const uint8_t* L = luts + (size_t)b * grid_h * row_bytes;
    const uint8_t* L0 = L + (size_t)ty0 * row_bytes;
    const uint8_t* L1 = L + (size_t)ty1 * row_bytes;
    if ((reinterpret_cast<uintptr_t>(luts) & 15) == 0) {
      const int row16 = row_bytes / 16;  // row_bytes is a multiple of 256
      for (int i = tid; i < 2 * row16; i += nthreads) {
        const uint4* row = reinterpret_cast<const uint4*>(i < row16 ? L0 : L1);
        reinterpret_cast<uint4*>(lut_sh)[i] = __ldg(row + i % row16);
      }
    } else {
      for (int i = tid; i < 2 * row_bytes; i += nthreads)
        lut_sh[i] = (i < row_bytes ? L0 : L1)[i % row_bytes];
    }
    // Each column's OpenCV taps, once per block: fraction taken before
    // clamping, the two neighbours clamped separately.
    for (int x = tid; x < s; x += nthreads) {
      const float txv = tile_coord(x, tw);
      const float txf = floorf(txv);
      col_fx[x] = __fsub_rn(txv, txf);
      col_taps[x] = (min(max((int)txf, 0), grid_w - 1) * kBins) |
                    (min(max((int)txf + 1, 0), grid_w - 1) * kBins) << 16;
    }
    __syncthreads();
    for (int q = tx; q < nq; q += blockDim.x) {
      for (int r = ty; r < nrows; r += blockDim.y) {
        float v[V];
        if (q == tx && r == ty) {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = first[j];
        } else {
          load_px<V>(src + (size_t)r * s + q * V, v);
        }
        const float tyv = tile_coord(y_band + r0 + r, th);
        const float fy = __fsub_rn(tyv, floorf(tyv));
        int taps[V];
        float fx[V];
        load_shared<V>(col_taps + q * V, taps);
        load_shared<V>(col_fx + q * V, fx);
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[j] = blend_px(lut_sh, row_bytes, v[j], taps[j], fx[j], fy);
        store_px<V>(dst + (size_t)r * s + q * V, v);
      }
    }
    __syncthreads();  // lut_sh is restaged for the next sample
  }
}

// The bands (see Bands): their count; `most` is set to the most rows a
// band holds.
int band_rows(int s, int grid_h, Bands& bands, int& most) {
  const int th = s / grid_h;
  int n_bands = grid_h + 1;
  if (s % (2 * grid_h) == 0) {
    n_bands = 2 * grid_h, most = th / 2;
    for (int j = 0; j <= n_bands; ++j) bands.row[j] = j * most;
    return n_bands;
  }
  int band = 0;
  bands.row[0] = 0;
  for (int y = 0; y < s; ++y) {
    const float t = (float)y / (float)th - 0.5f;
    const int j = std::min(std::max((int)std::floor(t), -1), grid_h - 1) + 1;
    while (band < j) bands.row[++band] = y;
  }
  while (band < n_bands) bands.row[++band] = s;
  most = 0;
  for (int j = 0; j < n_bands; ++j)
    most = std::max(most, bands.row[j + 1] - bands.row[j]);
  return n_bands;
}

}  // namespace

extern "C" int volseg_clahe_luts(const void* imgs, const void* clips,
                                 const void* apply, void* luts, int n, int s,
                                 int grid_h, int grid_w, void* stream) {
  if (n > 0) {
    // float4 loads where tile rows are whole 16-byte groups and the images
    // are 16-byte aligned; one pixel a load otherwise. `luts` comes from
    // torch.empty, so it is aligned for warp_luts' 8-byte stores.
    const int area = (s / grid_h) * (s / grid_w);
    const bool vec = (s / grid_w) % 4 == 0 && s % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(imgs) & 15) == 0;
    const auto kernel = vec ? clahe_luts_kernel<4> : clahe_luts_kernel<1>;
    kernel<<<dim3(grid_h * grid_w, n), kLutThreads, 0, (cudaStream_t)stream>>>(
        (const float*)imgs, (const float*)clips, (const int*)apply,
        (uint8_t*)luts, s, grid_h, grid_w, (float)(255.0 / (double)area));
  }
  return (int)cudaGetLastError();
}

extern "C" int volseg_clahe_blend(const void* imgs, const void* apply,
                                  const void* luts, void* out, int n, int s,
                                  int grid_h, int grid_w, void* stream) {
  if (n > 0) {
    // float4 accesses where rows are whole 16-byte groups and both images
    // are 16-byte aligned; one pixel a thread otherwise.
    if (2 * grid_h > kMaxBands) return (int)cudaErrorInvalidValue;
    const bool vec = s % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(imgs) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    Bands bands;
    int band_h;
    const int n_bands = band_rows(s, grid_h, bands, band_h);
    const int nq = vec ? s / 4 : s;
    // One group of pixels a thread: a block is a row's column groups times
    // as many rows of one band as fill kBlendThreads threads.
    const int bx = std::min(nq, kBlendThreads);
    const int rows = std::max(1, std::min(kBlendThreads / bx, band_h));
    const int splits = (band_h + rows - 1) / rows;
    const dim3 grid(n_bands * splits, std::min(n, 65535)), block(bx, rows);
    const size_t smem = 2 * (size_t)grid_w * kBins + 8 * (size_t)s;
    const auto kernel = vec ? clahe_blend_kernel<4> : clahe_blend_kernel<1>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float*)imgs, (const int*)apply, (const uint8_t*)luts, (float*)out,
        n, s, grid_h, grid_w, rows, splits, bands);
  }
  return (int)cudaGetLastError();
}
