// Designs of kernel K2 (CLAHE LUTs) that tools/compare_k2_designs.py
// measures against each other on the card. This file includes the
// package's clahe.cu: its volseg_clahe_luts is the kept design, and its
// helpers (bin_of, load_px, clip_limit, Cursor, load_round, warp_luts) are
// shared. Every entry point here has volseg_clahe_luts' signature, and each
// design computes the same LUTs bit for bit.
//
// Designs (see PERF.md, "K2 design"):
//   k2_previous  the package's design before the kept one: a block of 256
//            threads per (sample, tile), thread t = bin t, scalar loads
//            with a division a pixel, two block scans;
//   block_*  the same block, one block scan of the clipped counts (three
//            barriers);
//   warp*_*  one warp per tile, W warps a block, no block barrier: the
//            warp's 1 KB histogram, 8 bins a lane, a warp shuffle scan;
//   split*   a tile over 2 or 8 warps of one block, warp 0 finishing with
//            warp_luts (4 warps is the kept design).
// Counting:  direct      one shared-memory atomicAdd a pixel;
//            match       __match_any_sync: one atomicAdd of popc(peers)
//                        per distinct bin in a warp;
//            subhist     per-warp sub-histograms, summed per bin;
//            uniform     one shuffle and one vote: a single atomicAdd of
//                        32 * V where all the warp's pixels share a bin,
//                        direct atomics otherwise.
// Loads (all but k2_previous's) are 16-byte (V = 4) where tiles are whole
// float4 groups and the image is 16-byte aligned, one float (V = 1)
// otherwise; the first round is issued before the histogram is cleared.

#include "../volume_segmantics_tpu_torch/ops/csrc/clahe.cu"

namespace {

constexpr int kProbeRecords = 4096;  // (sample, tile) pairs the probe records

enum class Count { kDirect, kMatch, kSubHist, kUniform };

// `scale` is (float)(255.0 / area), computed on the host.
__device__ __forceinline__ uint32_t lut_value(int cdf, float scale) {
  return (uint32_t)fminf(fmaxf(rintf(__fmul_rn((float)cdf, scale)), 0.f), 255.f);
}

// CDF of bin t from the inclusive prefix and the total of the clipped
// counts: the excess is area - total, and the OpenCV redistribution's
// prefix has a closed form (bins 0, step, 2 step, ... below
// residual * step get one more).
__device__ __forceinline__ int one_scan_cdf(int t, int prefix, int total,
                                            int area) {
  const int excess = area - total;
  const int redist = excess / kBins, residual = excess - redist * kBins;
  const int step = kBins / max(residual, 1);
  return prefix + redist * (t + 1) + min(t / step + 1, residual);
}

// Adds the loaded pixels to `hist`. Every lane of the warp calls it.
template <int V, int G, Count M>
__device__ __forceinline__ void count_round(int* hist, const float (&v)[G][V],
                                            const bool (&ok)[G], int lane) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int bins[V];
#pragma unroll
    for (int j = 0; j < V; ++j) bins[j] = ok[g] ? bin_of(v[g][j]) : -1;
    if constexpr (M == Count::kMatch) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const unsigned peers = __match_any_sync(kFull, bins[j]);
        if (bins[j] >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[bins[j]], __popc(peers));
      }
    } else if constexpr (M == Count::kUniform) {
      const int b0 = __shfl_sync(kFull, bins[0], 0);
      bool same = b0 >= 0;
#pragma unroll
      for (int j = 0; j < V; ++j) same = same && bins[j] == b0;
      if (__all_sync(kFull, same)) {
        if (lane == 0) atomicAdd(&hist[b0], 32 * V);
      } else if (ok[g]) {
#pragma unroll
        for (int j = 0; j < V; ++j) atomicAdd(&hist[bins[j]], 1);
      }
    } else if (ok[g]) {
#pragma unroll
      for (int j = 0; j < V; ++j) atomicAdd(&hist[bins[j]], 1);
    }
  }
}

// The package's K2 before the kept design, as it was.
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
    previous_luts_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w, float, int) {
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

template <int V, Count M, bool E = false>
__global__ void __launch_bounds__(kBins)
    luts_block_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w, float scale, int) {
  constexpr int kG = 4, kWarps = kBins / 32;
  constexpr int kHists = M == Count::kSubHist ? kWarps : 1;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int on = apply[b];
  const float clip = clips[b];
  if (!E && on == 0) return;
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int qn = tw / V, n_groups = th * qn;
  const int dr = kBins / qn, dc = kBins - dr * qn;
  __shared__ int hist[kHists * kBins];
  __shared__ int warp_sums[kWarps];
  Cursor cur{t / qn, t - t / qn * qn};
  float v[kG][V];
  bool ok[kG];
  int first = t - lane;  // the warp's first group: loop bounds stay warp-uniform
  load_round<V, kG>(base, s, t, kBins, n_groups, cur, dr, dc, qn, v, ok);
  if (E && on == 0) return;
#pragma unroll
  for (int h = 0; h < kHists; ++h) hist[h * kBins + t] = 0;
  __syncthreads();
  int* my_hist = hist + (M == Count::kSubHist ? wid * kBins : 0);
  for (;;) {
    count_round<V, kG, M>(my_hist, v, ok, lane);
    first += kG * kBins;
    if (first >= n_groups) break;
    load_round<V, kG>(base, s, first + lane, kBins, n_groups, cur, dr, dc, qn,
                      v, ok);
  }
  __syncthreads();
  int h = hist[t];
#pragma unroll
  for (int w = 1; w < kHists; ++w) h += hist[w * kBins + t];
  int x = min(h, clip_limit(clip, area));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += u;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  int below = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int ws = warp_sums[w];
    total += ws;
    below += w < wid ? ws : 0;
  }
  luts[((size_t)b * grid_h * grid_w + tile) * kBins + t] =
      (uint8_t)lut_value(one_scan_cdf(t, x + below, total, area), scale);
}

template <int V, int W, Count M, bool E = false>
__global__ void __launch_bounds__(32 * W)
    luts_warp_kernel(const float* __restrict__ imgs,
                     const float* __restrict__ clips,
                     const int* __restrict__ apply, uint8_t* __restrict__ luts,
                     int s, int grid_h, int grid_w, float scale, int) {
  constexpr int kG = 8;
  __shared__ __align__(16) int hist_all[W][kBins];
  const int b = blockIdx.y, n_tiles = grid_h * grid_w;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int tile = blockIdx.x * W + wid;
  if (tile >= n_tiles) return;  // warp-uniform: no block barrier below
  const int on = apply[b];
  const float clip = clips[b];
  if (!E && on == 0) return;
  int* hist = hist_all[wid];
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
  const int qn = tw / V, n_groups = th * qn;
  const int dr = 32 / qn, dc = 32 - dr * qn;
  Cursor cur{lane / qn, lane - lane / qn * qn};
  float v[kG][V];
  bool ok[kG];
  load_round<V, kG>(base, s, lane, 32, n_groups, cur, dr, dc, qn, v, ok);
  if (E && on == 0) return;
  int4* hist4 = reinterpret_cast<int4*>(hist);
  hist4[lane] = make_int4(0, 0, 0, 0);
  hist4[lane + 32] = make_int4(0, 0, 0, 0);
  __syncwarp();
  for (int first = 0;;) {
    count_round<V, kG, M>(hist, v, ok, lane);
    first += kG * 32;
    if (first >= n_groups) break;
    load_round<V, kG>(base, s, first + lane, 32, n_groups, cur, dr, dc, qn, v,
                      ok);
  }
  __syncwarp();
  // Lane l scans bins 8 l .. 8 l + 7.
  const int4 h0 = hist4[2 * lane], h1 = hist4[2 * lane + 1];
  const int h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const int limit = clip_limit(clip, area);
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
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = 8 * lane + k;
    word[k >> 2] |= lut_value(one_scan_cdf(t, below + p[k], total, area), scale)
                    << (8 * (k & 3));
  }
  // luts comes from torch.empty: 8-byte aligned.
  reinterpret_cast<uint2*>(luts + ((size_t)b * n_tiles + tile) * kBins)[lane] =
      make_uint2(word[0], word[1]);
}


// The second generation of the warp-per-tile design.
// C: warps are dealt to the applied (sample, tile) pairs in order (warp j
//    takes tile j % tiles of the (j / tiles)-th applied sample), so the
//    applied work lands on the first blocks and spreads over every SM;
//    without C a block row per sample, as luts_warp_kernel.
// R: R interleaved replicas of the histogram, lane l adding to replica
//    l % R (bin b of replica r at b * R + r), so lanes of different
//    replicas never share a bank.
// The finish divides by `step` with one reciprocal: (t + 0.5) / step is at
// least 0.5 / 256 from an integer, far beyond the product's rounding, so
// its floor is t / step.
template <int V, int W, int R, bool C>
__global__ void __launch_bounds__(32 * W)
    luts_warp_kernel2(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w, float scale, int n) {
  constexpr int kG = 8;
  __shared__ __align__(16) int hist_all[W][R * kBins];
  const int n_tiles = grid_h * grid_w;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int b = blockIdx.y, tile = blockIdx.x * W + wid;
  if constexpr (C) {
    const int j = tile, k = j / n_tiles;
    tile = j - k * n_tiles;
    b = -1;
    for (int base = 0, seen = 0; base < n; base += 32) {
      unsigned m = __ballot_sync(kFull, base + lane < n && apply[base + lane] != 0);
      const int c = __popc(m);
      if (k < seen + c) {
        for (int i = seen; i < k; ++i) m &= m - 1;
        b = base + __ffs(m) - 1;
        break;
      }
      seen += c;
    }
    if (b < 0) return;  // warp-uniform
  } else {
    if (tile >= n_tiles || apply[b] == 0) return;  // warp-uniform
  }
  const float clip = clips[b];
  int* hist = hist_all[wid];
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
  const int qn = tw / V, n_groups = th * qn;
  const int dr = 32 / qn, dc = 32 - dr * qn;
  Cursor cur{lane / qn, lane - lane / qn * qn};
  float v[kG][V];
  bool ok[kG];
  load_round<V, kG>(base, s, lane, 32, n_groups, cur, dr, dc, qn, v, ok);
  int4* hist4 = reinterpret_cast<int4*>(hist);
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) hist4[lane + 32 * i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  int* my_hist = hist + (lane & (R - 1));
  for (int first = 0;;) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (ok[g]) {
#pragma unroll
        for (int j = 0; j < V; ++j) atomicAdd(&my_hist[bin_of(v[g][j]) * R], 1);
      }
    }
    first += kG * 32;
    if (first >= n_groups) break;
    load_round<V, kG>(base, s, first + lane, 32, n_groups, cur, dr, dc, qn, v,
                      ok);
  }
  __syncwarp();
  // Lane l scans bins 8 l .. 8 l + 7: 8 R contiguous ints.
  int h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) {
    const int4 q = hist4[2 * R * lane + i];
    const int e = 4 * i;
    h[(e + 0) / R] += q.x, h[(e + 1) / R] += q.y;
    h[(e + 2) / R] += q.z, h[(e + 3) / R] += q.w;
  }
  const int limit = clip_limit(clip, area);
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
  const int excess = area - total, redist = excess >> 8, residual = excess & 255;
  const float inv_step = __fdiv_rn(1.f, (float)(kBins / max(residual, 1)));
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = 8 * lane + k;
    const int ones = min((int)__fmul_rn((float)t + 0.5f, inv_step) + 1, residual);
    const int cdf = below + p[k] + redist * (t + 1) + ones;
    word[k >> 2] |= min(__float2uint_rn(__fmul_rn((float)cdf, scale)), 255u)
                    << (8 * (k & 3));
  }
  reinterpret_cast<uint2*>(luts + ((size_t)b * n_tiles + tile) * kBins)[lane] =
      make_uint2(word[0], word[1]);
}

// A tile split over T warps of one block: one shared histogram, two
// barriers, then warp 0 alone finishes with warp_luts. The package's
// clahe_luts_kernel is this design at T = 4, in its final form.
template <int V, int T>
__global__ void __launch_bounds__(32 * T)
    luts_split_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w, float scale, int) {
  constexpr int kG = 8 / T, kThreads = 32 * T;
  __shared__ __align__(16) int hist[kBins];
  const int b = blockIdx.y, tile = blockIdx.x;
  if (apply[b] == 0) return;  // block-uniform
  const float clip = clips[b];
  const int t = threadIdx.x, lane = t & 31;
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
  const int qn = tw / V, n_groups = th * qn;
  const int dr = kThreads / qn, dc = kThreads - dr * qn;
  Cursor cur{t / qn, t - t / qn * qn};
  float v[kG][V];
  bool ok[kG];
  load_round<V, kG>(base, s, t, kThreads, n_groups, cur, dr, dc, qn, v, ok);
  int4* hist4 = reinterpret_cast<int4*>(hist);
  for (int i = t; i < kBins / 4; i += kThreads) hist4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int first = t - lane;;) {
    count_round<V, kG, Count::kDirect>(hist, v, ok, lane);
    first += kG * kThreads;
    if (first >= n_groups) break;
    load_round<V, kG>(base, s, first + lane, kThreads, n_groups, cur, dr, dc,
                      qn, v, ok);
  }
  __syncthreads();
  if (t >= 32) return;
  warp_luts(hist4, lane, clip_limit(clip, area), area, scale,
              luts + ((size_t)b * grid_h * grid_w + tile) * kBins);
}

// The kept design (clahe_luts_kernel) with timestamps, for where its time
// goes: thread 0 of each block records %globaltimer at entry and at the
// end, and clock64 cycles from entry to the flag known, to the first
// barrier (loads issued, histogram cleared), to the second (histogram
// built, so every load has arrived) and to the LUT store.
__device__ long long k2_probe_records[kProbeRecords][8];

__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

template <int V>
__global__ void __launch_bounds__(kLutThreads)
    probe_luts_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ clips,
                      const int* __restrict__ apply, uint8_t* __restrict__ luts,
                      int s, int grid_h, int grid_w, float scale, int) {
  const long long c0 = clock64(), g0 = global_ns();
  __shared__ __align__(16) int hist[kBins];
  const int b = blockIdx.y, tile = blockIdx.x;
  if (apply[b] == 0) return;
  const long long c1 = clock64();
  const float clip = clips[b];
  const int t = threadIdx.x;
  const int th = s / grid_h, tw = s / grid_w, area = th * tw;
  const int ty = tile / grid_w, tx = tile - ty * grid_w;
  const float* base = imgs + (size_t)b * s * s + (size_t)ty * th * s + tx * tw;
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
  const long long c2 = clock64();
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
  __syncthreads();
  const long long c3 = clock64();
  if (t >= 32) return;
  const int record = b * grid_h * grid_w + tile;
  warp_luts(hist4, t, clip_limit(clip, area), area, scale,
            luts + (size_t)record * kBins);
  if (t == 0 && record < kProbeRecords) {
    const long long c4 = clock64(), g4 = global_ns();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* r = k2_probe_records[record];
    r[0] = g0, r[1] = c1 - c0, r[2] = c2 - c1, r[3] = c3 - c2;
    r[4] = c4 - c3, r[5] = g4, r[6] = sm, r[7] = 1;
  }
}

using LutKernel = void (*)(const float*, const float*, const int*, uint8_t*,
                           int, int, int, float, int);

// compact: a flat grid over n * tiles warps (luts_warp_kernel2 with C).
int launch_design(LutKernel vec, LutKernel scalar, int threads,
                  int tiles_per_block, bool compact, const void* imgs,
                  const void* clips, const void* apply, void* luts, int n,
                  int s, int grid_h, int grid_w, void* stream) {
  if (n > 0) {
    const bool use_vec = (s / grid_w) % 4 == 0 &&
                         (reinterpret_cast<uintptr_t>(imgs) & 15) == 0;
    const int tiles = grid_h * grid_w;
    const dim3 grid = compact
        ? dim3((n * tiles + tiles_per_block - 1) / tiles_per_block, 1)
        : dim3((tiles + tiles_per_block - 1) / tiles_per_block, n);
    (use_vec ? vec : scalar)<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)imgs, (const float*)clips, (const int*)apply,
        (uint8_t*)luts, s, grid_h, grid_w,
        (float)(255.0 / (double)((s / grid_h) * (s / grid_w))), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define K2_DESIGN_C(name, vec, scalar, threads, tiles_per_block, compact)     \
  extern "C" int name(const void* imgs, const void* clips, const void* apply, \
                      void* luts, int n, int s, int grid_h, int grid_w,       \
                      void* stream) {                                         \
    return launch_design(vec, scalar, threads, tiles_per_block, compact,      \
                         imgs, clips, apply, luts, n, s, grid_h, grid_w,      \
                         stream);                                             \
  }
#define K2_DESIGN(name, vec, scalar, threads, tiles_per_block) \
  K2_DESIGN_C(name, vec, scalar, threads, tiles_per_block, false)

// Parenthesised, so that the commas survive a macro argument.
#define BLOCK(V, M, ...) (luts_block_kernel<V, Count::M, ##__VA_ARGS__>)
#define WARP(V, W, M, ...) (luts_warp_kernel<V, W, Count::M, ##__VA_ARGS__>)
#define WARP2(V, W, R, C) (luts_warp_kernel2<V, W, R, C>)
#define SPLIT(V, T) (luts_split_kernel<V, T>)

K2_DESIGN(k2_previous, previous_luts_kernel, previous_luts_kernel, kBins, 1)
K2_DESIGN(k2_block_scalar, BLOCK(1, kDirect), BLOCK(1, kDirect), kBins, 1)
K2_DESIGN(k2_block_direct, BLOCK(4, kDirect), BLOCK(1, kDirect), kBins, 1)
K2_DESIGN(k2_block_match, BLOCK(4, kMatch), BLOCK(1, kMatch), kBins, 1)
K2_DESIGN(k2_block_subhist, BLOCK(4, kSubHist), BLOCK(1, kSubHist), kBins, 1)
K2_DESIGN(k2_block_uniform, BLOCK(4, kUniform), BLOCK(1, kUniform), kBins, 1)
K2_DESIGN(k2_warp1_direct, WARP(4, 1, kDirect), WARP(1, 1, kDirect), 32, 1)
K2_DESIGN(k2_warp2_direct, WARP(4, 2, kDirect), WARP(1, 2, kDirect), 64, 2)
K2_DESIGN(k2_warp2_match, WARP(4, 2, kMatch), WARP(1, 2, kMatch), 64, 2)
K2_DESIGN(k2_warp2_uniform, WARP(4, 2, kUniform), WARP(1, 2, kUniform), 64, 2)
K2_DESIGN(k2_warp4_direct, WARP(4, 4, kDirect), WARP(1, 4, kDirect), 128, 4)
K2_DESIGN(k2_warp4_match, WARP(4, 4, kMatch), WARP(1, 4, kMatch), 128, 4)
K2_DESIGN(k2_warp4_uniform, WARP(4, 4, kUniform), WARP(1, 4, kUniform), 128, 4)
// E: apply and clip read, and the first image loads issued, before the
// apply test, so the flag's round trip overlaps the image's.
K2_DESIGN(k2_block_early, BLOCK(4, kDirect, true), BLOCK(1, kDirect, true), kBins, 1)
K2_DESIGN(k2_warp1_early, WARP(4, 1, kDirect, true), WARP(1, 1, kDirect, true), 32, 1)
K2_DESIGN(k2_warp2_early, WARP(4, 2, kDirect, true), WARP(1, 2, kDirect, true), 64, 2)
K2_DESIGN(k2_warp4_early, WARP(4, 4, kDirect, true), WARP(1, 4, kDirect, true), 128, 4)
// Second generation (luts_warp_kernel2): the one-reciprocal finish, R
// histogram replicas, and with `compact` warps dealt to applied tiles.
K2_DESIGN(k2_warp4_fast, WARP2(4, 4, 1, false), WARP2(1, 4, 1, false), 128, 4)
K2_DESIGN(k2_warp4_fast_r2, WARP2(4, 4, 2, false), WARP2(1, 4, 2, false), 128, 4)
K2_DESIGN(k2_warp4_fast_r4, WARP2(4, 4, 4, false), WARP2(1, 4, 4, false), 128, 4)
K2_DESIGN_C(k2_warp1_compact, WARP2(4, 1, 1, true), WARP2(1, 1, 1, true), 32, 1, true)
K2_DESIGN_C(k2_warp2_compact, WARP2(4, 2, 1, true), WARP2(1, 2, 1, true), 64, 2, true)
K2_DESIGN_C(k2_warp2_compact_r2, WARP2(4, 2, 2, true), WARP2(1, 2, 2, true), 64, 2, true)
K2_DESIGN_C(k2_warp2_compact_r4, WARP2(4, 2, 4, true), WARP2(1, 2, 4, true), 64, 2, true)
K2_DESIGN_C(k2_warp4_compact_r2, WARP2(4, 4, 2, true), WARP2(1, 4, 2, true), 128, 4, true)
// A tile split over 2 or 8 warps, warp 0 finishing (4: volseg_clahe_luts).
K2_DESIGN(k2_split2, SPLIT(4, 2), SPLIT(1, 2), 64, 1)
K2_DESIGN(k2_split8, SPLIT(4, 8), SPLIT(1, 8), 256, 1)
K2_DESIGN(k2_warp2_fast, WARP2(4, 2, 1, false), WARP2(1, 2, 1, false), 64, 2)

// The kept design with timestamps, and access to its records: 8 int64 per
// (sample, tile), the last 1 where the tile was applied.
K2_DESIGN(k2_probe, probe_luts_kernel<4>, probe_luts_kernel<1>, kLutThreads, 1)
extern "C" int k2_probe_clear() {
  static const long long zero[kProbeRecords][8] = {};
  return (int)cudaMemcpyToSymbol(k2_probe_records, zero, sizeof(zero));
}
extern "C" int k2_probe_fetch(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k2_probe_records,
                                   sizeof(k2_probe_records));
}
