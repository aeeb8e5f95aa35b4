// Hand-written Hopper (sm_90a) samplers for the voxel unprojection.
//
// sp3d_sample_view replaces the TPU kernel _slice_warp_kernel
// (selfpose3d_tpu/ops/slicewarp.py:323, per-slice body _warp_slice :150);
// sp3d_sample_views_mean replaces _slice_warp_agg_kernel (:664);
// sp3d_sample_view_adjoint replaces _slice_warp_adjoint_kernel (:1162, per-
// slice body _adjoint_slice :907), the backward of the per-view sampler.
//
// What they compute: exact 4-tap bilinear samples of channel-minor
// heatmaps (B, [V,] H, W, J) at pixel coordinates in the align-corners
// convention, each tap outside the image contributing zero -- the function
// of F.grid_sample(align_corners=True, padding_mode="zeros"). The views
// kernel also takes the bounded mean over the V views:
//   clip(nan_to_num(sum_v s_v * bnd_v / (sum_v bnd_v + 1e-6)), 0, 1).
// Taps and weights are combined in the order of the plain version
// (selfpose3d_tpu_torch/ops/sampling.py), in float32.
//
// None of the TPU kernels' machinery carries over (column hosting,
// binary-search inversion, <=128-lane gathers, slice- and channel-pair
// packing, flip flags, exact-fix slots): those work around the TPU's
// vector gathers. A GPU thread reads any texel, so both kernels are exact
// everywhere and have no ok mask.
//
// What bounds them on an H100: bytes, not arithmetic (about 2 flops per
// tap and channel). Per point the views kernel reads 3 floats per view
// (px, py, bnd: 60 B over 5 views) and writes J values (30 B at J=15 in
// bf16); the heatmaps it gathers from are small (74 MB at B=8, 5 views,
// 128x240x15 f32) and one batch element's 9 MB stays in the 50 MB L2 while
// its points are sampled. The design follows from that: one thread per
// (batch, point), coordinate loads coalesced across the warp, the J
// channels of each tap read contiguously and accumulated in f32 registers,
// the output written once in its final dtype and layout (B, N, J) -- the
// V2V input, with no transpose after it. The per-view sampler (RootNet:
// J=1, 128,000 points a view) moves about 5 MB a launch and is bound by
// launch latency.
//
// The adjoint is the transpose of sp3d_sample_view: every point adds
// w_tap * g[b, n, :] into the 4 texels it sampled, taps outside the image
// dropped, with the weights of bilinear<> below, into a heatmap gradient
// the caller has zeroed. Coordinates get no gradient. The TPU kernel turns
// this scatter into lane cumsums, a binary-search count and boundary
// gathers because TPU scatters are serial; none of that carries over.
// Bytes bound it (g read once, 4*J bytes a point; the heatmap gradient is
// small), but what it costs is atomic traffic: the first version issued
// one scalar RED to L2 per point, tap and channel, and the 64 voxels along
// a camera ray land on the same texels, so those adds serialised in L2
// (6.6-7.3 ms against a 0.11 ms bound on a dense train-shape cotangent).
// The design now: points are x-major and z-minor, so a run of kRun = 512
// consecutive points is 8 neighbouring z-columns of one cube plane and
// projects into a compact pixel box. A block takes one run: it reads the
// run's cotangent rows with coalesced 16-byte loads (an all-zero run -- in
// a train step most points outside a view are -- exits after that read),
// stages them in shared memory, reduces the pixel box of the live taps,
// and, where box x J floats fit its tile (96 KB with the staged rows),
// accumulates the run into a private shared-memory tile with shared
// atomics, then adds the tile's nonzero texels to dhm, one box row at a
// time: a row is bw*J contiguous floats in both, added with 16-byte
// float4 REDs (atomicAdd on float4, sm_90). A run whose box does not fit
// is split into four sub-runs of 128 points, each privatised the same way
// where its box fits; a sub-run that is still spread over the image (a
// cube that straddles the image edge, or close to the camera) takes the
// direct path, one scalar RED per tap and channel, inside the same kernel.
// Contributions that are exactly zero (a zeroed cotangent row, a zero tap
// weight) are skipped: adding 0 changes nothing. Float atomics (shared and
// global) add in an order that varies from run to run, so two runs agree
// only to rounding of the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// s[j] = sum over the 4 taps of hm[yi, xi, j] * w_tap, zero-padded.
template <int JMAX>
__device__ __forceinline__ void bilinear(const float* __restrict__ img, int H, int W,
                                         int J, float x, float y, float (&s)[JMAX]) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const float w[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
#pragma unroll
  for (int j = 0; j < JMAX; ++j) s[j] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int xi = x0 + (t & 1);
    const int yi = y0 + (t >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const float* p = img + (static_cast<int64_t>(yi) * W + xi) * J;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if (j < J) s[j] += __ldg(p + j) * w[t];
    }
  }
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

template <int JMAX>
__global__ void __launch_bounds__(kThreads)
sample_view_kernel(const float* __restrict__ hm, const float* __restrict__ px,
                   const float* __restrict__ py, float* __restrict__ out, int64_t total,
                   int N, int H, int W, int J) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / N;
  float s[JMAX];
  bilinear<JMAX>(hm + b * H * W * J, H, W, J, px[i], py[i], s);
  float* o = out + i * J;
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    if (j < J) o[j] = s[j];
  }
}

template <int JMAX, typename OutT>
__global__ void __launch_bounds__(kThreads)
sample_views_mean_kernel(const float* __restrict__ hm, const float* __restrict__ px,
                         const float* __restrict__ py, const float* __restrict__ bnd,
                         OutT* __restrict__ out, int64_t total, int V, int N, int H, int W,
                         int J) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / N;
  const int64_t n = i - b * N;
  float acc[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) acc[j] = 0.f;
  float bsum = 0.f;
  for (int v = 0; v < V; ++v) {
    const int64_t bv = b * V + v;
    const int64_t k = bv * N + n;
    const float bd = bnd[k];
    float s[JMAX];
    bilinear<JMAX>(hm + bv * H * W * J, H, W, J, px[k], py[k], s);
#pragma unroll
    for (int j = 0; j < JMAX; ++j) acc[j] += s[j] * bd;
    bsum += bd;
  }
  const float den = bsum + 1e-6f;
  OutT* o = out + i * J;
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    if (j < J) {
      float m = acc[j] / den;
      if (m != m) m = 0.f;  // nan_to_num(nan=0); +-inf are clipped below
      store(o + j, fminf(fmaxf(m, 0.f), 1.f));
    }
  }
}

// The adjoint: a block takes a run of kRun consecutive points of one batch
// element (see the header note) and stages their cotangent rows in shared
// memory at an odd row stride (no bank conflicts when a thread walks its
// point's row).
constexpr int kRun = 512;
constexpr int kSubRun = 128;
constexpr int kAdjSmem = 96 * 1024;

struct Taps {
  int x0, y0;
  float w[4];
};

// the four taps of bilinear<> and their weights, in the same arithmetic
__device__ __forceinline__ Taps taps_of(float x, float y) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  return {static_cast<int>(x0f), static_cast<int>(y0f),
          {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy}};
}

// tap t lands in the image with a nonzero weight
__device__ __forceinline__ bool tap_live(const Taps& tp, int t, int H, int W) {
  const int xi = tp.x0 + (t & 1);
  const int yi = tp.y0 + (t >> 1);
  return xi >= 0 && xi < W && yi >= 0 && yi < H && tp.w[t] != 0.f;
}

__global__ void __launch_bounds__(kThreads)
sample_view_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ px,
                           const float* __restrict__ py, float* __restrict__ dhm, int N, int H,
                           int W, int J, int runs) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int box[4];
  __shared__ unsigned char live[kRun];
  const int JS = J | 1;
  const int stage_floats = (kRun * JS + 3) & ~3;
  float* stage = sm;
  float* tile = sm + stage_floats;
  const int tile_floats = kAdjSmem / 4 - stage_floats;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.x / runs;
  const int64_t p0 = static_cast<int64_t>(b) * N +
                     static_cast<int64_t>(blockIdx.x - b * runs) * kRun;  // first point
  const int64_t left = static_cast<int64_t>(b + 1) * N - p0;  // points of batch b from p0 on
  const int n = left < kRun ? static_cast<int>(left) : kRun;
  float* img = dhm + static_cast<int64_t>(b) * H * W * J;

  // 1. the run's cotangent rows with 16-byte loads: an all-zero run (in a
  // train step most runs of points outside a view are) exits after this
  // read; otherwise they are staged, read again from L1
  const float* src = g + p0 * J;
  const int total = n * J;
  // floats before the first 16-byte boundary
  const int head =
      min(total, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
  const int n4 = (total - head) / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  bool any = tid < head && src[tid] != 0.f;
  for (int k = tid; k < n4; k += kThreads) {
    const float4 v = __ldg(src4 + k);
    any = any || v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
  }
  for (int f = head + 4 * n4 + tid; f < total; f += kThreads) any = any || src[f] != 0.f;
  if (!__syncthreads_or(any)) return;
  auto put = [&](int f, float v) {
    const int p = f / J;
    stage[p * JS + f - p * J] = v;
  };
  if (tid < head) put(tid, src[tid]);
  for (int k = tid; k < n4; k += kThreads) {
    const float4 v = __ldg(src4 + k);
    const int f = head + 4 * k;
    put(f, v.x);
    put(f + 1, v.y);
    put(f + 2, v.z);
    put(f + 3, v.w);
  }
  for (int f = head + 4 * n4 + tid; f < total; f += kThreads) put(f, src[f]);
  __syncthreads();
  for (int p = tid; p < n; p += kThreads) {
    bool nz = false;
    for (int j = 0; j < J; ++j) nz = nz || stage[p * JS + j] != 0.f;
    live[p] = nz;
  }

  // the pixel box of the live taps of points [q0, q1); empty when x1 < x0
  auto box_of = [&](int q0, int q1, int& x0, int& x1, int& y0, int& y1) {
    __syncthreads();  // every thread has read the previous box and flushed the tile
    if (tid == 0) {
      box[0] = INT_MAX;
      box[1] = INT_MIN;
      box[2] = INT_MAX;
      box[3] = INT_MIN;
    }
    __syncthreads();
    int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
    for (int p = q0 + tid; p < q1; p += kThreads) {
      if (!live[p]) continue;
      const Taps tp = taps_of(px[p0 + p], py[p0 + p]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!tap_live(tp, t, H, W)) continue;
        bx0 = min(bx0, tp.x0 + (t & 1));
        bx1 = max(bx1, tp.x0 + (t & 1));
        by0 = min(by0, tp.y0 + (t >> 1));
        by1 = max(by1, tp.y0 + (t >> 1));
      }
    }
    bx0 = __reduce_min_sync(0xffffffffu, bx0);
    bx1 = __reduce_max_sync(0xffffffffu, bx1);
    by0 = __reduce_min_sync(0xffffffffu, by0);
    by1 = __reduce_max_sync(0xffffffffu, by1);
    if (lane == 0) {
      atomicMin(&box[0], bx0);
      atomicMax(&box[1], bx1);
      atomicMin(&box[2], by0);
      atomicMax(&box[3], by1);
    }
    __syncthreads();
    x0 = box[0];
    x1 = box[1];
    y0 = box[2];
    y1 = box[3];
  };

  // points [q0, q1) into the private tile of box (x0, y0, bw, bh), then
  // the tile's nonzero texels into dhm, J contiguous floats a texel
  auto privatised = [&](int q0, int q1, int x0, int y0, int bw, int bh) {
    const int nf = bw * bh * J;
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int k = tid; k < (nf + 3) / 4; k += kThreads) t4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int p = q0 + tid; p < q1; p += kThreads) {
      if (!live[p]) continue;
      const Taps tp = taps_of(px[p0 + p], py[p0 + p]);
      const float* gr = stage + p * JS;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!tap_live(tp, t, H, W)) continue;
        float* d = tile + ((tp.y0 + (t >> 1) - y0) * bw + tp.x0 + (t & 1) - x0) * J;
        for (int j = 0; j < J; ++j) {
          const float gv = gr[j];
          if (gv != 0.f) atomicAdd(d + j, gv * tp.w[t]);
        }
      }
    }
    __syncthreads();
    // flush: a warp a box row; the row is bw*J contiguous floats in the
    // tile and in dhm, added as 16-byte-aligned float4 REDs (scalar REDs
    // at the row's unaligned ends), all-zero groups skipped
    const int L = bw * J;
    for (int r = tid / 32; r < bh; r += kThreads / 32) {
      const int64_t go = (static_cast<int64_t>(y0 + r) * W + x0) * J;
      const float* trow = tile + r * L;
      // floats before go in its 16-byte group
      const int64_t base = (reinterpret_cast<uintptr_t>(img + go) & 15) / 4;
      for (int64_t k = lane; 4 * k < base + L; k += 32) {
        const int64_t lo = 4 * k - base;  // offset of the group's first float from go
        if (lo >= 0 && lo + 4 <= L) {
          const float4 v = make_float4(trow[lo], trow[lo + 1], trow[lo + 2], trow[lo + 3]);
          if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
            atomicAdd(reinterpret_cast<float4*>(img + go + lo), v);
        } else {
          for (int64_t e = lo < 0 ? 0 : lo; e < lo + 4 && e < L; ++e)
            if (trow[e] != 0.f) atomicAdd(img + go + e, trow[e]);
        }
      }
    }
  };

  // points [q0, q1) straight into dhm, one scalar RED a tap and channel
  auto direct = [&](int q0, int q1) {
    for (int p = q0 + tid; p < q1; p += kThreads) {
      if (!live[p]) continue;
      const Taps tp = taps_of(px[p0 + p], py[p0 + p]);
      const float* gr = stage + p * JS;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!tap_live(tp, t, H, W)) continue;
        float* d = img + (static_cast<int64_t>(tp.y0 + (t >> 1)) * W + tp.x0 + (t & 1)) * J;
        for (int j = 0; j < J; ++j) {
          const float gv = gr[j];
          if (gv != 0.f) atomicAdd(d + j, gv * tp.w[t]);
        }
      }
    }
  };

  // 2. the whole run if its box fits the tile; else each sub-run whose box
  // fits; the rest directly
  auto fits = [&](int x0, int x1, int y0, int y1) {
    return (x1 - x0 + 1) * (y1 - y0 + 1) * J <= tile_floats - 4;
  };
  int x0, x1, y0, y1;
  box_of(0, n, x0, x1, y0, y1);
  if (x1 < x0) return;
  if (fits(x0, x1, y0, y1)) {
    privatised(0, n, x0, y0, x1 - x0 + 1, y1 - y0 + 1);
    return;
  }
  for (int q0 = 0; q0 < n; q0 += kSubRun) {
    const int q1 = min(n, q0 + kSubRun);
    box_of(q0, q1, x0, x1, y0, y1);
    if (x1 < x0) continue;
    if (fits(x0, x1, y0, y1)) {
      privatised(q0, q1, x0, y0, x1 - x0 + 1, y1 - y0 + 1);
    } else {
      direct(q0, q1);
    }
  }
}

unsigned blocks_for(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <typename OutT>
int launch_views_mean(const float* hm, const float* px, const float* py, const float* bnd,
                      OutT* out, int B, int V, int N, int H, int W, int J,
                      cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * N;
  const unsigned g = blocks_for(total);
#define SP3D_VIEWS_MEAN(JM) \
  sample_views_mean_kernel<JM, OutT><<<g, kThreads, 0, stream>>>(hm, px, py, bnd, out, total, V, N, H, W, J)
  if (J <= 1) SP3D_VIEWS_MEAN(1);
  else if (J <= 4) SP3D_VIEWS_MEAN(4);
  else if (J <= 16) SP3D_VIEWS_MEAN(16);
  else if (J <= 32) SP3D_VIEWS_MEAN(32);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef SP3D_VIEWS_MEAN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One view: hm (B, H, W, J) f32; px, py (B, N) f32 -> out (B, N, J) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sp3d_sample_view(const float* hm, const float* px, const float* py, float* out,
                                int B, int N, int H, int W, int J, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * N;
  if (total == 0) return 0;
  const unsigned g = blocks_for(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP3D_VIEW(JM) \
  sample_view_kernel<JM><<<g, kThreads, 0, s>>>(hm, px, py, out, total, N, H, W, J)
  if (J <= 1) SP3D_VIEW(1);
  else if (J <= 4) SP3D_VIEW(4);
  else if (J <= 16) SP3D_VIEW(16);
  else if (J <= 32) SP3D_VIEW(32);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef SP3D_VIEW
  return static_cast<int>(cudaGetLastError());
}

// V views: hm (B, V, H, W, J) f32; px, py, bnd (B, V, N) f32 ->
// out (B, N, J), bf16 when out_bf16 else f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sp3d_sample_views_mean(const float* hm, const float* px, const float* py,
                                      const float* bnd, void* out, int out_bf16, int B, int V,
                                      int N, int H, int W, int J, void* stream) {
  if (static_cast<int64_t>(B) * N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch_views_mean(hm, px, py, bnd, static_cast<__nv_bfloat16*>(out), B, V, N, H,
                             W, J, s);
  }
  return launch_views_mean(hm, px, py, bnd, static_cast<float*>(out), B, V, N, H, W, J, s);
}

// Adjoint of sp3d_sample_view: g (B, N, J) f32; px, py (B, N) f32 ->
// dhm (B, H, W, J) f32 += sum over points and taps of w_tap * g. The caller
// zeroes dhm first. Returns cudaGetLastError() after the launch.
extern "C" int sp3d_sample_view_adjoint(const float* g, const float* px, const float* py,
                                        float* dhm, int B, int N, int H, int W, int J,
                                        void* stream) {
  if (static_cast<int64_t>(B) * N == 0) return 0;
  if (J < 1 || J > 32 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (N + kRun - 1) / kRun;
  if (static_cast<int64_t>(B) * runs > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(sample_view_adjoint_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kAdjSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sample_view_adjoint_kernel<<<static_cast<unsigned>(B * runs), kThreads, kAdjSmem,
                               static_cast<cudaStream_t>(stream)>>>(g, px, py, dhm, N, H, W, J,
                                                                    runs);
  return static_cast<int>(cudaGetLastError());
}
