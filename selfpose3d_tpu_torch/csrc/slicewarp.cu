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
// dropped, with the weights of bilinear<> below. Coordinates get no
// gradient. The TPU kernel turns this scatter into lane cumsums, a
// binary-search count and boundary gathers because TPU scatters are serial;
// none of that carries over. Here it is one thread per (batch, point) and
// one float32 atomicAdd (a RED to L2) per tap and channel into a heatmap
// gradient the caller has zeroed. Bytes bound it (g read once, 4*J bytes a
// point; the heatmap gradient is small), but what it costs is atomic
// traffic: neighbouring voxels project into the same texel (a 64^3 cube's
// voxel pitch is well under one heatmap pixel), so the adds serialise in
// L2. Contributions that are exactly zero (the cotangent of a zeroed
// candidate cube, a zero tap weight) are skipped: adding 0 changes nothing.
// Float atomics add in an order that varies from run to run, so two runs
// agree only to rounding of the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <int JMAX>
__global__ void __launch_bounds__(kThreads)
sample_view_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ px,
                           const float* __restrict__ py, float* __restrict__ dhm,
                           int64_t total, int N, int H, int W, int J) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / N;
  float gj[JMAX];
  const float* gp = g + i * J;
  bool any = false;
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    gj[j] = (j < J) ? gp[j] : 0.f;
    any = any || (gj[j] != 0.f);
  }
  if (!any) return;
  const float x = px[i];
  const float y = py[i];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const float w[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
  float* img = dhm + b * H * W * J;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int xi = x0 + (t & 1);
    const int yi = y0 + (t >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H || w[t] == 0.f) continue;
    float* p = img + (static_cast<int64_t>(yi) * W + xi) * J;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if (j < J && gj[j] != 0.f) atomicAdd(p + j, gj[j] * w[t]);
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
  const int64_t total = static_cast<int64_t>(B) * N;
  if (total == 0) return 0;
  const unsigned grid = blocks_for(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP3D_ADJOINT(JM) \
  sample_view_adjoint_kernel<JM><<<grid, kThreads, 0, s>>>(g, px, py, dhm, total, N, H, W, J)
  if (J <= 1) SP3D_ADJOINT(1);
  else if (J <= 4) SP3D_ADJOINT(4);
  else if (J <= 16) SP3D_ADJOINT(16);
  else if (J <= 32) SP3D_ADJOINT(32);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef SP3D_ADJOINT
  return static_cast<int>(cudaGetLastError());
}
