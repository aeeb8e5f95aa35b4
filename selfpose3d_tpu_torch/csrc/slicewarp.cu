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
// tap and channel). sp3d_sample_view at PoseNet's train shapes (2 x
// 2,621,440 points, J = 15) writes 315 MB of the 360 MB it must move; the
// views kernel (flagship inference: 8 x 5 views x 1,048,576 points) reads
// 503 MB of coordinates and writes 252 MB of bf16. The heatmaps they gather
// from are small (one batch element's 5 views: 9 MB) and stay in L2. The
// first design -- one thread a point, its J outputs stored at a J-float
// stride, each tap's J channels read as scalars -- spread each warp store
// over 60 sectors and ran at 7x and 15x those bounds. The design now
// (sample_views_kernel, both samplers; J = 1, RootNet, keeps one thread a
// point):
// - a block takes a run of 256 consecutive points of one batch element.
//   One thread a point loads its coordinates (and bounding weights),
//   coalesced, and stages its taps in shared memory: a 16-byte Staged a
//   point and view (tap code, fractions, bounding weight).
// - then a thread takes a quad, one point's channels 4c..4c+3, consecutive
//   threads on consecutive quads: per view one 16-byte staged point and one
//   16-byte load a tap in the image serve four outputs, and a point with no
//   tap in the image loads no texel (in a train step most points lie
//   outside a view). What limits the gathers is the SM's shared-memory and
//   L1 data path (128 bytes a clock), which the staged points and the texel
//   loads share: with a thread an output, each thread read its own copy of
//   the staged point and 4-byte texels, and that path set the views
//   kernel's time. The quads read a copy of the heatmaps with the channels
//   padded to a multiple of 4 (16-byte texel rows; sample_view_pad_kernel
//   makes it, into scratch of sp3d_forward_scratch_floats from the caller,
//   where J is not one or hm is not 16-byte aligned: 79 MB at the
//   flagship).
// - the run's outputs collect in a shared tile and leave as 16-byte (f32)
//   or 8-byte (bf16) stores, in the final dtype and layout (B, N, J).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W:
// sp3d_sample_view at the train shapes 0.185 ms (the first design 0.733,
// F.grid_sample 0.307, bound 0.108); sp3d_sample_views_mean 0.921 ms (the
// first design 3.81, bound 0.247); J = 1 at RootNet's shapes 0.0099 ms
// (F.grid_sample 0.0175).
//
// The adjoint is the transpose of sp3d_sample_view: every point adds
// w_tap * g[b, n, :] into the 4 texels it sampled, taps outside the image
// dropped, with the weights of taps_of below, into a heatmap gradient
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

struct Taps {
  int x0, y0;
  float w[4];
};

// the four taps (x0 + (t & 1), y0 + (t >> 1)) of (x, y) and their weights,
// in the arithmetic of the plain version (the forward kernels stage the
// fractions wx, wy and form the same weights where they use them)
__device__ __forceinline__ Taps taps_of(float x, float y) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  return {static_cast<int>(x0f), static_cast<int>(y0f),
          {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy}};
}

// One point's taps in one view, as the forward kernels stage them in shared
// memory (16 bytes, one load): om = off << 4 | mask, where off is the offset
// of tap 0's channel 0 (view * H*W*C + (y0*W + x0) * C, C the channel
// stride) and bit t of mask says tap t lands in the image; the fractions
// wx, wy of taps_of; the point's bounding weight in this view (views mean).
struct __align__(16) Staged {
  int om;
  float wx, wy, bnd;
};

__device__ __forceinline__ Staged stage(float x, float y, int H, int W, int C, int view_off,
                                        float bnd) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  int mask = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int xi = x0 + (t & 1);
    const int yi = y0 + (t >> 1);
    if (xi >= 0 && xi < W && yi >= 0 && yi < H) mask |= 1 << t;
  }
  // with no tap in the image x0 and y0 may be far outside; off is not read
  return {mask ? (view_off + (y0 * W + x0) * C) * 16 | mask : 0, x - x0f, y - y0f, bnd};
}

// the bilinear sample from the taps' values: taps 0..3 in order, each in
// the image adding value * weight (the weights of taps_of), the others
// nothing
__device__ __forceinline__ float combine(int om, float wx, float wy, const float (&t)[4]) {
  const float ax = 1.f - wx;
  const float ay = 1.f - wy;
  float v = 0.f;
  if (om & 1) v += t[0] * (ax * ay);
  if (om & 2) v += t[1] * (wx * ay);
  if (om & 4) v += t[2] * (ax * wy);
  if (om & 8) v += t[3] * (wx * wy);
  return v;
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// kVec consecutive outputs a thread: one 16-byte (f32) or 8-byte (bf16) store
constexpr int kVec = 4;
__device__ __forceinline__ void store_vec(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(o) = u;
}

// J = 1 (RootNet): one thread a point, its loads and stores coalesced.
__global__ void __launch_bounds__(kThreads)
sample_view_j1_kernel(const float* __restrict__ hm, const float* __restrict__ px,
                      const float* __restrict__ py, float* __restrict__ out, int64_t total,
                      int N, int H, int W) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* img = hm + i / N * H * W;
  const Staged s = stage(px[i], py[i], H, W, 1, 0, 0.f);
  const int o = s.om >> 4;
  const float t[4] = {s.om & 1 ? __ldg(img + o) : 0.f, s.om & 2 ? __ldg(img + o + 1) : 0.f,
                      s.om & 4 ? __ldg(img + o + W) : 0.f,
                      s.om & 8 ? __ldg(img + o + W + 1) : 0.f};
  out[i] = combine(s.om, s.wx, s.wy, t);
}

// sample_views_kernel reads a texel's channels four at a time, as 16-byte
// loads, from the heatmaps with their channels padded to Jp, a multiple of
// 4: this kernel makes that copy where it cannot read hm as it is
// (reads_in_place).
__global__ void __launch_bounds__(kThreads)
sample_view_pad_kernel(const float* __restrict__ hm, float4* __restrict__ hp, int64_t quads,
                       int J, int Q) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= quads) return;
  const int64_t t = g / Q;  // texel
  const int c = 4 * static_cast<int>(g - t * Q);
  const float* src = hm + t * J + c;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c + i < J ? __ldg(src + i) : 0.f;
  hp[g] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Writes the run's n*J outputs o[e] = tile[e], consecutive threads on
// consecutive groups of kVec, each group one vector store (the elements
// before the first aligned group and after the last one a scalar store
// each).
template <typename OutT>
__device__ __forceinline__ void write_run(OutT* __restrict__ o, const float* tile, int total) {
  const int tid = threadIdx.x;
  const int head = min(
      total, static_cast<int>((kVec - (reinterpret_cast<uintptr_t>(o) / sizeof(OutT)) % kVec) %
                              kVec));
  const int groups = (total - head) / kVec;
  if (tid < head) store(o + tid, tile[tid]);
  for (int g = tid; g < groups; g += kThreads) {
    const int e = head + kVec * g;
    const float v[kVec] = {tile[e], tile[e + 1], tile[e + 2], tile[e + 3]};
    store_vec(o + e, v);
  }
  for (int e = head + kVec * groups + tid; e < total; e += kThreads) store(o + e, tile[e]);
}

// A forward block's run of points.
constexpr int kFwdRun = 256;

// hp: the heatmaps (B, V, H, W, Jp), channels padded to Jp. kMean: the
// bounded mean over the V views (sp3d_sample_views_mean), else V = 1 and
// the samples themselves (sp3d_sample_view). Pass 1, one thread a point:
// coordinates (and bounding weights) loaded, taps staged. Pass 2, a thread
// a quad (point p, channels 4c..4c+3), consecutive threads on consecutive
// quads: per view one staged point and one 16-byte load a tap in the
// image. The run's outputs collect in a shared tile, then leave with
// vector stores.
template <bool kMean, typename OutT>
__global__ void __launch_bounds__(kThreads)
sample_views_kernel(const float* __restrict__ hp, const float* __restrict__ px,
                    const float* __restrict__ py, const float* __restrict__ bnd,
                    OutT* __restrict__ out, int V, int N, int H, int W, int J, int Jp, int run,
                    int runs) {
  // [V][run] staged taps, [run] denominators, [run * J] outputs
  extern __shared__ __align__(16) unsigned char smem[];
  Staged* st = reinterpret_cast<Staged*>(smem);
  float* den = reinterpret_cast<float*>(st + V * run);
  float* tile = den + run;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / runs;
  const int r0 = (blockIdx.x - b * runs) * run;
  const int n = min(run, N - r0);
  const int HWJp = H * W * Jp;
  for (int p = tid; p < n; p += kThreads) {
    float bsum = 0.f;
    for (int v = 0; v < V; ++v) {
      const int64_t k = (static_cast<int64_t>(b) * V + v) * N + r0 + p;
      const float bk = kMean ? bnd[k] : 0.f;
      st[v * run + p] = stage(px[k], py[k], H, W, Jp, v * HWJp, bk);
      bsum += bk;
    }
    den[p] = bsum + 1e-6f;
  }
  __syncthreads();
  const float* img = hp + static_cast<int64_t>(b) * V * HWJp;
  const int WJp = W * Jp;
  const int Q = Jp / 4;
  const int dp = kThreads / Q;
  const int dc = kThreads - dp * Q;
  int p = tid / Q;
  int c = tid - p * Q;
  const int views = kMean ? V : 1;
  for (int q = tid; q < n * Q; q += kThreads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int v = 0; v < views; ++v) {
      const Staged s = st[v * run + p];
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      if (s.om & 15) {
        const float* src = img + (s.om >> 4) + 4 * c;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 t0 = s.om & 1 ? load4(src) : z;
        const float4 t1 = s.om & 2 ? load4(src + Jp) : z;
        const float4 t2 = s.om & 4 ? load4(src + WJp) : z;
        const float4 t3 = s.om & 8 ? load4(src + WJp + Jp) : z;
        r[0] = combine(s.om, s.wx, s.wy, {t0.x, t1.x, t2.x, t3.x});
        r[1] = combine(s.om, s.wx, s.wy, {t0.y, t1.y, t2.y, t3.y});
        r[2] = combine(s.om, s.wx, s.wy, {t0.z, t1.z, t2.z, t3.z});
        r[3] = combine(s.om, s.wx, s.wy, {t0.w, t1.w, t2.w, t3.w});
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = kMean ? acc[i] + r[i] * s.bnd : r[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * c + i < J) {
        float m = acc[i];
        if (kMean) {
          m /= den[p];
          if (m != m) m = 0.f;  // nan_to_num(nan=0); +-inf are clipped below
          m = fminf(fmaxf(m, 0.f), 1.f);
        }
        tile[p * J + 4 * c + i] = m;
      }
    }
    p += dp;
    c += dc;
    if (c >= Q) {
      c -= Q;
      ++p;
    }
  }
  __syncthreads();
  write_run(out + (static_cast<int64_t>(b) * N + r0) * J, tile, n * J);
}

// tap t lands in the image with a nonzero weight
__device__ __forceinline__ bool tap_live(const Taps& tp, int t, int H, int W) {
  const int xi = tp.x0 + (t & 1);
  const int yi = tp.y0 + (t >> 1);
  return xi >= 0 && xi < W && yi >= 0 && yi < H && tp.w[t] != 0.f;
}

// The adjoint: a block takes a run of kRun consecutive points of one batch
// element (see the header note) and stages their cotangent rows in shared
// memory at an odd row stride (no bank conflicts when a thread walks its
// point's row).
constexpr int kRun = 512;
constexpr int kSubRun = 128;
constexpr int kAdjSmem = 96 * 1024;

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

// The forward kernels index one batch element's heatmaps (V*H*W*Jp floats,
// with the taps' reach past them) in int, 16 times that in a tap code.
bool forward_shape_ok(int V, int H, int W, int Jp) {
  return Jp >= 1 && Jp <= 32 && V >= 0 && H >= 0 && W >= 0 &&
         static_cast<int64_t>(V) * H * W * Jp + 2 * (static_cast<int64_t>(W) + 1) * Jp <=
             INT_MAX / 16;
}

// sp3d_sample_view at J = 1 (RootNet) takes one thread a point.
bool one_thread_a_point(bool mean, int J) { return !mean && J == 1; }

// sample_views_kernel reads hm as it is where its texel rows are 16-byte
// loads: J a multiple of 4 and hm 16-byte aligned (a contiguous view into
// a larger tensor need not be). Else it reads a copy padded to Jp.
bool reads_in_place(const float* hm, int J) {
  return J % 4 == 0 && reinterpret_cast<uintptr_t>(hm) % 16 == 0;
}

// The channel-quad forward pass: the padded copy unless reads_in_place
// (into `padded`, B*V*H*W*Jp floats), then sample_views_kernel.
template <bool kMean, typename OutT>
int launch_views(const float* hm, const float* px, const float* py, const float* bnd,
                   OutT* out, float* padded, int B, int V, int N, int H, int W, int J,
                   cudaStream_t stream) {
  const int Jp = (J + 3) / 4 * 4;
  if (!forward_shape_ok(V, H, W, Jp)) return static_cast<int>(cudaErrorInvalidValue);
  const float* hp = hm;
  if (!reads_in_place(hm, J)) {
    if (padded == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t quads = static_cast<int64_t>(B) * V * H * W * (Jp / 4);
    if (quads > 0) {
      const unsigned blocks = static_cast<unsigned>((quads + kThreads - 1) / kThreads);
      sample_view_pad_kernel<<<blocks, kThreads, 0, stream>>>(
          hm, reinterpret_cast<float4*>(padded), quads, J, Jp / 4);
      if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    }
    hp = padded;
  }
  // kFwdRun points a block, fewer where they outgrow 48 KB of shared
  // memory; past that at 32 points the block asks for more (up to 227 KB)
  auto smem_for = [&](int run) {
    return static_cast<size_t>(run) * (V * sizeof(Staged) + sizeof(float) + J * sizeof(float));
  };
  int run = kFwdRun;
  while (run > 32 && smem_for(run) > 48 * 1024) run /= 2;
  const size_t smem = smem_for(run);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sample_views_kernel<kMean, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int runs = (N + run - 1) / run;
  if (static_cast<int64_t>(B) * runs > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  sample_views_kernel<kMean, OutT><<<static_cast<unsigned>(B * runs), kThreads, smem, stream>>>(
      hp, px, py, bnd, out, V, N, H, W, J, Jp, run, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the forward entry needs for its padded copy of hm (B,
// V, H, W, J): 0 where it reads hm as it is, else B*V*H*W*Jp, Jp = J
// rounded up to a multiple of 4. mean: sp3d_sample_views_mean, else
// sp3d_sample_view (V = 1). The wrappers allocate what this returns and
// pass it as `padded`.
extern "C" int64_t sp3d_forward_scratch_floats(const float* hm, int mean, int B, int V, int H,
                                               int W, int J) {
  if (one_thread_a_point(mean, J) || reads_in_place(hm, J)) return 0;
  return static_cast<int64_t>(B) * V * H * W * ((J + 3) / 4 * 4);
}

// One view: hm (B, H, W, J) f32; px, py (B, N) f32 -> out (B, N, J) f32.
// padded: sp3d_forward_scratch_floats(hm, 0, B, 1, H, W, J) floats of
// scratch (may be null where that is 0). Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int sp3d_sample_view(const float* hm, const float* px, const float* py, float* out,
                                int B, int N, int H, int W, int J, float* padded,
                                void* stream) {
  if (static_cast<int64_t>(B) * N * J == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (one_thread_a_point(false, J)) {
    if (!forward_shape_ok(1, H, W, 1)) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t total = static_cast<int64_t>(B) * N;
    sample_view_j1_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads,
                            0, s>>>(hm, px, py, out, total, N, H, W);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_views<false>(hm, px, py, nullptr, out, padded, B, 1, N, H, W, J, s);
}

// V views: hm (B, V, H, W, J) f32; px, py, bnd (B, V, N) f32 ->
// out (B, N, J), bf16 when out_bf16 else f32. padded:
// sp3d_forward_scratch_floats(hm, 1, B, V, H, W, J) floats of scratch (may
// be null where that is 0). Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int sp3d_sample_views_mean(const float* hm, const float* px, const float* py,
                                      const float* bnd, void* out, int out_bf16, int B, int V,
                                      int N, int H, int W, int J, float* padded, void* stream) {
  if (static_cast<int64_t>(B) * N * J == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch_views<true>(hm, px, py, bnd, static_cast<__nv_bfloat16*>(out), padded, B, V,
                                N, H, W, J, s);
  }
  return launch_views<true>(hm, px, py, bnd, static_cast<float*>(out), padded, B, V, N, H, W,
                              J, s);
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
