// Hand-written Hopper (sm_90a) kernel for the slice-warp ablation probe.
//
// sp3d_sw_variant replaces the TPU kernel make_kernel(mode) of
// scripts/microbench_sw_variants.py (:21; pallas_call :91): the
// column-hosted slice-warp forward in six ablation modes, which the probe
// times to attribute the per-slice cost of the TPU sampler to its stages.
//
// What it computes, per slice row x (of Xp) with coordinates xs, ys (Yp
// each; the first Y of xs are the row's search table) and heatmap plane
// hm[col, row] (Wp x Hp, image W x H):
//   sgn = +1 if xs[Y-1] >= xs[0] else -1; xs_m = xs * sgn;
//   for each column c < Wp: seg(c) = branchless search over xs_m[0:Y-1]
//     (steps 32..1 for Y = 64, from 0: take cand = seg + step if cand <= Y-2
//     and xs_m[min(cand, Y-2)] <= c*sgn);
//   t = (c*sgn - xs_m[seg]) / (xs_m[seg+1] - xs_m[seg] + 1e-6);
//   r(c) = floor(clip(ys[seg] + t*(ys[seg+1] - ys[seg]), -4, H+3)).
// Per point (x, y): x0c = clip(floor(xs), 0, W-1), x1c = clip(x0c+1 ...),
// s_i = clip(floor(ys) - r(x_ic), -1, 1),
// tap(col, rr, j) = hm[col, clip(rr + j - 1, 0, H-1)],
// F_i = tap(x_ic, r(x_ic), s_i+1)*(1-vy) + tap(x_ic, r(x_ic), s_i+2)*vy,
// out = F0*(1-ux) + F1*ux, for each channel. The modes:
//   full; nosearch (seg = 0); tap2 (taps j = 0, 1, no selection);
//   nopass2 (out = sum_{j<4} hm[y, clip(r(y) + j - 1, 0, H-1)]);
//   j1 (channel 0 only; the other channels are not written);
//   notranspose (the probe's "WRONG values, same shapes" variant: its taps
//   read hm[x, clip(R + j - 1, 0, H-1)], R = r of slice row x_ic at column
//   x when x_ic < Xp, else 0; the probe defines it only for x_ic < 128).
// The floors make the result jump where an interpolated row crosses an
// integer, so this source is compiled with -fmad=false: every a*b + c
// rounds twice, as the probe and the plain version compute it.
//
// None of the TPU machinery carries over: the lane gathers of <= 128
// lanes, the transposes between the row table and the tap planes, the
// (8, 128) tiling. The stages those modes ablate on the TPU (search,
// transposes, second gather pass) map onto different GPU costs, so this
// kernel's mode times attribute the GPU's cost, not the TPU's.
//
// What bounds it on an H100: bytes. The output (B, S, J, Xp, Yp) f32 is
// 1.26 GB at the probe's shapes, against 168 MB of coordinates and 8 MB
// of heatmaps (one batch element's 2 MB stays in L2). The design: one
// block per slice row (b, s, x), one thread per output point (y); the
// block's threads first build the row's r table for all Wp columns in
// shared memory (each column's search reads the row's xs from shared
// memory), then every thread samples its point for each channel and
// writes out[b, s, ch, x, y], coalesced across y. notranspose needs r of
// other rows, which each thread searches for itself in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kFull = 0, kJ1 = 1, kNoSearch = 2, kNoTranspose = 3, kNoPass2 = 4, kTap2 = 5 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// r(c) of one slice row: xr, yr the row's xs, ys (any memory space).
template <bool SEARCH>
__device__ int row_r(const float* xr, const float* yr, int c, int Y, int H) {
  const float sgn = (xr[Y - 1] >= xr[0]) ? 1.f : -1.f;
  const float cm = static_cast<float>(c) * sgn;
  int seg = 0;
  if (SEARCH) {
    int st = 1;
    while (st * 2 < Y - 1) st *= 2;
    for (; st >= 1; st >>= 1) {
      const int cand = seg + st;
      const float val = xr[min(cand, Y - 2)] * sgn;
      if (cand <= Y - 2 && val <= cm) seg = cand;
    }
  }
  const float xk = xr[seg] * sgn;
  const float xk1 = xr[seg + 1] * sgn;
  const float yk = yr[seg];
  const float yk1 = yr[seg + 1];
  const float t = (cm - xk) / (xk1 - xk + 1e-6f);
  const float yh = fminf(fmaxf(yk + t * (yk1 - yk), -4.f), static_cast<float>(H) + 3.f);
  return static_cast<int>(floorf(yh));
}

template <int MODE>
__global__ void sw_kernel(const float* __restrict__ hm, const float* __restrict__ xs,
                          const float* __restrict__ ys, float* __restrict__ out, int S, int J,
                          int Wp, int Hp, int Xp, int Yp, int W, int H, int Y) {
  extern __shared__ float smem[];
  float* xrow = smem;       // Yp
  float* yrow = smem + Yp;  // Yp
  int* rtab = reinterpret_cast<int*>(smem + 2 * Yp);  // Wp
  const int x = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t slice = static_cast<int64_t>(b) * S + s;
  const float* xs_s = xs + slice * Xp * Yp;
  const float* ys_s = ys + slice * Xp * Yp;
  for (int i = threadIdx.x; i < Yp; i += blockDim.x) {
    xrow[i] = xs_s[static_cast<int64_t>(x) * Yp + i];
    yrow[i] = ys_s[static_cast<int64_t>(x) * Yp + i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Wp; c += blockDim.x)
    rtab[c] = row_r<MODE != kNoSearch>(xrow, yrow, c, Y, H);
  __syncthreads();

  const int nch = (MODE == kJ1) ? 1 : J;
  for (int y = threadIdx.x; y < Yp; y += blockDim.x) {
    float* o = out + (slice * J * Xp + x) * Yp + y;  // channel 0
    const int64_t chan = static_cast<int64_t>(Xp) * Yp;
    if (MODE == kNoPass2) {
      const int r = rtab[y];
      for (int ch = 0; ch < nch; ++ch) {
        const float* p = hm + ((static_cast<int64_t>(b) * J + ch) * Wp + y) * Hp;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc = acc + p[clampi(r + j - 1, 0, H - 1)];
        o[ch * chan] = acc;
      }
      continue;
    }
    const float xv = xrow[y], yv = yrow[y];
    const float xf = floorf(xv), yf = floorf(yv);
    const float ux = xv - xf, vy = yv - yf;
    const int x0 = static_cast<int>(xf), y0 = static_cast<int>(yf);
    const int xc[2] = {clampi(x0, 0, W - 1), clampi(x0 + 1, 0, W - 1)};
    int rr[2], lo[2], col[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rtab[xc[i]];
      // first tap j of the two: s + 1 (s = clip(floor(ys) - r, -1, 1)), or 0 for tap2
      lo[i] = (MODE == kTap2) ? 0 : clampi(y0 - r, -1, 1) + 1;
      if (MODE == kNoTranspose) {
        // the tap row of slice row xc at column x, read from that row
        const int64_t xo = static_cast<int64_t>(xc[i]) * Yp;
        rr[i] = (xc[i] < Xp) ? row_r<true>(xs_s + xo, ys_s + xo, x, Y, H) : 0;
        col[i] = x;
      } else {
        rr[i] = r;
        col[i] = xc[i];
      }
    }
    for (int ch = 0; ch < nch; ++ch) {
      const float* p = hm + (static_cast<int64_t>(b) * J + ch) * Wp * Hp;
      float F[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* pc = p + static_cast<int64_t>(col[i]) * Hp;
        const float t0 = pc[clampi(rr[i] + lo[i] - 1, 0, H - 1)];
        const float t1 = pc[clampi(rr[i] + lo[i], 0, H - 1)];
        F[i] = t0 * (1.f - vy) + t1 * vy;
      }
      o[ch * chan] = F[0] * (1.f - ux) + F[1] * ux;
    }
  }
}

template <int MODE>
int launch(const float* hm, const float* xs, const float* ys, float* out, int B, int S, int J,
           int Wp, int Hp, int Xp, int Yp, int W, int H, int Y, cudaStream_t stream) {
  const dim3 grid(Xp, S, B);
  const int threads = Yp < 1024 ? ((Yp + 31) / 32) * 32 : 1024;
  const size_t smem = (2 * static_cast<size_t>(Yp) + Wp) * sizeof(float);
  sw_kernel<MODE><<<grid, threads, smem, stream>>>(hm, xs, ys, out, S, J, Wp, Hp, Xp, Yp, W, H,
                                                   Y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hm (B, J, Wp, Hp) f32; xs, ys (B, S, Xp, Yp) f32 (the probe's
// (B, S/SB, SB, Xp, Yp)) -> out (B, S, J, Xp, Yp) f32; mode 0..5 = full,
// j1, nosearch, notranspose, nopass2, tap2. Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for arguments it does not take.
extern "C" int sp3d_sw_variant(const float* hm, const float* xs, const float* ys, float* out,
                               int mode, int B, int S, int J, int Wp, int Hp, int Xp, int Yp,
                               int W, int H, int Y, void* stream) {
  if (Y < 2 || Y > Yp || W < 1 || W > Wp || H < 1 || H > Hp || Yp > Wp ||
      (2 * static_cast<size_t>(Yp) + Wp) * sizeof(float) > 48 * 1024 || S > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * S * Xp * Yp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP3D_SW(M) return launch<M>(hm, xs, ys, out, B, S, J, Wp, Hp, Xp, Yp, W, H, Y, s)
  switch (mode) {
    case kFull: SP3D_SW(kFull);
    case kJ1: SP3D_SW(kJ1);
    case kNoSearch: SP3D_SW(kNoSearch);
    case kNoTranspose: SP3D_SW(kNoTranspose);
    case kNoPass2: SP3D_SW(kNoPass2);
    case kTap2: SP3D_SW(kTap2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SP3D_SW
}
