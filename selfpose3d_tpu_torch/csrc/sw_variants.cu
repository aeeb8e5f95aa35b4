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
// of heatmaps (one batch element's 2 MB stays in L2). The first design
// (one block a slice row, one thread a point, each tap a 4-byte load from
// a column-major plane) ran at 6.4x that bound: neighbouring threads read
// columns 512 B apart, so a warp's tap load touched up to 32 sectors, and
// a point's 15 channels x 4 taps cost about 1.9 KB of sector traffic for
// 60 B of output. The design now:
// - sw_pad_kernel writes a channel-last copy of the planes, (B, Wp, Hp,
//   Jp) with Jp the channels rounded up to a multiple of 4 (8.4 MB here;
//   sp3d_sw_scratch_floats sizes it), so a tap's four channels are one
//   aligned 16-byte load and all its channels one 16*Jp/4-byte span.
// - sw_slice_kernel: a block takes a band of kSub slice rows (notranspose:
//   the whole slice, whose every row's r it reads). It stages the rows'
//   coordinates in shared memory and builds the r table of all its rows
//   once, there too (int16; only the columns the mode reads; a thread
//   searches kCols columns at once, their dependent loads interleaved).
//   Pass 1, one thread a point, stages the point's four tap texels (16
//   bits each) and weights. Pass 2, one thread a channel quad, consecutive
//   threads on consecutive quads of a point, reads each tap as one 16-byte
//   load (two quads' eight loads in flight before either is combined) and
//   collects the outputs in a shared tile; they leave as 16-byte stores
//   along y, a channel's kSub rows being kSub*Yp contiguous floats of out.
// - where one channel is written (j1, or J = 1) there is no copy: one
//   thread a point (two at once, their eight taps in flight together)
//   reads channel 0's plane and stores its output, coalesced across y.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: full
// 0.779 ms (the first design 2.753; bound 0.428), j1 0.288 (0.349; bound
// 0.075). What holds it now is instruction issue and the block's phases,
// not bytes: the r table (about 1.9 searches and divisions a point) and
// the channel-quad arithmetic (separate multiplies and adds under
// -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kFull = 0, kJ1 = 1, kNoSearch = 2, kNoTranspose = 3, kNoPass2 = 4, kTap2 = 5 };

constexpr int kThreads = 256;
// slice rows a pass takes (kSub * Yp points): 4 where the outputs collect
// in a shared tile, 16 where one thread a point stores its output
constexpr int kSubQuad = 4;
constexpr int kSubOne = 16;
constexpr int kCols = 4;  // table columns one thread searches together

// Element e of rows of width w, as (row r, column c), stepped by a fixed
// stride without a division a step.
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int e, int stride, int w_)
      : r(e / w_), c(e % w_), dr(stride / w_), dc(stride % w_), w(w_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Columns of the r table a mode reads: the taps' columns x0c, x1c < W;
// nopass2's y < Yp; notranspose also reads column x < Xp of other rows.
__host__ __device__ int table_cols(int mode, int W, int Xp, int Yp) {
  return mode == kNoPass2 ? Yp : mode == kNoTranspose ? (W > Xp ? W : Xp) : W;
}

// r(c) of one slice row at the K columns c0 .. c0 + K - 1, their searches
// interleaved; xr, yr the row's xs, ys; st0 the search's first step (the
// largest power of two below Y - 1). Each column's arithmetic is the
// probe's.
template <bool SEARCH, int K>
__device__ __forceinline__ void row_r(const float* xr, const float* yr, int c0, int Y, int H,
                                      int st0, int (&r)[K]) {
  const float sgn = (xr[Y - 1] >= xr[0]) ? 1.f : -1.f;
  float cm[K];
  int seg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cm[k] = static_cast<float>(c0 + k) * sgn;
    seg[k] = 0;
  }
  if (SEARCH) {
    for (int st = st0; st >= 1; st >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int cand = seg[k] + st;
        const float val = xr[min(cand, Y - 2)] * sgn;
        if (cand <= Y - 2 && val <= cm[k]) seg[k] = cand;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float xk = xr[seg[k]] * sgn;
    const float xk1 = xr[seg[k] + 1] * sgn;
    const float yk = yr[seg[k]];
    const float yk1 = yr[seg[k] + 1];
    const float t = (cm[k] - xk) / (xk1 - xk + 1e-6f);
    const float yh = fminf(fmaxf(yk + t * (yk1 - yk), -4.f), static_cast<float>(H) + 3.f);
    r[k] = static_cast<int>(floorf(yh));
  }
}

// hm (B, J, WH) -> hp (B, WH, Jp), channels J..Jp-1 zero. A thread takes
// four consecutive texels of one channel quad: one 16-byte load from each
// of the quad's planes, one 16-byte store a texel; consecutive threads on
// consecutive quads. WH is a multiple of 4 and hm 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
sw_pad_kernel(const float* __restrict__ hm, float* __restrict__ hp, int64_t items, int J,
              int Jp, int WH) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= items) return;
  const int Q = Jp / 4;
  const int T4 = WH / 4;
  const int c = static_cast<int>(g % Q);
  const int64_t bt = g / Q;
  const int t4 = static_cast<int>(bt % T4);
  const int64_t b = bt / T4;
  float v[4][4];  // [channel i][texel k]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ch = 4 * c + i;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < J) a = __ldg(reinterpret_cast<const float4*>(hm + (b * J + ch) * WH) + t4);
    v[i][0] = a.x;
    v[i][1] = a.y;
    v[i][2] = a.z;
    v[i][3] = a.w;
  }
  float* dst = hp + (b * WH + 4 * static_cast<int64_t>(t4)) * Jp + 4 * c;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(dst + k * Jp) = make_float4(v[0][k], v[1][k], v[2][k], v[3][k]);
}

// One point's four tap texels (col * Hp + row, 16 bits each: Wp * Hp <=
// 65536) and its fractions. Taps a, b of corner 0 in t01, of corner 1 in
// t23; nopass2's four taps of column y in order.
struct __align__(16) Staged {
  unsigned t01, t23;
  float ux, vy;
};

// Tap texels of the point (xv, yv) of slice row xr, point y, in the order
// the combine step takes them, and the fractions. rt: the table of slice
// row xr; tab: the block's table (notranspose: every row's), Wc columns.
template <int MODE>
__device__ __forceinline__ void taps_of(float xv, float yv, const int16_t* tab,
                                        const int16_t* rt, int xr, int y, int Wc, int Hp,
                                        int Xp, int W, int H, int (&t)[4], float& ux,
                                        float& vy) {
  if (MODE == kNoPass2) {
    const int r = rt[y];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = y * Hp + clampi(r + j - 1, 0, H - 1);
    ux = vy = 0.f;
    return;
  }
  const float xf = floorf(xv), yf = floorf(yv);
  ux = xv - xf;
  vy = yv - yf;
  const int x0 = static_cast<int>(xf), y0 = static_cast<int>(yf);
  const int xc[2] = {clampi(x0, 0, W - 1), clampi(x0 + 1, 0, W - 1)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt[xc[i]];
    // first tap j of the two: s + 1 (s = clip(floor(ys) - r, -1, 1)), or 0 for tap2
    const int lo = (MODE == kTap2) ? 0 : clampi(y0 - r, -1, 1) + 1;
    int rr = r, col = xc[i];
    if (MODE == kNoTranspose) {
      // the tap row of slice row xc at column x, read from that row's table
      rr = (xc[i] < Xp) ? tab[xc[i] * Wc + xr] : 0;
      col = xr;
    }
    t[2 * i] = col * Hp + clampi(rr + lo - 1, 0, H - 1);
    t[2 * i + 1] = col * Hp + clampi(rr + lo, 0, H - 1);
  }
}

// The output from the four taps' values, in the plain version's order.
template <int MODE>
__device__ __forceinline__ float combine(float a, float b, float c, float d, float ux,
                                         float vy) {
  if (MODE == kNoPass2) return ((a + b) + c) + d;
  const float f0 = a * (1.f - vy) + b * vy;
  const float f1 = c * (1.f - vy) + d * vy;
  return f0 * (1.f - ux) + f1 * ux;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A block takes slice rows [x_lo, x_hi) of slice (b, s) (see the header
// note), kSub rows a pass. ONE: one channel written, one thread a point
// reading hm's plane 0; else pass 1 / pass 2 on hp, the channel-padded
// copy.
template <int MODE, bool ONE>
__global__ void __launch_bounds__(kThreads)
sw_slice_kernel(const float* __restrict__ hm, const float* __restrict__ hp,
                const float* __restrict__ xs, const float* __restrict__ ys,
                float* __restrict__ out, int S, int J, int Jp, int Wp, int Hp, int Xp, int Yp,
                int W, int H, int Y) {
  constexpr bool kAll = (MODE == kNoTranspose);  // the table of every slice row
  constexpr int kSub = ONE ? kSubOne : kSubQuad;
  // [kSub*Yp] staged points, [J][P] output tile, [2][kSub*Yp] coordinates
  // of kSub slice rows, [rows][Wc] r table
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = kSub * Yp + 4;
  const int Wc = table_cols(MODE, W, Xp, Yp);
  Staged* st = reinterpret_cast<Staged*>(smem);
  float* tile = reinterpret_cast<float*>(st + (ONE ? 0 : kSub * Yp));
  float* cx = tile + (ONE ? 0 : J * P);
  float* cy = cx + kSub * Yp;
  int16_t* tab = reinterpret_cast<int16_t*>(cy + kSub * Yp);
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t slice = static_cast<int64_t>(b) * S + s;
  const int x_lo = kAll ? 0 : blockIdx.x * kSub;
  const int x_hi = kAll ? Xp : min(Xp, x_lo + kSub);
  int st0 = 1;
  while (st0 * 2 < Y - 1) st0 *= 2;

  // coordinates of slice rows [x0, x0 + nr): nr*Yp contiguous floats
  auto stage_rows = [&](int x0, int nr) {
    const int64_t g = (slice * Xp + x0) * Yp;
    for (int e = tid; e < nr * Yp; e += kThreads) {
      cx[e] = xs[g + e];
      cy[e] = ys[g + e];
    }
  };
  // the table of rows [x_lo, x_hi), kSub rows at a time, kCols columns a
  // thread; the last chunk's coordinates stay staged
  const int G = (Wc + kCols - 1) / kCols;
  for (int c0 = x_lo; c0 < x_hi; c0 += kSub) {
    const int nr = min(kSub, x_hi - c0);
    stage_rows(c0, nr);
    __syncthreads();
    for (Walk e(tid, kThreads, G); e.r < nr; e.next()) {
      const int col = e.c * kCols;
      int r[kCols];
      row_r<MODE != kNoSearch, kCols>(cx + e.r * Yp, cy + e.r * Yp, col, Y, H, st0, r);
      int16_t* dst = tab + (c0 - x_lo + e.r) * Wc + col;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (col + k < Wc) dst[k] = static_cast<int16_t>(r[k]);
    }
    __syncthreads();
  }

  const int64_t chan = static_cast<int64_t>(Xp) * Yp;
  for (int xb = x_lo; xb < x_hi; xb += kSub) {
    const int n = min(kSub, x_hi - xb) * Yp;
    if (kAll) {  // the table's chunks left other rows' coordinates staged
      stage_rows(xb, n / Yp);
      __syncthreads();
    }
    // channel ch's n outputs are contiguous in out, from o + ch * chan
    float* o = out + slice * J * chan + static_cast<int64_t>(xb) * Yp;
    // point p = (pass row r, point c) of this pass
    auto taps = [&](const Walk& w, int (&t)[4], float& ux, float& vy) {
      const int p = w.r * Yp + w.c;
      taps_of<MODE>(cx[p], cy[p], tab, tab + (xb + w.r - x_lo) * Wc, xb + w.r, w.c, Wc, Hp,
                    Xp, W, H, t, ux, vy);
    };
    if (ONE) {
      const float* pl = hm + static_cast<int64_t>(b) * J * Wp * Hp;  // channel 0
      // two points a thread at once, p and p + kThreads: all eight taps
      // loaded, then combined
      Walk w(tid, kThreads, Yp);
      for (int p = tid; p < n; p += 2 * kThreads) {
        Walk w2 = w;
        w2.next();
        const bool two = p + kThreads < n;
        int t[2][4];
        float ux[2], vy[2];
        taps(w, t[0], ux[0], vy[0]);
        taps(two ? w2 : w, t[1], ux[1], vy[1]);
        float v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 4; ++k) v[h][k] = __ldg(pl + t[h][k]);
        o[p] = combine<MODE>(v[0][0], v[0][1], v[0][2], v[0][3], ux[0], vy[0]);
        if (two)
          o[p + kThreads] = combine<MODE>(v[1][0], v[1][1], v[1][2], v[1][3], ux[1], vy[1]);
        w = w2;
        w.next();
      }
      if (kAll) __syncthreads();  // cx, cy are restaged by the next pass
      continue;
    }
    {
      Walk w(tid, kThreads, Yp);
      for (int p = tid; p < n; p += kThreads, w.next()) {
        int t[4];
        float ux, vy;
        taps(w, t, ux, vy);
        st[p] = {static_cast<unsigned>(t[0]) | static_cast<unsigned>(t[1]) << 16,
                 static_cast<unsigned>(t[2]) | static_cast<unsigned>(t[3]) << 16, ux, vy};
      }
    }
    __syncthreads();
    const float* img = hp + b * static_cast<int64_t>(Wp) * Hp * Jp;
    // quad q is point r, channels 4c..4c+3; two quads a thread at once, q
    // and q + kThreads: all eight taps loaded, then combined
    Walk w(tid, kThreads, Jp / 4);
    for (int q = tid; q < n * (Jp / 4); q += 2 * kThreads) {
      Walk w2 = w;
      w2.next();
      const bool two = q + kThreads < n * (Jp / 4);
      const Walk wq[2] = {w, two ? w2 : w};
      Staged sp[2];
      float4 tv[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sp[h] = st[wq[h].r];
        const float* base = img + 4 * wq[h].c;
        tv[h][0] = load4(base + (sp[h].t01 & 0xffff) * Jp);
        tv[h][1] = load4(base + (sp[h].t01 >> 16) * Jp);
        tv[h][2] = load4(base + (sp[h].t23 & 0xffff) * Jp);
        tv[h][3] = load4(base + (sp[h].t23 >> 16) * Jp);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !two) break;
        const float4* v = tv[h];
        const float r[4] = {combine<MODE>(v[0].x, v[1].x, v[2].x, v[3].x, sp[h].ux, sp[h].vy),
                            combine<MODE>(v[0].y, v[1].y, v[2].y, v[3].y, sp[h].ux, sp[h].vy),
                            combine<MODE>(v[0].z, v[1].z, v[2].z, v[3].z, sp[h].ux, sp[h].vy),
                            combine<MODE>(v[0].w, v[1].w, v[2].w, v[3].w, sp[h].ux, sp[h].vy)};
        float* dst = tile + 4 * wq[h].c * P + wq[h].r;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * wq[h].c + i < J) dst[i * P] = r[i];
      }
      w = w2;
      w.next();
    }
    __syncthreads();
    // 16-byte stores where Yp is a multiple of 4 (then both sides are
    // 16-byte aligned)
    if (Yp % 4 == 0) {
      for (Walk e(tid, kThreads, n / 4); e.r < J; e.next())
        *reinterpret_cast<float4*>(o + e.r * chan + 4 * e.c) =
            *reinterpret_cast<const float4*>(tile + e.r * P + 4 * e.c);
    } else {
      for (Walk e(tid, kThreads, n); e.r < J; e.next()) o[e.r * chan + e.c] = tile[e.r * P + e.c];
    }
    __syncthreads();  // st, tile (and cx, cy) are rewritten by the next pass
  }
}

bool writes_one_channel(int mode, int J) { return mode == kJ1 || J == 1; }

size_t slice_smem(int mode, bool one, int J, int W, int Xp, int Yp) {
  const int kSub = one ? kSubOne : kSubQuad;
  const size_t rows = mode == kNoTranspose ? Xp : kSub;
  return (one ? 0 : kSub * static_cast<size_t>(Yp) * sizeof(Staged) +
                        static_cast<size_t>(J) * (kSub * Yp + 4) * sizeof(float)) +
         2 * static_cast<size_t>(kSub) * Yp * sizeof(float) +
         rows * table_cols(mode, W, Xp, Yp) * sizeof(int16_t);
}

template <int MODE, bool ONE>
int launch(const float* hm, const float* hp, const float* xs, const float* ys, float* out,
           int B, int S, int J, int Jp, int Wp, int Hp, int Xp, int Yp, int W, int H, int Y,
           cudaStream_t stream) {
  const size_t smem = slice_smem(MODE, ONE, J, W, Xp, Yp);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sw_slice_kernel<MODE, ONE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int kSub = ONE ? kSubOne : kSubQuad;
  const dim3 grid(MODE == kNoTranspose ? 1 : (Xp + kSub - 1) / kSub, S, B);
  sw_slice_kernel<MODE, ONE><<<grid, kThreads, smem, stream>>>(hm, hp, xs, ys, out, S, J, Jp,
                                                               Wp, Hp, Xp, Yp, W, H, Y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch sp3d_sw_variant needs for its channel-padded copy of
// hm: 0 where it writes one channel (j1, or J = 1), else B*Wp*Hp*Jp, Jp =
// J rounded up to a multiple of 4. The wrapper allocates what this returns
// and passes it as `padded`.
extern "C" int64_t sp3d_sw_scratch_floats(int mode, int B, int J, int Wp, int Hp) {
  if (writes_one_channel(mode, J)) return 0;
  return static_cast<int64_t>(B) * Wp * Hp * ((J + 3) / 4 * 4);
}

// hm (B, J, Wp, Hp) f32, 16-byte aligned; xs, ys (B, S, Xp, Yp) f32 (the
// probe's (B, S/SB, SB, Xp, Yp)) -> out (B, S, J, Xp, Yp) f32; mode 0..5 =
// full, j1, nosearch, notranspose, nopass2, tap2. padded:
// sp3d_sw_scratch_floats(mode, B, J, Wp, Hp) floats (may be null where
// that is 0). Takes Y <= Yp <= Wp, Xp <= Wp, W <= Wp, H <= Hp, Wp * Hp a
// multiple of 4 and at most 65536, H <= 32764 (the r table is int16).
// Returns cudaGetLastError() after the launches, cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int sp3d_sw_variant(const float* hm, const float* xs, const float* ys, float* out,
                               float* padded, int mode, int B, int S, int J, int Wp, int Hp,
                               int Xp, int Yp, int W, int H, int Y, void* stream) {
  if (mode < 0 || mode > kTap2 || Y < 2 || Y > Yp || W < 1 || W > Wp || H < 1 || H > Hp ||
      H > 32764 || Yp > Wp || Xp > Wp || static_cast<int64_t>(Wp) * Hp > 65536 ||
      (Wp * Hp) % 4 != 0 || J < 1 || S > 65535 || B > 65535 ||
      reinterpret_cast<uintptr_t>(hm) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * S * Xp * Yp == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Jp = (J + 3) / 4 * 4;
  const bool one = writes_one_channel(mode, J);
  if (!one) {
    if (padded == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t items = static_cast<int64_t>(B) * (Wp * Hp / 4) * (Jp / 4);
    sw_pad_kernel<<<static_cast<unsigned>((items + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        hm, padded, items, J, Jp, Wp * Hp);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
#define SP3D_SW(M, O) \
  return launch<M, O>(hm, padded, xs, ys, out, B, S, J, Jp, Wp, Hp, Xp, Yp, W, H, Y, st)
  switch (mode) {
    case kJ1: SP3D_SW(kJ1, true);
    case kFull: if (one) SP3D_SW(kFull, true); SP3D_SW(kFull, false);
    case kNoSearch: if (one) SP3D_SW(kNoSearch, true); SP3D_SW(kNoSearch, false);
    case kNoTranspose: if (one) SP3D_SW(kNoTranspose, true); SP3D_SW(kNoTranspose, false);
    case kNoPass2: if (one) SP3D_SW(kNoPass2, true); SP3D_SW(kNoPass2, false);
    default: if (one) SP3D_SW(kTap2, true); SP3D_SW(kTap2, false);
  }
#undef SP3D_SW
  return static_cast<int>(cudaErrorInvalidValue);
}
