// Hand-written Hopper (sm_90a) primitive-rate probe.
//
// sp3d_primitive replaces the TPU kernel bench_kernel of
// scripts/microbench.py (:99; pallas_call :111), which runs one Mosaic
// primitive body `reps` times inside one program on a tile held in VMEM,
// to price the primitives of the slice-warp cost model. The four bodies
// (:124, :134, :143, :152), i the repetition index:
//   0 gather            tbl (256, 128) -> out (256, 128):
//                       out[r, c] = tbl[r, clip(int(tbl[r, c]) + i, 0, 127)]
//   1 transpose         a (256, 128) -> out (128, 256): out = a.T + i
//   2 cmp_add           a (64, 256) -> out (64, 256): out += (a <= i)
//   3 transpose_64x256  a (64, 256) -> out (256, 128): out[:, :64] = a.T + i
// int() truncates toward zero. cmp_add starts from zero here (the TPU
// probe starts from uninitialised memory); transpose_64x256 writes zeros
// to out[:, 64:] (the TPU probe leaves them undefined).
//
// What it measures on an H100: the rate of one primitive on the whole
// card, as the TPU probe priced the v5e's one TensorCore, which is the
// whole chip. (The first version ran one block of 1024 threads, so it
// priced one SM of 132, and its keep() after every load made each
// repetition wait for the one before: one SM's latency chain.) What
// bounds it: the bodies' shared-memory loads (32 four-byte loads a clock
// an SM), far below the cost of one launch at the probe's 200
// repetitions. The design: the tile is cut into bands of output rows, a
// block a band (`band` rows; per_of says which bands it takes).
// Gather and cmp_add are row-local; a transpose's band of output rows
// reads the same band of input columns. A block copies the input its band
// reads into shared memory once (a transpose's columns with an odd row
// pitch, so a warp's 32 reads of one column fall in 32 banks), then runs
// every repetition on it, a thread PER outputs. The tile is read through a
// volatile pointer (ld.volatile.shared), which no compiler stage may
// hoist out of the loop or drop; an empty asm takes every repetition's
// result register, so that the front end folds no repetition whose result
// the next one overwrites. Repetitions run kUnroll at a time: the group's
// loads are all issued before the first asm takes a result, so kUnroll *
// PER independent loads are in flight (the gather's second loads after
// its first); a tail runs the reps % kUnroll left one at a time. The tile
// enters and leaves once.
//
// The probe's own check (chip_smoke.py) wants 400 repetitions to take at
// least 1.5 times as long as 200, so the repetitions must outweigh a
// launch's fixed cost (2.2-2.9 us on an H100: the launch, the band's
// load, the output's store). At the card's full width they do not for
// three bodies, so the wrapper's default band (primitives.py BANDS) is the
// most blocks at which the check holds with a margin, measured with
// `python -m selfpose3d_tpu_torch.microbench.primitives --bands`: gather
// 256 blocks, transpose and cmp_add 16, transpose_64x256 8. The time at
// 200 repetitions is then some 7-11 us for every body; the rate a body
// reaches is the slope between 200 and 400 repetitions at full width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)); }

// input IR x IC, output OR x OC, DC columns of a row written by a repetition
template <int BODY>
struct Shape {
  static constexpr int IR = (BODY <= 1) ? 256 : 64;
  static constexpr int IC = (BODY <= 1) ? 128 : 256;
  static constexpr bool kT = (BODY == 1 || BODY == 3);  // a transpose
  static constexpr int OR = (BODY == 0) ? 256 : (BODY == 1) ? 128 : (BODY == 2) ? 64 : 256;
  static constexpr int OC = (BODY == 0) ? 128 : (BODY == 1) ? 256 : (BODY == 2) ? 256 : 128;
  static constexpr int DC = (BODY == 3) ? 64 : OC;
};

// one repetition's value of output (rr, c) of the band, from the band's
// input in shared memory (t: row-local IC pitch; transposes: input row c,
// band column rr, pitch PT)
template <int BODY, int PT>
__device__ __forceinline__ float first(const volatile float* t, int rr, int c) {
  return Shape<BODY>::kT ? t[c * PT + rr] : t[rr * Shape<BODY>::IC + c];
}

// output rows of a band where a thread takes PER outputs (1 for the
// instances that per_of never launches: a DC of 256 needs PER >= 2)
template <int BODY, int PER>
__host__ __device__ constexpr int band_rows() {
  return PER * kThreads >= Shape<BODY>::DC ? PER * kThreads / Shape<BODY>::DC : 1;
}

// Repetitions i0 .. i0 + U - 1 of a thread's PER outputs: every load of
// the group issued, then every result taken by keep().
template <int BODY, int PER, int PT, int U>
__device__ __forceinline__ void group(const volatile float* vt, const int (&rr)[PER],
                                      const int (&c)[PER], float (&acc)[PER], int i0) {
  float v[U][PER];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < PER; ++k) v[u][k] = first<BODY, PT>(vt, rr[k], c[k]);
  if (BODY == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = min(max(static_cast<int>(v[u][k]) + i0 + u, 0), 127);
        v[u][k] = vt[rr[k] * Shape<BODY>::IC + idx];
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float fi = static_cast<float>(i0 + u);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (BODY == 2) {
        acc[k] += (v[u][k] <= fi) ? 1.f : 0.f;
        keep(acc[k]);
      } else {
        if (BODY != 0) v[u][k] += fi;
        keep(v[u][k]);
        acc[k] = v[u][k];
      }
    }
  }
}

template <int BODY, int PER>
__global__ void __launch_bounds__(kThreads)
primitive_band_kernel(const float* __restrict__ in, float* __restrict__ out, int reps) {
  using S = Shape<BODY>;
  constexpr int R = band_rows<BODY, PER>();
  constexpr int PT = (R % 2 == 0) ? R + 1 : R;  // a transpose's odd row pitch
  extern __shared__ __align__(16) float tile[];
  const int r0 = blockIdx.x * R;
  if (S::kT) {
    // input columns r0..r0+R-1 of every input row
    for (int e = threadIdx.x; e < S::IR * R; e += kThreads) {
      const int c = e / R;
      tile[c * PT + e - c * R] = in[c * S::IC + r0 + e - c * R];
    }
  } else {
    // input rows r0..r0+R-1, 16 bytes a load
    const float4* src = reinterpret_cast<const float4*>(in + r0 * S::IC);
    for (int e = threadIdx.x; e < R * S::IC / 4; e += kThreads)
      reinterpret_cast<float4*>(tile)[e] = src[e];
  }
  __syncthreads();

  // output k of this thread: band element threadIdx.x + k * kThreads, at
  // band row rr[k], column c[k]
  int rr[PER], c[PER];
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = threadIdx.x + k * kThreads;
    rr[k] = e / S::DC;
    c[k] = e % S::DC;
    acc[k] = 0.f;
  }
  const volatile float* vt = tile;
  int i = 0;
#pragma unroll 1
  for (; i + kUnroll <= reps; i += kUnroll) group<BODY, PER, PT, kUnroll>(vt, rr, c, acc, i);
#pragma unroll 1
  for (; i < reps; ++i) group<BODY, PER, PT, 1>(vt, rr, c, acc, i);

#pragma unroll
  for (int k = 0; k < PER; ++k) out[(r0 + rr[k]) * S::OC + c[k]] = acc[k];
  if (BODY == 3) {
    for (int e = threadIdx.x; e < R * 64; e += kThreads)
      out[(r0 + e / 64) * S::OC + 64 + e % 64] = 0.f;
  }
}

// PER = band * DC / kThreads outputs a thread; the kernel is built for
// PER in {1, 2, 4, 8, 16}, and the band must divide the output's rows
int per_of(int body, int band) {
  const int dc = (body == 0) ? 128 : (body == 3) ? 64 : 256;
  const int rows = (body == 0 || body == 3) ? 256 : (body == 1) ? 128 : 64;
  if (band < 1 || rows % band != 0 || band * dc % kThreads != 0) return 0;
  const int per = band * dc / kThreads;
  return (per == 1 || per == 2 || per == 4 || per == 8 || per == 16) ? per : 0;
}

template <int BODY, int PER>
int launch(const float* in, float* out, int reps, cudaStream_t stream) {
  using S = Shape<BODY>;
  constexpr int R = band_rows<BODY, PER>();
  constexpr int PT = (R % 2 == 0) ? R + 1 : R;
  const size_t smem = (S::kT ? S::IR * PT : R * S::IC) * sizeof(float);
  primitive_band_kernel<BODY, PER><<<S::OR / R, kThreads, smem, stream>>>(in, out, reps);
  return static_cast<int>(cudaGetLastError());
}

template <int BODY>
int launch_body(const float* in, float* out, int reps, int per, cudaStream_t stream) {
  switch (per) {
    case 1: return launch<BODY, 1>(in, out, reps, stream);
    case 2: return launch<BODY, 2>(in, out, reps, stream);
    case 4: return launch<BODY, 4>(in, out, reps, stream);
    case 8: return launch<BODY, 8>(in, out, reps, stream);
    case 16: return launch<BODY, 16>(in, out, reps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch of `reps` repetitions of body 0..3 (see above) on the input
// tile (16-byte aligned), `band` output rows a block; out is written once.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// an unknown body, a band it does not take, reps < 1 or a misaligned in.
extern "C" int sp3d_primitive(const float* in, float* out, int body, int reps, int band,
                              void* stream) {
  const int per = (body >= 0 && body <= 3) ? per_of(body, band) : 0;
  if (reps < 1 || per == 0 || reinterpret_cast<uintptr_t>(in) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: return launch_body<0>(in, out, reps, per, s);
    case 1: return launch_body<1>(in, out, reps, per, s);
    case 2: return launch_body<2>(in, out, reps, per, s);
    default: return launch_body<3>(in, out, reps, per, s);
  }
}
