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
// to out[:, 64:] once at the end (the TPU probe leaves them undefined).
//
// What it measures on an H100: the rate of one primitive on one SM, the
// counterpart of one TensorCore running one program. One block of 1024
// threads; the input tile lives in shared memory (128 KB for 256 x 128 f32;
// transposed reads go through a row pitch of C + 1 floats, so a warp's 32
// reads of one column fall in 32 banks), the output tile in registers (at
// most 32 values a thread). Each repetition rereads the tile from shared
// memory: the tile is read through a volatile pointer (ld.volatile.shared),
// which no compiler stage may hoist out of the loop or drop, and an empty
// asm takes each output register so that the front end does not fold the
// repetitions whose results the next one overwrites (ptxas may still drop
// such a repetition's add; its loads, which are the gather or the
// transpose, stay). An empty asm with a memory clobber does not suffice:
// it emits nothing into the PTX, and ptxas hoisted the loop-invariant
// transposed loads (on the H100, 400 repetitions of transpose_64x256 took
// 1.2x the time of 200). The tile enters and leaves once; its bound is the
// repetitions' operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)); }

template <int BODY>
__global__ void __launch_bounds__(kThreads, 1)
primitive_kernel(const float* __restrict__ in, float* __restrict__ out, int reps) {
  extern __shared__ float tile[];
  // input IR x IC; output rows of OC columns, DC of them written by a repetition
  constexpr int IR = (BODY <= 1) ? 256 : 64;
  constexpr int IC = (BODY <= 1) ? 128 : 256;
  constexpr bool TRANSPOSED = (BODY == 1 || BODY == 3);
  constexpr int P = TRANSPOSED ? IC + 1 : IC;  // shared row pitch
  constexpr int OC = (BODY == 0) ? 128 : (BODY == 1) ? 256 : (BODY == 2) ? 256 : 128;
  constexpr int DC = (BODY == 3) ? 64 : OC;  // columns a repetition writes
  constexpr int N = (BODY == 0 || BODY == 1) ? 32768 : 16384;  // defined outputs
  constexpr int PER = N / kThreads;
  // output element threadIdx.x + k * kThreads is (row r0 + k * kThreads / DC, column c)
  const int c = threadIdx.x % DC;
  const int r0 = threadIdx.x / DC;

  for (int e = threadIdx.x; e < IR * IC; e += kThreads) tile[(e / IC) * P + e % IC] = in[e];
  __syncthreads();

  const volatile float* vt = tile;
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int r = r0 + k * (kThreads / DC);
      if (BODY == 0) {
        const int idx = min(max(static_cast<int>(vt[r * P + c]) + i, 0), 127);
        acc[k] = vt[r * P + idx];
      } else if (BODY == 2) {
        acc[k] += (vt[r * P + c] <= fi) ? 1.f : 0.f;
      } else {  // out[r, c] = a[c, r] + i
        acc[k] = vt[c * P + r] + fi;
      }
      keep(acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) out[(r0 + k * (kThreads / DC)) * OC + c] = acc[k];
  if (BODY == 3) {
    for (int e = threadIdx.x; e < 256 * 64; e += kThreads) out[(e / 64) * OC + 64 + e % 64] = 0.f;
  }
}

template <int BODY>
int launch(const float* in, float* out, int reps, cudaStream_t stream) {
  constexpr int IR = (BODY <= 1) ? 256 : 64;
  constexpr int IC = (BODY <= 1) ? 128 : 256;
  constexpr int P = (BODY == 1 || BODY == 3) ? IC + 1 : IC;
  const int smem = IR * P * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(primitive_kernel<BODY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  primitive_kernel<BODY><<<1, kThreads, smem, stream>>>(in, out, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of `reps` repetitions of body 0..3 (see above) on the input
// tile; out is written once. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for an unknown body or reps < 1.
extern "C" int sp3d_primitive(const float* in, float* out, int body, int reps, void* stream) {
  if (reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: return launch<0>(in, out, reps, s);
    case 1: return launch<1>(in, out, reps, s);
    case 2: return launch<2>(in, out, reps, s);
    case 3: return launch<3>(in, out, reps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
