// Hand-written Hopper (sm_90a) k=3^3 SAME 3D convolution, NDHWC bf16.
//
// sp3d_conv3 replaces the TPU kernel _kernel / pallas_conv3 of
// scripts/microbench_pallas_conv.py (:29, :73; pallas_call :88), the
// im2col probe of the V2V's 3x3x3 convolutions at 64^3.
//
// What it computes: out[b, x, y, z, co] = bf16(sum over dx, dy, dz, ci of
// x[b, x+dx-1, y+dy-1, z+dz-1, ci] * w[dx, dy, dz, ci, co]), zero outside
// the volume: bf16 operands, every product and the 27*CI-term sum in f32,
// one rounding to bf16 at the end -- what the Pallas kernel computes with
// preferred_element_type=f32 and one astype. The sum runs in another order
// than the Pallas kernel's (or cuDNN's), so results may differ by one bf16
// ulp where an f32 sum lies next to a rounding boundary.
//
// None of the TPU kernel's layout machinery carries over: the overlapping
// halo windows it materialises in HBM (for Mosaic's block specs), the
// lane-concat of the dy taps into the contraction and the output-side
// row shifts of the dz taps. Here a block reads its halo window straight
// from the input into shared memory, zero-filled at the volume's edges.
//
// What bounds it on an H100: at CI = CO = 32 the tensor-core operations
// (2*27*CI*CO per voxel: 580 GFLOP at 40 cubes of 64^3, 0.59 ms at 989
// TFLOP/s); at CI = 16 the bytes (input and output once: 1 GB, 0.30 ms).
// The design: an implicit GEMM, M = voxels, N = CO, K = 27*CI, on the
// tensor cores through WMMA (m16n16k16, bf16 in, f32 accumulate). A block
// of 8 warps owns kRows output rows (y) of one x-plane, all z and all CO;
// its halo window (3 planes x kRows+2 rows x Z+2 x CI) sits in shared
// memory, so every A fragment (16 consecutive z of one row and tap, 16
// input channels) loads from it with leading dimension CI and no im2col
// copy. Each warp takes two 16-voxel tiles at a time so that each weight
// fragment (read from global memory; the weights are small and stay in
// L1/L2) feeds two products. The f32 accumulators go through a per-warp
// shared staging tile, are rounded to bf16 and stored 16 bytes a lane.
// First version: no TMA, no wgmma, no pipelining of the window load.
//
// Takes CI, CO and Z multiples of 16, CO <= 128, 16-byte-aligned tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // output y rows per block
constexpr int kTile = 16;

__host__ __device__ size_t window_bytes(int Z, int CI) {
  const size_t b = static_cast<size_t>(3) * (kRows + 2) * (Z + 2) * CI * sizeof(__nv_bfloat16);
  return (b + 127) / 128 * 128;
}

__host__ __device__ size_t smem_bytes(int Z, int CI) {
  return window_bytes(Z, CI) + kWarps * kTile * kTile * sizeof(float);
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
conv3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ out, int X, int Y, int Z, int CI) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CO = NT * kTile;
  const int ytiles = (Y + kRows - 1) / kRows;
  const int y0 = (blockIdx.x % ytiles) * kRows;
  const int bx = blockIdx.x / ytiles;  // b * X + x
  const int xi = bx % X;
  const int b = bx / X;
  const int ZP = Z + 2;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);

  // halo window, 16 bytes (8 channels) a thread at a time, zeros outside
  const int c8 = CI / 8;
  const int chunks = 3 * (kRows + 2) * ZP * c8;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    int rest = i / c8;
    const int c = i - rest * c8;
    const int zp = rest % ZP;
    rest /= ZP;
    const int r = rest % (kRows + 2);
    const int p = rest / (kRows + 2);
    const int xx = xi + p - 1, yy = y0 + r - 1, zz = zp - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (xx >= 0 && xx < X && yy >= 0 && yy < Y && zz >= 0 && zz < Z) {
      const int64_t off = (((static_cast<int64_t>(b) * X + xx) * Y + yy) * Z + zz) * CI + c * 8;
      v = *reinterpret_cast<const uint4*>(x + off);
    }
    *reinterpret_cast<uint4*>(win + static_cast<int64_t>(i) * 8) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + window_bytes(Z, CI)) + warp * kTile * kTile;
  const int zt = Z / kTile;
  const int mtiles = kRows * zt;
  for (int m0 = 2 * warp; m0 < mtiles; m0 += 2 * kWarps) {
    int yl[2], z0[2];
    bool ok[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int m = (m0 + t < mtiles) ? m0 + t : m0;  // a spare tile recomputes m0, unstored
      yl[t] = m / zt;
      z0[t] = (m % zt) * kTile;
      ok[t] = (m0 + t < mtiles) && (y0 + yl[t] < Y);
    }
    if (!ok[0] && !ok[1]) continue;
    wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[2][NT];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[t][n], 0.f);
    for (int tap = 0; tap < 27; ++tap) {
      const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
      const __nv_bfloat16* arow[2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        arow[t] = win + ((dx * (kRows + 2) + yl[t] + dy) * ZP + z0[t] + dz) * CI;
      const __nv_bfloat16* wtap = w + static_cast<int64_t>(tap) * CI * CO;
      for (int cb = 0; cb < CI; cb += kTile) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) wmma::load_matrix_sync(a[t], arow[t] + cb, CI);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, wtap + cb * CO + n * kTile, CO);
#pragma unroll
          for (int t = 0; t < 2; ++t) wmma::mma_sync(acc[t][n], a[t], bf, acc[t][n]);
        }
      }
    }
    // f32 tile -> bf16, 16 bytes a lane: lane owns row lane/2, columns (lane%2)*8..+8
    const int row = lane >> 1, col = (lane & 1) * 8;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (!ok[t]) continue;
      const int64_t vox =
          ((static_cast<int64_t>(b) * X + xi) * Y + y0 + yl[t]) * Z + z0[t] + row;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wmma::store_matrix_sync(stage, acc[t][n], kTile, wmma::mem_row_major);
        __syncwarp();
        uint4 packed;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
        const float* s = stage + row * kTile + col;
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(s[2 * k], s[2 * k + 1]);
        *reinterpret_cast<uint4*>(out + vox * CO + n * kTile + col) = packed;
        __syncwarp();
      }
    }
  }
}

template <int NT>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out, int B, int X,
           int Y, int Z, int CI, cudaStream_t stream) {
  const size_t smem = smem_bytes(Z, CI);
  cudaError_t e = cudaFuncSetAttribute(conv3_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>(B) * X * ((Y + kRows - 1) / kRows);
  conv3_kernel<NT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(x, w, out, X, Y,
                                                                              Z, CI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, X, Y, Z, CI) bf16; w (3, 3, 3, CI, CO) bf16 -> out (B, X, Y, Z, CO)
// bf16, SAME zero padding. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for shapes it does not take.
extern "C" int sp3d_conv3(const void* x, const void* w, void* out, int B, int X, int Y, int Z,
                          int CI, int CO, void* stream) {
  if (CI % kTile || CO % kTile || Z % kTile || CI <= 0 || CO <= 0 || CO > 8 * kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(Z, CI) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * X * Y == 0) return 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (CO / kTile) {
    case 1: return launch<1>(xb, wb, ob, B, X, Y, Z, CI, s);
    case 2: return launch<2>(xb, wb, ob, B, X, Y, Z, CI, s);
    case 4: return launch<4>(xb, wb, ob, B, X, Y, Z, CI, s);
    case 8: return launch<8>(xb, wb, ob, B, X, Y, Z, CI, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
