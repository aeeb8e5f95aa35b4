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
// What bounds it on an H100: at CI = CO = 32 the tensor-core operations
// (2*27*CI*CO per voxel: 580 GFLOP at 40 cubes of 64^3, 0.59 ms at 989
// TFLOP/s); at CI = 16 the bytes (input and output once: 1 GB, 0.30 ms).
// Closer in: a m64n32k16 wgmma reads 2 KB of A and 1 KB of B from shared
// memory, 24 cycles at 128 bytes a cycle against its 16 at the tensor
// peak, so at N = 32 shared memory bounds it near 0.9 ms.
//
// The design: an implicit GEMM, M = voxels, N = CO, K = 27 taps x CI, on
// wgmma (m64nNk16, bf16 operands from shared memory, f32 accumulators in
// registers). What it does about the faults of the first (WMMA) version:
//
// - wgmma, not WMMA (which lowers to mma.sync on Hopper). A block is four
//   warpgroups (two where the shared memory of four does not fit); a
//   warpgroup's M tile is 64 consecutive z of one output row (Z/64 tiles a
//   row, rounded up: at Z < 64 a tile's rows past Z are computed and not
//   stored). N is the block's slice of CO (16, 32, 64 or 128: all legal
//   wgmma widths); K steps through the 27 taps x CI/16. A tile's wgmmas go
//   out back to back, one commit and one wait a tile, on three accumulator
//   chains (one per dx, summed in f32 at the end) where N <= 64: the
//   wgmmas of one chain depend on each other, and at N = 32 one chain a
//   warpgroup left the tensor pipe waiting on their latency. No wgmma sits
//   on a thread-dependent branch (ptxas serialises those): every
//   warpgroup runs the same trip counts, and a tile past the step's last
//   is computed and not stored.
// - Weights in shared memory once per block. The wrapper repacks w once a
//   call into [27*CI/16][2][CO][8] (microbench/conv3.py:pack_weights):
//   each 16-channel k step, each 8-channel half and each output channel is
//   one 16-byte row, so a block copies its CO slice with 16-byte loads
//   straight into the canonical no-swizzle K-major B layout (core matrix =
//   8 output channels x 16 bytes; SBO 128 bytes between 8-channel groups,
//   LBO NT*16 bytes between the two k halves). Blocks are persistent (one
//   or two a SM, each walking many tiles), so the weights are read once per
//   block, not once per fragment. CO is cut into slices only where
//   27*CI*CO*2 bytes and the window do not fit (CI >= 48 at CO = 128).
// - The A operand and the halo layout: option (b) of the design note. The
//   window is stored channel-chunk-major, [plane][row][CI/8][Z+2][8
//   channels], so each voxel's 8 channels of a chunk are one 16-byte row
//   and 8 consecutive voxels one 128-byte core matrix: the A tile of tap
//   (dx, dy, dz) is a descriptor whose start moves by dz*16 bytes (every
//   shift 16-byte aligned), SBO 128 to the next 8 voxels, LBO (Z+2)*16 to
//   the next chunk. A tile never spans two rows, so one SBO serves it.
//   Option (a), ldmatrix into registers, needs a wgmma.fence after each
//   load and ran slower; 128-byte (B) and 32-byte (A) swizzled layouts
//   gave no gain over these.
// - The halo is read once per x-plane, not 4.5 times: a block walks a run
//   of y rows of one (b, x) column, S output rows a step (a tile a
//   warpgroup), and keeps a ring of 2S+2 input rows x 3 planes. Each step
//   loads only the S incoming rows, with cp.async (16 bytes a thread,
//   zero-filled where the row or plane lies outside the volume), into the
//   ring slots the step does not read, while the warpgroups run the step's
//   wgmmas. The z halo columns of the ring are zeroed once. Neighbouring
//   x-planes are walked by neighbouring blocks at the same time, so the 3
//   planes a block reads come from L2.
// - Occupancy: 84 KB of shared memory and 128 registers a block of 8 WMMA
//   warps before; now 183 KB (55 KB weights, 128 KB ring) at 32->32 for
//   512 threads, one block a SM, 16 warps; 92 KB at 16->32.
// - Epilogue: the accumulators are rounded to bf16 in registers; a quad of
//   lanes swaps its 4-byte pairs with shuffles so that each lane stores 16
//   bytes (8 channels) of one voxel; no staging tile and no __syncwarp. At
//   NT = 16 each lane stores 4 bytes.
//
// What still holds it back at 32->32: the tensor pipe's rate at N = 32
// with both operands read from shared memory (3 KB a m64n32k16), and the
// step's loads and epilogue, which overlap the wgmmas only in part.
//
// Takes CI, Z multiples of 16, CO in (16, 32, 64, 128), 16-byte-aligned
// tensors, and shapes whose ring and smallest weight slice fit in 227 KB
// (CI <= 64 at Z = 64); returns cudaErrorInvalidValue otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;     // wgmma M: output voxels of one warpgroup tile
constexpr size_t kSmemLimit = 227 * 1024;

struct Plan {
  int nt;   // output channels of a block's slice (wgmma N)
  int wgs;  // warpgroups a block, a 64-voxel tile each a step
  int S;   // output rows a step
  int RB;  // input rows the ring holds
  size_t w_bytes, ring_bytes;
};

// A tile is 64 consecutive z of one y row: Z/64 tiles a row (rounded up;
// a partial tile's rows past Z are computed and not stored). A step takes
// S rows, so that the step has about a tile a warpgroup.
Plan make_plan(int Z, int CI, int nt, int wgs) {
  Plan p;
  p.nt = nt;
  p.wgs = wgs;
  const int tiles_a_row = (Z + kTileM - 1) / kTileM;
  p.S = tiles_a_row >= wgs ? 1 : wgs / tiles_a_row;
  p.RB = 2 * p.S + 2;
  p.w_bytes = static_cast<size_t>(27) * CI * nt * 2;
  // + the rows a partial tile reads past the ring's last strip
  p.ring_bytes = static_cast<size_t>(3) * p.RB * (CI / 8) * (Z + 2) * 16 + (kTileM + 2) * 16;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// shared-memory writes of this thread (stores, completed cp.async) made
// visible to the async proxy that wgmma reads its operands through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the asm above
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, K-major, no swizzle
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// wgmma m64nNk16, D (f32, registers) += A * B (bf16, both in shared
// memory, K-major): one overload per N
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

template <int NT, int WGS>
__global__ void __launch_bounds__(128 * WGS)
conv3_kernel(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wpk,
             __nv_bfloat16* __restrict__ out, int B, int X, int Y, int Z, int CI, int CO, int S,
             int RB, int NR, int YR, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kThreads = 128 * WGS;
  constexpr int KC = NT <= 64 ? 3 : 1;  // accumulator chains
  const int C8 = CI / 8, C16 = CI / 16, KS = 27 * C16, ZP = Z + 2;
  const int tid = threadIdx.x;
  uint4* wsm = reinterpret_cast<uint4*>(smem);
  uint4* ring = reinterpret_cast<uint4*>(smem + static_cast<size_t>(KS) * 2 * NT * 16);
  const uint32_t wsm_u32 = smem_u32(wsm);
  const uint32_t ring_u32 = smem_u32(ring);
  const int row_bytes = C8 * ZP * 16;  // one input row of one plane in the ring
  const int plane_bytes = RB * row_bytes;
  for (int i = tid; i < 3 * RB * C8 * ZP + kTileM + 2; i += kThreads)
    ring[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  __syncthreads();

  const int wg = tid / 128;
  const int wl = (tid % 128) / 32;
  const int lane = tid % 32;
  const int TR = (Z + kTileM - 1) / kTileM;  // tiles a row
  const int MT = S * TR;                       // tiles a step
  // K-major, no swizzle. A: 8 voxels of one 8-channel chunk are a core
  // matrix (128 contiguous bytes), SBO 128 to the next 8 voxels, LBO
  // ZP*16 to the next chunk (channels 8..15 of the k step). B: 8 output
  // channels x 16 bytes, SBO 128, LBO NT*16 to the other k half.
  constexpr uint32_t kBStep = (2 * NT * 16) >> 4;  // one k step of B, descriptor units
  const uint64_t bdesc = desc_kmajor(wsm_u32, NT * 16, 128);
  const uint64_t adesc = desc_kmajor(0, ZP * 16, 128);  // + the start address a k step

  int cur_slice = -1;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int xi = u % X;
    int t = u / X;
    const int r = t % NR;
    t /= NR;
    const int b = t % B;
    const int slice = t / B;
    if (slice != cur_slice) {
      // every wgmma of the old slice has completed before the last barrier
      for (int i = tid; i < KS * 2 * NT; i += kThreads)
        wsm[i] = wpk[static_cast<size_t>(i / NT) * CO + slice * NT + i % NT];
      fence_async_smem();
      __syncthreads();
      cur_slice = slice;
    }
    const int ybeg = r * YR;
    const int yend = min(Y, ybeg + YR);

    // input rows yfirst .. yfirst+count-1 of planes x-1, x, x+1 into ring slot (y+1) % RB
    auto load_rows = [&](int yfirst, int count) {
      const int n = count * 3 * Z * C8;
      for (int i = tid; i < n; i += kThreads) {
        const int c = i % C8;
        int q = i / C8;
        const int z = q % Z;
        q /= Z;
        const int p = q % 3;
        const int y = yfirst + q / 3;
        const int xx = xi + p - 1;
        const bool ok = y >= 0 && y < Y && xx >= 0 && xx < X;
        const uint32_t dst = ring_u32 + p * plane_bytes + ((y + 1) % RB) * row_bytes +
                             (c * ZP + z + 1) * 16;
        const __nv_bfloat16* src =
            ok ? x + ((((static_cast<int64_t>(b) * X + xx) * Y + y) * Z + z) * CI + c * 8) : x;
        cp_async16(dst, src, ok);
      }
    };

    load_rows(ybeg - 1, S + 2);
    cp_async_commit();
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    for (int y0 = ybeg; y0 < yend; y0 += S) {
      if (y0 + S < yend) load_rows(y0 + S + 1, S);  // the next step's incoming rows
      cp_async_commit();

      // the same trip count in every warpgroup (a tile past MT is computed
      // and not stored), so no wgmma sits on a thread-dependent branch
      for (int it = 0; it < (MT + WGS - 1) / WGS; ++it) {
        const int mt = WGS * it + wg < MT ? WGS * it + wg : 0;
        const bool tile_ok = WGS * it + wg < MT;
        const int yl = mt / TR;
        const int z0 = (mt - yl * TR) * kTileM;
        // KC independent accumulator chains (one per dx where KC = 3): a
        // chain's wgmmas depend on each other, and at N <= 64 one chain
        // leaves the tensor pipe waiting on its latency
        float acc[KC][NT / 2];
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) acc[c][i] = 0.f;
        // every k step of the tile back to back: the A tile of tap (dx, dy,
        // dz), channels 16*cb.., starts at voxel z0+dz of chunk 2*cb of
        // input row y0+yl+dy-1 of plane dx
        const uint32_t tile_base = ring_u32 + z0 * 16;
        wgmma_fence();
        for (int d0 = 0; d0 < 3; d0 += KC) {
          for (int t9 = 0; t9 < 9; ++t9) {
            const int dy = t9 / 3, dz = t9 % 3;
            const uint32_t a0 = tile_base + ((y0 + yl + dy) % RB) * row_bytes + dz * 16;
            for (int cb = 0; cb < C16; ++cb) {
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                const int dx = d0 + c;
                wgmma_ss(acc[c], adesc + ((a0 + dx * plane_bytes + cb * 2 * ZP * 16) >> 4),
                         bdesc + ((dx * 9 + t9) * C16 + cb) * kBStep);
              }
            }
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < KC; ++c) fence_regs(acc[c]);
#pragma unroll
        for (int c = 1; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) acc[0][i] += acc[c][i];

        // accumulator (i): row 16*wl + lane/4 (+8 for i%4 >= 2), column
        // 8*(i/4) + 2*(lane%4) + i%2
        const int q = lane & 3;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int zr = z0 + 16 * wl + (lane >> 2) + 8 * half;
          const int y = y0 + yl;
          const bool store = tile_ok && zr < Z && y < yend;
          __nv_bfloat16* orow =
              out + ((((static_cast<int64_t>(b) * X + xi) * Y + y) * Z + zr) * CO + slice * NT);
          if constexpr (NT >= 32) {
#pragma unroll
            for (int gq = 0; gq < NT / 32; ++gq) {
              uint32_t in[4], o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int j = 4 * gq + jj;
                in[jj] = pack_bf16(acc[0][4 * j + 2 * half], acc[0][4 * j + 2 * half + 1]);
              }
              // lane q gathers 8-channel block 4*gq+q: word k from quad lane k
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                const int from = (q + rr) & 3;
                const uint32_t got =
                    __shfl_sync(0xffffffffu, pick4(in, (q - rr) & 3), (lane & ~3) | from);
                o[0] = from == 0 ? got : o[0];
                o[1] = from == 1 ? got : o[1];
                o[2] = from == 2 ? got : o[2];
                o[3] = from == 3 ? got : o[3];
              }
              if (store)
                *reinterpret_cast<uint4*>(orow + (4 * gq + q) * 8) =
                    make_uint4(o[0], o[1], o[2], o[3]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
              if (store)
                *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * q) =
                    pack_bf16(acc[0][4 * j + 2 * half], acc[0][4 * j + 2 * half + 1]);
          }
        }
      }
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();
    }
  }
}

template <int NT, int WGS>
int launch(const Plan& p, const __nv_bfloat16* x, const uint4* w, __nv_bfloat16* out, int B,
           int X, int Y, int Z, int CI, int CO, cudaStream_t stream) {
  const size_t smem = p.w_bytes + p.ring_bytes;
  constexpr int kThreads = 128 * WGS;
  cudaError_t e = cudaFuncSetAttribute(conv3_kernel<NT, WGS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, conv3_kernel<NT, WGS>, kThreads,
                                                         smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a unit is (CO slice, b, x, run of YR rows); runs are cut short only
  // where whole columns would leave blocks idle
  const int64_t cols = static_cast<int64_t>(CO / NT) * B * X;
  const int64_t resident = static_cast<int64_t>(sms) * occ;
  const int steps = (Y + p.S - 1) / p.S;
  const int64_t want = (2 * resident + cols - 1) / cols;
  const int nr0 = static_cast<int>(want < steps ? want : steps);
  const int YR = (steps + nr0 - 1) / nr0 * p.S;
  const int NR = (Y + YR - 1) / YR;
  const int64_t units = cols * NR;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(units < resident ? units : resident);
  conv3_kernel<NT, WGS><<<grid, kThreads, smem, stream>>>(x, w, out, B, X, Y, Z, CI, CO, p.S, p.RB,
                                                      NR, YR, static_cast<int>(units));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, X, Y, Z, CI) bf16; w: the weights (3, 3, 3, CI, CO) bf16 repacked
// as [27*CI/16][2][CO][8] (k step = tap*CI/16 + ci/16, half = ci/8 % 2,
// output channel, ci % 8; microbench/conv3.py:pack_weights) -> out
// (B, X, Y, Z, CO) bf16, SAME zero padding. Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int sp3d_conv3(const void* x, const void* w, void* out, int B, int X, int Y, int Z,
                          int CI, int CO, void* stream) {
  if (CI % 16 || Z % 16 || CI <= 0 || Z <= 0 || X < 0 || Y < 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (CO != 16 && CO != 32 && CO != 64 && CO != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * X * Y == 0) return 0;
  // the widest CO slice that fits, with four warpgroups where the ring of
  // four tiles' rows fits beside it, else two
  Plan p{};
  for (int nt = CO; nt >= 16 && p.nt == 0; nt /= 2)
    for (int wgs = 4; wgs >= 2 && p.nt == 0; wgs -= 2) {
      const Plan q = make_plan(Z, CI, nt, wgs);
      if (q.w_bytes + q.ring_bytes <= kSmemLimit) p = q;
    }
  if (p.nt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint4*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP3D_CONV3(N)                                                           \
  case N:                                                                       \
    return p.wgs == 4 ? launch<N, 4>(p, xb, wb, ob, B, X, Y, Z, CI, CO, s)      \
                      : launch<N, 2>(p, xb, wb, ob, B, X, Y, Z, CI, CO, s);
  switch (p.nt) {
    SP3D_CONV3(16)
    SP3D_CONV3(32)
    SP3D_CONV3(64)
    SP3D_CONV3(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SP3D_CONV3
}
