// The epilogue of a convolution followed by an eval BatchNorm.
//
// sp3d_conv_epilogue replaces no TPU kernel: the JAX package applies eval
// BatchNorm as a per-channel affine (selfpose3d_tpu/models/norm.py:119-129)
// and XLA fuses it, the ReLU and the residual add into the convolution's
// consumer. Under PyTorch each of those was a pass of its own over the
// activation (the multiply and the add of a (C,) vector broadcast over a
// channels-last view even took the strided, unvectorised elementwise
// kernel). models/norm.py:conv_bn hands them all to one pass, here:
//
//   MODE 0: y = relu?((x + c)*s + b)
//   MODE 1: y = relu?((x + c)*s + b + r)
//   MODE 2: y = relu?((x + c)*s + b + ((r + rc)*rs + rb))   (a skip branch)
//   MODE 3: y = relu?((x + c)*s + b) + r
//
// x the convolution's output without its own bias c (optional: cuDNN
// leaves a convolution's bias to a pass of its own, which this one takes
// over), s and b the BatchNorm's (C,) scale and shift (float32, rounded to
// x's type as the modules cast them), r a residual of x's shape and layout,
// in MODE 2 a skip convolution's output with its bias rc, scale and shift.
// Each multiply and add is computed in float32 and rounded to x's type
// (bf16 or float32) on its own, in the order of the plain version
// (selfpose3d_tpu_torch/ops/conv_epilogue.py), which is the separate
// modules' code: the kernel gives their bits in both types, and saves only
// passes over memory. y may be x (in place).
//
// What bounds it on an H100: bytes. A few float operations an element
// against 4 (bf16) or 8 (float32) bytes read and written, 6 or 12 with a
// residual: 3.35 TB/s is the roof (a 64^3 x 32-channel bf16
// activation of 320 cubes, 5.4 GB, takes at least 3.2 ms). The design:
// - the tensor is channels-last and dense, so it is a (rows, C) matrix
//   and element i has channel i % C. A thread moves 16 bytes at a time (8
//   bf16 or 4 float32 lanes, C a multiple of the lanes, so a vector never
//   spans two rows), neighbouring threads on neighbouring vectors;
// - the (C,) vectors, each passed by its own pointer, sit in shared
//   memory, loaded once a block; a vector's 8 or 4 values of each are two
//   or one 16-byte shared loads;
// - grid-stride over vectors with 4 vectors in flight a thread (all loads
//   issued before the first store), a grid of 8 blocks of 256 an SM; a
//   thread's channel advances by the grid's stride modulo C, so the loop
//   divides nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int N = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T>
__device__ __forceinline__ void to_float(const uint4& v, float* f);

template <>
__device__ __forceinline__ void to_float<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // lane 2k in the low half of word k
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ uint4 from_float(const float* f);

template <>
__device__ __forceinline__ uint4 from_float<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 from_float<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // round to nearest even, as torch's .to(bfloat16)
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a float32 result rounded to T and back, as a torch op on T tensors
// rounds each result (to nearest even); float32 as it is
template <typename T>
__device__ __forceinline__ float rnd(float v);

template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.relu: NaN stays NaN, every other value not above 0 becomes +0
__device__ __forceinline__ float relu(float v) { return (v > 0.f || v != v) ? v : 0.f; }

// the L values of one (C,) vector that a vector of x meets, from shared memory
template <int L>
__device__ __forceinline__ void lanes(const float4* row, float* out) {
#pragma unroll
  for (int k = 0; k < L / 4; ++k) {
    const float4 t = row[k];
    out[4 * k] = t.x;
    out[4 * k + 1] = t.y;
    out[4 * k + 2] = t.z;
    out[4 * k + 3] = t.w;
  }
}

// The (C,) float32 vectors, each by its own pointer, in the order of
// their rows in shared memory: s, b[, c][, rs, rb[, rc]] (c where x_bias,
// rs and rb in MODE 2, rc where r_bias too).
struct Vectors {
  const float* row[6];
  int rows;
};

// x and y may be one buffer: no __restrict__ on them, no read-only loads.
// The vectors are rounded to T on their way to shared memory. Every
// multiply and add rounds to T on its own (no FMA), as the plain version's
// separate torch ops do.
template <typename T, int MODE, bool RELU>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const uint4* x, const Vectors vecs, const uint4* __restrict__ r,
                         uint4* y, int64_t nvec, int cvec, int x_bias, int r_bias) {
  constexpr int L = Lanes<T>::N;
  extern __shared__ float4 vec4[];  // rows of cvec * L floats
  float* vec = reinterpret_cast<float*>(vec4);
  const int row = cvec * (L / 4);  // float4s a row
  const int channels = cvec * L;
  for (int k = 0; k < vecs.rows; ++k) {
    for (int i = threadIdx.x; i < channels; i += kThreads) {
      vec[k * channels + i] = rnd<T>(vecs.row[k][i]);
    }
  }
  __syncthreads();
  const int rs_row = 2 + x_bias;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int smod = static_cast<int>(stride % cvec);
  int c = static_cast<int>(tid % cvec);
  for (int64_t base = tid; base < nvec; base += stride * kUnroll) {
    uint4 xv[kUnroll], rv[kUnroll];
    int cu[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u == 0) {
        cu[u] = c;
      } else {
        cu[u] = cu[u - 1] + smod;
        if (cu[u] >= cvec) cu[u] -= cvec;
      }
      const int64_t i = base + u * stride;
      if (i < nvec) {
        xv[u] = x[i];
        if (MODE != 0) rv[u] = r[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < nvec) {
        float v[L], q[L], sc[L], sh[L], cb[L], rsc[L], rsh[L], rcb[L];
        to_float<T>(xv[u], v);
        if (MODE != 0) to_float<T>(rv[u], q);
        const float4* at = vec4 + cu[u] * (L / 4);
        lanes<L>(at, sc);
        lanes<L>(at + row, sh);
        if (x_bias) lanes<L>(at + 2 * row, cb);
        if (MODE == 2) {
          lanes<L>(at + rs_row * row, rsc);
          lanes<L>(at + (rs_row + 1) * row, rsh);
          if (r_bias) lanes<L>(at + (rs_row + 2) * row, rcb);
        }
#pragma unroll
        for (int j = 0; j < L; ++j) {
          float a = x_bias ? rnd<T>(__fadd_rn(v[j], cb[j])) : v[j];
          a = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(a, sc[j])), sh[j]));
          if (MODE == 1) a = rnd<T>(__fadd_rn(a, q[j]));
          if (MODE == 2) {
            float b = r_bias ? rnd<T>(__fadd_rn(q[j], rcb[j])) : q[j];
            b = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(b, rsc[j])), rsh[j]));
            a = rnd<T>(__fadd_rn(a, b));
          }
          if (RELU) a = relu(a);
          if (MODE == 3) a = rnd<T>(__fadd_rn(a, q[j]));
          v[j] = a;
        }
        y[i] = from_float<T>(v);
      }
    }
    c = cu[kUnroll - 1] + smod;
    if (c >= cvec) c -= cvec;
  }
}

struct Shape {
  int64_t numel;
  int channels, x_bias, r_bias, blocks;
};

template <typename T, int MODE, bool RELU>
int launch(const void* x, const Vectors& v, const void* r, void* y, const Shape& sh,
           cudaStream_t stream) {
  constexpr int L = Lanes<T>::N;
  const int64_t nvec = sh.numel / L;
  const int64_t need = (nvec + static_cast<int64_t>(kThreads) * kUnroll - 1) /
                       (static_cast<int64_t>(kThreads) * kUnroll);
  const unsigned grid = static_cast<unsigned>(need < sh.blocks ? need : sh.blocks);
  conv_epilogue_kernel<T, MODE, RELU>
      <<<grid, kThreads, v.rows * sh.channels * sizeof(float), stream>>>(
          static_cast<const uint4*>(x), v, static_cast<const uint4*>(r), static_cast<uint4*>(y),
          nvec, sh.channels / L, sh.x_bias, sh.r_bias);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const Vectors& v, const void* r, void* y, const Shape& sh,
             int mode, int relu_on, cudaStream_t s) {
  switch (mode * 2 + (relu_on ? 1 : 0)) {
    case 0: return launch<T, 0, false>(x, v, r, y, sh, s);
    case 1: return launch<T, 0, true>(x, v, r, y, sh, s);
    case 2: return launch<T, 1, false>(x, v, r, y, sh, s);
    case 3: return launch<T, 1, true>(x, v, r, y, sh, s);
    case 4: return launch<T, 2, false>(x, v, r, y, sh, s);
    case 5: return launch<T, 2, true>(x, v, r, y, sh, s);
    case 6: return launch<T, 3, false>(x, v, r, y, sh, s);
    case 7: return launch<T, 3, true>(x, v, r, y, sh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y (numel,) as a dense channels-last (rows, channels) matrix of bf16
// (is_bf16) or float32, 16-byte aligned, channels a multiple of 8 (bf16)
// or 4 (float32); s, b, c, rs, rb, rc (channels,) float32 vectors: the
// scale and shift, the convolution's own bias c (or null), and in mode 2
// the skip branch's scale, shift and bias (rc or null; null otherwise);
// r like x, or null where mode is 0 (1: the residual before the ReLU, 2: a
// skip convolution's output through its own rc, rs and rb, 3: the
// residual after the ReLU); blocks the grid's most. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int sp3d_conv_epilogue(const void* x, const float* s, const float* b, const float* c,
                                  const void* r, const float* rs, const float* rb,
                                  const float* rc, void* y, int64_t numel, int channels,
                                  int is_bf16, int mode, int relu_on, int blocks, void* stream) {
  if (numel == 0) return 0;
  const int lanes = is_bf16 ? 8 : 4;
  Vectors v{{s, b}, 2};
  if (c != nullptr) v.row[v.rows++] = c;
  if (mode == 2) {
    v.row[v.rows++] = rs;
    v.row[v.rows++] = rb;
    if (rc != nullptr) v.row[v.rows++] = rc;
  }
  const Shape sh{numel, channels, c != nullptr ? 1 : 0, (mode == 2 && rc != nullptr) ? 1 : 0,
                 blocks};
  bool missing = false;
  for (int k = 0; k < v.rows; ++k) missing = missing || v.row[k] == nullptr;
  if (channels <= 0 || channels % lanes != 0 || numel % channels != 0 || blocks <= 0 ||
      mode < 0 || mode > 3 || (mode != 0 && r == nullptr) || missing ||
      v.rows * channels * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(x, v, r, y, sh, mode, relu_on, st);
  return dispatch<float>(x, v, r, y, sh, mode, relu_on, st);
}
