// InstanceNorm (affine, biased variance) followed by mish, for sm_90a.
//
// Replaces the TPU kernel delivr_cfos_tpu/ops/pallas/fused_norm_mish.py:59
// (`instance_norm_mish_pallas`, body `_kernel`) with the same math:
//   per (n, c) plane of S = D * H * W voxels, in f32:
//     mean = sum(x) / S,  var = sum(x^2) / S - mean^2  (E[x^2] - mean^2)
//     y    = (x - mean) * rsqrt(var + 1e-5) * scale[c] + bias[c]
//     out  = y * tanh(softplus(y)), rounded once to the input type
//   x, out   (N, C, D, H, W) contiguous, f32 or bf16
//   scale, bias  (C,) f32
//
// Bound on an H100 SXM: bytes. It does ~20 operations per voxel against 4 or
// 8 bytes moved, far below the card's ~20 f32 operations per byte, so the
// least time is one read of x and one write of out at 3.35 TB/s.
//
// Design: one block owns one (n, c) plane, which is contiguous in NCDHW.
// Pass 1 reads the plane with 16-byte vector loads (a scalar head and tail
// align the vectors to the plane's address) and sums x and x^2 in f32: each
// thread in a fixed stride order, then warp shuffles, then shared memory, so
// the statistics are the same bits on every run (the streaming resume relies
// on that). Pass 2 reads the plane again, normalises, applies mish and
// writes: two reads and one write, as on the TPU, where the grid's first
// sweep accumulated into VMEM scratch and the second applied. A TPU grid runs
// its sweeps in order on one core; here the plane-per-block split keeps every
// reduction inside one block, so nothing crosses blocks and no atomics are
// needed. The second read mostly misses L2 at the large planes: fusing the
// apply into the next conv's loads (conv3d_cs's in_affine) would remove it.
//
// Rounding: the variance and the affine steps use explicitly rounded
// operations (no contraction into fma), so a one-voxel plane gives var = 0
// exactly; the variance is clamped at 0 all the same. softplus is written as
// max(y, 0) + log1p(exp(-|y|)) with the accurate expf/log1pf/tanhf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T <-> V floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);  // the lower address holds element 0
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
    return a | (b << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float norm_mish(float x, float mean, float inv,
                                           float scale, float bias) {
  float y = __fmul_rn(__fsub_rn(x, mean), inv);
  y = __fadd_rn(__fmul_rn(y, scale), bias);
  const float sp = fmaxf(y, 0.0f) + log1pf(expf(-fabsf(y)));
  return __fmul_rn(y, tanhf(sp));
}

// Sums a and b over the block in a fixed order; every thread gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    sh[warp] = a;
    sh[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    a = lane < n_warps ? sh[lane] : 0.0f;
    b = lane < n_warps ? sh[32 + lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sh[64] = a;
      sh[65] = b;
    }
  }
  __syncthreads();
  a = sh[64];
  b = sh[65];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    instance_norm_mish_kernel(const T* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int C, long long S,
                              int vec_ok) {
  constexpr int V = Vec<T>::V;
  __shared__ float sh[66];
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % C);
  const T* xp = x + plane * S;
  T* op = out + plane * S;

  // scalar head up to the first 16-byte boundary, vectors, scalar tail;
  // vec_ok says x and out share their alignment modulo 16 bytes
  long long head = S;
  if (vec_ok) {
    const long long mis =
        static_cast<long long>((reinterpret_cast<uintptr_t>(xp) % 16) / sizeof(T));
    head = mis ? V - mis : 0;
    if (head > S) head = S;
  }
  const long long n_vec = (S - head) / V;
  const long long tail = head + n_vec * V;
  const uint4* xv = reinterpret_cast<const uint4*>(xp + head);
  uint4* ov = reinterpret_cast<uint4*>(op + head);

  // pass 1: per-thread partial sums in a fixed order
  float s1 = 0.0f, s2 = 0.0f;
  for (long long i = threadIdx.x; i < head; i += THREADS) {
    const float v = load_f(xp + i);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  for (long long i = threadIdx.x; i < n_vec; i += THREADS) {
    float f[V];
    Vec<T>::unpack(__ldg(xv + i), f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1 += f[k];
      s2 = fmaf(f[k], f[k], s2);
    }
  }
  for (long long i = tail + threadIdx.x; i < S; i += THREADS) {
    const float v = load_f(xp + i);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  block_sum2(s1, s2, sh);

  const float inv_n = 1.0f / static_cast<float>(S);
  const float mean = __fmul_rn(s1, inv_n);
  const float var =
      fmaxf(__fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean)), 0.0f);
  const float inv = 1.0f / sqrtf(var + EPS);
  const float sc = scale[c];
  const float bi = bias[c];

  // pass 2: normalise, mish, one rounding to T
  for (long long i = threadIdx.x; i < head; i += THREADS)
    store_f(op + i, norm_mish(load_f(xp + i), mean, inv, sc, bi));
  for (long long i = threadIdx.x; i < n_vec; i += THREADS) {
    float f[V];
    Vec<T>::unpack(__ldg(xv + i), f);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = norm_mish(f[k], mean, inv, sc, bi);
    ov[i] = Vec<T>::pack(f);
  }
  for (long long i = tail + threadIdx.x; i < S; i += THREADS)
    store_f(op + i, norm_mish(load_f(xp + i), mean, inv, sc, bi));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// is_bf16: 0 for f32 x/out, 1 for bf16.
extern "C" int instance_norm_mish_launch(const void* x, const void* scale,
                                         const void* bias, void* out, int N,
                                         int C, long long S, int is_bf16,
                                         int vec_ok, void* stream) {
  const long long planes = static_cast<long long>(N) * C;
  if (planes <= 0 || planes > 0x7fffffffLL || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(planes));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    instance_norm_mish_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc, bi,
        static_cast<__nv_bfloat16*>(out), C, S, vec_ok);
  } else {
    instance_norm_mish_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), sc, bi, static_cast<float*>(out), C, S,
        vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}
