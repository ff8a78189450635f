// The fast forwards' epilogue, bf16(act(x * a + c [+ r * a_r + c_r])), in one
// pass, for sm_90a: BasicUNet's mish instance, and SwinUNETR's LeakyReLU(0.01)
// instances with and without the residual operand r.
//
// Replaces the XLA fusion of delivr_cfos_tpu/models/basic_unet_cs.py:108
// (`_affine_mish_cs`), which the TPU runs as one elementwise pass after each
// 3x3x3 conv of the fast forward:
//   x, out  (B, D, C, S) bf16 contiguous, S = H * W (the conv3d_cs layout)
//   a, c    (B, C) f32: the InstanceNorm folded into one affine per (b, c)
//   v       = x * a + c, in f32, rounded after the multiply and after the add
//   out     = v * tanh(softplus(v)), rounded once to bf16
// The other instances (SwinUNETR's residual blocks, lrelu(IN(conv2) + r)):
//   r, a_r, c_r  optional: r (B, D, C, S) bf16 at x's alignment, a_r and
//                c_r (B, C) f32; v = (x * a + c) + (r * a_r + c_r), each
//                product and sum rounded in f32 in that order
//   out          = v > 0 ? v : v * 0.01, rounded once to bf16, or mish(v)
// The mish instance without r is the kernel BasicUNet has run since it was
// written: the same arithmetic, launch and grid.
//
// Bound on an H100 SXM: bytes. One read of x and one write of out, 4 bytes an
// element, at 3.35 TB/s is 0.84 G elements a millisecond; the card runs
// about 30 G thread instructions a millisecond, so the pass stays bound by
// bytes only below some 35 instructions an element, index arithmetic
// included. Accurate expf + log1pf + tanhf alone come near that, so mish uses
// one fast exponential: tanh(softplus(v)) = n / (n + 2) with
// n = e^v (e^v + 2), and v itself above softplus's threshold of 20, as
// F.softplus has it. Below v = -64, e^v nears the end of f32's normal range
// (ex2.approx flushes below 2^-126), so there the kernel computes
// v * e^v (what n / (n + 2) is to f32 precision) scaled by 2^64 and scales
// back with one rounding, which keeps the subnormal results of the plain
// version. Against the plain version (expf, log1pf, tanhf through PyTorch)
// the f32 results differ by a few f32 ULPs, so the bf16 outputs differ by at
// most one bf16 ULP.
//
// Design: the tensor is one flat array. Each thread takes 16-byte vectors of
// 8 elements in a grid-stride loop (a grid the size of the card's resident
// blocks), UNROLL vectors loaded before any is computed. A vector's row
// (b, d, c) comes from its flat index by multiplication with precomputed
// reciprocals (no integer division on the card), and its factors from
// a[b, c], c[b, c]. S need not be a multiple of 8: a vector that crosses the
// end of its row steps to the next row's factors, element by element. A base
// pointer off 16-byte alignment is handled by a scalar head up to the first
// boundary and a scalar tail, as csrc/instance_norm_mish.cu does; the wrapper
// gives out the same alignment as x, so both are vectors at the same offsets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;       // bf16 elements in 16 bytes
constexpr int UNROLL = 2;  // vectors in flight a thread
constexpr float SOFTPLUS_THRESHOLD = 20.0f;
constexpr float LOW = -64.0f;        // below: the scaled path
constexpr float LOG2E = 1.4426950408889634f;
constexpr float TWO_M64 = 5.421010862427522e-20f;  // 2^-64

// floor(n / d) as a multiply-high and a shift (Granlund and Montgomery, 1994,
// theorem 4.2): with 2^(l-1) < d <= 2^l and m = ceil(2^(N+l) / d),
// floor(n / d) = floor(m n / 2^(N+l)) for 0 <= n < 2^N; N = 63 here and 31 in
// Div32, and n is doubled so that the shift past the high word is l.
struct Div64 {
  unsigned long long m;
  int l;
};
struct Div32 {
  unsigned m;
  int l;
};

__device__ __forceinline__ unsigned long long divide(unsigned long long n,
                                                     Div64 d) {
  return __umul64hi(d.m, n << 1) >> d.l;
}
__device__ __forceinline__ unsigned divide(unsigned n, Div32 d) {
  return __umulhi(d.m, n << 1) >> d.l;
}

struct Shape {
  Div64 by_s;    // flat index -> row (b, d, c)
  Div32 by_c;    // row -> b * D + d
  Div32 by_dc;   // row -> b
  long long s;   // S
  unsigned c;    // C
};

// the index of a row's factors in the (B, C) arrays: b * C + c
__device__ __forceinline__ unsigned factor_index(unsigned row, const Shape& sh) {
  const unsigned bd = divide(row, sh.by_c);
  return divide(row, sh.by_dc) * sh.c + (row - bd * sh.c);
}

__device__ __forceinline__ float mish(float v) {
  const float e = __expf(v);
  const float n = e * (e + 2.0f);
  float m = v * __fdividef(n, n + 2.0f);
  if (v > SOFTPLUS_THRESHOLD) m = v;
  if (v < LOW) m = __fmul_rn(v * exp2f(__fmaf_rn(v, LOG2E, 64.0f)), TWO_M64);
  return m;
}

enum { MISH = 0, LRELU = 1 };
constexpr float LRELU_SLOPE = 0.01f;

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == MISH) return mish(v);
  return v > 0.0f ? v : __fmul_rn(v, LRELU_SLOPE);
}

__device__ __forceinline__ float affine(float x, float a, float c) {
  return __fadd_rn(__fmul_rn(x, a), c);
}

// the factors of one row: (a, c) and, with the residual, (a_r, c_r)
struct Factors {
  float a, c, ar, cr;
};

template <bool RESID>
__device__ __forceinline__ Factors factors(const float* __restrict__ a,
                                           const float* __restrict__ c,
                                           const float* __restrict__ ar,
                                           const float* __restrict__ cr, unsigned p) {
  Factors f{__ldg(a + p), __ldg(c + p), 0.0f, 0.0f};
  if (RESID) {
    f.ar = __ldg(ar + p);
    f.cr = __ldg(cr + p);
  }
  return f;
}

template <int ACT, bool RESID>
__device__ __forceinline__ float apply(float x, float r, const Factors& f) {
  float v = affine(x, f.a, f.c);
  if (RESID) v = __fadd_rn(v, affine(r, f.ar, f.cr));
  return act<ACT>(v);
}

// the operands of a kernel launch
struct Operands {
  const __nv_bfloat16* __restrict__ x;
  const __nv_bfloat16* __restrict__ r;
  const float* __restrict__ a;
  const float* __restrict__ c;
  const float* __restrict__ ar;
  const float* __restrict__ cr;
  __nv_bfloat16* __restrict__ out;
};

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);  // the lower address holds the first
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ uint4 pack(const float* f) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// one element at flat index i, its row found alone (the scalar head and tail)
template <int ACT, bool RESID>
__device__ __forceinline__ void apply_one(const Operands& op, long long i,
                                          const Shape& sh) {
  const unsigned p = factor_index(
      static_cast<unsigned>(divide(static_cast<unsigned long long>(i), sh.by_s)), sh);
  const Factors f = factors<RESID>(op.a, op.c, op.ar, op.cr, p);
  const float r = RESID ? __bfloat162float(op.r[i]) : 0.0f;
  op.out[i] = __float2bfloat16_rn(apply<ACT, RESID>(__bfloat162float(op.x[i]), r, f));
}

// the 8 elements of a vector whose first element has flat index i; rv: the
// residual's 8 elements (unread without it)
template <int ACT, bool RESID>
__device__ __forceinline__ void apply_vector(float* fx, const float* rv, long long i,
                                             const Operands& op, const Shape& sh) {
  unsigned row = static_cast<unsigned>(
      divide(static_cast<unsigned long long>(i), sh.by_s));
  long long off = i - static_cast<long long>(row) * sh.s;  // within the row
  Factors f = factors<RESID>(op.a, op.c, op.ar, op.cr, factor_index(row, sh));
  if (off + V <= sh.s) {  // one row: the common case wherever S >= 8
#pragma unroll
    for (int k = 0; k < V; ++k) fx[k] = apply<ACT, RESID>(fx[k], RESID ? rv[k] : 0.0f, f);
  } else {  // the vector crosses the end of its row, or of several
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (off == sh.s) {
        off = 0;
        f = factors<RESID>(op.a, op.c, op.ar, op.cr, factor_index(++row, sh));
      }
      fx[k] = apply<ACT, RESID>(fx[k], RESID ? rv[k] : 0.0f, f);
      ++off;
    }
  }
}

template <int ACT, bool RESID>
__global__ void __launch_bounds__(THREADS)
    affine_act_cs_kernel(Operands op, long long n, long long head, Shape sh) {
  const long long n_vec = (n - head) / V;
  const long long tail = head + n_vec * V;
  const long long tid =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;

  // scalar head up to the first 16-byte boundary, and the tail: < V each
  if (tid < head) apply_one<ACT, RESID>(op, tid, sh);
  if (tid < n - tail) apply_one<ACT, RESID>(op, tail + tid, sh);

  const uint4* xv = reinterpret_cast<const uint4*>(op.x + head);
  const uint4* rvp = reinterpret_cast<const uint4*>(op.r + head);
  uint4* ov = reinterpret_cast<uint4*>(op.out + head);
  for (long long j0 = tid; j0 < n_vec; j0 += stride * UNROLL) {
    uint4 u[UNROLL];
    uint4 ur[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const long long j = j0 + r * stride;
      if (j < n_vec) {
        u[r] = __ldcs(xv + j);  // read once: evict first
        if (RESID) ur[r] = __ldcs(rvp + j);
      }
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const long long j = j0 + r * stride;
      if (j < n_vec) {
        float f[V];
        float fr[V];
        unpack(u[r], f);
        if (RESID) unpack(ur[r], fr);
        apply_vector<ACT, RESID>(f, fr, head + j * V, op, sh);
        ov[j] = pack(f);
      }
    }
  }
}

Div64 make_div64(unsigned long long d) {
  int l = 0;
  while ((1ULL << l) < d) ++l;
  const unsigned __int128 num = static_cast<unsigned __int128>(1) << (63 + l);
  return {static_cast<unsigned long long>((num + d - 1) / d), l};
}

Div32 make_div32(unsigned d) {
  int l = 0;
  while ((1u << l) < d) ++l;
  const unsigned long long num = 1ULL << (31 + l);
  return {static_cast<unsigned>((num + d - 1) / d), l};
}

template <int ACT, bool RESID>
int launch(const Operands& op, long long n, int D, int C, long long S, long long head,
           void* stream) {
  if (n <= 0 || D <= 0 || C <= 0 || S <= 0 || S >= (1LL << 31) || head < 0 ||
      head >= V || n >= (1LL << 62))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dc = static_cast<long long>(D) * C;
  if (dc >= (1LL << 31) || n % (dc * S) != 0 || n / S >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (head > n) head = n;
  Shape sh;
  sh.by_s = make_div64(static_cast<unsigned long long>(S));
  sh.by_c = make_div32(static_cast<unsigned>(C));
  sh.by_dc = make_div32(static_cast<unsigned>(dc));
  sh.s = S;
  sh.c = static_cast<unsigned>(C);

  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, affine_act_cs_kernel<ACT, RESID>, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = (n - head) / V;
  long long blocks = (n_vec + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  affine_act_cs_kernel<ACT, RESID><<<static_cast<unsigned>(blocks), THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(op, n, head, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n = B * D * C * S elements; head: elements before x's first 16-byte
// boundary (out shares x's alignment). Needs S < 2^31 and B * D * C < 2^31.
// act_kind 0 (mish) or 1 (LeakyReLU 0.01); the residual r with its factors
// a_r, c_r where r is not null (r shares x's alignment).
extern "C" int affine_act_cs_launch(const void* x, const void* a, const void* c,
                                    const void* r, const void* ar, const void* cr,
                                    void* out, long long n, int D, int C, long long S,
                                    long long head, int act_kind, void* stream) {
  const Operands op{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
                    static_cast<const float*>(a), static_cast<const float*>(c),
                    static_cast<const float*>(ar), static_cast<const float*>(cr),
                    static_cast<__nv_bfloat16*>(out)};
  if (act_kind == MISH)
    return r ? launch<MISH, true>(op, n, D, C, S, head, stream)
             : launch<MISH, false>(op, n, D, C, S, head, stream);
  if (act_kind == LRELU)
    return r ? launch<LRELU, true>(op, n, D, C, S, head, stream)
             : launch<LRELU, false>(op, n, D, C, S, head, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
