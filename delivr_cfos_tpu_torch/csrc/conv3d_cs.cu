// 3x3x3 SAME convolution on (B, D, C, H*W) bf16 activations, for sm_90a.
//
// Replaces the TPU kernel delivr_cfos_tpu/ops/pallas/conv3d_cs.py:374
// (`conv3d_cs`, bodies `_kernel` and `_kernel_mp`) with the same contract:
//   x        (B, D, C1, H*W) bf16, and in pair mode x2 (B, D, C2, H*W) bf16;
//            the conv runs over concat([x, x2 + pair_bias], C) without
//            building the concat (two input pointers feed one K loop)
//   w        (27 * (C1 + C2), C_out) bf16: the DHWIO weights flattened, so
//            row k = ((dz * 3 + dy) * 3 + dx) * C_in + ci
//   bias     optional (C_out,) f32, added in f32 before rounding
//   in_affine optional (B, C_in) f32 a and c: each loaded input value v
//            becomes bf16(mish(v * a + c)) (the fused InstanceNorm+mish)
//   out      (B, D, C_out, H*W) bf16
//   stats    optional (B, D, 2, C_out) f32: per-plane sum and sum of squares
//            of the f32 output before bf16 rounding
//
// Bound on an H100 SXM: operations 2 * 27 * C_in * C_out * B * D * H * W
// against 989 TFLOP/s bf16 dense; bytes (x read once, out written once,
// weights, stats) against 3.35 TB/s. Every production layer has
// 2 * 27 * C_in * C_out / (2 * (C_in + C_out)) >= 295 operations per byte
// from C_in = C_out = 32 up, so the full-resolution layers are bound by
// operations (the C_in = 1 first conv is bound by bytes).
//
// Design: an implicit GEMM with M = output voxels of one z-plane, N = C_out,
// K = 27 * C_in. One block per (C_out tile of 32, z-plane d, batch b) walks
// its whole H*W plane in tiles of 128 voxels, so the plane's stats are reduced
// inside the block in a fixed order: no atomics, no second pass, the same bits
// on every run (a TPU grid runs in order, Hopper blocks do not). 8 warps run
// nvcuda::wmma bf16 -> f32 on 16 x 16 x 16 fragments. Two K loops:
//
// - staged (C1 and C2 multiples of 16: every production layer but the
//   C_in = 1 first conv): per chunk of 16 input channels the block stages the
//   span of the zero-padded, flattened input planes that its tile reads, with
//   channels innermost, in shared memory. The A fragment of tap (dz, dy, dx) is
//   then a strided view of that buffer (16 consecutive voxels, stride 16
//   channels): no im2col copy, each input value read from device memory once
//   per tile.
// - gather (any other C_in): per chunk of 32 K columns, which cross tap
//   boundaries so K = 27 * C_in is not padded, the block gathers the im2col
//   tile straight from global memory.
//
// Left for later: wgmma and TMA, cp.async double buffering of the staged
// chunks, reuse of a staged tile across C_out tiles, wider N tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 128;       // output voxels per tile (GEMM rows)
constexpr int TN = 32;        // output channels per block (GEMM columns)
constexpr int THREADS = 256;  // 8 warps; warp w owns tile rows [16w, 16w + 16)
constexpr int LDC = TM + 4;   // C col-major: C[m, n] at c_s[n * LDC + m]
constexpr int NJ = TN / 2;    // output channels per thread in the epilogue
// gather path
constexpr int TK = 32;        // K per shared-memory stage
constexpr int LDA = TM + 8;   // A col-major: A[m, k] at a_s[k * LDA + m]
constexpr int LDB = TN + 8;   // B row-major: B[k, n] at b_s[k * LDB + n]
// staged path
constexpr int CC = 16;        // input channels per stage
constexpr int LDW = TN + 8;   // weights row-major: W[t, k, n] at w_s[(t*CC+k)*LDW+n]

struct Args {
  const __nv_bfloat16* x1;
  const __nv_bfloat16* x2;
  const __nv_bfloat16* pair_bias;
  const __nv_bfloat16* w;
  const float* bias;
  const float* aff_a;
  const float* aff_c;
  __nv_bfloat16* out;
  float* stats;
  int B, D, C1, C2, Cout, H, W;
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float mish_f32(float v) {
  // softplus as max(v, 0) + log1p(exp(-|v|)): no overflow for large |v|
  const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return v * tanhf(sp);
}

// Channel ci of the (virtual) concat input after the pair bias and the affine
// prologue, given its raw bf16 value.
__device__ __forceinline__ __nv_bfloat16 prologue(const Args& p, int b, int ci,
                                                  __nv_bfloat16 val) {
  if (ci >= p.C1 && p.pair_bias != nullptr) {
    val = __float2bfloat16(__bfloat162float(val) +
                           __bfloat162float(p.pair_bias[ci - p.C1]));
  }
  if (p.aff_a != nullptr) {
    const int cin = p.C1 + p.C2;
    const float v = __bfloat162float(val) * p.aff_a[b * cin + ci] +
                    p.aff_c[b * cin + ci];
    val = __float2bfloat16(mish_f32(v));
  }
  return val;
}

// Pointer to channel ci of the concat input at plane z, offset 0 of the plane.
__device__ __forceinline__ const __nv_bfloat16* channel_ptr(const Args& p,
                                                            int b, int z,
                                                            int ci) {
  const size_t S = (size_t)p.H * p.W;
  if (ci < p.C1) return p.x1 + (((size_t)b * p.D + z) * p.C1 + ci) * S;
  return p.x2 + (((size_t)b * p.D + z) * p.C2 + (ci - p.C1)) * S;
}

// Epilogue of one 128-voxel tile: accumulators → c_s → bf16 output (+ bias),
// and this thread's running stats of the f32 values.
//
// Tile row i is output voxel (r, c) with m0 + i = r * row + c; columns
// c >= W of a padded row (row > W) are dropped.
__device__ __forceinline__ void store_tile(const Args& p, AccFrag (&acc)[TN / 16],
                                           float* c_s, int b, int d, int n0,
                                           int m0, int row, float (&s1)[NJ],
                                           float (&s2)[NJ]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int S = p.H * p.W;
#pragma unroll
  for (int nf = 0; nf < TN / 16; ++nf) {
    wmma::store_matrix_sync(c_s + nf * 16 * LDC + warp * 16, acc[nf], LDC,
                            wmma::mem_col_major);
  }
  __syncthreads();
  const int m_t = tid % TM;
  const int k_t = tid / TM;
  const int r = (m0 + m_t) / row;
  const int c = (m0 + m_t) % row;
  const int m = r * p.W + c;
  if (r < p.H && c < p.W) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nn = k_t + 2 * j;
      const int n = n0 + nn;
      if (n < p.Cout) {
        float v = c_s[nn * LDC + m_t];
        if (p.bias != nullptr) v += p.bias[n];
        p.out[(((size_t)b * p.D + d) * p.Cout + n) * S + m] = __float2bfloat16(v);
        s1[j] += v;
        s2[j] += v * v;
      }
    }
  }
  __syncthreads();  // c_s is overwritten by the next tile
}

// Reduce the 128 partials of each output channel in a fixed order and write
// stats[b, d, :, n0 : n0 + TN].
__device__ __forceinline__ void store_stats(const Args& p, float* c_s, int b,
                                            int d, int n0, const float (&s1)[NJ],
                                            const float (&s2)[NJ]) {
  const int tid = threadIdx.x;
  const int m_t = tid % TM;
  const int k_t = tid / TM;
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      c_s[(k_t + 2 * j) * LDC + m_t] = q == 0 ? s1[j] : s2[j];
    }
    __syncthreads();
    if (tid < TN && n0 + tid < p.Cout) {
      float s = 0.f;
      for (int i = 0; i < TM; ++i) s += c_s[tid * LDC + i];
      p.stats[(((size_t)b * p.D + d) * 2 + q) * p.Cout + n0 + tid] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) conv3d_cs_gather_kernel(Args p) {
  __shared__ __align__(32) __nv_bfloat16 a_s[TK * LDA];
  __shared__ __align__(32) __nv_bfloat16 b_s[TK * LDB];
  __shared__ __align__(32) float c_s[TN * LDC];

  const int n0 = blockIdx.x * TN;
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int cin = p.C1 + p.C2;
  const int S = p.H * p.W;
  const int K = 27 * cin;
  const int n_chunks = (K + TK - 1) / TK;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int m_t = tid % TM;
  const int k_t = tid / TM;

  float s1[NJ], s2[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s1[j] = s2[j] = 0.f;

  for (int m0 = 0; m0 < S; m0 += TM) {
    AccFrag acc[TN / 16];
#pragma unroll
    for (int nf = 0; nf < TN / 16; ++nf) wmma::fill_fragment(acc[nf], 0.f);
    const int m = m0 + m_t;
    const bool m_ok = m < S;
    const int hh = m_ok ? m / p.W : 0;
    const int ww = m_ok ? m % p.W : 0;

    for (int kc = 0; kc < n_chunks; ++kc) {
      // A: im2col gather of 128 voxels x 32 K columns
      for (int kk = k_t; kk < TK; kk += THREADS / TM) {
        const int k = kc * TK + kk;
        __nv_bfloat16 val = zero;
        if (m_ok && k < K) {
          const int tap = k / cin;
          const int ci = k - tap * cin;
          const int z = d + tap / 9 - 1;
          const int y = hh + (tap / 3) % 3 - 1;
          const int x = ww + tap % 3 - 1;
          if (z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W) {
            val = prologue(p, b, ci, channel_ptr(p, b, z, ci)[y * p.W + x]);
          }
        }
        a_s[kk * LDA + m_t] = val;
      }
      // B: 32 weight rows x 32 output channels
      for (int i = tid; i < TK * TN; i += THREADS) {
        const int kk = i / TN;
        const int nn = i % TN;
        const int k = kc * TK + kk;
        const int n = n0 + nn;
        b_s[kk * LDB + nn] =
            (k < K && n < p.Cout) ? p.w[(size_t)k * p.Cout + n] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < TK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            af;
        wmma::load_matrix_sync(af, a_s + ks * LDA + warp * 16, LDA);
#pragma unroll
        for (int nf = 0; nf < TN / 16; ++nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf;
          wmma::load_matrix_sync(bf, b_s + ks * LDB + nf * 16, LDB);
          wmma::mma_sync(acc[nf], af, bf, acc[nf]);
        }
      }
      __syncthreads();
    }
    store_tile(p, acc, c_s, b, d, n0, m0, p.W, s1, s2);
  }
  if (p.stats != nullptr) store_stats(p, c_s, b, d, n0, s1, s2);
}

// Dynamic shared memory of the staged kernel for plane width W: the input
// span of one tile (TM + 2 padded rows + 2 voxels) of the three input planes,
// the chunk's weights, the f32 output tile.
__host__ __device__ constexpr size_t staged_smem_bytes(int W) {
  return (size_t)3 * (TM + 2 * (W + 2) + 2) * CC * 2 + (size_t)27 * CC * LDW * 2 +
         (size_t)TN * LDC * 4;
}

// The staged kernel works on the zero-padded plane P of (H + 2) x (W + 2)
// voxels, flattened: output voxel (r, c) is virtual index v = r * (W + 2) + c,
// and its tap (dy, dx) reads P[v + dy * (W + 2) + dx], contiguous in v. Virtual
// columns c = W, W + 1 are computed and dropped (the TPU kernel's flat-lane
// trick; 3 % extra work at W = 64, 50 % at W = 4).
__global__ void __launch_bounds__(THREADS) conv3d_cs_staged_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int WP = p.W + 2;
  const int NS = TM + 2 * WP + 2;  // padded-plane voxels one tile reads
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][NS][CC]
  __nv_bfloat16* w_s = x_s + 3 * NS * CC;                         // [27][CC][LDW]
  float* c_s = reinterpret_cast<float*>(w_s + 27 * CC * LDW);     // [TN][LDC]

  const int n0 = blockIdx.x * TN;
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int cin = p.C1 + p.C2;
  const int S = p.H * p.W;
  const int V = p.H * WP;  // virtual outputs of the plane

  float s1[NJ], s2[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s1[j] = s2[j] = 0.f;

  for (int v0 = 0; v0 < V; v0 += TM) {
    AccFrag acc[TN / 16];
#pragma unroll
    for (int nf = 0; nf < TN / 16; ++nf) wmma::fill_fragment(acc[nf], 0.f);

    for (int c0 = 0; c0 < cin; c0 += CC) {
      // input span: voxel q of P holds 16 channels in 32 contiguous bytes
      for (int i = tid; i < 3 * NS; i += THREADS) {
        const int zz = i / NS;
        const int q = v0 + i - zz * NS;
        const int z = d + zz - 1;
        const int y = q / WP - 1;
        const int x = q % WP - 1;
        uint32_t words[CC / 2];
        if (z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W) {
          const __nv_bfloat16* src = channel_ptr(p, b, z, c0) + y * p.W + x;
#pragma unroll
          for (int j = 0; j < CC / 2; ++j) {
            const __nv_bfloat16 lo =
                prologue(p, b, c0 + 2 * j, src[(size_t)(2 * j) * S]);
            const __nv_bfloat16 hi =
                prologue(p, b, c0 + 2 * j + 1, src[(size_t)(2 * j + 1) * S]);
            words[j] = (uint32_t)__bfloat16_as_ushort(lo) |
                       ((uint32_t)__bfloat16_as_ushort(hi) << 16);
          }
        } else {
#pragma unroll
          for (int j = 0; j < CC / 2; ++j) words[j] = 0u;
        }
        uint4* dst = reinterpret_cast<uint4*>(x_s + (size_t)i * CC);
        dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
        dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
      }
      // weights of the chunk: 27 taps x 16 channels x 32 output channels
      for (int i = tid; i < 27 * CC * TN; i += THREADS) {
        const int nn = i % TN;
        const int kk = (i / TN) % CC;
        const int t = i / (TN * CC);
        const int n = n0 + nn;
        w_s[(t * CC + kk) * LDW + nn] =
            n < p.Cout ? p.w[((size_t)t * cin + c0 + kk) * p.Cout + n]
                       : __float2bfloat16(0.f);
      }
      __syncthreads();
#pragma unroll 3
      for (int t = 0; t < 27; ++t) {
        const int dz = t / 9;
        const int dy = (t / 3) % 3;
        const int dx = t % 3;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(
            af, x_s + (dz * NS + warp * 16 + dy * WP + dx) * CC, CC);
#pragma unroll
        for (int nf = 0; nf < TN / 16; ++nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf;
          wmma::load_matrix_sync(bf, w_s + t * CC * LDW + nf * 16, LDW);
          wmma::mma_sync(acc[nf], af, bf, acc[nf]);
        }
      }
      __syncthreads();
    }
    store_tile(p, acc, c_s, b, d, n0, v0, WP, s1, s2);
  }
  if (p.stats != nullptr) store_stats(p, c_s, b, d, n0, s1, s2);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int conv3d_cs_launch(const void* x1, const void* x2,
                                const void* pair_bias, const void* w,
                                const void* bias, const void* aff_a,
                                const void* aff_c, void* out, void* stats,
                                int B, int D, int C1, int C2, int Cout, int H,
                                int W, void* stream) {
  Args p;
  p.x1 = static_cast<const __nv_bfloat16*>(x1);
  p.x2 = static_cast<const __nv_bfloat16*>(x2);
  p.pair_bias = static_cast<const __nv_bfloat16*>(pair_bias);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.aff_a = static_cast<const float*>(aff_a);
  p.aff_c = static_cast<const float*>(aff_c);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats = static_cast<float*>(stats);
  p.B = B;
  p.D = D;
  p.C1 = C1;
  p.C2 = C2;
  p.Cout = Cout;
  p.H = H;
  p.W = W;
  const dim3 grid((Cout + TN - 1) / TN, D, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C1 % CC == 0 && C2 % CC == 0) {
    const size_t smem = staged_smem_bytes(W);
    cudaError_t err = cudaFuncSetAttribute(
        conv3d_cs_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3d_cs_staged_kernel<<<grid, THREADS, smem, s>>>(p);
  } else {
    conv3d_cs_gather_kernel<<<grid, THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
