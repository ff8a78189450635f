// 2x2x2 stride-2 transposed convolution on (B, D, C, H*W) bf16, for sm_90a.
//
// Replaces the TPU kernel scripts/probe_deconv.py:117 (`_variant_d`, body
// `_pallas_kernel`), the in-kernel form of the fast forward's UpCat deconv
// delivr_cfos_tpu/models/basic_unet_cs.py::_deconv2x_cs, with its contract:
//   x     (B, D, C, H*W) bf16
//   w     (ceil(O / 16), C, 8, 16) bf16: the ConvTranspose3d weights
//         (C, O, 2, 2, 2) with the phase p = 4a + 2beta + gamma moved in front
//         of O, O zero-padded to a multiple of 16 and cut into tiles of 16
//         channels, so that one block's weights are contiguous; phase a reads
//         kernel index a directly, no flip
//   bias  optional (O,) f32, added in f32 before the one rounding
//   out   (B, 2D, O, 4*H*W) bf16, contiguous in its final order:
//         out[b, 2d+a, o, (2y+beta)*2W + 2x+gamma]
//           = bf16_rn(sum_c x[b, d, c, y*W + x] * w[o / 16, c, p, o % 16]
//                     + bias[o])
//
// Bound on an H100 SXM: bytes. Each input voxel costs 2 * 8 * C * O
// operations against 2 * C bytes read and 2 * 8 * O bytes written: 28
// operations per byte at C = O = 32 and 205 at C = 256, O = 128, both under
// the card's 295 (989 TFLOP/s bf16 over 3.35 TB/s). The output, 8x the
// input's voxels, is most of the bytes.
//
// Design: a GEMM per z-plane with M = the plane's H*W voxels, N = 8 phases x
// O channels, K = C. One block per (tile of 16 output channels, run of `pd`
// planes, batch b) stages its weights (all C, all 8 phases, zero-padded to a
// multiple of 16 channels) in shared memory once, with 16-byte loads, then
// walks its planes in tiles of 64 voxels. The launcher sets pd so that a
// block walks at least 8 tiles where the batch's planes allow: the small
// planes of the deep UpCats (upcat_4: 24 voxels, C = 256, 64 KB of weights)
// would otherwise restage their weights for one tile's work. The tile's
// inputs are staged as they lie (channel-major,
// voxels minor: the A operand column-major), 8 warps run nvcuda::wmma bf16 ->
// f32 on 16 x 16 x 16 fragments in a fixed K order, and the accumulators go
// through shared memory to the epilogue, which adds the bias, rounds once and
// writes the phase interleave. gamma is the minor output index, so each thread
// writes the (x, gamma) pairs of 4 neighbouring voxels of one output row as
// one 16-byte store when W % 4 == 0 (every UpCat of the production forward),
// else one voxel's pair as a 4-byte store; a warp's stores run along the row.
//
// Left for later: wgmma and TMA, several output-channel tiles per block (the
// input is read once per 16 output channels), a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;          // voxels per tile (GEMM rows)
constexpr int TO = 16;          // output channels per block
constexpr int TN = 8 * TO;      // GEMM columns per block: (phase, channel)
constexpr int THREADS = 256;    // 8 warps: warp w owns rows 16 (w % 4) + [0, 16)
                                // and column fragments 4 (w / 4) + [0, 4)
constexpr int LDA = TM + 8;     // A col-major: A[m, k] at a_s[k * LDA + m]
constexpr int LDB = TN + 8;     // B row-major: B[k, n] at b_s[k * LDB + n]
constexpr int LDC = TM + 4;     // C col-major: C[m, n] at c_s[n * LDC + m]
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

size_t smem_bytes(int kp) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kp) * (LDB + LDA) +
         sizeof(float) * static_cast<size_t>(TN) * LDC;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* out;
  int D, C, O, H, W, Kp, pd;
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// G: voxels per epilogue item (4: one 16-byte store, needs W % 4 == 0 and a
// 16-byte aligned output; 1: one 4-byte store). vec_in: H*W % 8 == 0 and x
// 16-byte aligned, so the inputs stage as 8-voxel vectors.
// At most 64 registers a thread, so that 4 blocks fit an SM (without the
// bound the 16-byte-store form took 127 and ran 2 blocks an SM).
template <int G>
__global__ void __launch_bounds__(THREADS, 4) deconv2x_cs_kernel(Args p,
                                                                int vec_in) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* a_s = b_s + static_cast<size_t>(p.Kp) * LDB;
  float* c_s = reinterpret_cast<float*>(a_s + static_cast<size_t>(p.Kp) * LDA);

  const int o0 = blockIdx.x * TO;
  const int d0 = blockIdx.y * p.pd;
  const int d1 = min(d0 + p.pd, p.D);
  const int b = blockIdx.z;
  const int S = p.H * p.W;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int mf = warp & 3;
  const int nf0 = (warp >> 2) * 4;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // B[k, ph * TO + j] = w[blockIdx.x, k, ph, j]: TN contiguous values a
  // row, 8 per 16-byte load; zero beyond C
  const uint4* wt = reinterpret_cast<const uint4*>(
      p.w + static_cast<size_t>(blockIdx.x) * p.C * TN);
  for (int i = tid; i < p.Kp * (TN / 8); i += THREADS) {
    const int k = i / (TN / 8), v = i % (TN / 8);
    *reinterpret_cast<uint4*>(b_s + k * LDB + v * 8) =
        k < p.C ? wt[k * (TN / 8) + v] : make_uint4(0u, 0u, 0u, 0u);
  }

  const size_t S4 = 4 * static_cast<size_t>(S);
  const int tiles = (S + TM - 1) / TM;  // voxel tiles per plane
  for (int t = 0; t < (d1 - d0) * tiles; ++t) {
    const int d = d0 + t / tiles;
    const int m0 = (t % tiles) * TM;
    const __nv_bfloat16* xp =
        p.x + (static_cast<size_t>(b) * p.D + d) * p.C * static_cast<size_t>(S);
    __nv_bfloat16* out_bd =
        p.out + (static_cast<size_t>(b) * 2 * p.D + 2 * d) * p.O * S4;

    if (vec_in) {
      for (int i = tid; i < p.Kp * (TM / 8); i += THREADS) {
        const int k = i / (TM / 8), m = (i % (TM / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < p.C && m0 + m < S)
          v = *reinterpret_cast<const uint4*>(xp + static_cast<size_t>(k) * S +
                                              m0 + m);
        *reinterpret_cast<uint4*>(a_s + k * LDA + m) = v;
      }
    } else {
      for (int i = tid; i < p.Kp * TM; i += THREADS) {
        const int k = i / TM, m = i % TM;
        a_s[k * LDA + m] = (k < p.C && m0 + m < S)
                               ? xp[static_cast<size_t>(k) * S + m0 + m]
                               : zero;
      }
    }
    __syncthreads();  // the weights (first tile) and this tile's inputs

    AccFrag acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k = 0; k < p.Kp; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>
          af;
      wmma::load_matrix_sync(af, a_s + k * LDA + mf * 16, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, b_s + k * LDB + (nf0 + j) * 16, LDB);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(c_s + (nf0 + j) * 16 * LDC + mf * 16, acc[j],
                              LDC, wmma::mem_col_major);
    __syncthreads();  // c_s complete; a_s free for the next tile

    // items (2a + beta, channel j, voxel group g), g fastest: neighbouring
    // threads write neighbouring pieces of one output row
    constexpr int NG = TM / G;
    for (int i = tid; i < 4 * TO * NG; i += THREADS) {
      const int g = i % NG;
      const int j = (i / NG) % TO;
      const int ab = i / (NG * TO);
      const int o = o0 + j;
      const int vox = m0 + g * G;
      if (o >= p.O || vox >= S) continue;
      const int a = ab >> 1, beta = ab & 1;
      const int yy = vox / p.W, xx = vox - yy * p.W;
      const float* c0 = c_s + ((2 * ab) * TO + j) * LDC + g * G;  // gamma 0
      const float* c1 = c0 + TO * LDC;                            // gamma 1
      const float bo = p.bias != nullptr ? p.bias[o] : 0.f;
      __nv_bfloat16* dst = out_bd + (static_cast<size_t>(a) * p.O + o) * S4 +
                           static_cast<size_t>(2 * yy + beta) * 2 * p.W + 2 * xx;
      if constexpr (G == 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(c0);
        const float4 v1 = *reinterpret_cast<const float4*>(c1);
        float f[8] = {v0.x, v1.x, v0.y, v1.y, v0.z, v1.z, v0.w, v1.w};
        if (p.bias != nullptr) {
#pragma unroll
          for (int q = 0; q < 8; ++q) f[q] += bo;
        }
        __align__(16) __nv_bfloat162 h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
      } else {
        float f0 = c0[0], f1 = c1[0];
        if (p.bias != nullptr) {
          f0 += bo;
          f1 += bo;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(f0, f1);
      }
    }
    // the next tile's staging writes a_s only; c_s is rewritten after its
    // __syncthreads, which every thread reaches after this epilogue
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int deconv2x_cs_launch(const void* x, const void* w,
                                  const void* bias, void* out, int B, int D,
                                  int C, int O, int H, int W, void* stream) {
  if (B <= 0 || D <= 0 || C <= 0 || O <= 0 || H <= 0 || W <= 0 ||
      B > 65535 || D > 65535 || static_cast<long long>(H) * W > (1 << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = (C + 15) / 16 * 16;
  const size_t smem = smem_bytes(kp);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.D = D;
  p.C = C;
  p.O = O;
  p.H = H;
  p.W = W;
  p.Kp = kp;
  // planes per block: at least 8 voxel tiles a block where D allows
  const int tiles = (H * W + TM - 1) / TM;
  const int want = (8 + tiles - 1) / tiles;
  p.pd = want < D ? want : D;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec_in =
      (H * W) % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool g4 = W % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  void (*kern)(Args, int) =
      g4 ? &deconv2x_cs_kernel<4> : &deconv2x_cs_kernel<1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((O + TO - 1) / TO, (D + p.pd - 1) / p.pd, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, vec_in);
  return static_cast<int>(cudaGetLastError());
}
