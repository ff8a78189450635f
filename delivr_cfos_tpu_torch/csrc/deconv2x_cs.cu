// 2x2x2 stride-2 transposed convolution on (B, D, C, H*W) bf16, for sm_90a.
//
// Replaces the TPU kernel scripts/probe_deconv.py:117 (`_variant_d`, body
// `_pallas_kernel`), the in-kernel form of the fast forward's UpCat deconv
// delivr_cfos_tpu/models/basic_unet_cs.py::_deconv2x_cs, with its contract.
// The (b, d) planes are flattened, P = B * D of them, S = H * W voxels each:
//   x     (P, C, S) bf16
//   w     (C, 8 O) bf16, K-major: w[c, 8 o + p] = the ConvTranspose3d weight
//         (C, O, 2, 2, 2) at [c, o, a, beta, gamma], phase p = 4a + 2beta +
//         gamma, which is that tensor's own order; phase a reads kernel
//         index a directly, no flip. The staging zero-fills the columns of
//         the last N tile past 8 O.
//   bias  optional (O,) f32, added in f32 before the one rounding
//   out   (2P, O, 4S) bf16, which is (B, 2D, O, 4*H*W) in its final order:
//         out[2 pd + a, o, (2y + beta) * 2W + 2x + gamma]
//           = bf16_rn(sum_c x[pd, c, y*W + x] * w[c, 8 o + p] + bias[o])
//
// Bound on an H100 SXM: bytes. Each input voxel costs 2 * 8 * C * O
// operations against 2 * C bytes read and 2 * 8 * O bytes written: 28
// operations per byte at C = O = 32 and 205 at C = 256, O = 128, both under
// the card's 295 (989 TFLOP/s bf16 over 3.35 TB/s). The output, 8x the
// input's voxels, is most of the bytes. So mma.sync m16n8k16 (bf16 -> f32)
// with ldmatrix is enough, and wgmma would buy nothing.
//
// Design: one GEMM over the whole call, M = P * S voxels (flattened over the
// planes), N = 8 phases x O, K = C, in tiles of TM voxels x TN = 8 * TNC
// columns (TNC output channels with all 8 phases, so the input is read from
// device memory once where O <= TNC, the two finer UpCats). An M tile may
// span planes: every chunk of 8 voxels lies in one plane where S % 8 == 0.
// The grid is (N tiles, m_blocks): block (nt, mg) walks M tiles mg,
// mg + m_blocks, ... at its one N tile, so the N tiles of an M tile run side
// by side and their re-reads of the input hit L2. Per tile, K streams in
// chunks of KC channels through a ring of STAGES buffers filled by 16-byte
// cp.async (zero-filled past C and past M): the A chunk as x lies (channel
// rows, voxels along a row, read with ldmatrix.trans) and the B chunk from
// the K-major weights (L2-resident: all four UpCats' weights are under
// 1 MB). The ring runs across tiles, so the next tile's first chunks are in
// flight during this tile's epilogue. 8 warps, 2 (M) x 4 (N), each a 32 x 64
// tile: 64 f32 accumulators a thread in registers. Column n = 8 o + p puts
// the phases gamma = 0, 1 of one output channel in a thread's two
// accumulator columns, neighbours in the output.
//
// Epilogue, from registers: bias in f32, one rounding, then
//   FAST (W even and dividing TM): the bf16 tile goes to shared memory laid
//   out as output runs. A tile is then whole input rows, and gives, for
//   each (channel o, phase a) and each plane it meets, one contiguous run of
//   output rows 2y, 2y + 1; the block copies them out with 16-byte loads and
//   stores, a warp on 512 contiguous bytes.
//   otherwise: each thread writes its (gamma 0, 1) pairs as 4-byte stores.
// Staging: VEC (S % 8 == 0, x 16-byte aligned) copies 8 voxels a cp.async;
// otherwise a thread loads its 8 voxels one at a time, zeros past C and M.
// The K order is fixed and nothing is atomic: a relaunch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // voxels per tile (GEMM rows)
constexpr int TNC = 32;         // output channels per tile
constexpr int TN = 8 * TNC;     // GEMM columns per tile: (channel, phase)
constexpr int KC = 32;          // input channels per ring stage
constexpr int STAGES = 3;       // ring depth
constexpr int THREADS = 256;    // 8 warps: rows 32 (w & 1), columns 64 (w >> 1)
constexpr int LDA = TM + 8;     // A chunk: A[m, k] at a_s[k * LDA + m]
constexpr int LDB = TN + 8;     // B chunk: B[k, n] at b_s[k * LDB + n]
constexpr int A_STAGE = KC * LDA;
constexpr int STAGE = A_STAGE + KC * LDB;  // bf16 a ring buffer holds
constexpr int RUN_MAX = 4 * TM + 32;       // bf16 an output run, padding included
constexpr size_t SMEM =
    sizeof(__nv_bfloat16) * (static_cast<size_t>(STAGES) * STAGE + 2 * TNC * RUN_MAX);

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* out;
  int P, C, O, H, W, NP;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool VEC, bool FAST>
__global__ void __launch_bounds__(THREADS, 2) deconv2x_cs_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* e_s = ring + STAGES * STAGE;
  const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int S = p.H * p.W;
  const int M = p.P * S;
  const int nt = blockIdx.x;
  const int m_tiles = (M + TM - 1) / TM;
  const int m_blocks = static_cast<int>(gridDim.y);
  const int my_tiles = (m_tiles - static_cast<int>(blockIdx.y) + m_blocks - 1) / m_blocks;
  const int KI = (p.C + KC - 1) / KC;
  const int total = my_tiles * KI;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int tig = lane & 3;  // accumulator columns 2 tig, 2 tig + 1: phase (a, beta)
  const int ph_a = tig >> 1;
  const int ph_b = tig & 1;

  // this thread's A copy: channel row a_k of the chunk, voxels 8 a_j + [0, 8)
  const int a_k = tid >> 3;
  const int a_j = tid & 7;
  const __nv_bfloat16* wb = p.w + static_cast<size_t>(nt) * TN;

  auto load = [&](int it) {
    const int t = it / KI;
    const int kc = it - t * KI;
    const int m0 = (static_cast<int>(blockIdx.y) + t * m_blocks) * TM;
    const int slot = it % STAGES;
    const uint32_t a_s = ring0 + static_cast<uint32_t>(slot * STAGE) * 2u;
    const uint32_t b_s = a_s + static_cast<uint32_t>(A_STAGE) * 2u;
    const int k = kc * KC + a_k;
    const int m = m0 + 8 * a_j;
    if constexpr (VEC) {
      const bool ok = k < p.C && m < M;
      const int pd = ok ? m / S : 0;
      const __nv_bfloat16* src =
          ok ? p.x + (static_cast<size_t>(pd) * p.C + k) * S + (m - pd * S) : p.x;
      cp_async16(a_s + static_cast<uint32_t>(a_k * LDA + 8 * a_j) * 2u, src, ok);
    } else {
      __nv_bfloat16* dst = ring + slot * STAGE + a_k * LDA + 8 * a_j;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (k < p.C && m + e < M) {
          const int pd = (m + e) / S;
          v = p.x[(static_cast<size_t>(pd) * p.C + k) * S + (m + e - pd * S)];
        }
        dst[e] = v;
      }
    }
    // B chunk: KC rows of TN columns, TN / 8 copies a row, each 8 columns of
    // one output channel. Where KI divides STAGES, ring buffer j always
    // holds chunk j % KI: filled once.
    if (it >= STAGES && STAGES % KI == 0) return;
#pragma unroll
    for (int i = tid; i < KC * (TN / 8); i += THREADS) {
      const int r = i / (TN / 8);
      const int q = (i % (TN / 8)) * 8;
      const int kr = kc * KC + r;
      const bool ok = kr < p.C && nt * TN + q < p.NP;
      cp_async16(b_s + static_cast<uint32_t>(r * LDB + q) * 2u,
                 ok ? wb + static_cast<size_t>(kr) * p.NP + q : p.w, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  // n8 block ni of the warp is output channel o = TNC nt + 8 wn + ni
  float bo[8];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int o = nt * TNC + 8 * wn + ni;
    bo[ni] = p.bias != nullptr && o < p.O ? p.bias[o] : 0.f;
  }
  // ldmatrix row addresses (bf16 elements) of this lane. A, transposed from
  // channel rows: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
  // (m 8-15, k 8-15). B: K rows (lane & 15), columns 8 (lane >> 4).
  const uint32_t a_lane = static_cast<uint32_t>(
      ((lane & 7) + ((lane >> 4) << 3)) * LDA + ((lane >> 3) & 1) * 8 + 32 * wm) * 2u;
  const uint32_t b_lane =
      static_cast<uint32_t>((lane & 15) * LDB + (lane >> 4) * 8 + 64 * wn) * 2u;
  // output run of (channel, phase a): the tile's rows in output order, its
  // length padded so that the two phases a of one warp store fall in other
  // banks than each other
  const int run = 4 * TM + (p.W == 16 ? 16 : 32);
  // the copy-out's fixed coordinates (FAST: W is a power of two): lane c's
  // chunk starts in tile row ir_c; warp w's first channel
  const int ir_c = (2 * lane) & ~(p.W - 1);
  const int o_w = nt * TNC + (warp >> 1);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  int kc = 0;
  int t = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk it landed for all; buffer it - 1 and e_s are free
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();

    const uint32_t a_s = ring0 + static_cast<uint32_t>((it % STAGES) * STAGE) * 2u;
    const uint32_t b_s = a_s + static_cast<uint32_t>(A_STAGE) * 2u;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], a_s + a_lane + static_cast<uint32_t>(ks * LDA + 16 * mi) * 2u);
#pragma unroll
      for (int nh = 0; nh < 4; ++nh) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, b_s + b_lane + static_cast<uint32_t>(ks * LDB + 16 * nh) * 2u);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nh], af[mi], bq[0], bq[1]);
          mma_bf16(acc[mi][2 * nh + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
    if (++kc < KI) continue;

    // epilogue of tile t: accumulator row (lane >> 2) + 8 h of 16-row block
    // mi is tile voxel i; columns 2 tig + {0, 1} are gamma = 0, 1 of phase
    // (ph_a, ph_b) of channel ni
    const int m0 = (static_cast<int>(blockIdx.y) + t * m_blocks) * TM;
    if constexpr (FAST) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 32 * wm + 16 * mi + 8 * h + (lane >> 2);
          // output order within the tile's rows: (row, beta, x, gamma)
          const int pos = 4 * i - 2 * (i & (p.W - 1)) + 2 * ph_b * p.W;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int r = 2 * (8 * wn + ni) + ph_a;
            *reinterpret_cast<__nv_bfloat162*>(e_s + r * run + pos) = __floats2bfloat162_rn(
                acc[mi][ni][2 * h] + bo[ni], acc[mi][ni][2 * h + 1] + bo[ni]);
          }
        }
      }
      __syncthreads();  // the tile's runs are complete
      // warp w copies runs r = w + 8s (channel o_w + 4s, phase a = w & 1),
      // lane c their 16-byte chunk c, which lies in the output rows of tile
      // row ir_c: one plane and one division a tile for the thread
      if (ir_c < M - m0) {
        const int m = m0 + ir_c;
        const int pd = m / S;
        __nv_bfloat16* dst = p.out +
                             (static_cast<size_t>(2 * pd + (warp & 1)) * p.O + o_w) * (4 * static_cast<size_t>(S)) +
                             4 * static_cast<size_t>(m - pd * S) + (8 * lane - 4 * ir_c);
#pragma unroll
        for (int s = 0; s < 2 * TNC / (THREADS / 32); ++s) {
          if (o_w + 4 * s >= p.O) break;
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(s) * 16 * S) =
              *reinterpret_cast<const uint4*>(e_s + (warp + 8 * s) * run + 8 * lane);
        }
      }
      // e_s is rewritten after the next iteration's __syncthreads
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 32 * wm + 16 * mi + 8 * h + (lane >> 2);
          if (m >= M) continue;
          const int pd = m / S;
          const int v = m - pd * S;
          const int y = v / p.W;
          const int xx = v - y * p.W;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int o = nt * TNC + 8 * wn + ni;
            if (o >= p.O) continue;
            __nv_bfloat16* dst =
                p.out + (static_cast<size_t>(2 * pd + ph_a) * p.O + o) * (4 * static_cast<size_t>(S)) +
                static_cast<size_t>(2 * y + ph_b) * 2 * p.W + 2 * xx;
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
                acc[mi][ni][2 * h] + bo[ni], acc[mi][ni][2 * h + 1] + bo[ni]);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    kc = 0;
    ++t;
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(Args);

Kernel pick(int vec_in, int fast_out) {
  if (vec_in) return fast_out ? &deconv2x_cs_kernel<true, true> : &deconv2x_cs_kernel<true, false>;
  return fast_out ? &deconv2x_cs_kernel<false, true> : &deconv2x_cs_kernel<false, false>;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). x is
// (P, C, H*W), w (C, 8 O) K-major and 16-byte aligned, out (2P, O, 4*H*W);
// P * H * W < 2^30: voxel indices are 32-bit. The grid is (ceil(O / 32),
// m_blocks), 1 <= m_blocks <= the number of 64-voxel tiles. vec_in needs
// H*W % 8 == 0 and x 16-byte aligned; fast_out needs W even, 64 % W == 0
// and out 16-byte aligned.
extern "C" int deconv2x_cs_launch(const void* x, const void* w, const void* bias, void* out,
                                  int P, int C, int O, int H, int W, int m_blocks, int vec_in,
                                  int fast_out, void* stream) {
  const long long S = static_cast<long long>(H) * W;
  const long long M = P * S;
  if (P <= 0 || C <= 0 || O <= 0 || H <= 0 || W <= 0 || M >= (1LL << 30) ||
      m_blocks <= 0 || m_blocks > (M + TM - 1) / TM || m_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (vec_in && (S % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0)) ||
      (fast_out && (W % 2 != 0 || TM % W != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Args p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.P = P;
  p.C = C;
  p.O = O;
  p.H = H;
  p.W = W;
  const int n_tiles = (O + TNC - 1) / TNC;
  p.NP = 8 * O;
  const Kernel kern = pick(vec_in, fast_out);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(n_tiles, m_blocks), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks an SM of the kernel instance that
// (vec_in, fast_out) picks, as the card reports them.
extern "C" int deconv2x_cs_resources(int vec_in, int fast_out, int* regs, int* blocks_per_sm) {
  const Kernel kern = pick(vec_in, fast_out);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(kern), THREADS, SMEM));
}
