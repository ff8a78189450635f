// 3x3x3 SAME convolution on (B, D, C, H*W) bf16 activations, for sm_90a.
//
// Replaces the TPU kernel delivr_cfos_tpu/ops/pallas/conv3d_cs.py:374
// (`conv3d_cs`, bodies `_kernel` and `_kernel_mp`) with the same contract:
//   x        (B, D, C1, H*W) bf16, and in pair mode x2 (B, D, C2, H*W) bf16;
//            the conv runs over concat([x, x2 + pair_bias], C)
//   w        the DHWIO weights, row k = ((dz * 3 + dy) * 3 + dx) * C_in + ci
//   bias     optional (C_out,) f32, added in f32 before rounding
//   in_affine optional (B, C_in) f32 a and c: each input value v becomes
//            bf16(mish(v * a + c)) (the fused InstanceNorm+mish)
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
// The kernels:
//
// - conv3d_cs_pack_kernel (bound by bytes): writes the conv's input once as
//   xp (B, D + 2, H + 2, W + 2, Cp) bf16, zero-padded on the three spatial
//   axes, channels innermost, with the pair concat, the pair bias and the
//   affine prologue applied. Cp pads the channels to the packed conv's K
//   step: C1 and C2 each to a multiple of 8 (C1p, C2p), their sum to a
//   multiple of 16; slots [0, C1) hold x, [C1p, C1p + C2) hold
//   bf16(x2 + bf16(bias2)), every other slot an exact zero (the prologue
//   touches real channels only). Where C1 and C2 are multiples of 16 (every
//   production layer) Cp = C1 + C2 and the kernel's unpadded instance runs,
//   slot s channel s (the slot map cost 3 % there). A thread reads 8 channel
//   slots x 8 voxels with 16-byte loads along x (8 x 1 voxel where H*W % 8
//   != 0), zeros for pad slots, transposes them in registers and writes each
//   voxel's 8 slots as one 16-byte store; the halo zeros are 16-byte stores
//   of the same kernel.
// - conv3d_cs_packed_kernel (every C_in but the narrow ones, padded to Cp by
//   the pack: every production layer but the C_in = 1 first conv, and the
//   wider C_in that are not multiples of 16): an implicit GEMM, M = output
//   voxels of one z-plane, N = C_out, K = 27 * Cp, on xp, the weights with
//   zero rows at the pad slots. With the padded plane flattened
//   to v = r * (W + 2) + c, tap (dz, dy, dx) of tile row v reads voxel
//   v + dy * (W + 2) + dx of padded plane d + dz: one stage, (dz, 16 input
//   channels), is one span of TM + 2 (W + 2) + 2 voxels, a strided block of
//   xp copied with 16-byte cp.async and no per-element logic, and its 9
//   (dy, dx) taps are row offsets into it. The stage's weights (9 taps x 16
//   channels x 32 output channels) come from a per-block contiguous layout
//   with the same copies. Stages run in a ring of STAGES buffers: while the
//   taps of one stage run, the copies of the next two are in flight.
//   mma.sync m16n8k16 bf16 -> f32 with ldmatrix; warp w owns tile rows
//   [32w, 32w + 32) and all 32 output channels. Rows are padded (24 and 40
//   bf16) so ldmatrix's eight 16-byte rows fall in distinct banks. Virtual
//   columns c = W, W + 1 are computed and dropped (3 % extra work at W = 64);
//   the input rows they read, and those of rows past the plane, feed only
//   dropped rows, so xp needs only a tail of TM + 1 voxels past its end
//   (the last tile starts at most at virtual voxel H (W + 2) - 1, so its
//   dz = 2 span reaches voxel TM past the end), which the wrapper
//   allocates.
//   Shared memory per stage: (TM + 2 (W + 2) + 2) * 24 * 2 bytes of input
//   and 9 * 16 * 40 * 2 = 11520 of weights: at TM = 256 and W = 64,
//   30240 bytes, 90720 for the ring of 3, so 2 blocks of 256 threads fit an
//   SM (the bound __launch_bounds__ asks for); at TM = 128 (planes of at
//   most 128 virtual voxels, levels 3-4) 4 blocks of 128. Measured
//   (conv3d_cs_variants.py in the history): 64-row warp tiles, a ring of 2
//   or 4, or 512-row tiles move the level-0 convs by -10 % to +29 %, and
//   256-row tiles beat 128 from the 24 x 16 plane of level 2 up.
// - conv3d_cs_direct_kernel (C_in = 1, W and C_out multiples of 8: the first
//   conv, 1 -> 32 on the 96 x 64 plane; on the TPU the C_in = 1 case of the
//   kernel above, padded to C_in = 2 and run by `_kernel_mp` at P = 8 planes):
//   a direct stencil in f32 FMAs, no im2col and no tensor cores. Its bound is
//   the output's bytes: 27 MACs a value (65.2 G MACs a forward batch of 128
//   windows) take about 2 ms on the FP32 pipe, beside 1.49 ms to write the
//   4.83 GB of bf16 output at 3.35 TB/s. A block stages its 27 x 32 weights
//   once as f32 (3456 bytes) and input planes d - 1, d, d + 1 as f32 with
//   the prologue applied and zeros around, in bands of rows: (rows + 2) x
//   (W + 4) floats a plane, so 3 x 98 x 68 x 4 = 79968 bytes hold the whole
//   96 x 64 plane in one band, 83424 with the weights (direct_band_rows in
//   ops/conv3d_cs.py keeps a band under 100 KB). A thread stages 8 columns
//   of a row (one 16-byte load where x is aligned). 128 registers, no
//   spills, 2 blocks of 256 threads an SM. Measured at the first conv
//   (conv3d_cs_direct_variants.py in the history): bands of 32 or 16 rows
//   and blocks of 128 threads were 2-10 % slower than the whole plane with
//   256, four padded columns a thread 9 % slower. A work unit is
//   8 consecutive x voxels x 8 output channels, 64 accumulators: per (dz, dy)
//   the thread reads its 10 input values once (two float4 and a float2) for
//   the 3 dx taps, and each tap's 8 weights are a broadcast read. Warp w
//   keeps channel group w & 3 for the whole plane; a quarter warp's lanes sit
//   on 2 rows x 4 groups, so at W = 64 their float4 reads fall in distinct
//   banks. The epilogue adds the bias in f32, rounds each channel's 8 voxels
//   to bf16 once and writes them as one 16-byte store: a warp writes 512
//   contiguous bytes of one channel plane, nothing through shared memory.
// - conv3d_cs_narrow_kernel (C1 + C2 <= 16 but not multiples of 16: a packed
//   model's first conv, C_in = G, the convs of narrow models, C_in = 1 where
//   W or C_out is not a multiple of 8; on the TPU the kernel above at even
//   C_in, odd C_in padded by the JAX model, models/basic_unet_cs.py:50-58).
//   Bound by bytes, the output's: at C 2 -> 64 it does 2 * 27 * 2 * 64 /
//   (2 * (2 + 64)) = 52 operations a byte against the card's 295. One block
//   a (z-plane d, batch b), 256 threads, 2 blocks an SM. Per band of rows
//   (the whole 96 x 64 plane at C_in = 2; ops/conv3d_cs.py narrow_band_rows
//   keeps a block's shared memory under 112 KB) it stages planes d - 1, d,
//   d + 1 once as [plane][row + 2][W + 2][ce] bf16, C padded to an even ce
//   with a zero channel, zeros around, the pair bias and the prologue applied
//   once per staged value, with 16-byte loads along x. Then per pass of 32
//   output channels (the pass's weights, [32][kp + 8] bf16, loaded once a band and
//   pass: once a block at C_out <= 32 with one band) warp w takes tiles w,
//   w + 8, .. of 32 voxels x 32 channels: mma.sync m16n8k16, K = 27 * ce
//   padded to 16 (54 -> 64 at C = 2), tap-major with channel pairs
//   innermost, so an A fragment's column pair is one 32-bit shared load at
//   the row's word plus a tabulated K-pair offset, with no bounds test and
//   no division; B by ldmatrix. The accumulators start at the bias; the
//   epilogue takes the stats from the f32 values, rounds to bf16 once,
//   transposes the tile into the warp's [channel][voxel] buffer with
//   stmatrix.trans and writes each channel's 32 voxels as 64 contiguous
//   bytes with 16-byte stores. A pass of 32 channels whatever C_out is keeps
//   a channel's outputs and stats the same bits at every C_out (the packed
//   first conv's windows equal each window alone). Measured
//   (conv3d_cs_narrow_variants.py drops one phase at a time): it is bound by
//   instruction latency at 2 blocks an SM, not by the stores -- at the packed
//   first conv dropping the stores saves less than dropping the MMA loop. Alternatives timed
//   while it was written were slower or no faster: items of 64 or 128 voxels
//   a channel (128- and 256-byte runs; they spilled), pitches of the staged
//   planes chosen against bank conflicts, passes of 64 channels split over
//   warp pairs (slower at C_out = 32). wgmma and TMA are not used: at 52
//   operations a byte the tensor cores are not the limit, and padding C to
//   16 for the packed kernel would do 8x the multiply-adds at C = 2.
//   Padded channels (C_in above 16 and not a multiple of 16; on the TPU the
//   same kernel at even C_in, odd C_in padded to even by the JAX model,
//   models/basic_unet_cs.py:44-58): the tensor cores' K depth is 16 channels,
//   so the pack pads to it as the JAX package pads to the TPU's bf16 pairs.
//   At 24 channels (level 0 of a (24, 24, 48, 96, 192, 24) model) the work is
//   bound by operations: 2 * 27 * 24 * 24 / (2 * (24 + 24)) = 324 operations
//   a byte against the card's 295. The padding costs 32 / 24 = 1.33x the
//   multiply-adds on K there (and 1.33x on N, C_out 24 in a 32-wide tile:
//   unchanged from the unpadded kernel), 15 / 17 more at worst (C_in = 17
//   padded to 32), none at 24 + 24 (48 slots); the pack writes Cp / C_in
//   times the bytes. Against that, each (dz, 16-slot) span is one strided
//   16-byte copy serving all 9 (dy, dx) taps, where gathering the im2col tile
//   element by element ran at 0.005 of the bound.
// - conv3d_cs_packed_wide_kernel (planes wider than the packed ring: at
//   256-row tiles W > 556, where 3 stages of the span above would pass the
//   232,448 bytes of shared memory a block may opt into; on the TPU the same
//   kernel, whose programs _auto_planes sizes to VMEM): the same implicit
//   GEMM on the same xp and weights, with tiles that do not grow with W:
//   WIDE_ROWS x WIDE_COLS = 4 x 64 outputs of one plane, one warp's 32 rows
//   in one tile row. A stage, (dz, 16 channel slots) as above, is the 6 x 66
//   voxels of padded plane d + dz around the tile, 6 rows of 66 voxels
//   copied with the same 16-byte cp.async (those past the padded plane's
//   edge, which feed only dropped outputs of a ragged tile, are not copied,
//   so nothing is read past xp's end), and its 9 (dy, dx) taps are offsets
//   dy * 66 + dx into it: (396 * 24 + 9 * 16 * 40) * 2 = 30528 bytes a
//   stage, 91584 for the ring of 3 whatever W is (the plane instance's at
//   W = 64 is 90720), and 2 blocks of 256 threads an SM. A tap moves 44
//   span voxels through shared memory, as the plane instance does at
//   W = 64. The design it replaced, a stage of one (dz, dy) row span of
//   TM + 2 voxels serving 3 dx taps (86 voxels a tap), was measured on the
//   H100 (conv3d_cs_wide_variants.py): with its copies dropped a level-0
//   conv at (64, 96, 640) took 1.39 ms, with its MMAs dropped 2.30, whole
//   2.54: the copies into shared memory, not the tensor cores, bound it.
//   One plane's tiles are spread over blocks: the grid is (C_out tiles,
//   tile groups, D * B), the groups of consecutive tiles sized by
//   ops/conv3d_cs.py wide_tile_groups to the fewest waves of 2 blocks on the
//   132 SMs times a block's stages (at least one wave where there are tiles
//   enough; one block a plane gave 32 blocks at 2 windows of (16, 16,
//   1024)). Each block reduces its (sum, sum of squares) as above and writes
//   them in f32 to a scratch buffer; conv3d_cs_stats_sum_kernel then adds a
//   plane's partials in group order. Blocks run in no order and nothing
//   carries between them: the same bits on every launch.
//
// The packed, direct and narrow kernels walk a whole H*W plane in one block
// in a fixed order (one block per (C_out tile of 32, z-plane d, batch b); the
// narrow kernel per (d, b) for all of C_out), so the plane's stats are
// reduced inside the block in a fixed order: no atomics, no second pass, the
// same bits on every run (a TPU grid runs in order, Hopper blocks do not).
// The wide instance's second pass keeps that order across its blocks.
//
// Left for later: wgmma and TMA on xp, multi-plane tiles for the small planes
// of levels 3-4, wider N tiles (and, for the padded shapes, an N tile of 24
// or 48 channels and more blocks at a few windows); for the narrow kernel,
// more warps in flight (its 113 registers allow 2 blocks of 256 threads an
// SM) and an epilogue of fewer instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;        // output channels per block (GEMM columns)
// packed path
constexpr int PCC = 16;       // input channels per stage
constexpr int STAGES = 3;     // ring depth
constexpr int WM = 32;        // tile rows a warp
constexpr int MI = WM / 16;   // 16-row mma blocks a warp
constexpr int LDX = PCC + 8;  // span row: one voxel's 16 channels, padded
constexpr int LDP = TN + 8;   // weight row: one K row's 32 output channels
constexpr int W_STAGE = 9 * PCC * LDP;  // bf16 of one stage's weights
constexpr int WIDE_TM = 256;            // tile rows of the wide instance
constexpr int STATS_THREADS = 256;      // the wide instance's stats pass
constexpr int PACK_THREADS = 256;
// direct path
constexpr int DIRECT_THREADS = 256;  // 8 warps: warp w holds channel group w & 3
constexpr int DV = 8;                // x voxels a work unit
constexpr int DC = 8;                // output channels a work unit
// narrow path
constexpr int NARROW_THREADS = 256;  // 8 warps
constexpr int NARROW_WARPS = NARROW_THREADS / 32;
constexpr int NARROW_MAX_C = 16;     // C1 + C2 the narrow conv takes
constexpr int NMI = 2;               // 16-row mma blocks a warp tile
constexpr int NTM = 16 * NMI;        // output voxels a warp tile
constexpr int NTN = 32;              // output channels a warp tile (4 n8 blocks)
constexpr int LDE = NTM + 8;         // epilogue row: one channel's NTM voxels, padded
static_assert(NMI == 2 && NTN == 32, "the narrow epilogue's stmatrix.x4 takes 2 x 2 8x8 blocks");

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
  int Cp;  // the pack's channel slots (packed_channels(C1, C2))
};

// mish as PyTorch computes v * tanh(softplus(v)) in f32 (softplus with its
// threshold 20), so that the prologue gives the plain version's bits.
__device__ __forceinline__ float mish_f32(float v) {
  const float sp = v > 20.f ? v : log1pf(expf(v));
  return __fmul_rn(v, tanhf(sp));
}

// Channel ci of the (virtual) concat input after the pair bias and the affine
// prologue, given its raw bf16 value. Explicit roundings (no fused
// multiply-add): the plain version's f32 product, then its sum.
__device__ __forceinline__ __nv_bfloat16 prologue(const Args& p, int b, int ci,
                                                  __nv_bfloat16 val) {
  if (ci >= p.C1 && p.pair_bias != nullptr) {
    val = __float2bfloat16(__fadd_rn(__bfloat162float(val),
                                     __bfloat162float(p.pair_bias[ci - p.C1])));
  }
  if (p.aff_a != nullptr) {
    const int cin = p.C1 + p.C2;
    const float v = __fadd_rn(__fmul_rn(__bfloat162float(val), p.aff_a[b * cin + ci]),
                              p.aff_c[b * cin + ci]);
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

// The channel slots of xp: C1 and C2 each padded to a multiple of 8, their
// sum to a multiple of 16 (the packed conv's K step).
__host__ __device__ constexpr int pad8(int c) { return (c + 7) / 8 * 8; }
__host__ __device__ constexpr int packed_channels(int c1, int c2) {
  return (pad8(c1) + pad8(c2) + PCC - 1) / PCC * PCC;
}

// The concat channel that slot s of xp holds, or -1 for a pad slot: slots
// [0, C1) hold x, slots [C1p, C1p + C2) channels C1 .. C1 + C2 - 1 (x2).
__device__ __forceinline__ int slot_channel(const Args& p, int s) {
  const int c1p = pad8(p.C1);
  if (s < c1p) return s < p.C1 ? s : -1;
  return s - c1p < p.C2 ? p.C1 + s - c1p : -1;
}

// ---------------------------------------------------------------------------
// pack: (B, D, C, H*W) -> xp (B, D + 2, H + 2, W + 2, Cp)

// Unit u of the interior: the 8 channel slots of group g x VEC consecutive
// voxels of one plane. Loads along x, transposes in registers, 16-byte
// stores. PAD: slot s holds concat channel slot_channel(s), a pad slot an
// exact zero, the prologue not applied. Without PAD slot s is channel s:
// the slot map in that loop cost 3 % of the pack's time at the production
// shapes, where Cp = C1 + C2, on an H100 (chip_smoke.py's pack rows).
template <int VEC, bool PAD>
__device__ __forceinline__ void pack_interior(const Args& p, long long u) {
  const int G = p.Cp / 8;
  const int S = p.H * p.W;
  const int NV = S / VEC;
  const int g = (int)(u % G);
  const long long r = u / G;
  const int j = (int)(r % NV);
  const int bz = (int)(r / NV);
  const int b = bz / p.D;
  const int z = bz - b * p.D;
  __nv_bfloat16 v[8][VEC];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ci = PAD ? slot_channel(p, 8 * g + e) : 8 * g + e;
    if (PAD && ci < 0) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) v[e][t] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* src = channel_ptr(p, b, z, ci) + (size_t)j * VEC;
    if constexpr (VEC == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(src);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[e][t] = h[t];
    } else {
      v[e][0] = *src;
    }
#pragma unroll
    for (int t = 0; t < VEC; ++t) v[e][t] = prologue(p, b, ci, v[e][t]);
  }
  const size_t plane = (size_t)b * (p.D + 2) + z + 1;
#pragma unroll
  for (int t = 0; t < VEC; ++t) {
    const int m = j * VEC + t;
    const int y = m / p.W;
    const int x = m - y * p.W;
    uint32_t w4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w4[e] = (uint32_t)__bfloat16_as_ushort(v[2 * e][t]) |
              ((uint32_t)__bfloat16_as_ushort(v[2 * e + 1][t]) << 16);
    }
    const size_t vox = (plane * (p.H + 2) + y + 1) * (p.W + 2) + x + 1;
    *reinterpret_cast<uint4*>(p.out + vox * p.Cp + 8 * g) =
        make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
}

// Unit u of the halo: 8 zero channel slots of one halo voxel. Per batch the
// halo is the two padded planes z' = 0 and D + 1, then for each interior
// plane its rows y' = 0 and H + 1 and its columns x' = 0 and W + 1.
__device__ __forceinline__ void pack_halo(const Args& p, long long u) {
  const int G = p.Cp / 8;
  const int WP = p.W + 2;
  const int P = (p.H + 2) * WP;
  const int R = 2 * WP + 2 * p.H;
  const long long NH = 2LL * P + (long long)p.D * R;
  const int g = (int)(u % G);
  const long long r = u / G;
  const int h = (int)(r % NH);
  const int b = (int)(r / NH);
  int zp, yp, xp;
  if (h < 2 * P) {
    zp = h < P ? 0 : p.D + 1;
    const int q = h % P;
    yp = q / WP;
    xp = q - yp * WP;
  } else {
    const int h2 = h - 2 * P;
    zp = 1 + h2 / R;
    const int k = h2 % R;
    if (k < 2 * WP) {
      yp = k < WP ? 0 : p.H + 1;
      xp = k % WP;
    } else {
      yp = 1 + (k - 2 * WP) / 2;
      xp = (k & 1) ? p.W + 1 : 0;
    }
  }
  const size_t vox = (((size_t)b * (p.D + 2) + zp) * (p.H + 2) + yp) * WP + xp;
  *reinterpret_cast<uint4*>(p.out + vox * p.Cp + 8 * g) = make_uint4(0u, 0u, 0u, 0u);
}

template <int VEC, bool PAD>
__global__ void __launch_bounds__(PACK_THREADS) conv3d_cs_pack_kernel(
    Args p, long long n_interior, long long n_total) {
  const long long stride = (long long)gridDim.x * PACK_THREADS;
  for (long long u = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
       u < n_total; u += stride) {
    if (u < n_interior) {
      pack_interior<VEC, PAD>(p, u);
    } else {
      pack_halo(p, u - n_interior);
    }
  }
}

// ---------------------------------------------------------------------------
// packed conv on xp

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

struct PackedArgs {
  const __nv_bfloat16* xp;  // (B, D + 2, H + 2, W + 2, Cin) and a tail
  const __nv_bfloat16* w;   // (ceil(Cout / TN), 27 * Cin, TN), zero-padded
  const float* bias;
  __nv_bfloat16* out;
  float* stats;  // (B, D, 2, Cout); the wide instance's (B * D, groups, 2, Cout)
  int B, D, Cin, Cout, H, W;
  int tiles_per_block;  // the wide instance's tiles a block (the last group's fewer)
};

__host__ __device__ constexpr int packed_stage_elems(int tm, int W) {
  return (tm + 2 * (W + 2) + 2) * LDX + W_STAGE;
}
// The wide instance's tiles: WIDE_ROWS rows x WIDE_COLS columns of a plane.
// A stage is the (WIDE_ROWS + 2) x (WIDE_COLS + 2) voxels of padded plane
// d + dz around the tile, 16 channel slots each, and the 9 (dy, dx) taps'
// weights.
constexpr int WIDE_COLS = 64;
constexpr int WIDE_ROWS = WIDE_TM / WIDE_COLS;
constexpr int WIDE_SPAN_COLS = WIDE_COLS + 2;
__host__ __device__ constexpr int wide_stage_elems() {
  return (WIDE_ROWS + 2) * WIDE_SPAN_COLS * LDX + W_STAGE;
}

// The packed conv of one block: tiles of TMP outputs, a stage (dz, 16-slot
// chunk) serving the 9 (dy, dx) taps. WIDE = false: one block a (C_out tile,
// plane d, batch b) walks the plane's tiles of TMP consecutive virtual
// voxels, whose span is one contiguous run of xp. WIDE = true: one block a
// (C_out tile, tile group, plane) walks its group's tiles of WIDE_ROWS x
// WIDE_COLS outputs, whose span is WIDE_ROWS + 2 runs of WIDE_SPAN_COLS
// voxels, and writes its stats as the block's partials.
template <int TMP, bool WIDE>
__device__ __forceinline__ void packed_conv(const PackedArgs& p) {
  constexpr int NW = TMP / WM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int WP = p.W + 2;
  const int P = (p.H + 2) * WP;
  const int NS = WIDE ? (WIDE_ROWS + 2) * WIDE_SPAN_COLS : TMP + 2 * WP + 2;
  const int stage_elems = WIDE ? wide_stage_elems() : packed_stage_elems(TMP, p.W);
  const int SR = WIDE ? WIDE_SPAN_COLS : WP;  // span row: tap dy's offset
  const int cin = p.Cin;
  const int nch = cin / PCC;
  const int KI = 3 * nch;  // stages per tile: (dz, channel chunk)
  const int V = p.H * WP;  // virtual outputs of the plane
  const int strips = (p.W + WIDE_COLS - 1) / WIDE_COLS;

  const int nt = blockIdx.x;
  const int n0 = nt * TN;
  int d, b, t0, tiles;
  if constexpr (WIDE) {
    d = blockIdx.z % p.D;
    b = blockIdx.z / p.D;
    t0 = blockIdx.y * p.tiles_per_block;
    tiles = min(p.tiles_per_block, (p.H + WIDE_ROWS - 1) / WIDE_ROWS * strips - t0);
  } else {
    d = blockIdx.y;
    b = blockIdx.z;
    t0 = 0;
    tiles = (V + TMP - 1) / TMP;
  }
  const int total = tiles * KI;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // padded plane d + dz holds input plane d + dz - 1: tap dz of output plane d
  const __nv_bfloat16* xb = p.xp + ((size_t)b * (p.D + 2) + d) * P * cin;
  const __nv_bfloat16* wb = p.w + (size_t)nt * 27 * cin * TN;
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(smem);

  auto load = [&](int it) {
    const int t = t0 + it / KI;
    const int k = it - (it / KI) * KI;
    const int dz = k / nch;
    const int c0 = (k - dz * nch) * PCC;
    const uint32_t a_s = smem0 + (uint32_t)((it % STAGES) * stage_elems) * 2u;
    const uint32_t w_s = a_s + (uint32_t)(NS * LDX) * 2u;
    if constexpr (WIDE) {
      // rows r0 .. r0 + WIDE_ROWS + 1 and columns x0 .. x0 + WIDE_COLS + 1 of
      // the padded plane; those past its edge (a ragged tile) feed only
      // dropped outputs and are not copied
      const int r0 = t / strips * WIDE_ROWS;
      const int x0 = t % strips * WIDE_COLS;
      const __nv_bfloat16* src = xb + ((size_t)dz * P + (size_t)r0 * WP + x0) * cin + c0;
      for (int i = tid; i < NS * 2; i += TMP) {
        const int q = i >> 1;
        const int h = (i & 1) * 8;
        const int qr = q / WIDE_SPAN_COLS;
        const int qc = q - qr * WIDE_SPAN_COLS;
        if (r0 + qr < p.H + 2 && x0 + qc < WP) {
          cp_async16(a_s + (uint32_t)(q * LDX + h) * 2u,
                     src + ((size_t)qr * WP + qc) * cin + h);
        }
      }
    } else {
      const __nv_bfloat16* src = xb + ((size_t)dz * P + (size_t)t * TMP) * cin + c0;
      for (int i = tid; i < NS * 2; i += TMP) {
        const int q = i >> 1;
        const int h = (i & 1) * 8;
        cp_async16(a_s + (uint32_t)(q * LDX + h) * 2u, src + (size_t)q * cin + h);
      }
    }
    const __nv_bfloat16* wsrc = wb + ((size_t)dz * 9 * cin + c0) * TN;
    for (int i = tid; i < 9 * PCC * (TN / 8); i += TMP) {
      const int row = i >> 2;  // j * PCC + kk
      const int q = (i & 3) * 8;
      const int j = row / PCC;
      const int kk = row - j * PCC;
      cp_async16(w_s + (uint32_t)(row * LDP + q) * 2u,
                 wsrc + ((size_t)j * cin + kk) * TN + q);
    }
  };

  float acc[MI][4][4];
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[ni][e] = s2[ni][e] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    }
  }
  // ldmatrix row addresses of this lane: A rows (lane & 15) of the warp's
  // 16-row block, channels (lane >> 4) * 8 (tile row i at span voxel i, or
  // in the wide instance at (i / WIDE_COLS, i % WIDE_COLS) of the span: a
  // warp's 32 rows lie in one tile row); B K rows (lane & 15), output
  // channels (lane >> 4) * 8 of a 16-wide block
  const int a_row = WIDE ? (warp * WM) / WIDE_COLS * WIDE_SPAN_COLS + (warp * WM) % WIDE_COLS
                         : warp * WM;
  const uint32_t a_lane = (uint32_t)(((a_row + (lane & 15)) * LDX + (lane >> 4) * 8) * 2);
  const uint32_t b_lane = (uint32_t)(((lane & 15) * LDP + (lane >> 4) * 8) * 2);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  int k_in_tile = 0;
  int v0 = t0 * TMP;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed for all; stage it - 1 is free
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();

    const uint32_t a_s = smem0 + (uint32_t)((it % STAGES) * stage_elems) * 2u;
    const uint32_t w_s = a_s + (uint32_t)(NS * LDX) * 2u;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int off = (j / 3) * SR + (j % 3);
      uint32_t af[MI][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        ldmatrix_x4(af[mi], a_s + a_lane + (uint32_t)((off + 16 * mi) * LDX * 2));
      }
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        ldmatrix_x4_trans(bq[nh], w_s + b_lane + (uint32_t)((j * PCC * LDP + nh * 16) * 2));
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], af[mi], bq[ni >> 1][(ni & 1) * 2],
                   bq[ni >> 1][(ni & 1) * 2 + 1]);
        }
      }
    }

    if (++k_in_tile == KI) {
      // epilogue of the tile, from registers: tile row i is virtual voxel
      // v0 + i = r * WP + c, or in the wide instance output (r0 + i /
      // WIDE_COLS, x0 + i % WIDE_COLS); columns c >= W and rows r >= H are
      // dropped
      const int S = p.H * p.W;
      const int t = t0 + it / KI;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = warp * WM + 16 * mi + (lane >> 2) + 8 * h;
          int r, c;
          if constexpr (WIDE) {
            r = t / strips * WIDE_ROWS + i / WIDE_COLS;
            c = t % strips * WIDE_COLS + i % WIDE_COLS;
          } else {
            const int v = v0 + i;
            r = v / WP;
            c = v - r * WP;
          }
          if (r < p.H && c < p.W) {
            const int m = r * p.W + c;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = n0 + 8 * ni + 2 * (lane & 3) + e;
                if (n < p.Cout) {
                  float val = acc[mi][ni][2 * h + e];
                  if (p.bias != nullptr) val += p.bias[n];
                  p.out[(((size_t)b * p.D + d) * p.Cout + n) * S + m] =
                      __float2bfloat16(val);
                  s1[ni][e] += val;
                  s2[ni][e] += val * val;
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
        }
      }
      k_in_tile = 0;
      v0 += TMP;
    }
  }
  cp_async_wait<0>();
  if (p.stats == nullptr) return;

  // stats: a fixed xor tree over the 8 lanes that share a column, then the
  // warps in order; the ring's buffers are free once every thread is here
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [2][NW][TN]
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[ni][e] += __shfl_xor_sync(0xffffffffu, s1[ni][e], o);
        s2[ni][e] += __shfl_xor_sync(0xffffffffu, s2[ni][e], o);
      }
      if (lane < 4) {
        const int col = 8 * ni + 2 * lane + e;
        red[warp * TN + col] = s1[ni][e];
        red[(NW + warp) * TN + col] = s2[ni][e];
      }
    }
  }
  __syncthreads();
  if (tid < 2 * TN) {
    const int q = tid / TN;
    const int col = tid - q * TN;
    if (n0 + col < p.Cout) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += red[(q * NW + w) * TN + col];
      // the wide instance: partial (plane, group) of its scratch buffer
      const size_t row = WIDE ? (size_t)blockIdx.z * gridDim.y + blockIdx.y
                              : (size_t)b * p.D + d;
      p.stats[(row * 2 + q) * p.Cout + n0 + col] = s;
    }
  }
}

template <int TMP>
__global__ void __launch_bounds__(TMP, 512 / TMP) conv3d_cs_packed_kernel(PackedArgs p) {
  packed_conv<TMP, false>(p);
}

__global__ void __launch_bounds__(WIDE_TM, 2) conv3d_cs_packed_wide_kernel(PackedArgs p) {
  packed_conv<WIDE_TM, true>(p);
}

// The wide instance's stats: stats[plane, q, n] = the sum over groups g, in
// order, of partials[plane, g, q, n]; one thread a (plane, q, n).
__global__ void __launch_bounds__(STATS_THREADS) conv3d_cs_stats_sum_kernel(
    const float* partials, float* stats, int planes, int groups, int cout) {
  const long long i = (long long)blockIdx.x * STATS_THREADS + threadIdx.x;
  const int row = 2 * cout;
  if (i >= (long long)planes * row) return;
  const long long plane = i / row;
  const float* src = partials + plane * groups * row + (i - plane * row);
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += src[(size_t)g * row];
  stats[i] = s;
}

// ---------------------------------------------------------------------------
// direct conv, C_in = 1, on (B, D, 1, H*W)

// Floats of shared memory: the weights [27][TN], then input planes
// d - 1, d, d + 1 of a band, [3][rb + 2][W + 4], column c holding x = c - 1.
__host__ __device__ constexpr int direct_smem_floats(int rb, int W) {
  return 27 * TN + 3 * (rb + 2) * (W + 4);
}

__global__ void __launch_bounds__(DIRECT_THREADS, 512 / DIRECT_THREADS)
    conv3d_cs_direct_kernel(Args p, int rb, int vec) {
  constexpr int STRIDE = DIRECT_THREADS / 4;  // units a channel group takes at once
  extern __shared__ __align__(16) float dsm[];
  float* w_s = dsm;
  float* in_s = dsm + 27 * TN;
  const int WP = p.W + 4;  // a multiple of 4: every row starts 16-byte aligned
  const int RP = rb + 2;
  const int G = p.W / DV;  // voxel groups a row
  const int S = p.H * p.W;
  const int n0 = blockIdx.x * TN;
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = warp & 3;
  const bool active = n0 + cg * DC < p.Cout;
  // the warp's 32 consecutive units: quarter warp q on rows 2 (q >> 1) + {0, 1}
  // and groups 4 (q & 1) + {0..3} of a 64-wide plane
  const int slot = (warp >> 2) * 32 + ((lane >> 4) << 4 | ((lane >> 2) & 1) << 3 |
                                       ((lane >> 3) & 1) << 2 | (lane & 3));

  for (int i = tid; i < 27 * TN; i += DIRECT_THREADS) {
    const int k = i / TN;
    const int n = n0 + i - k * TN;
    w_s[i] = n < p.Cout ? __bfloat162float(p.w[(size_t)k * p.Cout + n]) : 0.f;
  }
  float s1[DC], s2[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) s1[j] = s2[j] = 0.f;

  for (int r0 = 0; r0 < p.H; r0 += rb) {
    const int rows = min(rb, p.H - r0);
    __syncthreads();  // the last band's reads are done
    // input rows r0 - 1 .. r0 + rows of planes d - 1 .. d + 1 with the
    // prologue, 8 columns a thread (one 16-byte load where x is aligned);
    // zeros outside the volume
    for (int i = tid; i < 3 * (rows + 2) * G; i += DIRECT_THREADS) {
      const int j = i % G;
      const int zr = i / G;
      const int pz = zr / (rows + 2);
      const int pr = zr - pz * (rows + 2);
      const int z = d + pz - 1;
      const int y = r0 + pr - 1;
      float* dst = in_s + (pz * RP + pr) * WP + DV * j;  // column DV j + 1 holds x = DV j
      float v[DV];
#pragma unroll
      for (int t = 0; t < DV; ++t) v[t] = 0.f;
      if (z >= 0 && z < p.D && y >= 0 && y < p.H) {
        const __nv_bfloat16* src = p.x1 + ((size_t)b * p.D + z) * S + (size_t)y * p.W + DV * j;
        uint4 q;
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&q);
        if (vec) {
          q = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int t = 0; t < DV; ++t) h[t] = src[t];
        }
#pragma unroll
        for (int t = 0; t < DV; ++t) v[t] = __bfloat162float(prologue(p, b, 0, h[t]));
      }
#pragma unroll
      for (int t = 0; t < DV; ++t) dst[1 + t] = v[t];
      if (j == 0) dst[0] = 0.f;           // x = -1
      if (j == G - 1) dst[DV + 1] = 0.f;  // x = W
    }
    __syncthreads();
    if (!active) continue;

    for (int u = slot; u < rows * G; u += STRIDE) {
      const int y = u / G;
      const int x0 = (u - y * G) * DV;
      float acc[DC][DV];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
#pragma unroll
        for (int i = 0; i < DV; ++i) acc[j][i] = 0.f;
      }
      // dz stays a loop: unrolled, the compiler hoists all 27 taps' weight
      // reads (216 floats) out of the unit loop, and at the 128-register cap
      // of 2 blocks an SM they spill (31 ms against 3.2)
#pragma unroll 1
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // padded column x0 + k holds x = x0 + k - 1: voxel x0 + i, tap dx reads v[i + dx]
          const float* row = in_s + (dz * RP + y + dy) * WP + x0;
          const float4 a0 = *reinterpret_cast<const float4*>(row);
          const float4 a1 = *reinterpret_cast<const float4*>(row + 4);
          const float2 a2 = *reinterpret_cast<const float2*>(row + 8);
          const float v[DV + 2] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wt = w_s + ((dz * 3 + dy) * 3 + dx) * TN + cg * DC;
            const float4 w0 = *reinterpret_cast<const float4*>(wt);
            const float4 w1 = *reinterpret_cast<const float4*>(wt + 4);
            const float wv[DC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < DC; ++j) {
#pragma unroll
              for (int i = 0; i < DV; ++i) acc[j][i] = fmaf(v[i + dx], wv[j], acc[j][i]);
            }
          }
        }
      }
      // epilogue from registers: per channel, 8 voxels in one 16-byte store
      const int m = (r0 + y) * p.W + x0;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int n = n0 + cg * DC + j;
        const float bn = p.bias != nullptr ? p.bias[n] : 0.f;
        uint32_t h[DV / 2];
#pragma unroll
        for (int i = 0; i < DV; i += 2) {
          float v0 = acc[j][i], v1 = acc[j][i + 1];
          if (p.bias != nullptr) {
            v0 += bn;
            v1 += bn;
          }
          s1[j] += v0 + v1;
          s2[j] += v0 * v0 + v1 * v1;
          h[i / 2] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v0)) |
                     ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v1)) << 16);
        }
        *reinterpret_cast<uint4*>(p.out + (((size_t)b * p.D + d) * p.Cout + n) * S + m) =
            make_uint4(h[0], h[1], h[2], h[3]);
      }
    }
  }
  if (p.stats == nullptr) return;

  // stats: a fixed xor tree over the warp, then the channel group's warps
  // in order; the weights' buffer is free once every thread is here
  __syncthreads();
  float* red = w_s;  // [warps][2][DC]
#pragma unroll
  for (int j = 0; j < DC; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      red[warp * 2 * DC + j] = s1[j];
      red[warp * 2 * DC + DC + j] = s2[j];
    }
  }
  __syncthreads();
  if (tid < 2 * TN) {
    const int q = tid / TN;
    const int col = tid - q * TN;
    const int g = col / DC;
    const int e = q * DC + col - g * DC;
    if (n0 + col < p.Cout) {
      float s = 0.f;
      for (int k = g; k < DIRECT_THREADS / 32; k += 4) s += red[k * 2 * DC + e];
      p.stats[(((size_t)b * p.D + d) * 2 + q) * p.Cout + n0 + col] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// narrow conv on (B, D, C, H*W), C1 + C2 <= NARROW_MAX_C

// Channels staged a voxel (C padded to even) and K = 27 * ce padded to 16.
__host__ __device__ constexpr int narrow_ce(int c) { return c + (c & 1); }
__host__ __device__ constexpr int narrow_kp(int ce) { return (27 * ce + 15) / 16 * 16; }

// Shared memory, in this order (each part a multiple of 16 bytes but the
// last): the warps' epilogue tiles [NARROW_WARPS][NTN][LDE] bf16, one pass's
// weights [NTN][kp + 8] bf16, the stats partials [NARROW_WARPS][2][NTN] f32,
// the K-pair offsets [kp / 2] int, and the band's input
// [3][rb + 2][W + 2][ce] bf16.
__host__ __device__ constexpr size_t narrow_smem_bytes(int ce, int rb, int W) {
  return (size_t)NARROW_WARPS * NTN * LDE * 2 + (size_t)NTN * (narrow_kp(ce) + 8) * 2 +
         (size_t)NARROW_WARPS * 2 * NTN * 4 + (size_t)narrow_kp(ce) / 2 * 4 +
         (size_t)3 * (rb + 2) * (W + 2) * ce * 2;
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// Eight x voxels from x0 of channel ci at plane z, row y, after the prologue
// (zeros past W, and for the pad channel ci == C1 + C2).
__device__ __forceinline__ void narrow_load8(const Args& p, int b, int z, int y, int x0,
                                             int ci, bool vec, __nv_bfloat16 (&v)[8]) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (ci >= p.C1 + p.C2) {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = zero;
    return;
  }
  const __nv_bfloat16* src = channel_ptr(p, b, z, ci) + (size_t)y * p.W + x0;
  if (vec) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = prologue(p, b, ci, h[t]);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = x0 + t < p.W ? prologue(p, b, ci, src[t]) : zero;
  }
}

// One block a (d, b) plane. Per band of rb output rows: planes d - 1, d,
// d + 1 staged once, rows r0 - 1 .. r0 + rows, columns -1 .. W, as
// [pz][row][col][ce] bf16 with zeros outside the volume; then per pass of NTN
// output channels, warp tiles of NTM voxels x NTN channels over the band.
__global__ void __launch_bounds__(NARROW_THREADS, 2)
    conv3d_cs_narrow_kernel(Args p, int rb, int vec_in, int vec_out) {
  extern __shared__ __align__(16) unsigned char nsm[];
  const int C = p.C1 + p.C2;
  const int ce = narrow_ce(C);
  const int cw = ce / 2;  // 32-bit words a staged voxel
  const int kp = narrow_kp(ce);
  const int ldw = kp + 8;  // weight row: one output channel's kp K values, padded
  const int WP = p.W + 2;
  const int ppw = (rb + 2) * WP * cw;  // words a staged plane
  const int S = p.H * p.W;
  const int cout8 = (p.Cout + 7) / 8 * 8;
  const int passes = (p.Cout + NTN - 1) / NTN;
  const int d = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  __nv_bfloat16* e_s = reinterpret_cast<__nv_bfloat16*>(nsm);
  __nv_bfloat16* w_s = e_s + NARROW_WARPS * NTN * LDE;
  float* red = reinterpret_cast<float*>(w_s + NTN * ldw);
  int* off_s = reinterpret_cast<int*>(red + NARROW_WARPS * 2 * NTN);
  uint32_t* in_s = reinterpret_cast<uint32_t*>(off_s + kp / 2);
  const uint32_t e_warp = (uint32_t)__cvta_generic_to_shared(e_s + warp * NTN * LDE);
  const uint32_t w_s0 = (uint32_t)__cvta_generic_to_shared(w_s);

  // word offset of K pair q (tap-major, channel pairs innermost) from an
  // output voxel's word in plane 0; the K pad repeats the last pair's (its
  // weights are zero), so its loads read words the warp reads anyway
  for (int q = tid; q < kp / 2; q += NARROW_THREADS) {
    const int tap = min(q / cw, 26);
    const int cp = q / cw < 27 ? q - tap * cw : cw - 1;
    off_s[q] = (tap / 9) * ppw + (((tap / 3) % 3) * WP + tap % 3) * cw + cp;
  }

  auto load_weights = [&](int n0) {
    const int rows = min(NTN, cout8 - n0);
    const int chunks = kp / 8;
    for (int i = tid; i < rows * chunks; i += NARROW_THREADS) {
      const int r = i / chunks;
      const int c = i - r * chunks;
      *reinterpret_cast<uint4*>(w_s + r * ldw + 8 * c) =
          *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + r) * kp + 8 * c);
    }
  };

  // ldmatrix row address of this lane: matrix (lane >> 3) = (n8 block
  // 2 jp + (lane >> 4), K half (lane >> 3) & 1), row lane & 7
  const int mat = lane >> 3;
  const uint32_t b_lane = (uint32_t)(((8 * (mat >> 1) + (lane & 7)) * ldw + 8 * (mat & 1)) * 2);
  // stmatrix row address of this lane: matrix (lane >> 3) = (mi, h), row
  // lane & 7 is output channel 8 j + (lane & 7), voxels 16 mi + 8 h ..
  const uint32_t e_lane = e_warp + (uint32_t)(((lane & 7) * LDE + 8 * mat) * 2);

  float s1[4][2], s2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
  const size_t plane_out = ((size_t)b * p.D + d) * p.Cout;

  for (int r0 = 0; r0 < p.H; r0 += rb) {
    const int rows = min(rb, p.H - r0);
    const int V = rows * p.W;  // output voxels of the band
    __syncthreads();  // the last band's reads of in_s and w_s are done
    {
      // unit u: 8 x voxels of channel pair cp of one staged row
      const int G8 = (p.W + 7) / 8;
      const int units = 3 * (rows + 2) * G8 * cw;
      for (int u = tid; u < units; u += NARROW_THREADS) {
        const int cp = u % cw;
        const int r = u / cw;
        const int j = r % G8;
        const int zr = r / G8;
        const int pz = zr / (rows + 2);
        const int pr = zr - pz * (rows + 2);
        const int z = d + pz - 1;
        const int y = r0 + pr - 1;
        uint32_t* row = in_s + pz * ppw + pr * WP * cw + cp;
        __nv_bfloat16 lo[8], hi[8];
        if (z >= 0 && z < p.D && y >= 0 && y < p.H) {
          narrow_load8(p, b, z, y, 8 * j, 2 * cp, vec_in, lo);
          narrow_load8(p, b, z, y, 8 * j, 2 * cp + 1, vec_in, hi);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) lo[e] = hi[e] = __float2bfloat16(0.f);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (8 * j + e < p.W) {  // column c holds x = c - 1
            row[(8 * j + e + 1) * cw] = (uint32_t)__bfloat16_as_ushort(lo[e]) |
                                        ((uint32_t)__bfloat16_as_ushort(hi[e]) << 16);
          }
        }
        if (j == 0) row[0] = 0u;                     // x = -1
        if (j == G8 - 1) row[(p.W + 1) * cw] = 0u;  // x = W
      }
    }
    if (passes > 1 || r0 == 0) load_weights(0);
    __syncthreads();

    for (int pass = 0; pass < passes; ++pass) {
      const int n0 = pass * NTN;
      if (pass > 0) {
        __syncthreads();  // the last pass's reads of w_s (and red) are done
        load_weights(n0);
        __syncthreads();
      }
      // warp w takes tiles w, w + 8, .. of the pass's NTN channels: a
      // channel's outputs and stats come out the same bits whatever C_out
      // is (the packed first conv's window equals that window alone)
      const int ntl = min(NTN, cout8 - n0) / 8;  // n8 blocks of this pass
      float bias[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t + e;
          bias[j][e] = p.bias != nullptr && n < p.Cout ? p.bias[n] : 0.f;
        }
      }
      const uint32_t b_warp = w_s0 + b_lane;
      const int n_tiles = (V + NTM - 1) / NTM;

      for (int tile = warp; tile < n_tiles; tile += NARROW_WARPS) {
        const int m0 = tile * NTM;  // first band voxel of the tile
        // this lane's rows: voxel (y, x) of the band from one division a tile
        int base[NMI][2];
        bool ok[NMI][2];
        {
          int y = m0 / p.W;
          int x = m0 - y * p.W + g;
#pragma unroll
          for (int q = 0; q < 2 * NMI; ++q) {
            if (q > 0) x += 8;
            while (x >= p.W) {
              x -= p.W;
              ++y;
            }
            ok[q >> 1][q & 1] = m0 + 8 * q + g < V;
            // a row past the band reads the band's first voxel, and is dropped
            base[q >> 1][q & 1] = ok[q >> 1][q & 1] ? (y * WP + x) * cw : 0;
          }
        }
        float acc[NMI][4][4];
#pragma unroll
        for (int mi = 0; mi < NMI; ++mi) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[mi][j][0] = acc[mi][j][2] = bias[j][0];
            acc[mi][j][1] = acc[mi][j][3] = bias[j][1];
          }
        }
#pragma unroll 4
        for (int s = 0; s < kp / 16; ++s) {
          const int o_lo = off_s[8 * s + t];
          const int o_hi = off_s[8 * s + 4 + t];
          uint32_t af[NMI][4];
#pragma unroll
          for (int mi = 0; mi < NMI; ++mi) {
            af[mi][0] = in_s[base[mi][0] + o_lo];
            af[mi][1] = in_s[base[mi][1] + o_lo];
            af[mi][2] = in_s[base[mi][0] + o_hi];
            af[mi][3] = in_s[base[mi][1] + o_hi];
          }
          uint32_t bq[2][4];
          ldmatrix_x4(bq[0], b_warp + (uint32_t)(16 * s * 2));
          if (ntl > 2) ldmatrix_x4(bq[1], b_warp + (uint32_t)((16 * ldw + 16 * s) * 2));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < ntl) {
#pragma unroll
              for (int mi = 0; mi < NMI; ++mi) {
                mma_bf16(acc[mi][j], af[mi], bq[j >> 1][(j & 1) * 2],
                         bq[j >> 1][(j & 1) * 2 + 1]);
              }
            }
          }
        }

        // epilogue: stats from the f32 values, one bf16 rounding, the tile
        // transposed by stmatrix into the warp's [channel][voxel] buffer, then
        // 16-byte stores: a channel's NTM voxels are 64 contiguous bytes
        if (p.stats != nullptr) {
#pragma unroll
          for (int mi = 0; mi < NMI; ++mi) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (ok[mi][h]) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const float v = acc[mi][j][2 * h + e];
                    s1[j][e] += v;
                    s2[j][e] = fmaf(v, v, s2[j][e]);
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < ntl) {
            stmatrix_x4_trans(e_lane + (uint32_t)(8 * j * LDE * 2),
                              pack_bf16(acc[0][j][0], acc[0][j][1]),
                              pack_bf16(acc[0][j][2], acc[0][j][3]),
                              pack_bf16(acc[1][j][0], acc[1][j][1]),
                              pack_bf16(acc[1][j][2], acc[1][j][3]));
          }
        }
        __syncwarp();
        const __nv_bfloat16* e_w = e_s + warp * NTN * LDE;
        // channel n0, voxel m0 of the band
        __nv_bfloat16* o_item = p.out + (plane_out + n0) * S + (size_t)r0 * p.W + m0;
        const int ncol = min(8 * ntl, p.Cout - n0);  // channels of the tile
        if (vec_out) {
          const int c8 = 8 * (lane & 3);  // 4 lanes a channel
#pragma unroll
          for (int k = 0; k < NTN / 8; ++k) {
            const int col = 8 * k + (lane >> 2);
            if (col < ncol && m0 + c8 < V) {
              *reinterpret_cast<uint4*>(o_item + (size_t)col * S + c8) =
                  *reinterpret_cast<const uint4*>(e_w + col * LDE + c8);
            }
          }
        } else {
          for (int col = 0; col < ncol; ++col) {
            if (m0 + lane < V) o_item[(size_t)col * S + lane] = e_w[col * LDE + lane];
          }
        }
        __syncwarp();  // the buffer is rewritten by the next tile
      }

      if (p.stats != nullptr) {
        // the band's partials: a fixed xor tree over the 8 lanes that share
        // a column, then the 8 warps in order, added to the earlier bands'
        // sums (this block owns the plane's stats)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], o);
              s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], o);
            }
            if (lane < 4) {
              red[(warp * 2) * NTN + 8 * j + 2 * lane + e] = s1[j][e];
              red[(warp * 2 + 1) * NTN + 8 * j + 2 * lane + e] = s2[j][e];
            }
            s1[j][e] = s2[j][e] = 0.f;
          }
        }
        __syncthreads();
        if (tid < 2 * NTN) {
          const int q = tid / NTN;
          const int col = tid - q * NTN;
          if (n0 + col < p.Cout) {
            float sum = 0.f;
            for (int w = 0; w < NARROW_WARPS; ++w) sum += red[(w * 2 + q) * NTN + col];
            float* dst = p.stats + (((size_t)b * p.D + d) * 2 + q) * p.Cout + n0 + col;
            *dst = r0 == 0 ? sum : *dst + sum;
          }
        }
        // red is next written after a __syncthreads: the next pass's or band's
      }
    }
  }
}

template <int TMP>
int launch_packed(const PackedArgs& p, cudaStream_t s) {
  const size_t smem = (size_t)STAGES * packed_stage_elems(TMP, p.W) * 2;
  cudaError_t err = cudaFuncSetAttribute(conv3d_cs_packed_kernel<TMP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Cout + TN - 1) / TN, p.D, p.B);
  conv3d_cs_packed_kernel<TMP><<<grid, TMP, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t WIDE_SMEM = (size_t)STAGES * wide_stage_elems() * 2;

PackedArgs make_packed_args(const void* xp, const void* w, const void* bias, void* out,
                            void* stats, int B, int D, int Cin, int Cout, int H, int W) {
  PackedArgs p = {};
  p.xp = static_cast<const __nv_bfloat16*>(xp);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats = static_cast<float*>(stats);
  p.B = B;
  p.D = D;
  p.Cin = Cin;
  p.Cout = Cout;
  p.H = H;
  p.W = W;
  return p;
}

Args make_args(const void* x1, const void* x2, const void* pair_bias,
               const void* aff_a, const void* aff_c, int B, int D, int C1,
               int C2, int H, int W) {
  Args p = {};
  p.x1 = static_cast<const __nv_bfloat16*>(x1);
  p.x2 = static_cast<const __nv_bfloat16*>(x2);
  p.pair_bias = static_cast<const __nv_bfloat16*>(pair_bias);
  p.aff_a = static_cast<const float*>(aff_a);
  p.aff_c = static_cast<const float*>(aff_c);
  p.B = B;
  p.D = D;
  p.C1 = C1;
  p.C2 = C2;
  p.H = H;
  p.W = W;
  return p;
}

}  // namespace

// Every launcher runs on `stream` and returns cudaGetLastError() (0 = launched).

// xp (B, D + 2, H + 2, W + 2, packed_channels(C1, C2)) from x1, x2, the pair
// bias and the affine prologue: slots [0, C1) hold x1, slots [C1p, C1p + C2)
// x2 (C1p = C1 padded to a multiple of 8), the other slots zeros; where C1
// and C2 are multiples of 8 and C1 + C2 of 16 every slot is a channel. 16-byte
// loads along x when H*W is a multiple of 8 and x1, x2 are 16-byte aligned,
// else one voxel a load.
extern "C" int conv3d_cs_pack_launch(const void* x1, const void* x2,
                                     const void* pair_bias, const void* aff_a,
                                     const void* aff_c, void* xp, int B, int D,
                                     int C1, int C2, int H, int W, void* stream) {
  if (C1 < 1 || C2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args p = make_args(x1, x2, pair_bias, aff_a, aff_c, B, D, C1, C2, H, W);
  p.out = static_cast<__nv_bfloat16*>(xp);
  p.Cp = packed_channels(C1, C2);
  const bool pad = p.Cp != C1 + C2;
  const int G = p.Cp / 8;
  const int S = H * W;
  const long long P = (long long)(H + 2) * (W + 2);
  const long long n_halo = (long long)B * (2 * P + (long long)D * (2 * (W + 2) + 2 * H)) * G;
  const bool vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  const long long n_int = (long long)B * D * (vec ? S / 8 : S) * G;
  const long long n_total = n_int + n_halo;
  const long long want = (n_total + PACK_THREADS - 1) / PACK_THREADS;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks == 0) return 0;
  if (vec && pad) {
    conv3d_cs_pack_kernel<8, true><<<blocks, PACK_THREADS, 0, s>>>(p, n_int, n_total);
  } else if (vec) {
    conv3d_cs_pack_kernel<8, false><<<blocks, PACK_THREADS, 0, s>>>(p, n_int, n_total);
  } else if (pad) {
    conv3d_cs_pack_kernel<1, true><<<blocks, PACK_THREADS, 0, s>>>(p, n_int, n_total);
  } else {
    conv3d_cs_pack_kernel<1, false><<<blocks, PACK_THREADS, 0, s>>>(p, n_int, n_total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The packed conv: xp from conv3d_cs_pack_launch with a tail of at least
// tm + 1 voxels of storage past its end, Cin its channel slots (a multiple of 16), w
// in the per-block layout (ceil(Cout / 32), 27 * Cin, 32) bf16 with zero rows
// at the pad slots; tm is 256 or 128.
extern "C" int conv3d_cs_packed_launch(const void* xp, const void* w,
                                       const void* bias, void* out, void* stats,
                                       int B, int D, int Cin, int Cout, int H,
                                       int W, int tm, void* stream) {
  const PackedArgs p = make_packed_args(xp, w, bias, out, stats, B, D, Cin, Cout, H, W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm == 256) return launch_packed<256>(p, s);
  if (tm == 128) return launch_packed<128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide instance of the packed conv, for planes of any width: the same xp
// (its tail of 257 voxels), Cin and w; 256-row tiles, tiles_per_block of them
// a block, so ceil(H * (W + 2) / 256 / tiles_per_block) groups a plane.
// With stats, partials is scratch of (B * D, groups, 2, Cout) f32, which the
// second pass sums into stats in group order.
extern "C" int conv3d_cs_packed_wide_launch(const void* xp, const void* w, const void* bias,
                                            void* out, void* stats, void* partials, int B,
                                            int D, int Cin, int Cout, int H, int W,
                                            int tiles_per_block, void* stream) {
  const long long tiles = (long long)((H + WIDE_ROWS - 1) / WIDE_ROWS) *
                          ((W + WIDE_COLS - 1) / WIDE_COLS);
  if (Cin % PCC != 0 || tiles_per_block < 1 || (stats != nullptr) != (partials != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = (tiles + tiles_per_block - 1) / tiles_per_block;
  const long long planes = (long long)B * D;
  if (groups > 65535 || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  PackedArgs p = make_packed_args(xp, w, bias, out, partials, B, D, Cin, Cout, H, W);
  p.tiles_per_block = tiles_per_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(conv3d_cs_packed_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(WIDE_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Cout + TN - 1) / TN, (unsigned)groups, (unsigned)planes);
  conv3d_cs_packed_wide_kernel<<<grid, WIDE_TM, WIDE_SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return static_cast<int>(err);
  const long long n = planes * 2 * Cout;
  conv3d_cs_stats_sum_kernel<<<(unsigned)((n + STATS_THREADS - 1) / STATS_THREADS),
                               STATS_THREADS, 0, s>>>(static_cast<const float*>(partials),
                                                      static_cast<float*>(stats), (int)planes,
                                                      (int)groups, Cout);
  return static_cast<int>(cudaGetLastError());
}

// The direct conv, C_in = 1: x (B, D, 1, H*W) bf16, W and Cout multiples of
// 8, w (27, Cout) bf16, aff_a and aff_c (B, 1) or null; a block stages rb
// rows of output (their planes' rows and halo) at a time, with 16-byte
// loads where x is 16-byte aligned, else one voxel a load.
extern "C" int conv3d_cs_direct_launch(const void* x, const void* w, const void* bias,
                                       const void* aff_a, const void* aff_c, void* out,
                                       void* stats, int B, int D, int Cout, int H, int W,
                                       int rb, void* stream) {
  if (W % DV != 0 || Cout % DC != 0 || rb < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args p = make_args(x, nullptr, nullptr, aff_a, aff_c, B, D, 1, 0, H, W);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats = static_cast<float*>(stats);
  p.Cout = Cout;
  const size_t smem = (size_t)direct_smem_floats(rb, W) * 4;
  cudaError_t err = cudaFuncSetAttribute(conv3d_cs_direct_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Cout + TN - 1) / TN, D, B);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  conv3d_cs_direct_kernel<<<grid, DIRECT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, rb, vec);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks an SM of the kernel that takes a
// plane of width W: the packed kernel with tm rows (256 or 128), its wide
// instance (tm 3), the direct kernel with bands of rb rows (tm 1), or the
// narrow kernel on C input channels with bands of rb rows (tm 2), as the card
// reports them.
extern "C" int conv3d_cs_resources(int tm, int rb, int W, int C, int* regs,
                                   int* blocks_per_sm) {
  const void* fn;
  int threads;
  size_t smem;
  if (tm == 2) {
    fn = reinterpret_cast<const void*>(conv3d_cs_narrow_kernel);
    threads = NARROW_THREADS;
    smem = narrow_smem_bytes(narrow_ce(C), rb, W);
  } else if (tm == 1) {
    fn = reinterpret_cast<const void*>(conv3d_cs_direct_kernel);
    threads = DIRECT_THREADS;
    smem = (size_t)direct_smem_floats(rb, W) * 4;
  } else if (tm == 3) {
    fn = reinterpret_cast<const void*>(conv3d_cs_packed_wide_kernel);
    threads = WIDE_TM;
    smem = WIDE_SMEM;
  } else if (tm == 256 || tm == 128) {
    fn = tm == 256 ? reinterpret_cast<const void*>(conv3d_cs_packed_kernel<256>)
                   : reinterpret_cast<const void*>(conv3d_cs_packed_kernel<128>);
    threads = tm;
    smem = (size_t)STAGES * packed_stage_elems(tm, W) * 2;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem));
}

// The narrow conv on (B, D, C, H*W) itself, C1 + C2 <= 16: w from
// narrow_weights in ops/conv3d_cs.py, (ceil(Cout / 8) * 8, kp) bf16, row n
// holding K = tap * ce + ci (zero rows past C_out, zero columns for the pad
// channel of an odd C and past 27 * ce); bands of rb output rows. 16-byte
// loads where W % 8 == 0 and x1, x2 are 16-byte aligned, 16-byte stores where
// H*W and rb*W are multiples of 8.
extern "C" int conv3d_cs_narrow_launch(const void* x1, const void* x2,
                                       const void* pair_bias, const void* w,
                                       const void* bias, const void* aff_a,
                                       const void* aff_c, void* out, void* stats,
                                       int B, int D, int C1, int C2, int Cout, int H,
                                       int W, int rb, void* stream) {
  if (C1 + C2 < 1 || C1 + C2 > NARROW_MAX_C || rb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p = make_args(x1, x2, pair_bias, aff_a, aff_c, B, D, C1, C2, H, W);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats = static_cast<float*>(stats);
  p.Cout = Cout;
  const size_t smem = narrow_smem_bytes(narrow_ce(C1 + C2), rb, W);
  cudaError_t err = cudaFuncSetAttribute(conv3d_cs_narrow_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_in = W % 8 == 0 && reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  const int vec_out = (H * W) % 8 == 0 && (rb * W) % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(D, B);
  conv3d_cs_narrow_kernel<<<grid, NARROW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, rb, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
