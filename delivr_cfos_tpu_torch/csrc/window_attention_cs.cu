// SwinUNETR's shifted-window multi-head attention in one pass, for sm_90a.
//
// The port's form of MONAI's WindowAttention at head dim 16 (SwinUNETR at
// feature size 48 with heads (3, 6, 12, 24)), over windows of up to 7^3 =
// 343 tokens:
//   qkv   (B_, n, 3C) bf16 contiguous, the qkv Linear's output in window
//         order: q of head h at columns [h*16, h*16 + 16), k at C + that,
//         v at 2C + that; B_ = samples * nW windows
//   bias  (heads, n, n) f32, key-major: bias[h][j][i] is the relative-
//         position bias of query i against key j
//   out   (B_, n, C) bf16: out[w][i][h*16 + d] = sum_j p_ij v_jd with
//         p_i = softmax_j(scale * q_i . k_j + bias[h][j][i] + mask_ij)
//   mask  in shifted windows, -100 between tokens of different regions of
//         the padded, rolled grid (MONAI's compute_mask): per shifted axis a
//         position p of padded size P lies in region 0 below P - ws, 1 below
//         P - shift, 2 above; an axis of shift 0 has one region. Each
//         token's region comes from its window's place in the sample's grid
//         and its place in the window: no (nW, n, n) mask is in memory.
// Scores, the softmax and the sums are f32; the scores never leave the chip.
//
// Design: one block per (window, head), one thread per query token (n <= 343
// threads, rounded up to whole warps). The block stages its window's keys
// and values in shared memory as f32 (2 * 343 * 16 * 4 = 43,904 bytes) and
// each key's region, then every thread walks all keys in chunks of CHUNK:
// the chunk's scores in registers, one rescale of the running sum and of the
// 16 accumulators a chunk (the online softmax of FlashAttention), then the
// chunk's exponentials times the values. A key's k and v are read from
// shared memory as broadcasts (every thread reads the same address); the
// bias, read at [h][j][i], is coalesced over the queries of a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 16;        // head dim
constexpr int MAX_N = 343;    // tokens a window, at most
constexpr int MAX_THREADS = 352;  // MAX_N rounded up to warps
constexpr int CHUNK = 16;     // keys a step of the online softmax
constexpr float MASK_VALUE = -100.0f;

struct Geometry {
  int n;        // tokens a window
  int heads;
  int c;        // channels: heads * HD
  int nw;       // windows a sample
  int ws[3];    // window per axis (z, y, x)
  int grid[3];  // windows per axis
  int padded[3];
  int shift[3];
  int masked;   // any shift
  float scale;
};

__device__ __forceinline__ int axis_region(int p, int P, int ws, int s) {
  if (s == 0) return 0;
  return p < P - ws ? 0 : (p < P - s ? 1 : 2);
}

// the region of token t of window w (the window's index over all samples)
__device__ __forceinline__ int region(int w, int t, const Geometry& g) {
  const int wl = w % g.nw;
  const int gx = wl % g.grid[2];
  const int gy = (wl / g.grid[2]) % g.grid[1];
  const int gz = wl / (g.grid[2] * g.grid[1]);
  const int tx = t % g.ws[2];
  const int ty = (t / g.ws[2]) % g.ws[1];
  const int tz = t / (g.ws[2] * g.ws[1]);
  return axis_region(gz * g.ws[0] + tz, g.padded[0], g.ws[0], g.shift[0]) * 9 +
         axis_region(gy * g.ws[1] + ty, g.padded[1], g.ws[1], g.shift[1]) * 3 +
         axis_region(gx * g.ws[2] + tx, g.padded[2], g.ws[2], g.shift[2]);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = __ldg(v + h);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[8 * h + 2 * k] = __uint_as_float(w[k] << 16);
      f[8 * h + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__global__ void __launch_bounds__(MAX_THREADS)
    window_attention_cs_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               __nv_bfloat16* __restrict__ out, Geometry g) {
  __shared__ __align__(16) float ks[MAX_N * HD];
  __shared__ __align__(16) float vs[MAX_N * HD];
  __shared__ int8_t kreg[MAX_N];

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int i = threadIdx.x;
  const int n = g.n;
  const long long row = 3LL * g.c;
  const __nv_bfloat16* base = qkv + static_cast<long long>(w) * n * row + h * HD;

  float q[HD];
  int myreg = 0;
  if (i < n) {
    const __nv_bfloat16* tok = base + static_cast<long long>(i) * row;
    float kv[HD];
    load16(tok + g.c, kv);
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(ks + i * HD + d) =
          make_float4(kv[d], kv[d + 1], kv[d + 2], kv[d + 3]);
    load16(tok + 2 * g.c, kv);
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(vs + i * HD + d) =
          make_float4(kv[d], kv[d + 1], kv[d + 2], kv[d + 3]);
    load16(tok, q);
    if (g.masked) {
      myreg = region(w, i, g);
      kreg[i] = static_cast<int8_t>(myreg);
    }
  }
  __syncthreads();
  if (i >= n) return;

  const float* b = bias + static_cast<long long>(h) * n * n + i;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int j0 = 0; j0 < n; j0 += CHUNK) {
    float s[CHUNK];
    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < CHUNK; ++jj) {
      const int j = j0 + jj;
      float sv = -INFINITY;
      if (j < n) {
        const float4* kp = reinterpret_cast<const float4*>(ks + j * HD);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 k4 = kp[d4];
          dot = fmaf(q[4 * d4], k4.x, dot);
          dot = fmaf(q[4 * d4 + 1], k4.y, dot);
          dot = fmaf(q[4 * d4 + 2], k4.z, dot);
          dot = fmaf(q[4 * d4 + 3], k4.w, dot);
        }
        sv = dot * g.scale + __ldg(b + static_cast<long long>(j) * n);
        if (g.masked && kreg[j] != myreg) sv += MASK_VALUE;
      }
      s[jj] = sv;
      cmax = fmaxf(cmax, sv);
    }
    const float m_new = fmaxf(m, cmax);
    const float corr = __expf(m - m_new);  // 0 on the first chunk
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < CHUNK; ++jj) {
      const int j = j0 + jj;
      if (j < n) {
        const float p = __expf(s[jj] - m_new);
        l += p;
        const float4* vp = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 v4 = vp[d4];
          acc[4 * d4] = fmaf(p, v4.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, v4.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, v4.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, v4.w, acc[4 * d4 + 3]);
        }
      }
    }
    m = m_new;
  }

  const float inv = 1.0f / l;
  uint4* o = reinterpret_cast<uint4*>(
      out + (static_cast<long long>(w) * n + i) * g.c + h * HD);
  o[0] = make_uint4(pack2(acc[0] * inv, acc[1] * inv), pack2(acc[2] * inv, acc[3] * inv),
                    pack2(acc[4] * inv, acc[5] * inv), pack2(acc[6] * inv, acc[7] * inv));
  o[1] = make_uint4(pack2(acc[8] * inv, acc[9] * inv), pack2(acc[10] * inv, acc[11] * inv),
                    pack2(acc[12] * inv, acc[13] * inv),
                    pack2(acc[14] * inv, acc[15] * inv));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// windows: B_ (samples * nW); ws, padded, shift: (z, y, x) each. Needs
// n = ws[0] * ws[1] * ws[2] <= 343, padded[a] a multiple of ws[a], channels
// = heads * 16, and qkv and out 16-byte aligned.
extern "C" int window_attention_cs_launch(const void* qkv, const void* bias, void* out,
                                          int windows, int heads, const int* ws,
                                          const int* padded, const int* shift, float scale,
                                          void* stream) {
  Geometry g;
  g.n = ws[0] * ws[1] * ws[2];
  g.heads = heads;
  g.c = heads * HD;
  g.masked = 0;
  g.nw = 1;
  for (int a = 0; a < 3; ++a) {
    if (ws[a] <= 0 || padded[a] <= 0 || padded[a] % ws[a] != 0 || shift[a] < 0 ||
        shift[a] >= ws[a])
      return static_cast<int>(cudaErrorInvalidValue);
    g.ws[a] = ws[a];
    g.padded[a] = padded[a];
    g.grid[a] = padded[a] / ws[a];
    g.shift[a] = shift[a];
    g.nw *= g.grid[a];
    if (shift[a] > 0) g.masked = 1;
  }
  g.scale = scale;
  if (g.n > MAX_N || heads <= 0 || windows <= 0 || windows % g.nw != 0 || heads > 65535 ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (g.n + 31) / 32 * 32;
  window_attention_cs_kernel<<<dim3(windows, heads), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
