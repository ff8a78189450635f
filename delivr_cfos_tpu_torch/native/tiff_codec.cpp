// Native TIFF strip codecs: LZW and PackBits decode.
//
// Stage 1 ingests hundreds of GB of microscope TIFFs (reference:
// downsample/downsample_and_mask.py reads every raw z-plane twice); the
// from-scratch Python LZW decoder in utils/io/tiff.py is correct but
// byte-at-a-time. This is the same TIFF-flavor LZW (MSB-first bit packing,
// early code-width change) with a (prefix, suffix, length) chain table and
// backwards emission — no per-code allocations.
//
// Plain C ABI consumed via ctypes (delivr_cfos_tpu/native/tiff.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kMaxCodes = 1 << 12;  // TIFF LZW caps at 12-bit codes

struct Entry {
  int32_t prefix;   // previous code in the chain, -1 for literals
  uint8_t suffix;   // last byte of this entry
  uint8_t first;    // first byte of the full string
  int32_t length;   // total string length
};

}  // namespace

extern "C" {

// Decode TIFF LZW. Returns bytes written, -1 if dst overflows, -2 on a
// malformed stream (reference semantics: stop quietly at EOI or when the
// bitstream runs out, like utils/io/tiff.py:_lzw_decode).
int64_t tiff_lzw_decode(const uint8_t* src, int64_t src_len, uint8_t* dst,
                        int64_t dst_cap) {
  static thread_local Entry table[kMaxCodes];
  for (int i = 0; i < 256; ++i) {
    table[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
  }
  int table_size = 258;
  int nbits = 9;
  int64_t bitpos = 0;
  const int64_t total_bits = src_len * 8;
  int64_t out = 0;
  int32_t prev = -1;

  while (bitpos + nbits <= total_bits) {
    const int64_t byte_idx = bitpos >> 3;
    uint32_t chunk;
    if (byte_idx + 4 <= src_len) {
      std::memcpy(&chunk, src + byte_idx, 4);  // unaligned load
      chunk = __builtin_bswap32(chunk);        // MSB-first bit order
    } else {
      chunk = 0;
      for (int k = 0; k < 4; ++k) {
        chunk = (chunk << 8) |
                (byte_idx + k < src_len ? src[byte_idx + k] : 0);
      }
    }
    const int code =
        (chunk >> (32 - (bitpos & 7) - nbits)) & ((1u << nbits) - 1);
    bitpos += nbits;

    if (code == kEoi) break;
    if (code == kClear) {
      table_size = 258;
      nbits = 9;
      prev = -1;
      continue;
    }

    int emit_code;
    if (prev < 0) {
      if (code >= table_size) return -2;
      emit_code = code;
    } else if (code < table_size) {
      emit_code = code;
      if (table_size < kMaxCodes) {
        table[table_size++] = {prev, table[code].first, table[prev].first,
                               table[prev].length + 1};
      }
    } else if (code == table_size) {
      // KwKwK case: entry = prev + first(prev)
      if (table_size >= kMaxCodes) return -2;
      table[table_size++] = {prev, table[prev].first, table[prev].first,
                             table[prev].length + 1};
      emit_code = code;
    } else {
      return -2;
    }

    const int32_t len = table[emit_code].length;
    if (out + len > dst_cap) return -1;
    // walk the chain backwards into place
    int64_t pos = out + len;
    for (int32_t c = emit_code; c >= 0; c = table[c].prefix) {
      dst[--pos] = table[c].suffix;
    }
    out += len;
    prev = emit_code;

    // TIFF early change: bump width one code earlier than generic LZW
    if (table_size + 1 >= (1 << nbits) && nbits < 12) ++nbits;
  }
  return out;
}

// Decode ALL strips of a page in one call, multi-threaded (one ctypes
// round-trip per page instead of per strip — per-strip Python overhead
// measured ~0.4 ms against ~µs of actual decode for common 2-row strips).
// kind: 5 = LZW, 32773 = PackBits. Each strip i reads src[src_offs[i],
// +src_lens[i]) and writes dst[dst_offs[i], +dst_caps[i]).
// Returns 0 on success, 1 + index of the first failing strip otherwise.
int64_t tiff_packbits_decode(const uint8_t*, int64_t, uint8_t*, int64_t);

int64_t tiff_decode_strips(const uint8_t* src, const int64_t* src_offs,
                           const int64_t* src_lens, int64_t n_strips,
                           uint8_t* dst, const int64_t* dst_offs,
                           const int64_t* dst_caps, int64_t kind,
                           int64_t n_threads);

// PackBits decode. Returns bytes written, -1 if dst overflows.
int64_t tiff_packbits_decode(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_cap) {
  int64_t i = 0, out = 0;
  while (i < src_len) {
    const uint8_t h = src[i++];
    if (h < 128) {
      const int64_t n = (int64_t)h + 1;
      if (i + n > src_len || out + n > dst_cap) return -1;
      std::memcpy(dst + out, src + i, n);
      i += n;
      out += n;
    } else if (h > 128) {
      const int64_t n = 257 - (int64_t)h;
      if (i >= src_len || out + n > dst_cap) return -1;
      std::memset(dst + out, src[i++], n);
      out += n;
    }
    // 128 = no-op
  }
  return out;
}

int64_t tiff_decode_strips(const uint8_t* src, const int64_t* src_offs,
                           const int64_t* src_lens, int64_t n_strips,
                           uint8_t* dst, const int64_t* dst_offs,
                           const int64_t* dst_caps, int64_t kind,
                           int64_t n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(-1);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_strips || failed.load() >= 0) return;
      const uint8_t* s = src + src_offs[i];
      uint8_t* d = dst + dst_offs[i];
      const int64_t n =
          kind == 5 ? tiff_lzw_decode(s, src_lens[i], d, dst_caps[i])
                    : tiff_packbits_decode(s, src_lens[i], d, dst_caps[i]);
      // dst_caps is the exact expected byte count (short last strips get a
      // reduced cap upstream), so a short decode means a truncated/corrupt
      // stream: fail the page so the caller falls back to the Python
      // decoder, which raises loudly instead of yielding black rows.
      if (n != dst_caps[i]) {
        failed.store(i);
        return;
      }
    }
  };
  int64_t nt = n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads);
  if (nt > n_strips) nt = n_strips;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int64_t t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  const int64_t f = failed.load();
  return f >= 0 ? 1 + f : 0;
}

}  // extern "C"
