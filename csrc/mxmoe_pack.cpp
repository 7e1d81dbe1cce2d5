// Native host-side quantize/pack kernels for checkpoint conversion.
//
// Counterpart of the reference's host pack pipeline
// (mxmoe/kernels/src/include/quantize.cuh:289-475: compose_perm_indices /
// permute_weight / pack_weightonly / pack_wxax). The Triton kernel and XLA
// pick their own tile layouts, so there is no ldmatrix layout to permute
// for, and packing is (a) RTN integer codes and
// (b) nibble-packing for 4-bit storage — but converting a multi-GB MoE
// checkpoint one expert at a time in Python is loader-bound, so the hot
// loops live here, threaded across output channels.
//
// Build: python -m mxmoe.native.build   (g++ -O3 -shared -fPIC)
// ABI: plain C, consumed via ctypes (mxmoe/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// Run fn(begin, end) over [0, total) split across threads.
template <typename F>
void parallel_for(int64_t total, F fn) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(total, 1));
  if (nt <= 1) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (total + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min<int64_t>(b + chunk, total);
    if (b >= e) break;
    ts.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// RTN quantization of row-major weights [rows, k], groups of `gsize` along
// k (gsize == -1 -> one group per row). Symmetric: codes in
// [-(2^(b-1)-1), 2^(b-1)-1], zp = 0. Asymmetric: recentred signed codes
// with zp' = zp + 2^(b-1)*scale (packing.py convention). Outputs:
//   codes  [rows, k] int8
//   scales [rows, k/g] float32
//   zps    [rows, k/g] float32
void mxmoe_rtn_quant(const float* w, int64_t rows, int64_t k, int gsize,
                     int bits, int sym, int8_t* codes, float* scales,
                     float* zps) {
  const int64_t g = gsize <= 0 ? k : gsize;
  const int64_t ng = k / g;
  const float upper_s = static_cast<float>((1 << (bits - 1)) - 1);
  const float upper_a = static_cast<float>((1 << bits) - 1);
  const float shift = static_cast<float>(1 << (bits - 1));

  parallel_for(rows, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const float* row = w + r * k;
      for (int64_t gi = 0; gi < ng; ++gi) {
        const float* seg = row + gi * g;
        float s, zp;
        if (sym) {
          float amax = 0.f;
          for (int64_t i = 0; i < g; ++i) amax = std::max(amax, std::fabs(seg[i]));
          s = amax / upper_s;
          zp = 0.f;
        } else {
          float mn = seg[0], mx = seg[0];
          for (int64_t i = 1; i < g; ++i) {
            mn = std::min(mn, seg[i]);
            mx = std::max(mx, seg[i]);
          }
          s = (mx - mn) / upper_a;
          zp = mn;
        }
        float inv = s == 0.f ? 0.f : 1.f / s;
        int8_t* crow = codes + r * k + gi * g;
        if (sym) {
          for (int64_t i = 0; i < g; ++i) {
            float q = std::nearbyint(seg[i] * inv);
            q = std::max(-upper_s, std::min(upper_s, q));
            crow[i] = static_cast<int8_t>(q);
          }
        } else {
          for (int64_t i = 0; i < g; ++i) {
            float q = std::nearbyint((seg[i] - zp) * inv);
            q = std::max(0.f, std::min(upper_a, q));
            crow[i] = static_cast<int8_t>(q - shift);  // recentre to signed
          }
          zp += shift * s;
        }
        scales[r * ng + gi] = s;
        zps[r * ng + gi] = zp;
      }
    }
  });
}

// Nibble-pack signed int4 codes [k, n] -> [k/2, n]; low nibble = even k
// (packing.py::pack_int4_rows layout). k must be even.
void mxmoe_pack_int4(const int8_t* codes, int64_t k, int64_t n, int8_t* out) {
  parallel_for(k / 2, [&](int64_t j0, int64_t j1) {
    for (int64_t j = j0; j < j1; ++j) {
      const int8_t* lo = codes + (2 * j) * n;
      const int8_t* hi = codes + (2 * j + 1) * n;
      int8_t* dst = out + j * n;
      for (int64_t c = 0; c < n; ++c) {
        dst[c] = static_cast<int8_t>((lo[c] & 0xF) | ((hi[c] & 0xF) << 4));
      }
    }
  });
}

// Transpose [rows, cols] float32 (HF [out,in] -> kernel [in,out]) blocked
// and threaded; used by the checkpoint converter.
void mxmoe_transpose_f32(const float* src, int64_t rows, int64_t cols,
                         float* dst) {
  constexpr int64_t B = 64;
  int64_t rb = (rows + B - 1) / B;
  parallel_for(rb, [&](int64_t b0, int64_t b1) {
    for (int64_t bi = b0; bi < b1; ++bi) {
      int64_t r0 = bi * B, r1 = std::min(rows, r0 + B);
      for (int64_t c0 = 0; c0 < cols; c0 += B) {
        int64_t c1 = std::min(cols, c0 + B);
        for (int64_t r = r0; r < r1; ++r)
          for (int64_t c = c0; c < c1; ++c) dst[c * rows + r] = src[r * cols + c];
      }
    }
  });
}

// bf16 (uint16 bit pattern) -> float32, threaded. Checkpoint shards are
// bf16; numpy lacks native bf16.
void mxmoe_bf16_to_f32(const uint16_t* src, int64_t count, float* dst) {
  parallel_for(count, [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
      std::memcpy(dst + i, &bits, 4);
    }
  });
}

}  // extern "C"
