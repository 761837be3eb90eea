// Native host-side kernels of the port's data pipeline (C ABI, loaded with
// ctypes by infgen_torch/data/native.py; the port's copy of
// native/womd_native.cc, same code).
//
// The reference gets its host-side throughput from compiled dependencies
// (scipy interp1d in the polyline splitter, TF's tfrecord reader); this
// module provides the equivalents for offline preprocessing:
//   - interpolate_polyline: 0.5 m resample + 5 m segment split of a map
//     polyline into 3-sample-point pt-token segments (the hot loop of
//     infgen_torch/tokenizers/map_tokenizer.py, mirroring reference
//     preprocess.py:58-139)
//   - tfrecord_index: scan a TFRecord file and return record offsets/lengths
//     so Python can pread records without per-record syscalls.
//
// Built at first use by infgen_torch/data/native.py with g++ -O3 -fPIC
// -shared -std=c++17 -Wall into build/libwomd_native.so; a failed
// build raises there, with the compiler's output.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Piece {
  std::vector<double> x, y, s;  // points and cumulative arclength
};

}  // namespace

extern "C" {

// Splits one raw polyline into pt-token segments.
//   pts:      [n, 2] doubles (x, y)
//   headings: [n] doubles
//   out:      caller buffer for up to max_out segments of [3, 3] floats
//             (3 sample points x (x, y, theta))
// Returns the number of segments written (<= max_out), or -1 on bad input.
int interpolate_polyline(const double* pts, const double* headings, int n,
                         double distance, double split_distance,
                         float* out, int max_out) {
  if (n < 2 || max_out <= 0) return n < 2 ? 0 : -1;

  // 1. break into continuous pieces (reference preprocess.py:60-80,
  //    including the heading[1] quirk)
  std::vector<Piece> pieces;
  pieces.emplace_back();
  pieces.back().x.push_back(pts[0]);
  pieces.back().y.push_back(pts[1]);
  pieces.back().s.push_back(0.0);
  const double h1 = n > 1 ? headings[1] : headings[0];
  for (int i = 1; i < n; ++i) {
    const double dx = pts[2 * i] - pts[2 * (i - 1)];
    const double dy = pts[2 * i + 1] - pts[2 * (i - 1) + 1];
    const double d = std::sqrt(dx * dx + dy * dy);
    const double hi = headings[i], hj = headings[i - 1];
    const double hi_max = hi > hj ? hi : hj;
    const double lo = h1 < hj ? h1 : hj;
    double diff = std::fabs(hi_max - lo);
    const double alt = std::fabs(hi_max - lo + kPi);
    if (alt < diff) diff = alt;
    const bool brk = (diff > 0.1 && d > 3.0) || d > 10.0;
    if (brk) {
      pieces.emplace_back();
      pieces.back().x.push_back(pts[2 * i]);
      pieces.back().y.push_back(pts[2 * i + 1]);
      pieces.back().s.push_back(0.0);
    } else {
      pieces.back().x.push_back(pts[2 * i]);
      pieces.back().y.push_back(pts[2 * i + 1]);
      pieces.back().s.push_back(pieces.back().s.back() + d);
    }
  }

  const int polyline_size = static_cast<int>(split_distance / distance);  // 10
  int n_out = 0;

  for (const Piece& p : pieces) {
    const int m = static_cast<int>(p.s.size());
    if (m < 2) continue;
    const double total = p.s.back();

    // 2. resample at `distance` + the final point
    std::vector<double> rs;
    for (double t = 0.0; t < total; t += distance) rs.push_back(t);
    rs.push_back(total);
    const int nn = static_cast<int>(rs.size());

    std::vector<double> nx(nn), ny(nn), nth(nn);
    int k = 0;
    for (int i = 0; i < nn; ++i) {
      const double t = rs[i];
      while (k + 1 < m - 1 && p.s[k + 1] < t) ++k;
      const double s0 = p.s[k], s1 = p.s[k + 1];
      const double w = s1 > s0 ? (t - s0) / (s1 - s0) : 0.0;
      nx[i] = p.x[k] + w * (p.x[k + 1] - p.x[k]);
      ny[i] = p.y[k] + w * (p.y[k + 1] - p.y[k]);
    }
    for (int i = 0; i < nn - 1; ++i)
      nth[i] = std::atan2(ny[i + 1] - ny[i], nx[i + 1] - nx[i]);
    nth[nn - 1] = nn >= 2 ? nth[nn - 2] : 0.0;

    // 3. window into (polyline_size+1)-point chunks, keep every 5th point
    int padding_size, final_index;
    if (nn >= polyline_size + 1) {
      padding_size = (nn - (polyline_size + 1)) % polyline_size;
      final_index = (nn - (polyline_size + 1)) / polyline_size + 1;
    } else {
      padding_size = nn;
      final_index = 0;
    }
    for (int c = 0; c < final_index && n_out < max_out; ++c, ++n_out) {
      const int st = c * polyline_size;
      for (int j = 0; j < 3; ++j) {
        const int idx = st + j * 5;
        out[(n_out * 3 + j) * 3 + 0] = static_cast<float>(nx[idx]);
        out[(n_out * 3 + j) * 3 + 1] = static_cast<float>(ny[idx]);
        out[(n_out * 3 + j) * 3 + 2] = static_cast<float>(nth[idx]);
      }
    }
    if (padding_size >= 3 && n_out < max_out) {
      const int st = final_index * polyline_size;
      const int len = nn - st;
      for (int j = 0; j < 3; ++j) {
        // torch.linspace(0, len-1, 3).long() truncates
        const int idx = st + static_cast<int>((len - 1) * j / 2.0);
        out[(n_out * 3 + j) * 3 + 0] = static_cast<float>(nx[idx]);
        out[(n_out * 3 + j) * 3 + 1] = static_cast<float>(ny[idx]);
        out[(n_out * 3 + j) * 3 + 2] = static_cast<float>(nth[idx]);
      }
      ++n_out;
    }
  }
  return n_out;
}

// Scans a TFRecord file; writes (offset, length) pairs of the record DATA
// (not headers) into `out` for up to max_records. Returns record count or
// -1 on IO error.
int64_t tfrecord_index(const char* path, int64_t* out, int64_t max_records) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0;
  uint8_t header[12];
  while (count < max_records) {
    if (std::fread(header, 1, 12, f) != 12) break;
    uint64_t len;
    std::memcpy(&len, header, 8);
    const int64_t off = std::ftell(f);
    out[2 * count] = off;
    out[2 * count + 1] = static_cast<int64_t>(len);
    if (std::fseek(f, static_cast<long>(len) + 4, SEEK_CUR) != 0) break;
    ++count;
  }
  std::fclose(f);
  return count;
}

}  // extern "C"
