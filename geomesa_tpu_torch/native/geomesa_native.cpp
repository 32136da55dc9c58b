// Native host-side range decomposition for geomesa_tpu_torch.
//
// The planner's hot host loops, in C++: z-order range decomposition (the
// role the reference delegates to the external sfcurve library,
// geomesa-z3/pom.xml:16-17, called from curve/Z2SFC.scala:52 and
// curve/Z3SFC.scala:61) and the XZ quad/octree sweeps
// (curve/XZ2SFC.scala:146-252, XZ3SFC analog).
//
// Semantics are bit-for-bit identical to the numpy sweeps in
// geomesa_tpu_torch/curve/{ranges,xz2,xz3}.py: the same level-synchronous
// frontier sweep, the same emit order, the same budget arithmetic, the
// same IEEE-754 double comparisons — so the numpy path and the native
// path are interchangeable and differential-tested for equality.
//
// Exported C ABI (see geomesa_tpu_torch/native/__init__.py for the ctypes
// binding):
//   gm_zranges    — Z2/Z3 morton-range decomposition (quad/octree).
//   gm_xz_ranges  — XZ2/XZ3 sequence-code range decomposition.
// Both return the number of merged [lo, hi] pairs written to `out`, or a
// negative required-capacity if `cap` pairs were insufficient.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <vector>

namespace {

struct Range {
  int64_t lo;
  int64_t hi;
};

// Sort + merge overlapping/adjacent inclusive ranges, in place semantics of
// curve/ranges.py merge_ranges().
int64_t merge_and_emit(std::vector<Range>& ranges, int64_t* out, int64_t cap) {
  if (ranges.empty()) return 0;
  std::sort(ranges.begin(), ranges.end(),
            [](const Range& a, const Range& b) { return a.lo < b.lo; });
  std::vector<Range> merged;
  merged.reserve(ranges.size());
  Range cur = ranges[0];
  for (size_t i = 1; i < ranges.size(); ++i) {
    const Range& r = ranges[i];
    if (r.lo > cur.hi + 1) {
      merged.push_back(cur);
      cur = r;
    } else if (r.hi > cur.hi) {
      cur.hi = r.hi;
    }
  }
  merged.push_back(cur);
  int64_t n = static_cast<int64_t>(merged.size());
  if (n > cap) return -n;
  for (int64_t i = 0; i < n; ++i) {
    out[2 * i] = merged[i].lo;
    out[2 * i + 1] = merged[i].hi;
  }
  return n;
}

// De-interleave one dimension of a d-dim morton code: bits at positions
// dim, dim+d, dim+2d, ...
inline uint64_t extract_dim(uint64_t z, int dim, int dims, int bits) {
  uint64_t v = 0;
  for (int b = 0; b < bits; ++b) {
    v |= ((z >> (b * dims + dim)) & 1ULL) << b;
  }
  return v;
}

}  // namespace

extern "C" {

// Z2/Z3 morton-range decomposition (curve/ranges.py zranges()).
//
// mins/maxs: n_boxes * dims int64 inclusive normalized-int bounds,
// box-major ([b0d0, b0d1, ..., b1d0, ...]). Emits merged covering ranges.
int64_t gm_zranges(const int64_t* mins, const int64_t* maxs, int64_t n_boxes,
                   int32_t dims, int32_t bits, int64_t budget,
                   int32_t depth_cap, int64_t* out, int64_t cap) {
  if (dims != 2 && dims != 3) return -1;
  if (n_boxes <= 0) return 0;
  const int fanout = 1 << dims;
  if (depth_cap > bits) depth_cap = bits;

  // Frontier cells carry the z of their min corner; coordinates are
  // recovered by de-interleaving exactly as the numpy sweep does.
  std::vector<uint64_t> frontier(1, 0);
  std::vector<uint64_t> next;
  std::vector<Range> emitted_ranges;
  int64_t emitted = 0;

  for (int level = 0; level <= depth_cap; ++level) {
    if (frontier.empty()) break;
    const uint64_t side = 1ULL << (bits - level);
    const uint64_t zsize = 1ULL << (static_cast<uint64_t>(dims) * (bits - level));
    const bool bottom = (level == depth_cap);

    next.clear();
    std::vector<uint64_t> rest;
    for (uint64_t z : frontier) {
      uint64_t cmin[3], cmax[3];
      for (int d = 0; d < dims; ++d) {
        cmin[d] = extract_dim(z, d, dims, bits);
        cmax[d] = cmin[d] + (side - 1);
      }
      bool contained = false, overlaps = false;
      for (int64_t b = 0; b < n_boxes && !(contained && overlaps); ++b) {
        bool c = true, o = true;
        for (int d = 0; d < dims; ++d) {
          const uint64_t bmin = static_cast<uint64_t>(mins[b * dims + d]);
          const uint64_t bmax = static_cast<uint64_t>(maxs[b * dims + d]);
          c = c && (cmin[d] >= bmin) && (cmax[d] <= bmax);
          o = o && (cmin[d] <= bmax) && (cmax[d] >= bmin);
        }
        contained = contained || c;
        overlaps = overlaps || o;
      }
      if (bottom) contained = overlaps;
      if (contained) {
        emitted_ranges.push_back(
            {static_cast<int64_t>(z), static_cast<int64_t>(z + (zsize - 1))});
        ++emitted;
      } else if (overlaps) {
        rest.push_back(z);
      }
    }
    if (rest.empty()) break;
    if (emitted + static_cast<int64_t>(rest.size()) * fanout > budget) {
      // Budget exhausted: remaining frontier becomes covering ranges.
      for (uint64_t z : rest) {
        emitted_ranges.push_back(
            {static_cast<int64_t>(z), static_cast<int64_t>(z + (zsize - 1))});
      }
      break;
    }
    const uint64_t child_zsize =
        1ULL << (static_cast<uint64_t>(dims) * (bits - level - 1));
    for (uint64_t z : rest) {
      for (int q = 0; q < fanout; ++q) {
        next.push_back(z + static_cast<uint64_t>(q) * child_zsize);
      }
    }
    frontier.swap(next);
  }
  return merge_and_emit(emitted_ranges, out, cap);
}

// XZ2/XZ3 sequence-code range decomposition (curve/xz2.py / xz3.py
// ranges()).  Windows are pre-normalized [0,1] doubles, window-major
// (dims mins then dims maxs per window is split: wmins / wmaxs arrays).
// iv[i] = (fanout^(g-i) - 1) / (fanout - 1) subtree sizes are recomputed
// here (g <= 30 for dims=2, <= 20 for dims=3 keeps codes in int64).
int64_t gm_xz_ranges(const double* wmins, const double* wmaxs,
                     int64_t n_windows, int32_t dims, int32_t g,
                     int64_t budget, int64_t* out, int64_t cap) {
  if (dims != 2 && dims != 3) return -1;
  if (n_windows <= 0) return 0;
  const int fanout = 1 << dims;

  std::vector<int64_t> iv(g + 1);
  for (int i = 0; i <= g; ++i) {
    // (fanout^(g-i) - 1) / (fanout - 1)
    int64_t v = 0;
    for (int p = 0; p < g - i; ++p) v = v * fanout + 1;
    iv[i] = v;
  }

  struct Cell {
    int64_t k[3];  // integer cell coords at the current level
    int64_t cs;    // sequence code of the cell
  };
  std::vector<Cell> frontier(1);
  frontier[0] = {{0, 0, 0}, 0};
  std::vector<Cell> rest;
  std::vector<Range> emitted_ranges;
  int64_t emitted = 0;

  for (int level = 1; level <= g; ++level) {
    if (frontier.empty()) break;
    const double w = std::pow(0.5, level);
    rest.clear();
    for (const Cell& parent : frontier) {
      for (int q = 0; q < fanout; ++q) {
        Cell c;
        c.k[0] = (parent.k[0] << 1) + (q & 1);
        c.k[1] = (parent.k[1] << 1) + ((q >> 1) & 1);
        c.k[2] = dims == 3 ? (parent.k[2] << 1) + (q >> 2) : 0;
        c.cs = parent.cs + 1 + static_cast<int64_t>(q) * iv[level - 1];

        double lo[3], ext[3];
        for (int d = 0; d < dims; ++d) {
          lo[d] = static_cast<double>(c.k[d]) * w;
          ext[d] = lo[d] + 2.0 * w;  // extended footprint
        }
        bool contained = false, overlaps = false;
        for (int64_t b = 0; b < n_windows && !(contained && overlaps); ++b) {
          bool cn = true, ov = true;
          for (int d = 0; d < dims; ++d) {
            const double wmin = wmins[b * dims + d];
            const double wmax = wmaxs[b * dims + d];
            cn = cn && (wmin <= lo[d]) && (wmax >= ext[d]);
            ov = ov && (wmax >= lo[d]) && (wmin <= ext[d]);
          }
          contained = contained || cn;
          overlaps = overlaps || ov;
        }
        if (contained) {
          emitted_ranges.push_back({c.cs, c.cs + iv[level - 1]});
          ++emitted;
        } else if (overlaps) {
          rest.push_back(c);
        }
      }
    }
    if (rest.empty()) break;
    if (level == g ||
        emitted + static_cast<int64_t>(rest.size()) * fanout > budget) {
      // Bottom out: cover each remaining cell's whole subtree.
      for (const Cell& c : rest) {
        emitted_ranges.push_back({c.cs, c.cs + iv[level - 1]});
      }
      break;
    }
    // Partial matches emit their own code (large objects stored at this
    // cell) and descend.
    for (const Cell& c : rest) {
      emitted_ranges.push_back({c.cs, c.cs});
      ++emitted;
    }
    frontier.swap(rest);
  }
  return merge_and_emit(emitted_ranges, out, cap);
}

}  // extern "C"
