// 3D 26-connected connected-component labeling (union-find, two-pass).
//
// Native replacement for the cc3d C++ extension the reference depends on
// (reference: count_blobs.py:61-64). Exposed as a plain C ABI consumed via
// ctypes — no Python headers needed, builds with a bare `g++ -O3 -shared`.
// The port's copy of delivr_cfos_tpu/native/cc_label.cpp (same code).
//
// Labeling convention matches cc3d/scipy.ndimage.label: background = 0,
// components numbered 1..N in raster order of first encounter.
//
// Also exports a per-component statistics pass (voxel counts, centroid sums,
// bounding boxes) so Python can avoid a second full sweep in numpy.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;

  int64_t make() {
    int64_t id = static_cast<int64_t>(parent.size());
    parent.push_back(id);
    return id;
  }

  int64_t find(int64_t a) {
    int64_t root = a;
    while (parent[root] != root) root = parent[root];
    while (parent[a] != root) {
      int64_t next = parent[a];
      parent[a] = root;
      a = next;
    }
    return root;
  }

  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (rb < ra) std::swap(ra, rb);
    parent[rb] = ra;  // smaller (earlier) root wins → raster-order stability
  }
};

}  // namespace

extern "C" {

// Labels `vol` (Z*Y*X uint8, C-order) into `out` (int32). Returns the number
// of components, or -1 if the provisional label space overflows int32.
int64_t cc_label_u8(const uint8_t* vol, int64_t Z, int64_t Y, int64_t X,
                    int32_t* out) {
  const int64_t YX = Y * X;
  const int64_t n = Z * YX;
  std::vector<int32_t> prov(n, 0);  // provisional labels, 0 = background
  UnionFind uf;
  uf.make();  // id 0 reserved for background

  // Prior-neighbor deltas for 26-connectivity (half-neighborhood already
  // visited in raster order): 13 (dz, dy, dx) triples.
  struct Delta { int dz, dy, dx; };
  Delta deltas[13];
  int n_deltas = 0;
  for (int dz = -1; dz <= 0; ++dz)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && (dy > 0 || (dy == 0 && dx >= 0))) continue;
        deltas[n_deltas++] = {dz, dy, dx};
      }

  for (int64_t z = 0; z < Z; ++z) {
    for (int64_t y = 0; y < Y; ++y) {
      const int64_t row = z * YX + y * X;
      for (int64_t x = 0; x < X; ++x) {
        const int64_t i = row + x;
        if (!vol[i]) continue;
        int32_t best = 0;
        int32_t found[13];
        int n_found = 0;
        for (int k = 0; k < 13; ++k) {
          const int64_t nz = z + deltas[k].dz;
          const int64_t ny = y + deltas[k].dy;
          const int64_t nx = x + deltas[k].dx;
          if (nz < 0 || ny < 0 || ny >= Y || nx < 0 || nx >= X) continue;
          const int32_t p = prov[nz * YX + ny * X + nx];
          if (p) found[n_found++] = p;
        }
        if (n_found == 0) {
          int64_t id = uf.make();
          if (id > INT32_MAX) return -1;
          prov[i] = static_cast<int32_t>(id);
        } else {
          best = found[0];
          for (int k = 1; k < n_found; ++k)
            if (found[k] < best) best = found[k];
          prov[i] = best;
          for (int k = 0; k < n_found; ++k) uf.unite(best, found[k]);
        }
      }
    }
  }

  // Second pass: renumber roots in raster order of first encounter.
  std::vector<int32_t> final_label(uf.parent.size(), 0);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t p = prov[i];
    if (!p) {
      out[i] = 0;
      continue;
    }
    const int64_t r = uf.find(p);
    if (!final_label[r]) final_label[r] = ++next;
    out[i] = final_label[r];
  }
  return next;
}

// Per-component statistics over an int32 label volume with labels 0..n.
// counts: (n+1) int64; centroid_sums: (n+1)*3 double (z, y, x sums);
// bbox: (n+1)*6 int64 as (zmin, zmax, ymin, ymax, xmin, xmax) inclusive.
// bbox rows for absent labels are zeroed.
void cc_statistics_i32(const int32_t* labels, int64_t Z, int64_t Y, int64_t X,
                       int64_t n, int64_t* counts, double* centroid_sums,
                       int64_t* bbox) {
  const int64_t n1 = n + 1;
  std::memset(counts, 0, sizeof(int64_t) * n1);
  std::memset(centroid_sums, 0, sizeof(double) * n1 * 3);
  for (int64_t l = 0; l < n1; ++l) {
    bbox[l * 6 + 0] = INT64_MAX;
    bbox[l * 6 + 1] = -1;
    bbox[l * 6 + 2] = INT64_MAX;
    bbox[l * 6 + 3] = -1;
    bbox[l * 6 + 4] = INT64_MAX;
    bbox[l * 6 + 5] = -1;
  }
  int64_t i = 0;
  for (int64_t z = 0; z < Z; ++z)
    for (int64_t y = 0; y < Y; ++y)
      for (int64_t x = 0; x < X; ++x, ++i) {
        const int32_t l = labels[i];
        if (l < 0 || l > n) continue;
        counts[l]++;
        centroid_sums[l * 3 + 0] += static_cast<double>(z);
        centroid_sums[l * 3 + 1] += static_cast<double>(y);
        centroid_sums[l * 3 + 2] += static_cast<double>(x);
        int64_t* bb = bbox + l * 6;
        if (z < bb[0]) bb[0] = z;
        if (z > bb[1]) bb[1] = z;
        if (y < bb[2]) bb[2] = y;
        if (y > bb[3]) bb[3] = y;
        if (x < bb[4]) bb[4] = x;
        if (x > bb[5]) bb[5] = x;
      }
  for (int64_t l = 0; l < n1; ++l)
    if (counts[l] == 0) std::memset(bbox + l * 6, 0, sizeof(int64_t) * 6);
}

}  // extern "C"
