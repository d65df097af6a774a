// Native host data-plane kernels for graspnet_tpu_torch: the port's copy of
// graspnet_tpu/native/src/graspnet_host.cpp, the same source, so the two
// packages' host labels are the same.
//
// These C++ kernels own the host-side hot loops that feed the card — the
// parameter-independent FPS seed chain precomputed in data workers,
// nearest-label-point assignment, the per-(label point, view) statistics
// and the visibility test of the training labels, and voxel downsampling
// of full-resolution capture clouds.  They replace the reference's CUDA
// host wrappers (pointnet2/_ext_src/src/*.cpp) in role, with identical
// numeric semantics to the numpy plain versions in
// train/label_pipeline.py and data/camera.py.
//
// Exposed via a plain C ABI for ctypes (graspnet_tpu_torch/native.py),
// built with g++ by graspnet_tpu_torch/ops/cuda/build.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Furthest point sampling, exact reference semantics
// (sampling_gpu.cu:74-178): index 0 first, skip points with squared norm
// <= 1e-3, min-distance buffer initialized to 1e10, first-index tie-break.
//
// Vectorized formulation (bit-identical selections to the scalar scan):
//   * SoA x/y/z planes so the inner loop is unit-stride vector loads;
//   * the near-origin skip becomes temp = -1 at init: squared distances are
//     >= 0, so min() keeps invalid points at -1 forever and the argmax can
//     only pick one when NO valid point exists — in which case the
//     reference's scan also leaves besti = 0;
//   * per-iteration fused pass: branchless min-update + blockwise max
//     (exact associative reductions), then the first block holding the
//     global max is re-scanned for the first attaining index — the same
//     first-index tie-break as the reference's strict `>` scan.
void gn_fps(const float* xyz, int n, int m, int* out) {
  if (m <= 0) return;
  constexpr int BLK = 4096;
  std::vector<float> xs(n), ys(n), zs(n), temp(n);
  for (int k = 0; k < n; ++k) {
    const float x = xyz[k * 3], y = xyz[k * 3 + 1], z = xyz[k * 3 + 2];
    xs[k] = x;
    ys[k] = y;
    zs[k] = z;
    temp[k] = (x * x + y * y + z * z) > 1e-3f ? 1e10f : -1.0f;
  }
  const int nblk = (n + BLK - 1) / BLK;
  std::vector<float> blockmax(nblk);
  int old = 0;
  out[0] = 0;
  for (int j = 1; j < m; ++j) {
    const float x1 = xs[old], y1 = ys[old], z1 = zs[old];
    float gmax = -2.0f;
    for (int b = 0; b < nblk; ++b) {
      const int k0 = b * BLK, k1 = k0 + BLK < n ? k0 + BLK : n;
      float bm = -2.0f;
#pragma omp simd reduction(max : bm)
      for (int k = k0; k < k1; ++k) {
        const float dx = xs[k] - x1;
        const float dy = ys[k] - y1;
        const float dz = zs[k] - z1;
        const float d = dx * dx + dy * dy + dz * dz;
        const float t = temp[k];
        const float d2 = d < t ? d : t;
        temp[k] = d2;
        bm = d2 > bm ? d2 : bm;
      }
      blockmax[b] = bm;
      gmax = bm > gmax ? bm : gmax;
    }
    int besti = 0;
    for (int b = 0; b < nblk; ++b) {
      if (blockmax[b] == gmax) {
        const int k0 = b * BLK, k1 = k0 + BLK < n ? k0 + BLK : n;
        for (int k = k0; k < k1; ++k) {
          if (temp[k] == gmax) {
            besti = k;
            break;
          }
        }
        break;
      }
    }
    old = besti;
    out[j] = besti;
  }
}

// Grid-pruned exact FPS — bit-identical selections to gn_fps, usually a
// lot faster.  Points are bucketed into a uniform grid (CSR layout, with
// an index map back to original order); per iteration, a whole cell is
// skipped when the squared distance lower bound from the newly selected
// point to the cell's bounding box is >= the cell's current max min-dist
// (then min(temp, d) == temp for every member, so neither the temps nor
// the cell max can change).  The arithmetic for updated cells is the same
// dx*dx+dy*dy+dz*dz float expression gn_fps evaluates, and the argmax
// tie-break picks the smallest ORIGINAL index attaining the global max —
// exactly gn_fps's first-index scan.  Matches the reference CUDA kernel's
// semantics (sampling_gpu.cu:74-178) like gn_fps does.
void gn_fps_grid(const float* xyz, int n, int m, int* out) {
  if (m <= 0) return;
  if (n < 4096) {  // grid bookkeeping not worth it below this
    gn_fps(xyz, n, m, out);
    return;
  }
  // --- bucket points into a cubic grid (~128 points/cell target) ---
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int k = 0; k < n; ++k)
    for (int c = 0; c < 3; ++c) {
      const float v = xyz[k * 3 + c];
      lo[c] = v < lo[c] ? v : lo[c];
      hi[c] = v > hi[c] ? v : hi[c];
    }
  int side = (int)std::cbrt((double)n / 128.0);
  side = side < 1 ? 1 : (side > 64 ? 64 : side);
  const int ncell = side * side * side;
  float inv[3];
  for (int c = 0; c < 3; ++c) {
    const float ext = hi[c] - lo[c];
    inv[c] = ext > 0 ? (float)side / (ext * 1.0001f) : 0.0f;
  }
  auto cell_of = [&](int k) {
    int ix[3];
    for (int c = 0; c < 3; ++c) {
      int q = (int)((xyz[k * 3 + c] - lo[c]) * inv[c]);
      ix[c] = q < 0 ? 0 : (q >= side ? side - 1 : q);
    }
    return (ix[0] * side + ix[1]) * side + ix[2];
  };
  std::vector<int> count(ncell + 1, 0);
  for (int k = 0; k < n; ++k) count[cell_of(k) + 1]++;
  for (int b = 0; b < ncell; ++b) count[b + 1] += count[b];
  std::vector<int> orig(n);
  std::vector<float> xs(n), ys(n), zs(n), temp(n);
  {
    std::vector<int> cur(count.begin(), count.end() - 1);
    for (int k = 0; k < n; ++k) {
      const int w = cur[cell_of(k)]++;
      orig[w] = k;
      const float x = xyz[k * 3], y = xyz[k * 3 + 1], z = xyz[k * 3 + 2];
      xs[w] = x;
      ys[w] = y;
      zs[w] = z;
      temp[w] = (x * x + y * y + z * z) > 1e-3f ? 1e10f : -1.0f;
    }
  }
  // per-cell bbox over members + initial blockmax
  std::vector<float> blo(ncell * 3, 1e30f), bhi(ncell * 3, -1e30f);
  std::vector<float> bmax(ncell, -2.0f);
  for (int b = 0; b < ncell; ++b) {
    for (int w = count[b]; w < count[b + 1]; ++w) {
      const float p[3] = {xs[w], ys[w], zs[w]};
      for (int c = 0; c < 3; ++c) {
        blo[b * 3 + c] = p[c] < blo[b * 3 + c] ? p[c] : blo[b * 3 + c];
        bhi[b * 3 + c] = p[c] > bhi[b * 3 + c] ? p[c] : bhi[b * 3 + c];
      }
      bmax[b] = temp[w] > bmax[b] ? temp[w] : bmax[b];
    }
  }
  // reordered slot of original index 0 (gn_fps starts at index 0)
  int slot0 = 0;
  for (int w = 0; w < n; ++w)
    if (orig[w] == 0) {
      slot0 = w;
      break;
    }
  int old = slot0;
  out[0] = 0;
  for (int j = 1; j < m; ++j) {
    const float x1 = xs[old], y1 = ys[old], z1 = zs[old];
    float gmax = -2.0f;
    for (int b = 0; b < ncell; ++b) {
      if (count[b] == count[b + 1]) continue;
      // squared distance lower bound to the cell bbox
      float lb = 0.f;
      const float q[3] = {x1, y1, z1};
      for (int c = 0; c < 3; ++c) {
        const float d0 = blo[b * 3 + c] - q[c];
        const float d1 = q[c] - bhi[b * 3 + c];
        const float d = d0 > 0 ? d0 : (d1 > 0 ? d1 : 0.f);
        lb += d * d;
      }
      if (lb < bmax[b]) {  // cell can change: rescan members
        float bm = -2.0f;
        const int w0 = count[b], w1 = count[b + 1];
#pragma omp simd reduction(max : bm)
        for (int w = w0; w < w1; ++w) {
          const float dx = xs[w] - x1;
          const float dy = ys[w] - y1;
          const float dz = zs[w] - z1;
          const float d = dx * dx + dy * dy + dz * dz;
          const float t = temp[w];
          const float d2 = d < t ? d : t;
          temp[w] = d2;
          bm = d2 > bm ? d2 : bm;
        }
        bmax[b] = bm;
      }
      gmax = bmax[b] > gmax ? bmax[b] : gmax;
    }
    // smallest ORIGINAL index attaining gmax (gn_fps first-index scan)
    int besti_orig = n, besti_slot = slot0;
    for (int b = 0; b < ncell; ++b) {
      if (bmax[b] != gmax) continue;
      for (int w = count[b]; w < count[b + 1]; ++w) {
        if (temp[w] == gmax && orig[w] < besti_orig) {
          besti_orig = orig[w];
          besti_slot = w;
        }
      }
    }
    if (besti_orig == n) {  // no attainer (degenerate): gn_fps keeps 0
      besti_orig = 0;
      besti_slot = slot0;
    }
    old = besti_slot;
    out[j] = besti_orig;
  }
}

// Batched FPS over B independent scenes (OpenMP across scenes).
void gn_fps_batch(const float* xyz, int b, int n, int m, int* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < b; ++i) {
    gn_fps(xyz + (int64_t)i * n * 3, n, m, out + (int64_t)i * m);
  }
}

// Nearest reference point per query (argmin over squared distance,
// first-index tie-break) — the seed -> label-point assignment
// (label_generation.py:84-94).
void gn_nearest(const float* query, int nq, const float* ref, int nr,
                int* out) {
  // Blocked two-pass scan so the distance sweep vectorizes: per block,
  // a SIMD min-reduction finds the block minimum; only when it strictly
  // beats the running best is the block re-scanned for the FIRST index
  // attaining it.  Identical selection to the scalar strictly-less scan
  // (min is exact; blocks are processed in order), ~6x faster — the
  // conditional-update loop it replaces could not vectorize.
  constexpr int kBlock = 2048;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < nq; ++i) {
    const float qx = query[i * 3], qy = query[i * 3 + 1], qz = query[i * 3 + 2];
    float best = 1e30f;
    int besti = 0;
    float d2[kBlock];
    for (int b = 0; b < nr; b += kBlock) {
      const int bn = (nr - b) < kBlock ? (nr - b) : kBlock;
      const float* rb = ref + (int64_t)b * 3;
      float bmin = 1e30f;
#if defined(_OPENMP)
#pragma omp simd reduction(min : bmin)
#endif
      for (int k = 0; k < bn; ++k) {
        const float dx = rb[k * 3] - qx;
        const float dy = rb[k * 3 + 1] - qy;
        const float dz = rb[k * 3 + 2] - qz;
        const float d = dx * dx + dy * dy + dz * dz;
        d2[k] = d;
        bmin = d < bmin ? d : bmin;
      }
      if (bmin < best) {
        for (int k = 0; k < bn; ++k) {
          if (d2[k] == bmin) {
            best = bmin;
            besti = b + k;
            break;
          }
        }
      }
    }
    out[i] = besti;
  }
}

// Uniform-grid index build for eval/ap._SceneGrid: groups point indices
// by cell (cell keys packed EXACTLY as the numpy path — double-precision
// floor((p - min)/cell), dims = max coord + 1, row-major packing — so the
// Python consumer's searchsorted lookups see identical keys).  Outputs:
//   order  (n)  : point indices grouped by cell; ascending WITHIN a cell
//   keys   (n)  : first `ncells` entries = sorted unique cell keys
//   starts (n+1): first `ncells`+1 entries = group offsets into order
// Returns ncells (0 when n == 0).  Replaces an O(n log n) numpy argsort +
// unique (~12 ms at 136k points) with two O(n) passes (~2 ms).
int64_t gn_grid_build(const float* pts, int64_t n, double cell,
                      int32_t* order, uint64_t* keys_out,
                      int64_t* starts, double* minb_out,
                      int64_t* dims_out) {
  if (n == 0) return 0;
  double* minb = minb_out;
  minb[0] = minb[1] = minb[2] = 1e300;
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c) {
      const double v = (double)pts[i * 3 + c];
      if (v < minb[c]) minb[c] = v;
    }
  std::vector<int64_t> coords((size_t)n * 3);
  int64_t* dims = dims_out;
  dims[0] = dims[1] = dims[2] = 0;
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c) {
      const int64_t q =
          (int64_t)std::floor(((double)pts[i * 3 + c] - minb[c]) / cell);
      coords[i * 3 + c] = q;
      if (q + 1 > dims[c]) dims[c] = q + 1;
    }
  std::vector<uint64_t> pkeys((size_t)n);
  for (int64_t i = 0; i < n; ++i)
    pkeys[i] = ((uint64_t)coords[i * 3] * (uint64_t)dims[1] +
                (uint64_t)coords[i * 3 + 1]) *
                   (uint64_t)dims[2] +
               (uint64_t)coords[i * 3 + 2];
  // open-addressing key -> dense group id; counts per group
  uint64_t cap = 64;
  while (cap < (uint64_t)(2 * n)) cap <<= 1;
  const uint64_t smask = cap - 1;
  const uint64_t kEmpty = UINT64_MAX;
  std::vector<uint64_t> tkeys(cap, kEmpty);
  std::vector<int32_t> tgid(cap, -1);
  std::vector<int64_t> counts;
  std::vector<uint64_t> uniq;
  std::vector<uint64_t> slot_of((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t key = pkeys[i];
    uint64_t h = key;
    h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ull;
    h ^= h >> 27; h *= 0x94d049bb133111ebull;
    h ^= h >> 31;
    uint64_t s = h & smask;
    while (tkeys[s] != key && tkeys[s] != kEmpty) s = (s + 1) & smask;
    if (tkeys[s] == kEmpty) {
      tkeys[s] = key;
      tgid[s] = (int32_t)uniq.size();
      uniq.push_back(key);
      counts.push_back(0);
    }
    counts[tgid[s]] += 1;
    slot_of[i] = s;
  }
  const int64_t ncells = (int64_t)uniq.size();
  // sort group ids by key so the Python searchsorted contract holds
  std::vector<int32_t> perm(ncells);
  for (int64_t g = 0; g < ncells; ++g) perm[g] = (int32_t)g;
  std::sort(perm.begin(), perm.end(),
            [&](int32_t a, int32_t b) { return uniq[a] < uniq[b]; });
  std::vector<int32_t> rank(ncells);
  for (int64_t g = 0; g < ncells; ++g) rank[perm[g]] = (int32_t)g;
  starts[0] = 0;
  for (int64_t g = 0; g < ncells; ++g) {
    keys_out[g] = uniq[perm[g]];
    starts[g + 1] = starts[g] + counts[perm[g]];
  }
  std::vector<int64_t> fill(ncells, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t g = rank[tgid[slot_of[i]]];
    order[starts[g] + fill[g]++] = (int32_t)i;
  }
  return ncells;
}

// Voxel-grid downsample: centroid per occupied voxel, grid anchored at
// min_bound - voxel/2 (matches graspnet_tpu.postproc.voxel semantics).
// Returns the number of voxels written to out (caller provides capacity n).
int gn_voxel_downsample(const float* pts, int64_t n, float voxel, float* out) {
  if (n == 0) return 0;
  double minb[3] = {1e30, 1e30, 1e30};
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      const double v = pts[i * 3 + c];
      if (v < minb[c]) minb[c] = v;
    }
  }
  for (int c = 0; c < 3; ++c) minb[c] -= 0.5 * voxel;

  // Flat open-addressing table (linear probing, load factor <= 0.5):
  // ~8x faster than the former std::unordered_map accumulation on 250k-pt
  // capture clouds (node allocation + pointer chasing dominated there).
  // Key packing and the double-precision floor((p - minb) / voxel)
  // quantization are unchanged, so cell assignment is bit-identical to the
  // numpy path; output order is table order (consumers are order-invariant,
  // pinned as sorted-set parity in tests/test_native.py).
  uint64_t cap = 64;
  while (cap < (uint64_t)(2 * n)) cap <<= 1;
  const uint64_t smask = cap - 1;
  const uint64_t kEmpty = UINT64_MAX;  // packed keys use 63 bits at most
  std::vector<uint64_t> keys(cap, kEmpty);
  std::vector<double> sums(cap * 3, 0.0);
  std::vector<int32_t> cnts(cap, 0);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = 0;
    for (int c = 0; c < 3; ++c) {
      const int64_t q =
          (int64_t)std::floor((pts[i * 3 + c] - minb[c]) / voxel);
      key = key * 2097152ull + (uint64_t)(q & 0x1FFFFF);
    }
    uint64_t h = key;  // splitmix64 finalizer spreads packed coords
    h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ull;
    h ^= h >> 27; h *= 0x94d049bb133111ebull;
    h ^= h >> 31;
    uint64_t s = h & smask;
    while (keys[s] != key && keys[s] != kEmpty) s = (s + 1) & smask;
    keys[s] = key;
    sums[s * 3 + 0] += pts[i * 3 + 0];
    sums[s * 3 + 1] += pts[i * 3 + 1];
    sums[s * 3 + 2] += pts[i * 3 + 2];
    cnts[s] += 1;
  }
  int64_t w = 0;
  for (uint64_t s = 0; s < cap; ++s) {
    if (cnts[s] == 0) continue;
    for (int c = 0; c < 3; ++c)
      out[w * 3 + c] = (float)(sums[s * 3 + c] / cnts[s]);
    ++w;
  }
  return (int)w;
}

// Fused per-(label point, view) statistics for the compact training-label
// path (train/label_pipeline.prepare_scene_labels).  One pass over the
// object's (Np, V, A*D) score/width arrays computes, per (p, v):
//   lmin = min score where (score > 0 && width <= max_width), else +inf
//   has  = whether any such element exists
//   vmax = raw max score (mask-free; feeds the reference's batch u_max,
//          label_generation.py:114)
// Replaces ~5 numpy passes (bool mask alloc + where + min + any + max).
void gn_label_view_stats(const float* scores, const float* widths,
                         int64_t np_, int v, int ad, float max_width,
                         float* lmin, unsigned char* has, float* vmax) {
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < np_; ++p) {
    const float* sp = scores + p * (int64_t)v * ad;
    const float* wp = widths + p * (int64_t)v * ad;
    for (int i = 0; i < v; ++i) {
      const float* sv = sp + (int64_t)i * ad;
      const float* wv = wp + (int64_t)i * ad;
      float mn = INFINITY, mx = -INFINITY;
      int hc = 0;
      // branchless so the compiler vectorizes the (memory-bound) sweep:
      // masked-out elements contribute +inf to the min and 0 to the count
#pragma omp simd reduction(min : mn) reduction(max : mx) reduction(+ : hc)
      for (int j = 0; j < ad; ++j) {
        const float x = sv[j];
        mx = x > mx ? x : mx;
        const bool keep = (x > 0.f) & (wv[j] <= max_width);
        const float c = keep ? x : INFINITY;
        mn = c < mn ? c : mn;
        hc += keep ? 1 : 0;
      }
      const int64_t o = p * (int64_t)v + i;
      lmin[o] = mn;
      has[o] = hc ? 1 : 0;
      vmax[o] = mx;
    }
  }
}

// Visibility test for object grasp points vs the (object-segment) scene
// cloud (reference utils/data_utils.py:91-112): point visible iff its
// nearest scene point is closer than `th`.  Scene points are hashed into a
// uniform grid with cell edge `th`, so every scene point within distance th
// of a query lies in one of its 27 neighbor cells (|dx| <= d <= th implies
// a cell-index delta of at most 1 per axis, boundary included) — the
// boolean is exact, not approximate.  The final comparison mirrors the
// numpy path's norm-then-compare: sqrtf is correctly rounded and monotone,
// so sqrtf(min d2) < th decides identically to min(sqrt d2) < th.
void gn_visible(const float* cloud, int n, const float* pts, int m, float th,
                unsigned char* out) {
  if (n == 0) {
    for (int i = 0; i < m; ++i) out[i] = 0;
    return;
  }
  const float inv = 1.0f / th;
  auto cell = [inv](float v) -> int64_t {
    return (int64_t)std::floor((double)v * inv);
  };
  auto key3 = [](int64_t a, int64_t b, int64_t c) -> uint64_t {
    const uint64_t M = 2097152ull;  // 21-bit per axis, as in voxel kernel
    return ((uint64_t)(a & 0x1FFFFF) * M + (uint64_t)(b & 0x1FFFFF)) * M +
           (uint64_t)(c & 0x1FFFFF);
  };
  // bucket scene point indices per cell
  std::unordered_map<uint64_t, std::vector<int>> grid;
  grid.reserve(n / 2 + 16);
  for (int k = 0; k < n; ++k) {
    grid[key3(cell(cloud[k * 3]), cell(cloud[k * 3 + 1]),
              cell(cloud[k * 3 + 2]))]
        .push_back(k);
  }
#pragma omp parallel for schedule(static)
  for (int i = 0; i < m; ++i) {
    const float qx = pts[i * 3], qy = pts[i * 3 + 1], qz = pts[i * 3 + 2];
    const int64_t cx = cell(qx), cy = cell(qy), cz = cell(qz);
    unsigned char vis = 0;
    for (int64_t a = cx - 1; a <= cx + 1 && !vis; ++a)
      for (int64_t b = cy - 1; b <= cy + 1 && !vis; ++b)
        for (int64_t c = cz - 1; c <= cz + 1 && !vis; ++c) {
          auto it = grid.find(key3(a, b, c));
          if (it == grid.end()) continue;
          for (int k : it->second) {
            const float dx = cloud[k * 3] - qx;
            const float dy = cloud[k * 3 + 1] - qy;
            const float dz = cloud[k * 3 + 2] - qz;
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (std::sqrt(d2) < th) {
              vis = 1;
              break;
            }
          }
        }
    out[i] = vis;
  }
}

// Collision-masked variant over FULL per-object label slabs, for the
// per-(scene, object) stat cache (label_pipeline.object_label_stats): the
// dataset zeroes collision elements of scores/tolerance
// (reference graspnet_dataset.py:227-232) BEFORE the per-view reductions,
// so here masked elements contribute 0 to the raw max and are excluded
// from the (score > 0) min — bit-identical to running the unmasked kernel
// on a zeroed copy, without materializing that copy.  `wstride` is the
// element stride of the width array in floats (the width channel of the
// (Np, V, A, D, 3) offsets tensor has stride 3), so no contiguous width
// copy is needed either.
void gn_label_view_stats_masked(const float* scores, const float* widths,
                                const unsigned char* coll, int64_t np_, int v,
                                int ad, int64_t wstride, float max_width,
                                float* lmin, unsigned char* has, float* vmax) {
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < np_; ++p) {
    const float* sp = scores + p * (int64_t)v * ad;
    const float* wp = widths + p * (int64_t)v * ad * wstride;
    const unsigned char* cp = coll + p * (int64_t)v * ad;
    for (int i = 0; i < v; ++i) {
      const float* sv = sp + (int64_t)i * ad;
      const float* wv = wp + (int64_t)i * ad * wstride;
      const unsigned char* cv = cp + (int64_t)i * ad;
      float mn = INFINITY, mx = -INFINITY;
      int hc = 0;
#pragma omp simd reduction(min : mn) reduction(max : mx) reduction(+ : hc)
      for (int j = 0; j < ad; ++j) {
        const bool zeroed = cv[j] != 0;
        const float x = zeroed ? 0.f : sv[j];
        mx = x > mx ? x : mx;
        const bool keep = (x > 0.f) & (wv[j * wstride] <= max_width);
        const float c = keep ? x : INFINITY;
        mn = c < mn ? c : mn;
        hc += keep ? 1 : 0;
      }
      const int64_t o = p * (int64_t)v + i;
      lmin[o] = mn;
      has[o] = hc ? 1 : 0;
      vmax[o] = mx;
    }
  }
}

// Greedy suppression pass for grasp NMS (postproc/nms.py): visit candidates
// in `order`; keep a candidate unless suppressed, then suppress everything
// its `close` row marks.  close is a row-major (m, m) 0/1 matrix.
// Returns the number of kept indices written to `keep`.
int gn_greedy_suppress(const unsigned char* close_mat, const int* order,
                       int m, int* keep) {
  std::vector<unsigned char> suppressed(m, 0);
  int nk = 0;
  for (int oi = 0; oi < m; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep[nk++] = i;
    const unsigned char* row = close_mat + (int64_t)i * m;
    for (int j = 0; j < m; ++j) suppressed[j] |= row[j];
  }
  return nk;
}

// Fully fused grasp NMS: greedy suppression with the pairwise predicate
// (translation distance < tt AND rotation geodesic < rt) evaluated on the
// fly only for KEPT rows — no (m, m) matrix is ever materialized.
// t: (m, 3) translations; r: (m, 9) row-major rotations; order: visit order
// (descending score).  cos_rt = cos(rotation_thresh), tt2 = thresh^2.
// trace(R_i^T R_j) = <r_i, r_j> elementwise, so the rotation test is a
// 9-term dot; the translation test a 3-term squared distance.
int gn_grasp_nms(const float* t, const float* r, const int* order, int m,
                 float tt2, float cos_rt, int* keep) {
  std::vector<unsigned char> suppressed(m, 0);
  int nk = 0;
  for (int oi = 0; oi < m; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep[nk++] = i;
    const float* ti = t + 3 * (int64_t)i;
    const float* ri = r + 9 * (int64_t)i;
#pragma omp parallel for schedule(static) if (m > 4096)
    for (int j = 0; j < m; ++j) {
      if (suppressed[j]) continue;
      const float* tj = t + 3 * (int64_t)j;
      const float dx = ti[0] - tj[0], dy = ti[1] - tj[1], dz = ti[2] - tj[2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 >= tt2) continue;
      const float* rj = r + 9 * (int64_t)j;
      float tr = 0.f;
      for (int k = 0; k < 9; ++k) tr += ri[k] * rj[k];
      if ((tr - 1.f) * 0.5f > cos_rt) suppressed[j] = 1;
    }
  }
  return nk;
}

int gn_version() { return 4; }

}  // extern "C"
