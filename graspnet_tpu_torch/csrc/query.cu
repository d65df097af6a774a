// First-ns ball and multi-depth cylinder queries with first-hit padding,
// and the per-query scan that they are cross-checked against.
//
// Replaces graspnet_tpu/ops/pallas/query.py::multi_query_batched_pallas in
// both of its modes, through its two entry points:
//   - ball_query_pallas (K4, rotate=False): for each center, the indices of
//     the first ns points with dx*dx+dy*dy+dz*dz < r*r in index order;
//   - cylinder_query_multi_pallas (K8, rotate=True): offsets rotated into
//     the gripper frame, x_r = dx*R0 + dy*R3 + dz*R6 (offset @ R), and for
//     each depth d the first ns points with y_r*y_r + z_r*z_r < r*r and
//     hmin < x_r < hmax_d (query.py:464-472);
// and multi_query_pallas (K10, _query_kernel, query.py:300-353), the
// per-(scene, seed) oracle of the same semantics.  In every mode an empty
// slot takes the first hit of its depth, and a depth with no hits is index
// 0 everywhere.
//
// What bounds them on an H100: the membership tests, a few FLOPs per point
// tested, and the scan stops once every depth has ns hits.  On the serving
// path (SA2-4: 2048 -> 1024 centers r 0.1 ns 32, 1024 -> 512 r 0.2 ns 16,
// 512 -> 256 r 0.3 ns 16) the whole work is well under a microsecond of
// arithmetic and a few hundred KB of traffic, so launch latency dominates.
// The cylinder query at 1024 seeds x 4 depths x 20000 points tests a few
// million point-seed pairs (far seeds scan all N).
//
// Design of K4/K8 (warp_query_kernel): one warp per center scans the points
// 32 at a time in index order; per depth, __ballot_sync/__popc give each
// hit its slot, and the warp stops as soon as every depth has ns hits (the
// hmax list need not be sorted).  The first hit of each depth is tracked in
// registers, so the padding needs no read-back.
//
// Design of K10 (seed_query_kernel): one thread per (scene, center) walks
// the points one by one in index order and appends each hit to its depth's
// row; the padding reads the row's first entry back.  It shares nothing
// with the warp scan but the membership test, so holding K4/K8 bit-equal
// to it checks their slot arithmetic.  It is an oracle, not a fast path.
//
// The membership arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn in the JAX
// operation order, so no FMA contraction moves a point across a radius or
// hmax boundary: the indices equal the plain version's exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSeedThreads = 128;
constexpr int kMaxDepths = 8;

struct QueryArgs {
  int n, m, ns, ndepth, rotate;
  float r2, hmin;
  float hmax[kMaxDepths];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// Bit d set when point p lies in the region of depth d (ball mode: the one
// sphere, the same for every depth).
__device__ __forceinline__ unsigned hit_bits(const float* __restrict__ p,
                                             float cx, float cy, float cz,
                                             const float* r,
                                             const QueryArgs& a) {
  const float dx = __fsub_rn(__ldg(p), cx);
  const float dy = __fsub_rn(__ldg(p + 1), cy);
  const float dz = __fsub_rn(__ldg(p + 2), cz);
  const unsigned all = (1u << a.ndepth) - 1u;
  if (!a.rotate) {
    const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
    return d2 < a.r2 ? all : 0u;
  }
  const float xr = add(add(mul(dx, r[0]), mul(dy, r[3])), mul(dz, r[6]));
  const float yr = add(add(mul(dx, r[1]), mul(dy, r[4])), mul(dz, r[7]));
  const float zr = add(add(mul(dx, r[2]), mul(dy, r[5])), mul(dz, r[8]));
  const float yz2 = add(mul(yr, yr), mul(zr, zr));
  unsigned hits = 0;
  if (yz2 < a.r2 && xr > a.hmin) {
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth && xr < a.hmax[d]) hits |= 1u << d;
    }
  }
  return hits;
}

__device__ __forceinline__ void load_query(const float* __restrict__ centers,
                                           const float* __restrict__ rot,
                                           int q, const QueryArgs& a,
                                           float* c, float* r) {
  c[0] = centers[3 * (size_t)q];
  c[1] = centers[3 * (size_t)q + 1];
  c[2] = centers[3 * (size_t)q + 2];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = a.rotate ? rot[9 * (size_t)q + i] : 0.0f;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
warp_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers,
                  const float* __restrict__ rot, int64_t* __restrict__ out,
                  int batch, QueryArgs a) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= batch * a.m) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  const float* pts = xyz + (size_t)(q / a.m) * a.n * 3;
  float c[3], r[9];
  load_query(centers, rot, q, a, c, r);
  int64_t* o = out + (size_t)q * a.ndepth * a.ns;

  int count[kMaxDepths], first[kMaxDepths];
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) count[d] = first[d] = 0;
  for (int base = 0; base < a.n; base += 32) {
    const int p = base + lane;
    const unsigned hits = p < a.n ? hit_bits(pts + 3 * p, c[0], c[1], c[2], r, a) : 0u;
    bool done = true;
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth) {  // uniform per warp
        const bool hit = (hits >> d) & 1u;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (bal != 0) {
          if (count[d] == 0) first[d] = base + __ffs(bal) - 1;
          if (hit) {
            const int pos = count[d] + __popc(bal & ((1u << lane) - 1u));
            if (pos < a.ns) o[d * a.ns + pos] = p;
          }
          count[d] += __popc(bal);
        }
        done = done && count[d] >= a.ns;
      }
    }
    if (done) break;
  }
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) {
    if (d < a.ndepth) {
      const int pad_from = count[d] < a.ns ? count[d] : a.ns;
      for (int s = pad_from + lane; s < a.ns; s += 32) o[d * a.ns + s] = first[d];
    }
  }
}

__global__ void __launch_bounds__(kSeedThreads)
seed_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers,
                  const float* __restrict__ rot, int64_t* __restrict__ out,
                  int batch, QueryArgs a) {
  const int q = blockIdx.x * kSeedThreads + threadIdx.x;
  if (q >= batch * a.m) return;
  const float* pts = xyz + (size_t)(q / a.m) * a.n * 3;
  float c[3], r[9];
  load_query(centers, rot, q, a, c, r);
  int64_t* o = out + (size_t)q * a.ndepth * a.ns;

  int count[kMaxDepths];
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) count[d] = 0;
  for (int p = 0; p < a.n; ++p) {
    const unsigned hits = hit_bits(pts + 3 * p, c[0], c[1], c[2], r, a);
    bool done = true;
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth) {
        if (((hits >> d) & 1u) && count[d] < a.ns) o[d * a.ns + count[d]++] = p;
        done = done && count[d] == a.ns;
      }
    }
    if (done) break;
  }
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) {
    if (d < a.ndepth) {
      const int64_t pad = count[d] == 0 ? 0 : o[d * a.ns];
      for (int s = count[d]; s < a.ns; ++s) o[d * a.ns + s] = pad;
    }
  }
}

int make_args(QueryArgs* a, int n, int m, int ns, int rotate, float r2,
              float hmin, const float* hmax, int ndepth) {
  if (ns < 1 || ndepth < 1 || ndepth > kMaxDepths) return (int)cudaErrorInvalidValue;
  a->n = n;
  a->m = m;
  a->ns = ns;
  a->ndepth = ndepth;
  a->rotate = rotate;
  a->r2 = r2;
  a->hmin = hmin;
  for (int d = 0; d < kMaxDepths; ++d) {
    a->hmax[d] = (hmax != nullptr && d < ndepth) ? hmax[d] : 0.0f;
  }
  return (int)cudaSuccess;
}

int launch_warp(const float* xyz, const float* centers, const float* rot,
                int64_t* out, int batch, const QueryArgs& a, void* stream) {
  const int blocks = (batch * a.m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  warp_query_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      xyz, centers, rot, out, batch, a);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: out (batch, m, ns).
extern "C" int gn_ball_query(const float* xyz, const float* centers,
                             int64_t* out, int batch, int n, int m, float r2,
                             int ns, void* stream) {
  QueryArgs a;
  int err = make_args(&a, n, m, ns, 0, r2, 0.0f, nullptr, 1);
  if (err != (int)cudaSuccess) return err;
  return launch_warp(xyz, centers, nullptr, out, batch, a, stream);
}

// K8: out (batch, m, ndepth, ns); rot (batch, m, 3, 3) row-major.
extern "C" int gn_cylinder_query(const float* xyz, const float* centers,
                                 const float* rot, int64_t* out, int batch,
                                 int n, int m, int ns, float r2, float hmin,
                                 const float* hmax, int ndepth, void* stream) {
  QueryArgs a;
  int err = make_args(&a, n, m, ns, 1, r2, hmin, hmax, ndepth);
  if (err != (int)cudaSuccess) return err;
  return launch_warp(xyz, centers, rot, out, batch, a, stream);
}

// K10: out (batch, m, ndepth, ns); rot is ignored (may be null) when
// rotate is 0, and every depth then holds the ball query.
extern "C" int gn_multi_query(const float* xyz, const float* centers,
                              const float* rot, int64_t* out, int batch,
                              int n, int m, int ns, int rotate, float r2,
                              float hmin, const float* hmax, int ndepth,
                              void* stream) {
  QueryArgs a;
  int err = make_args(&a, n, m, ns, rotate, r2, hmin, hmax, ndepth);
  if (err != (int)cudaSuccess) return err;
  if (rotate && rot == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (batch * m + kSeedThreads - 1) / kSeedThreads;
  if (blocks == 0) return (int)cudaSuccess;
  seed_query_kernel<<<blocks, kSeedThreads, 0, (cudaStream_t)stream>>>(
      xyz, centers, rot, out, batch, a);
  return (int)cudaGetLastError();
}
