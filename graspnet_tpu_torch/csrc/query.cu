// First-ns ball and multi-depth cylinder queries with first-hit padding,
// the cylinder crop's offsets, and the per-query scan that they are
// cross-checked against.
//
// Replaces graspnet_tpu/ops/pallas/query.py::multi_query_batched_pallas in
// both of its modes, through its two entry points:
//   - ball_query_pallas (K4, rotate=False): for each center, the indices of
//     the first ns points with dx*dx+dy*dy+dz*dz < r*r in index order;
//   - cylinder_query_multi_pallas (K8, rotate=True): offsets rotated into
//     the gripper frame, x_r = dx*R0 + dy*R3 + dz*R6 (offset @ R), and for
//     each depth d the first ns points with y_r*y_r + z_r*z_r < r*r and
//     hmin < x_r < hmax_d (query.py:464-472);
// the front half of ops/pallas/crop.py's crop_group_pallas (K6) and
// crop_fused_pallas (K5): the same cylinder selection written as the
// selected points' rotated offsets (crop.py:116-157; the rest of K5 is
// crop.cu's MLP);
// and multi_query_pallas (K10, _query_kernel, query.py:300-353), the
// per-(scene, seed) oracle of the same semantics.  In every mode an empty
// slot takes the first hit of its depth, and a depth with no hits is index
// 0 everywhere.
//
// What bounds them on an H100: the membership tests, 8 FLOPs a point-centre
// pair in ball mode and 21 in cylinder mode, and the scan stops once every
// depth has ns hits.  On the serving path (SA2-4: 2048 -> 1024 centers r
// 0.1 ns 32, 1024 -> 512 r 0.2 ns 16, 512 -> 256 r 0.3 ns 16) the whole
// work is well under a microsecond of arithmetic and the clouds are 6-24
// KB, so latency bounds it; the training step's SA1 call (2048 centers x
// 20000 points, r 0.04, ns 64) tests tens of millions of pairs on a 240 KB
// scene.  The cylinder scans at 1024 centers x 4 depths x 20000 points test
// tens of millions of point-center pairs (a center stops at the ns-th hit
// of its slowest depth; far centers scan all N).
//
// Design of the ring scan (ring_scan, under K4's ball_scan_kernel and the
// cylinder's cylinder_scan_kernel): a block takes consecutive centers of
// one scene, one per warp (8 for K4, 4 for the cylinder), and streams the
// scene's points through a ring of kScanStages shared-memory stages of
// kScanTile points.  Thread 0 keeps the ring full: a 1-D cp.async.bulk
// (TMA) per stage for its 16-byte-aligned middle and 4-byte cp.async for
// the ragged head and tail (a scene starts at byte 12 N b, not always
// 16-aligned), all completing on the stage's mbarrier.  Each warp scans a
// stage from shared memory, 4 chunks of 32 points a step (the 12 loads go
// out together): a ballot/__popc gives each hit its slot and the hit goes
// straight to out.  The block barrier at the end of a stage
// (__syncthreads_count of the warps that are done) releases the stage for
// the next load and stops the block once all its centers are done; loads
// still in flight are waited for before the block exits.  What bounds it:
// the instructions a warp runs for its center per 32 points (~15 for the
// ball, ~35 for the cylinder's rotation and tests), over as many points as
// each center needs, with the block's stages held until its slowest center
// is done.  For K4, two centers a warp, or 16 a block, ran slower on an
// H100: each warp then scans as far as the slower of its two centers.  At
// SA2-4 the whole cloud fits the ring and is loaded once per block.
//
// The cylinder (K8, K6, K5's first launch: cylinder_scan_kernel<Out>) keeps
// the rotation in registers and, per depth (<= 8), a hit count.  A step
// rotates and tests its 4 chunks with no branch between them, then one
// vote skips the step when no lane lies in the union of the depths; each
// depth short of ns hits takes 4 independent ballots.  A first version
// that voted and balloted chunk by chunk ran 1.6x slower on an H100: a
// warp's step is a chain of dependent votes, and few warps are resident
// (1024 centers at B=1).  A warp is done when every depth has ns hits (the
// hmax list need not be sorted).  Out 0 writes the indices (K8), Out 1 the
// hits' rotated offsets (K6, K5), which the test has just computed in the
// plain version's operand order, so they are bitwise the plain version's;
// the padding reads each depth's first slot back (first-hit registers made
// ptxas spill).  Blocks of 4 centers ran 4-17 % faster than blocks of 8
// (less waiting on a block's slowest center at each stage barrier), and two
// warps per center, each taking every other step and merged by rank, 10 %
// faster at B=1 but 30-36 % slower at B=2.
//
// Design of K10 (seed_query_kernel): a warp per (scene, center), 8 centers
// of one scene a block.  Lanes read 32 consecutive points straight from
// device memory (a scene is at most 240 KB, so it stays in L2), kSeedUnroll
// chunks at a time so their loads go out together; per depth a ballot of
// hit_bits gives each hit its slot, count + the hits of lower lanes, and a
// hit is written when its slot is < ns; the warp stops once every depth has
// ns hits, and the padding reads each depth's first entry back.  It shares
// nothing with the ring scan but the membership test (hit_bits): no
// shared-memory ring, no TMA, no block barrier or block stop, so a fault in
// the ring's stage parity, its head/tail loader or its block stop shows up
// as K4 != K10 or K8 != K10.  What bounds it: as for K4 and the cylinder,
// the tests a warp runs for its center (up to the ns-th hit of its slowest
// depth); it is an oracle, not a fast path.
//
// The membership arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn in the JAX
// operation order, so no FMA contraction moves a point across a radius or
// hmax boundary: the indices equal the plain version's exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kSeedWarps = 8;   // K10: centers a block takes, one a warp
constexpr int kSeedUnroll = 4;  // K10: 32-point chunks a warp loads before it tests them
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

// out (batch, m, ndepth, ns): a block per kSeedWarps consecutive centers of
// one scene, one per warp.
__global__ void __launch_bounds__(kSeedWarps * 32)
seed_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers,
                  const float* __restrict__ rot, int64_t* __restrict__ out,
                  QueryArgs a) {
  const int per_scene = (a.m + kSeedWarps - 1) / kSeedWarps;
  const int b = blockIdx.x / per_scene;
  const int q = (blockIdx.x - b * per_scene) * kSeedWarps + (threadIdx.x >> 5);
  if (q >= a.m) return;  // the whole warp: nothing below waits for the block
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t row = (size_t)b * a.m + q;
  const float* pts = xyz + (size_t)b * a.n * 3;
  float c[3], r[9];
  load_query(centers, rot, (int)row, a, c, r);
  int64_t* o = out + row * a.ndepth * a.ns;

  int count[kMaxDepths];
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) count[d] = 0;
  bool done = false;
  for (int base = 0; base < a.n && !done; base += 32 * kSeedUnroll) {
    unsigned hits[kSeedUnroll];
#pragma unroll
    for (int u = 0; u < kSeedUnroll; ++u) {
      const int p = base + 32 * u + lane;
      hits[u] = p < a.n ? hit_bits(pts + 3 * p, c[0], c[1], c[2], r, a) : 0u;
    }
    done = true;
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth && count[d] < a.ns) {  // uniform per warp
#pragma unroll
        for (int u = 0; u < kSeedUnroll; ++u) {
          const bool hit = (hits[u] >> d) & 1u;
          const unsigned bal = __ballot_sync(0xffffffffu, hit);
          const int pos = count[d] + __popc(bal & below);
          if (hit && pos < a.ns) o[d * a.ns + pos] = base + 32 * u + lane;
          count[d] += __popc(bal);
        }
        done = done && count[d] >= a.ns;
      }
    }
  }
  __syncwarp();  // every lane's hits are visible to the warp
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) {
    if (d < a.ndepth && count[d] < a.ns) {
      const int64_t pad = count[d] == 0 ? 0 : o[d * a.ns];
      for (int s = count[d] + lane; s < a.ns; s += 32) o[d * a.ns + s] = pad;
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

// ---------------------- the ring scan: K4, and the cylinder (K8, K6, K5's first launch) --

constexpr int kScanWarps = 8;     // one center each: a block takes 8 consecutive centers
constexpr int kScanUnroll = 4;    // 32-point chunks a warp loads before it tests them (K4)
constexpr int kCylinderUnroll = 4;  // the same for the cylinder
constexpr int kCylinderWarps = 4;  // one center each: a cylinder block takes 4 consecutive centers
constexpr int kScanTile = 1024;   // points a stage holds
constexpr int kScanStages = 4;
// a stage's floats: the tile, plus 16 bytes to put the bulk copy's
// destination on a 16-byte boundary (12 kScanTile bytes keep every tile's
// start at the scene's alignment)
constexpr int kStageFloats = 3 * kScanTile + 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Thread 0 loads tile t of a scene into its stage: the 16-byte-aligned
// middle with one bulk copy, the ragged head and tail (< 4 floats each)
// with 4-byte cp.async; the stage's barrier completes when all have landed.
// `head` is the floats before the scene's first 16-byte boundary.
__device__ __forceinline__ void load_tile(const float* __restrict__ pts, int n, int t, int head,
                                          float* stage, uint64_t* bar) {
  const int floats = 3 * min(kScanTile, n - t * kScanTile);
  const float* src = pts + (size_t)3 * kScanTile * t;
  const int h = min(head, floats);
  const int mid = (floats - h) & ~3;
  for (int j = 0; j < floats; ++j) {
    if (j == h) j += mid;  // the bulk copy's part
    if (j < floats) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(stage + j)), "l"(src + j)
                   : "memory");
    }
  }
  // the barrier's pending count rises now and falls when those copies land
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
  if (mid == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
  } else {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(4 * mid)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(stage + h)), "l"(src + h), "r"(4 * mid), "r"(smem_u32(bar))
        : "memory");
  }
}

// Streams one scene (n points at pts) through `stages` <= kScanStages
// shared-memory stages and hands each warp its points 32 x Scan::kUnroll at
// a time: scan.step(x, y, z, base, cnt, first, lane), where lane's point of
// chunk u is x[u], y[u], z[u] if base + 32 u + lane < cnt, and has index
// first + base + 32 u + lane in the scene; then scan.step_done(), which says
// whether the warp's center is done.  A warp that is done tests nothing
// more; the block stops once all its warps are done.
template <class Scan>
__device__ __forceinline__ void ring_scan(const float* __restrict__ pts, int n, int stages, Scan& scan) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[kScanStages];

  const int lane = threadIdx.x & 31;
  const int tiles = (n + kScanTile - 1) / kScanTile;
  const int head = (4 - (int)((reinterpret_cast<uintptr_t>(pts) >> 2) & 3)) & 3;
  const int shift = (4 - head) & 3;  // stage + shift + head is 16-byte aligned
  bool done = scan.step_done();

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < min(stages, tiles); ++t) load_tile(pts, n, t, head, ring + t * kStageFloats + shift, &full[t]);
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int s = t % stages;
    if (!done) mbar_wait(&full[s], (t / stages) & 1);
    const float* sp = ring + s * kStageFloats + shift;
    const int cnt = min(kScanTile, n - t * kScanTile);
    // kUnroll chunks a step: their loads go out together, and a chunk
    // tested after the ns-th hit writes nothing (its slots are >= ns)
    for (int base = 0; base < cnt && !done; base += 32 * Scan::kUnroll) {
      float x[Scan::kUnroll], y[Scan::kUnroll], z[Scan::kUnroll];
#pragma unroll
      for (int u = 0; u < Scan::kUnroll; ++u) {
        const int p = base + 32 * u + lane;
        x[u] = p < cnt ? sp[3 * p] : 0.0f;
        y[u] = p < cnt ? sp[3 * p + 1] : 0.0f;
        z[u] = p < cnt ? sp[3 * p + 2] : 0.0f;
      }
      scan.step(x, y, z, base, cnt, t * kScanTile, lane);
      done = scan.step_done();
    }
    // every warp is past stage s: it may be refilled, or the block stops
    const bool stop = __syncthreads_count(done) == (int)blockDim.x;
    if (stop) {
      for (int u = t + 1; u < min(t + stages, tiles); ++u) mbar_wait(&full[u % stages], (u / stages) & 1);
      break;
    }
    if (threadIdx.x == 0 && t + stages < tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(pts, n, t + stages, head, ring + s * kStageFloats + shift, &full[s]);
    }
  }
}

// K4's test: the first ns points with d2 < r2, each written to its slot
// as the ballot finds it; the first hit is kept for the padding.
struct BallScan {
  static constexpr int kUnroll = kScanUnroll;
  float cx, cy, cz, r2;
  int ns, count, first;
  bool valid;
  int64_t* o;

  __device__ __forceinline__ void step(const float* x, const float* y, const float* z, int base, int cnt,
                                       int tile0, int lane) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + 32 * u + lane;
      const float dx = __fsub_rn(x[u], cx);
      const float dy = __fsub_rn(y[u], cy);
      const float dz = __fsub_rn(z[u], cz);
      const bool hit = p < cnt && add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)) < r2;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (bal != 0) {
        const int index = tile0 + p;
        if (count == 0) first = index - lane + __ffs(bal) - 1;
        const int pos = count + __popc(bal & ((1u << lane) - 1u));
        if (hit && pos < ns) o[pos] = index;
        count += __popc(bal);
      }
    }
  }
  __device__ __forceinline__ bool step_done() const { return !valid || count >= ns; }
};

// out (batch, m, ns): a block per kScanWarps consecutive centers of one
// scene, one per warp; `stages` <= kScanStages shared-memory stages.
__global__ void __launch_bounds__(kScanWarps * 32)
ball_scan_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                 int64_t* __restrict__ out, int n, int m, int ns, float r2, int stages) {
  const int per_scene = (m + kScanWarps - 1) / kScanWarps;
  const int b = blockIdx.x / per_scene;
  const int q = (blockIdx.x - b * per_scene) * kScanWarps + (threadIdx.x >> 5);
  const bool valid = q < m;  // a missing center is done from the start and writes nothing
  const size_t row = (size_t)b * m + (valid ? q : 0);
  BallScan scan = {centers[3 * row], centers[3 * row + 1], centers[3 * row + 2], r2, ns, 0, 0, valid,
                   out + row * ns};
  ring_scan(xyz + (size_t)b * n * 3, n, stages, scan);
  if (valid) {
    for (int slot = min(scan.count, ns) + (threadIdx.x & 31); slot < ns; slot += 32) scan.o[slot] = scan.first;
  }
}

// The cylinder's test (K8, K6, K5's first launch), for every depth at once:
// the offset rotated into the gripper frame, x_r = dx*R0 + dy*R3 + dz*R6
// (offset @ R), then y_r^2 + z_r^2 < r2, x_r > hmin and x_r < hmax_d, in the
// JAX order (query.py:464-472).  Per depth a hit count.  A step's chunks
// are rotated and tested with no branch between them, then one vote skips
// the step when no lane is in the union of the depths (hmin < x_r < top,
// top the largest hmax); else each depth short of ns hits takes a ballot
// per chunk, all independent, and gives the hits their slots chunk by
// chunk.  Out 0 writes each hit's index, Out 1 its rotated offset (x_r,
// y_r, z_r), which is bit for bit the plain version's (the point, minus the
// centre, @ R, each product rounded).
template <int Out>
struct CylinderScan {
  static constexpr int kUnroll = kCylinderUnroll;
  float cx, cy, cz, r[9], top;
  QueryArgs a;
  int count[kMaxDepths];
  bool valid;
  void* o;  // this center's row: ndepth x ns indices (Out 0) or offsets (Out 1)

  __device__ __forceinline__ void rotate(float x, float y, float z, float* xr, float* yr, float* zr) const {
    const float dx = __fsub_rn(x, cx);
    const float dy = __fsub_rn(y, cy);
    const float dz = __fsub_rn(z, cz);
    *xr = add(add(mul(dx, r[0]), mul(dy, r[3])), mul(dz, r[6]));
    *yr = add(add(mul(dx, r[1]), mul(dy, r[4])), mul(dz, r[7]));
    *zr = add(add(mul(dx, r[2]), mul(dy, r[5])), mul(dz, r[8]));
  }
  __device__ __forceinline__ void put(int slot, int index, float xr, float yr, float zr) const {
    if (Out == 0) {
      static_cast<int64_t*>(o)[slot] = index;
    } else {
      float* f = static_cast<float*>(o) + 3 * (size_t)slot;
      f[0] = xr;
      f[1] = yr;
      f[2] = zr;
    }
  }
  __device__ __forceinline__ void step(const float* x, const float* y, const float* z, int base, int cnt,
                                       int tile0, int lane) {
    float xr[kUnroll], yr[kUnroll], zr[kUnroll];
    bool inside[kUnroll];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rotate(x[u], y[u], z[u], &xr[u], &yr[u], &zr[u]);
      inside[u] = base + 32 * u + lane < cnt && add(mul(yr[u], yr[u]), mul(zr[u], zr[u])) < a.r2 &&
                  xr[u] > a.hmin && xr[u] < top;
      any = any || inside[u];
    }
    if (!__any_sync(0xffffffffu, any)) return;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth && count[d] < a.ns) {  // uniform per warp
        unsigned bal[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) bal[u] = __ballot_sync(0xffffffffu, inside[u] && xr[u] < a.hmax[d]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = count[d] + __popc(bal[u] & below);
          if (((bal[u] >> lane) & 1u) && pos < a.ns) {
            put(d * a.ns + pos, tile0 + base + 32 * u + lane, xr[u], yr[u], zr[u]);
          }
          count[d] += __popc(bal[u]);
        }
      }
    }
  }
  __device__ __forceinline__ bool step_done() const {
    bool done = true;
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) done = done && (d >= a.ndepth || count[d] >= a.ns);
    return !valid || done;
  }
  // An empty slot takes its depth's first hit, read back from slot 0 (the
  // warp wrote it); a depth with no hits, point 0.
  __device__ __forceinline__ void pad(const float* __restrict__ pts, int lane) const {
    __syncwarp();  // every lane's hits are visible to the warp
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth && count[d] < a.ns) {
        const int row = d * a.ns;
        int index = 0;
        float xr = 0.0f, yr = 0.0f, zr = 0.0f;
        if (Out == 0) {
          if (count[d] > 0) index = (int)static_cast<const int64_t*>(o)[row];
        } else if (count[d] > 0) {
          const float* f = static_cast<const float*>(o) + 3 * (size_t)row;
          xr = f[0];
          yr = f[1];
          zr = f[2];
        } else {
          rotate(__ldg(pts), __ldg(pts + 1), __ldg(pts + 2), &xr, &yr, &zr);
        }
        for (int slot = count[d] + lane; slot < a.ns; slot += 32) put(row + slot, index, xr, yr, zr);
      }
    }
  }
};

// Out 0: out (batch, m, ndepth, ns) int64; Out 1: out (batch, m, ndepth,
// ns, 3) float32.  rot (batch, m, 3, 3) row-major.  A block per
// kCylinderWarps consecutive centers of one scene, one per warp, over
// ring_scan.
template <int Out>
__global__ void __launch_bounds__(kCylinderWarps * 32)
cylinder_scan_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                     const float* __restrict__ rot, void* __restrict__ out, QueryArgs a, int stages) {
  const int per_scene = (a.m + kCylinderWarps - 1) / kCylinderWarps;
  const int b = blockIdx.x / per_scene;
  const int q = (blockIdx.x - b * per_scene) * kCylinderWarps + (threadIdx.x >> 5);
  const size_t row = (size_t)b * a.m + (q < a.m ? q : 0);
  CylinderScan<Out> scan;
  scan.valid = q < a.m;  // a missing center is done from the start and writes nothing
  scan.cx = centers[3 * row];
  scan.cy = centers[3 * row + 1];
  scan.cz = centers[3 * row + 2];
#pragma unroll
  for (int i = 0; i < 9; ++i) scan.r[i] = rot[9 * row + i];
  scan.a = a;
  scan.top = a.hmax[0];
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) {
    scan.count[d] = 0;
    if (d < a.ndepth) scan.top = fmaxf(scan.top, a.hmax[d]);
  }
  const size_t slots = row * a.ndepth * a.ns;
  scan.o = Out == 0 ? (void*)(static_cast<int64_t*>(out) + slots) : (void*)(static_cast<float*>(out) + 3 * slots);
  const float* pts = xyz + (size_t)b * a.n * 3;
  ring_scan(pts, a.n, stages, scan);
  if (scan.valid) scan.pad(pts, threadIdx.x & 31);
}

// The ring's stages for n points (1 when n is 0).
int ring_stages(int n) {
  const int tiles = (n + kScanTile - 1) / kScanTile;
  return tiles < kScanStages ? (tiles > 0 ? tiles : 1) : kScanStages;
}

template <int Out>
int launch_cylinder(const float* xyz, const float* centers, const float* rot, void* out, int batch,
                    const QueryArgs& a, cudaStream_t stream) {
  void (*kernel)(const float*, const float*, const float*, void*, QueryArgs, int) = cylinder_scan_kernel<Out>;
  const int stages = ring_stages(a.n);
  const int smem = stages * kStageFloats * (int)sizeof(float);
  const cudaError_t err = raise_smem_limit((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * ((a.m + kCylinderWarps - 1) / kCylinderWarps);
  if (blocks == 0) return (int)cudaSuccess;
  kernel<<<blocks, kCylinderWarps * 32, smem, stream>>>(xyz, centers, rot, out, a, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: out (batch, m, ns).
extern "C" int gn_ball_query(const float* xyz, const float* centers,
                             int64_t* out, int batch, int n, int m, float r2,
                             int ns, void* stream) {
  if (ns < 1 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int stages = ring_stages(n);
  const int smem = stages * kStageFloats * (int)sizeof(float);
  const cudaError_t err = raise_smem_limit((const void*)ball_scan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * ((m + kScanWarps - 1) / kScanWarps);
  if (blocks == 0) return (int)cudaSuccess;
  ball_scan_kernel<<<blocks, kScanWarps * 32, smem, (cudaStream_t)stream>>>(xyz, centers, out, n, m, ns,
                                                                             r2, stages);
  return (int)cudaGetLastError();
}

// The cylinder scan: K8 (offsets 0) writes the indices, out (batch, m,
// ndepth, ns) int64; K6 and K5's first launch (offsets 1) the rotated
// offsets, out (batch, m, ndepth, ns, 3) float32.  rot (batch, m, 3, 3)
// row-major; n >= 1 (a depth with no hits takes point 0).
extern "C" int gn_cylinder_scan(const float* xyz, const float* centers,
                                const float* rot, void* out, int offsets, int batch,
                                int n, int m, int ns, float r2, float hmin,
                                const float* hmax, int ndepth, void* stream) {
  QueryArgs a;
  int err = make_args(&a, n, m, ns, 1, r2, hmin, hmax, ndepth);
  if (err != (int)cudaSuccess) return err;
  if (n < 1 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return offsets ? launch_cylinder<1>(xyz, centers, rot, out, batch, a, st)
                 : launch_cylinder<0>(xyz, centers, rot, out, batch, a, st);
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
  const int blocks = batch * ((m + kSeedWarps - 1) / kSeedWarps);
  if (blocks == 0) return (int)cudaSuccess;
  seed_query_kernel<<<blocks, kSeedWarps * 32, 0, (cudaStream_t)stream>>>(xyz, centers, rot, out, a);
  return (int)cudaGetLastError();
}
