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
// What bounds them on an H100: the membership tests, 8 FLOPs a point-centre
// pair in ball mode, and the scan stops once every depth has ns hits.  On
// the serving path (SA2-4: 2048 -> 1024 centers r 0.1 ns 32, 1024 -> 512 r
// 0.2 ns 16, 512 -> 256 r 0.3 ns 16) the whole work is well under a
// microsecond of arithmetic and the clouds are 6-24 KB, so latency bounds
// it; the training step's SA1 call (2048 centers x 20000 points, r 0.04, ns
// 64) tests tens of millions of pairs on a 240 KB scene.  The cylinder
// query at 1024 seeds x 4 depths x 20000 points tests a few million
// point-seed pairs (far seeds scan all N).
//
// Design of K4 (ball_scan_kernel): a block takes kScanWarps (8)
// consecutive centers of one scene, one per warp, and streams the scene's
// points through a ring of kScanStages shared-memory stages of kScanTile
// points.  Thread 0 keeps the ring full: a 1-D cp.async.bulk (TMA) per
// stage for its 16-byte-aligned middle and 4-byte cp.async for the ragged
// head and tail (a scene starts at byte 12 N b, not always 16-aligned), all
// completing on the stage's mbarrier.  Each warp scans a stage from shared
// memory, 4 chunks of 32 points a step (the 12 loads go out together): per
// chunk a ballot/__popc gives each hit its slot and the hit goes straight
// to out, the first hit stays in a register for the padding.  The block
// barrier at the end of a stage (__syncthreads_count of the warps that are
// done) releases the stage for the next load and stops the block once all
// its centers have ns hits; loads still in flight are waited for before
// the block exits.  What bounds it: the ~15 instructions a warp runs for its center
// per 32 points, over as many points as each center needs (a warp stops at
// its own ns-th hit), with the block's stages held until its slowest
// center is done.  Two centers a warp, or 16 a block, ran slower on an
// H100: each warp then scans as far as the slower of its two centers.  At
// SA2-4 the whole cloud fits the ring and is loaded once per block.
//
// Design of K8 (warp_query_kernel): one warp per center scans the points
// 32 at a time in index order; per depth, __ballot_sync/__popc give each
// hit its slot, and the warp stops as soon as every depth has ns hits (the
// hmax list need not be sorted).  The first hit of each depth is tracked in
// registers, so the padding needs no read-back.
//
// Design of K10 (seed_query_kernel): one thread per (scene, center) walks
// the points one by one in index order and appends each hit to its depth's
// row; the padding reads the row's first entry back.  It shares nothing
// with the scans but the membership test, so holding K4/K8 bit-equal
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

// ------------------------------------------------------ K4: the ball scan --

constexpr int kScanWarps = 8;     // one center each: a block takes 8 consecutive centers
constexpr int kScanUnroll = 4;    // 32-point chunks a warp loads before it tests them
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

// out (batch, m, ns): a block per kScanWarps consecutive centers of one
// scene, one per warp; `stages` <= kScanStages shared-memory stages.
__global__ void __launch_bounds__(kScanWarps * 32)
ball_scan_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                 int64_t* __restrict__ out, int n, int m, int ns, float r2, int stages) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[kScanStages];

  const int per_scene = (m + kScanWarps - 1) / kScanWarps;
  const int b = blockIdx.x / per_scene;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pts = xyz + (size_t)b * n * 3;
  const int tiles = (n + kScanTile - 1) / kScanTile;
  const int head = (4 - (int)((reinterpret_cast<uintptr_t>(pts) >> 2) & 3)) & 3;
  const int shift = (4 - head) & 3;  // stage + shift + head is 16-byte aligned

  const int q = (blockIdx.x - b * per_scene) * kScanWarps + warp;
  const bool valid = q < m;  // a missing center is done from the start and writes nothing
  const size_t row = (size_t)b * m + (valid ? q : 0);
  const float cx = centers[3 * row], cy = centers[3 * row + 1], cz = centers[3 * row + 2];
  int64_t* o = out + row * ns;
  int count = 0, first = 0;
  bool done = !valid;

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
    // kScanUnroll chunks a step: their loads go out together, and a chunk
    // tested after the ns-th hit writes nothing (its slots are >= ns)
    for (int base = 0; base < cnt && !done; base += 32 * kScanUnroll) {
      float x[kScanUnroll], y[kScanUnroll], z[kScanUnroll];
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int p = base + 32 * u + lane;
        x[u] = p < cnt ? sp[3 * p] : 0.0f;
        y[u] = p < cnt ? sp[3 * p + 1] : 0.0f;
        z[u] = p < cnt ? sp[3 * p + 2] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int p = base + 32 * u + lane;
        const float dx = __fsub_rn(x[u], cx);
        const float dy = __fsub_rn(y[u], cy);
        const float dz = __fsub_rn(z[u], cz);
        const bool hit = p < cnt && add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)) < r2;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (bal != 0) {
          const int index = t * kScanTile + p;
          if (count == 0) first = index - lane + __ffs(bal) - 1;
          const int pos = count + __popc(bal & ((1u << lane) - 1u));
          if (hit && pos < ns) o[pos] = index;
          count += __popc(bal);
        }
      }
      done = count >= ns;
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

  if (valid) {
    for (int slot = min(count, ns) + lane; slot < ns; slot += 32) o[slot] = first;
  }
}

}  // namespace

// K4: out (batch, m, ns).
extern "C" int gn_ball_query(const float* xyz, const float* centers,
                             int64_t* out, int batch, int n, int m, float r2,
                             int ns, void* stream) {
  if (ns < 1 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kScanTile - 1) / kScanTile;
  const int stages = tiles < kScanStages ? (tiles > 0 ? tiles : 1) : kScanStages;
  const int smem = stages * kStageFloats * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(ball_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * ((m + kScanWarps - 1) / kScanWarps);
  if (blocks == 0) return (int)cudaSuccess;
  ball_scan_kernel<<<blocks, kScanWarps * 32, smem, (cudaStream_t)stream>>>(xyz, centers, out, n, m, ns,
                                                                             r2, stages);
  return (int)cudaGetLastError();
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
