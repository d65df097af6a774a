// Cascaded furthest point sampling, one launch for every stage.
//
// Replaces graspnet_tpu/ops/pallas/fps.py::fps_chain_pallas (K1) and its
// single-stage case fps_pallas (K2).  Semantics (ops/sampling.py:53-73):
// index 0 comes first; a point with x*x+y*y+z*z <= 1e-3 is never picked;
// the running min-distance starts at 1e10; d = dx*dx + dy*dy + dz*dz in
// that order; ties go to the lowest index; stage k samples the coordinates
// that stage k-1 selected and returns indices into stage k-1's list.
//
// What bounds it on an H100: latency, not FLOPs or bytes.  The production
// cascade 20000 -> 2048 -> 1024 -> 512 -> 256 is 3,836 dependent argmax
// steps per scene; each step is a distance update over the stage's points,
// an argmax across them and the broadcast of the winner's coordinates.
//
// Design.  Stage 0 runs on a thread-block cluster of C CTAs per scene
// (kDefaultCluster, launched with cudaLaunchKernelEx).  CTA r owns the
// contiguous slice [r L, (r+1) L) of the scene's points, L = ceil(N / C),
// and each thread keeps its points' coordinates and min-distances in
// registers, so a step reads no device memory.  A step: local update and
// argmax -> warp shuffle argmax -> per-warp candidates in shared memory,
// one __syncthreads -> warp 0 reduces them to the CTA's (dist, index, x, y,
// z) and pushes it with st.async into slot r of every CTA of the cluster,
// each store completing transaction bytes on that CTA's mbarrier -> every
// CTA waits on its own mbarrier for the C candidates and each warp reduces
// them by (value desc, index asc).  The winner's coordinates travel in the
// slot, so no dependent global read remains.  Slots and mbarriers are
// double-buffered by step parity: a CTA pushes step j+1 only after all its
// warps passed step j+1's __syncthreads, so no peer overwrites a slot that
// is still being read.  (A cluster barrier per step instead costs ~1.9 us
// at C = 8 on an H100: every thread of every CTA arrives; PERF.md.)  CTA 0
// forwards every winner's coordinates into its shared memory; after stage
// 0 the other CTAs leave and CTA 0 runs the later stages on its own
// threads, each holding <= 8 points in registers, one __syncthreads a step:
// every warp reduces the double-buffered warp candidates itself, with no
// broadcast through warp 0.  A slice too large for registers (C <= 2 at
// 20000 points, or a forwarded stage above 2048 points) runs a 1024-thread
// variant that keeps only the min-distances in registers and re-reads
// stage 0's coordinates through L1/L2.  The distance arithmetic uses
// __fmul_rn/__fadd_rn so that no FMA contraction changes a rounding: the
// indices equal the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

// CTAs per scene in stage 0, from the sweep over C in {1, 2, 4, 8, 16} that
// chip_smoke.py runs at 20000 points on an H100: 8 and 16 tie, 8 is
// portable (PERF.md).
constexpr int kDefaultCluster = 8;
constexpr int kMaxCluster = 16;   // 16 needs the non-portable cluster size
constexpr int kMaxStages = 8;
constexpr int kNarrow = 256;      // threads of the register variant
constexpr int kWide = 1024;       // threads of the wide variant
constexpr int kWidePer = 24;      // wide variant: min-distances per thread
// Stage 0's limit is the slice a CTA holds, not N: ceil(N / C) points, at
// most kWide x kWidePer (24,576), so the default cluster takes N <= 196,608.
constexpr int kMaxSlice = kWide * kWidePer;
constexpr int kNarrowLate = 8;    // later stages: points per thread (<= 2048)
constexpr int kWideLate = 10;     // (<= 10240)

struct Stages {
  int count;
  int total;            // sum of npoint over stages (columns of `out`)
  int max_forward;      // largest npoint forwarded to a next stage
  int npoint[kMaxStages];
  int offset[kMaxStages];
};

// A candidate: min-distance, index and coordinates of a point.
struct Cand {
  float v;
  int i;
  float x, y, z;
};

__device__ __forceinline__ Cand sentinel() { return Cand{-3.0f, 0x7fffffff, 0.0f, 0.0f, 0.0f}; }

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void take_better(Cand& a, const Cand& b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) a = b;
}

__device__ __forceinline__ Cand shfl_xor(const Cand& c, int m) {
  return Cand{__shfl_xor_sync(0xffffffffu, c.v, m), __shfl_xor_sync(0xffffffffu, c.i, m),
              __shfl_xor_sync(0xffffffffu, c.x, m), __shfl_xor_sync(0xffffffffu, c.y, m),
              __shfl_xor_sync(0xffffffffu, c.z, m)};
}

__device__ __forceinline__ Cand shfl_lane(const Cand& c, int src) {
  return Cand{__shfl_sync(0xffffffffu, c.v, src), __shfl_sync(0xffffffffu, c.i, src),
              __shfl_sync(0xffffffffu, c.x, src), __shfl_sync(0xffffffffu, c.y, src),
              __shfl_sync(0xffffffffu, c.z, src)};
}

// The best of lanes [0, width) (width a power of two <= 32), in every lane.
__device__ __forceinline__ Cand warp_best(Cand c, int width) {
  for (int m = 1; m < width; m <<= 1) take_better(c, shfl_xor(c, m));
  return width == 32 ? c : shfl_lane(c, 0);
}

// ---- cluster messaging: st.async into a peer's shared memory, completing
// on the peer's mbarrier (transaction bytes), so a step waits for the C
// candidates it needs and for nothing else ----

// A candidate slot: {v, i, x, y} as one 16-byte store, z as a second.
constexpr int kSlotWords = 8;
constexpr unsigned kSlotBytes = 20;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of st.async transactions
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// c into slot `slot` and barrier `bar` (local addresses) of CTA `rank`
__device__ __forceinline__ void send_cand(const Cand& c, float* slot, uint64_t* bar, unsigned rank) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rs) : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(rs), "r"(__float_as_uint(c.v)), "r"(c.i), "r"(__float_as_uint(c.x)),
        "r"(__float_as_uint(c.y)), "r"(rb)
      : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(rs + 16), "r"(__float_as_uint(c.z)), "r"(rb)
               : "memory");
}

__device__ __forceinline__ Cand read_slot(const float* slot) {
  return Cand{slot[0], __float_as_int(slot[1]), slot[2], slot[3], slot[4]};
}

__device__ __forceinline__ float init_dist(float x, float y, float z) {
  // -1 marks a near-origin point: a distance is >= 0, so fminf keeps it
  // losing; -2 (set by the callers) marks a slot past the end
  return sq3(x, y, z) > 1e-3f ? 1e10f : -1.0f;
}

// Later stages on CTA 0's T threads: n points in fbuf (3 n floats) ->
// npoint indices into out_s; the selected coordinates overwrite fbuf when
// `forward`.  wcand holds 2 x (T / 32) candidates.
template <int T, int PER>
__device__ void late_stage(float* fbuf, Cand* wcand, int n, int npoint, bool forward,
                           int64_t* out_s) {
  constexpr int kWarps = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float px[PER], py[PER], pz[PER], mind[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int p = tid + k * T;
    mind[k] = -2.0f;
    px[k] = py[k] = pz[k] = 0.0f;
    if (p < n) {
      px[k] = fbuf[3 * p];
      py[k] = fbuf[3 * p + 1];
      pz[k] = fbuf[3 * p + 2];
      mind[k] = init_dist(px[k], py[k], pz[k]);
    }
  }
  float cx = fbuf[0], cy = fbuf[1], cz = fbuf[2];
  __syncthreads();  // every point is in registers before fbuf is overwritten
  if (tid == 0) out_s[0] = 0;  // fbuf[0] already holds point 0
  for (int j = 1; j < npoint; ++j) {
    Cand best = sentinel();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const float m = fminf(sq3(__fsub_rn(px[k], cx), __fsub_rn(py[k], cy), __fsub_rn(pz[k], cz)),
                            mind[k]);
      mind[k] = m;
      if (m > best.v) best = Cand{m, tid + k * T, px[k], py[k], pz[k]};  // strict: lowest index
    }
    best = warp_best(best, 32);
    Cand* wc = wcand + (j & 1) * kWarps;
    if (lane == 0) wc[warp] = best;
    __syncthreads();
    const Cand c = warp_best(lane < kWarps ? wc[lane] : sentinel(), kWarps);
    cx = c.x;
    cy = c.y;
    cz = c.z;
    if (tid == 0) {
      out_s[j] = c.i;
      if (forward) {
        fbuf[3 * j] = c.x;
        fbuf[3 * j + 1] = c.y;
        fbuf[3 * j + 2] = c.z;
      }
    }
  }
  __syncthreads();  // fbuf complete before the next stage reads it
}

// T threads a CTA; stage 0 keeps PER0 points a thread (coordinates in
// registers when REG0, else min-distances only); LATE bounds a later
// stage's points a thread.
template <int T, int PER0, bool REG0, int LATE>
__global__ void __launch_bounds__(T)
fps_cluster_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int n0, Stages st) {
  constexpr int kWarps = T / 32;
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);            // 2 (step parity)
  float* slots = reinterpret_cast<float*>(smem4 + 1);            // [2][kMaxCluster][kSlotWords]
  Cand* wcand = reinterpret_cast<Cand*>(slots + 2 * kMaxCluster * kSlotWords);  // 2 x kWarps
  float* fbuf = reinterpret_cast<float*>(wcand + 2 * kWarps);    // 3 * max_forward

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = xyz + (size_t)(blockIdx.x / csize) * n0 * 3;
  int64_t* out_b = out + (size_t)(blockIdx.x / csize) * st.total;
  const bool lead = rank == 0 && tid == 0;
  const bool fwd0 = st.count > 1;
  const int slice = (n0 + csize - 1) / csize;
  const int lo = rank * slice, hi = min(n0, lo + slice);

  // ---- stage 0 on the cluster ----
  float px[REG0 ? PER0 : 1], py[REG0 ? PER0 : 1], pz[REG0 ? PER0 : 1], mind[PER0];
#pragma unroll
  for (int k = 0; k < PER0; ++k) {
    const int p = lo + tid + k * T;
    mind[k] = -2.0f;
    if (REG0) px[k] = py[k] = pz[k] = 0.0f;
    if (p < hi) {
      const float x = src[3 * p], y = src[3 * p + 1], z = src[3 * p + 2];
      if (REG0) {
        px[k] = x;
        py[k] = y;
        pz[k] = z;
      }
      mind[k] = init_dist(x, y, z);
    }
  }
  float cx = src[0], cy = src[1], cz = src[2];
  if (lead) {
    out_b[0] = 0;
    if (fwd0) {
      fbuf[0] = cx;
      fbuf[1] = cy;
      fbuf[2] = cz;
    }
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_fence_init();
  }
  cluster.sync();  // every CTA's barriers are initialised before any message
  for (int j = 1; j < st.npoint[0]; ++j) {
    const int par = j & 1;
    if (tid == 0) mbar_expect(bar + par, kSlotBytes * csize);
    Cand best = sentinel();
#pragma unroll
    for (int k = 0; k < PER0; ++k) {
      const int p = lo + tid + k * T;
      if (p < hi) {
        const float x = REG0 ? px[k] : src[3 * p];
        const float y = REG0 ? py[k] : src[3 * p + 1];
        const float z = REG0 ? pz[k] : src[3 * p + 2];
        const float m = fminf(sq3(__fsub_rn(x, cx), __fsub_rn(y, cy), __fsub_rn(z, cz)), mind[k]);
        mind[k] = m;
        if (m > best.v) best = Cand{m, p, x, y, z};  // strict: the lowest index wins ties
      }
    }
    best = warp_best(best, 32);
    if (lane == 0) wcand[par * kWarps + warp] = best;
    __syncthreads();
    float* step_slots = slots + par * kMaxCluster * kSlotWords;
    if (warp == 0) {  // the CTA's best, pushed into slot `rank` of every CTA
      const Cand c = warp_best(lane < kWarps ? wcand[par * kWarps + lane] : sentinel(), kWarps);
      if (lane < csize) send_cand(c, step_slots + rank * kSlotWords, bar + par, lane);
    }
    mbar_wait(bar + par, ((j - 1) >> 1) & 1);  // this step's C candidates are here (the
                                               // barrier's ((j-1)/2)-th phase)
    const Cand c = warp_best(lane < csize ? read_slot(step_slots + lane * kSlotWords) : sentinel(), csize);
    cx = c.x;
    cy = c.y;
    cz = c.z;
    if (lead) {
      out_b[j] = c.i;
      if (fwd0) {
        fbuf[3 * j] = c.x;
        fbuf[3 * j + 1] = c.y;
        fbuf[3 * j + 2] = c.z;
      }
    }
  }
  cluster.sync();  // no CTA leaves while a message to it may be in flight
  if (rank != 0) return;

  // ---- later stages on CTA 0 ----
  __syncthreads();  // the forwarded coordinates are complete
  int n = st.npoint[0];
  for (int s = 1; s < st.count; ++s) {
    const int per = (n + T - 1) / T;
    const bool forward = s + 1 < st.count;
    int64_t* out_s = out_b + st.offset[s];
    if (per <= 2) {
      late_stage<T, 2>(fbuf, wcand, n, st.npoint[s], forward, out_s);
    } else if (per <= 4) {
      late_stage<T, 4>(fbuf, wcand, n, st.npoint[s], forward, out_s);
    } else {
      late_stage<T, LATE>(fbuf, wcand, n, st.npoint[s], forward, out_s);
    }
    n = st.npoint[s];
  }
}

template <int T, int PER0, bool REG0, int LATE>
cudaError_t launch(const float* xyz, int64_t* out, int batch, int n, const Stages& st,
                   int csize, cudaStream_t stream) {
  auto kernel = fps_cluster_kernel<T, PER0, REG0, LATE>;
  const size_t smem = sizeof(float4) + 2 * kMaxCluster * kSlotWords * sizeof(float) +
                      2 * (T / 32) * sizeof(Cand) + 3 * (size_t)st.max_forward * sizeof(float);
  cudaError_t err = raise_smem_limit((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  if (csize > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * csize);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xyz, out, n, st);
}

}  // namespace

// cluster: CTAs per scene in stage 0 (1, 2, 4, 8 or 16), 0 for the default.
extern "C" int gn_fps_chain(const float* xyz, int64_t* out, int batch, int n,
                            const int* npoints, int nstage, int cluster, void* stream) {
  const int csize = cluster > 0 ? cluster : kDefaultCluster;
  if (nstage < 1 || nstage > kMaxStages || n < 1 || csize > kMaxCluster || (csize & (csize - 1)) != 0 ||
      (n + csize - 1) / csize > kMaxSlice) {
    return (int)cudaErrorInvalidValue;
  }
  Stages st;
  st.count = nstage;
  st.total = 0;
  st.max_forward = 1;
  for (int s = 0; s < nstage; ++s) {
    st.npoint[s] = npoints[s];
    st.offset[s] = st.total;
    st.total += npoints[s];
    if (s + 1 < nstage && npoints[s] > st.max_forward) st.max_forward = npoints[s];
  }
  if (batch == 0) return (int)cudaSuccess;
  const int slice = (n + csize - 1) / csize;
  const int per = (slice + kNarrow - 1) / kNarrow;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (per <= 24 && st.max_forward <= kNarrow * kNarrowLate) {
    if (per <= 4) {
      err = launch<kNarrow, 4, true, kNarrowLate>(xyz, out, batch, n, st, csize, s);
    } else if (per <= 8) {
      err = launch<kNarrow, 8, true, kNarrowLate>(xyz, out, batch, n, st, csize, s);
    } else if (per <= 12) {
      err = launch<kNarrow, 12, true, kNarrowLate>(xyz, out, batch, n, st, csize, s);
    } else if (per <= 16) {
      err = launch<kNarrow, 16, true, kNarrowLate>(xyz, out, batch, n, st, csize, s);
    } else {
      err = launch<kNarrow, 24, true, kNarrowLate>(xyz, out, batch, n, st, csize, s);
    }
  } else if (st.max_forward <= kWide * kWideLate) {
    err = launch<kWide, kWidePer, false, kWideLate>(xyz, out, batch, n, st, csize, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
