// Deterministic row scatter-add: the backward of the port's differentiable
// row gathers (ops/scatter.py: gather_points, group_points,
// three_interpolate), in two kernels, the plan and the segment sum.
//
// No TPU kernel: the JAX package's scatter_add_rows
// (graspnet_tpu/ops/scatter.py:28) is plain XLA, one-hot matmuls that
// replace the TPU's near-serial scatter.  Its job here is another: torch's
// own gather backward on CUDA adds with float atomics, and the ball
// query's first-hit padding and three-NN's shared neighbours make the
// indices collide, so the order of the sums, and the step's result, change
// from run to run.
//
// The plan (scatter_plan_kernel) is a stable counting sort of the keys
// b * n + idx (an index outside [0, n) takes the key B * n, a row past the
// last that no sum reads): perm lists the flattened source rows in
// ascending key, ascending source row within a key, and starts (B * n + 1
// entries) bounds each key's segment: bitwise torch.sort(stable=True) and
// searchsorted, the plain version.  It also gives the sum its work order.
// The keys are few (B * n + 1 <= 4097 at a training step's calls) and the
// sources many (up to 65,536), so a comparison or radix sort of 64-bit keys
// (torch.sort: ~24 device operations a call) does far more than the work,
// which is one histogram, one scan and one placement.  One cooperative
// launch does them, with two grid-wide barriers:
//   1. each CTA takes a contiguous chunk of kPlanChunk sources, each of its
//      kPlanWarps warps a contiguous piece of that (its keys loaded into
//      registers at once), and counts its keys into its own histogram with
//      shared-memory atomics (shared memory when B * n + 1 <=
//      kPlanSmemRows, else global scratch); each row's counts turn into the
//      warps' exclusive prefix, and the CTA's count goes to a (CTA, row)
//      table;
//   2. the CTAs share the rows out: each row's counts take an exclusive
//      prefix over the CTAs, the slice's row totals a scan, and each output
//      row a rank in its group of the work order: segments of kLong sources
//      or more, then the other non-empty ones, then the empty ones;
//   3. each CTA adds up the slices before each row, which gives starts, the
//      order and the CTA's first position for each row, and each warp walks
//      its piece again and places its keys, 32 a step: __match_any_sync
//      groups a step's equal keys, the group's lowest lane advances the
//      warp's cursor for the row, and a key's rank is the __popc of its
//      lower peers, so the order is the stable one with no turn-taking
//      between warps.
// The placement is a chain of dependent steps, each ~1k cycles on the H100
// (clock64 marks in the kernel), so the pieces are short: 1024 sources a
// CTA, 4 steps a warp, 64 CTAs at SA2 of a B=2 step (4096 sources a CTA
// took twice as long).  Global loads a thread needs together are started
// together (kBatch).  The plan is made in the forward of every gather whose
// input needs a gradient, five times a training step.
//
// The sum (segment_sum_kernel): out[r] = the sum over the positions s of
// row r's segment, in order, of g[perm[s]], started at 0.0f and taken with
// __fadd_rn: bitwise the sequential index_add_ of the plain version on the
// CPU, and the same from run to run.  Only the order within a segment is
// fixed, so the rest is spread:
//   * the channels: a warp takes one output row's slice of 32 channels, so
//     a long segment is walked by C / 32 warps at once, each in order;
//   * the loads in flight: a warp reads kRound of the segment's perm
//     entries in one coalesced load (the next ones while the current ones'
//     rows load), then starts all kRound source rows' loads before it adds
//     them in order.  The loads are unconditional (a round's tail re-reads
//     the segment's last source, a line already on its way), so the
//     compiler issues them back to back: predicated on the round's length,
//     a round of a ~200-row segment took ~3.4 us, unconditional ~0.9 us
//     (clock64 marks in the kernel);
//   * the schedule: at SA2-4 of a B=2 step 60-87 % of the rows are empty
//     and a few hold ~200 sources (the first-hit padding piles a centre's
//     unfilled slots onto its first hit).  The warps take the rows in the
//     plan's work order, so the long segments start in the first wave and
//     the empty rows' warps, which only write zeros, come last; the first
//     design (one warp a row in row order, 8 rows in flight) waited on the
//     long rows' ~25 rounds of loads wherever they fell.
// What bounds the sum on an H100: bytes.  Each source row is read once (g,
// then perm and starts) and each output row written once; a B=2 training
// step's five calls move ~76 MB, ~23 us at 3.35 TB/s (SA2's g alone is
// 2 x 32768 x 128 x 4 B).  The plan moves each index once (8 B) and writes
// perm, starts and the order (4 B each): ~1 MB a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- the plan --

constexpr int kPlanWarps = 8;      // warps a CTA (ops/scatter.py PLAN_WARPS)
constexpr int kPlanChunk = 1024;   // keys a CTA when the grid allows (PLAN_CHUNK)
constexpr int kPlanSmemRows = 6144;  // most rows kept in shared memory (PLAN_SMEM_ROWS)
constexpr int kPlanSteps = kPlanChunk / kPlanWarps / 32;  // 32-key steps a warp keeps in registers
constexpr int kBatch = 8;          // global loads a thread starts before it uses them
constexpr int kMaxPlanCtas = 256;  // the grid's bound: at most one CTA an SM
constexpr int kLong = 32;          // a segment of more sources than one round of the sum (SUM_LONG)
constexpr int kOrders = 3;         // the work order's groups: long, short, empty rows
static_assert(kPlanWarps > kOrders, "phase 3 gives a warp to each of sums' 1 + kOrders rows");

// An exclusive scan of v over the CTA's threads, in thread order; *total
// gets the sum.  Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kPlanWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Source i's key; -1 past hi.  Unsigned: i may pass 2^31 - 1 past the last step.
__device__ __forceinline__ int plan_key(const int64_t* __restrict__ idx, unsigned i, int hi, int k, int n,
                                        int dropped) {
  if (i >= (unsigned)hi) return -1;
  const int64_t v = __ldg(idx + i);
  return (v >= 0 && v < n) ? ((int)i / k) * n + (int)v : dropped;
}

// The keys of up to kPlanSteps steps of a warp's piece from s, all loads in
// flight at once: key[t] is lane's key at step t, -1 past hi.
__device__ __forceinline__ void load_keys(int (&key)[kPlanSteps], const int64_t* __restrict__ idx, int64_t s,
                                          int hi, int k, int n, int dropped, int lane) {
#pragma unroll
  for (int t = 0; t < kPlanSteps; ++t) key[t] = plan_key(idx, (unsigned)(s + t * 32 + lane), hi, k, n, dropped);
}

// idx (total) int64, k indices a scene; perm (total), starts (rows) and
// order (rows - 1) int32, rows = B * n + 1; scratch: table (CTAs x rows),
// local and rank (rows each), sums (CTAs x (1 + kOrders)), and hist (CTAs x
// (kPlanWarps + 1) x rows: each warp's counts, then the CTA's base for each
// row) or null for shared memory.
__global__ void __launch_bounds__(kPlanWarps * 32)
scatter_plan_kernel(const int64_t* __restrict__ idx, int total, int k, int n, int rows, int per_warp,
                    int* __restrict__ perm, int* __restrict__ starts, int* __restrict__ order,
                    int* __restrict__ table, int* __restrict__ local, int* __restrict__ rank,
                    int* __restrict__ sums, int* __restrict__ hist_global) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kPlanWarps];
  __shared__ int slice_base[1 + kOrders][kMaxPlanCtas];
  __shared__ int order_base[kOrders];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int threads = blockDim.x, blk = blockIdx.x, ctas = gridDim.x;
  const int dropped = rows - 1;
  int* hist = hist_global != nullptr ? hist_global + (int64_t)blk * (kPlanWarps + 1) * rows : smem;
  int* mine = hist + (int64_t)warp * rows;
  int* base_of = hist + (int64_t)kPlanWarps * rows;  // the CTA's first position for each row
  const int64_t lo64 = ((int64_t)blk * kPlanWarps + warp) * per_warp;
  const int lo = (int)(lo64 < total ? lo64 : total);
  const int hi = (int)(lo64 + per_warp < total ? lo64 + per_warp : total);
  const unsigned lower = (1u << lane) - 1u;
  int key[kPlanSteps];

  // 1. count: each warp into its own histogram with shared-memory atomics
  // (the counts do not depend on their order); then each row's warps'
  // exclusive prefix, and the CTA's count
  for (int r = threadIdx.x; r < kPlanWarps * rows; r += threads) hist[r] = 0;
  __syncthreads();
  for (int64_t s = lo; s < hi; s += kPlanSteps * 32) {
    load_keys(key, idx, s, hi, k, n, dropped, lane);
#pragma unroll
    for (int t = 0; t < kPlanSteps; ++t) {
      if (key[t] >= 0) atomicAdd(mine + key[t], 1);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += threads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kPlanWarps; ++w) {
      const int c = hist[(int64_t)w * rows + r];
      hist[(int64_t)w * rows + r] = run;
      run += c;
    }
    table[(int64_t)blk * rows + r] = run;
  }
  grid.sync();

  // 2. this CTA's slice of the rows: each row's exclusive prefix over the
  // CTAs (in place), the slice's exclusive scan of the row totals (local),
  // and each output row's rank in its group of the work order
  const int slice = (rows + ctas - 1) / ctas;
  const int r0 = min(rows, blk * slice), r1 = min(rows, r0 + slice);
  int carry[1 + kOrders] = {0, 0, 0, 0};
  for (int p0 = r0; p0 < r1; p0 += threads) {
    const int r = p0 + threadIdx.x;
    int v = 0;
    if (r < r1) {
      for (int c0 = 0; c0 < ctas; c0 += kBatch) {
        int t[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) t[j] = c0 + j < ctas ? table[(int64_t)(c0 + j) * rows + r] : 0;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (c0 + j < ctas) table[(int64_t)(c0 + j) * rows + r] = v;
          v += t[j];
        }
      }
    }
    int pass;
    const int before = block_scan(v, warp_sums, &pass);
    if (r < r1) local[r] = carry[0] + before;
    carry[0] += pass;
    const int group = r < min(r1, dropped) ? (v >= kLong ? 0 : v > 0 ? 1 : 2) : -1;
#pragma unroll
    for (int o = 0; o < kOrders; ++o) {
      const int at = block_scan(group == o, warp_sums, &pass);
      if (group == o) rank[r] = carry[1 + o] + at;
      carry[1 + o] += pass;
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int o = 0; o <= kOrders; ++o) sums[o * ctas + blk] = carry[o];
  }
  grid.sync();

  // 3. the slices' bases, then each row's start, its place in the work
  // order and the CTA's first position for it (start + the CTAs' keys
  // before it); then each warp places its keys in order, from its cursor
  // (the warps' keys before it, in `mine`)
  if (warp <= kOrders) {  // warp o scans sums[o]
    int run = 0;
    for (int c0 = 0; c0 < ctas; c0 += 32) {
      const int v = c0 + lane < ctas ? sums[warp * ctas + c0 + lane] : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (c0 + lane < ctas) slice_base[warp][c0 + lane] = run + x - v;
      run += __shfl_sync(kFull, x, 31);
    }
    if (warp > 0 && lane == 0) order_base[warp - 1] = run;  // the group's size, for now
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int longs = order_base[0], shorts = order_base[1];
    order_base[0] = 0;
    order_base[1] = longs;
    order_base[2] = longs + shorts;
  }
  __syncthreads();
  for (int p0 = 0; p0 < rows; p0 += threads * kBatch) {
    int base[kBatch], own[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = p0 + j * threads + threadIdx.x;
      base[j] = r < rows ? local[r] : 0;
      own[j] = r < rows ? table[(int64_t)blk * rows + r] : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = p0 + j * threads + threadIdx.x;
      if (r < rows) {
        const int start = base[j] + slice_base[0][r / slice];
        if (r >= r0 && r < r1) starts[r] = start;
        base_of[r] = start + own[j];
      }
    }
  }
  for (int r = r0 + threadIdx.x; r < min(r1, dropped); r += threads) {  // this CTA's output rows
    const int v = local[r + 1] + slice_base[0][(r + 1) / slice] - local[r] - slice_base[0][blk];
    const int group = v >= kLong ? 0 : v > 0 ? 1 : 2;
    order[order_base[group] + slice_base[1 + group][blk] + rank[r]] = r;
  }
  __syncthreads();
  for (int64_t s = lo; s < hi; s += kPlanSteps * 32) {
    load_keys(key, idx, s, hi, k, n, dropped, lane);
    unsigned peers[kPlanSteps];  // every step's groups first: the steps' chain below is only the cursors
#pragma unroll
    for (int t = 0; t < kPlanSteps; ++t) peers[t] = __match_any_sync(kFull, key[t]);
#pragma unroll
    for (int t = 0; t < kPlanSteps; ++t) {
      const int leader = __ffs(peers[t]) - 1;
      int at = 0;
      if (key[t] >= 0 && lane == leader) {
        at = mine[key[t]];
        mine[key[t]] = at + __popc(peers[t]);
        at += base_of[key[t]];
      }
      const int pos = __shfl_sync(kFull, at, leader) + __popc(peers[t] & lower);
      if (key[t] >= 0) perm[pos] = (int)(s + t * 32 + lane);
      __syncwarp();  // orders the cursors' updates between steps
    }
  }
}

// --------------------------------------------------------------- the sum --

constexpr int kSumWarps = 8;  // (row, channel slice) items a block
constexpr int kRound = 32;    // source rows a warp has in flight

__global__ void __launch_bounds__(kSumWarps * 32)
segment_sum_kernel(const float* __restrict__ g, const int* __restrict__ perm, const int* __restrict__ starts,
                   const int* __restrict__ order, float* __restrict__ out, int64_t items, int c, int slices) {
  const int64_t item = (int64_t)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (item >= items) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t slot = item / slices;
  const int ch = (int)(item - slot * slices) * 32 + lane;
  const bool on = ch < c;
  const int64_t row = __ldg(order + slot);
  const int s0 = __ldg(starts + row), s1 = __ldg(starts + row + 1);
  float acc = 0.0f;
  const float* col = g + (on ? ch : c - 1);
  int p = s0 < s1 ? __ldg(perm + min(s0 + lane, s1 - 1)) : 0;
  for (int64_t s = s0; s < s1; s += kRound) {
    const int m = (int)(s1 - s < kRound ? s1 - s : kRound);
    float x[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) x[u] = __ldg(col + (int64_t)__shfl_sync(kFull, p, u) * c);
    p = __ldg(perm + (s + kRound + lane < s1 ? s + kRound + lane : s1 - 1));
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      if (u < m) acc = __fadd_rn(acc, x[u]);
    }
  }
  if (on) out[row * c + ch] = acc;
}

}  // namespace

// idx (B, K) int64; buf int32: perm (B * K), starts (B * n + 1), order
// (B * n), then scratch_len entries of scratch (ops/scatter.py sizes it for
// ceil(B * K / kPlanChunk) CTAs).
extern "C" int gn_scatter_plan(const int64_t* idx, int64_t b, int64_t k, int64_t n, int* buf,
                               int64_t scratch_len, void* stream) {
  const int64_t total = b * k, rows = b * n + 1;
  if (b < 1 || k < 0 || n < 0 || total > 0x7fffffff || rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // CTAs: one a chunk, at most one an SM, so that all are resident for the barriers
  const int64_t chunks = total > 0 ? (total + kPlanChunk - 1) / kPlanChunk : 1;
  const int cap = sms < kMaxPlanCtas ? sms : kMaxPlanCtas;
  const int ctas = (int)(chunks < cap ? chunks : cap);
  const int64_t warps = (int64_t)ctas * kPlanWarps;
  const int per_warp = (int)((total + warps * 32 - 1) / (warps * 32) * 32);
  const bool in_smem = rows <= kPlanSmemRows;
  const int64_t need = ctas * rows + 2 * rows + (1 + kOrders) * ctas + (in_smem ? 0 : (warps + ctas) * rows);
  if (need > scratch_len) return (int)cudaErrorInvalidValue;
  int* perm = buf;
  int* starts = perm + total;
  int* order = starts + rows;
  int* table = order + (rows - 1);
  int* local = table + ctas * rows;
  int* rank = local + rows;
  int* sums = rank + rows;
  int* hist = in_smem ? nullptr : sums + (1 + kOrders) * ctas;
  const size_t smem = in_smem ? (size_t)(kPlanWarps + 1) * rows * sizeof(int) : 0;
  if ((err = raise_smem_limit((const void*)scatter_plan_kernel, smem)) != cudaSuccess) return (int)err;
  int total32 = (int)total, k32 = (int)k, n32 = (int)n, rows32 = (int)rows, per_warp32 = per_warp;
  void* args[] = {(void*)&idx, &total32, &k32, &n32, &rows32, &per_warp32, &perm, &starts, &order, &table, &local,
                  &rank, &sums, &hist};
  return (int)cudaLaunchCooperativeKernel((const void*)scatter_plan_kernel, dim3(ctas), dim3(kPlanWarps * 32),
                                          args, smem, (cudaStream_t)stream);
}

// g (K, C) float32 source rows; perm (K) int32 source row of each sorted
// position; starts (rows + 1) int32 segment bounds; order (rows) int32, the
// rows in work order; out (rows, C) float32.
extern "C" int gn_scatter_add_rows(const float* g, const int* perm, const int* starts, const int* order,
                                   float* out, int64_t rows, int c, void* stream) {
  const int slices = (c + 31) / 32;
  const int64_t items = rows * slices, blocks = (items + kSumWarps - 1) / kSumWarps;
  if (rows < 0 || c < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  segment_sum_kernel<<<(unsigned)blocks, kSumWarps * 32, 0, (cudaStream_t)stream>>>(g, perm, starts, order, out,
                                                                                      items, c, slices);
  return (int)cudaGetLastError();
}
