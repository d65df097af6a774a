// Voxel-grid downsample of a raw capture on the card: one centroid per
// occupied cell, bitwise the host library's gn_voxel_downsample
// (csrc/host.cpp) as a set of rows, for the collision filter
// (postproc/collision.py), which scans the result where it lies.
//
// No TPU kernel: the JAX package downsamples on its host library too
// (graspnet_tpu/native/src/graspnet_host.cpp).  On the card's host that
// took 8-9 ms a 250k-point capture, most of it cache misses into a 2n-slot
// table for ~8k occupied cells, and it sat on the request's path with the
// card idle.
//
// What "bitwise" fixes, and how each step keeps it:
//   * the grid's anchor: the float minimum of each axis (NaN skipped, as
//     the library's `v < minb` skips it), in double, capped at 1e30 (the
//     library's start), less 0.5 * voxel in double: __dsub_rn;
//   * a point's cell: floor((p - minb) / voxel) in IEEE double, with
//     __dsub_rn and __ddiv_rn (no contraction can touch them), and the
//     library's key, 21 bits an axis, masked: a far or sparse cloud merges
//     the cells the library merges;
//   * a cell's centroid: its points' coordinates summed in double from 0.0
//     in ascending source order, then (float)(sum / count).  The order is
//     part of the result (a long cell's sum rounds), so the points are
//     sorted stably by cell before the sums, and no sum is an atomic.
// The rows come out in the order of each cell's first point, so two runs
// give the same bytes (the hash table's slots, which depend on the order of
// the inserts, never reach the output).
//
// One cooperative launch, every CTA resident, grid-wide barriers between
// the phases:
//   0. the table's slots set empty; each CTA's per-axis minimum;
//   1. every CTA reduces the minima; each point's key goes into an
//      open-addressing table (linear probing, 2n slots rounded up to a
//      power of 2, as the library sizes it; atomicCAS on the key), and
//      the slot's first point is an atomicMin of the source index;
//   2-3. a point whose slot's first point is itself opens a cell; the
//      cells take dense ids in source order (a count a CTA, then each
//      CTA's exclusive scan over its contiguous range), and the last CTA
//      writes the count K;
//   4. a stable LSD radix sort of the (cell id, source) pairs, kDigitBits
//      a pass: scatter.cu's counting-sort design (each warp a contiguous
//      piece, per-warp shared-memory histograms, a (digit, CTA) table whose
//      prefix the CTAs take in slices, then placement 32 keys a step with
//      __match_any_sync, a key's rank the __popc of its lower peers).  Its
//      rows there are fixed (one table of B * n + 1 rows); here the cell
//      count is unknown at launch and may reach n, so the digits keep the
//      table at 512 x CTAs;
//   5. the thread at the start of each cell's run sums it in order.
// The host reads K once (8 bytes) after the launch: the scan that follows
// sizes its blocks by it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;  // warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCtas = 256;  // the most CTAs (MAX_CTAS); the per-CTA arrays are sized for it
constexpr int kCtaPoints = 2048;  // points a CTA when the grid allows
constexpr int kDigitBits = 9;  // bits of the cell id a sort pass takes (DIGIT_BITS)
constexpr int kDigits = 1 << kDigitBits;
constexpr int kBatch = 8;  // global loads a thread starts before it uses them
constexpr unsigned long long kEmpty = ~0ull;  // a key uses 63 bits at most
constexpr unsigned long long kAxis = 2097152ull;  // 2^21 cells an axis in a key (host.cpp)
constexpr unsigned long long kAxisMask = kAxis - 1;
constexpr double kMinStart = 1e30;  // the library's starting minimum

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
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// splitmix64's finalizer: spreads the packed cells over the slots
__device__ __forceinline__ unsigned long long mix(unsigned long long h) {
  h ^= h >> 30;
  h *= 0xbf58476d1ce4e5b9ull;
  h ^= h >> 27;
  h *= 0x94d049bb133111ebull;
  h ^= h >> 31;
  return h;
}

struct Buffers {
  long long* count;            // K, the cells
  unsigned long long* tkey;    // the table: a slot's key,
  int* tfirst;                 // its first point,
  int* tcell;                  // its cell id
  int* slot_of;                // each point's slot
  int* key[2];                 // the sort's ping-pong (cell id, source) pairs
  int* src[2];
  float* part_min;             // (CTA, axis) minima
  int* cta_count;              // cells opened in each CTA's range
  int* table;                  // (digit, CTA) counts, then their prefix over the CTAs
  int* local;                  // each digit's exclusive prefix within its CTA's slice
  int* slice_sum;              // each slice's keys
};

// pts (n, 3) float32; out (n, 3) float32, of which the first K rows are
// written.  A warp's piece: per_warp points from (CTA * kWarps + warp) *
// per_warp; a CTA's range is its warps' pieces, in order.
__global__ void __launch_bounds__(kThreads)
voxel_kernel(const float* __restrict__ pts, int n, float voxel, int per_warp, int passes, unsigned cap_mask,
             Buffers buf, float* __restrict__ out) {
  __shared__ int hist[kWarps][kDigits];  // each warp's digit counts, then its cursors
  __shared__ int base[kDigits];          // the CTA's first position for each digit
  __shared__ int slice_base[kMaxCtas];
  __shared__ int warp_sums[kWarps];
  __shared__ float red[3][kWarps];
  __shared__ double minb_s[3];
  __shared__ int cells_before;
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x, ctas = gridDim.x;
  const long long gthreads = (long long)ctas * kThreads, gtid = (long long)blk * kThreads + threadIdx.x;
  const long long range0 = (long long)blk * kWarps * per_warp;
  const int lo = (int)(range0 < n ? range0 : n);
  const int hi = (int)(range0 + (long long)kWarps * per_warp < n ? range0 + (long long)kWarps * per_warp : n);
  const long long piece0 = ((long long)blk * kWarps + warp) * per_warp;
  const int wlo = (int)(piece0 < n ? piece0 : n);
  const int whi = (int)(piece0 + per_warp < n ? piece0 + per_warp : n);
  const unsigned lower = (1u << lane) - 1u;

  // 0. the table's slots empty; this CTA's minimum of each axis
  for (long long s = gtid; s <= (long long)cap_mask; s += gthreads) {
    buf.tkey[s] = kEmpty;
    buf.tfirst[s] = INT_MAX;
  }
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  for (long long i = gtid; i < n; i += gthreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) mn[a] = fminf(mn[a], __ldg(pts + i * 3 + a));  // fminf skips NaN
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float m = warp_min(mn[a]);
    if (lane == 0) red[a][warp] = m;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float m = INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fminf(m, red[threadIdx.x][w]);
    buf.part_min[blk * 3 + threadIdx.x] = m;
  }
  grid.sync();

  // 1. the anchor, then each point's key into the table
  if (warp < 3) {
    float m = INFINITY;
    for (int c = lane; c < ctas; c += 32) m = fminf(m, buf.part_min[c * 3 + warp]);
    m = warp_min(m);
    if (lane == 0) {
      const double low = (double)m < kMinStart ? (double)m : kMinStart;
      minb_s[warp] = __dsub_rn(low, 0.5 * (double)voxel);
    }
  }
  __syncthreads();
  const double minb[3] = {minb_s[0], minb_s[1], minb_s[2]};
  const double vox = (double)voxel;
  for (long long i = gtid; i < n; i += gthreads) {
    unsigned long long key = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double d = __ddiv_rn(__dsub_rn((double)__ldg(pts + i * 3 + a), minb[a]), vox);
      const long long q = (long long)floor(d);
      key = key * kAxis + ((unsigned long long)q & kAxisMask);
    }
    unsigned s = (unsigned)mix(key) & cap_mask;
    while (true) {
      unsigned long long cur = __ldcg(buf.tkey + s);  // a key, once set, never changes
      if (cur == kEmpty) cur = atomicCAS(buf.tkey + s, kEmpty, key);
      if (cur == kEmpty || cur == key) break;
      s = (s + 1) & cap_mask;
    }
    atomicMin(buf.tfirst + s, (int)i);
    buf.slot_of[i] = (int)s;
  }
  grid.sync();

  // 2. the cells this CTA's range opens
  int opened = 0;
  for (int t0 = lo; t0 < hi; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    opened += __syncthreads_count(i < hi && buf.tfirst[buf.slot_of[i]] == i);
  }
  if (threadIdx.x == 0) buf.cta_count[blk] = opened;
  grid.sync();

  // 3. dense cell ids in source order
  if (warp == 0) {
    int before = 0;
    for (int c = lane; c < blk; c += 32) before += buf.cta_count[c];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) before += __shfl_xor_sync(kFull, before, d);
    if (lane == 0) cells_before = before;
  }
  __syncthreads();
  int carry = cells_before;
  for (int t0 = lo; t0 < hi; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    int slot = 0, opens = 0;
    if (i < hi) {
      slot = buf.slot_of[i];
      opens = buf.tfirst[slot] == i;
    }
    int tile;
    const int at = block_scan(opens, warp_sums, &tile);
    if (opens) buf.tcell[slot] = carry + at;
    carry += tile;
  }
  if (blk == ctas - 1 && threadIdx.x == 0) *buf.count = carry;
  grid.sync();

  // 4. stable LSD radix sort of the (cell, source) pairs by cell
  const int slice = (kDigits + ctas - 1) / ctas;
  const int g0 = min(kDigits, blk * slice), g1 = min(kDigits, g0 + slice);
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    const int* kin = buf.key[(p + 1) & 1];
    const int* sin = buf.src[(p + 1) & 1];
    int* kout = buf.key[p & 1];
    int* sout = buf.src[p & 1];
    // A. each warp's digit counts; the warps' exclusive prefix; the CTA's count
    for (int e = threadIdx.x; e < kWarps * kDigits; e += kThreads) (&hist[0][0])[e] = 0;
    __syncthreads();
    for (int s0 = wlo; s0 < whi; s0 += 32) {
      const int j = s0 + lane;
      if (j < whi) {
        const int key = p == 0 ? buf.tcell[buf.slot_of[j]] : kin[j];
        atomicAdd(&hist[warp][(key >> shift) & (kDigits - 1)], 1);
      }
    }
    __syncthreads();
    for (int g = threadIdx.x; g < kDigits; g += kThreads) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = hist[w][g];
        hist[w][g] = run;
        run += c;
      }
      buf.table[g * ctas + blk] = run;
    }
    grid.sync();
    // B. this CTA's slice of the digits: each digit's exclusive prefix over
    // the CTAs (in place), and the slice's exclusive scan of the totals
    int scarry = 0;
    for (int t0 = g0; t0 < g1; t0 += kThreads) {
      const int g = t0 + threadIdx.x;
      int v = 0;
      if (g < g1) {
        int* row = buf.table + g * ctas;
        for (int c0 = 0; c0 < ctas; c0 += kBatch) {
          int t[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) t[u] = c0 + u < ctas ? row[c0 + u] : 0;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (c0 + u < ctas) row[c0 + u] = v;
            v += t[u];
          }
        }
      }
      int tile;
      const int at = block_scan(v, warp_sums, &tile);
      if (g < g1) buf.local[g] = scarry + at;
      scarry += tile;
    }
    if (threadIdx.x == 0) buf.slice_sum[blk] = scarry;
    grid.sync();
    // C. the slices' bases, each digit's first position for this CTA, then
    // each warp places its keys in order from its cursors
    if (warp == 0) {
      int run = 0;
      for (int c0 = 0; c0 < ctas; c0 += 32) {
        const int v = c0 + lane < ctas ? buf.slice_sum[c0 + lane] : 0;
        int x = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        if (c0 + lane < ctas) slice_base[c0 + lane] = run + x - v;
        run += __shfl_sync(kFull, x, 31);
      }
    }
    __syncthreads();
    for (int g = threadIdx.x; g < kDigits; g += kThreads)
      base[g] = slice_base[g / slice] + buf.local[g] + buf.table[g * ctas + blk];
    __syncthreads();
    for (int s0 = wlo; s0 < whi; s0 += 32) {
      const int j = s0 + lane;
      const bool on = j < whi;
      int key = -1, src = 0;
      if (on) {
        key = p == 0 ? buf.tcell[buf.slot_of[j]] : kin[j];
        src = p == 0 ? j : sin[j];
      }
      const int digit = on ? (key >> shift) & (kDigits - 1) : -1;
      const unsigned peers = __match_any_sync(kFull, digit);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (on && lane == leader) {
        at = hist[warp][digit];
        hist[warp][digit] = at + __popc(peers);
        at += base[digit];
      }
      const int pos = __shfl_sync(kFull, at, leader) + __popc(peers & lower);
      if (on) {
        kout[pos] = key;
        sout[pos] = src;
      }
      __syncwarp();  // orders the cursors' updates between steps
    }
    grid.sync();
  }

  // 5. each cell's centroid: the thread at its run's start sums it in order
  const int* skey = buf.key[(passes - 1) & 1];
  const int* ssrc = buf.src[(passes - 1) & 1];
  for (long long j = gtid; j < n; j += gthreads) {
    const int cell = skey[j];
    if (j > 0 && skey[j - 1] == cell) continue;
    double sx = 0.0, sy = 0.0, sz = 0.0;
    int cnt = 0;
    for (long long t = j; t < n; t += kBatch) {
      int kk[kBatch], ss[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = t + u < n;
        kk[u] = in ? skey[t + u] : -1;
        ss[u] = in ? ssrc[t + u] : 0;
      }
      float x[kBatch][3];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int a = 0; a < 3; ++a) x[u][a] = __ldg(pts + (long long)ss[u] * 3 + a);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (kk[u] == cell) {  // the run is a prefix of the batch
          sx = __dadd_rn(sx, (double)x[u][0]);
          sy = __dadd_rn(sy, (double)x[u][1]);
          sz = __dadd_rn(sz, (double)x[u][2]);
          ++cnt;
        }
      }
      if (kk[kBatch - 1] != cell) break;
    }
    const double c = (double)cnt;
    out[(long long)cell * 3 + 0] = __double2float_rn(__ddiv_rn(sx, c));
    out[(long long)cell * 3 + 1] = __double2float_rn(__ddiv_rn(sy, c));
    out[(long long)cell * 3 + 2] = __double2float_rn(__ddiv_rn(sz, c));
  }
}

}  // namespace

// pts (n, 3) float32 on the card; scratch int32 (ops/voxel.py scratch_ints
// sizes it: the count K as an int64 first); out (n, 3) float32, whose first
// K rows the kernel writes, K landing in scratch[0:2] when it ends.  One
// cooperative launch on `stream`.
extern "C" int gn_voxel_downsample(const float* pts, int64_t n, float voxel, int* scratch, int64_t scratch_len,
                                   float* out, void* stream) {
  if (n < 1 || n > (1ll << 28)) return (int)cudaErrorInvalidValue;
  long long cap = 64;
  while (cap < 2 * n) cap <<= 1;
  const long long need = 2 + 4 * cap + 5 * n + 5 * kMaxCtas + (long long)kDigits * kMaxCtas + kDigits;
  if (need > scratch_len) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, voxel_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // every CTA resident for the barriers
  const long long most = (long long)sms * per_sm < kMaxCtas ? (long long)sms * per_sm : kMaxCtas;
  const long long want = (n + kCtaPoints - 1) / kCtaPoints;
  const int ctas = (int)(want < most ? want : most);
  const long long warps = (long long)ctas * kWarps;
  const int per_warp = (int)((n + warps * 32 - 1) / (warps * 32) * 32);
  int bits = 0;
  while ((1ll << bits) < n) ++bits;  // cell ids lie in [0, n)
  const int passes = bits > kDigitBits ? (bits + kDigitBits - 1) / kDigitBits : 1;
  Buffers buf;
  buf.count = reinterpret_cast<long long*>(scratch);
  buf.tkey = reinterpret_cast<unsigned long long*>(scratch + 2);
  buf.tfirst = scratch + 2 + 2 * cap;
  buf.tcell = buf.tfirst + cap;
  buf.slot_of = buf.tcell + cap;
  buf.key[0] = buf.slot_of + n;
  buf.src[0] = buf.key[0] + n;
  buf.key[1] = buf.src[0] + n;
  buf.src[1] = buf.key[1] + n;
  buf.part_min = reinterpret_cast<float*>(buf.src[1] + n);
  buf.cta_count = reinterpret_cast<int*>(buf.part_min + 3 * kMaxCtas);
  buf.table = buf.cta_count + kMaxCtas;
  buf.local = buf.table + kDigits * kMaxCtas;
  buf.slice_sum = buf.local + kDigits;
  int n32 = (int)n, pw = per_warp, ps = passes;
  unsigned mask = (unsigned)(cap - 1);
  void* args[] = {(void*)&pts, &n32, &voxel, &pw, &ps, &mask, &buf, &out};
  return (int)cudaLaunchCooperativeKernel((const void*)voxel_kernel, dim3(ctas), dim3(kThreads), args, 0,
                                          (cudaStream_t)stream);
}
