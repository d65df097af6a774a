// The empty-box count of box post-processing: for each proposal's
// axis-aligned box, the number of its scan's points with lo <= p <= hi on
// every axis (postproc/boxes.py::parse_predictions, votenet's
// remove_empty_box).
//
// No TPU kernel: the JAX package has no box post-processing (VoteNet and
// Group-Free-3D run on the port only).  The plain version
// (ops/cuda/boxes.py::points_in_boxes) broadcasts every point against every
// box and sums six ANDed bool masks of B x P x N bytes: at Group-Free-3D's
// 8 scans x 512 boxes x 50,000 points that is ~1 GB of temporaries through
// device memory for 205 M tests, in ~12 launches a chunk.
//
// What bounds it: the tests, 6 float compares a (box, point) pair on the
// CUDA cores (~18 us at Group-Free-3D's shape at 67 TFLOP/s); the bytes are
// the points (16 B each, 0.8 MB a scan) and 24 B a box, a few MB (~2 us),
// and a scan's points stay in L2 for every tile of boxes.  The design
// keeps every mask out of memory:
//   * a block takes one scan, a tile of up to kTile boxes (their lo and hi
//     staged in shared memory as float4s, read as broadcasts) and a slice
//     of the scan's points, kStep points at a time;
//   * a thread holds kPoints of those points in registers (read in place
//     with the rows' stride: the pipeline's x[..., :3] of xyz + height
//     rows needs no copy; each point's loads serve kTile boxes) and tests
//     them against each box of the tile with the plain version's
//     comparisons, x >= lo && x <= hi on each axis, so a NaN on either
//     side is outside;
//   * a warp's 32 results for a box become one count by __ballot_sync and
//     __popc, which the lane that owns the box (box % 32) adds to a
//     register counter;
//   * at the end the warps' counters meet in shared memory and one integer
//     atomicAdd a box a block adds the block's count to the output, which
//     the wrapper zeroes.  Integer sums are exact in any order, so the
//     counts are the plain version's, bitwise, run after run.
// Any B, P, N: a ragged tile stops at its last box, a point past N is
// outside.  A slice is kSliceSteps steps, whatever the shape: timed at both
// detection cells' shapes on an H100, 1, 2 or 3 steps a block (1.2 to 6
// cards' worth of blocks) were within ~1% of each other, and 16-byte point
// loads, 32-box tiles, 1 or 4 points a thread and other unrollings were no
// faster.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kPoints = 2;                  // points a thread tests at once
constexpr int kStep = kThreads * kPoints;   // points a block tests at once (ops/cuda/boxes.py::STEP)
constexpr int kGroups = 2;                  // boxes a lane counts for: box % 32 == lane in each group
constexpr int kTile = kGroups * 32;         // boxes a block (ops/cuda/boxes.py::TILE)
constexpr int kSliceSteps = 2;              // steps a block: its slice is kSliceSteps * kStep points

__global__ void __launch_bounds__(kThreads)
box_count_kernel(const float* __restrict__ pts, int64_t p_sb, int64_t p_sn, const float* __restrict__ lo,
                 int64_t lo_sb, int64_t lo_sp, const float* __restrict__ hi, int64_t hi_sb, int64_t hi_sp, int n,
                 int p, unsigned long long* __restrict__ out) {
  __shared__ float4 s_lo[kTile], s_hi[kTile];
  __shared__ int s_count[kWarps][kTile];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z;
  const int box0 = blockIdx.y * kTile;
  const int nb = min(kTile, p - box0);
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const float* l = lo + b * lo_sb + (int64_t)(box0 + j) * lo_sp;
    const float* h = hi + b * hi_sb + (int64_t)(box0 + j) * hi_sp;
    s_lo[j] = make_float4(l[0], l[1], l[2], 0.0f);
    s_hi[j] = make_float4(h[0], h[1], h[2], 0.0f);
  }
  __syncthreads();

  int acc[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) acc[g] = 0;
  const float* scan = pts + b * p_sb;
  const int64_t start = (int64_t)blockIdx.x * kSliceSteps * kStep;
  for (int s = 0; s < kSliceSteps; ++s) {
    const int64_t first = start + (int64_t)s * kStep;
    if (first >= n) break;
    float x[kPoints], y[kPoints], z[kPoints];
    bool live[kPoints];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const int64_t i = first + k * kThreads + threadIdx.x;
      live[k] = i < n;
      x[k] = y[k] = z[k] = 0.0f;
      if (live[k]) {
        const float* q = scan + i * p_sn;
        x[k] = __ldg(q), y[k] = __ldg(q + 1), z[k] = __ldg(q + 2);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int j = g * 32 + jj;
        if (j >= nb) break;  // the same for the whole block
        const float4 l = s_lo[j], h = s_hi[j];
        int c = 0;
#pragma unroll
        for (int k = 0; k < kPoints; ++k) {
          const bool inside = live[k] && x[k] >= l.x && x[k] <= h.x && y[k] >= l.y && y[k] <= h.y &&
                              z[k] >= l.z && z[k] <= h.z;
          c += __popc(__ballot_sync(full, inside));
        }
        if (lane == jj) acc[g] += c;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kGroups; ++g) s_count[warp][g * 32 + lane] = acc[g];
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_count[w][j];
    if (sum != 0) atomicAdd(out + b * p + box0 + j, (unsigned long long)sum);
  }
}

}  // namespace

// out (batch, p) int64, zeroed by the caller, += the count of points
// pts[b, i, :3] (row stride p_sn, batch stride p_sb, in floats) inside each
// box lo[b, j] .. hi[b, j]; kTile boxes a block, the points of a scan split
// into slices of kSliceSteps * kStep points.
extern "C" int gn_box_count(const float* pts, int64_t p_sb, int64_t p_sn, const float* lo, int64_t lo_sb,
                            int64_t lo_sp, const float* hi, int64_t hi_sb, int64_t hi_sp, int batch, int n, int p,
                            int64_t* out, void* stream) {
  if (batch < 0 || n < 0 || p < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || p == 0 || n == 0) return (int)cudaSuccess;
  const int64_t slices = ((int64_t)n + kSliceSteps * kStep - 1) / (kSliceSteps * kStep);
  const int64_t tiles = ((int64_t)p + kTile - 1) / kTile;
  if (batch > 65535 || tiles > 65535) return (int)cudaErrorInvalidValue;
  box_count_kernel<<<dim3((unsigned)slices, (unsigned)tiles, (unsigned)batch), kThreads, 0, (cudaStream_t)stream>>>(
      pts, p_sb, p_sn, lo, lo_sb, lo_sp, hi, hi_sb, hi_sp, n, p, reinterpret_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
