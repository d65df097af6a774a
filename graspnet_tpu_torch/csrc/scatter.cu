// Deterministic row scatter-add: the backward of the port's differentiable
// row gathers (ops/scatter.py: gather_points, group_points,
// three_interpolate).
//
// No TPU kernel: the JAX package's scatter_add_rows
// (graspnet_tpu/ops/scatter.py:28) is plain XLA, one-hot matmuls that
// replace the TPU's near-serial scatter.  Its job here is another: torch's
// own gather backward on CUDA adds with float atomics, and the ball
// query's first-hit padding and three-NN's shared neighbours make the
// indices collide, so the order of the sums, and the step's result, change
// from run to run.
//
// out[r] = sum over the positions s of row r's segment, in order, of
// g[perm[s]]: the wrapper sorts the flattened keys (batch * n + index)
// once, stably, so a row's segment lists its source rows in ascending
// order, and `starts` (rows + 1 entries) bounds each segment.  One warp per
// output row, lanes over channels (kV values a lane, 32 x kV channels a
// pass), each sum started at 0.0f and taken in segment order with __fadd_rn:
// bitwise the sequential index_add_ of the plain version on the CPU, and
// the same from run to run.  A segment is a chain of dependent adds, but its
// loads are not: a warp starts kUnroll source rows' loads, then adds them in
// order, so the longest segments (~200 rows at SA2-4 of a B=2 step) wait on
// memory kUnroll times less.  Padding a lane's loads with 0.0f past the
// channels adds nothing that is stored.
//
// What bounds it on an H100: bytes.  Each source row is read once (g, then
// perm and starts) and each output row written once; at SA2 of a B=2
// training step that is 2 x 32768 x 128 x 4 B of g, ~34 MB, ~10 us at
// 3.35 TB/s.  A warp reads a source row as 32 x kV consecutive floats.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;   // output rows a block
constexpr int kUnroll = 8;  // source rows a warp loads before it adds them

template <int kV>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const float* __restrict__ g, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ starts, float* __restrict__ out,
                   int64_t rows, int c) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t s0 = starts[row], s1 = starts[row + 1];
  for (int c0 = 0; c0 < c; c0 += 32 * kV) {
    float acc[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[v] = 0.0f;
    int64_t s = s0;
    // kUnroll source rows in flight at once, added in segment order
    for (; s + kUnroll <= s1; s += kUnroll) {
      float x[kUnroll][kV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* src = g + __ldg(perm + s + u) * (int64_t)c;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int ch = c0 + v * 32 + lane;
          x[u][v] = ch < c ? __ldg(src + ch) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int v = 0; v < kV; ++v) acc[v] = __fadd_rn(acc[v], x[u][v]);
      }
    }
    for (; s < s1; ++s) {
      const float* src = g + __ldg(perm + s) * (int64_t)c;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int ch = c0 + v * 32 + lane;
        if (ch < c) acc[v] = __fadd_rn(acc[v], __ldg(src + ch));
      }
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int ch = c0 + v * 32 + lane;
      if (ch < c) out[row * (int64_t)c + ch] = acc[v];
    }
  }
}

template <int kV>
cudaError_t launch(const float* g, const int64_t* perm, const int64_t* starts, float* out,
                   int64_t rows, int c, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  segment_sum_kernel<kV><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(g, perm, starts, out, rows, c);
  return cudaGetLastError();
}

}  // namespace

// g (K, C) float32 source rows; perm (K) int64 source row of each sorted
// position; starts (rows + 1) int64 segment bounds; out (rows, C) float32.
extern "C" int gn_scatter_add_rows(const float* g, const int64_t* perm, const int64_t* starts,
                                   float* out, int64_t rows, int c, void* stream) {
  if (rows < 0 || c < 1 || (rows + kWarps - 1) / kWarps > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (c <= 32) return (int)launch<1>(g, perm, starts, out, rows, c, s);
  if (c <= 64) return (int)launch<2>(g, perm, starts, out, rows, c, s);
  if (c <= 128) return (int)launch<4>(g, perm, starts, out, rows, c, s);
  return (int)launch<8>(g, perm, starts, out, rows, c, s);
}
