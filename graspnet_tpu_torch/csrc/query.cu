// First-ns ball query with first-hit padding.
//
// Replaces graspnet_tpu/ops/pallas/query.py::ball_query_pallas (K4), i.e.
// multi_query_batched_pallas(rotate=False) followed by
// _apply_first_hit_padding: for each center, the indices of the first ns
// points with dx*dx+dy*dy+dz*dz < r*r in index order; an empty slot takes
// the first hit and a center with no hits gets index 0 everywhere.
//
// What bounds it on an H100: the membership tests, a few FLOPs per point
// tested, and the scan stops at the ns-th hit.  On the main path (SA2-4:
// 2048 -> 1024 centers r 0.1 ns 32, 1024 -> 512 r 0.2 ns 16,
// 512 -> 256 r 0.3 ns 16) the whole work is well under a microsecond of
// arithmetic and a few hundred KB of traffic, so launch latency dominates.
//
// Design: one warp per center scans the points 32 at a time in index
// order; __ballot_sync/__popc give each hit its slot, and the warp stops as
// soon as ns hits are found.  The first hit is tracked in registers, so the
// padding needs no read-back.  d2 is computed with __fmul_rn/__fadd_rn in
// the JAX operation order (ops/pallas/query.py:465-475), so no FMA
// contraction moves a point across the radius: the indices equal the plain
// version's exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers,
                  int64_t* __restrict__ out, int batch, int n, int m, float r2,
                  int ns) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= batch * m) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  const float* pts = xyz + (size_t)(q / m) * n * 3;
  const float cx = centers[3 * (size_t)q];
  const float cy = centers[3 * (size_t)q + 1];
  const float cz = centers[3 * (size_t)q + 2];
  int64_t* o = out + (size_t)q * ns;

  int count = 0;
  int first = 0;
  for (int base = 0; base < n && count < ns; base += 32) {
    const int p = base + lane;
    bool hit = false;
    if (p < n) {
      const float dx = __fsub_rn(__ldg(pts + 3 * p), cx);
      const float dy = __fsub_rn(__ldg(pts + 3 * p + 1), cy);
      const float dz = __fsub_rn(__ldg(pts + 3 * p + 2), cz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (bal == 0) continue;
    if (count == 0) first = base + __ffs(bal) - 1;
    if (hit) {
      const int pos = count + __popc(bal & ((1u << lane) - 1u));
      if (pos < ns) o[pos] = p;
    }
    count += __popc(bal);
  }
  const int pad_from = count < ns ? count : ns;
  for (int s = pad_from + lane; s < ns; s += 32) o[s] = first;
}

}  // namespace

extern "C" int gn_ball_query(const float* xyz, const float* centers,
                             int64_t* out, int batch, int n, int m, float r2,
                             int ns, void* stream) {
  const int queries = batch * m;
  const int blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      xyz, centers, out, batch, n, m, r2, ns);
  return (int)cudaGetLastError();
}
