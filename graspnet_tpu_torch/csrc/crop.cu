// Fused crop: query + first-hits gather + frame transform + BN-folded MLP +
// max over samples, one block per center.
//
// Replaces graspnet_tpu/ops/pallas/crop.py::crop_fused_pallas (K5, the
// inference CloudCrop; body _crop_kernel over _gather_grouped_core) and
// sa1_fused_pallas (K3, which is crop_fused_pallas(ball=True,
// normalize=1/r)).  Per center:
//   1. the query masks: cylinder mode y_r^2+z_r^2 < r^2 and
//      hmin < x_r < hmax_d for every depth d, with the transposed rotation
//      x_r = dx*R00 + dy*R10 + dz*R20; ball mode dx^2+dy^2+dz^2 < r^2;
//   2. the first ns hits per depth, in index order;
//   3. padding on the raw coordinates: an empty slot takes the first hit,
//      a selection with no hits takes point 0 (crop.py:145-157);
//   4. centre subtraction, then offset @ R (cylinder) and * normalize;
//   5. the folded MLP relu(x @ W' + b') three times (3 -> c1 -> c2 -> c3);
//   6. the max over the ns samples -> out[center, d, :].
//
// What bounds it on an H100: the MLP's f32 FMAs.  Per frame the crop runs
// 1024 x 4 x 64 rows through 3 -> 64 -> 128 -> 256 (about 21.6 GFLOP) and
// SA1 2048 x 64 rows through 3 -> 64 -> 64 -> 128 (about 3.3 GFLOP); the
// scans test 20.5 M and 41 M point-center pairs.  This first version runs
// the MLP on the CUDA cores in f32 (no tensor cores), so it is far from
// the f32 peak; wgmma is later work.
//
// Design: the folded crop weights are ~41k floats (165 KB); beside them a
// 256-row x 128 activation tile (128 KB) would not fit in 227 KB of shared
// memory.  So the weights stay in device memory (read through L1/L2, every
// block reads the same 165 KB) and the rows go one depth (ns <= 64 rows) at a
// time: h1 (64 x c1) and h2 (64 x c2) tiles in shared memory, and the last
// layer is reduced to a running max in registers, so h3 never exists.
// The scan uses 8 warps over 256 consecutive points per round; per depth a
// ballot gives each hit its slot after the hits of lower warps.  The mask
// arithmetic uses __fmul_rn/__fadd_rn in the JAX order (crop.py:109-125),
// so no FMA contraction moves a point across a boundary.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSamples = 64;
constexpr int kMaxDepths = 8;
constexpr int kRows = 32;  // rows per register tile

struct CropArgs {
  int n, m, ndepth, ns, ball, c1, c2, c3;
  float r2, hmin, normalize;
  float hmax[kMaxDepths];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// offset @ R for one output axis: dx*R[col] + dy*R[3+col] + dz*R[6+col]
__device__ __forceinline__ float rot_axis(float dx, float dy, float dz,
                                          const float* r, int col) {
  return add(add(mul(dx, r[col]), mul(dy, r[3 + col])), mul(dz, r[6 + col]));
}

__global__ void __launch_bounds__(kThreads)
crop_fused_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers,
                  const float* __restrict__ rot,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out, CropArgs a) {
  extern __shared__ float smem[];
  float* h1 = smem;                         // kMaxSamples x c1
  float* h2 = h1 + kMaxSamples * a.c1;      // kMaxSamples x c2
  float* samples = h2 + kMaxSamples * a.c2; // kMaxSamples x 3
  __shared__ int s_idx[kMaxDepths][kMaxSamples];
  __shared__ int s_cnt[kMaxDepths];
  __shared__ int s_wcnt[kWarps][kMaxDepths];

  const int q = blockIdx.x;  // center index over batch * m
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + (size_t)(q / a.m) * a.n * 3;
  const float cx = centers[3 * (size_t)q];
  const float cy = centers[3 * (size_t)q + 1];
  const float cz = centers[3 * (size_t)q + 2];
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = a.ball ? 0.0f : rot[9 * (size_t)q + i];

  if (tid < kMaxDepths) s_cnt[tid] = 0;
  __syncthreads();

  // ---- 1-2: masks and the first ns hits per depth, in index order ----
  for (int base = 0; base < a.n; base += kThreads) {
    const int p = base + tid;
    unsigned hits = 0;
    if (p < a.n) {
      const float dx = __fsub_rn(__ldg(pts + 3 * p), cx);
      const float dy = __fsub_rn(__ldg(pts + 3 * p + 1), cy);
      const float dz = __fsub_rn(__ldg(pts + 3 * p + 2), cz);
      if (a.ball) {
        const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
        hits = d2 < a.r2 ? 1u : 0u;
      } else {
        const float xr = rot_axis(dx, dy, dz, r, 0);
        const float yr = rot_axis(dx, dy, dz, r, 1);
        const float zr = rot_axis(dx, dy, dz, r, 2);
        const float yz2 = add(mul(yr, yr), mul(zr, zr));
        if (yz2 < a.r2 && xr > a.hmin) {
#pragma unroll
          for (int d = 0; d < kMaxDepths; ++d) {
            if (d < a.ndepth && xr < a.hmax[d]) hits |= 1u << d;
          }
        }
      }
    }
    unsigned bal[kMaxDepths];
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      bal[d] = 0;
      if (d < a.ndepth) {
        bal[d] = __ballot_sync(0xffffffffu, (hits >> d) & 1u);
        if (lane == 0) s_wcnt[warp][d] = __popc(bal[d]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      if (d < a.ndepth && ((hits >> d) & 1u)) {
        int pos = s_cnt[d] + __popc(bal[d] & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) pos += s_wcnt[w][d];
        if (pos < a.ns) s_idx[d][pos] = p;
      }
    }
    __syncthreads();
    if (tid < a.ndepth) {
      int total = s_cnt[tid];
      for (int w = 0; w < kWarps; ++w) total += s_wcnt[w][tid];
      s_cnt[tid] = total;
    }
    __syncthreads();
    bool done = true;
    for (int d = 0; d < a.ndepth; ++d) done = done && s_cnt[d] >= a.ns;
    if (done) break;
  }

  for (int d = 0; d < a.ndepth; ++d) {
    // ---- 3-4: padded raw coordinates -> offsets in the crop frame ----
    if (tid < a.ns) {
      const int cnt = s_cnt[d];
      const int idx = cnt == 0 ? 0 : (tid < cnt ? s_idx[d][tid] : s_idx[d][0]);
      const float dx = __fsub_rn(pts[3 * idx], cx);
      const float dy = __fsub_rn(pts[3 * idx + 1], cy);
      const float dz = __fsub_rn(pts[3 * idx + 2], cz);
      float sx = dx, sy = dy, sz = dz;
      if (!a.ball) {
        sx = rot_axis(dx, dy, dz, r, 0);
        sy = rot_axis(dx, dy, dz, r, 1);
        sz = rot_axis(dx, dy, dz, r, 2);
      }
      if (a.normalize != 1.0f) {
        sx = mul(sx, a.normalize);
        sy = mul(sy, a.normalize);
        sz = mul(sz, a.normalize);
      }
      samples[3 * tid] = sx;
      samples[3 * tid + 1] = sy;
      samples[3 * tid + 2] = sz;
    }
    __syncthreads();

    // ---- 5a: layer 1 (K = 3) as a broadcast-sum ----
    for (int e = tid; e < a.ns * a.c1; e += kThreads) {
      const int row = e / a.c1, c = e - row * a.c1;
      const float v = samples[3 * row] * w1[c] + samples[3 * row + 1] * w1[a.c1 + c] +
                      samples[3 * row + 2] * w1[2 * a.c1 + c] + b1[c];
      h1[row * a.c1 + c] = fmaxf(v, 0.0f);
    }
    __syncthreads();

    // ---- 5b: layer 2, h2 = relu(h1 @ W2 + b2); thread = (column, row group)
    {
      const int groups = kThreads / a.c2;  // c2 divides kThreads (checked)
      const int c = tid % a.c2;
      const int g = tid / a.c2;
      for (int r0 = g; r0 < a.ns; r0 += groups * kRows) {
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
        for (int k = 0; k < a.c1; k += 4) {
          const float wa = __ldg(w2 + (size_t)k * a.c2 + c);
          const float wb = __ldg(w2 + (size_t)(k + 1) * a.c2 + c);
          const float wc = __ldg(w2 + (size_t)(k + 2) * a.c2 + c);
          const float wd = __ldg(w2 + (size_t)(k + 3) * a.c2 + c);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int row = r0 + i * groups;
            if (row < a.ns) {
              const float4 h = *reinterpret_cast<const float4*>(h1 + row * a.c1 + k);
              acc[i] += h.x * wa + h.y * wb + h.z * wc + h.w * wd;
            }
          }
        }
        const float bias = __ldg(b2 + c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = r0 + i * groups;
          if (row < a.ns) h2[row * a.c2 + c] = fmaxf(acc[i] + bias, 0.0f);
        }
      }
    }
    __syncthreads();

    // ---- 5c-6: layer 3 folded into the max over samples ----
    for (int c = tid; c < a.c3; c += kThreads) {
      const float bias = __ldg(b3 + c);
      float best = 0.0f;  // every candidate is a relu output, so >= 0
      for (int r0 = 0; r0 < a.ns; r0 += kRows) {
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
        for (int k = 0; k < a.c2; k += 4) {
          const float wa = __ldg(w3 + (size_t)k * a.c3 + c);
          const float wb = __ldg(w3 + (size_t)(k + 1) * a.c3 + c);
          const float wc = __ldg(w3 + (size_t)(k + 2) * a.c3 + c);
          const float wd = __ldg(w3 + (size_t)(k + 3) * a.c3 + c);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (r0 + i < a.ns) {
              const float4 h = *reinterpret_cast<const float4*>(h2 + (r0 + i) * a.c2 + k);
              acc[i] += h.x * wa + h.y * wb + h.z * wc + h.w * wd;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (r0 + i < a.ns) best = fmaxf(best, fmaxf(acc[i] + bias, 0.0f));
        }
      }
      out[((size_t)q * a.ndepth + d) * a.c3 + c] = best;
    }
    __syncthreads();  // samples/h1/h2 are rewritten by the next depth
  }
}

}  // namespace

extern "C" int gn_crop_fused(const float* xyz, const float* centers,
                             const float* rot, const float* w1, const float* b1,
                             const float* w2, const float* b2, const float* w3,
                             const float* b3, float* out, int batch, int n,
                             int m, int ns, int ball, float r2, float hmin,
                             const float* hmax, int ndepth, float normalize,
                             int c1, int c2, int c3, void* stream) {
  if (ns < 1 || ns > kMaxSamples || ndepth < 1 || ndepth > kMaxDepths ||
      c1 % 4 != 0 || c2 % 4 != 0 || c2 > kThreads || kThreads % c2 != 0 ||
      (!ball && rot == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CropArgs a;
  a.n = n;
  a.m = m;
  a.ndepth = ndepth;
  a.ns = ns;
  a.ball = ball;
  a.c1 = c1;
  a.c2 = c2;
  a.c3 = c3;
  a.r2 = r2;
  a.hmin = hmin;
  a.normalize = normalize;
  for (int d = 0; d < kMaxDepths; ++d) a.hmax[d] = d < ndepth ? hmax[d] : 0.0f;
  const size_t smem = (size_t)kMaxSamples * (c1 + c2 + 3) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      crop_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch * m == 0) return (int)cudaSuccess;
  crop_fused_kernel<<<batch * m, kThreads, smem, (cudaStream_t)stream>>>(
      xyz, centers, rot, w1, b1, w2, b2, w3, b3, out, a);
  return (int)cudaGetLastError();
}
