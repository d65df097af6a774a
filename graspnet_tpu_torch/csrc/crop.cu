// Fused crop: query + first-hits gather + frame transform + BN-folded MLP +
// max over samples, one block per center; and the crop group, the same
// front half writing the offsets instead of running the MLP.
//
// Replaces graspnet_tpu/ops/pallas/crop.py::crop_fused_pallas (K5, the
// inference CloudCrop; body _crop_kernel over _gather_grouped_core),
// sa1_fused_pallas (K3, which is crop_fused_pallas(ball=True,
// normalize=1/r)) and crop_group_pallas (K6, the training crop's front half,
// body _crop_group_kernel over the same _gather_grouped_core).  Per center:
//   1. the query masks: cylinder mode y_r^2+z_r^2 < r^2 and
//      hmin < x_r < hmax_d for every depth d, with the transposed rotation
//      x_r = dx*R00 + dy*R10 + dz*R20; ball mode dx^2+dy^2+dz^2 < r^2;
//   2. the first ns hits per depth, in index order;
//   3. padding on the raw coordinates: an empty slot takes the first hit,
//      a selection with no hits takes point 0 (crop.py:145-157);
//   4. centre subtraction, then offset @ R (cylinder) and * normalize;
//   5. the folded MLP relu(x @ W' + b') three times (3 -> c1 -> c2 -> c3);
//   6. the max over the ns samples -> out[center, d, :].
// crop_group_kernel stops after step 4 and writes the (D, ns, 3) offsets.
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
//
// The crop group is bound by its scan: 41 M point tests per training step
// (B=2, 1024 label points, 20000 points) against 6.3 MB of output, so it
// shares the fused kernel's scan (scan_first_hits) and sample transform
// (crop_sample) unchanged; its indices are those of the fused kernel.
//
// sa_feat_kernel replaces crop.py::sa_feat_fused_pallas (K9, body
// _sa_feat_kernel, crop.py:448-519), the fused SA2-4 eval stage: the same
// ball-mode scan and samples (offsets x (1/r), as crop.py:491-493 scales
// them; a center with no hits takes point 0's offset and features), then
// the slots' feature rows gathered straight from features[b, idx] into
// shared memory, and layer 1 over [xyz | features] (3 + C inputs), layer 2
// and layer 3 + max as in the crop.  What bounds it: the MLP's f32 FMAs,
// per B=1 frame ~4.3 GFLOP at SA2 (1024 x 32 rows, 131 -> 128 -> 128 -> 256),
// ~1.35 at SA3 and ~0.67 at SA4 (~0.1 ms at the f32 peak).  The folded
// weights (66k-82k floats, 264-329 KB) do not fit in shared memory, so they
// stream through L1/L2 as the crop's do; the ns <= 32 rows of a centre
// (features, h1, h2: at most 50 KB) sit in shared memory, so several blocks
// share an SM.

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

// Steps 1-2 for one center: s_idx[d][0..ns) and s_cnt[d] (the full hit
// count, which may exceed ns) for every depth, in index order.  Called by
// all kThreads threads of the block.
__device__ __forceinline__ void scan_first_hits(
    const float* __restrict__ pts, float cx, float cy, float cz,
    const float* r, const CropArgs& a, int (*s_idx)[kMaxSamples], int* s_cnt,
    int (*s_wcnt)[kMaxDepths]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kMaxDepths) s_cnt[tid] = 0;
  __syncthreads();
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
}

// Step 3: the point a slot takes; an empty slot takes the first hit, a
// selection with no hits point 0.
__device__ __forceinline__ int slot_index(const int* idx_d, int cnt, int slot) {
  return cnt == 0 ? 0 : (slot < cnt ? idx_d[slot] : idx_d[0]);
}

// Steps 3-4 for one slot of one depth: the padded raw point, centre
// subtracted, rotated (cylinder) and scaled.
__device__ __forceinline__ void crop_sample(
    const float* __restrict__ pts, float cx, float cy, float cz, const float* r,
    const CropArgs& a, const int* idx_d, int cnt, int slot, float* out3) {
  const int idx = slot_index(idx_d, cnt, slot);
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
  out3[0] = sx;
  out3[1] = sy;
  out3[2] = sz;
}

// out[row * c + col] = relu(in[row, 0:k] . w[0:k, col] + b[col] (+ the xyz
// part x3[row, 0:3] . wx[0:3, col] when x3 is given)) for every row < ns;
// in has row stride k.  Thread = (column, row group): c divides kThreads
// and k is a multiple of 4 (checked by the launchers).
__device__ __forceinline__ void dense_relu_rows(
    const float* in, int k_dim, const float* __restrict__ w,
    const float* __restrict__ b, float* out, int c, int ns, const float* x3,
    const float* __restrict__ wx) {
  const int groups = kThreads / c;
  const int col = threadIdx.x % c;
  const int g = threadIdx.x / c;
  for (int r0 = g; r0 < ns; r0 += groups * kRows) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
    for (int k = 0; k < k_dim; k += 4) {
      const float wa = __ldg(w + (size_t)k * c + col);
      const float wb = __ldg(w + (size_t)(k + 1) * c + col);
      const float wc = __ldg(w + (size_t)(k + 2) * c + col);
      const float wd = __ldg(w + (size_t)(k + 3) * c + col);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = r0 + i * groups;
        if (row < ns) {
          const float4 h = *reinterpret_cast<const float4*>(in + row * k_dim + k);
          acc[i] += h.x * wa + h.y * wb + h.z * wc + h.w * wd;
        }
      }
    }
    const float bias = __ldg(b + col);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = r0 + i * groups;
      if (row < ns) {
        float v = acc[i] + bias;
        if (x3 != nullptr) {
          v += x3[3 * row] * __ldg(wx + col) + x3[3 * row + 1] * __ldg(wx + c + col) +
               x3[3 * row + 2] * __ldg(wx + 2 * c + col);
        }
        out[row * c + col] = fmaxf(v, 0.0f);
      }
    }
  }
}

// out[col] = max over rows < ns of relu(in[row, 0:k] . w[0:k, col] + b[col]):
// the last layer folded into the pool, so its activations never exist.
__device__ __forceinline__ void dense_relu_max(
    const float* in, int k_dim, const float* __restrict__ w,
    const float* __restrict__ b, int c, int ns, float* __restrict__ out) {
  for (int col = threadIdx.x; col < c; col += kThreads) {
    const float bias = __ldg(b + col);
    float best = 0.0f;  // every candidate is a relu output, so >= 0
    for (int r0 = 0; r0 < ns; r0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
      for (int k = 0; k < k_dim; k += 4) {
        const float wa = __ldg(w + (size_t)k * c + col);
        const float wb = __ldg(w + (size_t)(k + 1) * c + col);
        const float wc = __ldg(w + (size_t)(k + 2) * c + col);
        const float wd = __ldg(w + (size_t)(k + 3) * c + col);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (r0 + i < ns) {
            const float4 h = *reinterpret_cast<const float4*>(in + (r0 + i) * k_dim + k);
            acc[i] += h.x * wa + h.y * wb + h.z * wc + h.w * wd;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (r0 + i < ns) best = fmaxf(best, fmaxf(acc[i] + bias, 0.0f));
      }
    }
    out[col] = best;
  }
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
  const float* pts = xyz + (size_t)(q / a.m) * a.n * 3;
  const float cx = centers[3 * (size_t)q];
  const float cy = centers[3 * (size_t)q + 1];
  const float cz = centers[3 * (size_t)q + 2];
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = a.ball ? 0.0f : rot[9 * (size_t)q + i];

  // ---- 1-2: masks and the first ns hits per depth, in index order ----
  scan_first_hits(pts, cx, cy, cz, r, a, s_idx, s_cnt, s_wcnt);

  for (int d = 0; d < a.ndepth; ++d) {
    // ---- 3-4: padded raw coordinates -> offsets in the crop frame ----
    if (tid < a.ns) crop_sample(pts, cx, cy, cz, r, a, s_idx[d], s_cnt[d], tid, samples + 3 * tid);
    __syncthreads();

    // ---- 5a: layer 1 (K = 3) as a broadcast-sum ----
    for (int e = tid; e < a.ns * a.c1; e += kThreads) {
      const int row = e / a.c1, c = e - row * a.c1;
      const float v = samples[3 * row] * w1[c] + samples[3 * row + 1] * w1[a.c1 + c] +
                      samples[3 * row + 2] * w1[2 * a.c1 + c] + b1[c];
      h1[row * a.c1 + c] = fmaxf(v, 0.0f);
    }
    __syncthreads();

    // ---- 5b: layer 2, h2 = relu(h1 @ W2 + b2) ----
    dense_relu_rows(h1, a.c1, w2, b2, h2, a.c2, a.ns, nullptr, nullptr);
    __syncthreads();

    // ---- 5c-6: layer 3 folded into the max over samples ----
    dense_relu_max(h2, a.c2, w3, b3, a.c3, a.ns, out + ((size_t)q * a.ndepth + d) * a.c3);
    __syncthreads();  // samples/h1/h2 are rewritten by the next depth
  }
}

// The crop group (K6): steps 1-4 only; out[center, d, slot, 0..3).
__global__ void __launch_bounds__(kThreads)
crop_group_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers,
                  const float* __restrict__ rot,
                  float* __restrict__ out, CropArgs a) {
  __shared__ int s_idx[kMaxDepths][kMaxSamples];
  __shared__ int s_cnt[kMaxDepths];
  __shared__ int s_wcnt[kWarps][kMaxDepths];

  const int q = blockIdx.x;  // center index over batch * m
  const int tid = threadIdx.x;
  const float* pts = xyz + (size_t)(q / a.m) * a.n * 3;
  const float cx = centers[3 * (size_t)q];
  const float cy = centers[3 * (size_t)q + 1];
  const float cz = centers[3 * (size_t)q + 2];
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = a.ball ? 0.0f : rot[9 * (size_t)q + i];

  scan_first_hits(pts, cx, cy, cz, r, a, s_idx, s_cnt, s_wcnt);

  for (int e = tid; e < a.ndepth * a.ns; e += kThreads) {
    const int d = e / a.ns;
    const int slot = e - d * a.ns;
    crop_sample(pts, cx, cy, cz, r, a, s_idx[d], s_cnt[d], slot,
                out + ((size_t)q * a.ndepth * a.ns + e) * 3);
  }
}

// The fused SA2-4 stage (K9): ball-mode steps 1-4 with normalize = 1/r,
// the slots' feature rows gathered beside the offsets, then the folded
// (3 + C) -> c1 -> c2 -> c3 MLP and the max.  out[center, 0..c3).
__global__ void __launch_bounds__(kThreads)
sa_feat_kernel(const float* __restrict__ xyz,
               const float* __restrict__ centers,
               const float* __restrict__ feat,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ w3, const float* __restrict__ b3,
               float* __restrict__ out, CropArgs a, int c_in) {
  extern __shared__ float smem[];
  float* f = smem;                         // ns x c_in gathered features
  float* h1 = f + a.ns * c_in;             // ns x c1
  float* h2 = h1 + a.ns * a.c1;            // ns x c2
  float* samples = h2 + a.ns * a.c2;       // ns x 3 scaled offsets
  __shared__ int s_idx[kMaxDepths][kMaxSamples];
  __shared__ int s_cnt[kMaxDepths];
  __shared__ int s_wcnt[kWarps][kMaxDepths];

  const int q = blockIdx.x;  // center index over batch * m
  const int tid = threadIdx.x;
  const size_t scene = (size_t)(q / a.m) * a.n;
  const float* pts = xyz + scene * 3;
  const float* fts = feat + scene * c_in;
  const float cx = centers[3 * (size_t)q];
  const float cy = centers[3 * (size_t)q + 1];
  const float cz = centers[3 * (size_t)q + 2];
  const float r[9] = {};

  scan_first_hits(pts, cx, cy, cz, r, a, s_idx, s_cnt, s_wcnt);

  if (tid < a.ns) crop_sample(pts, cx, cy, cz, r, a, s_idx[0], s_cnt[0], tid, samples + 3 * tid);
  for (int e = tid; e < a.ns * c_in; e += kThreads) {
    const int row = e / c_in;
    f[e] = fts[(size_t)slot_index(s_idx[0], s_cnt[0], row) * c_in + (e - row * c_in)];
  }
  __syncthreads();
  // layer 1: the feature part as a product against W1[3:], the xyz part
  // (K = 3) as a broadcast-sum against W1[0:3]
  dense_relu_rows(f, c_in, w1 + 3 * (size_t)a.c1, b1, h1, a.c1, a.ns, samples, w1);
  __syncthreads();
  dense_relu_rows(h1, a.c1, w2, b2, h2, a.c2, a.ns, nullptr, nullptr);
  __syncthreads();
  dense_relu_max(h2, a.c2, w3, b3, a.c3, a.ns, out + (size_t)q * a.c3);
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

extern "C" int gn_crop_group(const float* xyz, const float* centers,
                             const float* rot, float* out, int batch, int n,
                             int m, int ns, float r2, float hmin,
                             const float* hmax, int ndepth, void* stream) {
  if (ns < 1 || ns > kMaxSamples || ndepth < 1 || ndepth > kMaxDepths) {
    return (int)cudaErrorInvalidValue;
  }
  CropArgs a = {};
  a.n = n;
  a.m = m;
  a.ndepth = ndepth;
  a.ns = ns;
  a.ball = 0;
  a.r2 = r2;
  a.hmin = hmin;
  a.normalize = 1.0f;
  for (int d = 0; d < kMaxDepths; ++d) a.hmax[d] = d < ndepth ? hmax[d] : 0.0f;
  if (batch * m == 0) return (int)cudaSuccess;
  crop_group_kernel<<<batch * m, kThreads, 0, (cudaStream_t)stream>>>(
      xyz, centers, rot, out, a);
  return (int)cudaGetLastError();
}

extern "C" int gn_sa_feat(const float* xyz, const float* centers,
                          const float* feat, const float* w1, const float* b1,
                          const float* w2, const float* b2, const float* w3,
                          const float* b3, float* out, int batch, int n, int m,
                          int ns, float r2, float inv_radius, int c_in, int c1,
                          int c2, int c3, void* stream) {
  if (ns < 1 || ns > kMaxSamples || c_in % 4 != 0 || c1 % 4 != 0 ||
      c2 % 4 != 0 || c1 > kThreads || kThreads % c1 != 0 || c2 > kThreads ||
      kThreads % c2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CropArgs a = {};
  a.n = n;
  a.m = m;
  a.ndepth = 1;
  a.ns = ns;
  a.ball = 1;
  a.c1 = c1;
  a.c2 = c2;
  a.c3 = c3;
  a.r2 = r2;
  a.normalize = inv_radius;
  const size_t smem = (size_t)ns * (c_in + c1 + c2 + 3) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sa_feat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch * m == 0) return (int)cudaSuccess;
  sa_feat_kernel<<<batch * m, kThreads, smem, (cudaStream_t)stream>>>(
      xyz, centers, feat, w1, b1, w2, b2, w3, b3, out, a, c_in);
  return (int)cudaGetLastError();
}
