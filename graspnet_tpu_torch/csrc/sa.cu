// The eval SA stage's generic path around its matrix products: the
// grouping (with the first layer where its contraction is <= 4 wide) and
// the bias + ReLU (+ max over the samples) epilogue of each product.
//
// No TPU kernel: the JAX package runs this path (graspnet_tpu/models/
// backbone.py:84-119, an SA stage with input features that its fused
// kernels do not take) as plain XLA, which fuses the elementwise passes
// into the products by itself.  Eager PyTorch does not: at VoteNet's SA1
// (B=8, 2048 centres x 64 samples, 3 + 1 -> 64 -> 64 -> 128) the gathers,
// the subtract, the 1/r, the concat, the K = 4 broadcast-sum's nine passes
// and a separate bias and ReLU pass after each product move ~8 GB for ~26
// GFLOP.  These kernels move the same floats in two passes a product, and
// every float they write is bitwise what the plain path
// (ops/cuda/sa.py::sa_pool_plain) computes on the card:
//   * sa_group_kernel, an output row (b, m, s) with j = idx[b, m, s]: the
//     offset xyz[b, j] - new_xyz[b, m], times 1/r rounded to float32
//     where the stage normalizes (ATen's CUDA true division by a Python
//     float multiplies by that reciprocal), then either the row
//     [offset | features[b, j]] as torch.cat lays it out (the input of the
//     first product), or, with a first-layer weight (K = 3 + C <= 4), that
//     layer's relu(((x0 w0 + x1 w1) + x2 w2) + x3 w3 + b) in
//     nn/layers.py::dense's order, each product and sum rounded on its own
//     (__fmul_rn / __fadd_rn: no FMA contraction), written c_out wide;
//   * bias_relu_kernel: y = relu(y + b) in place after a product;
//   * bias_relu_max_kernel: after the last product, out[g, c] = the max over
//     the s rows of group g of relu(y + b), straight into (B, M, c).
// The products between them stay torch.matmul on the shapes the plain path
// gives it, so cuBLAS picks the same algorithm and its sums keep their bits.
// ReLU is torch's clamp_min(0) (NaN passes through) and the max torch.amax's
// (NaN wins), so the kernels agree with the plain path on any input.
//
// All three are bound by bytes: each reads and writes a float once (the
// grouping reads its index, offset and feature rows from L2).  A warp of
// the grouping takes 32 consecutive rows: each lane first gathers one row's
// index, point, centre (and first-layer feature), so the 32 rows' chains of
// dependent loads overlap, then the warp writes the rows one after another,
// lanes across the columns (coalesced stores), the first layer's weights
// held in registers.  The epilogues move 16 bytes a thread where the
// widths allow.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroupWarps = 8;    // warps a block of sa_group_kernel, 32 output rows a warp
constexpr int kMaxFusedK = 4;     // the widest first layer sa_group_kernel applies
constexpr int kSlots = 4;         // first-layer columns a lane holds in registers (32 x kSlots a warp)
constexpr int kThreads = 256;     // threads a block of the epilogues
constexpr int kMaxUnroll = 4;     // samples a thread of the max loads before it compares them

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// torch.amax's step: a NaN wins, else the larger
__device__ __forceinline__ float max_nan(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// relu(((x0 w0 + x1 w1) + x2 w2) + x3 w3 + b) over the first k_in terms, in
// nn/layers.py::dense's order, every product and sum rounded on its own
__device__ __forceinline__ float first_layer(const float* x, const float* w, float b, int k_in) {
  float y = __fmul_rn(x[0], w[0]);
#pragma unroll
  for (int k = 1; k < kMaxFusedK; ++k)
    if (k < k_in) y = __fadd_rn(y, __fmul_rn(x[k], w[k]));
  return relu(__fadd_rn(y, b));
}

__global__ void __launch_bounds__(kGroupWarps * 32)
sa_group_kernel(const int64_t* __restrict__ idx, const float* __restrict__ xyz,
                const float* __restrict__ centers, const float* __restrict__ feat, int64_t feat_sb,
                int64_t feat_sn, int c_in, int64_t rows, int ns, int m, int n, int normalize, float inv_radius,
                const float* __restrict__ w, const float* __restrict__ bias, int c_out,
                float* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kGroupWarps + (threadIdx.x >> 5)) * 32;
  if (r0 >= rows) return;
  const int count = rows - r0 < 32 ? (int)(rows - r0) : 32;
  const int k_in = 3 + c_in;
  // lane l gathers row r0 + l: its point, centre and (fused) its feature
  float x[kMaxFusedK] = {0.0f, 0.0f, 0.0f, 0.0f};
  int64_t fbase = 0;  // the row's feature row, feat + fbase
  if (lane < count) {
    const int64_t row = r0 + lane;
    const int64_t group = row / ns;  // b * M + m
    const int64_t b = group / m;
    const int64_t j = idx[row];
    const float* p = xyz + (b * n + j) * 3;
    const float* c = centers + group * 3;
    fbase = b * feat_sb + j * feat_sn;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = __fsub_rn(__ldg(p + k), __ldg(c + k));
      x[k] = normalize ? __fmul_rn(d, inv_radius) : d;
    }
    if (w != nullptr)
#pragma unroll
      for (int k = 3; k < kMaxFusedK; ++k)
        if (k < k_in) x[k] = __ldg(feat + fbase + (k - 3));
  }
  if (w == nullptr) {  // the concatenated rows [offset | features], a row at a time across the lanes
    const int width = k_in;
#pragma unroll 4
    for (int r = 0; r < count; ++r) {
      const float o0 = __shfl_sync(full, x[0], r), o1 = __shfl_sync(full, x[1], r), o2 = __shfl_sync(full, x[2], r);
      const float* f = feat + __shfl_sync(full, fbase, r);
      float* o = out + (r0 + r) * width;
      for (int col = lane; col < width; col += 32)
        o[col] = col >= 3 ? __ldg(f + (col - 3)) : col == 0 ? o0 : col == 1 ? o1 : o2;
    }
    return;
  }
  // the first layer: lane l holds columns l + 32 t of W and b in registers
  float wr[kSlots][kMaxFusedK], br[kSlots];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int col = lane + 32 * t;
    br[t] = col < c_out ? __ldg(bias + col) : 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxFusedK; ++k) wr[t][k] = col < c_out && k < k_in ? __ldg(w + k * c_out + col) : 0.0f;
  }
  for (int r = 0; r < count; ++r) {
    float xr[kMaxFusedK];
#pragma unroll
    for (int k = 0; k < kMaxFusedK; ++k) xr[k] = __shfl_sync(full, x[k], r);
    float* o = out + (r0 + r) * c_out;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int col = lane + 32 * t;
      if (col < c_out) o[col] = first_layer(xr, wr[t], br[t], k_in);
    }
    for (int col = lane + 32 * kSlots; col < c_out; col += 32) {  // columns past the registers'
      float wc[kMaxFusedK];
#pragma unroll
      for (int k = 0; k < kMaxFusedK; ++k) wc[k] = k < k_in ? __ldg(w + k * c_out + col) : 0.0f;
      o[col] = first_layer(xr, wc, __ldg(bias + col), k_in);
    }
  }
}

// y (rows, c) <- relu(y + b), V consecutive channels a thread (V = 4: c % 4 == 0)
template <int V>
__global__ void __launch_bounds__(kThreads)
bias_relu_kernel(float* __restrict__ y, const float* __restrict__ bias, int64_t items, int c) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int c0 = (int)((i * V) % c);
  if constexpr (V == 4) {
    float4 v = reinterpret_cast<float4*>(y)[i];
    v.x = relu(__fadd_rn(v.x, __ldg(bias + c0)));
    v.y = relu(__fadd_rn(v.y, __ldg(bias + c0 + 1)));
    v.z = relu(__fadd_rn(v.z, __ldg(bias + c0 + 2)));
    v.w = relu(__fadd_rn(v.w, __ldg(bias + c0 + 3)));
    reinterpret_cast<float4*>(y)[i] = v;
  } else {
    y[i] = relu(__fadd_rn(y[i], __ldg(bias + c0)));
  }
}

// out (groups, c) <- max over s of relu(y (groups, s, c) + b): a thread
// takes V consecutive channels of one group and walks its s rows,
// kMaxUnroll loads in flight
template <int V>
__global__ void __launch_bounds__(kThreads)
bias_relu_max_kernel(const float* __restrict__ y, const float* __restrict__ bias, float* __restrict__ out,
                     int64_t items, int ns, int c) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int per_row = c / V;
  const int64_t group = i / per_row;
  const int c0 = (int)(i % per_row) * V;
  float b[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    b[v] = __ldg(bias + c0 + v);
    acc[v] = __int_as_float(0xff800000);  // -inf, torch.amax's start
  }
  const float* base = y + group * ns * c + c0;
  for (int s0 = 0; s0 < ns; s0 += kMaxUnroll) {
    float r[kMaxUnroll][V];
#pragma unroll
    for (int u = 0; u < kMaxUnroll; ++u) {
      if (s0 + u < ns) {
        const float* q = base + (int64_t)(s0 + u) * c;
        if constexpr (V == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(q));
          r[u][0] = t.x;
          r[u][1] = t.y;
          r[u][2] = t.z;
          r[u][3] = t.w;
        } else {
          r[u][0] = __ldg(q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxUnroll; ++u)
      if (s0 + u < ns)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = max_nan(acc[v], relu(__fadd_rn(r[u][v], b[v])));
  }
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(out)[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[i] = acc[0];
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The grouping: out (B, M, ns, 3 + c_in) rows, or (B, M, ns, c_out) first-
// layer activations when w (3 + c_in, c_out) and bias (c_out,) are given.
// feat[b, j, k] lies at feat + b * feat_sb + j * feat_sn + k.
extern "C" int gn_sa_group(const int64_t* idx, const float* xyz, const float* centers, const float* feat,
                           int64_t feat_sb, int64_t feat_sn, int c_in, int64_t batch, int n, int m, int ns,
                           int normalize, float inv_radius, const float* w, const float* bias, int c_out,
                           float* out, void* stream) {
  if (batch < 0 || n < 1 || m < 0 || ns < 1 || c_in < 0) return (int)cudaErrorInvalidValue;
  if (w != nullptr && (3 + c_in > kMaxFusedK || c_out < 1 || bias == nullptr)) return (int)cudaErrorInvalidValue;
  const int64_t rows = batch * m * ns;
  const int64_t blocks = (rows + kGroupWarps * 32 - 1) / (kGroupWarps * 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  sa_group_kernel<<<(unsigned)blocks, kGroupWarps * 32, 0, (cudaStream_t)stream>>>(
      idx, xyz, centers, feat, feat_sb, feat_sn, c_in, rows, ns, m, n, normalize, inv_radius, w, bias, c_out, out);
  return (int)cudaGetLastError();
}

// y (rows, c) <- relu(y + bias) in place.
extern "C" int gn_sa_bias_relu(float* y, const float* bias, int64_t rows, int c, void* stream) {
  if (rows < 0 || c < 1) return (int)cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 && aligned16(y);
  const int64_t items = rows * c / (vec ? 4 : 1);
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (items == 0) return (int)cudaSuccess;
  if (vec)
    bias_relu_kernel<4><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(y, bias, items, c);
  else
    bias_relu_kernel<1><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(y, bias, items, c);
  return (int)cudaGetLastError();
}

// out (groups, c) <- max over the ns rows of relu(y (groups, ns, c) + bias).
extern "C" int gn_sa_bias_relu_max(const float* y, const float* bias, float* out, int64_t groups, int ns, int c,
                                   void* stream) {
  if (groups < 0 || ns < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 && aligned16(y) && aligned16(out);
  const int64_t items = groups * c / (vec ? 4 : 1);
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (items == 0) return (int)cudaSuccess;
  if (vec)
    bias_relu_max_kernel<4><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(y, bias, out, items, ns, c);
  else
    bias_relu_max_kernel<1><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(y, bias, out, items, ns, c);
  return (int)cudaGetLastError();
}
