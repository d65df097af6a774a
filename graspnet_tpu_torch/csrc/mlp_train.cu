// Train-mode crop MLP: the SharedMLP 3 -> c1 -> c2 -> c3 with batch-stats
// BatchNorm over every row, ReLU, and the max over the s samples of each
// (seed, depth) group; forward and backward.
//
// Replaces graspnet_tpu/ops/pallas/mlp_train.py::crop_mlp_train_pallas (K7):
// the forward _mlp_train_fwd_call (kernel _mlp_fwd_kernel), the backward
// _mlp_train_bwd_call (kernel _mlp_bwd_kernel) and the VJP assembly of
// _make_fused.  Rows: x is (G, s, 3) with G = B * Ns * D groups of s = 64
// samples, 524,288 rows at the production shape.
//
// What bounds it on an H100: f32 FMAs on the CUDA cores.  A row's forward
// costs 2 * (3*c1 + c1*c2 + c2*c3) = 82 k flops at (64, 128, 256) and its
// gradient products (dW3, da2, dW2, da1, dW1) 164 k: 43 + 86 GFLOP per
// training step at B=2, 0.64 + 1.29 ms at the 67 TFLOP/s f32 peak.  This
// design does more: the forward runs layer 1 three times, layer 2 twice
// and layer 3 once (52 GFLOP), the backward recomputes the whole chain in
// each of its three passes and forms da2 in two of them (250 GFLOP), so it
// takes 0.78 + 3.7 ms at best.  It computes in f32 on the CUDA cores and
// uses no tensor cores; the JAX package runs this kernel with bf16 inputs
// on the TPU, and the port is held against the XLA f32 path.
//
// Design.  The TPU kernel carries its BN sums across a sequential grid.
// CUDA blocks run in parallel and in no order, so every pass is its own
// launch of a persistent grid (one or two blocks per SM, each walking a
// fixed stride of groups), and every cross-block sum is a per-block partial that
// a second kernel reduces in block order: no float atomics, so two runs
// give bitwise equal results.
//   forward pass 1: z1 = x @ W1 -> per-column (mean, M2) of z1;
//   forward pass 2: a1 = relu(bn1(z1)), z2 = a1 @ W2 -> stats of z2;
//   forward pass 3: a2, z3 = a2 @ W3 -> stats of z3 and the per-group max
//     and min of the pre-norm z3; the wrapper takes the max (gamma >= 0)
//     or the min (gamma < 0) through relu(bn3(.)), as _fwd_impl does.
// Batch statistics combine per-tile (mean, M2) with Chan's formula, first
// within a block in tile order, then across blocks in block order.
//   backward pass A: recompute to a3, pool backward (the cotangent split
//     evenly across ties, as jnp.max's VJP), r3 = da3 * relu' ->
//     T3 = sum r3 * zhat3, S3 = sum r3 (dgamma3, dbeta3);
//   backward pass B: dz3 = gamma3/sigma3 (r3 - S3/n - zhat3 T3/n);
//     dW3 += a2^T dz3 (a per-block partial in device memory, updated in
//     place tile by tile); da2 = dz3 @ W3^T, r2 -> T2, S2;
//   backward pass C: dz2 likewise; dW2 += a1^T dz2 (registers);
//     da1 = dz2 @ W2^T, r1 -> T1, S1 and the x-moments x^T r1, x^T zhat1,
//     sum x, from which dW1 = x^T dz1 follows directly (K = 3): no normal
//     equations as on the TPU, and no fourth pass.
// Activations never go to device memory.  One block holds whole groups: a
// tile is one group of s <= 64 rows, so the pool and its backward stay in
// the block; in layer 3 a thread owns one output column and keeps its s
// values in registers.  h1/h2 tiles (and dz3 in the backward) sit in
// shared memory; the weights (W3 is 128 KB) are read through L1/L2, as in
// crop.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;  // samples per group
constexpr int kRows = 32;     // rows per register tile in matmul_rows
constexpr int kChunk = 16;    // dW3 columns updated per read-modify-write
constexpr int kMaxJ = 32;     // dW2 entries per thread

struct Dims {
  int g, s, c1, c2, c3;
  float eps;
};

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

// shared-memory tiles: x | a1 | a2 | z2 | dz3 | zh1 (floats)
__host__ __device__ inline size_t smem_floats(const Dims& d, int upto) {
  const size_t sz[6] = {(size_t)pad4(3 * d.s), (size_t)d.s * d.c1, (size_t)d.s * d.c2,
                        (size_t)d.s * d.c2, (size_t)d.s * d.c3, (size_t)d.s * d.c1};
  size_t total = 0;
  for (int i = 0; i < upto; ++i) total += sz[i];
  return total;
}

__device__ __forceinline__ float relu_bn(float zh, float gamma, float beta) {
  return fmaxf(fmaf(zh, gamma, beta), 0.0f);
}

// Chan's combine of (mean, m2) over n rows with a part (mt, m2t) over nt.
__device__ __forceinline__ void chan_add(float& mean, float& m2, float n,
                                         float mt, float m2t, float nt) {
  if (n == 0.0f) {
    mean = mt;
    m2 = m2t;
    return;
  }
  const float nn = n + nt;
  const float delta = mt - mean;
  mean = mean + delta * (nt / nn);
  m2 = m2 + m2t + delta * delta * (n * nt / nn);
}

__device__ __forceinline__ void load_x(const float* __restrict__ x, int grp,
                                       const Dims& d, float* xs) {
  const float* src = x + (size_t)grp * d.s * 3;
  for (int e = threadIdx.x; e < d.s * 3; e += kThreads) xs[e] = src[e];
}

// z1 = x @ W1 for one row and column, in the JAX broadcast-sum order
__device__ __forceinline__ float z1_at(const float* xs, const float* __restrict__ w1,
                                       int r, int c, int c1) {
  float y = xs[3 * r] * __ldg(w1 + c);
  y = y + xs[3 * r + 1] * __ldg(w1 + c1 + c);
  y = y + xs[3 * r + 2] * __ldg(w1 + 2 * c1 + c);
  return y;
}

// out(r, c) = sum_k in[r * nin + k] * w[k * nout + c] for r < s, c < nout;
// thread (c = tid % nout, row group tid / nout), nout | kThreads, nin % 4 == 0.
// epi(r, c, value) consumes each result; a thread always gets the same c.
template <typename Epi>
__device__ __forceinline__ void matmul_rows(const float* in, int nin,
                                            const float* __restrict__ w, int nout,
                                            int s, Epi epi) {
  const int groups = kThreads / nout;
  const int c = threadIdx.x % nout;
  const int g = threadIdx.x / nout;
  for (int r0 = g; r0 < s; r0 += groups * kRows) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
    for (int k = 0; k < nin; k += 4) {
      const float wa = __ldg(w + (size_t)k * nout + c);
      const float wb = __ldg(w + (size_t)(k + 1) * nout + c);
      const float wc = __ldg(w + (size_t)(k + 2) * nout + c);
      const float wd = __ldg(w + (size_t)(k + 3) * nout + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = r0 + i * groups;
        if (row < s) {
          const float4 h = *reinterpret_cast<const float4*>(in + row * nin + k);
          acc[i] += h.x * wa + h.y * wb + h.z * wc + h.w * wd;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = r0 + i * groups;
      if (row < s) epi(row, c, acc[i]);
    }
  }
}

// z3 column c for the s rows of the tile: z[r] = sum_k a2[r][k] W3[k][c]
__device__ __forceinline__ void layer3_column(const float* a2, int c2,
                                              const float* __restrict__ w3, int c3,
                                              int c, int s, float (&z)[kMaxRows]) {
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) z[r] = 0.0f;
  for (int k = 0; k < c2; k += 4) {
    const float wa = __ldg(w3 + (size_t)k * c3 + c);
    const float wb = __ldg(w3 + (size_t)(k + 1) * c3 + c);
    const float wc = __ldg(w3 + (size_t)(k + 2) * c3 + c);
    const float wd = __ldg(w3 + (size_t)(k + 3) * c3 + c);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < s) {
        const float4 h = *reinterpret_cast<const float4*>(a2 + r * c2 + k);
        z[r] += h.x * wa + h.y * wb + h.z * wc + h.w * wd;
      }
    }
  }
}

// Per-column (mean, M2) of an s x nc tile in shared memory, folded into the
// thread's running pair; threads c < nc own column c.
__device__ __forceinline__ void column_stats(const float* buf, int nc, int s, int tiles,
                                             float& mean, float& m2) {
  const int c = threadIdx.x;
  if (c >= nc) return;
  float sum = 0.0f;
  for (int r = 0; r < s; ++r) sum += buf[r * nc + c];
  const float mt = sum / (float)s;
  float m2t = 0.0f;
  for (int r = 0; r < s; ++r) {
    const float dv = buf[r * nc + c] - mt;
    m2t += dv * dv;
  }
  chan_add(mean, m2, (float)tiles * s, mt, m2t, (float)s);
}

// Layer 1 into a1 (batch-normalized and relu'd unless RAW); zh1 optional.
template <bool RAW>
__device__ __forceinline__ void layer1(const float* xs, const float* __restrict__ w1,
                                       const float* __restrict__ gb1,
                                       const float* __restrict__ st1, const Dims& d,
                                       float* a1, float* zh1) {
  for (int e = threadIdx.x; e < d.s * d.c1; e += kThreads) {
    const int r = e / d.c1;
    const int c = e - r * d.c1;
    const float z = z1_at(xs, w1, r, c, d.c1);
    if (RAW) {
      a1[e] = z;
    } else {
      const float zh = (z - __ldg(st1 + c)) * rsqrtf(__ldg(st1 + d.c1 + c) + d.eps);
      a1[e] = relu_bn(zh, __ldg(gb1 + c), __ldg(gb1 + d.c1 + c));
      if (zh1 != nullptr) zh1[e] = zh;
    }
  }
}

// ------------------------------------------------------------- forward --

// PASS 1, 2, 3: per-block partials part[block][0|1][C] = (mean, M2) of
// z1, z2 or z3; pass 3 also writes zmax/zmin (G, c3).
template <int PASS>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ w2, const float* __restrict__ w3,
               const float* __restrict__ gb1, const float* __restrict__ gb2,
               const float* __restrict__ st1, const float* __restrict__ st2,
               float* __restrict__ part, float* __restrict__ zmax,
               float* __restrict__ zmin, Dims d) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* a1 = xs + smem_floats(d, 1);
  float* a2 = xs + smem_floats(d, 2);
  const int tid = threadIdx.x;
  const int nc = PASS == 1 ? d.c1 : (PASS == 2 ? d.c2 : d.c3);
  float mean = 0.0f, m2 = 0.0f;
  int tiles = 0;
  for (int grp = blockIdx.x; grp < d.g; grp += gridDim.x, ++tiles) {
    load_x(x, grp, d, xs);
    __syncthreads();  // also: the previous tile's readers are done
    layer1<PASS == 1>(xs, w1, gb1, st1, d, a1, nullptr);
    __syncthreads();
    if (PASS == 1) {
      column_stats(a1, d.c1, d.s, tiles, mean, m2);
      continue;
    }
    matmul_rows(a1, d.c1, w2, d.c2, d.s, [&](int r, int c, float v) {
      if (PASS == 2) {
        a2[r * d.c2 + c] = v;
      } else {
        const float zh = (v - __ldg(st2 + c)) * rsqrtf(__ldg(st2 + d.c2 + c) + d.eps);
        a2[r * d.c2 + c] = relu_bn(zh, __ldg(gb2 + c), __ldg(gb2 + d.c2 + c));
      }
    });
    __syncthreads();
    if (PASS == 2) {
      column_stats(a2, d.c2, d.s, tiles, mean, m2);
      continue;
    }
    if (tid < d.c3) {
      float z[kMaxRows];
      layer3_column(a2, d.c2, w3, d.c3, tid, d.s, z);
      float sum = 0.0f, mx = -INFINITY, mn = INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < d.s) {
          sum += z[r];
          mx = fmaxf(mx, z[r]);
          mn = fminf(mn, z[r]);
        }
      }
      const float mt = sum / (float)d.s;
      float m2t = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < d.s) m2t += (z[r] - mt) * (z[r] - mt);
      }
      chan_add(mean, m2, (float)tiles * d.s, mt, m2t, (float)d.s);
      zmax[(size_t)grp * d.c3 + tid] = mx;
      zmin[(size_t)grp * d.c3 + tid] = mn;
    }
  }
  if (tid < nc) {
    part[(size_t)blockIdx.x * 2 * nc + tid] = mean;
    part[(size_t)blockIdx.x * 2 * nc + nc + tid] = m2;
  }
}

// Combine the per-block (mean, M2) in block order -> out = [mean; biased var].
__global__ void chan_reduce_kernel(const float* __restrict__ part, int nparts, int nc,
                                   int g, int s, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  float mean = 0.0f, m2 = 0.0f, n = 0.0f;
  for (int b = 0; b < nparts; ++b) {
    const int groups = b < g ? (g - 1 - b) / nparts + 1 : 0;
    if (groups == 0) continue;
    const float nb = (float)groups * s;
    chan_add(mean, m2, n, part[(size_t)b * 2 * nc + c], part[(size_t)b * 2 * nc + nc + c], nb);
    n += nb;
  }
  out[c] = mean;
  out[nc + c] = m2 / n;
}

// out[i] = sum over p in order of part[p * size + i]
__global__ void sum_parts_kernel(const float* __restrict__ part, int nparts, int size,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.0f;
  for (int p = 0; p < nparts; ++p) acc += part[(size_t)p * size + i];
  out[i] = acc;
}

// ------------------------------------------------------------ backward --

struct BwdArgs {
  const float* x;      // (G, s, 3)
  const float* gpool;  // (G, c3) cotangent of the pooled output
  const float *w1, *w2, *w3, *w2t, *w3t;
  const float *gb1, *gb2, *gb3;  // (2, C) [gamma; beta]
  const float *st1, *st2, *st3;  // (2, C) [mean; biased var]
  const float* sums3;  // (2, c3) [T3; S3], passes B and C
  const float* sums2;  // (2, c2) [T2; S2], pass C
  float* part;         // pass A: [block][T3|S3][c3]
  float* part_dw;      // pass B: [block][c2 * c3]; pass C: [block][c1 * c2]
  float* part_st;      // pass B: [block][group][T2|S2][c2]; pass C: [block][group][8][c1]
  float* part_sx;      // pass C: [block][3]
};

// PASS 1 (A), 2 (B), 3 (C); see the header.
template <int PASS>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(BwdArgs p, Dims d) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* a1 = xs + smem_floats(d, 1);
  float* a2 = xs + smem_floats(d, 2);
  float* z2 = xs + smem_floats(d, 3);   // zhat2, then dz2 (pass C)
  float* dz3 = xs + smem_floats(d, 4);
  float* zh1 = xs + smem_floats(d, 5);
  const int tid = threadIdx.x;
  const float n = (float)d.g * (float)d.s;

  // layer-3 column owned by this thread
  const bool own3 = tid < d.c3;
  const int c = own3 ? tid : 0;
  const float m3 = __ldg(p.st3 + c);
  const float rs3 = rsqrtf(__ldg(p.st3 + d.c3 + c) + d.eps);
  const float g3 = __ldg(p.gb3 + c), b3 = __ldg(p.gb3 + d.c3 + c);
  const float gs3 = g3 * rs3;
  const float t3n = PASS >= 2 ? __ldg(p.sums3 + c) / n : 0.0f;
  const float s3n = PASS >= 2 ? __ldg(p.sums3 + d.c3 + c) / n : 0.0f;
  // matmul_rows column of da2 (c2) and da1 (c1)
  const int k2 = tid % d.c2, grp2 = tid / d.c2;
  const int k1 = tid % d.c1, grp1 = tid / d.c1;
  const float gs2 = __ldg(p.gb2 + k2) * rsqrtf(__ldg(p.st2 + d.c2 + k2) + d.eps);
  const float t2n = PASS == 3 ? __ldg(p.sums2 + k2) / n : 0.0f;
  const float s2n = PASS == 3 ? __ldg(p.sums2 + d.c2 + k2) / n : 0.0f;

  float acc_t = 0.0f, acc_s = 0.0f;              // T, S of this thread's column
  float xr[3] = {0, 0, 0}, xz[3] = {0, 0, 0};    // pass C x-moments
  float sx = 0.0f;                               // pass C, threads 0..2
  float dw2[kMaxJ];                              // pass C dW2 partial
#pragma unroll
  for (int i = 0; i < kMaxJ; ++i) dw2[i] = 0.0f;
  const int jgroups = kThreads / d.c2;
  const int jg = tid / d.c2;

  int tiles = 0;
  for (int grp = blockIdx.x; grp < d.g; grp += gridDim.x, ++tiles) {
    __syncthreads();  // pass C's last epilogue still reads the previous xs
    load_x(p.x, grp, d, xs);
    __syncthreads();
    layer1<false>(xs, p.w1, p.gb1, p.st1, d, a1, PASS == 3 ? zh1 : nullptr);
    if (PASS == 3 && tid < 3) {
      for (int r = 0; r < d.s; ++r) sx += xs[3 * r + tid];
    }
    __syncthreads();
    matmul_rows(a1, d.c1, p.w2, d.c2, d.s, [&](int r, int cc, float v) {
      const float zh = (v - __ldg(p.st2 + cc)) * rsqrtf(__ldg(p.st2 + d.c2 + cc) + d.eps);
      a2[r * d.c2 + cc] = relu_bn(zh, __ldg(p.gb2 + cc), __ldg(p.gb2 + d.c2 + cc));
      if (PASS >= 2) z2[r * d.c2 + cc] = zh;
    });
    __syncthreads();

    if (own3) {
      float z[kMaxRows];
      layer3_column(a2, d.c2, p.w3, d.c3, c, d.s, z);
      // zhat3 in place, the recomputed pooled value and its tie count
      float pooled = 0.0f;  // every candidate is a relu output, >= 0
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < d.s) {
          z[r] = (z[r] - m3) * rs3;
          pooled = fmaxf(pooled, relu_bn(z[r], g3, b3));
        }
      }
      float cnt = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < d.s && relu_bn(z[r], g3, b3) == pooled) cnt += 1.0f;
      }
      const float q = __ldg(p.gpool + (size_t)grp * d.c3 + c) / cnt;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < d.s) {
          const float a = relu_bn(z[r], g3, b3);
          const float r3 = (a == pooled && a > 0.0f) ? q : 0.0f;
          if (PASS == 1) {
            acc_t += r3 * z[r];
            acc_s += r3;
          } else {
            z[r] = gs3 * (r3 - s3n - z[r] * t3n);  // dz3
            dz3[r * d.c3 + c] = z[r];
          }
        }
      }
      if (PASS == 2) {
        // dW3[:, c] += a2^T dz3[:, c], k in chunks, the block's partial
        // read, updated and written back in place
        float* pdw = p.part_dw + (size_t)blockIdx.x * d.c2 * d.c3;
        for (int k0 = 0; k0 < d.c2; k0 += kChunk) {
          float acc[kChunk];
#pragma unroll
          for (int kk = 0; kk < kChunk; ++kk) {
            acc[kk] = tiles == 0 ? 0.0f : pdw[(size_t)(k0 + kk) * d.c3 + c];
          }
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < d.s) {
#pragma unroll
              for (int kk = 0; kk < kChunk; kk += 4) {
                const float4 h = *reinterpret_cast<const float4*>(a2 + r * d.c2 + k0 + kk);
                acc[kk] += h.x * z[r];
                acc[kk + 1] += h.y * z[r];
                acc[kk + 2] += h.z * z[r];
                acc[kk + 3] += h.w * z[r];
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < kChunk; ++kk) pdw[(size_t)(k0 + kk) * d.c3 + c] = acc[kk];
        }
      }
    }
    if (PASS == 1) continue;
    __syncthreads();  // dz3 complete

    // da2 = dz3 @ W3^T, r2 = da2 * relu'; T2, S2 (pass B) or dz2 (pass C)
    matmul_rows(dz3, d.c3, p.w3t, d.c2, d.s, [&](int r, int cc, float v) {
      const float r2 = a2[r * d.c2 + cc] > 0.0f ? v : 0.0f;
      const float zh = z2[r * d.c2 + cc];
      if (PASS == 2) {
        acc_t += r2 * zh;
        acc_s += r2;
      } else {
        z2[r * d.c2 + cc] = gs2 * (r2 - s2n - zh * t2n);
      }
    });
    if (PASS == 2) continue;
    __syncthreads();  // dz2 complete

    // dW2[j][k2] += sum_r a1[r][j] dz2[r][k2] for j = jg + i * jgroups
    for (int r = 0; r < d.s; ++r) {
      const float dv = z2[r * d.c2 + k2];
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i) {
        const int j = jg + i * jgroups;
        if (j < d.c1) dw2[i] += a1[r * d.c1 + j] * dv;
      }
    }
    // da1 = dz2 @ W2^T, r1 = da1 * relu' -> T1, S1 and the x-moments
    matmul_rows(z2, d.c2, p.w2t, d.c1, d.s, [&](int r, int cc, float v) {
      const float r1 = a1[r * d.c1 + cc] > 0.0f ? v : 0.0f;
      const float zh = zh1[r * d.c1 + cc];
      acc_t += r1 * zh;
      acc_s += r1;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xr[i] += xs[3 * r + i] * r1;
        xz[i] += xs[3 * r + i] * zh;
      }
    });
  }

  // per-block partials
  if (PASS == 1) {
    if (own3) {
      p.part[(size_t)blockIdx.x * 2 * d.c3 + c] = acc_t;
      p.part[(size_t)blockIdx.x * 2 * d.c3 + d.c3 + c] = acc_s;
    }
  } else if (PASS == 2) {
    float* st = p.part_st + ((size_t)blockIdx.x * (kThreads / d.c2) + grp2) * 2 * d.c2;
    st[k2] = acc_t;
    st[d.c2 + k2] = acc_s;
  } else {
    float* st = p.part_st + ((size_t)blockIdx.x * (kThreads / d.c1) + grp1) * 8 * d.c1;
    st[k1] = acc_t;
    st[d.c1 + k1] = acc_s;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      st[(2 + i) * d.c1 + k1] = xr[i];
      st[(5 + i) * d.c1 + k1] = xz[i];
    }
    float* pdw = p.part_dw + (size_t)blockIdx.x * d.c1 * d.c2;
#pragma unroll
    for (int i = 0; i < kMaxJ; ++i) {
      const int j = jg + i * jgroups;
      if (j < d.c1) pdw[(size_t)j * d.c2 + k2] = dw2[i];
    }
    if (tid < 3) p.part_sx[(size_t)blockIdx.x * 3 + tid] = sx;
  }
}

// dgb1 = [T1; S1]; dW1[i][j] = gamma1/sigma1 (x^T r1 - sum x S1/n - x^T zhat1 T1/n)
__global__ void finish_layer1_kernel(const float* __restrict__ sums1,  // (8, c1)
                                     const float* __restrict__ sx,     // (3,)
                                     const float* __restrict__ gb1,
                                     const float* __restrict__ st1, Dims d,
                                     float* __restrict__ dw1, float* __restrict__ dgb1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d.c1) return;
  const float n = (float)d.g * (float)d.s;
  const float t1 = sums1[j], s1 = sums1[d.c1 + j];
  const float gs = gb1[j] * rsqrtf(st1[d.c1 + j] + d.eps);
  for (int i = 0; i < 3; ++i) {
    const float xr = sums1[(2 + i) * d.c1 + j];
    const float xz = sums1[(5 + i) * d.c1 + j];
    dw1[i * d.c1 + j] = gs * (xr - sx[i] * (s1 / n) - xz * (t1 / n));
  }
  dgb1[j] = t1;
  dgb1[d.c1 + j] = s1;
}

// ------------------------------------------------------------- host side --

bool dims_ok(const Dims& d) {
  return d.s >= 1 && d.s <= kMaxRows && d.c1 >= 4 && d.c2 >= 4 && d.c3 >= 4 &&
         d.c1 % 4 == 0 && d.c2 % kChunk == 0 && d.c3 % 4 == 0 &&
         kThreads % d.c1 == 0 && kThreads % d.c2 == 0 && d.c3 <= kThreads &&
         d.c1 <= (kThreads / d.c2) * kMaxJ;
}

int light_blocks(const Dims& d, int sm) { return d.g < 2 * sm ? d.g : 2 * sm; }
int heavy_blocks(const Dims& d, int sm) { return d.g < sm ? d.g : sm; }

struct BwdScratch {
  float *part_a, *sums1, *sx, *part_dw, *part_st, *part_sx;
};

size_t bwd_scratch(const Dims& d, int sm, float* base, BwdScratch* out) {
  const size_t na = light_blocks(d, sm), nh = heavy_blocks(d, sm);
  const size_t sizes[6] = {
      na * 2 * d.c3,                                     // part_a
      (size_t)8 * d.c1,                                  // sums1
      3,                                                 // sx
      nh * (size_t)(d.c2 * d.c3 > d.c1 * d.c2 ? d.c2 * d.c3 : d.c1 * d.c2),  // part_dw
      nh * (size_t)(kThreads / d.c2 * 2 * d.c2 > kThreads / d.c1 * 8 * d.c1
                        ? kThreads / d.c2 * 2 * d.c2
                        : kThreads / d.c1 * 8 * d.c1),   // part_st
      nh * 3,                                            // part_sx
  };
  float** ptrs[6] = {&out->part_a, &out->sums1, &out->sx, &out->part_dw, &out->part_st,
                     &out->part_sx};
  size_t off = 0;
  for (int i = 0; i < 6; ++i) {
    if (base != nullptr) *ptrs[i] = base + off;
    off += sizes[i];
  }
  return off;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Floats of scratch the forward (first value) and the backward need.
extern "C" size_t gn_mlp_train_scratch(int g, int s, int c1, int c2, int c3, int sm,
                                       int backward) {
  const Dims d = {g, s, c1, c2, c3, 0.0f};
  if (!backward) {
    const int cmax = c3 > c2 ? (c3 > c1 ? c3 : c1) : (c2 > c1 ? c2 : c1);
    return (size_t)light_blocks(d, sm) * 2 * cmax;
  }
  BwdScratch unused;
  return bwd_scratch(d, sm, nullptr, &unused);
}

// Forward: st1/st2/st3 = [mean; biased var] of z1/z2/z3, zmax/zmin (G, c3).
extern "C" int gn_mlp_train_fwd(const float* x, const float* w1, const float* w2,
                                const float* w3, const float* gb1, const float* gb2,
                                float* st1, float* st2, float* st3, float* zmax,
                                float* zmin, float* scratch, int g, int s, int c1, int c2,
                                int c3, float eps, int sm, void* stream) {
  const Dims d = {g, s, c1, c2, c3, eps};
  if (!dims_ok(d) || sm < 1) return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = smem_floats(d, 3) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(mlp_fwd_kernel<1>, bytes)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(mlp_fwd_kernel<2>, bytes)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(mlp_fwd_kernel<3>, bytes)) != cudaSuccess) return (int)err;
  const int nb = light_blocks(d, sm);
  mlp_fwd_kernel<1><<<nb, kThreads, bytes, st>>>(x, w1, w2, w3, gb1, gb2, st1, st2, scratch,
                                                 zmax, zmin, d);
  chan_reduce_kernel<<<cdiv(c1, 128), 128, 0, st>>>(scratch, nb, c1, g, s, st1);
  mlp_fwd_kernel<2><<<nb, kThreads, bytes, st>>>(x, w1, w2, w3, gb1, gb2, st1, st2, scratch,
                                                 zmax, zmin, d);
  chan_reduce_kernel<<<cdiv(c2, 128), 128, 0, st>>>(scratch, nb, c2, g, s, st2);
  mlp_fwd_kernel<3><<<nb, kThreads, bytes, st>>>(x, w1, w2, w3, gb1, gb2, st1, st2, scratch,
                                                 zmax, zmin, d);
  chan_reduce_kernel<<<cdiv(c3, 128), 128, 0, st>>>(scratch, nb, c3, g, s, st3);
  return (int)cudaGetLastError();
}

// Backward: dw1 (3, c1), dw2 (c1, c2), dw3 (c2, c3), dgb_l = [dgamma; dbeta].
extern "C" int gn_mlp_train_bwd(const float* x, const float* gpool, const float* w1,
                                const float* w2, const float* w3, const float* w2t,
                                const float* w3t, const float* gb1, const float* gb2,
                                const float* gb3, const float* st1, const float* st2,
                                const float* st3, float* dw1, float* dw2, float* dw3,
                                float* dgb1, float* dgb2, float* dgb3, float* scratch,
                                int g, int s, int c1, int c2, int c3, float eps, int sm,
                                void* stream) {
  const Dims d = {g, s, c1, c2, c3, eps};
  if (!dims_ok(d) || sm < 1) return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  BwdScratch sc;
  bwd_scratch(d, sm, scratch, &sc);
  const size_t bytes_a = smem_floats(d, 3) * sizeof(float);
  const size_t bytes_b = smem_floats(d, 5) * sizeof(float);
  const size_t bytes_c = smem_floats(d, 6) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(mlp_bwd_kernel<1>, bytes_a)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(mlp_bwd_kernel<2>, bytes_b)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(mlp_bwd_kernel<3>, bytes_c)) != cudaSuccess) return (int)err;
  const int na = light_blocks(d, sm), nh = heavy_blocks(d, sm);

  BwdArgs p = {x, gpool, w1, w2, w3, w2t, w3t, gb1, gb2, gb3, st1, st2, st3,
               dgb3, dgb2, sc.part_a, sc.part_dw, sc.part_st, sc.part_sx};
  // A: dgb3 = [T3; S3]
  mlp_bwd_kernel<1><<<na, kThreads, bytes_a, st>>>(p, d);
  sum_parts_kernel<<<cdiv(2 * c3, 256), 256, 0, st>>>(sc.part_a, na, 2 * c3, dgb3);
  // B: dw3, dgb2 = [T2; S2]
  mlp_bwd_kernel<2><<<nh, kThreads, bytes_b, st>>>(p, d);
  sum_parts_kernel<<<cdiv(c2 * c3, 256), 256, 0, st>>>(sc.part_dw, nh, c2 * c3, dw3);
  sum_parts_kernel<<<cdiv(2 * c2, 256), 256, 0, st>>>(sc.part_st, nh * (kThreads / c2),
                                                      2 * c2, dgb2);
  // C: dw2, then dw1 and dgb1 from the layer-1 sums
  mlp_bwd_kernel<3><<<nh, kThreads, bytes_c, st>>>(p, d);
  sum_parts_kernel<<<cdiv(c1 * c2, 256), 256, 0, st>>>(sc.part_dw, nh, c1 * c2, dw2);
  sum_parts_kernel<<<cdiv(8 * c1, 256), 256, 0, st>>>(sc.part_st, nh * (kThreads / c1),
                                                      8 * c1, sc.sums1);
  sum_parts_kernel<<<1, 32, 0, st>>>(sc.part_sx, nh, 3, sc.sx);
  finish_layer1_kernel<<<cdiv(c1, 128), 128, 0, st>>>(sc.sums1, sc.sx, gb1, st1, d, dw1, dgb1);
  return (int)cudaGetLastError();
}
