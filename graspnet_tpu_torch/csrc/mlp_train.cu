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
// What bounds it on an H100: its products.  A row's forward costs 2 *
// (3*c1 + c1*c2 + c2*c3) = 82 k flops at (64, 128, 256) and its gradient
// products (dW3, da2, dW2, da1, dW1) 164 k: 43 + 86 GFLOP per training step
// at B=2, 0.64 + 1.29 ms at the 67 TFLOP/s f32 CUDA-core peak, 0.26 + 0.52
// ms as 3xTF32 on the tensor cores (the least time at f32 accuracy).  The
// forward runs layer 1 three times, layer 2 twice and layer 3 once (52
// GFLOP).  The backward recomputes layers 1-3 once (pass B, layers 1-2 once
// per layer-3 column part) and layer 1 again (pass C): ~246 k flops a row,
// 129 GFLOP.  Everything computes in f32 on the CUDA cores, with no tensor
// cores (TF32 would break the port's f32 gradient bounds); the JAX package
// runs this kernel with bf16 inputs on the TPU, and the port is held against
// the XLA f32 path.
//
// Design.  The TPU kernel carries its BN sums across a sequential grid.
// CUDA blocks run in parallel and in no order, so every pass is its own
// launch of a persistent grid (each block walking a fixed stride of groups),
// and every cross-block sum is a per-block partial that a second kernel
// reduces in block order: no float atomics, so two runs give bitwise equal
// results.
//   forward pass 1: z1 = x @ W1 -> per-column (mean, M2) of z1;
//   forward pass 2: a1 = relu(bn1(z1)), z2 = a1 @ W2 -> stats of z2;
//   forward pass 3: a2, z3 = a2 @ W3 -> stats of z3 and the per-group max
//     and min of the pre-norm z3; the wrapper takes the max (gamma >= 0)
//     or the min (gamma < 0) through relu(bn3(.)), as _fwd_impl does, and
//     keeps that z_ext for the backward.
// Batch statistics combine per-tile (mean, M2) with Chan's formula, first
// within a block in tile order, then across blocks in block order.
//   backward, pool sums: only rows at a pool maximum carry r3 (the cotangent
//     split evenly across ties, as jnp.max's VJP), and tied rows share one
//     zhat3, so T3 = sum [pooled > 0] gpool zhat3(z_ext), S3 = sum [pooled
//     > 0] gpool: a (G, c3) reduction, no recompute;
//   backward pass B: recompute a1, a2, z3; r3 from the recomputed pool;
//     dz3 = gamma3/sigma3 (r3 - S3/n - zhat3 T3/n); dW3 += a2^T dz3 in
//     registers across all of the block's groups (split-K over blocks);
//     da2 = dz3 @ W3^T, r2 -> T2, S2; r2 and zhat2 go to device memory.
//     dgamma3, dbeta3 are the sums of r3 zhat3 and r3 as routed here;
//   backward pass C: recompute layer 1 only; dz2 from r2 and zhat2;
//     dW2 += a1^T dz2 (registers); da1 = dz2 @ W2^T, r1 -> T1, S1 and the
//     x-moments x^T r1, x^T zhat1, sum x, from which dW1 = x^T dz1 follows
//     directly (K = 3): no normal equations as on the TPU, and no fourth
//     pass.
// A block keeps whole groups: a tile is one group of s <= 64 rows (padded
// to 64 with zero rows, which no sum, pool or store takes).  Products are
// register-tiled (mma_tile: each thread a 4 x 8 or 8 x 8 outer-product tile,
// operands float4 loads from shared memory) with the weights resident in
// shared memory.  Forward pass 2 holds W2 (two blocks per SM); pass 3 holds
// W2 and all of W3 (c3 <= 256: 213 KB at the production shape, one block
// per SM, layers 1-2 computed once per group).  A pass-B block owns W2 and a part of at most 128
// columns of W3 (215 KB), so c3 = 256 runs as two column parts whose r2
// slabs pass C adds in order.
//   The forward and pass B build a1 and a2 with the same helpers (load_a1,
// layer2_tile) and every product with mma_tile, whose sums are fmaf chains
// in ascending k whatever the thread tile: the forward's z2 and z3 are
// bitwise what pass B recomputes, so the pool maxima that T3/S3 take from
// z_ext (pool_sums_kernel) are the rows that pass B routes r3 to.
//   Pass 3's epilogue: each thread reduces its tile rows (r = tm + tmt i <
// s) of each of its 8 columns to a (mean, M2) pair and a max and min of the
// pre-norm z3; thread c then combines the tmt row-threads of column c in
// ascending tm with Chan's formula (the group's pair, then into the block's
// running pair) and takes the group's max and min.  Fixed orders
// throughout: the forward is bitwise repeatable.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;  // samples per group
constexpr int kMaxC1 = 64;    // widest layer 1 the kernels take

struct Dims {
  int g, s, c1, c2, c3;
  float eps;
};

__device__ __forceinline__ float relu_bn(float zh, float gamma, float beta) {
  return fmaxf(fmaf(zh, gamma, beta), 0.0f);
}

// zhat of z in column c of a layer with [mean; biased var] st over nc columns
__device__ __forceinline__ float zhat(float z, const float* __restrict__ st, int c, int nc, float eps) {
  return (z - __ldg(st + c)) * rsqrtf(__ldg(st + nc + c) + eps);
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

// z1 = x @ W1 for one row and column, in the JAX broadcast-sum order
__device__ __forceinline__ float z1_at(const float* xs, const float* __restrict__ w1,
                                       int r, int c, int c1) {
  float y = xs[3 * r] * __ldg(w1 + c);
  y = y + xs[3 * r + 1] * __ldg(w1 + c1 + c);
  y = y + xs[3 * r + 2] * __ldg(w1 + 2 * c1 + c);
  return y;
}

// Per-column (mean, M2) of the s rows of a tile in shared memory (row stride
// ld), folded into the thread's running pair; threads c < nc own column c.
__device__ __forceinline__ void column_stats(const float* buf, int ld, int nc, int s, int tiles,
                                             float& mean, float& m2) {
  const int c = threadIdx.x;
  if (c >= nc) return;
  float sum = 0.0f;
  for (int r = 0; r < s; ++r) sum += buf[r * ld + c];
  const float mt = sum / (float)s;
  float m2t = 0.0f;
  for (int r = 0; r < s; ++r) {
    const float dv = buf[r * ld + c] - mt;
    m2t += dv * dv;
  }
  chan_add(mean, m2, (float)tiles * s, mt, m2t, (float)s);
}

// Combine the per-block (mean, M2) -> out = [mean; biased var].  One warp
// per column: lane l takes blocks l, l + 32, ... in order, then lane l
// absorbs lane l + 1, 2, 4, 8, 16 (a fixed tree): bitwise repeatable.
// Launched with whole warps per block.
__global__ void chan_reduce_kernel(const float* __restrict__ part, int nparts, int nc,
                                   int g, int s, float* __restrict__ out) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x & 31;
  if (c >= nc) return;  // the whole warp
  float mean = 0.0f, m2 = 0.0f, n = 0.0f;
  for (int b = lane; b < nparts; b += 32) {
    const int groups = b < g ? (g - 1 - b) / nparts + 1 : 0;
    if (groups == 0) continue;
    const float nb = (float)groups * s;
    chan_add(mean, m2, n, part[(size_t)b * 2 * nc + c], part[(size_t)b * 2 * nc + nc + c], nb);
    n += nb;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const float om = __shfl_down_sync(0xffffffffu, mean, off);
    const float om2 = __shfl_down_sync(0xffffffffu, m2, off);
    const float on = __shfl_down_sync(0xffffffffu, n, off);
    if (lane + off < 32 && on > 0.0f) {
      chan_add(mean, m2, n, om, om2, on);
      n += on;
    }
  }
  if (lane == 0) {
    out[c] = mean;
    out[nc + c] = m2 / n;
  }
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

// ------------------------------------------------------- register tiles --

constexpr int kPad = 4;                     // row padding of K-contiguous tiles (bank spread)
constexpr int kRowTiles = kMaxRows / 4;     // thread rows of a 64-row tile at 4 rows each
constexpr int kMaxHalf3 = 128;              // layer-3 columns one pass-B block owns
constexpr int kPoolChunks = 128;            // blocks of the (G, c3) pool-sum reduction
constexpr size_t kMaxSmem = 232448;         // bytes of shared memory a block may use

// Layer-3 columns a pass-B block owns, and the number of such column parts.
__host__ __device__ inline int half3(const Dims& d) { return d.c3 <= kMaxHalf3 ? d.c3 : kMaxHalf3; }
__host__ __device__ inline int parts3(const Dims& d) { return d.c3 / half3(d); }

// Index of a thread's i-th row (or column) among nt threads along that axis.
// K-contiguous operands take t, t + nt, t + 2 nt, ...: 8 neighbouring threads
// read 8 rows whose padded strides fall in distinct banks.  The other layout
// takes groups of 4 neighbours, 4t .. 4t+3, then 4t + 4nt ..: one float4 per
// group, 8 neighbouring threads reading 128 contiguous bytes.
template <bool K_CONTIG>
__device__ __forceinline__ int tile_index(int t, int nt, int i) {
  return K_CONTIG ? t + nt * i : 4 * t + (i & 3) + (i >> 2) * 4 * nt;
}

// acc[i][j] += sum_k A(m_i, k) B(k, n_j) over k < K (K % 4 == 0), for the
// thread at (tm, tn) of a (tmt x tnt) grid of TM x TN tiles.  A(m, k) is
// A[m * lda + k] if AK (k contiguous) else A[k * lda + m]; B(k, n) is
// B[n * ldb + k] if BK else B[k * ldb + n].  Every operand is a float4 load
// from shared memory; products are rounded fmaf in ascending k, so the
// result does not depend on the launch.
template <int TM, int TN, bool AK, bool BK>
__device__ __forceinline__ void mma_tile(const float* A, int lda, const float* B, int ldb, int K,
                                         int tm, int tmt, int tn, int tnt,
                                         float (&acc)[TM][TN]) {
  for (int k = 0; k < K; k += 4) {
    float a[TM][4], b[4][TN];
    if constexpr (AK) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(A + tile_index<true>(tm, tmt, i) * lda + k);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(A + (k + kk) * lda + tile_index<false>(tm, tmt, i));
          a[i][kk] = v.x; a[i + 1][kk] = v.y; a[i + 2][kk] = v.z; a[i + 3][kk] = v.w;
        }
      }
    }
    if constexpr (BK) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(B + tile_index<true>(tn, tnt, j) * ldb + k);
        b[0][j] = v.x; b[1][j] = v.y; b[2][j] = v.z; b[3][j] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(B + (k + kk) * ldb + tile_index<false>(tn, tnt, j));
          b[kk][j] = v.x; b[kk][j + 1] = v.y; b[kk][j + 2] = v.z; b[kk][j + 3] = v.w;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
      }
    }
  }
}

// Group grp's rows into xs (zeros past s), then a1 = relu(bn1(x W1)) for all
// kMaxRows rows into a1s (row stride ld1).  Starts with a barrier (the
// previous group's readers are done) and ends with one.
__device__ __forceinline__ void load_a1(const float* __restrict__ x, const float* __restrict__ w1,
                                        const float* __restrict__ gb1, const float* __restrict__ st1,
                                        const Dims& d, int grp, float* xs, float* a1s, int ld1) {
  __syncthreads();
  const float* xg = x + (size_t)grp * d.s * 3;
  for (int e = threadIdx.x; e < 3 * kMaxRows; e += kThreads) xs[e] = e < 3 * d.s ? xg[e] : 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < kMaxRows * d.c1; e += kThreads) {
    const int r = e / d.c1, c = e - r * d.c1;
    const float zh = zhat(z1_at(xs, w1, r, c, d.c1), st1, c, d.c1, d.eps);
    a1s[r * ld1 + c] = relu_bn(zh, __ldg(gb1 + c), __ldg(gb1 + d.c1 + c));
  }
  __syncthreads();
}

// z2 = a1 W2 for the thread's 4 x 8 tile, thread (tm2, tn2) of kRowTiles x
// c2 / 8; W2 resident as [j][c] (c1 x c2).
__device__ __forceinline__ void layer2_tile(const float* a1s, int ld1, const float* w2s, const Dims& d,
                                            int tm2, int tn2, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  mma_tile<4, 8, true, false>(a1s, ld1, w2s, d.c2, d.c1, tm2, kRowTiles, tn2, d.c2 / 8, acc);
}

// ------------------------------------------------------------- forward --

struct FwdArgs {
  const float* x;  // (G, s, 3)
  const float *w1, *w2, *w3;
  const float *gb1, *gb2;  // (2, C) [gamma; beta]
  const float *st1, *st2;  // (2, C) [mean; biased var]
  float* part;             // per-block (mean, M2): [block][0|1][C]
  float *zmax, *zmin;      // (G, c3) pooled pre-norm z3
};

// Rows of a pass-3 thread tile: 8 where c3 > 128 (c3 / 8 <= 32 thread
// columns), else 4 (<= 16).
__host__ __device__ inline int fwd_tm3(const Dims& d) { return d.c3 > kMaxHalf3 ? 8 : 4; }

// Shared-memory floats of pass 2 (W2 | x | a1 | z2) and pass 3 (W2 | W3 |
// x | a1, which the epilogue's partials reuse | a2).
__host__ __device__ inline size_t pass2_floats(const Dims& d) {
  return (size_t)d.c1 * d.c2 + 3 * kMaxRows + (size_t)kMaxRows * ((d.c1 + kPad) + (d.c2 + kPad));
}
__host__ __device__ inline size_t pass3_red(const Dims& d) {
  const size_t a1 = (size_t)kMaxRows * (d.c1 + kPad), red = 2 * (size_t)(kMaxRows / fwd_tm3(d)) * d.c3;
  return a1 > red ? a1 : red;
}
__host__ __device__ inline size_t pass3_floats(const Dims& d) {
  return (size_t)d.c1 * d.c2 + (size_t)d.c2 * (d.c3 + kPad) + 3 * kMaxRows + pass3_red(d) +
         (size_t)kMaxRows * (d.c2 + kPad);
}

// Pass 1: z1 = x W1 (K = 3) -> per-block (mean, M2) of z1.
__global__ void __launch_bounds__(kThreads)
mlp_fwd_pass1_kernel(FwdArgs p, Dims d) {
  __shared__ float xs[3 * kMaxRows];
  __shared__ float z1s[kMaxRows * kMaxC1];
  float mean = 0.0f, m2 = 0.0f;
  int tiles = 0;
  for (int grp = blockIdx.x; grp < d.g; grp += gridDim.x, ++tiles) {
    const float* xg = p.x + (size_t)grp * d.s * 3;
    for (int e = threadIdx.x; e < 3 * d.s; e += kThreads) xs[e] = xg[e];
    __syncthreads();  // also: the previous group's column_stats are done
    for (int e = threadIdx.x; e < d.s * d.c1; e += kThreads) {
      const int r = e / d.c1, c = e - r * d.c1;
      z1s[e] = z1_at(xs, p.w1, r, c, d.c1);
    }
    __syncthreads();
    column_stats(z1s, d.c1, d.c1, d.s, tiles, mean, m2);
  }
  if (threadIdx.x < d.c1) {
    p.part[(size_t)blockIdx.x * 2 * d.c1 + threadIdx.x] = mean;
    p.part[(size_t)blockIdx.x * 2 * d.c1 + d.c1 + threadIdx.x] = m2;
  }
}

// Pass 2: a1, z2 = a1 W2 (W2 resident, 4 x 8 thread tiles) -> per-block
// (mean, M2) of z2.
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_pass2_kernel(FwdArgs p, Dims d) {
  extern __shared__ float smem[];
  const int ld1 = d.c1 + kPad, ld2 = d.c2 + kPad;
  float* w2s = smem;  // [j][c] (c1 x c2)
  float* xs = w2s + d.c1 * d.c2;
  float* a1s = xs + 3 * kMaxRows;
  float* z2s = a1s + kMaxRows * ld1;
  const int tid = threadIdx.x;
  for (int e = tid; e < d.c1 * d.c2; e += kThreads) w2s[e] = p.w2[e];
  const int tnt2 = d.c2 / 8;
  const bool act2 = tid < kRowTiles * tnt2;
  const int tm2 = tid / tnt2, tn2 = tid - tm2 * tnt2;
  float mean = 0.0f, m2 = 0.0f;
  int tiles = 0;
  for (int grp = blockIdx.x; grp < d.g; grp += gridDim.x, ++tiles) {
    load_a1(p.x, p.w1, p.gb1, p.st1, d, grp, xs, a1s, ld1);
    if (act2) {
      float acc[4][8];
      layer2_tile(a1s, ld1, w2s, d, tm2, tn2, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tile_index<true>(tm2, kRowTiles, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) z2s[r * ld2 + tile_index<false>(tn2, tnt2, j)] = acc[i][j];
      }
    }
    __syncthreads();
    column_stats(z2s, ld2, d.c2, d.s, tiles, mean, m2);
  }
  if (tid < d.c2) {
    p.part[(size_t)blockIdx.x * 2 * d.c2 + tid] = mean;
    p.part[(size_t)blockIdx.x * 2 * d.c2 + d.c2 + tid] = m2;
  }
}

// Rows of thread row tm (of tmt) in a group of s rows: tm + tmt i < s, i < TM.
template <int TM>
__device__ __forceinline__ int tile_rows(int tm, int tmt, int s) {
  if (tm >= s) return 0;
  const int n = (s - tm + tmt - 1) / tmt;
  return n < TM ? n : TM;
}

// Pass 3.  Block b walks groups b, b + gridDim.x, ... with W2 and W3
// resident.  Per group: a1, a2 (as pass B), z3 = a2 W3 in TM x 8 thread
// tiles, then the epilogue (file note): the block's running (mean, M2) of
// z3 and zmax/zmin.
template <int TM>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_pass3_kernel(FwdArgs p, Dims d) {
  extern __shared__ float smem[];
  constexpr int tmt = kMaxRows / TM;
  const int ld1 = d.c1 + kPad, ld2 = d.c2 + kPad, ld3 = d.c3 + kPad;
  float* w2s = smem;                    // [j][c] (c1 x c2)
  float* w3s = w2s + d.c1 * d.c2;       // [j][c] (c2 x ld3)
  float* xs = w3s + d.c2 * ld3;
  float* a1s = xs + 3 * kMaxRows;       // a1, then the epilogue's partials
  float* a2s = a1s + pass3_red(d);
  float* red = a1s;                     // [2][tmt][d.c3]
  const int tid = threadIdx.x;
  for (int e = tid; e < d.c1 * d.c2; e += kThreads) w2s[e] = p.w2[e];
  for (int e = tid; e < d.c2 * d.c3; e += kThreads) {
    const int j = e / d.c3, c = e - j * d.c3;
    w3s[j * ld3 + c] = p.w3[e];
  }
  const int tnt2 = d.c2 / 8, tnt3 = d.c3 / 8;
  const bool act2 = tid < kRowTiles * tnt2, act3 = tid < tmt * tnt3, own = tid < d.c3;
  const int tm2 = tid / tnt2, tn2 = tid - tm2 * tnt2;
  const int tm3 = tid / tnt3, tn3 = tid - tm3 * tnt3;
  const int nrows = act3 ? tile_rows<TM>(tm3, tmt, d.s) : 0;
  float mean = 0.0f, m2 = 0.0f;
  int tiles = 0;
  for (int grp = blockIdx.x; grp < d.g; grp += gridDim.x, ++tiles) {
    load_a1(p.x, p.w1, p.gb1, p.st1, d, grp, xs, a1s, ld1);
    if (act2) {
      float acc[4][8];
      layer2_tile(a1s, ld1, w2s, d, tm2, tn2, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tile_index<true>(tm2, kRowTiles, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_index<false>(tn2, tnt2, j);
          a2s[r * ld2 + c] = relu_bn(zhat(acc[i][j], p.st2, c, d.c2, d.eps), __ldg(p.gb2 + c),
                                     __ldg(p.gb2 + d.c2 + c));
        }
      }
    }
    __syncthreads();  // a2 is in, and a1 is no longer read: red may take its place
    float mx[8], mn[8];
    if (act3) {
      float acc[TM][8];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      mma_tile<TM, 8, true, false>(a2s, ld2, w3s, ld3, d.c2, tm3, tmt, tn3, tnt3, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float sum = 0.0f;
        mx[j] = -INFINITY;
        mn[j] = INFINITY;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i < nrows) {
            sum += acc[i][j];
            mx[j] = fmaxf(mx[j], acc[i][j]);
            mn[j] = fminf(mn[j], acc[i][j]);
          }
        }
        const float mt = nrows > 0 ? sum / (float)nrows : 0.0f;
        float m2t = 0.0f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i < nrows) m2t += (acc[i][j] - mt) * (acc[i][j] - mt);
        }
        const int c = tile_index<false>(tn3, tnt3, j);
        red[tm3 * d.c3 + c] = mt;
        red[(tmt + tm3) * d.c3 + c] = m2t;
      }
    }
    __syncthreads();
    if (own) {  // the group's (mean, M2) from the row-threads in ascending tm
      float gm = 0.0f, gm2 = 0.0f, gn = 0.0f;
      for (int tm = 0; tm < tmt; ++tm) {
        const float nt = (float)tile_rows<TM>(tm, tmt, d.s);
        if (nt == 0.0f) break;
        chan_add(gm, gm2, gn, red[tm * d.c3 + tid], red[(tmt + tm) * d.c3 + tid], nt);
        gn += nt;
      }
      chan_add(mean, m2, (float)tiles * d.s, gm, gm2, (float)d.s);
    }
    __syncthreads();
    if (act3) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_index<false>(tn3, tnt3, j);
        red[tm3 * d.c3 + c] = mx[j];
        red[(tmt + tm3) * d.c3 + c] = mn[j];
      }
    }
    __syncthreads();
    if (own) {
      float gmax = -INFINITY, gmin = INFINITY;
      for (int tm = 0; tm < tmt; ++tm) {
        gmax = fmaxf(gmax, red[tm * d.c3 + tid]);
        gmin = fminf(gmin, red[(tmt + tm) * d.c3 + tid]);
      }
      p.zmax[(size_t)grp * d.c3 + tid] = gmax;
      p.zmin[(size_t)grp * d.c3 + tid] = gmin;
    }
  }
  if (own) {
    p.part[(size_t)blockIdx.x * 2 * d.c3 + tid] = mean;
    p.part[(size_t)blockIdx.x * 2 * d.c3 + d.c3 + tid] = m2;
  }
}

// ------------------------------------------------------------ backward --

struct BwdArgs {
  const float* x;      // (G, s, 3)
  const float* gpool;  // (G, c3) cotangent of the pooled output
  const float* zext;   // (G, c3) the forward's pooled pre-norm z3 (max, or min where gamma3 < 0)
  const float *w1, *w2, *w3;
  const float *gb1, *gb2, *gb3;  // (2, C) [gamma; beta]
  const float *st1, *st2, *st3;  // (2, C) [mean; biased var]
  const float* sums3;  // (2, c3) [T3; S3] from zext, passes B
  const float* sums2;  // (2, c2) [T2; S2], pass C
  float* r2;           // (P, G * s, c2): pass B's r2 = relu'(a2) da2, one slab per column part
  float* zh2;          // (G * s, c2): zhat2
  float* part_dw;      // pass B: [nblk][c2][c3]; pass C: [block][c1][c2]
  float* part_st;      // pass B: [block][tile row][T2|S2][c2]; pass C: [block][tile row][8][c1]
  float* part_t3;      // pass B: [nblk][T3|S3][c3]
  float* part_sx;      // pass C: [block][3]
};

// T3 and S3 without a recomputing pass.  Only rows that reach their pool
// maximum carry r3; tied rows share one zhat3 and split the cotangent, so a
// group adds gpool * zhat3(zext) to T3 and gpool to S3 where the pooled
// value is > 0.  Block k sums groups [k per, (k+1) per) in order:
// part[k] = [T3; S3].
__global__ void pool_sums_kernel(const float* __restrict__ zext, const float* __restrict__ gpool,
                                 const float* __restrict__ gb3, const float* __restrict__ st3,
                                 Dims d, int per, float* __restrict__ part) {
  const int g0 = blockIdx.x * per;
  const int g1 = min(d.g, g0 + per);
  for (int c = threadIdx.x; c < d.c3; c += blockDim.x) {
    const float m3 = st3[c], rs3 = rsqrtf(st3[d.c3 + c] + d.eps);
    const float g3 = gb3[c], b3 = gb3[d.c3 + c];
    float t = 0.0f, s = 0.0f;
    for (int grp = g0; grp < g1; ++grp) {
      const float zh = (zext[(size_t)grp * d.c3 + c] - m3) * rs3;
      if (relu_bn(zh, g3, b3) > 0.0f) {
        const float q = gpool[(size_t)grp * d.c3 + c];
        t += q * zh;
        s += q;
      }
    }
    part[(size_t)blockIdx.x * 2 * d.c3 + c] = t;
    part[(size_t)blockIdx.x * 2 * d.c3 + d.c3 + c] = s;
  }
}

// Shared-memory floats of pass B: W2 | W3 part | x | a1 | a2 | zhat2 | dz3.
__host__ __device__ inline size_t pass_b_floats(const Dims& d) {
  const int h3 = half3(d);
  return (size_t)d.c1 * d.c2 + (size_t)d.c2 * (h3 + kPad) + 3 * kMaxRows +
         (size_t)kMaxRows * ((d.c1 + kPad) + 2 * (d.c2 + kPad) + (h3 + kPad));
}

// Shared-memory floats of pass C: W2 | x | a1 | zhat1 | dz2.
__host__ __device__ inline size_t pass_c_floats(const Dims& d) {
  return (size_t)d.c1 * (d.c2 + kPad) + 3 * kMaxRows +
         (size_t)kMaxRows * (2 * (d.c1 + kPad) + (d.c2 + kPad));
}

// Pass B.  Block (b, h) walks groups b, b + nblk, ... and owns layer-3
// columns [h c3h, (h+1) c3h), with W2 and its part of W3 resident in shared
// memory.  Per group: recompute a1, a2 (G2) and its part of z3 (G3); pool
// backward and dz3 column by column; dW3 += a2^T dz3 (G-dW3) in registers
// across all the block's groups; da2 = dz3 W3^T (G-da2) over its columns,
// whose r2 goes to device memory as the part's slab (pass C adds the parts
// in order) with per-thread T2, S2 partials.  Part 0 also stores zhat2.
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_pass_b_kernel(BwdArgs p, Dims d) {
  extern __shared__ float smem[];
  const int h3 = half3(d), np = d.c3 / h3;
  const int h = blockIdx.x % np, b = blockIdx.x / np, nblk = gridDim.x / np;
  const int ld1 = d.c1 + kPad, ld2 = d.c2 + kPad, ld3 = h3 + kPad;
  float* w2s = smem;                       // [j][c] (c1 x c2)
  float* w3s = w2s + d.c1 * d.c2;          // [j][c] (c2 x ld3)
  float* xs = w3s + d.c2 * ld3;
  float* a1s = xs + 3 * kMaxRows;
  float* a2s = a1s + kMaxRows * ld1;
  float* zh2s = a2s + kMaxRows * ld2;
  float* dz3s = zh2s + kMaxRows * ld2;     // zhat3, then dz3
  const int tid = threadIdx.x;
  const float n = (float)d.g * (float)d.s;

  for (int e = tid; e < d.c1 * d.c2; e += kThreads) w2s[e] = p.w2[e];
  for (int e = tid; e < d.c2 * h3; e += kThreads) {
    const int j = e / h3, c = e - j * h3;
    w3s[j * ld3 + c] = p.w3[(size_t)j * d.c3 + h * h3 + c];
  }
  // thread tiles: rows x c2 (G2, G-da2: 4 x 8), rows x c3h (G3: 4 x 8), c2 x c3h (G-dW3: 8 x 8)
  const int tnt2 = d.c2 / 8, tnt3 = h3 / 8, tmtw = d.c2 / 8;
  const bool act2 = tid < kRowTiles * tnt2, act3 = tid < kRowTiles * tnt3, actw = tid < tmtw * tnt3;
  const int tm2 = tid / tnt2, tn2 = tid - tm2 * tnt2;
  const int tm3 = tid / tnt3, tn3 = tid - tm3 * tnt3;
  // column-pass constants: thread tid < c3h owns layer-3 column h c3h + tid
  const bool own3 = tid < h3;
  const int hc = h * h3 + (own3 ? tid : 0);
  const float rs3 = rsqrtf(__ldg(p.st3 + d.c3 + hc) + d.eps);
  const float g3 = __ldg(p.gb3 + hc), b3 = __ldg(p.gb3 + d.c3 + hc), gs3 = g3 * rs3;
  const float t3n = __ldg(p.sums3 + hc) / n, s3n = __ldg(p.sums3 + d.c3 + hc) / n;

  float dw3[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dw3[i][j] = 0.0f;
  }
  float t2[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t2[j] = s2[j] = 0.0f;
  float acc_t3 = 0.0f, acc_s3 = 0.0f;
  __syncthreads();

  for (int grp = b; grp < d.g; grp += nblk) {
    load_a1(p.x, p.w1, p.gb1, p.st1, d, grp, xs, a1s, ld1);
    if (act2) {  // G2: z2 = a1 W2 -> zhat2, a2
      float acc[4][8];
      layer2_tile(a1s, ld1, w2s, d, tm2, tn2, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tile_index<true>(tm2, kRowTiles, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_index<false>(tn2, tnt2, j);
          const float zh = zhat(acc[i][j], p.st2, c, d.c2, d.eps);
          zh2s[r * ld2 + c] = zh;
          a2s[r * ld2 + c] = relu_bn(zh, __ldg(p.gb2 + c), __ldg(p.gb2 + d.c2 + c));
          if (h == 0 && r < d.s) p.zh2[((size_t)grp * d.s + r) * d.c2 + c] = zh;
        }
      }
    }
    __syncthreads();
    if (act3) {  // G3: zhat3 of the block's columns
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      mma_tile<4, 8, true, false>(a2s, ld2, w3s, ld3, d.c2, tm3, kRowTiles, tn3, tnt3, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tile_index<true>(tm3, kRowTiles, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_index<false>(tn3, tnt3, j);
          const int cc = h * h3 + c;
          dz3s[r * ld3 + c] = zhat(acc[i][j], p.st3, cc, d.c3, d.eps);
        }
      }
    }
    __syncthreads();
    if (own3) {  // pool backward (ties split evenly, as jnp.max's VJP), dz3 in place
      const int c = tid;
      float pooled = 0.0f;  // every candidate is a relu output, >= 0
      for (int r = 0; r < d.s; ++r) pooled = fmaxf(pooled, relu_bn(dz3s[r * ld3 + c], g3, b3));
      float cnt = 0.0f;
      for (int r = 0; r < d.s; ++r) {
        if (relu_bn(dz3s[r * ld3 + c], g3, b3) == pooled) cnt += 1.0f;
      }
      const float q = __ldg(p.gpool + (size_t)grp * d.c3 + hc) / cnt;
      for (int r = 0; r < kMaxRows; ++r) {
        float v = 0.0f;  // rows past s take no part in G-dW3
        if (r < d.s) {
          const float zh = dz3s[r * ld3 + c];
          const float a = relu_bn(zh, g3, b3);
          const float r3 = (a == pooled && a > 0.0f) ? q : 0.0f;
          acc_t3 += r3 * zh;
          acc_s3 += r3;
          v = gs3 * (r3 - s3n - zh * t3n);
        }
        dz3s[r * ld3 + c] = v;
      }
    }
    __syncthreads();
    if (actw) {  // G-dW3: dW3 += a2^T dz3, K = the group's rows
      const int tmw = tid / tnt3, tnw = tid - tmw * tnt3;
      mma_tile<8, 8, false, false>(a2s, ld2, dz3s, ld3, kMaxRows, tmw, tmtw, tnw, tnt3, dw3);
    }
    if (act2) {  // G-da2: da2 = dz3 W3^T over the block's columns -> r2, T2, S2
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      mma_tile<4, 8, true, true>(dz3s, ld3, w3s, ld3, h3, tm2, kRowTiles, tn2, tnt2, acc);
      float* r2g = p.r2 + (size_t)h * d.g * d.s * d.c2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tile_index<true>(tm2, kRowTiles, i);
        if (r >= d.s) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_index<true>(tn2, tnt2, j);
          const float v = a2s[r * ld2 + c] > 0.0f ? acc[i][j] : 0.0f;
          t2[j] += v * zh2s[r * ld2 + c];
          s2[j] += v;
          r2g[((size_t)grp * d.s + r) * d.c2 + c] = v;
        }
      }
    }
  }

  // per-block partials, reduced in block order by sum_parts_kernel
  if (actw) {
    const int tmw = tid / tnt3, tnw = tid - tmw * tnt3;
    float* pdw = p.part_dw + (size_t)b * d.c2 * d.c3 + h * h3;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = tile_index<false>(tmw, tmtw, i);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) pdw[(size_t)j * d.c3 + tile_index<false>(tnw, tnt3, jj)] = dw3[i][jj];
    }
  }
  if (act2) {
    float* st = p.part_st + ((size_t)blockIdx.x * kRowTiles + tm2) * 2 * d.c2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_index<true>(tn2, tnt2, j);
      st[c] = t2[j];
      st[d.c2 + c] = s2[j];
    }
  }
  if (own3) {
    p.part_t3[(size_t)b * 2 * d.c3 + hc] = acc_t3;
    p.part_t3[(size_t)b * 2 * d.c3 + d.c3 + hc] = acc_s3;
  }
}

// Pass C.  Per group: recompute layer 1 (K = 3); dz2 from pass B's r2
// parts (added in part order) and zhat2; dW2 += a1^T dz2 in registers;
// da1 = dz2 W2^T (W2 resident, K-contiguous) -> r1, T1, S1 and the
// x-moments x^T r1, x^T zhat1, sum x, from which dW1 = x^T dz1 follows
// (K = 3, finish_layer1_kernel).
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_pass_c_kernel(BwdArgs p, Dims d) {
  extern __shared__ float smem[];
  const int np = parts3(d);
  const int ld1 = d.c1 + kPad, ld2 = d.c2 + kPad;
  float* w2s = smem;                    // [j][c] (c1 x ld2)
  float* xs = w2s + d.c1 * ld2;
  float* a1s = xs + 3 * kMaxRows;
  float* zh1s = a1s + kMaxRows * ld1;
  float* dz2s = zh1s + kMaxRows * ld1;
  const int tid = threadIdx.x;
  const float n = (float)d.g * (float)d.s;
  const size_t rows = (size_t)d.g * d.s;

  for (int e = tid; e < d.c1 * d.c2; e += kThreads) {
    const int j = e / d.c2, c = e - j * d.c2;
    w2s[j * ld2 + c] = p.w2[e];
  }
  // thread tiles: c1 x c2 (G-dW2: 4 x 8), rows x c1 (G-da1: 4 x 4)
  const int tmtw = d.c1 / 4, tntw = d.c2 / 8, tnt1 = d.c1 / 4;
  const bool actw = tid < tmtw * tntw, act1 = tid < kRowTiles * tnt1;
  const int tmw = tid / tntw, tnw = tid - tmw * tntw;
  const int tm1 = tid / tnt1, tn1 = tid - tm1 * tnt1;

  float dw2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dw2[i][j] = 0.0f;
  }
  float t1[4], s1[4], xr[3][4], xz[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t1[j] = s1[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) xr[k][j] = xz[k][j] = 0.0f;
  }
  float sx = 0.0f;  // threads 0..2
  __syncthreads();

  for (int grp = blockIdx.x; grp < d.g; grp += gridDim.x) {
    __syncthreads();
    const float* xg = p.x + (size_t)grp * d.s * 3;
    for (int e = tid; e < 3 * kMaxRows; e += kThreads) xs[e] = e < 3 * d.s ? xg[e] : 0.0f;
    __syncthreads();
    for (int e = tid; e < kMaxRows * d.c1; e += kThreads) {
      const int r = e / d.c1, c = e - r * d.c1;
      const float zh = (z1_at(xs, p.w1, r, c, d.c1) - __ldg(p.st1 + c)) *
                       rsqrtf(__ldg(p.st1 + d.c1 + c) + d.eps);
      a1s[r * ld1 + c] = relu_bn(zh, __ldg(p.gb1 + c), __ldg(p.gb1 + d.c1 + c));
      zh1s[r * ld1 + c] = zh;
    }
    if (tid < 3) {
      for (int r = 0; r < d.s; ++r) sx += xs[3 * r + tid];
    }
    const int q4 = d.c2 / 4;
    for (int e = tid; e < kMaxRows * q4; e += kThreads) {  // dz2, zero past s
      const int r = e / q4, c = 4 * (e - r * q4);
      float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < d.s) {
        const size_t o = ((size_t)grp * d.s + r) * d.c2 + c;
        float4 rv = *reinterpret_cast<const float4*>(p.r2 + o);
        for (int h = 1; h < np; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(p.r2 + h * rows * d.c2 + o);
          rv.x += v.x; rv.y += v.y; rv.z += v.z; rv.w += v.w;
        }
        const float4 zv = *reinterpret_cast<const float4*>(p.zh2 + o);
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w}, zz[4] = {zv.x, zv.y, zv.z, zv.w};
        float dz[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int cc = c + k;
          const float gs2 = __ldg(p.gb2 + cc) * rsqrtf(__ldg(p.st2 + d.c2 + cc) + d.eps);
          dz[k] = gs2 * (rr[k] - __ldg(p.sums2 + d.c2 + cc) / n - zz[k] * (__ldg(p.sums2 + cc) / n));
        }
        out = make_float4(dz[0], dz[1], dz[2], dz[3]);
      }
      *reinterpret_cast<float4*>(dz2s + r * ld2 + c) = out;
    }
    __syncthreads();
    if (actw) mma_tile<4, 8, false, false>(a1s, ld1, dz2s, ld2, kMaxRows, tmw, tmtw, tnw, tntw, dw2);
    if (act1) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      mma_tile<4, 4, true, true>(dz2s, ld2, w2s, ld2, d.c2, tm1, kRowTiles, tn1, tnt1, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tile_index<true>(tm1, kRowTiles, i);
        if (r >= d.s) continue;
        const float xv[3] = {xs[3 * r], xs[3 * r + 1], xs[3 * r + 2]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tile_index<true>(tn1, tnt1, j);
          const float r1 = a1s[r * ld1 + c] > 0.0f ? acc[i][j] : 0.0f;
          const float zh = zh1s[r * ld1 + c];
          t1[j] += r1 * zh;
          s1[j] += r1;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            xr[k][j] += xv[k] * r1;
            xz[k][j] += xv[k] * zh;
          }
        }
      }
    }
  }

  if (actw) {
    float* pdw = p.part_dw + (size_t)blockIdx.x * d.c1 * d.c2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tile_index<false>(tmw, tmtw, i);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) pdw[(size_t)j * d.c2 + tile_index<false>(tnw, tntw, jj)] = dw2[i][jj];
    }
  }
  if (act1) {
    float* st = p.part_st + ((size_t)blockIdx.x * kRowTiles + tm1) * 8 * d.c1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tile_index<true>(tn1, tnt1, j);
      st[c] = t1[j];
      st[d.c1 + c] = s1[j];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        st[(2 + k) * d.c1 + c] = xr[k][j];
        st[(5 + k) * d.c1 + c] = xz[k][j];
      }
    }
  }
  if (tid < 3) p.part_sx[(size_t)blockIdx.x * 3 + tid] = sx;
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
         d.c1 % 4 == 0 && d.c2 % 4 == 0 && d.c3 % 4 == 0 &&
         kThreads % d.c1 == 0 && kThreads % d.c2 == 0 && d.c3 <= kThreads;
}

// The kernels' thread tiles: G-da1 takes c1 / 4 <= 16 thread columns,
// G2/G-da2 c2 / 8 <= 16, G3/G-dW3 c3h / 8 <= 16 (c3 splits into parts of 128
// in pass B), forward pass 3 c3 / 8 <= 32; W2 and W3 fit forward pass 3.
bool train_dims_ok(const Dims& d) {
  return dims_ok(d) && d.c1 <= kMaxC1 && d.c2 % 8 == 0 && d.c2 <= 128 && d.c3 % 8 == 0 &&
         d.c3 % half3(d) == 0 && pass_b_floats(d) * sizeof(float) <= kMaxSmem &&
         pass3_floats(d) * sizeof(float) <= kMaxSmem;
}

int light_blocks(const Dims& d, int sm) { return d.g < 2 * sm ? d.g : 2 * sm; }

// pass B: parts3 blocks per group stride, one block per SM
int pass_b_strides(const Dims& d, int sm) {
  const int per = sm / parts3(d) > 0 ? sm / parts3(d) : 1;
  return d.g < per ? d.g : per;
}
// one block per SM: pass C and forward pass 3
int sm_blocks(const Dims& d, int sm) { return d.g < sm ? d.g : sm; }
int pool_chunk(const Dims& d) { return (d.g + kPoolChunks - 1) / kPoolChunks; }

inline size_t round4(size_t v) { return (v + 3) & ~(size_t)3; }

struct BwdScratch {
  float *pool_part, *sums3, *sums1, *sx, *part_dw, *part_st, *part_t3, *part_sx, *r2, *zh2;
};

size_t bwd_scratch(const Dims& d, int sm, float* base, BwdScratch* out) {
  const size_t nb = pass_b_strides(d, sm), gb = nb * parts3(d), nc = sm_blocks(d, sm);
  const size_t rows = (size_t)d.g * d.s;
  const size_t chunks = (d.g + pool_chunk(d) - 1) / pool_chunk(d);
  const size_t dw_b = nb * d.c2 * d.c3, dw_c = nc * d.c1 * d.c2;
  const size_t st_b = gb * kRowTiles * 2 * d.c2, st_c = nc * kRowTiles * 8 * d.c1;
  const size_t sizes[10] = {
      chunks * 2 * d.c3,            // pool_part
      (size_t)2 * d.c3,             // sums3
      (size_t)8 * d.c1,             // sums1
      3,                            // sx
      dw_b > dw_c ? dw_b : dw_c,    // part_dw
      st_b > st_c ? st_b : st_c,    // part_st
      nb * 2 * d.c3,                // part_t3
      nc * 3,                       // part_sx
      parts3(d) * rows * d.c2,      // r2
      rows * d.c2,                  // zh2
  };
  float** ptrs[10] = {&out->pool_part, &out->sums3, &out->sums1, &out->sx, &out->part_dw,
                      &out->part_st, &out->part_t3, &out->part_sx, &out->r2, &out->zh2};
  size_t off = 0;
  for (int i = 0; i < 10; ++i) {
    if (base != nullptr) *ptrs[i] = base + off;
    off += round4(sizes[i]);  // float4 access to r2 and zh2
  }
  return off;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return raise_smem_limit((const void*)kernel, bytes);
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

// 1 if the forward and backward kernels take these dims.
extern "C" int gn_mlp_train_dims_ok(int s, int c1, int c2, int c3) {
  const Dims d = {1, s, c1, c2, c3, 0.0f};
  return train_dims_ok(d) ? 1 : 0;
}

// Forward: st1/st2/st3 = [mean; biased var] of z1/z2/z3, zmax/zmin (G, c3).
extern "C" int gn_mlp_train_fwd(const float* x, const float* w1, const float* w2,
                                const float* w3, const float* gb1, const float* gb2,
                                float* st1, float* st2, float* st3, float* zmax,
                                float* zmin, float* scratch, int g, int s, int c1, int c2,
                                int c3, float eps, int sm, void* stream) {
  const Dims d = {g, s, c1, c2, c3, eps};
  if (!train_dims_ok(d) || sm < 1) return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes2 = pass2_floats(d) * sizeof(float), bytes3 = pass3_floats(d) * sizeof(float);
  const bool wide = fwd_tm3(d) == 8;
  cudaError_t err;
  if ((err = allow_smem(mlp_fwd_pass2_kernel, bytes2)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(wide ? mlp_fwd_pass3_kernel<8> : mlp_fwd_pass3_kernel<4>, bytes3)) != cudaSuccess) {
    return (int)err;
  }
  const int nb = light_blocks(d, sm), nb3 = sm_blocks(d, sm);
  const FwdArgs p = {x, w1, w2, w3, gb1, gb2, st1, st2, scratch, zmax, zmin};
  mlp_fwd_pass1_kernel<<<nb, kThreads, 0, st>>>(p, d);
  chan_reduce_kernel<<<cdiv(32 * c1, 256), 256, 0, st>>>(scratch, nb, c1, g, s, st1);
  mlp_fwd_pass2_kernel<<<nb, kThreads, bytes2, st>>>(p, d);
  chan_reduce_kernel<<<cdiv(32 * c2, 256), 256, 0, st>>>(scratch, nb, c2, g, s, st2);
  if (wide) {
    mlp_fwd_pass3_kernel<8><<<nb3, kThreads, bytes3, st>>>(p, d);
  } else {
    mlp_fwd_pass3_kernel<4><<<nb3, kThreads, bytes3, st>>>(p, d);
  }
  chan_reduce_kernel<<<cdiv(32 * c3, 256), 256, 0, st>>>(scratch, nb3, c3, g, s, st3);
  return (int)cudaGetLastError();
}

// Backward: dw1 (3, c1), dw2 (c1, c2), dw3 (c2, c3), dgb_l = [dgamma; dbeta];
// zext is the forward's pooled pre-norm z3 (G, c3).
extern "C" int gn_mlp_train_bwd(const float* x, const float* gpool, const float* zext,
                                const float* w1, const float* w2, const float* w3,
                                const float* gb1, const float* gb2, const float* gb3,
                                const float* st1, const float* st2, const float* st3,
                                float* dw1, float* dw2, float* dw3, float* dgb1, float* dgb2,
                                float* dgb3, float* scratch, int g, int s, int c1, int c2,
                                int c3, float eps, int sm, void* stream) {
  const Dims d = {g, s, c1, c2, c3, eps};
  if (!train_dims_ok(d) || sm < 1) return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  BwdScratch sc;
  bwd_scratch(d, sm, scratch, &sc);
  const size_t bytes_b = pass_b_floats(d) * sizeof(float);
  const size_t bytes_c = pass_c_floats(d) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(mlp_bwd_pass_b_kernel, bytes_b)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(mlp_bwd_pass_c_kernel, bytes_c)) != cudaSuccess) return (int)err;
  const int nb = pass_b_strides(d, sm), gb = nb * parts3(d), nc = sm_blocks(d, sm);
  const int per = pool_chunk(d), chunks = cdiv(g, per);

  BwdArgs p = {x, gpool, zext, w1, w2, w3, gb1, gb2, gb3, st1, st2, st3, sc.sums3, dgb2,
               sc.r2, sc.zh2, sc.part_dw, sc.part_st, sc.part_t3, sc.part_sx};
  // T3, S3 for dz3, from zext and the cotangent
  pool_sums_kernel<<<chunks, 256, 0, st>>>(zext, gpool, gb3, st3, d, per, sc.pool_part);
  sum_parts_kernel<<<cdiv(2 * c3, 256), 256, 0, st>>>(sc.pool_part, chunks, 2 * c3, sc.sums3);
  // B: dw3, dgb3 = [T3; S3] as routed, dgb2 = [T2; S2], r2 and zhat2
  mlp_bwd_pass_b_kernel<<<gb, kThreads, bytes_b, st>>>(p, d);
  sum_parts_kernel<<<cdiv(c2 * c3, 256), 256, 0, st>>>(sc.part_dw, nb, c2 * c3, dw3);
  sum_parts_kernel<<<cdiv(2 * c3, 256), 256, 0, st>>>(sc.part_t3, nb, 2 * c3, dgb3);
  sum_parts_kernel<<<cdiv(2 * c2, 256), 256, 0, st>>>(sc.part_st, gb * kRowTiles, 2 * c2, dgb2);
  // C: dw2, then dw1 and dgb1 from the layer-1 sums
  mlp_bwd_pass_c_kernel<<<nc, kThreads, bytes_c, st>>>(p, d);
  sum_parts_kernel<<<cdiv(c1 * c2, 256), 256, 0, st>>>(sc.part_dw, nc, c1 * c2, dw2);
  sum_parts_kernel<<<cdiv(8 * c1, 256), 256, 0, st>>>(sc.part_st, nc * kRowTiles, 8 * c1, sc.sums1);
  sum_parts_kernel<<<1, 32, 0, st>>>(sc.part_sx, nc, 3, sc.sx);
  finish_layer1_kernel<<<cdiv(c1, 128), 128, 0, st>>>(sc.sums1, sc.sx, gb1, st1, d, dw1, dgb1);
  return (int)cudaGetLastError();
}
