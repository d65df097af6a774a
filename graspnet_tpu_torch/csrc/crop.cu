// Fused crop: query + first-hits gather + frame transform + BN-folded MLP +
// max over samples.  The crop group (K6), the same front half writing the
// offsets instead of running the MLP, is query.cu's cylinder scan.
//
// Replaces graspnet_tpu/ops/pallas/crop.py::crop_fused_pallas (K5, the
// inference CloudCrop; body _crop_kernel over _gather_grouped_core) and
// sa1_fused_pallas (K3, which is crop_fused_pallas(ball=True,
// normalize=1/r)), each with a scan of query.cu as its first launch; and
// sa_feat_fused_pallas (K9, the SA2-4 stage, below).  Per center:
//   1. the query masks: cylinder mode y_r^2+z_r^2 < r^2 and
//      hmin < x_r < hmax_d for every depth d, with the transposed rotation
//      x_r = dx*R00 + dy*R10 + dz*R20; ball mode dx^2+dy^2+dz^2 < r^2;
//   2. the first ns hits per depth, in index order;
//   3. padding on the raw coordinates: an empty slot takes the first hit,
//      a selection with no hits takes point 0 (crop.py:145-157);
//   4. centre subtraction, then offset @ R (cylinder) and * normalize;
//   5. the folded MLP relu(x @ W' + b') three times (3 -> c1 -> c2 -> c3);
//   6. the max over the ns samples -> out[center, d, :].
// The crop group (K6, crop_group_pallas) stops after step 4 and writes the
// (D, ns, 3) offsets: query.cu's cylinder_scan_kernel (Out 1).
//
// SA1 (K3, ball mode): steps 1-3 are K4's ball scan (query.cu,
// ball_scan_kernel, launched by the wrapper through gn_ball_query), which
// writes the padded indices (B, M, ns) to a scratch; then sa1_mlp_tc_kernel
// builds each group's rows from them (step 4: xyz[idx] - centre, then x 1/r,
// each op rounded, so the offsets are bitwise those of the plain version)
// and runs steps 5-6 as K5's MLP does, below.  The scan
// writes indices rather than offsets: they are what the scan makes anyway
// (2 MB at B=2), K4 stays one kernel with one output, and the gather is 3
// loads a row that the MLP's prologue starts one group ahead.  Per frame
// the MLP is 2048 x 64 rows through 3 -> 64 -> 64 -> 128 (3.3 GFLOP; bound
// 3 x 6.5 GFLOP at B=2, 0.04 ms at 495 TFLOP/s) and the scan tests a few
// tens of millions of point-center pairs.  SA1's layout takes 88 KB, so two
// blocks share an SM and the grid is sized by occupancy; with 64 and 128
// columns, layer 2 splits its m tiles over two warps and layer 3 takes 2
// column tiles a warp, so all 8 warps work (K5's 2 + 4 would leave warps
// 4-7 idle).

// CloudCrop (K5, cylinder mode): steps 1-4 are the crop group's scan
// (query.cu's cylinder_scan_kernel, launched by the wrapper through
// gn_cylinder_scan: a warp per centre over the TMA-fed ring of K4, the
// offsets bitwise the plain version's) into a (B, M, D, ns, 3) scratch,
// then crop_mlp_tc_kernel (gn_crop_mlp) runs steps 5-6 on the tensor cores.
// Per frame the MLP is 1024 x 4 x 64 rows through 3 -> 64 -> 128 -> 256
// (21.6 GFLOP); the scan tests 20.5 M point-center pairs.  The two halves
// want opposite shapes: the scan is bound by its tests and the block's
// slowest centre and wants a warp per centre, the MLP wants its 160 KB of
// folded W2/W3 resident, which leaves one block per SM.  So they are two
// launches, and the offsets (6.3 MB at B=2) go through device memory once.
//   crop_mlp_tc_kernel (and sa1_mlp_tc_kernel, the same body tc_mlp with
// other rows and warp tiles): about one block per SM walks the (centre, depth)
// groups with W2 and W3 resident in shared memory (f32, transposed, loaded
// once per block).  A group's ns rows, padded to m16 tiles, go through layer
// 1 (K = 3) on the CUDA cores in the JAX broadcast-sum order, then layers 2
// and 3 as mma.sync.m16n8k8 TF32 products in 3xTF32: each f32 operand x
// splits into hi = tf32(x) (round to nearest, ties away: cvt.rna's bits)
// and lo = x - hi, which the tensor core reads as TF32 (truncated), and the
// f32 accumulator takes lo*hi + hi*lo + hi*hi.  The error is ~2^-21
// relative, f32-accurate for the 1e-4 feature gate (plain TF32 keeps ~3
// digits and would break it).  Operands come from shared memory by
// ldmatrix.x4 and are split on the fly (pre-split hi/lo weights would need
// 330 KB).  Layer 3's accumulators are max-reduced over rows in registers
// and warp shuffles straight into out: a warp owns 32 columns over all rows,
// so h3 never exists and no cross-warp reduction is needed.  Rows are padded
// to a stride of 4 mod 32 floats (bank_ld), so every ldmatrix phase hits 32
// banks.  What bounds it: the splits and fragment loads on the CUDA cores,
// not the tensor cores (on an earlier version of this loop one mma per tile
// in place of three saved 9 %); bound 3 x 43.2 GFLOP at B=2, 0.26 ms at
// 495 TFLOP/s.
//

// The fused SA2-4 stage (K9, sa_feat_fused_pallas, crop.py:547; body
// _sa_feat_kernel, crop.py:448-519): per centre the ball query's first ns
// hits, padded as above (a centre with no hits takes point 0), the offsets
// x (1/r) (crop.py:491-493) beside the features at those indices, the folded
// MLP over [xyz | features] (3 + C -> c1 -> c2 -> c3) and the max over the
// samples -> out[center, :].  Two launches, as K3: K4's ball scan writes the
// padded indices (B, M, ns), then sa_feat_tc_kernel runs the MLP on the
// tensor cores in 3xTF32.  Its bound is the products', 12.7 GFLOP at B=2
// over SA2-4 (1024 x 32 rows at 131 -> 128 -> 128 -> 256, 512 x 16 and 256 x
// 16 rows at 259 -> 128 -> 128 -> 256 per frame), 0.077 ms at 3 x flops /
// 495 TFLOP/s; K4's scans take ~0.014 ms a call at these shapes.  The design:
//   - a persistent block per SM walks row tiles made of whole centres (a
//     centre takes 16, 32 or 64 rows, its padded rows zero and masked out of
//     the max): 128 rows where that layout holds two weight-ring stages (SA2:
//     4 centres a tile), else 64 (SA3-4, whose 256-float feature rows leave
//     no room: 4 centres a tile);
//   - the weights (W1[3:] + W2 + W3, 66-82k floats at the production widths)
//     do not fit beside a tile's activations, so they stream through a ring
//     of shared-memory stages of kSaSliceK weight rows, one 1-D bulk copy
//     (TMA) per row onto the stage's mbarrier, fed by a producer warp of its
//     own (a warp specialised as Hopper's GEMMs do); a slice serves all the
//     tile's m tiles, so the weights are read from L2 once per tile (a block
//     per centre read them once per 16 or 32 rows).  The slices, not the
//     products, held the first version back: on an H100 it kept 60 % of its
//     time without its products, 16-row slices ran 15 % slower than 32,
//     128-row tiles 21 % faster than 64 at SA2, and the producer warp, in
//     place of a block barrier per slice and thread 0 refilling the stage,
//     22 % faster again (PERF.md §6);
//   - a stage keeps W row-major [k][n] with a row stride of 8 (mod 32)
//     floats, and lane (g, t) loads its B fragment (k = t and t + 4, n = g)
//     by scalar ld.shared from 32 distinct banks: no transposing pass and no
//     transposed copy of the weights in device memory;
//   - layer 1's K = C feature product runs on the tensor cores; its xyz part
//     (K = 3) and the bias are added on the CUDA cores in the epilogue, in
//     _sa_feat_kernel's order (crop.py:505-510), the offsets rounded as
//     BallRows rounds them;
//   - a1 overwrites the feature rows, a2 has its own buffer, and layer 3's
//     accumulators are max-reduced over each centre's rows in registers and
//     warp shuffles straight into out, so h3 never exists;
//   - the next tile's feature rows (C contiguous floats each, 16-byte
//     cp.async, zero-filled for padded rows), points and centres are copied
//     in as soon as layer 2 has consumed a1, so the gather overlaps layer 3.
// A warp owns one item of a layer, 4 m tiles x NJ column tiles: at 64 rows
// the 8 warps cover 128 columns (layers 1-2, NJ 2) or 256 (layer 3, NJ 4),
// at 128 rows 2 x 4 items of NJ 4 cover 128 columns, and layer 3 runs in
// passes where its columns need more items.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSamples = 64;

// ---------------------------------------------- K5: tensor-core crop MLP --

constexpr int kTile = 16;                     // rows of an mma tile
constexpr size_t kMaxSmemBytes = 232448;      // shared memory a block may use

// Smallest ld >= k with ld = 4 (mod 32) floats: the 8 rows of 16 bytes that
// an ldmatrix phase reads fall in 32 distinct banks.
__host__ __device__ inline int bank_ld(int k) { return k + ((4 - k) % 32 + 32) % 32; }

// Shared-memory floats of crop_mlp_tc_kernel: W2^T | W3^T | a1 | a2 |
// samples.  Every mma operand is K-contiguous: [n][k] for the weights,
// [row][k] for the activations.
struct TcLayout {
  int ld1, ld2;  // row strides of the K = c1 operands (W2^T, a1) and K = c2 ones (W3^T, a2)
  size_t w3, a1, a2, smp, floats;
};

__host__ __device__ inline TcLayout tc_layout(int c1, int c2, int c3) {
  TcLayout l;
  l.ld1 = bank_ld(c1);
  l.ld2 = bank_ld(c2);
  l.w3 = (size_t)c2 * l.ld1;
  l.a1 = l.w3 + (size_t)c3 * l.ld2;
  l.a2 = l.a1 + (size_t)kMaxSamples * l.ld1;
  l.smp = l.a2 + (size_t)kMaxSamples * l.ld2;
  l.floats = l.smp + 3 * kMaxSamples;
  return l;
}

// W (k_dim x n, row-major in device memory) -> wt[c * ld + j] = W[j][c]
__device__ __forceinline__ void load_transposed(const float* __restrict__ w, int k_dim, int n,
                                                float* wt, int ld) {
  for (int e = threadIdx.x; e < k_dim * n; e += kThreads) {
    const int j = e / n, c = e - j * n;
    wt[c * ld + j] = __ldg(w + e);
  }
}

// hi = tf32(x), rounded to nearest with ties away from zero (the bits
// cvt.rna.tf32.f32 gives, in two integer ops); lo = x - hi, exact, whose low
// 13 bits the tensor core ignores (lo rounds to TF32 toward zero).  hi + lo
// meets x within 2^-21 |x|.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// Four 8 x 4 tiles of 32-bit words from shared memory: lanes 8i .. 8i+7
// address the rows of tile i; r[i] holds word (lane % 4) of row lane / 4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][j] += A(16m .. 16m+15, 0:K) B(0:K, column tile t0 + j) in 3xTF32,
// m < MT, K % 8 == 0.  A is [row][k] with stride lda, B is held transposed,
// [n][k] with stride ldb; tiles past tlast read tile tlast (computed, never
// stored).  Fragments of m16n8k8 (lane = 4 g + t): A (g, t), (g+8, t),
// (g, t+4), (g+8, t+4), one ldmatrix.x4 per m tile (lanes 0-15 address
// rows 16m + lane at k0, lanes 16-31 the same rows at k0 + 4); B (k = t,
// n = g), (t+4, g), one ldmatrix.x4 per two column tiles.  Per k step the
// small terms go first, lo*hi, hi*lo, hi*hi, each over every (m, j) in
// turn: a warp runs its instructions in order, and consecutive mmas into one accumulator
// would wait out each other's latency.
template <int MT, int NJ>
__device__ __forceinline__ void mma_3xtf32(const float* A, int lda, const float* B, int ldb, int t0,
                                           int tlast, int k_dim, float (&acc)[MT][NJ][4]) {
  const int lane = threadIdx.x & 31;
  const float* ap = A + (lane & 15) * lda + (lane >> 4) * 4;
  const float* bp[NJ / 2];
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    const int tile = min(t0 + j + (lane >> 4), tlast);
    bp[j / 2] = B + (8 * tile + (lane & 7)) * ldb + ((lane >> 3) & 1) * 4;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < k_dim; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, bp[j / 2] + k0);
      split_tf32(r[0], bh[j][0], bl[j][0]);
      split_tf32(r[1], bh[j][1], bl[j][1]);
      split_tf32(r[2], bh[j + 1][0], bl[j + 1][0]);
      split_tf32(r[3], bh[j + 1][1], bl[j + 1][1]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t r[4];
      ldmatrix_x4(r, ap + kTile * m * lda + k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(r[i], ah[m][i], al[m][i]);
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[m][j], term == 0 ? al[m] : ah[m], term == 1 ? bl[j] : bh[j]);
      }
    }
  }
}

// A group's rows from the CloudCrop's offsets, (G, ns, 3) floats in
// device memory: thread e < 3 ns holds float e, fetched one group ahead.
struct GroupedRows {
  const float* grouped;
  int ns;
  float next;

  __device__ __forceinline__ void start(int grp, int groups) {
    next = 0.0f;
    if (grp < groups && threadIdx.x < 3 * ns) next = __ldg(grouped + (size_t)grp * 3 * ns + threadIdx.x);
  }
  // smp (rows, 3) <- group grp, padded rows zero; then fetch group `ahead`
  __device__ __forceinline__ void put(float* smp, int rows, int ahead, int groups) {
    const int e = threadIdx.x;
    if (e < 3 * rows) smp[e] = e < 3 * ns ? next : 0.0f;
    if (ahead < groups && e < 3 * ns) next = __ldg(grouped + (size_t)ahead * 3 * ns + e);
  }
};

// A group's rows built from SA1's padded ball-query indices (G, ns) int64:
// thread r < ns holds row r, the point xyz[scene, idx[grp, r]] and the
// group's centre, one group ahead, and the index two groups ahead, so no
// load waits on another.  The row is (point - centre) x normalize, each op
// rounded (so the offsets are bitwise those of the plain version's gather).
struct BallRows {
  const int64_t* idx;
  const float* xyz;
  const float* centers;
  int n, m, ns;
  float normalize;
  float p[3], c[3];
  int next_idx;

  __device__ __forceinline__ void fetch_point(int grp) {  // p, c <- group grp at next_idx
    const float* pt = xyz + ((size_t)(grp / m) * n + next_idx) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = __ldg(pt + k);
      c[k] = __ldg(centers + (size_t)grp * 3 + k);
    }
  }
  __device__ __forceinline__ void start(int grp, int groups) {
    const int r = threadIdx.x;
    if (grp >= groups || r >= ns) return;
    next_idx = (int)__ldg(idx + (size_t)grp * ns + r);
    fetch_point(grp);
    const int ahead = grp + gridDim.x;
    if (ahead < groups) next_idx = (int)__ldg(idx + (size_t)ahead * ns + r);
  }
  __device__ __forceinline__ void put(float* smp, int rows, int ahead, int groups) {
    const int r = threadIdx.x;
    if (r < rows) {
#pragma unroll
      for (int k = 0; k < 3; ++k) smp[3 * r + k] = r < ns ? __fmul_rn(__fsub_rn(p[k], c[k]), normalize) : 0.0f;
    }
    if (ahead < groups && r < ns) {
      fetch_point(ahead);
      const int later = ahead + gridDim.x;
      if (later < groups) next_idx = (int)__ldg(idx + (size_t)later * ns + r);
    }
  }
};

// Steps 5-6 on the tensor cores: the rows of group g (ns of them) ->
// out (g, c3) = max over the rows of relu(relu(relu(x W1 + b1) W2 + b2) W3
// + b3), with MT = ceil(ns / 16) m tiles.  Persistent: block b runs groups
// b, b + gridDim.x, ...  A warp's share of layer 2 is N2 column tiles over
// MT / MS2 m tiles, of layer 3 N3 column tiles over all MT (so the max over
// rows stays in the warp); the launchers pick them so that all 8 warps
// work at their widths.
template <int MT, int MS2, int N2, int N3, class Rows>
__device__ __forceinline__ void tc_mlp(Rows rows_in, int groups, int ns,
                                       const float* __restrict__ w1, const float* __restrict__ b1,
                                       const float* __restrict__ w2, const float* __restrict__ b2,
                                       const float* __restrict__ w3, const float* __restrict__ b3,
                                       float* __restrict__ out, int c1, int c2, int c3) {
  static_assert(MT % MS2 == 0, "layer 2's m parts split the m tiles evenly");
  extern __shared__ __align__(16) float tc_smem[];
  constexpr int rows = MT * kTile;
  constexpr int MP = MT / MS2;  // m tiles of a layer-2 part
  const TcLayout l = tc_layout(c1, c2, c3);
  float* w2t = tc_smem;
  float* w3t = tc_smem + l.w3;
  float* a1s = tc_smem + l.a1;
  float* a2s = tc_smem + l.a2;
  float* smp = tc_smem + l.smp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nt2 = c2 / 8, nt3 = c3 / 8;
  const int parts2 = (nt2 + N2 - 1) / N2;

  load_transposed(w2, c1, c2, w2t, l.ld1);
  load_transposed(w3, c2, c3, w3t, l.ld2);
  rows_in.start(blockIdx.x, groups);

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    __syncthreads();  // the weights are in; the previous group's layer 1 is done
    rows_in.put(smp, rows, grp + gridDim.x, groups);
    __syncthreads();

    // layer 1 (K = 3): the broadcast-sum on the CUDA cores
    for (int e = tid; e < rows * c1; e += kThreads) {
      const int row = e / c1, c = e - row * c1;
      const float v = smp[3 * row] * __ldg(w1 + c) + smp[3 * row + 1] * __ldg(w1 + c1 + c) +
                      smp[3 * row + 2] * __ldg(w1 + 2 * c1 + c) + __ldg(b1 + c);
      a1s[row * l.ld1 + c] = fmaxf(v, 0.0f);
    }
    __syncthreads();

    // layer 2: a2 = relu(a1 W2 + b2); item i: column tiles N2 (i % parts2)
    // on, m tiles MP (i / parts2) on
    for (int item = warp; item < parts2 * MS2; item += kWarps) {
      const int part = MS2 == 1 ? 0 : item / parts2;  // no division where the m tiles are not split
      const int t0 = N2 * (item - part * parts2), mt0 = MP * part;
      float acc[MP][N2][4] = {};
      mma_3xtf32<MP, N2>(a1s + kTile * mt0 * l.ld1, l.ld1, w2t, l.ld1, t0, nt2 - 1, c1, acc);
#pragma unroll
      for (int j = 0; j < N2; ++j) {
        if (t0 + j >= nt2) continue;
        const int col = 8 * (t0 + j) + 2 * t;
        const float bb0 = __ldg(b2 + col), bb1 = __ldg(b2 + col + 1);
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const int r = kTile * (mt0 + m) + g;
          *reinterpret_cast<float2*>(a2s + r * l.ld2 + col) =
              make_float2(fmaxf(acc[m][j][0] + bb0, 0.0f), fmaxf(acc[m][j][1] + bb1, 0.0f));
          *reinterpret_cast<float2*>(a2s + (r + 8) * l.ld2 + col) =
              make_float2(fmaxf(acc[m][j][2] + bb0, 0.0f), fmaxf(acc[m][j][3] + bb1, 0.0f));
        }
      }
    }
    __syncthreads();

    // layer 3 folded into the max over the ns rows: registers, then the 8
    // lanes that share a column (xor 4, 8, 16)
    for (int t0 = N3 * warp; t0 < nt3; t0 += N3 * kWarps) {
      float acc[MT][N3][4] = {};
      mma_3xtf32<MT, N3>(a2s, l.ld2, w3t, l.ld2, t0, nt3 - 1, c2, acc);
#pragma unroll
      for (int j = 0; j < N3; ++j) {
        if (t0 + j >= nt3) continue;  // warp-uniform
        const int col = 8 * (t0 + j) + 2 * t;
        const float bb0 = __ldg(b3 + col), bb1 = __ldg(b3 + col + 1);
        float m0 = 0.0f, m1 = 0.0f;  // every candidate is a relu output, >= 0
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = kTile * m + g;
          if (r < ns) {
            m0 = fmaxf(m0, fmaxf(acc[m][j][0] + bb0, 0.0f));
            m1 = fmaxf(m1, fmaxf(acc[m][j][1] + bb1, 0.0f));
          }
          if (r + 8 < ns) {
            m0 = fmaxf(m0, fmaxf(acc[m][j][2] + bb0, 0.0f));
            m1 = fmaxf(m1, fmaxf(acc[m][j][3] + bb1, 0.0f));
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        if (g == 0) *reinterpret_cast<float2*>(out + (size_t)grp * c3 + col) = make_float2(m0, m1);
      }
    }
  }
}

// K5's MLP: grouped (G, ns, 3) offsets; W2 and W3 at K5's widths take one
// block per SM, and 2 + 4 column tiles a warp keep its 8 warps busy at
// 128 and 256 columns.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
crop_mlp_tc_kernel(const float* __restrict__ grouped, int groups, int ns,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   float* __restrict__ out, int c1, int c2, int c3) {
  tc_mlp<MT, 1, 2, 4>(GroupedRows{grouped, ns}, groups, ns, w1, b1, w2, b2, w3, b3, out, c1, c2, c3);
}

// K3's MLP: rows from the ball scan's padded indices (B, M, ns), groups =
// B M.  SA1's layout (3 -> 64 -> 64 -> 128) takes 88 KB, so two blocks
// share an SM (registers capped at 128 a thread); layer 2 (8 column tiles)
// splits the m tiles in two where MT is even, layer 3 (16) takes 2 column
// tiles a warp.
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
sa1_mlp_tc_kernel(BallRows rows, int groups,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out, int c1, int c2, int c3) {
  tc_mlp<MT, MT % 2 == 0 ? 2 : 1, 2, 2>(rows, groups, rows.ns, w1, b1, w2, b2, w3, b3, out, c1, c2, c3);
}

// ------------------------------------------- K9: the SA2-4 stage's MLP --

constexpr int kSaItemM = 4;              // m tiles of a warp's item
constexpr int kSaItemN3 = 4;             // column tiles of a warp's item in layer 3
constexpr int kSaSliceK = 32;            // weight rows a ring stage holds
constexpr int kSaMaxStages = 4;
constexpr size_t kSaStaticBytes = 1024;  // the ring's barriers, with room

// Smallest ld >= n with ld = 8 (mod 32) floats: lane (g, t)'s B loads, at
// row k0 + t and column 8 j + g, fall in banks 8 t + g + const, 32 distinct.
__host__ __device__ inline int bank8_ld(int n) { return n + ((8 - n) % 32 + 32) % 32; }

// Column tiles of a warp's item in a layer of n columns: 2, or 4 where 2
// leave column tiles over for the col_parts items; 0 where 4 do too.
__host__ __device__ inline int sa_item_tiles(int n, int col_parts) {
  return (n / 8 + 1) / 2 <= col_parts ? 2 : (n / 8 + 3) / 4 <= col_parts ? 4 : 0;
}

// The row tile of sa_feat_tc_kernel, tm m tiles (4 or 8: 64 or 128 rows),
// and its shared memory, in floats: the tile's rows (the features, then
// a1) | a2 | the rows' points | their centres | the weight ring, as many
// stages (<= kSaMaxStages) as fit.  The 8 warps' items split the rows in
// row_parts and a layer's columns in col_parts; layer 3 runs in passes of
// cols3 columns, kSaItemN3 column tiles an item.
struct SaLayout {
  int rows, row_parts, col_parts, ldx, ld2, ldw, cols3, passes3, nj12, stages;
  size_t a2, pts, cen, ring, stage, floats;
};

__host__ __device__ inline SaLayout sa_layout(int tm, int c_in, int c1, int c2, int c3) {
  SaLayout l;
  l.rows = tm * kTile;
  l.row_parts = tm / kSaItemM;
  l.col_parts = kWarps / l.row_parts;
  l.ldx = bank_ld(c_in > c1 ? c_in : c1);
  l.ld2 = bank_ld(c2);
  l.cols3 = c3 < 8 * kSaItemN3 * l.col_parts ? c3 : 8 * kSaItemN3 * l.col_parts;
  l.passes3 = (c3 + l.cols3 - 1) / l.cols3;
  const int nj1 = sa_item_tiles(c1, l.col_parts), nj2 = sa_item_tiles(c2, l.col_parts);
  l.nj12 = nj1 == 0 || nj2 == 0 ? 0 : (nj1 > nj2 ? nj1 : nj2);
  const int wide = c1 > c2 ? c1 : c2;
  l.ldw = bank8_ld(wide > l.cols3 ? wide : l.cols3);
  l.a2 = (size_t)l.rows * l.ldx;
  l.pts = l.a2 + (size_t)l.rows * l.ld2;
  l.cen = l.pts + 3 * l.rows;
  l.ring = l.cen + 3 * l.rows;
  l.stage = (size_t)kSaSliceK * l.ldw;
  const size_t room = (kMaxSmemBytes - kSaStaticBytes) / sizeof(float);
  const size_t fit = l.ring < room ? (room - l.ring) / l.stage : 0;
  l.stages = fit < kSaMaxStages ? (int)fit : kSaMaxStages;
  l.floats = l.ring + (size_t)l.stages * l.stage;
  return l;
}

// The row tile a call takes: 128 rows where that layout holds the widths
// with two ring stages (fewer weight slices per row), else 64; 0 where
// neither does.
__host__ __device__ inline int sa_tile_m(int c_in, int c1, int c2, int c3) {
  for (int tm = 8; tm >= 4; tm -= 4) {
    const SaLayout l = sa_layout(tm, c_in, c1, c2, c3);
    if (l.nj12 != 0 && l.stages >= 2) return tm;
  }
  return 0;
}

struct SaArgs {
  const int64_t* idx;     // K4's padded indices (groups, ns)
  const float* xyz;       // (B, N, 3)
  const float* centers;   // (groups, 3), groups = B M
  const float* feat;      // (B, N, c_in), 16-byte aligned
  const float *w1, *b1, *w2, *b2, *w3, *b3;  // folded, row-major [k][n], 16-byte aligned
  float* out;             // (groups, c3)
  int n, m, groups, ns, rpc, tm, c_in, c1, c2, c3;  // rpc: rows a centre takes, 16, 32 or 64; tm: sa_tile_m
  float inv_radius;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// cp.async of 16 (4) bytes; zeros where !ok (no byte is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// acc[m][j] += A(16 m .. 16 m + 15, 0:K) B(0:K, column tile t0 + j) in
// 3xTF32, m < kSaItemM, K % 8 == 0, as mma_3xtf32 forms it, but with B
// row-major [k][n] (stride ldb = 8 mod 32): lane (g, t) loads b0 = B[k0 +
// t][8 tile + g] and b1 = B[k0 + t + 4][8 tile + g].  Tiles past tlast read
// tile tlast (computed, never stored).
template <int NJ>
__device__ __forceinline__ void mma_3xtf32_kn(const float* A, int lda, const float* B, int ldb, int t0,
                                              int tlast, int k_dim, float (&acc)[kSaItemM][NJ][4]) {
  const int lane = threadIdx.x & 31;
  const float* ap = A + (lane & 15) * lda + (lane >> 4) * 4;
  const float* bp = B + (lane & 3) * ldb + (lane >> 2);
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = 8 * min(t0 + j, tlast);
#pragma unroll 2
  for (int k0 = 0; k0 < k_dim; k0 += 8) {
    uint32_t ah[kSaItemM][4], al[kSaItemM][4], bh[NJ][2], bl[NJ][2];
    const float* bk = bp + k0 * ldb;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      split_tf32(__float_as_uint(bk[col[j]]), bh[j][0], bl[j][0]);
      split_tf32(__float_as_uint(bk[4 * ldb + col[j]]), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int m = 0; m < kSaItemM; ++m) {
      uint32_t r[4];
      ldmatrix_x4(r, ap + kTile * m * lda + k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(r[i], ah[m][i], al[m][i]);
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {
#pragma unroll
      for (int m = 0; m < kSaItemM; ++m) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[m][j], term == 0 ? al[m] : ah[m], term == 1 ? bl[j] : bh[j]);
      }
    }
  }
}

// The weight ring.  Per tile the slices of W1[3:] (K = c_in), W2 (K = c1)
// and W3 (K = c2, pass by pass over its columns), kSaSliceK rows each, in
// the order the layers take them; slice i of the block's walk goes to stage
// i % stages.  A producer warp of its own fills the stages: stage s's full
// barrier completes when its bulk copies have landed, and its empty barrier
// when the 8 warps have each arrived past it, so no warp waits for another
// at a slice.
struct SaRing {
  const float *w1, *w2, *w3;
  float* ring;
  uint64_t* full;
  uint64_t* empty;
  size_t stage;
  int c_in, c1, c2, c3, cols3, ldw, stages, s1, s2, s3, per_tile, total;
  int next;  // the slice the warps take next

  // The producer warp: slice i into its stage, a bulk copy per weight row,
  // lane l copying rows l, l + 32, ...
  __device__ void issue(int i, int lane) const {
    int j = i % per_tile;
    const float* w;
    int ld, k0, rows, n0 = 0, cols;
    if (j < s1) {
      w = w1 + 3 * (size_t)c1;
      ld = cols = c1;
      k0 = j * kSaSliceK;
      rows = c_in - k0;
    } else if ((j -= s1) < s2) {
      w = w2;
      ld = cols = c2;
      k0 = j * kSaSliceK;
      rows = c1 - k0;
    } else {
      j -= s2;
      const int pass = j / s3;
      w = w3;
      ld = c3;
      k0 = (j - pass * s3) * kSaSliceK;
      rows = c2 - k0;
      n0 = pass * cols3;
      cols = min(cols3, c3 - n0);
    }
    rows = min(rows, kSaSliceK);
    const int s = i % stages;
    float* dst = ring + s * stage;
    const uint32_t bar = smem_u32(full + s);
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(rows * cols * 4)
                   : "memory");
    }
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(dst + r * ldw)), "l"(w + (size_t)(k0 + r) * ld + n0), "r"(cols * 4), "r"(bar)
          : "memory");
    }
  }

  // acc += A(the item's rows, 0:k_dim) W(0:k_dim, its column tiles) over the
  // layer's slices; every warp takes every slice (item or not) and arrives
  // on its empty barrier.
  template <int NJ>
  __device__ __forceinline__ void layer(const float* A, int lda, int k_dim, bool item, int t0, int tlast,
                                        float (&acc)[kSaItemM][NJ][4]) {
    for (int k0 = 0; k0 < k_dim; k0 += kSaSliceK) {
      const int s = next % stages;
      mbar_wait(full + s, (next / stages) & 1);
      if (item) mma_3xtf32_kn<NJ>(A + k0, lda, ring + s * stage, ldw, t0, tlast, min(kSaSliceK, k_dim - k0), acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(empty + s)) : "memory");
      }
      ++next;
    }
  }

  // The producer warp's walk: every slice, once the 8 warps are past its
  // stage's previous slice.
  __device__ void produce(int lane) const {
    for (int i = 0; i < total; ++i) {
      const int s = i % stages;
      if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(i, lane);
    }
  }
};

// A barrier of the 8 warps that compute (named barrier 1), without the producer.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// A tile's rows: centre q = tile (rows / rpc) + row / rpc, slot row % rpc;
// a slot < ns takes K4's index, the rest (and rows of centres past the
// last) are padding, copied as zeros.  `threads` = 256 / rows threads gather
// a row: the thread takes row tid / threads and every threads-th 16-byte
// chunk of its feature row from chunk `part` on; part 0 also copies the
// row's point, the last part its centre.
struct SaGather {
  int row, part, threads, centres;  // centres: a tile's

  __device__ __forceinline__ int index(const SaArgs& a, int tile) const {  // -1: padding
    const int q = tile * centres + row / a.rpc, s = row % a.rpc;
    return q < a.groups && s < a.ns ? (int)__ldg(a.idx + (size_t)q * a.ns + s) : -1;
  }
  __device__ __forceinline__ void put(const SaArgs& a, int tile, int index, float* xs, int ldx, float* pts,
                                      float* cen) const {
    const int q = tile * centres + row / a.rpc;
    const bool ok = index >= 0;
    const size_t p = ok ? (size_t)(q / a.m) * a.n + index : 0;
    const float* src = a.feat + p * a.c_in;
    float* dst = xs + row * ldx;
    for (int c = 4 * part; c < a.c_in; c += 4 * threads) cp_async16(dst + c, src + c, ok);
    if (part == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) cp_async4(pts + 3 * row + k, a.xyz + 3 * p + k, ok);
    }
    if (part == threads - 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) cp_async4(cen + 3 * row + k, a.centers + 3 * (size_t)(ok ? q : 0) + k, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
};

// K9's MLP: out (groups, c3) = max over each centre's ns rows of relu(relu(
// relu([offset | features] W1 + b1) W2 + b2) W3 + b3), rows from K4's
// indices.  NJ12: column tiles of a warp's item in layers 1-2 (kSaItemN3 in
// layer 3).  Warps 0-7 gather and compute, warp 8 feeds the weight ring.
template <int NJ12>
__global__ void __launch_bounds__(kThreads + 32, 1) sa_feat_tc_kernel(SaArgs a) {
  extern __shared__ __align__(16) float sa_smem[];
  __shared__ __align__(8) uint64_t full[kSaMaxStages];
  __shared__ __align__(8) uint64_t empty[kSaMaxStages];
  const SaLayout l = sa_layout(a.tm, a.c_in, a.c1, a.c2, a.c3);
  float* xs = sa_smem;
  float* a2s = sa_smem + l.a2;
  float* pts = sa_smem + l.pts;
  float* cen = sa_smem + l.cen;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int centres = l.rows / a.rpc;  // per tile
  const int tiles = (a.groups + centres - 1) / centres;
  const int mc = a.rpc / kTile;         // m tiles of a centre

  SaRing ring;
  ring.w1 = a.w1;
  ring.w2 = a.w2;
  ring.w3 = a.w3;
  ring.ring = sa_smem + l.ring;
  ring.full = full;
  ring.empty = empty;
  ring.stage = l.stage;
  ring.c_in = a.c_in;
  ring.c1 = a.c1;
  ring.c2 = a.c2;
  ring.c3 = a.c3;
  ring.cols3 = l.cols3;
  ring.ldw = l.ldw;
  ring.stages = l.stages;
  ring.s1 = (a.c_in + kSaSliceK - 1) / kSaSliceK;
  ring.s2 = (a.c1 + kSaSliceK - 1) / kSaSliceK;
  ring.s3 = (a.c2 + kSaSliceK - 1) / kSaSliceK;
  ring.per_tile = ring.s1 + ring.s2 + l.passes3 * ring.s3;
  ring.total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * ring.per_tile;
  ring.next = 0;
  if (tid == 0) {
    for (int s = 0; s < l.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(empty + s)), "r"(kWarps) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers are set up
  if (warp == kWarps) {
    ring.produce(lane);
    return;
  }
  const int row_threads = kThreads / l.rows;
  const SaGather gather = {tid / row_threads, tid % row_threads, row_threads, centres};
  int next = gather.index(a, blockIdx.x);
  gather.put(a, blockIdx.x, next, xs, l.ldx, pts, cen);
  next = gather.index(a, blockIdx.x + gridDim.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    consumers_sync();  // the tile's rows are in

    {  // layer 1: the K = c_in feature product, + the xyz part + b1 on the CUDA cores
      const int nt = a.c1 / 8, parts = (nt + NJ12 - 1) / NJ12;
      const bool item = warp < parts * l.row_parts;
      const int mt0 = kSaItemM * (warp / parts), t0 = NJ12 * (warp % parts);
      float acc[kSaItemM][NJ12][4] = {};
      ring.layer<NJ12>(xs + kTile * mt0 * l.ldx, l.ldx, a.c_in, item, t0, nt - 1, acc);
      consumers_sync();  // every warp is past the feature rows: a1 overwrites them
      if (item) {
#pragma unroll
        for (int j = 0; j < NJ12; ++j) {
          if (t0 + j >= nt) continue;
          const int col = 8 * (t0 + j) + 2 * t;
          float wx[2], wy[2], wz[2], bb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wx[i] = __ldg(a.w1 + col + i);
            wy[i] = __ldg(a.w1 + a.c1 + col + i);
            wz[i] = __ldg(a.w1 + 2 * a.c1 + col + i);
            bb[i] = __ldg(a.b1 + col + i);
          }
#pragma unroll
          for (int m = 0; m < kSaItemM; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = kTile * (mt0 + m) + g + 8 * h;
              const float sx = __fmul_rn(__fsub_rn(pts[3 * r], cen[3 * r]), a.inv_radius);
              const float sy = __fmul_rn(__fsub_rn(pts[3 * r + 1], cen[3 * r + 1]), a.inv_radius);
              const float sz = __fmul_rn(__fsub_rn(pts[3 * r + 2], cen[3 * r + 2]), a.inv_radius);
              float v[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                v[i] = fmaxf(sx * wx[i] + sy * wy[i] + sz * wz[i] + acc[m][j][2 * h + i] + bb[i], 0.0f);
              }
              *reinterpret_cast<float2*>(xs + r * l.ldx + col) = make_float2(v[0], v[1]);
            }
          }
        }
      }
      consumers_sync();
    }

    {  // layer 2: a2 = relu(a1 W2 + b2)
      const int nt = a.c2 / 8, parts = (nt + NJ12 - 1) / NJ12;
      const bool item = warp < parts * l.row_parts;
      const int mt0 = kSaItemM * (warp / parts), t0 = NJ12 * (warp % parts);
      float acc[kSaItemM][NJ12][4] = {};
      ring.layer<NJ12>(xs + kTile * mt0 * l.ldx, l.ldx, a.c1, item, t0, nt - 1, acc);
      consumers_sync();  // every warp is past a1: the next tile's rows come in while layer 3 runs
      if (tile + (int)gridDim.x < tiles) {
        gather.put(a, tile + gridDim.x, next, xs, l.ldx, pts, cen);
        next = gather.index(a, tile + 2 * gridDim.x);
      }
      if (item) {
#pragma unroll
        for (int j = 0; j < NJ12; ++j) {
          if (t0 + j >= nt) continue;
          const int col = 8 * (t0 + j) + 2 * t;
          const float bb0 = __ldg(a.b2 + col), bb1 = __ldg(a.b2 + col + 1);
#pragma unroll
          for (int m = 0; m < kSaItemM; ++m) {
            const int r = kTile * (mt0 + m) + g;
            *reinterpret_cast<float2*>(a2s + r * l.ld2 + col) =
                make_float2(fmaxf(acc[m][j][0] + bb0, 0.0f), fmaxf(acc[m][j][1] + bb1, 0.0f));
            *reinterpret_cast<float2*>(a2s + (r + 8) * l.ld2 + col) =
                make_float2(fmaxf(acc[m][j][2] + bb0, 0.0f), fmaxf(acc[m][j][3] + bb1, 0.0f));
          }
        }
      }
      consumers_sync();
    }

    // layer 3, pass by pass, folded into the max over each centre's rows:
    // registers, then the 8 lanes that share a column (xor 4, 8, 16)
    for (int pass = 0; pass < l.passes3; ++pass) {
      const int n0 = pass * l.cols3;
      const int nt = min(l.cols3, a.c3 - n0) / 8, parts = (nt + kSaItemN3 - 1) / kSaItemN3;
      const bool item = warp < parts * l.row_parts;
      const int mt0 = kSaItemM * (warp / parts), t0 = kSaItemN3 * (warp % parts);
      float acc[kSaItemM][kSaItemN3][4] = {};
      ring.layer<kSaItemN3>(a2s + kTile * mt0 * l.ld2, l.ld2, a.c2, item, t0, nt - 1, acc);
      if (!item) continue;
#pragma unroll
      for (int j = 0; j < kSaItemN3; ++j) {
        if (t0 + j >= nt) continue;  // warp-uniform
        const int col = n0 + 8 * (t0 + j) + 2 * t;
        const float bb0 = __ldg(a.b3 + col), bb1 = __ldg(a.b3 + col + 1);
#pragma unroll
        for (int cc = 0; cc < kSaItemM; ++cc) {  // the item's centres
          if (cc * mc >= kSaItemM) break;
          float m0 = 0.0f, m1 = 0.0f;  // every candidate is a relu output, >= 0
#pragma unroll
          for (int m = 0; m < kSaItemM; ++m) {
            if (m / mc != cc) continue;
            const int r = kTile * (m - cc * mc) + g;  // the row's slot
            if (r < a.ns) {
              m0 = fmaxf(m0, fmaxf(acc[m][j][0] + bb0, 0.0f));
              m1 = fmaxf(m1, fmaxf(acc[m][j][1] + bb1, 0.0f));
            }
            if (r + 8 < a.ns) {
              m0 = fmaxf(m0, fmaxf(acc[m][j][2] + bb0, 0.0f));
              m1 = fmaxf(m1, fmaxf(acc[m][j][3] + bb1, 0.0f));
            }
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          const int q = tile * centres + mt0 / mc + cc;
          if (g == 0 && q < a.groups) *reinterpret_cast<float2*>(a.out + (size_t)q * a.c3 + col) = make_float2(m0, m1);
        }
      }
    }
  }
}

// The grid of a persistent MLP kernel of `threads` threads a block: as many
// blocks as fit the card at once (its occupancy at `smem` bytes of dynamic
// shared memory x the SMs), at most one per group.  Also raises the
// kernel's dynamic shared memory limit to at least `smem`.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int groups, int* grid, int threads = kThreads) {
  cudaError_t err = raise_smem_limit((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess) {
    return err;
  }
  const int fit = (per_sm > 0 ? per_sm : 1) * sms;
  *grid = groups < fit ? groups : fit;
  return cudaSuccess;
}

}  // namespace

// Bytes of dynamic shared memory crop_mlp_tc_kernel takes at these widths,
// or 0 where it does not take them (widths multiples of 8, the layout
// within a block's shared memory).
extern "C" size_t gn_crop_mlp_tc_smem(int c1, int c2, int c3) {
  if (c1 < 8 || c2 < 8 || c3 < 8 || c1 % 8 != 0 || c2 % 8 != 0 || c3 % 8 != 0) return 0;
  const size_t bytes = tc_layout(c1, c2, c3).floats * sizeof(float);
  return bytes <= kMaxSmemBytes ? bytes : 0;
}

// CloudCrop (K5), after the cylinder scan (query.cu's gn_cylinder_scan) has
// written the offsets grouped (B, M, D, ns, 3): the tensor-core MLP + max
// into out (B, M, D, c3), groups = B M D.  w* 16-byte aligned.
extern "C" int gn_crop_mlp(const float* grouped, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3, const float* b3,
                           float* out, int groups, int ns, int c1, int c2, int c3, void* stream) {
  const size_t smem = gn_crop_mlp_tc_smem(c1, c2, c3);
  if (ns < 1 || ns > kMaxSamples || smem == 0) return (int)cudaErrorInvalidValue;
  void (*mlp)(const float*, int, int, const float*, const float*, const float*, const float*,
              const float*, const float*, float*, int, int, int) =
      ns <= kTile ? crop_mlp_tc_kernel<1> : ns <= 2 * kTile ? crop_mlp_tc_kernel<2>
                  : ns <= 3 * kTile ? crop_mlp_tc_kernel<3> : crop_mlp_tc_kernel<4>;
  int grid = 0;
  const cudaError_t err = persistent_grid(mlp, smem, groups, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return (int)cudaSuccess;
  mlp<<<grid, kThreads, smem, (cudaStream_t)stream>>>(grouped, groups, ns, w1, b1, w2, b2, w3, b3, out, c1,
                                                      c2, c3);
  return (int)cudaGetLastError();
}

// SA1 (K3), after the ball scan (query.cu's gn_ball_query) has written the
// padded indices idx (B, M, ns): the rows (xyz[idx] - centre) x normalize
// and the tensor-core MLP + max into out (B, M, c3).  w* 16-byte aligned.
extern "C" int gn_sa1_mlp(const int64_t* idx, const float* xyz, const float* centers,
                          const float* w1, const float* b1, const float* w2, const float* b2,
                          const float* w3, const float* b3, float* out, int batch, int n, int m,
                          int ns, float normalize, int c1, int c2, int c3, void* stream) {
  const size_t smem = gn_crop_mlp_tc_smem(c1, c2, c3);
  if (ns < 1 || ns > kMaxSamples || smem == 0) return (int)cudaErrorInvalidValue;
  void (*mlp)(BallRows, int, const float*, const float*, const float*, const float*, const float*,
              const float*, float*, int, int, int) =
      ns <= kTile ? sa1_mlp_tc_kernel<1> : ns <= 2 * kTile ? sa1_mlp_tc_kernel<2>
                  : ns <= 3 * kTile ? sa1_mlp_tc_kernel<3> : sa1_mlp_tc_kernel<4>;
  int grid = 0;
  const cudaError_t err = persistent_grid(mlp, smem, batch * m, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return (int)cudaSuccess;
  BallRows rows = {};
  rows.idx = idx;
  rows.xyz = xyz;
  rows.centers = centers;
  rows.n = n;
  rows.m = m;
  rows.ns = ns;
  rows.normalize = normalize;
  mlp<<<grid, kThreads, smem, (cudaStream_t)stream>>>(rows, batch * m, w1, b1, w2, b2, w3, b3, out, c1,
                                                      c2, c3);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory sa_feat_tc_kernel takes at these widths,
// or 0 where it does not take them (widths multiples of 8; c1 and c2 within
// the 8 warps' items; the layout, with at least 2 ring stages, within a
// block's shared memory).
extern "C" size_t gn_sa_feat_tc_smem(int c_in, int c1, int c2, int c3) {
  const int dims[4] = {c_in, c1, c2, c3};
  for (int c : dims) {
    if (c < 8 || c % 8 != 0) return 0;
  }
  const int tm = sa_tile_m(c_in, c1, c2, c3);
  return tm == 0 ? 0 : sa_layout(tm, c_in, c1, c2, c3).floats * sizeof(float);
}

// The SA2-4 stage (K9), after the ball scan (query.cu's gn_ball_query) has
// written the padded indices idx (B, M, ns): the rows [(xyz[idx] - centre)
// x inv_radius | feat[idx]] and the tensor-core MLP + max into out (B, M,
// c3).  feat and w* 16-byte aligned; n >= 1.
extern "C" int gn_sa_feat_mlp(const int64_t* idx, const float* xyz, const float* centers, const float* feat,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              const float* w3, const float* b3, float* out, int batch, int n, int m, int ns,
                              float inv_radius, int c_in, int c1, int c2, int c3, void* stream) {
  const size_t smem = gn_sa_feat_tc_smem(c_in, c1, c2, c3);
  if (ns < 1 || ns > kMaxSamples || n < 1 || m < 0 || smem == 0) return (int)cudaErrorInvalidValue;
  const int tm = sa_tile_m(c_in, c1, c2, c3);
  const SaLayout l = sa_layout(tm, c_in, c1, c2, c3);
  void (*mlp)(SaArgs) = l.nj12 == 2 ? sa_feat_tc_kernel<2> : sa_feat_tc_kernel<4>;
  SaArgs a = {};
  a.idx = idx;
  a.xyz = xyz;
  a.centers = centers;
  a.feat = feat;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.w3 = w3;
  a.b3 = b3;
  a.out = out;
  a.n = n;
  a.m = m;
  a.groups = batch * m;
  a.ns = ns;
  a.rpc = kTile * (ns <= kTile ? 1 : ns <= 2 * kTile ? 2 : 4);
  a.tm = tm;
  a.c_in = c_in;
  a.c1 = c1;
  a.c2 = c2;
  a.c3 = c3;
  a.inv_radius = inv_radius;
  const int centres = l.rows / a.rpc;
  int grid = 0;
  const cudaError_t err = persistent_grid(mlp, smem, (a.groups + centres - 1) / centres, &grid, kThreads + 32);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return (int)cudaSuccess;
  mlp<<<grid, kThreads + 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
