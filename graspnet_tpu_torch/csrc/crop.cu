// Fused crop: query + first-hits gather + frame transform + BN-folded MLP +
// max over samples.  The crop group (K6), the same front half writing the
// offsets instead of running the MLP, is query.cu's cylinder scan.
//
// Replaces graspnet_tpu/ops/pallas/crop.py::crop_fused_pallas (K5, the
// inference CloudCrop; body _crop_kernel over _gather_grouped_core) and
// sa1_fused_pallas (K3, which is crop_fused_pallas(ball=True,
// normalize=1/r)), each with a scan of query.cu as its first launch; and
// sa_feat_fused_pallas (K9, below).  Per center:
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
// rounded as crop_sample rounds them, so the offsets are bitwise those of
// the plain version) and runs steps 5-6 as K5's MLP does, below.  The scan
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
// scan_first_hits now serves K9 only: 8 warps over 256 consecutive points
// per round; a ballot gives each hit its slot after the hits of lower
// warps, three barriers a round.  The mask arithmetic uses
// __fmul_rn/__fadd_rn in the JAX order (crop.py:109-125), so no FMA
// contraction moves a point across a boundary.
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
// stream through L1/L2; the ns <= 32 rows of a centre
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
  int n, m, ndepth, ns, c1, c2, c3;
  float r2, normalize;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// Steps 1-2 for one center in ball mode: s_idx[d][0..ns) and s_cnt[d]
// (the full hit count, which may exceed ns) for every depth, in index
// order.  Called by all kThreads threads of the block.
__device__ __forceinline__ void scan_first_hits(
    const float* __restrict__ pts, float cx, float cy, float cz,
    const CropArgs& a, int (*s_idx)[kMaxSamples], int* s_cnt,
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
      const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
      hits = d2 < a.r2 ? 1u : 0u;
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
// subtracted and scaled.
__device__ __forceinline__ void crop_sample(
    const float* __restrict__ pts, float cx, float cy, float cz,
    const CropArgs& a, const int* idx_d, int cnt, int slot, float* out3) {
  const int idx = slot_index(idx_d, cnt, slot);
  float sx = __fsub_rn(pts[3 * idx], cx);
  float sy = __fsub_rn(pts[3 * idx + 1], cy);
  float sz = __fsub_rn(pts[3 * idx + 2], cz);
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

  scan_first_hits(pts, cx, cy, cz, a, s_idx, s_cnt, s_wcnt);

  if (tid < a.ns) crop_sample(pts, cx, cy, cz, a, s_idx[0], s_cnt[0], tid, samples + 3 * tid);
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
// load waits on another.  The row is (point - centre) x normalize, rounded
// as crop_sample rounds it (so the offsets are bitwise those of the plain
// version's gather).
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

// The grid of a persistent MLP kernel: as many blocks as fit the card at
// once (its occupancy at `smem` bytes of dynamic shared memory x the SMs),
// at most one per group.  Also raises the kernel's dynamic shared memory
// limit to `smem`.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int groups, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess) {
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
