// Fused float32 multi-head attention: out_h = softmax(q_h k_h^T / sqrt(D)) v_h
// for each head h of D channels, the heads side by side in the channels.
// D is a compile-time parameter: 36 (Group-Free-3D) or 16 (Point
// Transformer V3).
//
// No TPU kernel: the JAX package has no attention.  Two callers:
//   * Group-Free-3D's decoder (models/groupfree.py), twice a layer:
//     self-attention of the 512 queries (Lk 512) and cross-attention to the
//     1,024 seeds (Lk 1,024), 8 heads of 36, batch 8: the dense entry
//     (batch, L, heads x 36);
//   * Point Transformer V3's serialized attention (models/ptv3.py), once a
//     block, 22 blocks: self-attention within patches of 1,024 points along
//     a space-filling curve (a fragment of fewer points is one sequence of
//     its own length), 2-32 heads of 16: the variable-length entry, packed
//     (T, 3 x heads x D) rows and int32 sequence starts, as
//     flash_attn_varlen_qkvpacked_func takes them.
// The scores of one call are B x H x Lq x Lk floats (134 MB at
// Group-Free-3D's cross-attention, ~7 GB at PTv3's stage 0); a scan of them
// and of the probabilities through device memory would move far more than
// q, k and v.  Here they never leave the registers.
//
// What bounds it: 4 Lq Lk D operations a head (the scores and the weighted
// sum, a multiply-add each), on the CUDA cores in float32: 4.8 GFLOP at
// Group-Free-3D's cross-attention against 28 MB of q, k, v and out, and
// ~0.55 TFLOP a PTv3 batch against ~2 GB, so the operations bound it (at
// 67 TFLOP/s).  The design keeps the FMA pipe fed:
//   * a block takes 32 queries of one (batch or sequence, head), a query a
//     lane, its q row (pre-scaled by log2(e) / sqrt(D), so the softmax is
//     exp2) and its D outputs in registers;
//   * the keys are split over the block's 4 warps, tile by tile (32 keys
//     a tile, every 4th tile a warp): each warp stages its tile's k and v
//     rows in shared memory with 16-byte loads, coalesced, and every lane
//     reads them as 16-byte broadcasts, so a read feeds 4 multiply-adds
//     of each of the 32 queries;
//   * each warp keeps its own online softmax (running max, sum, weighted
//     sum), rescaled once a 16-key chunk; at the end the 4 warps' partial
//     results meet in shared memory and each thread writes D / 4 of its
//     query's D outputs.
// Splitting the keys gives 4 x the warps a query-per-lane layout would
// have (B H Lq / 32 blocks: 1,024 at Group-Free-3D's shapes), so the loads
// of one warp overlap the arithmetic of the others.  Any Lq >= 0 and Lk >=
// 1: a ragged last tile masks its keys, a warp with no tile adds nothing, a
// row past Lq computes on zeros and is not written.  The variable-length
// entry launches ceil(max L / 32) query tiles a sequence; a tile past its
// sequence's end returns at once.  The two entries share the arithmetic;
// the card tests pin the width-36 results bitwise by their digests.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // warps a block; the keys are split over them
constexpr int kTile = 32;              // keys a warp stages at once
constexpr int kChunk = 16;             // keys between two rescales of the online softmax
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct Tiles {                          // each warp's staged keys and values
  float4 k[kWarps][kTile * (kD / 4)];
  float4 v[kWarps][kTile * (kD / 4)];
};

template <int kD>
struct Partials {                       // each warp's softmax state, lane-minor (no bank conflicts)
  float o[kWarps][kD][32];
  float m[kWarps][32];
  float l[kWarps][32];
};

template <int kD>
union Shared {
  Tiles<kD> t;
  Partials<kD> p;
};

// Dense (Varlen false): q (batch, lq, .), k, v (batch, lk, .), blockIdx.z
// the batch, `starts` unused.  Varlen: q, k, v rows of one packed array,
// sequence s the rows starts[s] .. starts[s + 1] - 1, blockIdx.x = s x
// `seq_tiles` + the query tile; lq, lk and the batch strides unused.
template <int kD, bool Varlen>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ out, int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb,
                int64_t v_sl, int lq, int lk, int heads, float qscale, const int* __restrict__ starts, int seq_tiles) {
  constexpr int kD4 = kD / 4;          // float4s a row of a head
  constexpr int kCols = kD / kWarps;   // output columns a thread writes at the end
  static_assert(kD % 4 == 0 && kD % kWarps == 0 && kTile % kChunk == 0, "tile shape");
  __shared__ Shared<kD> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  int tile = blockIdx.x;
  int64_t orow0;  // the output row of the block's sequence's first query
  if constexpr (Varlen) {
    const int s = blockIdx.x / seq_tiles;
    tile = blockIdx.x - s * seq_tiles;
    const int start = starts[s];
    lq = lk = starts[s + 1] - start;
    if (tile * 32 >= lq) return;  // the whole block: past its sequence
    q += (int64_t)start * q_sl;
    k += (int64_t)start * k_sl;
    v += (int64_t)start * v_sl;
    orow0 = start;
  } else {
    const int b = blockIdx.z;
    q += b * q_sb;
    k += b * k_sb;
    v += b * v_sb;
    orow0 = (int64_t)b * lq;
  }
  const int row = tile * 32 + lane;
  const bool live = row < lq;

  float qr[kD];
  {
    const float4* qp = reinterpret_cast<const float4*>(q + (int64_t)(live ? row : 0) * q_sl + h * kD);
#pragma unroll
    for (int i = 0; i < kD4; ++i) {
      const float4 t = live ? qp[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * i] = t.x * qscale;
      qr[4 * i + 1] = t.y * qscale;
      qr[4 * i + 2] = t.z * qscale;
      qr[4 * i + 3] = t.w * qscale;
    }
  }
  float o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const float* kb = k + h * kD;
  const float* vb = v + h * kD;
  float4* ks = sm.t.k[warp];
  float4* vs = sm.t.v[warp];
  const int tiles = (lk + kTile - 1) / kTile;
  for (int t = warp; t < tiles; t += kWarps) {
    const int key0 = t * kTile;
    __syncwarp();  // the warp is done reading its previous tile
#pragma unroll
    for (int r = 0; r < kD4; ++r) {  // the tile's 32 x D/4 float4s of k and of v, D/4 a lane
      const int f = lane + 32 * r;
      const int j = f / kD4, c = f - j * kD4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key0 + j < lk) {
        kv = reinterpret_cast<const float4*>(kb + (int64_t)(key0 + j) * k_sl)[c];
        vv = reinterpret_cast<const float4*>(vb + (int64_t)(key0 + j) * v_sl)[c];
      }
      ks[f] = kv;
      vs[f] = vv;
    }
    __syncwarp();
    const int n = min(kTile, lk - key0);
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      if (j0 >= n) break;
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.f;
#pragma unroll
      for (int c = 0; c < kD4; ++c) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kk = ks[(j0 + j) * kD4 + c];
          s[j] = fmaf(qr[4 * c], kk.x, s[j]);
          s[j] = fmaf(qr[4 * c + 1], kk.y, s[j]);
          s[j] = fmaf(qr[4 * c + 2], kk.z, s[j]);
          s[j] = fmaf(qr[4 * c + 3], kk.w, s[j]);
        }
      }
      float mt = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j0 + j < n) mt = fmaxf(mt, s[j]);
      const float corr = exp2f(m - mt);  // 0 at the first chunk (m = -inf)
      m = mt;
      l *= corr;
#pragma unroll
      for (int d = 0; d < kD; ++d) o[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = j0 + j < n ? exp2f(s[j] - mt) : 0.f;
        l += p;
#pragma unroll
        for (int c = 0; c < kD4; ++c) {
          const float4 vv = vs[(j0 + j) * kD4 + c];
          o[4 * c] = fmaf(p, vv.x, o[4 * c]);
          o[4 * c + 1] = fmaf(p, vv.y, o[4 * c + 1]);
          o[4 * c + 2] = fmaf(p, vv.z, o[4 * c + 2]);
          o[4 * c + 3] = fmaf(p, vv.w, o[4 * c + 3]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with its tiles: the shared memory holds the partials now
#pragma unroll
  for (int d = 0; d < kD; ++d) sm.p.o[warp][d][lane] = o[d];
  sm.p.m[warp][lane] = m;
  sm.p.l[warp][lane] = l;
  __syncthreads();
  float mm = -INFINITY;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) mm = fmaxf(mm, sm.p.m[u][lane]);
  float a[kWarps], total = 0.f;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    a[u] = exp2f(sm.p.m[u][lane] - mm);  // 0 for a warp that had no tile
    total += a[u] * sm.p.l[u][lane];
  }
  if (!live) return;
  const float inv = 1.f / total;
  float* op = out + (orow0 + row) * ((int64_t)heads * kD) + h * kD + warp * kCols;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) acc = fmaf(a[u], sm.p.o[u][warp * kCols + c][lane], acc);
    op[c] = acc * inv;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool rows_ok(const float* p, int64_t sb, int64_t sl) { return aligned16(p) && sb % 4 == 0 && sl % 4 == 0; }

}  // namespace

// out (batch, lq, heads x 36), contiguous <- attention of q (batch, lq, .)
// over k, v (batch, lk, .): each operand's head h is the 36 floats at column
// h x 36 of a row; rows lie `*_sl` floats apart and batches `*_sb` (multiples
// of 4, the base 16-byte aligned).
extern "C" int gn_attention(const float* q, const float* k, const float* v, float* out, int64_t q_sb, int64_t q_sl,
                            int64_t k_sb, int64_t k_sl, int64_t v_sb, int64_t v_sl, int batch, int lq, int lk,
                            int heads, int head_dim, void* stream) {
  if (head_dim != 36 || batch < 0 || batch > 65535 || lq < 0 || lk < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (!rows_ok(q, q_sb, q_sl) || !rows_ok(k, k_sb, k_sl) || !rows_ok(v, v_sb, v_sl) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || lq == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((lq + 31) / 32), (unsigned)heads, (unsigned)batch);
  attn_fwd_kernel<36, false><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      q, k, v, out, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, lq, lk, heads, kLog2e / sqrtf(36.f), nullptr, 0);
  return (int)cudaGetLastError();
}

// out (T, heads x 16), contiguous <- self-attention within each sequence of
// the packed rows qkv (T, .): row t's q, k and v of head h are the 16
// floats at columns h x 16, C + h x 16 and 2C + h x 16 (C = heads x 16),
// rows `row_stride` floats apart (a multiple of 4, the base 16-byte
// aligned); sequence s is the rows starts[s] .. starts[s + 1] - 1
// (`starts`: sequences + 1 int32 on the device, every sequence at least
// one row and at most max_len).
extern "C" int gn_attention_varlen(const float* qkv, const int* starts, float* out, int64_t row_stride,
                                   int sequences, int max_len, int heads, int head_dim, void* stream) {
  if (head_dim != 16 || sequences < 0 || max_len < 1 || heads < 1 || heads > 65535 ||
      !rows_ok(qkv, 0, row_stride) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int tiles = (max_len + 31) / 32;
  if ((int64_t)sequences * tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (sequences == 0) return (int)cudaSuccess;
  const int64_t c = (int64_t)heads * 16;
  const dim3 grid((unsigned)(sequences * tiles), (unsigned)heads, 1);
  attn_fwd_kernel<16, true><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      qkv, qkv + c, qkv + 2 * c, out, 0, row_stride, 0, row_stride, 0, row_stride, 0, 0, heads,
      kLog2e / sqrtf(16.f), starts, tiles);
  return (int)cudaGetLastError();
}
