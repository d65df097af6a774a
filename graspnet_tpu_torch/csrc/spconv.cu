// Submanifold sparse convolution on a voxel grid: the neighbour map
// (`kmap_kernel`) and the convolution through it (`subm_conv_kernel`).
//
// No TPU kernel: the JAX package has no sparse convolution.  Point
// Transformer V3 (models/ptv3.py) runs a 5^3 convolution at its stem (6 ->
// 32 channels) and a 3^3 one at the start of each of its 22 blocks (C -> C,
// C from 32 to 512), over grid-sampled room scans: ~410k sites at stage 0
// of a 4-fragment batch, about a quarter as many at each stage below.  A
// surface site has ~12 of its 27 neighbours.
//
// The map.  What bounds it: writing the (N, k^3) int32 map (44 MB at 3^3,
// 205 MB for the stem at 5^3: ~13 / ~61 us at 3.35 TB/s) and the probes of
// the table, which fit in L2 (2N slots of 12 bytes: ~12 MB at stage 0).
// The design, after csrc/voxel.cu's table: each site's key (batch, x, y,
// z: 15 + 3 x 16 bits) goes into an open-addressing table of 2N slots
// rounded up to a power of 2 (linear probing, atomicCAS on the key; the
// slot keeps the least site index, so a duplicate cell would still give
// one answer), then a thread an (site, offset) entry probes the table and
// writes the entry, coalesced, in the map's row-major order; each warp
// counts its hits with a ballot and each block adds its count to one int64
// with an atomic.  The entries do not depend on the order of the inserts:
// the map is exact, as the plain sort-and-search gives it.
//
// The convolution.  What bounds it: 2 x hits x C_in x C_out multiply-adds
// on the CUDA cores in float32 (no TF32: the configuration states full
// float32), ~0.3 TFLOP a batch counted on the hits, against the gathered
// rows (N x 27 x C_in x 4 bytes at most, read mostly from L2).  The design
// is an output-stationary implicit GEMM over the flattened (offset,
// channel) axis:
//   * a block owns 64 sites x 32 or 64 output channels, 256 threads, a
//     thread 4 sites x 2 or 4 channels in registers;
//   * the block's 64 map rows go to shared memory once, with a flag a
//     offset that any of its sites has a neighbour there;
//   * the reduction axis (k^3 x C_in, offset slowest) runs in steps of 16:
//     the 64 sites' 16 inputs gathered through the map into shared memory
//     (one 16-byte load a thread when C_in is a multiple of 16, so a step
//     lies within one offset; else element by element), the 16 x 64
//     weights beside them, then 16 multiply-adds a thread a step read as
//     16-byte broadcasts;
//   * a step whose offset no site of the block has is skipped whole: the
//     coarse stages' sparse neighbourhoods cost nothing there;
//   * every output sums its products in one fixed order (offset, then
//     channel, then the bias), so a run is bitwise the next.
// Absent neighbours inside a step gather zeros: the hits' bound counts
// only the ~12 of 27 offsets a surface site has, and a tile of the
// fragment's (unordered) stage-0 sites meets every offset, so the kernel
// does ~2.2 x the bound's products there; its roofline share says what
// that costs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // a key uses 63 bits at most
constexpr int kAxisBits = 16;
constexpr long long kAxis = 1ll << kAxisBits;
constexpr int kMapThreads = 256;

__device__ __forceinline__ unsigned long long pack(int b, int x, int y, int z) {
  return ((((unsigned long long)b << kAxisBits | (unsigned)x) << kAxisBits | (unsigned)y) << kAxisBits) |
         (unsigned)z;
}

// splitmix64's finalizer (voxel.cu's): spreads the packed cells over the slots
__device__ __forceinline__ unsigned long long mix(unsigned long long h) {
  h ^= h >> 30;
  h *= 0xbf58476d1ce4e5b9ull;
  h ^= h >> 27;
  h *= 0x94d049bb133111ebull;
  h ^= h >> 31;
  return h;
}

struct MapArgs {
  const int* grid;  // (n, 3)
  const int* batch;
  int n, k;
  unsigned long long* keys;  // the table: a slot's key,
  int* vals;                 // the least site in it
  unsigned mask;             // slots - 1
  int* out;                  // (n, k^3)
  unsigned long long* hits;
};

// Phase 0 inserts a thread a site; phase 1 writes a thread a map entry.
template <int Phase>
__global__ void __launch_bounds__(kMapThreads) kmap_kernel(MapArgs a) {
  if constexpr (Phase == 0) {
    const int i = blockIdx.x * kMapThreads + threadIdx.x;
    if (i >= a.n) return;
    const unsigned long long key = pack(a.batch[i], a.grid[3 * i], a.grid[3 * i + 1], a.grid[3 * i + 2]);
    unsigned h = (unsigned)mix(key) & a.mask;
    while (true) {
      const unsigned long long prev = atomicCAS(a.keys + h, kEmpty, key);
      if (prev == kEmpty || prev == key) {
        atomicMin(a.vals + h, i);
        return;
      }
      h = (h + 1) & a.mask;
    }
  } else {
    __shared__ unsigned long long block_hits;
    if (threadIdx.x == 0) block_hits = 0;
    __syncthreads();
    const int k3 = a.k * a.k * a.k;
    const long long e = (long long)blockIdx.x * kMapThreads + threadIdx.x;
    int found = -1;
    if (e < (long long)a.n * k3) {
      const int i = (int)(e / k3), o = (int)(e - (long long)i * k3);
      const int r = a.k / 2;
      const int x = a.grid[3 * i] + o / (a.k * a.k) - r;
      const int y = a.grid[3 * i + 1] + (o / a.k) % a.k - r;
      const int z = a.grid[3 * i + 2] + o % a.k - r;
      if (x >= 0 && y >= 0 && z >= 0 && x < kAxis && y < kAxis && z < kAxis) {
        const unsigned long long key = pack(a.batch[i], x, y, z);
        unsigned h = (unsigned)mix(key) & a.mask;
        while (true) {
          const unsigned long long kk = a.keys[h];
          if (kk == key) {
            found = a.vals[h];
            break;
          }
          if (kk == kEmpty) break;
          h = (h + 1) & a.mask;
        }
      }
      a.out[e] = found;
    }
    const unsigned ballot = __ballot_sync(kFull, found >= 0);
    if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(&block_hits, (unsigned long long)__popc(ballot));
    __syncthreads();
    if (threadIdx.x == 0 && block_hits) atomicAdd(a.hits, block_hits);
  }
}

constexpr int kBM = 64;         // sites a block
constexpr int kBK = 16;         // reduction entries a step
constexpr int kConvThreads = 256;
constexpr int kTM = 4;          // sites a thread
constexpr int kPadM = kBM + 4;  // a row of the staged inputs (fewer bank conflicts on the transposed store)

// Vec: C_in a multiple of kBK (a step lies within one offset; one float4 a
// thread).  BN: output channels a block, 32 or 64.
template <int BN, bool Vec>
__global__ void __launch_bounds__(kConvThreads)
subm_conv_kernel(const float* __restrict__ x, const int* __restrict__ kmap, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, int n, int cin, int cout, int k3) {
  constexpr int kTN = BN / 16;  // channels a thread
  __shared__ __align__(16) float as[kBK][kPadM];
  __shared__ __align__(16) float bs[kBK][BN];
  extern __shared__ int dyn[];  // the block's map rows (kBM x k3), then a flag an offset
  int* mt = dyn;
  int* present = dyn + kBM * k3;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  for (int f = tid; f < k3; f += kConvThreads) present[f] = 0;
  __syncthreads();
  for (int f = tid; f < kBM * k3; f += kConvThreads) {
    const int m = f / k3;
    const int v = m0 + m < n ? kmap[(long long)m0 * k3 + f] : -1;
    mt[f] = v;
    if (v >= 0) present[f - m * k3] = 1;
  }
  __syncthreads();

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const long long ktot = (long long)k3 * cin;
  for (long long k0 = 0; k0 < ktot; k0 += kBK) {
    if (Vec) {
      const int o = (int)(k0 / cin);
      if (!present[o]) continue;  // the same for every thread of the block
      const int c0 = (int)(k0 - (long long)o * cin);
      const int m = tid >> 2, kq = (tid & 3) * 4;
      const int src = mt[m * k3 + o];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0) v = *reinterpret_cast<const float4*>(x + (long long)src * cin + c0 + kq);
      as[kq][m] = v.x;
      as[kq + 1][m] = v.y;
      as[kq + 2][m] = v.z;
      as[kq + 3][m] = v.w;
    } else {
      for (int f = tid; f < kBM * kBK; f += kConvThreads) {
        const int m = f / kBK, kq = f - m * kBK;
        const long long kk = k0 + kq;
        float v = 0.f;
        if (kk < ktot) {
          const int o = (int)(kk / cin), c = (int)(kk - (long long)o * cin);
          const int src = mt[m * k3 + o];
          if (src >= 0) v = x[(long long)src * cin + c];
        }
        as[kq][m] = v;
      }
    }
    for (int f = tid; f < kBK * BN / 4; f += kConvThreads) {
      const int kq = f / (BN / 4), nq = (f - kq * (BN / 4)) * 4;
      const long long kk = k0 + kq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kk < ktot && n0 + nq < cout) v = *reinterpret_cast<const float4*>(w + kk * cout + n0 + nq);
      *reinterpret_cast<float4*>(&bs[kq][nq]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < kBK; ++kq) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kq][ty * kTM]);
      const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      float b[kTN];
      if constexpr (kTN == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[kq][tx * kTN]);
        b[0] = b4.x;
        b[1] = b4.y;
        b[2] = b4.z;
        b[3] = b4.w;
      } else {
        const float2 b2 = *reinterpret_cast<const float2*>(&bs[kq][tx * kTN]);
        b[0] = b2.x;
        b[1] = b2.y;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= n) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx * kTN + j;
      if (c < cout) y[(long long)m * cout + c] = bias ? acc[i][j] + bias[c] : acc[i][j];
    }
  }
}

template <int BN, bool Vec>
cudaError_t launch_conv(const float* x, const int* kmap, const float* w, const float* bias, float* y, int n, int cin,
                        int cout, int k3, cudaStream_t stream) {
  const size_t smem = (size_t)(kBM + 1) * k3 * sizeof(int);
  const size_t fixed = sizeof(float) * kBK * (kPadM + BN);  // the staged inputs and weights
  if (smem + fixed > 48 * 1024) return cudaErrorInvalidValue;  // the stem's 125 offsets fit
  const dim3 grid((unsigned)((n + kBM - 1) / kBM), (unsigned)((cout + BN - 1) / BN));
  subm_conv_kernel<BN, Vec><<<grid, kConvThreads, smem, stream>>>(x, kmap, w, bias, y, n, cin, cout, k3);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// out (n, k^3) int32 <- the neighbour map of n sites: grid (n, 3) int32
// cells in [0, 65535], batch (n,) in [0, 32767]; keys / vals: the table's
// `slots` (a power of 2, >= 2n) int64 / int32, every key all ones and
// every value INT_MAX (filled by the caller); *hits += the entries >= 0
// (zeroed by the caller).
extern "C" int gn_kernel_map(const int* grid, const int* batch, int n, int k, unsigned long long* keys, int* vals,
                             int slots, int* out, unsigned long long* hits, void* stream) {
  if (n < 0 || (k != 3 && k != 5) || slots < 2 * n || (slots & (slots - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const MapArgs a{grid, batch, n, k, keys, vals, (unsigned)(slots - 1), out, hits};
  kmap_kernel<0><<<(unsigned)((n + kMapThreads - 1) / kMapThreads), kMapThreads, 0, s>>>(a);
  const long long entries = (long long)n * k * k * k;
  kmap_kernel<1><<<(unsigned)((entries + kMapThreads - 1) / kMapThreads), kMapThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// y (n, cout) <- bias + sum over offsets o and channels c of x[kmap[i, o], c]
// w[o x cin + c, :], x (n, cin), kmap (n, k3) int32 (-1: absent), w (k3 x
// cin, cout) row-major, bias (cout,) or null; cout a multiple of 4.
extern "C" int gn_subm_conv(const float* x, const int* kmap, const float* w, const float* bias, float* y, int n,
                            int cin, int cout, int k3, void* stream) {
  if (n < 0 || cin < 1 || cout < 4 || cout % 4 != 0 || k3 < 1 || !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bool vec = cin % kBK == 0 && aligned16(x);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (cout >= 64)
    err = vec ? launch_conv<64, true>(x, kmap, w, bias, y, n, cin, cout, k3, s)
              : launch_conv<64, false>(x, kmap, w, bias, y, n, cin, cout, k3, s);
  else
    err = vec ? launch_conv<32, true>(x, kmap, w, bias, y, n, cin, cout, k3, s)
              : launch_conv<32, false>(x, kmap, w, bias, y, n, cin, cout, k3, s);
  return (int)err;
}
