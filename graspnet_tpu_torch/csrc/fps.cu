// Cascaded furthest point sampling, one launch for every stage.
//
// Replaces graspnet_tpu/ops/pallas/fps.py::fps_chain_pallas (K1) and its
// single-stage case fps_pallas (K2).  Semantics (ops/sampling.py:53-73):
// index 0 comes first; a point with x*x+y*y+z*z <= 1e-3 is never picked;
// the running min-distance starts at 1e10; d = dx*dx + dy*dy + dz*dz in
// that order; ties go to the lowest index; stage k samples the coordinates
// that stage k-1 selected and returns indices into stage k-1's list.
//
// What bounds it on an H100: latency, not FLOPs or bytes.  The production
// cascade 20000 -> 2048 -> 1024 -> 512 -> 256 is 3,836 dependent argmax
// steps per scene; each step is a distance update over the stage's points
// and a block-wide (dist, index) argmax, i.e. two __syncthreads().
//
// Design: one block of 1024 threads per scene (B of the 132 SMs are busy).
// The TPU kernel keeps the whole cloud and the min-distance buffer in VMEM;
// 20000 x 3 f32 is 240 KB, more than the 227 KB of shared memory a block may
// use, so here each thread owns points tid, tid+1024, ... and keeps their
// running min-distance in registers (MAXP per thread), while stage 0's
// coordinates are re-read through L1/L2 each step.  The coordinates a stage
// selects are written into a shared-memory buffer that the next stage
// samples (ping-pong), so the intermediate gathers never touch device
// memory.  The distance arithmetic uses __fmul_rn/__fadd_rn so that no FMA
// contraction changes a rounding: the indices equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPerThread = 24;  // N <= 24576
constexpr int kMaxStages = 8;

struct Stages {
  int count;
  int total;            // sum of npoint over stages (columns of `out`)
  int max_forward;      // largest npoint forwarded to a next stage
  int npoint[kMaxStages];
  int offset[kMaxStages];
};

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void take_better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_chain_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out,
                 int n0, Stages st) {
  extern __shared__ float forward_buf[];  // 2 x (3 * max_forward) floats
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  __shared__ int s_best;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* src = xyz + (size_t)blockIdx.x * n0 * 3;
  int64_t* out_b = out + (size_t)blockIdx.x * st.total;
  int n = n0;

  for (int s = 0; s < st.count; ++s) {
    const int npoint = st.npoint[s];
    int64_t* out_s = out_b + st.offset[s];
    float* nxt = (s + 1 < st.count)
                     ? forward_buf + (s & 1) * 3 * st.max_forward
                     : nullptr;

    // -1 marks a near-origin point: a distance is >= 0, so fminf keeps it
    // losing; -2 marks a slot past the end, below every real point
    float mind[kMaxPerThread];
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int p = tid + k * kThreads;
      mind[k] = -2.0f;
      if (p < n) {
        const float x = src[3 * p], y = src[3 * p + 1], z = src[3 * p + 2];
        mind[k] = sq3(x, y, z) > 1e-3f ? 1e10f : -1.0f;
      }
    }

    float cx = src[0], cy = src[1], cz = src[2];
    if (tid == 0) {
      out_s[0] = 0;
      if (nxt) {
        nxt[0] = cx;
        nxt[1] = cy;
        nxt[2] = cz;
      }
    }

    for (int j = 1; j < npoint; ++j) {
      float bv = -3.0f;
      int bi = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int p = tid + k * kThreads;
        if (p < n) {
          const float d = sq3(__fsub_rn(src[3 * p], cx),
                              __fsub_rn(src[3 * p + 1], cy),
                              __fsub_rn(src[3 * p + 2], cz));
          const float m = fminf(d, mind[k]);
          mind[k] = m;
          if (m > bv) {  // strict: the lowest index of this thread wins ties
            bv = m;
            bi = p;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                    __shfl_down_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) {
        s_val[warp] = bv;
        s_idx[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = s_val[lane];
        bi = s_idx[lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                      __shfl_down_sync(0xffffffffu, bi, off));
        }
        if (lane == 0) {
          s_best = bi;
          out_s[j] = bi;
          if (nxt) {
            nxt[3 * j] = src[3 * bi];
            nxt[3 * j + 1] = src[3 * bi + 1];
            nxt[3 * j + 2] = src[3 * bi + 2];
          }
        }
      }
      __syncthreads();
      const int best = s_best;
      cx = src[3 * best];
      cy = src[3 * best + 1];
      cz = src[3 * best + 2];
    }
    __syncthreads();  // the forwarded buffer is complete before it is read
    src = nxt;
    n = npoint;
  }
}

}  // namespace

extern "C" int gn_fps_chain(const float* xyz, int64_t* out, int batch, int n,
                            const int* npoints, int nstage, void* stream) {
  if (nstage < 1 || nstage > kMaxStages || n > kThreads * kMaxPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  Stages st;
  st.count = nstage;
  st.total = 0;
  st.max_forward = 1;
  for (int s = 0; s < nstage; ++s) {
    st.npoint[s] = npoints[s];
    st.offset[s] = st.total;
    st.total += npoints[s];
    if (s + 1 < nstage && npoints[s] > st.max_forward) {
      st.max_forward = npoints[s];
    }
  }
  const size_t smem = 2 * 3 * (size_t)st.max_forward * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_chain_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(xyz, out, n, st);
  return (int)cudaGetLastError();
}
