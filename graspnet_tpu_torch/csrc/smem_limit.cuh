// Raising a kernel's dynamic shared memory limit when several host threads
// launch it.  Included by the .cu sources; build.py hashes it into their
// library names.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

// Raise `kernel`'s dynamic shared memory limit on the current device to at
// least `bytes`; never lower it.  The limit is one value per kernel for
// every host thread, and the bytes a launch needs depend on its shape (the
// scan's ring stages, the MLP's widths, the FPS chain's forwarded points):
// a thread that set a smaller limit between another thread's set and its
// launch made that launch fail (cudaErrorLaunchOutOfResources, seen with
// concurrent service requests).  So the limit only grows, under a lock.
inline cudaError_t raise_smem_limit(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> limit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& cur = limit[{dev, kernel}];
  if (bytes <= cur) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) cur = bytes;
  return err;
}
