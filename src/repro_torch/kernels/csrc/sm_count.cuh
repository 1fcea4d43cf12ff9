// The streaming-multiprocessor count that the port's launchers size their
// grids by, shared by the sources that include it.
#pragma once

#include <cuda_runtime.h>

namespace {

// Streaming multiprocessors of the current device, read once a device; 1
// if the runtime cannot say.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 1;
  }
  if (sms[dev] == 0) {
    int n = 0;
    sms[dev] = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev) == cudaSuccess && n > 0 ? n : 1;
  }
  return sms[dev];
}

}  // namespace
