// The device of a launch, made current for the scope of a C entry point
// and given back when the scope ends.
//
// Every entry point (ryser_walk.cu, ryser_batch.cu, modp_walk.cu) launches
// on the card its caller names, which the CUDA runtime's current device
// must be while it launches.  Setting it and leaving it set would move the
// calling thread to that card: a later allocation or launch of PyTorch's
// on the default device would then go to the wrong card.  So the caller's
// device is read first and set again as the entry point returns, after
// the launch's error has been read.

#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int cur = -1;
    if (cudaGetDevice(&cur) == cudaSuccess && cur == device) return;
    err_ = cudaSetDevice(device);
    if (err_ == cudaSuccess) prev_ = cur;  // -1: none to give back
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  // the error of making the launch's device current (cudaSuccess where it
  // was current already)
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};
