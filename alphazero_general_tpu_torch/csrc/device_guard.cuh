// Makes ``device`` the calling thread's current CUDA device for the life of
// the guard, and restores the previous one after; a no-op (one
// cudaGetDevice) when it already is. The C entry points launch through it,
// so the Python wrappers need not enter ``torch.cuda.device`` per call.

#pragma once

#include <cuda_runtime.h>

namespace azg {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    error_ = cudaGetDevice(&previous_);
    if (error_ == cudaSuccess && previous_ != device) {
      error_ = cudaSetDevice(device);
      switched_ = error_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // The error of switching, cudaSuccess when the device is current.
  cudaError_t error() const { return error_; }

 private:
  int previous_ = 0;
  bool switched_ = false;
  cudaError_t error_ = cudaSuccess;
};

}  // namespace azg
