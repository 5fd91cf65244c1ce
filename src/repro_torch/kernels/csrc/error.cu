// cudaError_t -> message, for the Python wrappers' error reports.
#include "common.cuh"

REPRO_API const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
