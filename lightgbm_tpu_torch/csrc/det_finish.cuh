// The deterministic mode's last step, shared by K1 (histogram.cu) and K3
// (histogram_sublane.cu): each int64 fixed-point sum of `acc` ([cells, ka])
// as f32 into channel k of the [cells, ko] output, through float64 (exact
// division by the channel's power-of-two scale, ops/determinism.py).
#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void hist_det_finish_kernel(const unsigned long long* acc,
                                       const double* scale, float* out,
                                       long long cells, int ka, int ko) {
  const long long total = cells * ka;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long c = i / ka;
    const int k = (int)(i - c * ka);
    out[c * ko + k] = (float)((double)(long long)acc[i] / scale[k]);
  }
}

// A grid-stride pass of at most 1024 blocks of 256 threads: about the 2048
// resident threads of each of an H100's 132 SMs.
int det_finish(const unsigned long long* acc, const double* scale,
               float* out, long long cells, int ka, int ko,
               cudaStream_t stream) {
  const long long total = cells * ka;
  if (total <= 0) return (int)cudaSuccess;
  long long g = (total + 255) / 256;
  if (g > 1024) g = 1024;
  hist_det_finish_kernel<<<(unsigned)g, 256, 0, stream>>>(acc, scale, out,
                                                          cells, ka, ko);
  return (int)cudaGetLastError();
}

}  // namespace
