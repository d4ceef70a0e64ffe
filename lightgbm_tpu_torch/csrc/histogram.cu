// K1: per-(feature, bin) histogram of row channels, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py::_hist_kernel
// (wrapper pallas_histogram) and the histogram half of
// lightgbm_tpu/ops/fused_split.py::_fused_kernel:
//
//     hist[f, b, k] = sum_r [bins[r, f] == b] * ch[r, k]
//
// The TPU kernel builds a one-hot in VMEM and contracts it on the MXU. Here
// the sum is a scatter-add in the pattern of LightGBM's
// CUDAConstructHistogramDenseKernel: every block owns a strided share of
// the rows and a chunk of the features (grid.y), keeps a private
// [f_chunk, B, K] f32 histogram in shared memory, atomicAdds into it, and
// at the end adds its non-zero cells into the output with global atomics.
//
// One body, two channel sources (template parameter RECORDS):
//   * dense: bins [N, F] u8 read through a row stride, channels [N, K] f32;
//   * records: the packed row records of ops/compact.py ([N, C] u8: bins at
//     [0, F), grad/hess/sample-weight f32 bytes at grad_off/hess_off/
//     cnt_off). The channels are (grad, hess, weight != 0, 1). grad_off = F
//     is not a multiple of 4 when F % 4 != 0, so the floats are assembled
//     from the two covering 32-bit words (funnel shift), never loaded as a
//     misaligned float.
// In record mode the segment (start, count, which array) is read from a
// device int32 vector, so the grower never reads it back to the host.
//
// What bounds it on the H100: not the bytes. The least time is that of
// the bins and channels read once (dense: N * (F + 4K) bytes; records: the
// two 32-byte sectors of each 128-byte record that hold bins and channels,
// 64 B a row), but the kernel is bound by its shared-memory atomics, F * K
// of them a row: at 10.5M rows x 28 features it runs 45x over the byte
// bound, and with one channel instead of four it runs 8x faster
// (chip_smoke.py, PERF.md). The design keeps the histogram on chip so
// global memory sees each input byte once and each output cell a few
// times; fewer atomics (a bin-sorted or warp-aggregated update) is the
// next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;
// shared-memory budget of one block's private histogram: two to three
// blocks fit an SM (228 KB), and wide feature sets split over grid.y
constexpr int kSmemBudget = 96 * 1024;

__device__ __forceinline__ float load_f32_bytes(const uint8_t* rec, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(rec);
  const int wi = off >> 2;
  const int sh = (off & 3) * 8;
  uint32_t v = __ldg(w + wi);
  if (sh) v = __funnelshift_r(v, __ldg(w + wi + 1), sh);
  return __uint_as_float(v);
}

template <bool RECORDS>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* rows_a, const uint8_t* rows_b, long long stride,
            const float* ch, int K, const int* seg, long long n_rows,
            int start_h, int count_h, int F, int f_chunk, int B, int bf16,
            int grad_off, int hess_off, int cnt_off, float* out) {
  extern __shared__ float hist[];  // [fc, B, K]
  const int f0 = blockIdx.y * f_chunk;
  const int fc = min(f_chunk, F - f0);
  const int cells = fc * B * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  long long start = start_h;
  long long count = count_h;
  const uint8_t* rows = rows_a;
  if (seg != nullptr) {
    // defence in depth, as the fused split's prep clamps its scalars: a bad
    // segment reads fewer rows, never rows outside the arrays
    start = min(max((long long)seg[0], 0LL), n_rows);
    count = min(max((long long)seg[1], 0LL), n_rows - start);
    if (seg[2] != 0) rows = rows_b;
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < count; r += step) {
    const long long row = start + r;
    const uint8_t* rec = rows + row * stride;
    float c[kMaxK];
    if (RECORDS) {
      c[0] = load_f32_bytes(rec, grad_off);
      c[1] = load_f32_bytes(rec, hess_off);
      c[2] = load_f32_bytes(rec, cnt_off) != 0.f ? 1.f : 0.f;
      c[3] = 1.f;
    } else {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          float v = __ldg(ch + row * K + k);
          c[k] = bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
        }
      }
    }
    for (int j = 0; j < fc; ++j) {
      const int b = __ldg(rec + f0 + j);
      if (b >= B) continue;  // the TPU one-hot drops bins >= B the same way
      float* cell = hist + (j * B + b) * K;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) atomicAdd(cell + k, c[k]);
      }
    }
  }
  __syncthreads();
  float* o = out + (long long)f0 * B * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <bool RECORDS>
int launch(const uint8_t* rows_a, const uint8_t* rows_b, long long stride,
           const float* ch, int K, const int* seg, long long n_rows,
           int start, int count, int F, int B, int bf16, int grad_off,
           int hess_off, int cnt_off, float* out, cudaStream_t stream) {
  if (F <= 0 || B <= 0 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const long long per_feature = (long long)B * K * sizeof(float);
  const long long total = per_feature * F;
  const int n_chunks = (int)((total + kSmemBudget - 1) / kSmemBudget);
  const int f_chunk = (F + n_chunks - 1) / n_chunks;
  const int chunks = (F + f_chunk - 1) / f_chunk;
  const int smem = (int)(per_feature * f_chunk);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<RECORDS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, hist_kernel<RECORDS>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  int gx = max(1, num_sms() * max(occ, 1) / chunks);
  if (seg == nullptr) {
    if (count <= 0) return (int)cudaSuccess;
    gx = min(gx, (count + kThreads - 1) / kThreads);
  }
  dim3 grid(gx, chunks);
  hist_kernel<RECORDS><<<grid, kThreads, smem, stream>>>(
      rows_a, rows_b, stride, ch, K, seg, n_rows, start, count, F, f_chunk,
      B, bf16, grad_off, hess_off, cnt_off, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Dense mode: bins [n, F] u8 with row stride `stride` bytes, channels
// [n, K] f32 contiguous, out [F, B, K] f32 zeroed by the caller.
extern "C" int lgbt_hist_dense(const void* bins, long long stride,
                               const void* ch, int K, int n, int F, int B,
                               int bf16, void* out, void* stream) {
  return launch<false>(static_cast<const uint8_t*>(bins), nullptr, stride,
                       static_cast<const float*>(ch), K, nullptr, n, 0, n, F,
                       B, bf16, 0, 0, 0, static_cast<float*>(out),
                       static_cast<cudaStream_t>(stream));
}

// Record mode: rows [start, start + count) of `work` (seg[2] == 0) or
// `scratch` (seg[2] != 0), both [n_rows, stride] u8, seg = device int32
// {start, count, which}, clamped on the device to start in [0, n_rows] and
// count in [0, n_rows - start]; out [F, B, 4] f32 zeroed by the caller.
extern "C" int lgbt_hist_records(const void* work, const void* scratch,
                                 long long n_rows, long long stride,
                                 const void* seg, int F, int B, int grad_off,
                                 int hess_off, int cnt_off, void* out,
                                 void* stream) {
  return launch<true>(static_cast<const uint8_t*>(work),
                      static_cast<const uint8_t*>(scratch), stride, nullptr,
                      4, static_cast<const int*>(seg), n_rows, 0, 0, F, B, 0,
                      grad_off, hess_off, cnt_off, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}
