// K3: small-bin histogram over feature-major bins, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// lightgbm_tpu/ops/pallas_histogram.py::_hist_kernel_sublane (wrapper
// pallas_histogram(hist_layout="sublane")), the histogram of the masked
// grower at B <= 64:
//
//     hist[f, b, k] = sum_r [bins_t[f, r] == b] * ch[r, k],   b < B <= 64
//
// bins_t is [F, n] u8 with row stride `ld` bytes (feature-major, as the TPU
// kernel takes it), ch is [n, K] f32 contiguous (K <= 8), out is [F, B, K]
// f32 zeroed by the caller. Bins >= B are dropped, as the TPU kernel's
// padded sublanes drop them.
//
// The TPU kernel lays the bins along sublanes so a one-hot compare fills its
// register tiles and contracts it on the MXU. Here the sum is a scatter-add
// into one shared-memory histogram a block:
//   * the work items are (256-row tile, group of features); a warp takes an
//     item, lane l owns rows 8l..8l+7 of the tile and loads their channels
//     into registers once (K is a template parameter), then for each
//     feature of the group reads the 8 bins as one 8-byte load (a warp reads
//     256 consecutive bytes of one feature row) and adds its rows with
//     shared-memory atomics. Eight rows a lane keeps the channels in 8 K
//     registers; sixteen would double that and cost occupancy;
//   * the group is all the block's features when the rows alone fill the
//     card (channels read once a row), and fewer, down to one, when they do
//     not (the masked grower's 20k rows are 79 tiles): more items, more
//     warps in flight;
//   * a bin's K cells sit at an odd stride, so the lanes of a warp that hit
//     different bins spread over the shared-memory banks (at K = 4 an even
//     stride puts 64 bins on 8 banks);
//   * a row whose channels are all zero skips its atomics (the sum does not
//     change): the masked grower zeroes the channels of every row outside
//     the leaf it builds;
//   * one histogram a block, shared by its warps: private copies (which the
//     227 KB would hold at B <= 64) cost occupancy, and the first version of
//     this kernel, with four copies and channels staged in shared memory
//     behind block barriers, ran slower (PERF.md); no block-wide barrier
//     between the first and the last; at the end each non-zero cell goes
//     out with one global atomicAdd a block.
//
// What bounds it on the H100: the least time is that of the bytes, n * F
// (bins) + 4 n K (channels), read once; the kernel issues F * K shared
// atomics a non-zero row, which is what binds it, as it binds K1 (PERF.md).
// On the masked grower's own shapes (about 20k rows) the launch and the
// short grid, not the work, bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = 8;                       // one 8-byte load
constexpr int kTile = 32 * kRowsPerLane;              // 256 rows
constexpr int kMaxB = 64;
// shared-memory budget of a block's histogram: several blocks fit an SM
constexpr int kHistBudget = 96 * 1024;

template <bool VEC, int K>
__global__ void __launch_bounds__(kThreads)
hist_sublane_kernel(const uint8_t* __restrict__ bins, long long ld,
                    const float* __restrict__ ch, int ch_vec, long long n,
                    int F, int f_chunk, int group, int B, int bf16,
                    float* __restrict__ out) {
  constexpr int KS = K | 1;  // odd bin stride
  extern __shared__ float hist[];  // [fc][B][KS]
  const int f0 = blockIdx.y * f_chunk;
  const int fc = min(f_chunk, F - f0);
  for (int i = threadIdx.x; i < fc * B * KS; i += kThreads) hist[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const int n_groups = (fc + group - 1) / group;
  const long long items = n_tiles * n_groups;
  for (long long item = (long long)blockIdx.x * kWarps + warp; item < items;
       item += (long long)gridDim.x * kWarps) {
    const int grp = (int)(item % n_groups);
    const long long row_g = (item / n_groups) * kTile + lane * kRowsPerLane;
    // the lane's 8 rows of channels: 8 K consecutive floats, as 2 K
    // 16-byte loads where they lie aligned and inside the array
    float c[kRowsPerLane * K];
    const float* cp = ch + row_g * K;
    if (ch_vec && row_g + kRowsPerLane <= n) {
#pragma unroll
      for (int q = 0; q < kRowsPerLane * K / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(cp) + q);
        c[4 * q] = v.x;
        c[4 * q + 1] = v.y;
        c[4 * q + 2] = v.z;
        c[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerLane * K; ++i) {
        c[i] = row_g + i / K < n ? __ldg(cp + i) : 0.f;
      }
    }
    uint32_t live = 0;  // rows with a non-zero channel
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (bf16) {
          c[j * K + k] = __bfloat162float(__float2bfloat16_rn(c[j * K + k]));
        }
        any |= c[j * K + k] != 0.f;
      }
      live |= (uint32_t)any << j;
    }
    if (live == 0) continue;
    const int f_end = min(fc, (grp + 1) * group);
    for (int f = grp * group; f < f_end; ++f) {
      const uint8_t* p = bins + (long long)(f0 + f) * ld + row_g;
      uint32_t w[kRowsPerLane / 4];
      if (VEC && row_g + kRowsPerLane <= n) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = v.x;
        w[1] = v.y;
      } else {
        // ragged tail or unaligned rows: byte loads; rows past n read as
        // bin 255, which every B <= 64 drops
#pragma unroll
        for (int q = 0; q < kRowsPerLane / 4; ++q) {
          uint32_t word = 0;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const long long r = row_g + q * 4 + s;
            const uint32_t b = r < n ? __ldg(p + q * 4 + s) : 0xFFu;
            word |= b << (8 * s);
          }
          w[q] = word;
        }
      }
      float* hf = hist + f * B * KS;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int b = (w[j >> 2] >> ((j & 3) * 8)) & 0xFF;
        if (!((live >> j) & 1u) || b >= B) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) atomicAdd(hf + b * KS + k, c[j * K + k]);
      }
    }
  }
  __syncthreads();
  const int per_f = B * K;
  float* o = out + (long long)f0 * per_f;
  for (int i = threadIdx.x; i < fc * per_f; i += kThreads) {
    const int cell = i / K;  // f * B + b
    const float s = hist[cell * KS + (i - cell * K)];
    if (s != 0.f) atomicAdd(o + i, s);
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

template <bool VEC, int K>
int launch(const uint8_t* bins, long long ld, const float* ch, long long n,
           int F, int B, int bf16, float* out, cudaStream_t stream) {
  constexpr int KS = K | 1;
  const int feature_bytes = B * KS * (int)sizeof(float);
  const int f_chunk = F * feature_bytes <= kHistBudget
                          ? F : kHistBudget / feature_bytes;
  const int chunks = (F + f_chunk - 1) / f_chunk;
  const int smem = f_chunk * feature_bytes;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_sublane_kernel<VEC, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, hist_sublane_kernel<VEC, K>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) occ = 1;
  // features a work item covers: all of the chunk when the tiles alone give
  // every warp slot of the card work, fewer (down to one) when they do not
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long slots = (long long)num_sms() * occ * kWarps;
  long long group = (n_tiles * f_chunk + slots - 1) / slots;
  if (group > f_chunk) group = f_chunk;
  if (group < 1) group = 1;
  const long long n_groups = (f_chunk + group - 1) / group;
  long long gx = (long long)num_sms() * occ / chunks;
  const long long need = (n_tiles * n_groups + kWarps - 1) / kWarps;
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)chunks);
  hist_sublane_kernel<VEC, K><<<grid, kThreads, smem, stream>>>(
      bins, ld, ch, (reinterpret_cast<uintptr_t>(ch) & 15) == 0 ? 1 : 0, n,
      F, f_chunk, (int)group, B, bf16, out);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch(const uint8_t* bins, long long ld, const float* ch, int K,
             long long n, int F, int B, int bf16, float* out,
             cudaStream_t s) {
  switch (K) {
    case 1: return launch<VEC, 1>(bins, ld, ch, n, F, B, bf16, out, s);
    case 2: return launch<VEC, 2>(bins, ld, ch, n, F, B, bf16, out, s);
    case 3: return launch<VEC, 3>(bins, ld, ch, n, F, B, bf16, out, s);
    case 4: return launch<VEC, 4>(bins, ld, ch, n, F, B, bf16, out, s);
    case 5: return launch<VEC, 5>(bins, ld, ch, n, F, B, bf16, out, s);
    case 6: return launch<VEC, 6>(bins, ld, ch, n, F, B, bf16, out, s);
    case 7: return launch<VEC, 7>(bins, ld, ch, n, F, B, bf16, out, s);
    case 8: return launch<VEC, 8>(bins, ld, ch, n, F, B, bf16, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bins_t [F, n] u8 with row stride `ld` bytes (unit stride along rows),
// channels [n, K] f32 contiguous, out [F, B, K] f32 zeroed by the caller.
extern "C" int lgbt_hist_sublane(const void* bins_t, long long ld,
                                 const void* ch, int K, long long n, int F,
                                 int B, int bf16, void* out, void* stream) {
  if (F <= 0 || B <= 0 || B > kMaxB || K <= 0 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const uint8_t* bins = static_cast<const uint8_t*>(bins_t);
  const bool vec = (reinterpret_cast<uintptr_t>(bins) & 7) == 0
                   && (ld & 7) == 0;
  const float* c = static_cast<const float*>(ch);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(bins, ld, c, K, n, F, B, bf16, o, s)
             : dispatch<false>(bins, ld, c, K, n, F, B, bf16, o, s);
}
