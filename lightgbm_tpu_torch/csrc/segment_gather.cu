// Segment gather: the histogram inputs of one leaf segment of the packed row
// records, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's compact grower without the
// fused kernel (tpu_fused=off) builds a segment's histogram in row blocks,
// each block's channels stacked from its records' bytes by XLA
// (lightgbm_tpu/ops/compact.py segment_histogram, :384-407). On the card
// the segment's start and count stay on the device (the grower reads
// nothing back), so no PyTorch op can size that pass; this kernel does it,
// bounded by the count it reads:
//
//     ch[r]        = (grad, hess, in-bag indicator, 1) of record start + r
//                    (f32, or the quantized codes as int8 or int32)
//     bins_t[f, r] = feature f's bin of record start + r (optional; the
//                    feature-major copy K3 reads; nibbles unpacked)
//
// for r in [0, count), where seg = device int32 {start, count, which}
// (which != 0: the rows lie in `scratch`), clamped to the arrays' rows.
// K1 dense then reads the bins in place through the record stride and row
// r of ch for record start + r (csrc/histogram.cu).
//
// What bounds it on the H100: bytes. A record's grad, hess and weight
// (12 bytes; a 32-byte sector or two of its 128-byte line) and its bins
// are read once; ch is written once (16 or 4 bytes a row) and bins_t
// (F bytes a row) once. Rows are spread one a thread, so the channel
// stores of a warp are contiguous and each feature's row of bins_t is
// written by neighbouring threads at neighbouring bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32_bytes(const uint8_t* rec, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(rec);
  const int wi = off >> 2;
  const int sh = (off & 3) * 8;
  uint32_t v = __ldg(w + wi);
  if (sh) v = __funnelshift_r(v, __ldg(w + wi + 1), sh);
  return __uint_as_float(v);
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint8_t* work, const uint8_t* scratch, long long n_rows,
              long long stride, const int* seg, int F, int packed4,
              int grad_off, int hess_off, int cnt_off, int ch_type, void* ch,
              uint8_t* bins_t, long long ld) {
  const long long start = min(max((long long)seg[0], 0LL), n_rows);
  const long long count = min(max((long long)seg[1], 0LL), n_rows - start);
  const uint8_t* rows = seg[2] != 0 ? scratch : work;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < count; r += (long long)gridDim.x * kThreads) {
    const uint8_t* rec = rows + (start + r) * stride;
    const float g = load_f32_bytes(rec, grad_off);
    const float h = load_f32_bytes(rec, hess_off);
    const bool inbag = load_f32_bytes(rec, cnt_off) != 0.f;
    if (ch_type == 0) {
      reinterpret_cast<float4*>(ch)[r] =
          make_float4(g, h, inbag ? 1.f : 0.f, 1.f);
    } else if (ch_type == 1) {
      // integer codes stored as f32 (|code| <= 127): exact
      reinterpret_cast<char4*>(ch)[r] =
          make_char4((signed char)__float2int_rz(g),
                     (signed char)__float2int_rz(h), inbag ? 1 : 0, 1);
    } else {
      reinterpret_cast<int4*>(ch)[r] = make_int4(
          __float2int_rz(g), __float2int_rz(h), inbag ? 1 : 0, 1);
    }
    if (bins_t) {
      for (int f = 0; f < F; ++f) {
        const int b = packed4 ? (__ldg(rec + (f >> 1)) >> (4 * (f & 1))) & 0xF
                              : __ldg(rec + f);
        bins_t[(long long)f * ld + r] = (uint8_t)b;
      }
    }
  }
}

}  // namespace

// work, scratch: [n_rows, stride] u8 records; seg: device int32 {start,
// count, which}; F features (packed4: two a byte); the grad, hess and
// sample-weight f32 offsets; ch_type 0 f32, 1 int8, 2 int32; ch [n_rows, 4]
// of that type (rows [0, count) written); bins_t [F, ld] u8 or null
// (columns [0, count) written).
extern "C" int lgbt_segment_gather(const void* work, const void* scratch,
                                   long long n_rows, long long stride,
                                   const void* seg, int F, int packed4,
                                   int grad_off, int hess_off, int cnt_off,
                                   int ch_type, void* ch, void* bins_t,
                                   long long ld, void* stream) {
  if (F <= 0 || ch_type < 0 || ch_type > 2 || (bins_t && ld < n_rows))
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // eight blocks an SM, fewer where the array has fewer rows
  const long long want = (n_rows + kThreads - 1) / kThreads;
  const int grid = want < 8LL * sms ? (int)want : 8 * sms;
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(work), static_cast<const uint8_t*>(scratch),
      n_rows, stride, static_cast<const int*>(seg), F, packed4, grad_off,
      hess_off, cnt_off, ch_type, ch, static_cast<uint8_t*>(bins_t), ld);
  return (int)cudaGetLastError();
}
