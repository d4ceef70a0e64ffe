// K1: per-(feature, bin) histogram of row channels, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py::_hist_kernel
// (wrapper pallas_histogram) and the histogram half of
// lightgbm_tpu/ops/fused_split.py::_fused_kernel:
//
//     hist[f, b, k] = sum_r [bins[r, f] == b] * ch[r, k]
//
// The TPU kernel builds a one-hot in VMEM and contracts it on the MXU. Here
// the sum is a scatter-add into a histogram privatised in shared memory, one
// copy a block, added into the output with global atomics at the end.
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
// device int32 vector and clamped there, so the grower never reads it back
// to the host.
//
// Record mode has an integer variant (template parameter QUANT), the
// quantized-gradient histogram of the TPU kernels' int8 x int8 -> int32
// contraction (lightgbm_tpu/ops/fused_split.py, quant=True): the grad and
// hess columns hold the discretizer's integer codes as exact f32 values;
// each is converted to int once a row, summed with integer shared-memory
// atomics (native on sm_90, where an f32 one is a compare-and-swap loop) and
// added into an int32 output with integer global atomics. Integer sums do
// not depend on their order, so the result equals the plain version's
// exactly. The caller keeps rows x max |code| below 2^31.
//
// What bounds it on the H100: the least time is that of the bytes (dense:
// N (F + 4K); records: the two 32-byte sectors of each 128-byte record that
// hold bins and channels, 64 B a row), but the kernel issues one
// shared-memory atomic a (row, feature, channel), so shared-memory
// wavefronts and hot cells bind it. The design keeps their count low:
//   * feature rotation: at step j, lane l adds feature (j + l) mod P of its
//     own rows (P = 32 when 16 < fc < 32, the lanes past fc idling; else
//     P = fc). The shared histogram is [channel][bin][Fp] with Fp = 32 or
//     64, so a cell's bank is its feature mod 32: the 32 lanes of a warp hit
//     32 different banks whatever their bins, and never one cell, so a
//     skewed feature (most rows in one bin, zero-as-bin) puts no two lanes
//     of a warp on one address (no __match_any_sync aggregation needed);
//   * hot cells across warps: a skewed feature still sends the atomics of
//     all 32 warps of a block to a few cells. Each thread takes two rows a
//     tile and adds them with one atomic a channel where both sit in one
//     bin;
//   * wide loads: a row's bins go into a per-thread row buffer in shared
//     memory (records: 16-byte loads; dense: aligned 32-bit words), from
//     where the rotated byte is read (a stride of 8 words puts those reads
//     on 32 banks at P = 32; an odd stride on at most two a bank
//     otherwise); the channels go into registers once a row;
//   * integer counts: in record mode the in-bag and raw counts of a cell are
//     the low and high 16 bits of one u32, one integer atomic a (row,
//     feature) for both. A block flushes them into the output before any
//     bin could pass 65,535 rows (every 31 tiles of 2,048 rows) and at the
//     end, as exact integers converted to f32 (exact below 2^24 rows);
//   * occupancy: one 1,024-thread block an SM holds the whole feature set at
//     B = 256 (records: 3 x 256 x 32 x 4 B = 96 KB, with 64 KB of row
//     buffers), so a row is read once; wide feature sets split into chunks
//     over grid.y (at most 64 features a chunk, and dense channels into
//     halves when K x B does not fit);
//   * short segments (a deep split's child): a block takes at least one
//     tile, the blocks past the segment's tiles return before zeroing their
//     shared memory, and the end-of-block flush walks the cells without
//     integer division.
//
// The dense mode has an integer variant too (lgbt_hist_dense_int), the TPU
// kernel's int8 mode (pallas_histogram.py:107-109, :277-281): int8 or
// int32 codes summed with integer shared-memory atomics into an int32
// output, exactly. Its narrowed mode is the JAX package's 16-bit quantized
// engine (ops/histogram.py _xla_histogram_narrow, XLA there): the (grad,
// hess) codes of a row travel as one 32-bit word g * 2^16 + h and the
// (in-bag, raw) counts as another, so a (row, feature) costs two atomics
// where the 32-bit cells cost four. A word is unpacked with an arithmetic
// shift and a mask (exact for a negative grad sum while the hess sum stays
// below 2^16), so a block flushes its cells into the output before any of
// them could carry: every 32,767 / quant_max rows, two rows a thread a tile
// while that is at least 2,048 rows, else one. With narrow == 2 the kernel
// takes the 16-bit cells only where the whole segment fits them (count x
// quant_max < 2^15, the reference's GetHistBitsInLeaf), a choice made on
// the device from the segment count it reads, and tallies those launches.
//
// Both modes read a segment given on the device (seg = start, count, which
// array) through a row stride, as record mode does: the compact grower
// without the fused kernel histograms the records' bin columns in place,
// with the segment's channels (row r of the channels for row start + r)
// from csrc/segment_gather.cu. Nibble-packed bins (packed4: feature f in
// byte f >> 1, shift 4 (f & 1)) are unpacked into the row buffer as a row
// is loaded, in record and in dense mode, so the rest of the kernel is
// that of u8 bins; an odd F's last high nibble is never read.
//
// Wide bins (lgbt_hist_dense_u16): a bin matrix of more than 256 bins is
// 16-bit (uint16 on the host, an int16 view of the same bytes on the
// device), B up to 65,536, in dense f32 mode only: the masked grower's
// histogram, the one path such data trains on (the compact grower's
// records hold bins in bytes, and quantized runs on the masked grower sum
// dequantized f32 channels). It is its own kernel, hist_wide_kernel, so
// the byte-bin modes above keep their layout and row buffer as they are:
//   * shared memory: the block's cells are [kc][fc][bs] f32, bs = br | 1
//     (an odd stride: the same bin of the features of a rotation step lands
//     on different banks). [F, B, K] at B = 1,024 is 344 KB at K = 3, past
//     the 227 KB a block may use, and one feature's [B, K] passes it from
//     B = 18,944. So the launch narrows in this order until the cells fit:
//     the feature chunk (grid.y, down to one feature), then the channels
//     (grid.y, down to one), then the bin range (grid.z): at B = 1,024,
//     K = 3, F = 28 two chunks of 14 features; at B = 40,000 one feature
//     and one channel a block (160 KB); at B = 65,536 two bin ranges. Each
//     (feature chunk, channel chunk, bin range) reads the rows once; a row
//     whose bin falls outside the block's range adds nothing there;
//   * rows: one a thread a step, neighbouring threads on neighbouring
//     rows; its channels first, and a row whose channels are all zero (the
//     masked grower zeroes every row outside the histogrammed leaf) reads
//     no bins and adds nothing; features rotated across the lanes as above
//     (lane l adds feature (j + l) mod fc at step j); bins read as uint16
//     into 32-bit registers, so no value in [0, 65,535] is a sentinel, and
//     bins >= B drop;
//   * the end: each nonzero cell added into the output with one global
//     atomic.
// What bounds it: the bytes are N (2F + 4K) at the root; the f32
// shared-memory atomics, one a (live row, feature, channel), bind it as
// they do the byte-bin modes.
//
// The deterministic mode (deterministic=True; template parameter DET, the
// entries lgbt_hist_records_det, lgbt_hist_dense_det and
// lgbt_hist_dense_u16_det): every float mode above adds its f32 channels in
// fixed point. Each addend becomes an int64 q = rint(v * scale[k]) (scale a
// power of two, one a channel for the whole tree, read on the device: the
// caller chooses it so that rows x max |v| x scale < 2^62, ops/
// determinism.py), the shared cells are int64 and add with integer
// atomics, and each block adds its cells into an int64 [F, B, K] array
// with integer global atomics; a finishing launch writes each cell as
// (float)((double)sum / scale[k]). Integer sums do not depend on their
// order, so the result is fixed by the inputs and equals, bit for bit, the
// plain fixed-point sum (fixed_point_histogram). The record mode's counts
// are the packed 16-bit integers they are in the default mode, added into
// the output as exact f32 integers: order-free as well. The int64 cells
// double the float part of the shared histogram: records at B = 256 take
// 2 x 2 x 256 x 32 x 8 B + 32 KB of counts = 160 KB beside the 64 KB of row
// buffers (still one chunk at F <= 32); dense and wide modes narrow their
// chunks further as the launch's loops below find. The integer variants
// already sum exactly, and take no such mode.
//
// A one-hot product on the tensor cores is not the route: it would first
// write a 256-wide one-hot for every (row, feature) into shared memory:
// 10.5M x 28 x 256 = 75 billion entries at the root of a Higgs-sized tree,
// 75 GB of stores even at one byte an entry, against 0.7 GB of input.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "det_finish.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 2 * kThreads;      // two rows a thread a tile
constexpr int kMaxK = 8;
constexpr int kMaxChunk = 64;            // features a block at most
constexpr long long kCountFlushRows = 65535;
// the most dynamic shared memory a block may use on the H100 (227 KB)
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float load_f32_bytes(const uint8_t* rec, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(rec);
  const int wi = off >> 2;
  const int sh = (off & 3) * 8;
  uint32_t v = __ldg(w + wi);
  if (sh) v = __funnelshift_r(v, __ldg(w + wi + 1), sh);
  return __uint_as_float(v);
}

// the accumulator of the grad and hess channels: int codes (QUANT) or f32
template <bool QUANT>
using Acc = typename std::conditional<QUANT, int, float>::type;

struct Args {
  const uint8_t* rows_a;
  const uint8_t* rows_b;
  long long stride;
  const float* ch;
  const int8_t* ch8;   // dense integer variant: int8 codes, else
  const int* ch32;     // int32 codes
  const int* seg;      // device (start, count, which), or null (dense)
  long long n_rows;
  long long count;
  float* out;
  int* iout;           // the integer variants' int32 output
  int* tally;          // narrowed launches chosen on the device, or null
  const double* scale;         // DET: the channels' fixed-point scales
  unsigned long long* acc;     // DET: int64 [F, B, K (records: 2)] sums
  int K, F, B, bf16;
  int fc, Fp, kc, nf;  // feature chunk, its padded width, channels a chunk
  int u;               // row-buffer words a thread (8 or odd)
  int grad_off, hess_off, cnt_off;
  int packed4;         // bins nibble-packed, two features a byte
  int narrow;          // 0: 32-bit cells; 1: 16-bit; 2: 16-bit if it fits
  int quant_max;       // |code| bound of the narrowed mode
};

// Four packed bytes (eight nibbles) into eight bytes, features in order.
__device__ __forceinline__ void unpack_word(uint32_t v, uint32_t* d) {
  const uint32_t lo = v & 0x0f0f0f0fu;
  const uint32_t hi = (v >> 4) & 0x0f0f0f0fu;
  d[0] = __byte_perm(lo, hi, 0x5140);
  d[1] = __byte_perm(lo, hi, 0x7362);
}

// One row into the thread's row buffer (the bytes of features [f0, f0 + fc)
// from the returned offset on, nibbles unpacked) and its channels into c:
// records: grad, hess -- as ints with QUANT -- and the packed counts
// `packed`; dense: the row's channels at channel row `crow` (QUANT: int
// codes; narrowed: the two packed words). Returns the offset.
template <bool RECORDS, bool QUANT>
__device__ __forceinline__ int load_row(const Args& a, const uint8_t* rows,
                                        long long row, long long crow,
                                        int f0, int fc, int k0, int kc,
                                        bool narrow, uint32_t* buf,
                                        Acc<QUANT>* c, uint32_t& packed) {
  int boff;
  const uint8_t* rec = rows + row * a.stride;
  if (RECORDS) {
    const uint4* src = reinterpret_cast<const uint4*>(rec);
    if (a.packed4) {
      const int q0 = (f0 >> 1) >> 4;
      const int q1 = (((f0 + fc - 1) >> 1) + 16) >> 4;
      for (int q = q0; q < q1; ++q) {
        const uint4 v = __ldg(src + q);
        uint32_t* d = buf + 8 * (q - q0);
        unpack_word(v.x, d);
        unpack_word(v.y, d + 2);
        unpack_word(v.z, d + 4);
        unpack_word(v.w, d + 6);
      }
      boff = f0 - 32 * q0;
    } else {
      const int q0 = f0 >> 4;
      const int q1 = (f0 + fc + 15) >> 4;
      for (int q = q0; q < q1; ++q) {
        const uint4 v = __ldg(src + q);
        uint32_t* d = buf + 4 * (q - q0);
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
      boff = f0 - 16 * q0;
    }
    if (QUANT) {
      // integer codes stored as f32: the conversion is exact
      c[0] = __float2int_rz(load_f32_bytes(rec, a.grad_off));
      c[1] = __float2int_rz(load_f32_bytes(rec, a.hess_off));
    } else {
      c[0] = load_f32_bytes(rec, a.grad_off);
      c[1] = load_f32_bytes(rec, a.hess_off);
    }
    packed = 0x10000u | (load_f32_bytes(rec, a.cnt_off) != 0.f ? 1u : 0u);
    return boff;
  }
  const int b0 = a.packed4 ? f0 >> 1 : f0;
  const int b1 = a.packed4 ? ((f0 + fc - 1) >> 1) + 1 : f0 + fc;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(rec + b0);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
  const int boff_b = (int)(addr & 3);
  const int nw = (boff_b + b1 - b0 + 3) >> 2;
  if (a.packed4) {
    for (int i = 0; i < nw; ++i) unpack_word(__ldg(w + i), buf + 2 * i);
    boff = 2 * boff_b + (f0 & 1);
  } else {
    for (int i = 0; i < nw; ++i) buf[i] = __ldg(w + i);
    boff = boff_b;
  }
  if (QUANT) {
    // the narrowed mode packs all four channels into its two words
    const int kr = narrow ? 4 : kc;
    int v[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < kr) {
        const long long i = crow * a.K + k0 + k;
        v[k] = a.ch8 ? (int)__ldg(a.ch8 + i) : __ldg(a.ch32 + i);
      }
    }
    if (narrow) {
      // (grad, hess) and (in-bag, raw) as two words hi * 2^16 + lo
      c[0] = (int)(((uint32_t)v[0] << 16) + (uint32_t)v[1]);
      c[1] = (int)(((uint32_t)v[2] << 16) + (uint32_t)v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < kc) c[k] = v[k];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < kc) {
        const float v = __ldg(a.ch + crow * a.K + k0 + k);
        c[k] = a.bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
      }
    }
  }
  return boff;
}

// Flush a block's packed cells into the int32 or f32 output: records'
// counts (low 16 bits in-bag, high raw), or the narrowed words (hi * 2^16
// + lo: grad, hess; in-bag, raw). Zeroes them.
template <bool RECORDS, bool QUANT>
__device__ __forceinline__ void flush_packed(const Args& a, uint32_t* smem,
                                             uint32_t* counts, int f0, int fc,
                                             int lg) {
  const int B = a.B;
  const int Fp = a.Fp;
  for (int i = threadIdx.x; i < B * Fp; i += kThreads) {
    const int f = i & (Fp - 1);
    if (f >= fc) continue;
    const long long o = ((long long)(f0 + f) * B + (i >> lg)) * 4;
    if (RECORDS) {
      const uint32_t v = counts[i];
      if (v == 0u) continue;
      if (QUANT) {
        atomicAdd(a.iout + o + 2, (int)(v & 0xffffu));
        atomicAdd(a.iout + o + 3, (int)(v >> 16));
      } else {
        atomicAdd(a.out + o + 2, (float)(v & 0xffffu));
        atomicAdd(a.out + o + 3, (float)(v >> 16));
      }
      counts[i] = 0u;
    } else {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t v = smem[w * B * Fp + i];
        if (v == 0u) continue;
        // arithmetic shift: floor(v / 2^16), exact while lo < 2^16
        atomicAdd(a.iout + o + 2 * w, (int)v >> 16);
        atomicAdd(a.iout + o + 2 * w + 1, (int)(v & 0xffffu));
        smem[w * B * Fp + i] = 0u;
      }
    }
  }
}

// DET: an f32 addend as int64 fixed point (two's complement in a u64);
// otherwise the addend itself
template <bool DET, typename T>
__device__ __forceinline__ auto to_cell(T v, double scale) {
  if constexpr (DET) {
    return (unsigned long long)__double2ll_rn((double)v * scale);
  } else {
    return v;
  }
}

template <bool RECORDS, bool QUANT, bool DET = false>
__global__ void __launch_bounds__(kThreads, 1) hist_kernel(const Args a) {
  static_assert(!(QUANT && DET), "the integer variants are exact already");
  // the grad and hess (dense: every channel) cells
  using Cell = typename std::conditional<DET, unsigned long long,
                                         Acc<QUANT>>::type;
  constexpr int kWords = DET ? 2 : 1;   // 32-bit words a float cell
  extern __shared__ uint32_t smem[];
  const int f0 = (blockIdx.y % a.nf) * a.fc;
  const int fc = min(a.fc, a.F - f0);
  const int k0 = (blockIdx.y / a.nf) * a.kc;
  const int B = a.B;
  const int Fp = a.Fp;                 // 32 or 64
  const int lg = Fp == 64 ? 6 : 5;

  long long start = 0;
  long long count = a.count;
  const uint8_t* rows = a.rows_a;
  if (a.seg) {
    // defence in depth, as the fused split's prep clamps its scalars: a bad
    // segment reads fewer rows, never rows outside the arrays
    start = min(max((long long)a.seg[0], 0LL), a.n_rows);
    count = min(max((long long)a.seg[1], 0LL), a.n_rows - start);
    if (a.seg[2] != 0) rows = a.rows_b;
  }
  // the narrowed cells: forced, or where the whole segment fits them
  const bool narrow = !RECORDS && QUANT
      && (a.narrow == 1 || (a.narrow == 2 && count * a.quant_max < 32768));
  if (narrow && a.narrow == 2 && a.tally && blockIdx.x == 0
      && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(a.tally, 1);
  const int kc = RECORDS ? 3 : narrow ? 2 : min(a.kc, a.K - k0);
  // rows a block adds between flushes of its packed cells (0: never)
  const long long flush_rows =
      RECORDS ? kCountFlushRows : narrow ? 32767 / a.quant_max : 0;
  const int tile = narrow && flush_rows < kTile ? kThreads : kTile;
  const long long n_tiles = (count + tile - 1) / tile;
  const int active = (int)min((long long)gridDim.x, max(n_tiles, 1LL));
  if ((int)blockIdx.x >= active) return;  // uniform across the block

  // [kc][B][Fp] cells; in record mode channel 2 holds the packed counts
  Cell* hist = reinterpret_cast<Cell*>(smem);
  uint32_t* counts = smem + 2 * kWords * B * Fp;
  const int cells = (RECORDS ? 2 * kWords + 1 : kc * kWords) * B * Fp;
  for (int i = threadIdx.x; i < cells; i += kThreads) smem[i] = 0u;
  // DET: the fixed-point scales of the block's channels
  double sc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    sc[k] = DET && k < (RECORDS ? 2 : kc) ? a.scale[k0 + k] : 1.0;
  }
  uint32_t* buf0 = smem + cells + threadIdx.x * a.u;
  uint32_t* buf1 = buf0 + kThreads * a.u;
  const uint8_t* bytes0 = reinterpret_cast<const uint8_t*>(buf0);
  const uint8_t* bytes1 = reinterpret_cast<const uint8_t*>(buf1);
  // rotation period: between 16 and 32 features, the lanes past fc would
  // share banks with lanes 0.. (two wavefronts an atomic); a period of 32
  // idles them instead (one wavefront, a few more steps)
  const int rot = fc > 16 && fc < 32 ? 32 : fc;
  const int lane_f = (threadIdx.x & 31) % rot;
  __syncthreads();

  long long since_flush = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += active) {
    if (flush_rows && since_flush + tile > flush_rows) {
      // no packed cell of this block can carry before the flush
      __syncthreads();
      flush_packed<RECORDS, QUANT>(a, smem, counts, f0, fc, lg);
      __syncthreads();
      since_flush = 0;
    }
    since_flush += tile;
    // rows r and r + kThreads of the tile (one row a thread in the
    // narrowed mode's short tiles): neighbouring threads read
    // neighbouring rows
    const long long r = t * tile + threadIdx.x;
    if (r >= count) continue;
    const bool two = tile == kTile && r + kThreads < count;
    Acc<QUANT> c0[kMaxK], c1[kMaxK] = {};
    uint32_t p0 = 0u, p1 = 0u;
    const int boff0 = load_row<RECORDS, QUANT>(a, rows, start + r, r, f0,
                                               fc, k0, kc, narrow, buf0, c0,
                                               p0);
    const int boff1 =
        two ? load_row<RECORDS, QUANT>(a, rows, start + r + kThreads,
                                       r + kThreads, f0, fc, k0, kc, narrow,
                                       buf1, c1, p1)
            : 0;
    // the channels set above (records and the narrowed words: two)
    const int kset = RECORDS || narrow ? 2 : kc;
    Cell q0[kMaxK], q1[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < kset) {
        q0[k] = to_cell<DET>(c0[k], sc[k]);
        q1[k] = to_cell<DET>(c1[k], sc[k]);
      }
    }
    for (int j = 0; j < rot; ++j) {
      int f = j + lane_f;
      if (f >= rot) f -= rot;
      if (f >= fc) continue;
      const int b0 = bytes0[boff0 + f];
      // bins >= B drop, as the TPU one-hot drops them; 256 marks no row
      const int b1 = two ? bytes1[boff1 + f] : 256;
      // both rows in one bin (a skewed feature): one atomic a channel
      const bool same = b0 == b1;
      if (b0 < B) {
        const int cell = b0 * Fp + f;
        if (RECORDS) {
          atomicAdd(hist + cell, same ? q0[0] + q1[0] : q0[0]);
          atomicAdd(hist + B * Fp + cell, same ? q0[1] + q1[1] : q0[1]);
          atomicAdd(counts + cell, same ? p0 + p1 : p0);
        } else {
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (k < kc)
              atomicAdd(hist + k * B * Fp + cell,
                        same ? q0[k] + q1[k] : q0[k]);
          }
        }
      }
      if (!same && b1 < B) {
        const int cell = b1 * Fp + f;
        if (RECORDS) {
          atomicAdd(hist + cell, q1[0]);
          atomicAdd(hist + B * Fp + cell, q1[1]);
          atomicAdd(counts + cell, p1);
        } else {
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (k < kc) atomicAdd(hist + k * B * Fp + cell, q1[k]);
          }
        }
      }
    }
  }
  __syncthreads();
  if (narrow) {
    flush_packed<false, true>(a, smem, counts, f0, fc, lg);
    return;
  }
  const int K = RECORDS ? 4 : a.K;
  const int float_ch = RECORDS ? 2 : kc;
  if (DET) {
    // the int64 cells into the int64 sums, one integer atomic a non-zero
    // cell; the counts below as in the default mode
    const unsigned long long* h64 =
        reinterpret_cast<const unsigned long long*>(smem);
    const int ka = RECORDS ? 2 : a.K;
    for (int k = 0; k < float_ch; ++k) {
      for (int i = threadIdx.x; i < B * Fp; i += kThreads) {
        const int f = i & (Fp - 1);
        const unsigned long long v = h64[k * B * Fp + i];
        if (f >= fc || v == 0ull) continue;
        atomicAdd(a.acc + ((long long)(f0 + f) * B + (i >> lg)) * ka + k0
                      + k,
                  v);
      }
    }
  }
  for (int k = DET ? float_ch : 0; k < kc; ++k) {
    const uint32_t* cells_k = k < float_ch ? smem + k * B * Fp : counts;
    for (int i = threadIdx.x; i < B * Fp; i += kThreads) {
      const int f = i & (Fp - 1);
      const uint32_t v = cells_k[i];
      if (f >= fc || v == 0u) continue;
      const long long o = ((long long)(f0 + f) * B + (i >> lg)) * K;
      if (QUANT) {
        if (k < float_ch) {
          atomicAdd(a.iout + o + k0 + k, (int)v);
        } else {
          atomicAdd(a.iout + o + 2, (int)(v & 0xffffu));
          atomicAdd(a.iout + o + 3, (int)(v >> 16));
        }
      } else if (k < float_ch) {
        atomicAdd(a.out + o + k0 + k, __uint_as_float(v));
      } else {
        atomicAdd(a.out + o + 2, (float)(v & 0xffffu));
        atomicAdd(a.out + o + 3, (float)(v >> 16));
      }
    }
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

// Chunking: the widest feature chunk (<= 64) and the most channels a chunk
// whose histogram and row buffers fit one block's shared memory.
template <bool RECORDS, bool QUANT = false, bool DET = false>
int launch(Args a, cudaStream_t stream) {
  if (a.F <= 0 || a.B <= 0 || a.B > 256 || a.K <= 0 || a.K > kMaxK)
    return (int)cudaErrorInvalidValue;
  // the narrowed mode: the (grad, hess, in-bag, raw) quad, and at least one
  // row a thread between flushes
  if (a.narrow && (a.K != 4 || a.quant_max < 1
                   || 32767 / a.quant_max < kThreads))
    return (int)cudaErrorInvalidValue;
  const int kc_all = RECORDS ? 3 : a.K;
  // the packed cells need all their channels in one block
  const bool split_k = !RECORDS && a.narrow == 0;
  // a thread's row-buffer words: its chunk's bins, nibbles unpacked
  // (records: whole 16-byte vectors from a chunk start that may sit
  // mid-vector; dense: words from an address that may sit mid-word). The
  // stride sets the banks of the rotated byte reads: 8 words puts them on
  // 32 banks at a rotation period of 32, an odd stride on at most two a
  // bank otherwise
  auto row_words = [&](int fc) {
    int w;
    if (RECORDS && a.packed4) {
      // a chunk's packed bytes are at most fc / 2 + 1
      w = fc == a.F ? 8 * (((a.F + 1) / 2 + 15) / 16)
                    : 8 * ((fc / 2 + 1 + 30) / 16);
    } else if (RECORDS) {
      // records in one chunk start at vector 0
      w = fc == a.F ? 4 * ((fc + 15) / 16) : 4 * ((15 + fc + 15) / 16);
    } else if (a.packed4) {
      w = 2 * ((3 + fc / 2 + 1 + 3) / 4);
    } else {
      w = (3 + fc + 3) / 4;
    }
    return fc > 16 && fc < 32 && w <= 8 ? 8 : w | 1;
  };
  auto fp_of = [](int fc) { return (fc + 31) / 32 * 32; };
  // 32-bit words of a (bin, feature): DET's float cells take two
  auto cell_words = [&](int kc) {
    return DET ? (RECORDS ? 5 : 2 * kc) : kc;
  };
  auto smem_of = [&](int fc, int kc) {
    return (long long)cell_words(kc) * a.B * fp_of(fc) * 4
           + 2LL * kThreads * row_words(fc) * 4;
  };
  int fc = a.F < kMaxChunk ? a.F : kMaxChunk;
  int kc = kc_all;
  while (smem_of(fc, kc) > kSmemLimit) {
    if (fc > 32) {
      fc = 32;
    } else if (split_k && kc > 1) {
      kc = (kc + 1) / 2;
    } else if (fc > 1) {
      fc = (fc + 1) / 2;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  a.nf = (a.F + fc - 1) / fc;
  a.fc = (a.F + a.nf - 1) / a.nf;
  const int nk = (kc_all + kc - 1) / kc;
  a.kc = RECORDS ? 3 : (kc_all + nk - 1) / nk;
  a.Fp = fp_of(a.fc);
  a.u = row_words(a.fc);
  const int smem = (int)smem_of(a.fc, a.kc);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<RECORDS, QUANT, DET>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    smem_set = kSmemLimit;
  }
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, hist_kernel<RECORDS, QUANT, DET>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int chunks = a.nf * nk;
  int gx = num_sms() * (occ > 0 ? occ : 1) / chunks;
  if (gx < 1) gx = 1;
  if (!RECORDS) {
    // dense: the rows (or, for a segment on the device, the most it holds)
    if (a.count <= 0) return (int)cudaSuccess;
    const long long tiles = (a.count + kTile - 1) / kTile;
    if (tiles < gx) gx = (int)tiles;
  }
  hist_kernel<RECORDS, QUANT, DET>
      <<<dim3(gx, chunks), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

struct WideArgs {
  const uint16_t* bins;
  long long n_rows;
  long long stride;    // elements a row
  const float* ch;     // [n_rows, K]
  float* out;          // [F, B, K]
  const double* scale;         // DET: the channels' fixed-point scales
  unsigned long long* acc;     // DET: int64 [F, B, K] sums
  int K, F, B, bf16;
  int fc, nf, kc, br, bs;  // feature chunk, chunks; channels, bin range
};

template <bool DET = false>
__global__ void __launch_bounds__(kThreads, 1)
    hist_wide_kernel(const WideArgs a) {
  using Cell = typename std::conditional<DET, unsigned long long,
                                         float>::type;
  extern __shared__ __align__(16) unsigned char wraw[];
  Cell* wcells = reinterpret_cast<Cell*>(wraw);
  const int f0 = (blockIdx.y % a.nf) * a.fc;
  const int fc = min(a.fc, a.F - f0);
  const int k0 = (blockIdx.y / a.nf) * a.kc;
  const int kc = min(a.kc, a.K - k0);
  const int b0 = blockIdx.z * a.br;
  const int br = min(a.br, a.B - b0);
  if (br <= 0) return;  // uniform across the block
  const int bs = a.bs;
  const int cells = a.kc * a.fc * bs;
  for (int i = threadIdx.x; i < cells; i += kThreads) wcells[i] = Cell(0);
  double sc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    sc[k] = DET && k < kc ? a.scale[k0 + k] : 1.0;
  }
  __syncthreads();
  const int lane_f = (threadIdx.x & 31) % fc;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x;
       r < a.n_rows; r += step) {
    Cell c[kMaxK];
    bool live = false;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < kc) {
        const float v = __ldg(a.ch + r * a.K + k0 + k);
        const float x = a.bf16 ? __bfloat162float(__float2bfloat16_rn(v))
                               : v;
        live |= x != 0.f;
        c[k] = to_cell<DET>(x, sc[k]);
      }
    }
    if (!live) continue;
    const uint16_t* row = a.bins + r * a.stride + f0;
    for (int j = 0; j < fc; ++j) {
      int f = j + lane_f;
      if (f >= fc) f -= fc;
      // unsigned: bins below b0 wrap past br and drop, as do bins >= B
      const unsigned b = (unsigned)__ldg(row + f) - (unsigned)b0;
      if (b >= (unsigned)br) continue;
      Cell* cell = wcells + f * bs + b;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < kc) atomicAdd(cell + k * a.fc * bs, c[k]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const Cell v = wcells[i];
    const int b = i % bs;
    const int f = (i / bs) % a.fc;
    const int k = i / (bs * a.fc);
    if (v == Cell(0) || b >= br || f >= fc || k >= kc) continue;
    const long long o = ((long long)(f0 + f) * a.B + b0 + b) * a.K + k0 + k;
    if constexpr (DET) {
      atomicAdd(a.acc + o, v);
    } else {
      atomicAdd(a.out + o, v);
    }
  }
}

// The wide-bin launch: the widest feature chunk (<= 64), then the most
// channels, then the widest bin range whose cells fit a block.
template <bool DET = false>
int launch_wide(WideArgs a, cudaStream_t stream) {
  if (a.F <= 0 || a.B <= 0 || a.B > 65536 || a.K <= 0 || a.K > kMaxK
      || a.stride < a.F)
    return (int)cudaErrorInvalidValue;
  if (a.n_rows <= 0) return (int)cudaSuccess;
  auto smem_of = [](int fc, int kc, int br) {
    return (long long)kc * fc * (br | 1) * (DET ? 8 : 4);
  };
  int fc = a.F < kMaxChunk ? a.F : kMaxChunk;
  int kc = a.K;
  int br = a.B;
  while (smem_of(fc, kc, br) > kSmemLimit) {
    if (fc > 1) {
      fc = (fc + 1) / 2;
    } else if (kc > 1) {
      kc = (kc + 1) / 2;
    } else {
      br = (br + 1) / 2;
    }
  }
  // even chunks of the same count
  a.nf = (a.F + fc - 1) / fc;
  a.fc = (a.F + a.nf - 1) / a.nf;
  const int nk = (a.K + kc - 1) / kc;
  a.kc = (a.K + nk - 1) / nk;
  const int nz = (a.B + br - 1) / br;
  a.br = (a.B + nz - 1) / nz;
  a.bs = a.br | 1;
  const int smem = (int)smem_of(a.fc, a.kc, a.br);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_wide_kernel<DET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    smem_set = kSmemLimit;
  }
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, hist_wide_kernel<DET>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int chunks = a.nf * nk * nz;
  long long gx = (long long)num_sms() * (occ > 0 ? occ : 1) / chunks;
  const long long row_blocks = (a.n_rows + kThreads - 1) / kThreads;
  if (gx > row_blocks) gx = row_blocks;
  if (gx < 1) gx = 1;
  hist_wide_kernel<DET><<<dim3((unsigned)gx, a.nf * nk, nz), kThreads,
                          smem, stream>>>(a);
  return (int)cudaGetLastError();
}

Args record_args(const void* work, const void* scratch, long long n_rows,
                 long long stride, const void* seg, int F, int B, int packed4,
                 int grad_off, int hess_off, int cnt_off) {
  Args a = {};
  a.rows_a = static_cast<const uint8_t*>(work);
  a.rows_b = static_cast<const uint8_t*>(scratch);
  a.stride = stride;
  a.seg = static_cast<const int*>(seg);
  a.n_rows = n_rows;
  a.K = 4;
  a.F = F;
  a.B = B;
  a.packed4 = packed4;
  a.grad_off = grad_off;
  a.hess_off = hess_off;
  a.cnt_off = cnt_off;
  return a;
}

Args dense_args(const void* bins, const void* bins_b, long long n_rows,
                long long stride, const void* seg, int packed4, int K, int F,
                int B) {
  Args a = {};
  a.rows_a = static_cast<const uint8_t*>(bins);
  a.rows_b = static_cast<const uint8_t*>(bins_b);
  a.stride = stride;
  a.seg = static_cast<const int*>(seg);
  a.n_rows = n_rows;
  a.count = n_rows;
  a.packed4 = packed4;
  a.K = K;
  a.F = F;
  a.B = B;
  return a;
}

}  // namespace

// Dense mode: bins [n_rows, *] u8 with row stride `stride` bytes (packed4:
// two features a byte), channels [n_rows, K] f32 contiguous, out [F, B, K]
// f32 zeroed by the caller. With `seg` (device int32 {start, count,
// which}, clamped to the rows) rows [start, start + count) of `bins`
// (which == 0) or `bins_b`, whose row start + r takes channel row r.
extern "C" int lgbt_hist_dense(const void* bins, const void* bins_b,
                               long long n_rows, long long stride,
                               const void* seg, int packed4, const void* ch,
                               int K, int F, int B, int bf16, void* out,
                               void* stream) {
  Args a = dense_args(bins, bins_b, n_rows, stride, seg, packed4, K, F, B);
  a.ch = static_cast<const float*>(ch);
  a.out = static_cast<float*>(out);
  a.bf16 = bf16;
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}

// Dense mode on 16-bit bins: bins [n_rows, *] uint16 (B <= 65,536) with a
// row stride of `stride` elements, channels [n_rows, K] f32 contiguous
// (bf16: rounded to bf16 first), out [F, B, K] f32 zeroed by the caller.
extern "C" int lgbt_hist_dense_u16(const void* bins, long long n_rows,
                                   long long stride, const void* ch, int K,
                                   int F, int B, int bf16, void* out,
                                   void* stream) {
  WideArgs a = {};
  a.bins = static_cast<const uint16_t*>(bins);
  a.n_rows = n_rows;
  a.stride = stride;
  a.ch = static_cast<const float*>(ch);
  a.out = static_cast<float*>(out);
  a.K = K;
  a.F = F;
  a.B = B;
  a.bf16 = bf16;
  return launch_wide(a, static_cast<cudaStream_t>(stream));
}

// Dense mode, integer variant: the same rows against int8 (ch_int8) or
// int32 codes; out [F, B, K] int32 zeroed by the caller. narrow 1: the
// 16-bit cells (K = 4: grad, hess, in-bag, raw; |code| <= quant_max <= 31,
// hess codes >= 0); 2: those cells where count x quant_max < 2^15, which
// then adds one to *tally (if not null).
extern "C" int lgbt_hist_dense_int(const void* bins, const void* bins_b,
                                   long long n_rows, long long stride,
                                   const void* seg, int packed4,
                                   const void* ch, int ch_int8, int K, int F,
                                   int B, int quant_max, int narrow,
                                   void* out, void* tally, void* stream) {
  Args a = dense_args(bins, bins_b, n_rows, stride, seg, packed4, K, F, B);
  if (ch_int8) {
    a.ch8 = static_cast<const int8_t*>(ch);
  } else {
    a.ch32 = static_cast<const int*>(ch);
  }
  a.iout = static_cast<int*>(out);
  a.tally = static_cast<int*>(tally);
  a.quant_max = quant_max;
  a.narrow = narrow;
  return launch<false, true>(a, static_cast<cudaStream_t>(stream));
}

// Record mode: rows [start, start + count) of `work` (seg[2] == 0) or
// `scratch` (seg[2] != 0), both [n_rows, stride] u8, seg = device int32
// {start, count, which}, clamped on the device to start in [0, n_rows] and
// count in [0, n_rows - start]; packed4: the bin columns hold two features
// a byte; out [F, B, 4] f32 zeroed by the caller.
extern "C" int lgbt_hist_records(const void* work, const void* scratch,
                                 long long n_rows, long long stride,
                                 const void* seg, int F, int B, int packed4,
                                 int grad_off, int hess_off, int cnt_off,
                                 void* out, void* stream) {
  Args a = record_args(work, scratch, n_rows, stride, seg, F, B, packed4,
                       grad_off, hess_off, cnt_off);
  a.out = static_cast<float*>(out);
  return launch<true>(a, static_cast<cudaStream_t>(stream));
}

// Record mode, integer variant: the same rows, whose grad and hess columns
// hold integer codes (f32 bytes); out [F, B, 4] int32 zeroed by the caller.
extern "C" int lgbt_hist_records_int(const void* work, const void* scratch,
                                     long long n_rows, long long stride,
                                     const void* seg, int F, int B,
                                     int packed4, int grad_off, int hess_off,
                                     int cnt_off, void* out, void* stream) {
  Args a = record_args(work, scratch, n_rows, stride, seg, F, B, packed4,
                       grad_off, hess_off, cnt_off);
  a.iout = static_cast<int*>(out);
  return launch<true, true>(a, static_cast<cudaStream_t>(stream));
}

// The deterministic mode of the f32 entries above (the header note): the
// same arguments, then `scale` (float64 [K]: records' grad and hess at 0
// and 1) and `acc`, int64 [F, B, K] (records: [F, B, 2]) zeroed by the
// caller; `out` zeroed by the caller as above.
extern "C" int lgbt_hist_records_det(const void* work, const void* scratch,
                                     long long n_rows, long long stride,
                                     const void* seg, int F, int B,
                                     int packed4, int grad_off, int hess_off,
                                     int cnt_off, const void* scale,
                                     void* acc, void* out, void* stream) {
  Args a = record_args(work, scratch, n_rows, stride, seg, F, B, packed4,
                       grad_off, hess_off, cnt_off);
  a.out = static_cast<float*>(out);
  a.scale = static_cast<const double*>(scale);
  a.acc = static_cast<unsigned long long*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch<true, false, true>(a, s);
  if (e != 0) return e;
  return det_finish(a.acc, a.scale, a.out, (long long)F * B, 2, 4, s);
}

extern "C" int lgbt_hist_dense_det(const void* bins, const void* bins_b,
                                   long long n_rows, long long stride,
                                   const void* seg, int packed4,
                                   const void* ch, int K, int F, int B,
                                   int bf16, const void* scale, void* acc,
                                   void* out, void* stream) {
  Args a = dense_args(bins, bins_b, n_rows, stride, seg, packed4, K, F, B);
  a.ch = static_cast<const float*>(ch);
  a.out = static_cast<float*>(out);
  a.bf16 = bf16;
  a.scale = static_cast<const double*>(scale);
  a.acc = static_cast<unsigned long long*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch<false, false, true>(a, s);
  if (e != 0) return e;
  return det_finish(a.acc, a.scale, a.out, (long long)F * B, K, K, s);
}

extern "C" int lgbt_hist_dense_u16_det(const void* bins, long long n_rows,
                                       long long stride, const void* ch,
                                       int K, int F, int B, int bf16,
                                       const void* scale, void* acc,
                                       void* out, void* stream) {
  WideArgs a = {};
  a.bins = static_cast<const uint16_t*>(bins);
  a.n_rows = n_rows;
  a.stride = stride;
  a.ch = static_cast<const float*>(ch);
  a.out = static_cast<float*>(out);
  a.K = K;
  a.F = F;
  a.B = B;
  a.bf16 = bf16;
  a.scale = static_cast<const double*>(scale);
  a.acc = static_cast<unsigned long long*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_wide<true>(a, s);
  if (e != 0) return e;
  return det_finish(a.acc, a.scale, a.out, (long long)F * B, K, K, s);
}
