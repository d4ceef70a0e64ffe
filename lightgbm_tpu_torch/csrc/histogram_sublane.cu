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
// register tiles and contracts it on the MXU. Here the sum is a scatter into
// shared memory. What bounds it on the H100: the least time is that of the
// bytes, n F (bins) + 4 n K (channels), read once; every (live row,
// feature) costs K read-modify-writes of a shared-memory cell, and f32
// atomicAdd on shared memory is a compare-and-swap loop on sm_90
// (ATOMS.CAST.SPIN in the SASS), so the instructions and the latency of
// those read-modify-writes bind it. The design:
//   * work items are warp-sized: (tile of 4A rows, range of rotation steps)
//     of a feature chunk (grid.y; at most 32 features a chunk, fc). Lane
//     l < A owns four consecutive rows of the tile, holds their channels in
//     registers (4 K floats) and reads their four bins of a feature as one
//     32-bit word from the warp's stage in shared memory (feature f at
//     stage row f, word l: bank l);
//   * feature rotation: cells are laid out [bin][channel][column] with 32
//     columns, so a cell's bank is its column. Lane l is replica r = l / fc
//     of base feature l % fc; at step j it adds feature f = (l + j) mod fc
//     into column r fc + f. The active lanes of a warp sit on different
//     columns at every step whatever their bins: no bank conflict and no two
//     lanes on one cell, so a skewed feature (zero-heavy, a missing-value
//     bin) costs what a uniform one does. Small chunks keep the lanes busy
//     through the replicas (fc = 5: five replicas). A is the replicas'
//     lanes rounded down to a multiple of 4 (28 at fc = 28);
//   * a lane's four rows that share a bin of the feature are merged in
//     registers first, so its (at most four) cells of a step are distinct;
//   * private histogram copies: one a warp (B <= 64 makes a copy small:
//     B K 32 x 4 B, 24 KB at B = 64, K = 3). The read-modify-write is then a
//     plain load, add and store, no atomic: no other lane of the warp
//     writes the column at that step, and a __syncwarp between steps orders
//     the steps. Each access is predicated: a row that adds nothing touches
//     no bank. Copies shared by two to eight warps through shared-memory
//     atomics ran slower at the probe at every block size tried (PERF.md);
//     the host sizes the block to the copies that fit and lays out the
//     shared memory (sublane_geometry in ops/pallas_histogram.py), and the
//     C entry checks that layout. At the end of the block the copies (and the
//     replicas' columns) are summed and go out with one global atomicAdd a
//     non-zero cell;
//   * loads run ahead of the adds: the channels two items ahead, the bins
//     one item ahead, both into registers; the bins as 16-byte pieces (16
//     rows of one feature) spread over the lanes, stored into the stage at
//     the start of the item. A piece whose 16 rows have no live row is
//     neither loaded nor stored. (One 4-byte load a (lane, feature) moved
//     the same bytes more slowly, PERF.md.) Registers, not a second
//     shared-memory stage filled by cp.async or TMA: that stage does not
//     fit beside seven private copies and the pending tile;
//   * sparse inputs: the masked grower zeroes the channels of every row
//     outside the leaf it builds, so a deep split's histogram has few live
//     rows (a non-zero channel), spread over the whole range. An item
//     whose live rows fill at most 3/4 of a tile moves them (bins and
//     channels) into a pending tile in shared memory instead; the warp adds
//     the pending tile once it is full and at the end. The adds then follow
//     the live rows, not n; an item with no live row adds nothing;
//   * the grid is sized by the host: an item covers fewer rotation steps
//     when the tiles alone would leave warp slots of the card idle; such
//     items are not compacted;
//   * small inputs (up to the host's threshold, 262,144 rows) take a
//     lighter path, hist_sublane_small_kernel below: a launch there is
//     bound by fixed costs (zeroing and summing seven copies, a global
//     atomic a cell a block), which its single shared histogram a block
//     keeps low. The masked grower's 20k rows take it.
//
// The int8 mode (the TPU kernel's int8 mode, pallas_histogram.py:202-203,
// :316; is_int): the channels are int32 codes and every cell is an int32
// sum, on both paths, through the same 32-bit shared-memory accesses (a
// bit copy) with integer adds, and integer global atomics at the end; the
// result equals the plain version's exactly, whatever the order. With
// `cnt` (a device int32) the rows read are [0, min(*cnt, n)): the compact
// grower without the fused kernel hands K3 a feature-major copy of a
// segment whose count stays on the device (csrc/segment_gather.cu), the
// geometry being that of the whole array.
//
// The deterministic mode (deterministic=True; lgbt_hist_sublane_det, f32
// channels): the result is fixed by the inputs on both paths. On the tile
// path a block's sum is already fixed (each warp adds its statically
// assigned rows into its own copy in program order, and the copies and
// replicas are summed in a fixed order); only the global atomics across
// blocks are not, so each block's non-zero cell goes out as an int64
// q = rint(v * scale[k]) with an integer atomic into an int64 [F, B, K]
// array. On the small-data path the 8 warps of a block share one histogram
// through shared-memory atomics, so there each addend is converted and the
// shared cells are int64 ([fc][B][K | 1] x 8 B: the host halves the feature
// chunk to fit its budget), flushed the same way. A finishing launch writes
// each sum as (float)((double)sum / scale[k]). Integer sums do not depend
// on their order. The scale is a power of two a channel, chosen by the
// caller so that rows x max |v| x scale < 2^62 (ops/determinism.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "det_finish.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRowsPerLane = 4;       // one 32-bit word of bins a feature
constexpr int kCols = 32;             // histogram columns: one per bank
constexpr int kStageRow = 128;        // bytes of a feature in a stage
constexpr int kPieces = 8;            // 16-byte pieces of a tile a lane
constexpr int kMaxB = 64;
constexpr int kMaxK = 8;
// the most dynamic shared memory a block may use on the H100 (227 KB)
constexpr int kSmemLimit = 232448;

// active lanes of a chunk of fcc features: whole replicas of the chunk,
// rounded down to a multiple of 4
__host__ __device__ inline int active_lanes(int fcc) {
  const int reps = kCols / fcc;
  const int a = reps * fcc < 32 ? reps * fcc : 32;
  return a & ~3;
}

// the most active lanes over the chunks (the last one may be narrower)
inline int max_active_lanes(int F, int fc) {
  const int chunks = (F + fc - 1) / fc;
  const int a = active_lanes(fc);
  const int b = active_lanes(F - (chunks - 1) * fc);
  return a > b ? a : b;
}

struct Args {
  const uint8_t* bins;
  long long ld;
  const void* ch;     // [n, K] f32, or int32 codes (the int8 mode)
  long long n;
  void* out;          // [F, B, K] f32, or int32
  const int* cnt;     // a device count bounding the rows read, or null
  const double* scale;         // DET: the channels' fixed-point scales
  unsigned long long* acc;     // DET: int64 [F, B, K] sums
  int F, B, bf16, ch_vec;
  int fc, warps, group;
  int warp_bytes;     // a warp's stage, pending tile and pending channels
};

// Shared-memory accesses on 32-bit shared addresses, predicated: a row that
// adds nothing touches no bank. asm volatile keeps them in program order.
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float lds_if(uint32_t addr, bool p) {
  float v = 0.f;
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
               "@q ld.shared.f32 %0, [%1];\n}\n"
               : "+f"(v) : "r"(addr), "r"((int)p) : "memory");
  return v;
}
__device__ __forceinline__ void sts_if(uint32_t addr, float v, bool p) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
               "@q st.shared.f32 [%0], %1;\n}\n"
               :: "r"(addr), "f"(v), "r"((int)p) : "memory");
}
// The channel and cell type T (float, or int in the int8 mode) through the
// 32-bit shared-memory accesses above: a bit copy either way.
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t v) {
  if constexpr (std::is_same<T, int>::value) {
    return (int)v;
  } else {
    return __uint_as_float(v);
  }
}
template <typename T>
__device__ __forceinline__ T lds_t(uint32_t addr, bool p) {
  return from_bits<T>(__float_as_uint(lds_if(addr, p)));
}
template <typename T>
__device__ __forceinline__ void sts_t(uint32_t addr, T v, bool p) {
  if constexpr (std::is_same<T, int>::value) {
    sts_if(addr, __int_as_float(v), p);
  } else {
    sts_if(addr, v, p);
  }
}
__device__ __forceinline__ void sts_u8_if(uint32_t addr, uint32_t v, bool p) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
               "@q st.shared.u8 [%0], %1;\n}\n"
               :: "r"(addr), "r"(v), "r"((int)p) : "memory");
}

// An item's bins: the tile's [fcc][4 na] bytes as 16-byte pieces, piece
// q = lane + 32 t (feature q / (na / 4), rows 16 (q % (na / 4)) on) in
// v[t], at most 8 a lane; only the pieces whose four lanes hold a live row
// (bit 4 p .. 4 p + 3 of lanes_live). VEC: the bins' base and row stride
// are multiples of 16 bytes; else, and for the piece holding row n, byte
// loads (rows past n read 0).
template <bool VEC>
__device__ __forceinline__ void load_bins(const Args& a, int f0, int fcc,
                                          int na, long long row0, int lane,
                                          uint32_t lanes_live, uint4* v) {
  const int per_f = na / 4;
#pragma unroll
  for (int t = 0; t < kPieces; ++t) {
    const int q = lane + 32 * t;
    const int f = q / per_f;
    const int piece = q - f * per_f;
    if (q < fcc * per_f && ((lanes_live >> (4 * piece)) & 0xFu)) {
      const long long r = row0 + 16 * piece;
      const uint8_t* p = a.bins + (long long)(f0 + f) * a.ld + r;
      if (VEC && r + 16 <= a.n) {
        v[t] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int s = 0; s < 16 && r + s < a.n; ++s) {
          w[s >> 2] |= (uint32_t)__ldg(p + s) << (8 * (s & 3));
        }
        v[t] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// The loaded pieces into the warp's stage: feature f at stage row f.
__device__ __forceinline__ void store_bins(uint32_t stage, int fcc, int na,
                                           int lane, uint32_t lanes_live,
                                           const uint4* v) {
  const int per_f = na / 4;
#pragma unroll
  for (int t = 0; t < kPieces; ++t) {
    const int q = lane + 32 * t;
    const int f = q / per_f;
    const int piece = q - f * per_f;
    if (q < fcc * per_f && ((lanes_live >> (4 * piece)) & 0xFu)) {
      const uint32_t addr = stage + f * kStageRow + 16 * piece;
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(addr), "r"(v[t].x), "r"(v[t].y), "r"(v[t].z),
                      "r"(v[t].w) : "memory");
    }
  }
}

// The lane's four rows of channels (zero past n and on idle lanes),
// bf16-rounded in bf16 mode.
template <int K, typename T>
__device__ __forceinline__ void load_channels(const Args& a, long long row,
                                              bool on, T* c) {
  const T* cp = static_cast<const T*>(a.ch) + row * K;
  if (on && a.ch_vec && row + kRowsPerLane <= a.n) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(cp) + q);
      c[4 * q] = from_bits<T>(v.x);
      c[4 * q + 1] = from_bits<T>(v.y);
      c[4 * q + 2] = from_bits<T>(v.z);
      c[4 * q + 3] = from_bits<T>(v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerLane * K; ++i) {
      c[i] = on && row + i / K < a.n ? __ldg(cp + i) : T(0);
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    if (a.bf16) {
#pragma unroll
      for (int i = 0; i < kRowsPerLane * K; ++i) {
        c[i] = __bfloat162float(__float2bfloat16_rn(c[i]));
      }
    }
  }
}

template <int K, typename T>
__device__ __forceinline__ uint32_t live_rows(const T* c) {
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < K; ++k) any |= c[i * K + k] != T(0);
    live |= (uint32_t)any << i;
  }
  return live;
}

// One rotation step of a lane: its four rows' bins of the feature in
// column `col` (word w) into the histogram copy at shared address hb. Rows
// of one bin are merged into the first of them; a row adds where it is the
// first of its bin, the bin is < B and some row of the bin is live.
template <int K, typename T>
__device__ __forceinline__ void add_step(uint32_t hb, int col, uint32_t w,
                                         const T* c, uint32_t live,
                                         bool act, int B) {
  int b[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) b[i] = (w >> (8 * i)) & 0xFF;
  const bool e01 = b[0] == b[1], e02 = b[0] == b[2], e03 = b[0] == b[3];
  const bool e12 = b[1] == b[2], e13 = b[1] == b[3], e23 = b[2] == b[3];
  const bool l0 = live & 1u, l1 = live & 2u, l2 = live & 4u, l3 = live & 8u;
  bool v[kRowsPerLane];
  v[0] = act && b[0] < B && (l0 || (e01 && l1) || (e02 && l2) || (e03 && l3));
  v[1] = act && b[1] < B && !e01 && (l1 || (e12 && l2) || (e13 && l3));
  v[2] = act && b[2] < B && !e02 && !e12 && (l2 || (e23 && l3));
  v[3] = act && b[3] < B && !e03 && !e13 && !e23 && l3;
  T sum[kRowsPerLane * K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s0 = c[k], s1 = c[K + k], s2 = c[2 * K + k];
    if (e01) s0 += c[K + k];
    if (e02) s0 += c[2 * K + k];
    if (e03) s0 += c[3 * K + k];
    if (e12) s1 += c[2 * K + k];
    if (e13) s1 += c[3 * K + k];
    if (e23) s2 += c[3 * K + k];
    sum[k] = s0;
    sum[K + k] = s1;
    sum[2 * K + k] = s2;
    sum[3 * K + k] = c[3 * K + k];
  }
  uint32_t addr[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    addr[i] = hb + (uint32_t)((b[i] * K * kCols + col) * 4);
  }
  // the valid rows' cells are distinct, and no other lane of the warp
  // writes this column at this step: loads, adds, stores
  T old[kRowsPerLane * K];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      old[i * K + k] = lds_t<T>(addr[i] + k * kCols * 4, v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sts_t<T>(addr[i] + k * kCols * 4, old[i * K + k] + sum[i * K + k],
               v[i]);
    }
  }
}

// Rotation steps [j0, j1) of a tile whose bins sit in the stage at `stage`.
template <int K, typename T>
__device__ __forceinline__ void add_tile(uint32_t hb, uint32_t stage,
                                         const T* c, uint32_t live,
                                         bool act, int base, int col0,
                                         int fcc, int j0, int j1, int B,
                                         int lane) {
  const uint32_t sw = stage + 4 * lane;  // the lane's word of feature 0
  int f = base + j0;
  if (f >= fcc) f -= fcc;
  uint32_t w = lds_u32(sw + f * kStageRow);
  for (int j = j0; j < j1; ++j) {
    const int col = col0 + f;
    f = f + 1 == fcc ? 0 : f + 1;
    // the next step's word, read before this step's adds
    const uint32_t w_next = lds_u32(sw + f * kStageRow);
    add_step<K, T>(hb, col, w, c, live, act, B);
    __syncwarp();               // this step's cells before the next step's
    w = w_next;
  }
}

// Add the pending tile (its first p rows live) and leave it empty.
template <int K, typename T>
__device__ __forceinline__ void add_pending(uint32_t hb, uint32_t pend,
                                            uint32_t pend_ch, int p, bool act,
                                            int base, int col0, int fcc,
                                            int B, int lane) {
  __syncwarp();
  T c[kRowsPerLane * K];
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int q = kRowsPerLane * lane + i;
    const bool on = act && q < p;
    live |= (uint32_t)on << i;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[i * K + k] = lds_t<T>(pend_ch + (q * K + k) * 4, on);
    }
  }
  add_tile<K, T>(hb, pend, c, live, act, base, col0, fcc, 0, fcc, B,
                 lane);
  __syncwarp();
}

// the rows a launch reads: n, or the device count clamped to [0, n]
__device__ __forceinline__ Args bounded(const Args& a0) {
  Args a = a0;
  if (a0.cnt) a.n = min(max((long long)*a0.cnt, 0LL), a0.n);
  return a;
}

template <bool VEC, int K, typename T, bool DET = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
hist_sublane_kernel(const Args a0) {
  const Args a = bounded(a0);
  extern __shared__ __align__(16) float smem[];
  const int B = a.B;
  const int f0 = blockIdx.y * a.fc;
  const int fcc = min(a.fc, a.F - f0);
  const int na = active_lanes(fcc);           // active lanes
  const int cap = kRowsPerLane * na;          // rows of a tile
  const int reps = (na + fcc - 1) / fcc;      // replicas in use
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int threads = a.warps * 32;
  const int copy_cells = B * K * kCols;       // [bin][channel][column]

  const uint32_t smem_addr = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t hb = smem_addr + (uint32_t)(warp * copy_cells * 4);
  const uint32_t stage = smem_addr + a.warps * copy_cells * 4
      + (uint32_t)(warp * a.warp_bytes);
  const uint32_t pend = stage + a.fc * kStageRow;
  const uint32_t pend_ch = pend + a.fc * kStageRow;
  float4* z = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < a.warps * copy_cells / 4; i += threads) {
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const bool act = lane < na;
  const int rep = lane / fcc;
  const int base = lane - rep * fcc;
  const int col0 = rep * fcc;
  const long long tiles = (a.n + cap - 1) / cap;
  const int n_groups = (fcc + a.group - 1) / a.group;
  const long long items = tiles * n_groups;
  const long long stride = (long long)gridDim.x * a.warps;
  const uint32_t lt_mask = (1u << lane) - 1u;

  // Each lane's rows of an item come in three stages: channels two items
  // ahead, bins one item ahead (only the 16-row pieces with a live row: the
  // channels say which), the current item in the stage and registers.
  long long item = (long long)blockIdx.x * a.warps + warp;
  uint4 bn[kPieces];
  T c[kRowsPerLane * K], cn[kRowsPerLane * K], cnn[kRowsPerLane * K];
  uint32_t lanes_cur = 0, lanes_next = 0;
  auto row_of = [&](long long it) {
    return (it / n_groups) * cap + kRowsPerLane * lane;
  };
  if (item < items) {
    load_channels<K, T>(a, row_of(item), act, cn);
    lanes_next = __ballot_sync(0xffffffffu, live_rows<K, T>(cn) != 0);
    load_bins<VEC>(a, f0, fcc, na, row_of(item) - kRowsPerLane * lane, lane,
                   lanes_next, bn);
  }
  if (item + stride < items) {
    load_channels<K, T>(a, row_of(item + stride), act, cnn);
  }
  int p = 0;                                  // rows in the pending tile
  for (; item < items; item += stride) {
    __syncwarp();                             // the stage's readers are done
    lanes_cur = lanes_next;
    store_bins(stage, fcc, na, lane, lanes_cur, bn);
#pragma unroll
    for (int i = 0; i < kRowsPerLane * K; ++i) {
      c[i] = cn[i];
      cn[i] = cnn[i];
    }
    const long long next = item + stride;
    if (next + stride < items) {
      load_channels<K, T>(a, row_of(next + stride), act, cnn);
    }
    if (next < items) {
      lanes_next = __ballot_sync(0xffffffffu, live_rows<K, T>(cn) != 0);
      load_bins<VEC>(a, f0, fcc, na, row_of(next) - kRowsPerLane * lane,
                     lane, lanes_next, bn);
    }
    __syncwarp();

    const uint32_t live = live_rows<K, T>(c);
    uint32_t m[kRowsPerLane];
    int cnt = 0, before = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      m[i] = __ballot_sync(0xffffffffu, (live >> i) & 1u);
      cnt += __popc(m[i]);
      before += __popc(m[i] & lt_mask);
    }
    if (cnt == 0) continue;
    if (n_groups > 1 || 4 * cnt > 3 * cap) {
      const int g = (int)(item % n_groups);
      const int j0 = g * a.group;
      add_tile<K, T>(hb, stage, c, live, act, base, col0, fcc, j0,
                     min(fcc, j0 + a.group), B, lane);
      continue;
    }
    if (p + cnt > cap) {
      add_pending<K, T>(hb, pend, pend_ch, p, act, base, col0, fcc, B, lane);
      p = 0;
    }
    // the live rows into the pending tile, at p + (live rows of the lanes
    // before) + (the lane's live rows before)
    int q[kRowsPerLane];
    int own = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      q[i] = p + before + own;
      own += (live >> i) & 1u;
    }
    for (int f = 0; f < fcc; ++f) {
      const uint32_t w = lds_u32(stage + f * kStageRow + 4 * lane);
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        sts_u8_if(pend + f * kStageRow + q[i], (w >> (8 * i)) & 0xFF,
                  (live >> i) & 1u);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sts_t<T>(pend_ch + (q[i] * K + k) * 4, c[i * K + k],
                 (live >> i) & 1u);
      }
    }
    p += cnt;
  }
  if (p > 0) {
    add_pending<K, T>(hb, pend, pend_ch, p, act, base, col0, fcc, B, lane);
  }
  __syncthreads();

  // copies and replicas summed, the copies' loads in flight together; one
  // global atomic a non-zero cell. Cell i = (bin K + k) 32 + col, so the
  // output index is (f0 + col) B K + i / 32.
  for (int i = threadIdx.x; i < copy_cells; i += threads) {
    const int col = i & (kCols - 1);
    if (col >= fcc) continue;
    T part[kMaxWarps];
#pragma unroll
    for (int cp = 0; cp < kMaxWarps; ++cp) {
      part[cp] = T(0);
      if (cp < a.warps) {
        const T* h = reinterpret_cast<const T*>(smem) + cp * copy_cells + i;
        part[cp] = h[0];
        for (int r = 1; r < reps; ++r) part[cp] += h[r * fcc];
      }
    }
    T v = T(0);
#pragma unroll
    for (int cp = 0; cp < kMaxWarps; ++cp) v += part[cp];
    if (v != T(0)) {
      const long long o = (long long)(f0 + col) * B * K + (i >> 5);
      if constexpr (DET) {
        // the block's fixed sum in fixed point; (i >> 5) % K is its channel
        atomicAdd(a.acc + o, (unsigned long long)__double2ll_rn(
                                 (double)v * a.scale[(i >> 5) % K]));
      } else {
        atomicAdd(static_cast<T*>(a.out) + o, v);
      }
    }
  }
}

// The small-data path (n <= the host's threshold, PERF.md): a launch there
// is bound by its fixed costs (zeroing and summing the private copies, one
// global atomic a cell a block), so it takes the lighter design of the
// first version of this kernel: one histogram a block at an odd bin stride
// ([fc][B][K | 1]), shared by its 8 warps through shared-memory atomics;
// work items of (256-row tile, group of features), each lane holding its
// 8 rows' channels in registers and reading their bins of a feature as one
// 8-byte load; rows with all-zero channels skipped; at the end one global
// atomic a non-zero cell. VEC: bins' base and row stride on 8 bytes.
constexpr int kSmallThreads = 256;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallRows = 8;                       // rows a lane
constexpr int kSmallTile = 32 * kSmallRows;         // 256 rows

template <bool VEC, int K, typename T, bool DET = false>
__global__ void __launch_bounds__(kSmallThreads)
hist_sublane_small_kernel(const Args a0) {
  const Args a = bounded(a0);
  constexpr int KS = K | 1;  // odd bin stride
  // DET: int64 fixed-point cells
  using Cell = typename std::conditional<DET, unsigned long long, T>::type;
  extern __shared__ __align__(16) float hist_raw[];
  Cell* hist = reinterpret_cast<Cell*>(hist_raw);  // [fc][B][KS]
  const int B = a.B;
  const int f0 = blockIdx.y * a.fc;
  const int fc = min(a.fc, a.F - f0);
  for (int i = threadIdx.x; i < fc * B * KS; i += kSmallThreads) {
    hist[i] = Cell(0);
  }
  double sc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sc[k] = DET ? a.scale[k] : 1.0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = a.n;
  const long long n_tiles = (n + kSmallTile - 1) / kSmallTile;
  const int n_groups = (fc + a.group - 1) / a.group;
  const long long items = n_tiles * n_groups;
  for (long long item = (long long)blockIdx.x * kSmallWarps + warp;
       item < items; item += (long long)gridDim.x * kSmallWarps) {
    const int grp = (int)(item % n_groups);
    const long long row_g = (item / n_groups) * kSmallTile
                            + lane * kSmallRows;
    T c[kSmallRows * K];
    const T* cp = static_cast<const T*>(a.ch) + row_g * K;
    if (a.ch_vec && row_g + kSmallRows <= n) {
#pragma unroll
      for (int q = 0; q < kSmallRows * K / 4; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(cp) + q);
        c[4 * q] = from_bits<T>(v.x);
        c[4 * q + 1] = from_bits<T>(v.y);
        c[4 * q + 2] = from_bits<T>(v.z);
        c[4 * q + 3] = from_bits<T>(v.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSmallRows * K; ++i) {
        c[i] = row_g + i / K < n ? __ldg(cp + i) : T(0);
      }
    }
    uint32_t live = 0;
#pragma unroll
    for (int j = 0; j < kSmallRows; ++j) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if constexpr (std::is_same<T, float>::value) {
          if (a.bf16) {
            c[j * K + k] =
                __bfloat162float(__float2bfloat16_rn(c[j * K + k]));
          }
        }
        any |= c[j * K + k] != T(0);
      }
      live |= (uint32_t)any << j;
    }
    if (live == 0) continue;
    const int f_end = min(fc, (grp + 1) * a.group);
    for (int f = grp * a.group; f < f_end; ++f) {
      const uint8_t* p = a.bins + (long long)(f0 + f) * a.ld + row_g;
      uint32_t w[kSmallRows / 4];
      if (VEC && row_g + kSmallRows <= n) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = v.x;
        w[1] = v.y;
      } else {
        // ragged tail or unaligned rows: byte loads; rows past n read as
        // bin 255, which every B <= 64 drops
#pragma unroll
        for (int q = 0; q < kSmallRows / 4; ++q) {
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
      Cell* hf = hist + f * B * KS;
#pragma unroll
      for (int j = 0; j < kSmallRows; ++j) {
        const int b = (w[j >> 2] >> ((j & 3) * 8)) & 0xFF;
        if (!((live >> j) & 1u) || b >= B) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if constexpr (DET) {
            atomicAdd(hf + b * KS + k, (unsigned long long)__double2ll_rn(
                                           (double)c[j * K + k] * sc[k]));
          } else {
            atomicAdd(hf + b * KS + k, c[j * K + k]);
          }
        }
      }
    }
  }
  __syncthreads();
  const long long o0 = (long long)f0 * B * K;
  for (int i = threadIdx.x; i < fc * B * K; i += kSmallThreads) {
    const int cell = i / K;  // f * B + b
    const Cell v = hist[cell * KS + (i - cell * K)];
    if (v == Cell(0)) continue;
    if constexpr (DET) {
      atomicAdd(a.acc + o0 + i, v);
    } else {
      atomicAdd(static_cast<T*>(a.out) + o0 + i, v);
    }
  }
}

template <auto kern>
int launch(const Args& a, int threads, int gx, int chunks, int smem,
           cudaStream_t stream) {
  static bool smem_set = false;   // one flag a kernel
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  kern<<<dim3(gx, chunks), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool VEC, int K, typename T, bool DET = false>
int launch_k(const Args& a, bool small, int gx, int chunks, int smem,
             cudaStream_t s) {
  if (small) {
    return launch<hist_sublane_small_kernel<VEC, K, T, DET>>(
        a, kSmallThreads, gx, chunks, smem, s);
  }
  return launch<hist_sublane_kernel<VEC, K, T, DET>>(a, a.warps * 32, gx,
                                                     chunks, smem, s);
}

template <bool VEC, typename T, bool DET = false>
int dispatch(const Args& a, int K, bool small, int gx, int chunks, int smem,
             cudaStream_t s) {
  switch (K) {
    case 1: return launch_k<VEC, 1, T, DET>(a, small, gx, chunks, smem, s);
    case 2: return launch_k<VEC, 2, T, DET>(a, small, gx, chunks, smem, s);
    case 3: return launch_k<VEC, 3, T, DET>(a, small, gx, chunks, smem, s);
    case 4: return launch_k<VEC, 4, T, DET>(a, small, gx, chunks, smem, s);
    case 5: return launch_k<VEC, 5, T, DET>(a, small, gx, chunks, smem, s);
    case 6: return launch_k<VEC, 6, T, DET>(a, small, gx, chunks, smem, s);
    case 7: return launch_k<VEC, 7, T, DET>(a, small, gx, chunks, smem, s);
    case 8: return launch_k<VEC, 8, T, DET>(a, small, gx, chunks, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The checks and Args of both entries below; returns 0 or an error code.
int make_args(Args& a, const void* bins_t, long long ld, const void* ch,
              int K, long long n, int F, int B, int bf16, void* out,
              int small, int fc, int warps, int group, int grid_x, int smem,
              int warp_bytes, const void* cnt, int cell_bytes) {
  if (F <= 0 || B <= 0 || B > kMaxB || K <= 0 || K > kMaxK || n < 0
      || fc < 1 || warps < 1 || warps > kMaxWarps || group < 1
      || grid_x < 1 || (small ? warps != kSmallWarps : fc > kCols)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long need =
      small ? (long long)fc * B * (K | 1) * cell_bytes
            : warps * ((long long)B * K * kCols * 4 + warp_bytes);
  if (smem > kSmemLimit || smem < need
      || (!small && (warp_bytes % 16 != 0
                     || warp_bytes < 2LL * fc * kStageRow
                                     + 16LL * K * max_active_lanes(F, fc)))) {
    return (int)cudaErrorInvalidValue;
  }
  a = Args{};
  a.bins = static_cast<const uint8_t*>(bins_t);
  a.ld = ld;
  a.ch = ch;
  a.n = n;
  a.out = out;
  a.cnt = static_cast<const int*>(cnt);
  a.F = F;
  a.B = B;
  a.bf16 = bf16;
  a.ch_vec = (reinterpret_cast<uintptr_t>(ch) & 15) == 0;
  a.fc = fc;
  a.warps = warps;
  a.group = group;
  a.warp_bytes = warp_bytes;
  return 0;
}

bool vec_bins(const void* bins_t, long long ld, bool small) {
  const uintptr_t align = small ? 7 : 15;
  return (reinterpret_cast<uintptr_t>(bins_t) & align) == 0
         && (ld & (long long)align) == 0;
}

}  // namespace

// bins_t [F, n] u8 with row stride `ld` bytes (unit stride along rows),
// channels [n, K] f32 contiguous, out [F, B, K] f32 zeroed by the caller.
// The launch geometry and the shared-memory layout come from the host
// (sublane_geometry in ops/pallas_histogram.py): `small` picks the
// small-data path (8 warps a block); fc features a chunk (<= 32 on the tile
// path; grid.y is ceil(F / fc)), `warps` warps a block on the tile path (a
// private copy each), `group` rotation steps (small path: features) a work
// item, grid_x blocks a chunk; `smem` bytes a block, on the tile path the
// copies and then `warp_bytes` a warp. Here they are only checked against
// the block's limit and the bytes the kernel addresses.
extern "C" int lgbt_hist_sublane(const void* bins_t, long long ld,
                                 const void* ch, int K, long long n, int F,
                                 int B, int bf16, void* out, int small,
                                 int fc, int warps, int group, int grid_x,
                                 int smem, int warp_bytes, int is_int,
                                 const void* cnt, void* stream) {
  Args a;
  const int e = make_args(a, bins_t, ld, ch, K, n, F, B, bf16, out, small,
                          fc, warps, group, grid_x, smem, warp_bytes, cnt, 4);
  if (e != 0) return e;
  if (n == 0) return (int)cudaSuccess;
  const int chunks = (F + fc - 1) / fc;
  const bool vec = vec_bins(bins_t, ld, small);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int) {
    return vec ? dispatch<true, int>(a, K, small, grid_x, chunks, smem, s)
               : dispatch<false, int>(a, K, small, grid_x, chunks, smem, s);
  }
  return vec ? dispatch<true, float>(a, K, small, grid_x, chunks, smem, s)
             : dispatch<false, float>(a, K, small, grid_x, chunks, smem, s);
}

// The deterministic mode of the f32 entry above (the header note): the
// same arguments (the small path's `smem` sized for 8-byte cells), then
// `scale` (float64 [K]) and `acc`, int64 [F, B, K] zeroed by the caller.
extern "C" int lgbt_hist_sublane_det(const void* bins_t, long long ld,
                                     const void* ch, int K, long long n,
                                     int F, int B, int bf16, void* out,
                                     int small, int fc, int warps, int group,
                                     int grid_x, int smem, int warp_bytes,
                                     const void* cnt, const void* scale,
                                     void* acc, void* stream) {
  Args a;
  const int e = make_args(a, bins_t, ld, ch, K, n, F, B, bf16, out, small,
                          fc, warps, group, grid_x, smem, warp_bytes, cnt, 8);
  if (e != 0) return e;
  a.scale = static_cast<const double*>(scale);
  a.acc = static_cast<unsigned long long*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int chunks = (F + fc - 1) / fc;
    const int r = vec_bins(bins_t, ld, small)
        ? dispatch<true, float, true>(a, K, small, grid_x, chunks, smem, s)
        : dispatch<false, float, true>(a, K, small, grid_x, chunks, smem, s);
    if (r != 0) return r;
  }
  return det_finish(a.acc, a.scale, static_cast<float*>(out),
                    (long long)F * B, K, K, s);
}
