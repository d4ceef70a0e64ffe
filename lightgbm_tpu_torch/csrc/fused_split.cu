// K2: the partition half of one leaf split, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/fused_split.py::_fused_kernel
// (wrapper fused_split). The TPU kernel is ONE sequential walk over the
// parent's segment; on Hopper the same work is a short chain of launches,
// as in LightGBM's cuda_data_partition.cu:
//
//   prep      one thread sanitizes the split scalars (device int32 vector
//             `sp`) into a workspace: start within the array, count within
//             n_rows - start, n_left <= count, and the smaller child's
//             range for the histogram;
//   count     every block evaluates the routing predicate (go_left_pred of
//             ops/split.py) over its contiguous share of the segment and
//             writes its left-row count;
//   scatter   every block sums the counts of the blocks before it (its
//             exclusive offset), ranks its rows stably with warp ballots and
//             a scan across the warps, and copies whole 128-byte records as
//             16-byte vectors into the OTHER residency array: left rows to
//             [start, start + n_left), right rows to [start + n_left,
//             start + count);
//   copyback  the left child is copied back into the parent's own array.
//
// The histogram of the smaller child is K1 (csrc/histogram.cu) in record
// mode over that child's now contiguous range of the other array, launched
// by the Python wrapper after this chain; in mode 1 only `prep` runs here
// and K1 covers the whole segment.
//
// Dual residency races on a GPU: the TPU kernel writes left rows in place,
// safe because its single walk cannot let the left write cursor overtake
// the read cursor. Blocks here run in no order, so a block's left rows
// would land below its own read range, where an earlier block may not have
// read yet. Writing every row to the other array (whose [start, start +
// count) range is dead, ops/fused_split.py module docstring) removes the
// race; the copy-back keeps the TPU's public contract: left child in
// `side`, right child in `1 - side`, same offsets and order, rows outside
// the segment untouched.
//
// No host sync: the segment scalars come from the device, the grid is fixed
// (n_blocks blocks share the count read on the device), and a zero count is
// a no-op.
//
// What bounds it on the H100: bytes. Each parent-segment record is read
// once and written once (2 * count * C bytes), the left child is copied
// once more (2 * n_left * C), and the routing column is read twice (a byte
// per row, from the same 128-byte lines). Record copies are 16-byte
// vector loads and stores, coalesced across the 8 (C = 128) threads that
// move one record. In the whole fused split the smaller child's histogram
// (K1, bound by its shared-memory atomics) takes most of the time
// (chip_smoke.py, PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// sp: the wrapper's split scalars (int32, device)
enum { SP_START, SP_COUNT, SP_NLEFT, SP_FEAT, SP_BIN, SP_DLEFT, SP_NANBIN,
       SP_ISCAT, SP_SMALLER, SP_SIDE, SP_LEN };
// ws: sanitized scalars written by prep_kernel (int32, device); the three
// HIST entries are the segment vector K1 reads in record mode
enum { WS_START, WS_COUNT, WS_NLEFT, WS_HSTART, WS_HCOUNT, WS_HSEL, WS_SIDE,
       WS_FEAT, WS_BIN, WS_DLEFT, WS_NANBIN, WS_ISCAT, WS_LEN };

__global__ void prep_kernel(const int* sp, int mode, int n_rows, int F,
                            int* ws) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int start = min(max(sp[SP_START], 0), n_rows);
  const int count = min(max(sp[SP_COUNT], 0), n_rows - start);
  const int n_left = min(max(sp[SP_NLEFT], 0), count);
  const int side = sp[SP_SIDE] != 0 ? 1 : 0;
  ws[WS_START] = start;
  ws[WS_COUNT] = count;
  ws[WS_NLEFT] = n_left;
  ws[WS_SIDE] = side;
  ws[WS_FEAT] = min(max(sp[SP_FEAT], 0), F - 1);
  ws[WS_BIN] = sp[SP_BIN];
  ws[WS_DLEFT] = sp[SP_DLEFT] != 0 ? 1 : 0;
  ws[WS_NANBIN] = sp[SP_NANBIN];
  ws[WS_ISCAT] = sp[SP_ISCAT] != 0 ? 1 : 0;
  if (mode == 1) {
    ws[WS_HSTART] = start;
    ws[WS_HCOUNT] = count;
    ws[WS_HSEL] = side;
  } else {
    const int smaller = sp[SP_SMALLER] < 0 ? (n_left <= count - n_left)
                                           : (sp[SP_SMALLER] != 0);
    ws[WS_HSTART] = smaller ? start : start + n_left;
    ws[WS_HCOUNT] = smaller ? n_left : count - n_left;
    ws[WS_HSEL] = 1 - side;  // both children now live in the other array
  }
}

struct Split {
  int start, count, n_left, side, feat, bin, dleft, nanbin, iscat;
};

__device__ __forceinline__ Split load_split(const int* ws) {
  Split s;
  s.start = ws[WS_START];
  s.count = ws[WS_COUNT];
  s.n_left = ws[WS_NLEFT];
  s.side = ws[WS_SIDE];
  s.feat = ws[WS_FEAT];
  s.bin = ws[WS_BIN];
  s.dleft = ws[WS_DLEFT];
  s.nanbin = ws[WS_NANBIN];
  s.iscat = ws[WS_ISCAT];
  return s;
}

// the routing predicate, mirroring ops/split.py go_left_pred
__device__ __forceinline__ bool go_left(int col, const Split& s,
                                        const uint32_t* bits, int W) {
  if (s.iscat) {
    const int w = col >> 5;
    return w < W && ((bits[w] >> (col & 31)) & 1u) != 0;
  }
  return col <= s.bin || (s.dleft && col == s.nanbin);
}

__device__ __forceinline__ void chunk_of(const Split& s, int& b0, int& b1) {
  const int g = (int)gridDim.x;
  const int per = (s.count + g - 1) / g;
  b0 = min(s.count, (int)blockIdx.x * per);
  b1 = min(s.count, b0 + per);
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* work, const uint8_t* scratch, long long C,
             const int* ws, const uint32_t* bits, int W, int* block_left) {
  __shared__ int red[kWarps];
  const Split s = load_split(ws);
  const uint8_t* src = s.side ? scratch : work;
  int b0, b1;
  chunk_of(s, b0, b1);
  int mine = 0;
  for (int r = b0 + threadIdx.x; r < b1; r += kThreads) {
    const int col = src[(long long)(s.start + r) * C + s.feat];
    mine += go_left(col, s, bits, W) ? 1 : 0;
  }
  const int tot = block_sum(mine, red);
  if (threadIdx.x == 0) block_left[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(uint8_t* work, uint8_t* scratch, long long C, const int* ws,
               const uint32_t* bits, int W, const int* block_left) {
  __shared__ int red[kWarps];
  __shared__ int warp_l[kWarps];
  __shared__ int warp_r[kWarps];
  __shared__ int dest[kThreads];
  const Split s = load_split(ws);
  // parent in `side`, both children written to the other array
  const uint8_t* src = s.side ? scratch : work;
  uint8_t* dst = s.side ? work : scratch;
  int b0, b1;
  chunk_of(s, b0, b1);
  if (b0 >= b1) return;  // uniform across the block

  int before = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads)
    before += block_left[b];
  const int off_l = block_sum(before, red);  // left rows of earlier blocks
  const int off_r = b0 - off_l;               // right rows of earlier blocks

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int pieces = (int)(C / 16);
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  int run_l = 0, run_r = 0;
  for (int t0 = b0; t0 < b1; t0 += kThreads) {
    const int r = t0 + threadIdx.x;
    const bool valid = r < b1;
    bool gl = false;
    if (valid) {
      const int col = src[(long long)(s.start + r) * C + s.feat];
      gl = go_left(col, s, bits, W);
    }
    const unsigned bl = __ballot_sync(0xffffffffu, gl);
    const unsigned br = __ballot_sync(0xffffffffu, valid && !gl);
    if (lane == 0) {
      warp_l[warp] = __popc(bl);
      warp_r[warp] = __popc(br);
    }
    __syncthreads();
    int pre_l = 0, pre_r = 0, tot_l = 0, tot_r = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        pre_l += warp_l[w];
        pre_r += warp_r[w];
      }
      tot_l += warp_l[w];
      tot_r += warp_r[w];
    }
    int d = -1;
    if (gl) {
      d = s.start + off_l + run_l + pre_l + __popc(bl & lt);
    } else if (valid) {
      d = s.start + s.n_left + off_r + run_r + pre_r + __popc(br & lt);
    }
    // defence in depth: a split whose scanned n_left disagrees with the
    // routing may scramble the segment, but never writes outside it
    if (d >= s.start + s.count) d = -1;
    dest[threadIdx.x] = d;
    __syncthreads();
    const int rows = min(kThreads, b1 - t0);
    const long long base = (long long)(s.start + t0) * pieces;
    for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
      const int row = i / pieces;
      const int piece = i - row * pieces;
      const int to = dest[row];
      if (to >= 0) dst4[(long long)to * pieces + piece] = src4[base + i];
    }
    run_l += tot_l;
    run_r += tot_r;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
copyback_kernel(uint8_t* work, uint8_t* scratch, long long C, const int* ws) {
  const Split s = load_split(ws);
  // the left child: other array -> the parent's own array
  const uint4* src = reinterpret_cast<const uint4*>(s.side ? work : scratch);
  uint4* dst = reinterpret_cast<uint4*>(s.side ? scratch : work);
  const long long pieces = C / 16;
  const long long base = (long long)s.start * pieces;
  const long long total = (long long)s.n_left * pieces;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step)
    dst[base + i] = src[base + i];
}

}  // namespace

// One split's launch chain on `stream`. work/scratch: [n_rows, C] u8 row
// records (C % 16 == 0, 16-byte aligned); sp: int32[SP_LEN] split scalars
// (SP_SMALLER < 0 = pick the smaller child); bits: uint32[W] categorical
// bitset; block_left: int32[n_blocks] scratch; ws: int32[WS_LEN] output
// workspace (ws + WS_HSTART is the segment vector for K1's record mode).
// mode 1 runs prep only (the histogram of the whole segment follows).
extern "C" int lgbt_fused_split(int mode, void* work, void* scratch,
                                int n_rows, long long C, int F,
                                const void* sp, const void* bits, int W,
                                void* block_left, int n_blocks, void* ws,
                                void* stream) {
  if (C % 16 != 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(work);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  int* wsp = static_cast<int*>(ws);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  int* bl = static_cast<int*>(block_left);
  prep_kernel<<<1, 32, 0, st>>>(static_cast<const int*>(sp), mode, n_rows, F,
                                wsp);
  if (mode != 1) {
    count_kernel<<<n_blocks, kThreads, 0, st>>>(w, s, C, wsp, b, W, bl);
    scatter_kernel<<<n_blocks, kThreads, 0, st>>>(w, s, C, wsp, b, W, bl);
    copyback_kernel<<<n_blocks, kThreads, 0, st>>>(w, s, C, wsp);
  }
  return (int)cudaGetLastError();
}
