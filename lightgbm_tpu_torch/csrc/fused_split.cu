// K2: the partition half of one leaf split, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/fused_split.py::_fused_kernel
// (wrapper fused_split), which walks the parent's segment once, writes the
// left rows in place and the right rows into the other residency array, and
// accumulates the smaller child's histogram. Here two launches do the
// partition:
//
//   prep       one thread sanitizes the split scalars (device int32 vector
//              `sp`) into a workspace: start within the array, count within
//              n_rows - start, n_left <= count, the smaller child's range
//              and array for the histogram; it advances the look-back epoch
//              and resets the tile ticket (device int32 `ctl`), so nothing
//              is reset from the host;
//   partition  one pass with decoupled look-back. A persistent grid takes
//              tiles of the parent's segment in ticket order (an atomic
//              counter, so a tile's predecessors were all taken by blocks
//              that are running). A block stages its tile's real record
//              bytes in shared memory (ceil(num_real_cols / 16) 16-byte
//              vectors a row: 4 of 8 at F = 28 with 4 extra columns),
//              evaluates the routing predicate, ranks its rows stably with
//              warp ballots and a scan across the warps, publishes its left
//              count, and takes its exclusive left offset from its
//              predecessors' flags (one warp reads 32 of them at a time).
//              Left rows go in place to start + off_l + rank of the parent's
//              array, right rows to start + n_left + off_r + rank of the
//              other array.
//
// Writing left rows in place is safe although blocks run in no order: a
// block's left destinations lie at or below the end of its own tile, in
// tiles whose blocks have already staged them (a block publishes only after
// its whole tile is in shared memory, and a block writes only after it has
// seen every predecessor publish). Left and right destinations of different
// tiles are disjoint. The flags carry the epoch of their split, so flags of
// an earlier split never pass for this one and the flag array is never
// cleared.
//
// Copy-back variant (dual = 0; the TPU kernel's dual=False, which the JAX
// package runs on EFB-bundled data): every segment lives in `work`. prep
// takes the side as 0, the partition writes the left rows in place and the
// right rows to `scratch` at the same offsets, and a third launch,
//
//   copyback   a grid-stride copy of the right rows' first P vectors from
//              `scratch` back into `work`, over exactly [start + n_left,
//              start + count) (rows outside it are left bit for bit),
//
// restores the one-array layout; the histogram then reads `work`.
//
// The histogram of the smaller child is K1 (csrc/histogram.cu) in record
// mode over that child's now contiguous range (left child: the parent's
// array, right child: the other array, or `work` in copy-back), launched by
// the Python wrapper after these launches; in mode 1 only `prep` runs here
// and K1 covers the whole segment.
//
// Nibble-packed records (packed4, the TPU kernel's packed4, lightgbm_tpu/
// ops/fused_split.py:217-228, :662): the bin columns hold two features a
// byte, so a record's real vectors are fewer (P shrinks with the layout's
// moved_cols) and the routing reads feature f's nibble, byte f >> 1, shift
// 4 (f & 1), from the staged tile; the rest is unchanged in either
// residency. The compact grower without the fused kernel (tpu_fused=off)
// runs these launches alone, with no histogram after them.
//
// Padding bytes past the last 16-byte vector of a row's real columns are
// neither read nor written; the arrays start with zero padding and every
// copy of the grower moves whole rows, so the padding stays zero.
//
// What bounds it on the H100: bytes, 2 * count * 16 * ceil(num_real_cols /
// 16) (each parent row's real vectors read once and written once; the
// copy-back adds a read and a write of each right row's vectors); the
// routing byte comes from the staged tile. No host sync: the segment
// scalars come from the device, the grid is fixed (a persistent grid sized
// from the array's rows, whose surplus blocks return at once), and a zero
// count is a no-op.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 1024;           // rows; 4 rounds of 256

// sp: the wrapper's split scalars (int32, device)
enum { SP_START, SP_COUNT, SP_NLEFT, SP_FEAT, SP_BIN, SP_DLEFT, SP_NANBIN,
       SP_ISCAT, SP_SMALLER, SP_SIDE, SP_LEN };
// ws: sanitized scalars written by prep_kernel (int32, device); the three
// HIST entries are the segment vector K1 reads in record mode
enum { WS_START, WS_COUNT, WS_NLEFT, WS_HSTART, WS_HCOUNT, WS_HSEL, WS_SIDE,
       WS_FEAT, WS_BIN, WS_DLEFT, WS_NANBIN, WS_ISCAT, WS_LEN };
// ctl: the look-back state kept across splits (int32, device, zeroed once)
enum { CTL_EPOCH, CTL_TICKET, CTL_LEN };
// flag status, in the low two bits of the flag's high word
enum { FLAG_NONE = 0, FLAG_AGGREGATE = 1, FLAG_PREFIX = 2 };

__global__ void prep_kernel(const int* sp, int mode, int dual, int n_rows,
                            int F, int* ws, int* ctl) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int start = min(max(sp[SP_START], 0), n_rows);
  const int count = min(max(sp[SP_COUNT], 0), n_rows - start);
  const int n_left = min(max(sp[SP_NLEFT], 0), count);
  // copy-back: every segment lives in work
  const int side = dual && sp[SP_SIDE] != 0 ? 1 : 0;
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
    // the left child stays in the parent's array, the right is in the other
    // (copy-back: back in work)
    ws[WS_HSTART] = smaller ? start : start + n_left;
    ws[WS_HCOUNT] = smaller ? n_left : count - n_left;
    ws[WS_HSEL] = smaller || !dual ? side : 1 - side;
    int epoch = (ctl[CTL_EPOCH] + 1) & 0x3fffffff;
    ctl[CTL_EPOCH] = epoch == 0 ? 1 : epoch;
    ctl[CTL_TICKET] = 0;
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

__device__ __forceinline__ unsigned long long make_flag(int epoch, int status,
                                                        int value) {
  return ((unsigned long long)(uint32_t)((epoch << 2) | status) << 32)
         | (uint32_t)value;
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Status and value of a tile's flag, spinning until its block has
// published for this epoch (a flag of an earlier split does not count).
__device__ __forceinline__ int wait_flag(const unsigned long long* p,
                                         int epoch, int& value) {
  const uint32_t want = (uint32_t)epoch << 2;
  for (;;) {
    const unsigned long long v =
        *reinterpret_cast<const volatile unsigned long long*>(p);
    const uint32_t hi = (uint32_t)(v >> 32);
    if ((hi & ~3u) == want && (hi & 3u) != FLAG_NONE) {
      value = (int)(uint32_t)v;
      return (int)(hi & 3u);
    }
    __nanosleep(32);
  }
}

__global__ void __launch_bounds__(kThreads)
partition_kernel(uint8_t* work, uint8_t* scratch, long long C, int P, int T,
                 int packed4, const int* ws, const uint32_t* bits, int W,
                 unsigned long long* flags, int* ctl) {
  extern __shared__ uint4 tile[];            // [T][P] vectors, then dest[T]
  int* dest = reinterpret_cast<int*>(tile + (long long)T * P);
  __shared__ int warp_l[kMaxTile / 32];      // left rows a (round, warp)
  __shared__ int warp_pre[kMaxTile / 32];    // their exclusive prefix
  __shared__ int sh_ticket, sh_off;
  const Split s = load_split(ws);
  const int n_tiles = (s.count + T - 1) / T;
  if ((int)blockIdx.x >= n_tiles) return;    // uniform across the block
  const int epoch = ctl[CTL_EPOCH];
  uint8_t* par = s.side ? scratch : work;    // the parent; the left child
  uint8_t* oth = s.side ? work : scratch;    // the right child
  const long long cp = C / 16;               // vectors a record
  const uint4* par4 = reinterpret_cast<const uint4*>(par);
  uint4* par4w = reinterpret_cast<uint4*>(par);
  uint4* oth4 = reinterpret_cast<uint4*>(oth);
  const uint8_t* tile_bytes = reinterpret_cast<const uint8_t*>(tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int rounds = T / kThreads;

  for (;;) {
    if (threadIdx.x == 0) sh_ticket = atomicAdd(ctl + CTL_TICKET, 1);
    __syncthreads();
    const int t = sh_ticket;
    if (t >= n_tiles) break;
    const int r0 = t * T;
    const int rows = min(T, s.count - r0);

    // stage the tile's real vectors
    const long long base = (long long)(s.start + r0) * cp;
    for (int i = threadIdx.x; i < rows * P; i += kThreads) {
      const int row = i / P;
      tile[i] = par4[base + row * cp + (i - row * P)];
    }
    __syncthreads();

    // route and rank: rows in order round * 256 + warp * 32 + lane
    unsigned left_bits = 0u;
    int rank_in_warp[kMaxTile / kThreads];
#pragma unroll
    for (int k = 0; k < kMaxTile / kThreads; ++k) {
      if (k < rounds) {
        const int i = k * kThreads + threadIdx.x;
        bool gl = false;
        if (i < rows) {
          // packed4: the feature's nibble, byte feat >> 1, shift
          // 4 (feat & 1)
          const uint8_t* rec = tile_bytes + (long long)i * P * 16;
          const int col = packed4
              ? (rec[s.feat >> 1] >> (4 * (s.feat & 1))) & 0xF
              : rec[s.feat];
          gl = go_left(col, s, bits, W);
        }
        const unsigned bl = __ballot_sync(0xffffffffu, gl);
        rank_in_warp[k] = __popc(bl & lt);
        if (gl) left_bits |= 1u << k;
        if (lane == 0) warp_l[k * kWarps + warp] = __popc(bl);
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int nq = rounds * kWarps;
      const int v = lane < nq ? warp_l[lane] : 0;
      int inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      if (lane < nq) warp_pre[lane] = inc - v;
      const int total = __shfl_sync(0xffffffffu, inc, 31);

      // publish, then look back for the left rows of earlier tiles
      int excl = 0;
      if (t == 0) {
        if (lane == 0) store_flag(flags, make_flag(epoch, FLAG_PREFIX, total));
      } else {
        if (lane == 0)
          store_flag(flags + t, make_flag(epoch, FLAG_AGGREGATE, total));
        int end = t - 1;
        for (;;) {
          const int idx = end - lane;
          int val = 0;
          int st = FLAG_PREFIX;  // before tile 0: a prefix of 0
          if (idx >= 0) st = wait_flag(flags + idx, epoch, val);
          const unsigned pm = __ballot_sync(0xffffffffu, st == FLAG_PREFIX);
          const int stop = pm ? __ffs(pm) - 1 : 31;
          int part = lane <= stop ? val : 0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          excl += part;
          if (pm) break;
          end -= 32;
        }
        if (lane == 0)
          store_flag(flags + t, make_flag(epoch, FLAG_PREFIX, excl + total));
      }
      if (lane == 0) sh_off = excl;
      __threadfence();
    }
    __syncthreads();

    // destinations: >= 0 a left row of the parent's array, <= -2 a right
    // row of the other one, -1 dropped
    const int off_l = sh_off;
    const int off_r = r0 - off_l;  // right rows of earlier tiles
    const int end = s.start + s.count;
#pragma unroll
    for (int k = 0; k < kMaxTile / kThreads; ++k) {
      if (k < rounds) {
        const int i = k * kThreads + threadIdx.x;
        if (i < rows) {
          const int lb = warp_pre[k * kWarps + warp] + rank_in_warp[k];
          int d;
          if (left_bits & (1u << k)) {
            d = s.start + off_l + lb;
          } else {
            // defence in depth: a split whose scanned n_left disagrees
            // with the routing may scramble the segment, but never writes
            // outside it
            const int to = s.start + s.n_left + off_r + (i - lb);
            d = to < end ? -2 - to : -1;
          }
          dest[i] = d;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * P; i += kThreads) {
      const int row = i / P;
      const int piece = i - row * P;
      const int d = dest[row];
      if (d >= 0) {
        par4w[(long long)d * cp + piece] = tile[i];
      } else if (d <= -2) {
        oth4[(long long)(-2 - d) * cp + piece] = tile[i];
      }
    }
    __syncthreads();  // the tile and sh_ticket are reused
  }
}

// The copy-back pass: rows [start + n_left, start + count) of scratch into
// work, their first P vectors, one vector a thread per step of a grid-stride
// loop (a zero-row range is a no-op; the grid is fixed by the host).
__global__ void __launch_bounds__(kThreads)
copyback_kernel(uint8_t* work, const uint8_t* scratch, long long C, int P,
                const int* ws) {
  const long long r0 = (long long)ws[WS_START] + ws[WS_NLEFT];
  const long long rows = (long long)ws[WS_COUNT] - ws[WS_NLEFT];
  const long long cp = C / 16;
  const long long total = rows * P;
  uint4* dst = reinterpret_cast<uint4*>(work);
  const uint4* src = reinterpret_cast<const uint4*>(scratch);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long row = i / P;
    const long long at = (r0 + row) * cp + (i - row * P);
    dst[at] = src[at];
  }
}

}  // namespace

// One split's launches on `stream`. work/scratch: [n_rows, C] u8 row records
// (C % 16 == 0, 16-byte aligned) of which the first P 16-byte vectors of a
// row move; sp: int32[SP_LEN] split scalars (SP_SMALLER < 0 = pick the
// smaller child); bits: uint32[W] categorical bitset; ws: int32[WS_LEN]
// output workspace (ws + WS_HSTART is the segment vector for K1's record
// mode); flags: uint64[ceil(n_rows / T)] and ctl: int32[CTL_LEN], both
// zeroed once and kept across splits; T: rows a tile (a multiple of 256, at
// most 1024). The persistent grid is as many blocks as fit the card at once,
// at most one a tile of the whole array. mode 1 runs prep only (the
// histogram of the whole segment follows). dual = 0 selects the copy-back
// variant (side taken as 0, then the copy-back launch).
extern "C" int lgbt_fused_split(int mode, int dual, void* work, void* scratch,
                                int n_rows, long long C, int P, int T, int F,
                                int packed4, const void* sp, const void* bits,
                                int W,
                                void* ws, void* flags, void* ctl,
                                void* stream) {
  if (C % 16 != 0 || P <= 0 || P * 16 > C || T <= 0 || T % kThreads != 0
      || T > kMaxTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* wsp = static_cast<int*>(ws);
  int* ctlp = static_cast<int*>(ctl);
  prep_kernel<<<1, 32, 0, st>>>(static_cast<const int*>(sp), mode, dual,
                                n_rows, F, wsp, ctlp);
  if (mode != 1) {
    const int smem = T * P * 16 + T * 4;
    cudaError_t e = cudaFuncSetAttribute(
        partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int occ = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, partition_kernel,
                                                      kThreads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (occ <= 0) return (int)cudaErrorInvalidConfiguration;
    const int n_tiles = (n_rows + T - 1) / T;
    const int grid = occ * sms < n_tiles ? occ * sms : n_tiles;
    partition_kernel<<<grid > 0 ? grid : 1, kThreads, smem, st>>>(
        static_cast<uint8_t*>(work), static_cast<uint8_t*>(scratch), C, P, T,
        packed4, wsp, static_cast<const uint32_t*>(bits), W,
        static_cast<unsigned long long*>(flags), ctlp);
    if (!dual) {
      // four blocks an SM, fewer where the whole array has fewer vectors
      const long long vecs = (long long)n_rows * P;
      const long long want = (vecs + kThreads - 1) / kThreads;
      const int cb_grid = want < 4LL * sms ? (int)want : 4 * sms;
      copyback_kernel<<<cb_grid > 0 ? cb_grid : 1, kThreads, 0, st>>>(
          static_cast<uint8_t*>(work),
          static_cast<const uint8_t*>(scratch), C, P, wsp);
    }
  }
  return (int)cudaGetLastError();
}
