// Exact TreeSHAP contributions for Hopper (sm_90a), in float64.
//
// No Pallas kernel is replaced: the JAX package computes pred_contrib as
// Python recursion on the host (lightgbm_tpu/ops/treeshap.py) and, for
// serving, as an XLA program that unrolls the recursion per leaf
// (lightgbm_tpu/ops/treeshap_device.py shap_batched; reference:
// Tree::TreeSHAP, src/io/tree.cpp). This kernel computes the same function
// from the per-leaf path tables of ops/treeshap_device.py
// build_shap_paths.
//
// One thread a row. For each tree of the window, in order, the thread
// evaluates every internal node's go-left decision for its row once (the
// predicate of the depth-batched walk: numerical bin <= threshold, the NaN
// bin following default_left, a categorical node's bitset) into a bit
// array; then, leaf by leaf, in index order:
//   agreement  a slot's `one` is 1 when the row agrees with every step of
//              the leaf's path that maps to the slot (repeated features
//              share a slot), else 0;
//   EXTEND     the permutation weights pweight[0..u] over slots 1..u;
//   UNWIND     for each slot, the sum of the weights with the slot taken
//              out, and phi[feature] += w * (one - zero) * leaf_value.
// The tree's expected value goes to the bias column. The row's output
// [K, F+1] belongs to its thread (tree t adds to class t % K): no atomics,
// and the sums run in one fixed order.
//
// What bounds it: float64 operations, 1.5 u(u+1) + 2 u^2 + 2u a leaf of u
// slots a row of work that depends on the row (shap_ops), against a few
// bytes a row of input; this kernel does more, dividing by factors that
// depend on the leaf's tables alone, and its scattered output and per-row
// scratch are cached. Every table read is the same
// address for all threads of the block (the same tree, leaf and step at the
// same time): one broadcast a warp from L1, so they are read from device
// memory as they are (staging them in shared memory, two barriers a leaf,
// measured 1.01x slower at 131,072 rows on an H100). The per-row arrays
// (pweight, one, the node decisions) have the window's longest unique path
// and node count as their size, so they live in device scratch laid out
// [slot][row]: neighbouring threads touch neighbouring addresses, as local
// memory would, at any depth.
//
// The tabled mode (lgbt_treeshap_tables): serving's pred_contrib, with
// EXTEND and UNWIND run once at deployment on every agreement mask of every
// leaf (ops/treeshap_device.py build_shap_tables; replaces
// lightgbm_tpu/ops/treeshap_device.py:385 shap_batched_tables, an XLA
// program). A row then forms each leaf's mask from its node decisions,
// reads one row of the leaf's block and adds its u weights: one thread a
// row, as above.
//
// Rows of more than 256 bins are 16-bit (uint16 on the host, an int16
// view of the same bytes on the device): the kernel is a template on the
// bin type, lgbt_treeshap (uint8) and lgbt_treeshap_u16 (uint16), and a
// bin is read into a 32-bit int either way.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Each internal node's go-left decision for one row (the predicate of the
// depth-batched walk), tree t's nn nodes as bits: word w at dec[w * n].
template <typename BinT>
__device__ __forceinline__ void node_decisions(
    const BinT* __restrict__ x, int t, int nn, long long n, int max_nodes,
    int cat_words, const int* __restrict__ split_feature,
    const int* __restrict__ split_bin, const int* __restrict__ nan_bin,
    const int* __restrict__ node_flags,
    const unsigned* __restrict__ cat_bitset, unsigned* __restrict__ dec) {
  for (int w = 0; w * 32 < nn; ++w) {
    unsigned bits = 0;
    for (int b = 0; b < 32 && w * 32 + b < nn; ++b) {
      const long long o = (long long)t * max_nodes + w * 32 + b;
      const int bin = x[split_feature[o]];
      const int fl = node_flags[o];
      bool left;
      if (fl & 2) {
        const int wi = bin >> 5;
        const unsigned word =
            wi < cat_words ? cat_bitset[o * cat_words + wi] : 0u;
        left = (word >> (bin & 31)) & 1u;
      } else {
        left = bin <= split_bin[o] || ((fl & 1) && bin == nan_bin[o]);
      }
      bits |= (unsigned)left << b;
    }
    dec[(long long)w * n] = bits;
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads) treeshap_kernel(
    const BinT* __restrict__ binned, long long n,
    long long row_stride, int f, int num_trees, int max_nodes,
    int cat_words, int max_leaves, int max_steps, int max_slots,
    int num_class, const int* __restrict__ split_feature,
    const int* __restrict__ split_bin, const int* __restrict__ nan_bin,
    const int* __restrict__ node_flags,
    const unsigned* __restrict__ cat_bitset,
    const int* __restrict__ num_nodes, const int* __restrict__ num_leaves,
    const int* __restrict__ path_len, const int* __restrict__ step_node,
    const int* __restrict__ step_left, const int* __restrict__ step_slot,
    const double* __restrict__ zfrac, const int* __restrict__ feat,
    const int* __restrict__ ulen, const double* __restrict__ leaf_value,
    const double* __restrict__ ev, double* __restrict__ out,
    double* __restrict__ pw_all, unsigned char* __restrict__ one_all,
    unsigned* __restrict__ dec_all) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  double* pw = pw_all + r;                  // pweight[j] at pw[j * n]
  unsigned char* one = one_all + r;         // one[j] at one[j * n]
  unsigned* dec = dec_all + r;              // decision word w at dec[w * n]
  const BinT* x = binned + r * row_stride;
  const int width = f + 1;

  for (int t = 0; t < num_trees; ++t) {
    double* orow = out + (r * num_class + t % num_class) * width;
    const int nn = num_nodes[t];
    orow[f] += ev[t];
    node_decisions(x, t, nn, n, max_nodes, cat_words, split_feature,
                   split_bin, nan_bin, node_flags, cat_bitset, dec);
    if (nn == 0) continue;
    const int nl = num_leaves[t];
    for (int l = 0; l < nl; ++l) {
      const long long tl = (long long)t * max_leaves + l;
      const int u = ulen[tl];
      const int plen = path_len[tl];
      if (u == 0) continue;
      const double* z = zfrac + tl * max_slots;
      const int* fs = feat + tl * max_slots;
      const int* sn = step_node + tl * max_steps;
      const int* sl = step_left + tl * max_steps;
      const int* ss = step_slot + tl * max_steps;
      for (int j = 0; j <= u; ++j) one[(long long)j * n] = 1;
      for (int s = 0; s < plen; ++s) {
        const int nd = sn[s];
        const int bit = (dec[(long long)(nd >> 5) * n] >> (nd & 31)) & 1u;
        if (bit != sl[s]) one[(long long)ss[s] * n] = 0;
      }
      // EXTEND (reference order: p[k+1] += o p[k] (k+1)/(j+1), then
      // p[k] = z p[k] (j-k)/(j+1), k = j-1 .. 0)
      pw[0] = 1.0;
      for (int j = 1; j <= u; ++j) {
        const double zj = z[j];
        const double oj = one[(long long)j * n];
        pw[(long long)j * n] = 0.0;
        for (int k = j - 1; k >= 0; --k) {
          const double pk = pw[(long long)k * n];
          pw[(long long)(k + 1) * n] += oj * pk * (k + 1) / (j + 1);
          pw[(long long)k * n] = zj * pk * (j - k) / (j + 1);
        }
      }
      // UNWIND sum of each slot
      const double lv = leaf_value[tl];
      const double pu = pw[(long long)u * n];
      for (int i = 1; i <= u; ++i) {
        const double oi = one[(long long)i * n];
        const double zi = z[i];
        double total = 0.0;
        double next = pu;
        for (int k = u - 1; k >= 0; --k) {
          const double pk = pw[(long long)k * n];
          if (oi != 0.0) {
            const double tmp = next * (u + 1) / ((k + 1) * oi);
            total += tmp;
            next = pk - tmp * zi * (u - k) / (u + 1);
          } else {
            total += pk / (zi * (u - k) / (u + 1));
          }
        }
        orow[fs[i]] += total * (oi - zi) * lv;
      }
    }
  }
}

template <typename BinT>
int launch(const void* binned, long long n, long long row_stride, int f,
           int num_trees, int max_nodes, int cat_words, int max_leaves,
           int max_steps, int max_slots, int num_class,
           const void* split_feature, const void* split_bin,
           const void* nan_bin, const void* node_flags,
           const void* cat_bitset, const void* num_nodes,
           const void* num_leaves, const void* path_len,
           const void* step_node, const void* step_left,
           const void* step_slot, const void* zfrac, const void* feat,
           const void* ulen, const void* leaf_value, const void* ev,
           void* out, void* pw, void* one, void* dec, void* stream) {
  if (n <= 0 || f <= 0 || num_trees <= 0 || max_nodes <= 0 ||
      cat_words <= 0 || max_leaves <= 0 || max_steps <= 0 ||
      max_slots <= 0 || num_class <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  treeshap_kernel<BinT><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(binned), n, row_stride, f,
      num_trees, max_nodes, cat_words, max_leaves, max_steps, max_slots,
      num_class, static_cast<const int*>(split_feature),
      static_cast<const int*>(split_bin), static_cast<const int*>(nan_bin),
      static_cast<const int*>(node_flags),
      static_cast<const unsigned*>(cat_bitset),
      static_cast<const int*>(num_nodes), static_cast<const int*>(num_leaves),
      static_cast<const int*>(path_len), static_cast<const int*>(step_node),
      static_cast<const int*>(step_left), static_cast<const int*>(step_slot),
      static_cast<const double*>(zfrac), static_cast<const int*>(feat),
      static_cast<const int*>(ulen), static_cast<const double*>(leaf_value),
      static_cast<const double*>(ev), static_cast<double*>(out),
      static_cast<double*>(pw), static_cast<unsigned char*>(one),
      static_cast<unsigned*>(dec));
  return (int)cudaGetLastError();
}

// The tabled mode: the same node decisions, then for each leaf the mask of
// its slots' agreement (bit j-1 for slot j; a slot agrees when every step
// of the path mapping to it does) and one row of the leaf's block of
// ops/treeshap_device.py build_shap_tables, whose u weights add at the
// slots' features. No EXTEND or UNWIND runs here: both ran once, at
// deployment, on every mask.
template <typename BinT>
__global__ void __launch_bounds__(kThreads) treeshap_tables_kernel(
    const BinT* __restrict__ binned, long long n,
    long long row_stride, int f, int num_trees, int max_nodes,
    int cat_words, int max_leaves, int max_steps, int max_slots,
    int num_class, const int* __restrict__ split_feature,
    const int* __restrict__ split_bin, const int* __restrict__ nan_bin,
    const int* __restrict__ node_flags,
    const unsigned* __restrict__ cat_bitset,
    const int* __restrict__ num_nodes, const int* __restrict__ num_leaves,
    const int* __restrict__ path_len, const int* __restrict__ step_node,
    const int* __restrict__ step_left, const int* __restrict__ step_slot,
    const int* __restrict__ feat, const int* __restrict__ ulen,
    const long long* __restrict__ offset, const double* __restrict__ table,
    const double* __restrict__ ev, double* __restrict__ out,
    unsigned* __restrict__ dec_all) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  unsigned* dec = dec_all + r;
  const BinT* x = binned + r * row_stride;
  const int width = f + 1;

  for (int t = 0; t < num_trees; ++t) {
    double* orow = out + (r * num_class + t % num_class) * width;
    const int nn = num_nodes[t];
    orow[f] += ev[t];
    if (nn == 0) continue;
    node_decisions(x, t, nn, n, max_nodes, cat_words, split_feature,
                   split_bin, nan_bin, node_flags, cat_bitset, dec);
    const int nl = num_leaves[t];
    for (int l = 0; l < nl; ++l) {
      const long long tl = (long long)t * max_leaves + l;
      const int u = ulen[tl];
      if (u == 0) continue;
      const int plen = path_len[tl];
      const int* sn = step_node + tl * max_steps;
      const int* sl = step_left + tl * max_steps;
      const int* ss = step_slot + tl * max_steps;
      unsigned mask = u >= 32 ? ~0u : ((1u << u) - 1u);
      for (int s = 0; s < plen; ++s) {
        const int nd = sn[s];
        const int bit = (dec[(long long)(nd >> 5) * n] >> (nd & 31)) & 1u;
        if (bit != sl[s]) mask &= ~(1u << (ss[s] - 1));
      }
      const double* row = table + offset[tl] + (long long)mask * u;
      const int* fs = feat + tl * max_slots;
      for (int j = 1; j <= u; ++j) orow[fs[j]] += row[j - 1];
    }
  }
}

template <typename BinT>
int launch_tables(const void* binned, long long n, long long row_stride,
                  int f, int num_trees, int max_nodes, int cat_words,
                  int max_leaves, int max_steps, int max_slots,
                  int num_class, const void* split_feature,
                  const void* split_bin, const void* nan_bin,
                  const void* node_flags, const void* cat_bitset,
                  const void* num_nodes, const void* num_leaves,
                  const void* path_len, const void* step_node,
                  const void* step_left, const void* step_slot,
                  const void* feat, const void* ulen, const void* offset,
                  const void* table, const void* ev, void* out, void* dec,
                  void* stream) {
  if (n <= 0 || f <= 0 || num_trees <= 0 || max_nodes <= 0 ||
      cat_words <= 0 || max_leaves <= 0 || max_steps <= 0 ||
      max_slots <= 0 || num_class <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  treeshap_tables_kernel<BinT><<<(unsigned)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(binned), n, row_stride, f, num_trees,
      max_nodes, cat_words, max_leaves, max_steps, max_slots, num_class,
      static_cast<const int*>(split_feature),
      static_cast<const int*>(split_bin), static_cast<const int*>(nan_bin),
      static_cast<const int*>(node_flags),
      static_cast<const unsigned*>(cat_bitset),
      static_cast<const int*>(num_nodes), static_cast<const int*>(num_leaves),
      static_cast<const int*>(path_len), static_cast<const int*>(step_node),
      static_cast<const int*>(step_left), static_cast<const int*>(step_slot),
      static_cast<const int*>(feat), static_cast<const int*>(ulen),
      static_cast<const long long*>(offset),
      static_cast<const double*>(table), static_cast<const double*>(ev),
      static_cast<double*>(out), static_cast<unsigned*>(dec));
  return (int)cudaGetLastError();
}

}  // namespace

// binned: [n, f] uint8 rows of row_stride bytes
extern "C" int lgbt_treeshap(
    const void* binned, long long n, long long row_stride, int f,
    int num_trees, int max_nodes, int cat_words, int max_leaves,
    int max_steps, int max_slots, int num_class, const void* split_feature,
    const void* split_bin, const void* nan_bin, const void* node_flags,
    const void* cat_bitset, const void* num_nodes, const void* num_leaves,
    const void* path_len, const void* step_node, const void* step_left,
    const void* step_slot, const void* zfrac, const void* feat,
    const void* ulen, const void* leaf_value, const void* ev, void* out,
    void* pw, void* one, void* dec, void* stream) {
  return launch<uint8_t>(
      binned, n, row_stride, f, num_trees, max_nodes, cat_words, max_leaves,
      max_steps, max_slots, num_class, split_feature, split_bin, nan_bin,
      node_flags, cat_bitset, num_nodes, num_leaves, path_len, step_node,
      step_left, step_slot, zfrac, feat, ulen, leaf_value, ev, out, pw, one,
      dec, stream);
}

// binned: [n, f] uint16 rows of row_stride elements
extern "C" int lgbt_treeshap_u16(
    const void* binned, long long n, long long row_stride, int f,
    int num_trees, int max_nodes, int cat_words, int max_leaves,
    int max_steps, int max_slots, int num_class, const void* split_feature,
    const void* split_bin, const void* nan_bin, const void* node_flags,
    const void* cat_bitset, const void* num_nodes, const void* num_leaves,
    const void* path_len, const void* step_node, const void* step_left,
    const void* step_slot, const void* zfrac, const void* feat,
    const void* ulen, const void* leaf_value, const void* ev, void* out,
    void* pw, void* one, void* dec, void* stream) {
  return launch<uint16_t>(
      binned, n, row_stride, f, num_trees, max_nodes, cat_words, max_leaves,
      max_steps, max_slots, num_class, split_feature, split_bin, nan_bin,
      node_flags, cat_bitset, num_nodes, num_leaves, path_len, step_node,
      step_left, step_slot, zfrac, feat, ulen, leaf_value, ev, out, pw, one,
      dec, stream);
}

// the tabled mode: binned rows as above, the path tables without the
// cover fractions and leaf values, each leaf's table offset (int64) and the
// tables (float64), the expected values, output and the decision scratch
#define LGBT_TABLES_ENTRY(NAME, BINT)                                         \
  extern "C" int NAME(                                                        \
      const void* binned, long long n, long long row_stride, int f,          \
      int num_trees, int max_nodes, int cat_words, int max_leaves,           \
      int max_steps, int max_slots, int num_class,                            \
      const void* split_feature, const void* split_bin, const void* nan_bin, \
      const void* node_flags, const void* cat_bitset, const void* num_nodes, \
      const void* num_leaves, const void* path_len, const void* step_node,   \
      const void* step_left, const void* step_slot, const void* feat,        \
      const void* ulen, const void* offset, const void* table,               \
      const void* ev, void* out, void* dec, void* stream) {                  \
    return launch_tables<BINT>(                                               \
        binned, n, row_stride, f, num_trees, max_nodes, cat_words,           \
        max_leaves, max_steps, max_slots, num_class, split_feature,           \
        split_bin, nan_bin, node_flags, cat_bitset, num_nodes, num_leaves,   \
        path_len, step_node, step_left, step_slot, feat, ulen, offset,       \
        table, ev, out, dec, stream);                                         \
  }

LGBT_TABLES_ENTRY(lgbt_treeshap_tables, uint8_t)
LGBT_TABLES_ENTRY(lgbt_treeshap_tables_u16, uint16_t)
