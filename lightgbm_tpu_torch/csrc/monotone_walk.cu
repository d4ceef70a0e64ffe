// The intermediate monotone method's tree walk, for Hopper (sm_90a).
//
// No TPU kernel is replaced: the JAX package walks the tree with XLA
// while-loops (lightgbm_tpu/ops/grower_compact.py:859-991; reference:
// IntermediateLeafConstraints::Update, GoUpToFindLeavesToUpdate and
// GoDownToFindLeavesToUpdate, src/treelearner/monotone_constraints.hpp:
// 560-858). The walk is sequential pointer chasing over arrays of at most L
// entries, so one thread runs it, launched once a split with every input on
// the device: the grower reads nothing back to the host.
//
//   up    from the new split node to the root: at each numerical ancestor
//         whose (feature, side) was not climbed already, record (feature,
//         threshold, side); at a monotone one, record its other branch as
//         pending, with the direction of the bound to tighten and the
//         number of climbed records before it;
//   down  for each pending branch, a depth-first walk pruned by the climbed
//         records (a node on a climbed feature whose threshold puts the
//         branch beyond the climbed split keeps only one side) and by the
//         new split's own feature and threshold (which narrow whether the
//         left or the right new child borders the leaves below); each leaf
//         reached that has a valid cached split gets its upper (or lower)
//         bound clamped by the smaller (or larger) of the bordering
//         children's outputs, and is flagged when the bound moved.
//
// The stacks (2L entries) and the climbed records (L each) live in dynamic
// shared memory (30 bytes a leaf). The 32 threads of the block clear the
// flags first. The node table is int64 [L-1, node_stride] (feature,
// threshold bin, default left, left child, right child, parent node,
// categorical flag); the leaf table f32 [L, leaf_stride], whose bounds the
// walk updates in place.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
enum { kSF = 0, kSB = 1, kLeft = 3, kRight = 4, kParent = 5, kCat = 6 };

__global__ void monotone_walk_kernel(
    const long long* __restrict__ node_i, int node_stride, int node,
    const long long* __restrict__ mono, float* __restrict__ leaf_f,
    int leaf_stride, int col_bg, int col_cmin, int col_cmax,
    const bool* __restrict__ eff_p, const long long* __restrict__ parent_p,
    const long long* __restrict__ feature_p,
    const long long* __restrict__ thr_p, const float* __restrict__ lw_p,
    const float* __restrict__ rw_p, unsigned char* __restrict__ flags,
    int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = threadIdx.x; i < L; i += blockDim.x) flags[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0 || !*eff_p) return;

  int* st_n = reinterpret_cast<int*>(smem);     // [2L] stack: node
  int* feats = st_n + 2 * L;                    // [L] climbed features
  int* thrs = feats + L;                        // [L] climbed thresholds
  int* pend_root = thrs + L;                    // [L] pending branches
  int* pend_d = pend_root + L;                  // [L] records before each
  unsigned char* st_ul = reinterpret_cast<unsigned char*>(pend_d + L);
  unsigned char* st_ur = st_ul + 2 * L;         // [2L] stack: borders
  unsigned char* wasr = st_ur + 2 * L;          // [L] climbed from right
  unsigned char* pend_umax = wasr + L;          // [L] tighten the max

#define NI(n, c) node_i[(long long)(n) * node_stride + (c)]
  // ---- up ----
  int cur = node;
  int par = static_cast<int>(*parent_p);
  int d = 0, n_pend = 0;
  while (par >= 0) {
    const int pf = static_cast<int>(NI(par, kSF));
    const int pt = static_cast<int>(NI(par, kSB));
    const bool p_num = NI(par, kCat) == 0;
    const long long mt_p = mono[pf];
    const bool is_right = NI(par, kRight) == cur;
    bool clash = false;
    for (int j = 0; j < d; ++j)
      if (feats[j] == pf && (wasr[j] != 0) == is_right) clash = true;
    if (p_num && !clash) {
      const bool left_is_cur = NI(par, kLeft) == cur;
      if (mt_p != 0) {
        const int ip = min(n_pend, L - 1);
        pend_root[ip] = static_cast<int>(left_is_cur ? NI(par, kRight)
                                                     : NI(par, kLeft));
        pend_umax[ip] = mt_p < 0 ? left_is_cur : !left_is_cur;
        pend_d[ip] = d;
        ++n_pend;
      }
      const int idx = min(d, L - 1);
      feats[idx] = pf;
      thrs[idx] = pt;
      wasr[idx] = is_right;
      ++d;
    }
    cur = par;
    par = static_cast<int>(NI(par, kParent));
  }

  // ---- down ----
  const float lw = *lw_p, rw = *rw_p;
  const float lo = fminf(lw, rw), hi = fmaxf(lw, rw);
  const int f_split = static_cast<int>(*feature_p);
  const int t_split = static_cast<int>(*thr_p);
  for (int j = 0; j < min(n_pend, L); ++j) {
    const int dj = pend_d[j];
    const bool umax = pend_umax[j] != 0;
    int sp = 1;
    st_n[0] = pend_root[j];
    st_ul[0] = 1;
    st_ur[0] = 1;
    while (sp > 0) {
      --sp;
      const int nd = st_n[sp];
      const bool ul = st_ul[sp] != 0, ur = st_ur[sp] != 0;
      if (nd < 0) {
        const int leaf = -(nd + 1);
        float* row = leaf_f + (long long)leaf * leaf_stride;
        if (row[col_bg] > kNegInf / 2) {
          const bool both = ul && ur;
          const float near = ur ? rw : lw;
          if (umax) {
            const float nv = fminf(row[col_cmax], both ? lo : near);
            if (nv < row[col_cmax]) flags[leaf] = 1;
            row[col_cmax] = nv;
          } else {
            const float nv = fmaxf(row[col_cmin], both ? hi : near);
            if (nv > row[col_cmin]) flags[leaf] = 1;
            row[col_cmin] = nv;
          }
        }
        continue;
      }
      const int nf = static_cast<int>(NI(nd, kSF));
      const int nt = static_cast<int>(NI(nd, kSB));
      const bool n_num = NI(nd, kCat) == 0;
      bool hit_r = false, hit_l = false;
      for (int q = 0; q < dj; ++q) {
        if (feats[q] != nf) continue;
        if (nt >= thrs[q] && !wasr[q]) hit_r = true;
        if (nt <= thrs[q] && wasr[q]) hit_l = true;
      }
      const bool keep_r = !n_num || !hit_r;
      const bool keep_l = !n_num || !hit_l;
      const bool ul4r = !(n_num && nf == f_split && nt >= t_split);
      const bool ur4l = !(n_num && nf == f_split && nt <= t_split);
      if (keep_l) {
        st_n[sp] = static_cast<int>(NI(nd, kLeft));
        st_ul[sp] = ul;
        st_ur[sp] = ur && ur4l;
        ++sp;
      }
      if (keep_r) {
        st_n[sp] = static_cast<int>(NI(nd, kRight));
        st_ul[sp] = ul && ul4r;
        st_ur[sp] = ur;
        ++sp;
      }
    }
  }
#undef NI
}

}  // namespace

extern "C" int lgbt_monotone_walk(
    const void* node_i, int node_stride, int node, const void* mono,
    void* leaf_f, int leaf_stride, int col_bg, int col_cmin, int col_cmax,
    const void* eff, const void* parent, const void* feature,
    const void* thr, const void* lw, const void* rw, void* flags, int L,
    int smem, void* stream) {
  if (L <= 0 || node_stride < 7 || smem < 30 * L)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        monotone_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  monotone_walk_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(node_i), node_stride, node,
      static_cast<const long long*>(mono), static_cast<float*>(leaf_f),
      leaf_stride, col_bg, col_cmin, col_cmax,
      static_cast<const bool*>(eff), static_cast<const long long*>(parent),
      static_cast<const long long*>(feature),
      static_cast<const long long*>(thr), static_cast<const float*>(lw),
      static_cast<const float*>(rw), static_cast<unsigned char*>(flags), L);
  return (int)cudaGetLastError();
}
