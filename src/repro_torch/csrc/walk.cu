// Kernel D: the score walk of paper Algorithm 7, hand-written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference's walk is plain XLA
// (src/repro/core/predict.py, `_walk` and `walk_class_trees`), and the
// port ran it as a Python loop of plain-torch gathers, ~33 launches a
// step over [M] int64 / int32 / bool tensors.  This kernel walks every
// row down T trees in one launch:
//
//   out[t, m] = label[t, node] after at most `steps` descents from the
//   root, where row m descends at `node` iff
//     f = max(feat, 0) < K, !leaf, 0 <= left < N, count >= smin, and,
//     with use_mcw, min(count[left], count[max(right, 0)]) > mcw in
//     float32 (torch's promotion of the int32 counts);
//   it goes left iff the Table-3 predicate holds on its code x = bins[m, f]:
//     op 0 (<=): x < n_num[f] && x <= tbin; op 1 (>): x < n_num[f] &&
//     x > tbin; any other op (=): x == tbin
//   and stops for good where it cannot descend, or where the child it
//   picks lies outside [0, N).
//
// The depth limit is the step count (the wrapper passes min(num_steps,
// max_depth - 1)); the other limits depend on the node alone, so a row
// that cannot descend never will, and leaves the loop.  Each node's rule
// is one record: the feature (-1: stop here), and the code interval
// [lo, hi] that sends a row left, which folds n_num[f], op and tbin into
// two compares.  The labels equal the plain walk's bit for bit.
//
// Bound on this card: every row's K int32 codes are read once and T
// float32 labels written once, (M*K*4 + T*M*4) bytes: 1.218 GB, 0.364 ms
// at 3.35 TB/s at a Higgs round's M = 10.5M, K = 28, T = 1.  The plain
// walk instead moves each step's [M] node ids, gathers and masks through
// device memory, ~30 GB a Higgs round.  What the design does about it:
//   1. Blocks are persistent (as many as fit on the card, each looping
//      over 256-row tiles), and each stages the T trees' node records in
//      shared memory once, for every tile, when they fit in kNodeSmemMax:
//      a step is then one 16-byte and two 4-byte shared loads.  The
//      trees' live prefix, N = n_nodes slots (a host int), is what is
//      staged, so a boosted tree's 4,194,304 slots cost 511 records.
//   2. A tile's codes are copied into shared memory with coalesced
//      16-byte streaming loads (a scalar tail) when a row fits in
//      kTileMaxK ints, at an odd row pitch so that rows on one feature
//      fall in distinct banks; the tile is read from device memory once
//      for all T trees, and each thread keeps its row's node in a
//      register for all the steps.
//   3. Trees too large to stage read their fields through the read-only
//      path on every step, and rows too wide to stage read their codes
//      straight from device memory: slower, same labels.
// The kernel synchronises nothing with the host, reads nothing back and
// allocates nothing; offsets of rows and outputs are 64-bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // a block's threads, a tile's rows
constexpr long long kNodeBytes = 24;          // int4 rule, feature, label
constexpr long long kNodeSmemMax = 96 * 1024; // node tables staged up to this
constexpr int kTileMaxK = 48;                 // codes staged for pitches <= this

struct Walk {
  const int* feat;
  const int* op;
  const int* tbin;
  const float* label;
  const int* count;
  const int* left;
  const int* right;
  const unsigned char* leaf;
  long long ld;        // row stride of the [T, *] node fields, elements
  const int* bins;     // [M, K]
  const int* n_num;    // [K] (n_num_ld 0) or [T, K] (n_num_ld K)
  int n_num_ld;
  float* out;          // [T, M]
  int trees, nodes, k;
  long long m;
  int steps;
  long long smin;
  int use_mcw;
  float mcw;
};

struct Rule {
  int f;               // feature, or -1 where the row stops
  int lo, hi;          // a code in [lo, hi] goes left
  int left, right;
};

__device__ __forceinline__ Rule make_rule(const Walk& w, int t, int n) {
  const long long base = (long long)t * w.ld;
  const long long i = base + n;
  Rule r;
  r.left = __ldg(w.left + i);
  r.right = __ldg(w.right + i);
  const int f = max(__ldg(w.feat + i), 0);
  bool can = !__ldg(w.leaf + i) && r.left >= 0 && r.left < w.nodes &&
             f < w.k && (long long)__ldg(w.count + i) >= w.smin;
  if (can && w.use_mcw) {
    const int rc = max(r.right, 0);
    can = rc < w.nodes &&
          (float)min(__ldg(w.count + base + r.left), __ldg(w.count + base + rc)) >
              w.mcw;
  }
  r.f = can ? f : -1;
  r.lo = 1;
  r.hi = 0;
  if (can) {
    const long long nn = __ldg(w.n_num + (long long)t * w.n_num_ld + f);
    const long long tb = __ldg(w.tbin + i);
    const int op = __ldg(w.op + i);
    long long lo = tb, hi = tb;
    if (op == 0) {
      lo = INT_MIN;
      hi = min(tb, nn - 1);
    } else if (op == 1) {
      lo = tb + 1;
      hi = nn - 1;
    }
    if (lo <= hi) {    // hi <= INT_MAX and lo >= INT_MIN here
      r.lo = (int)lo;
      r.hi = (int)hi;
    }
  }
  return r;
}

// Copy n = rows * k contiguous codes into rows of pitch kp.
__device__ __forceinline__ void stage_tile(const int* __restrict__ src, int n,
                                           int k, int kp, int* dst) {
  const int head = (reinterpret_cast<uintptr_t>(src) & 15) ? 0 : (n & ~3);
  for (int v = threadIdx.x; 4 * v < head; v += kThreads) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(src) + v);
    const int vals[4] = {q.x, q.y, q.z, q.w};
    int row = (4 * v) / k, col = 4 * v - row * k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[row * kp + col] = vals[j];
      if (++col == k) {
        col = 0;
        ++row;
      }
    }
  }
  for (int e = head + threadIdx.x; e < n; e += kThreads)
    dst[(e / k) * kp + e % k] = __ldcs(src + e);
}

template <bool kStageNodes, bool kStageBins>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tn = kStageNodes ? w.trees * w.nodes : 0;
  int4* s_rule = reinterpret_cast<int4*>(smem);       // lo, hi, left, right
  int* s_feat = reinterpret_cast<int*>(s_rule + tn);
  float* s_label = reinterpret_cast<float*>(s_feat + tn);
  int* s_tile = reinterpret_cast<int*>(s_label + tn);
  const int kp = w.k | 1;

  if (kStageNodes) {
    for (int i = threadIdx.x; i < tn; i += kThreads) {
      const int t = i / w.nodes, n = i - t * w.nodes;
      const Rule r = make_rule(w, t, n);
      s_rule[i] = make_int4(r.lo, r.hi, r.left, r.right);
      s_feat[i] = r.f;
      s_label[i] = __ldg(w.label + (long long)t * w.ld + n);
    }
    __syncthreads();
  }
  const long long tiles = (w.m + kThreads - 1) / kThreads;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kThreads;
    const int rows = (int)min((long long)kThreads, w.m - row0);
    if (kStageBins) {
      __syncthreads();                 // the last tile's walks are done
      stage_tile(w.bins + row0 * w.k, rows * w.k, w.k, kp, s_tile);
      __syncthreads();
    }
    if ((int)threadIdx.x >= rows) continue;
    const long long row = row0 + threadIdx.x;
    const int* x_row = kStageBins ? s_tile + threadIdx.x * kp : w.bins + row * w.k;
    for (int t = 0; t < w.trees; ++t) {
      int node = 0;
      for (int s = 0; s < w.steps; ++s) {
        Rule r;
        if (kStageNodes) {
          const int i = t * w.nodes + node;
          r.f = s_feat[i];
          if (r.f < 0) break;
          const int4 q = s_rule[i];
          r.lo = q.x;
          r.hi = q.y;
          r.left = q.z;
          r.right = q.w;
        } else {
          r = make_rule(w, t, node);
          if (r.f < 0) break;
        }
        const int x = kStageBins ? x_row[r.f] : __ldg(x_row + r.f);
        const int next = (x >= r.lo && x <= r.hi) ? r.left : r.right;
        if ((unsigned)next >= (unsigned)w.nodes) break;
        node = next;
      }
      w.out[(long long)t * w.m + row] =
          kStageNodes ? s_label[t * w.nodes + node]
                      : __ldg(w.label + (long long)t * w.ld + node);
    }
  }
}

struct Plan {
  bool nodes, bins;
  long long smem;
};

Plan plan(int trees, int nodes, int k) {
  Plan p;
  const long long node_bytes = kNodeBytes * trees * nodes;
  p.nodes = node_bytes <= kNodeSmemMax;
  p.bins = (k | 1) <= kTileMaxK;
  p.smem = (p.nodes ? node_bytes : 0) + (p.bins ? 4LL * kThreads * (k | 1) : 0);
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch over `trees` trees of `nodes` staged
// slots and K features, in bytes.
long long udt_walk_smem(int trees, int nodes, int k) {
  return plan(trees, nodes, k).smem;
}

int udt_walk(const int* feat, const int* op, const int* tbin, const float* label,
             const int* count, const int* left, const int* right,
             const unsigned char* leaf, long long ld, const int* bins,
             const int* n_num, int n_num_ld, float* out, int trees, int nodes,
             long long m, int k, int steps, long long smin, int use_mcw,
             float mcw, cudaStream_t stream) {
  if (trees <= 0 || m <= 0) return 0;
  if (nodes <= 0 || k <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  const Walk w{feat, op, tbin, label, count, left, right, leaf, ld, bins, n_num,
               n_num_ld, out, trees, nodes, k, m, steps, smin, use_mcw, mcw};
  const Plan p = plan(trees, nodes, k);
  void (*kernel)(const Walk) = &walk_kernel<false, false>;
  if (p.nodes && p.bins) kernel = &walk_kernel<true, true>;
  else if (p.nodes) kernel = &walk_kernel<true, false>;
  else if (p.bins) kernel = &walk_kernel<false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, (size_t)p.smem)) != cudaSuccess)
    return (int)err;
  const long long tiles = (m + kThreads - 1) / kThreads;
  const long long resident = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  const long long grid = tiles < resident ? tiles : resident;
  kernel<<<(unsigned)grid, kThreads, (size_t)p.smem, stream>>>(w);
  return (int)cudaGetLastError();
}

}  // extern "C"
