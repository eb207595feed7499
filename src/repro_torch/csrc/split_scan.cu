// Kernel B: fused prefix-sum -> heuristic -> argmax split scan, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `split_scan_pallas` (body `_scan_kernel`) in
// src/repro/kernels/split_scan.py.  One result per (slot, feature) of
// hist [S, K, B, C]:
//   tot     = sum over all bins
//   prefix  = running sum over the numeric bins (b < n_num[k])
//   three candidate families, for every bin b:
//     "<=" pos = prefix[b]            valid b < n_num
//     ">"  pos = tot_num - prefix[b]  valid b < n_num
//     "="  pos = hist[b]              valid n_num <= b < n_num + n_cat
//   neg = tot - pos; a side's count is channel 0 for "sse", the channel
//   sum otherwise; a candidate below min_leaf on either side, or invalid,
//   scores NEG_INF; the first maximum in the order op*B + bin wins.
// Outputs score [S,K] f32, bin [S,K] i32, op [S,K] i32.  The cross-feature
// argmax stays in core/split.py::best_splits_kernel.
//
// The heuristics evaluate the formulas of core/heuristics.py in the same
// operation order (the same `> 0` guards, logf and not __logf), and the
// library is built with --fmad=false so no multiply-add is contracted.
//
// Design: one block of kThreads (two warps) per (slot, feature); of 32,
// 64, 128 and 256 threads a block, 64 timed best on the H100 over both the
// main path's widest chunk and a narrow level.
//   1. The [B, C] block is copied into shared memory with 16-byte loads
//      (a scalar head and tail where B*C*4 is not a multiple of 16), so a
//      warp reads contiguous bytes.  A block wider than kSmemLimit works in
//      a global scratch slice of the same layout instead.
//   2. Thread j owns bins [j*bpt, (j+1)*bpt): it sums them per channel, a
//      warp scan (shuffles) and the per-warp totals give each thread its
//      exclusive prefix, and it overwrites its numeric bins with their
//      inclusive prefix in place (the "=" family reads only the raw
//      categorical bins, which stay).  The numeric bins are the first
//      n_num bins, so one scan over all bins gives prefix, tot_num (the
//      prefix at n_num - 1) and tot (the sum of the warp totals).
//   3. The 2*n_num + n_cat valid candidates, enumerated in flat order
//      op*B + bin, are dealt round-robin over the threads, so a feature
//      with few numeric bins does not leave work on a few threads.
//   4. Block argmax on (score, flat index): the larger score wins, on equal
//      scores the smaller index -- the reference's first maximum over the
//      flat [3, B].  Every thread starts from (NEG_INF, first invalid
//      index), the entry the flat argmax returns when no candidate beats
//      NEG_INF.
// On integer-valued channels the scan order cannot change a prefix, so the
// scores equal the one-thread-per-(slot, feature) walk's bit for bit; on
// float channels the tree-ordered sums round differently (rtol 1e-5).
//
// Bound on this card: it reads S*K*B*C*4 B once and writes S*K*12 B, and
// scores about (2*n_num + n_cat) candidates per (slot, feature), each a
// chain of C-proportional precise logf (info_gain) or divisions.  At the
// main path's widest chunk (S = 1272, K = 41, B = 257, C = 5) the 268 MB
// read (0.08 ms) and the logf arithmetic are of one order, and a block's
// copy, scan and argmax run one after the other; at a narrow level
// (S = 16) the 656 blocks of one short scan each are bound by the launch
// and one block's latency, below the host's cost of a call.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -3.4e38f;
constexpr int kMaxC = 32;
enum { kInfoGain = 0, kGini = 1, kChiSquare = 2, kSse = 3 };

__device__ __forceinline__ float safe_log(float x) {
  return logf(x > 0.0f ? x : 1.0f);
}

template <int CM>
__device__ __forceinline__ float heuristic_score(int h, const float* pos, const float* neg,
                                 int c) {
  if (h == kSse) {
    float cp = pos[0], sp = pos[1], cn = neg[0], sn = neg[1];
    float a = sp * sp / (cp > 0.0f ? cp : 1.0f);
    float b = sn * sn / (cn > 0.0f ? cn : 1.0f);
    return a + b;
  }
  float tp = 0.0f, tn = 0.0f;
#pragma unroll
  for (int i = 0; i < CM; ++i) if (i < c) tp += pos[i];
#pragma unroll
  for (int i = 0; i < CM; ++i) if (i < c) tn += neg[i];
  if (h == kInfoGain) {
    float tot = tp + tn;
    tot = tot > 0.0f ? tot : 1.0f;
    float ltp = safe_log(tp), ltn = safe_log(tn);
    float sp = 0.0f, sn = 0.0f;
#pragma unroll
    for (int i = 0; i < CM; ++i)
      if (i < c) sp += pos[i] > 0.0f ? pos[i] * (safe_log(pos[i]) - ltp) : 0.0f;
#pragma unroll
    for (int i = 0; i < CM; ++i)
      if (i < c) sn += neg[i] > 0.0f ? neg[i] * (safe_log(neg[i]) - ltn) : 0.0f;
    return (sp + sn) / tot;
  }
  if (h == kGini) {
    float tot = tp + tn > 0.0f ? tp + tn : 1.0f;
    float qp = 0.0f, qn = 0.0f;
#pragma unroll
    for (int i = 0; i < CM; ++i) if (i < c) qp += pos[i] * pos[i];
#pragma unroll
    for (int i = 0; i < CM; ++i) if (i < c) qn += neg[i] * neg[i];
    float sp = qp / (tp > 0.0f ? tp : 1.0f);
    float sn = qn / (tn > 0.0f ? tn : 1.0f);
    return (sp + sn) / tot;
  }
  // chi-square
  float tot = tp + tn > 0.0f ? tp + tn : 1.0f;
  float dp = 0.0f, dn = 0.0f;
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    if (i < c) {
      float col = pos[i] + neg[i];
      float ep = tp * col / tot;
      float en = tn * col / tot;
      float d = pos[i] - ep;
      float e = neg[i] - en;
      dp += ep > 0.0f ? d * d / (ep > 0.0f ? ep : 1.0f) : 0.0f;
      dn += en > 0.0f ? e * e / (en > 0.0f ? en : 1.0f) : 0.0f;
    }
  }
  return dp + dn;
}

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a block may take (the H100 allows 227 KB)
constexpr int kSmemLimit = 200 * 1024;

// (score, flat index) pair order: larger score, then smaller index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// CT > 0: C is the compile-time constant CT; CT == 0: C = c_rt <= kMaxC.
// ``scratch`` != nullptr: the block's [B, C] slice lives there, not in
// shared memory.
template <int CT>
__global__ void __launch_bounds__(kThreads)
split_scan_kernel(const float* __restrict__ hist,
                  const int* __restrict__ n_num,
                  const int* __restrict__ n_cat,
                  float* __restrict__ score_out, int* __restrict__ bin_out,
                  int* __restrict__ op_out, float* __restrict__ scratch,
                  int k, int n_bins, int c_rt, int h, float min_leaf) {
  constexpr int CM = CT > 0 ? CT : kMaxC;
  const int c = CT > 0 ? CT : c_rt;
  extern __shared__ float4 smem4[];
  __shared__ float warp_tot[kWarps][CM];
  __shared__ float tot_num_s[CM];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];

  const long long t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = (int)(t % k);
  const int bc = n_bins * c;
  const float* src = hist + t * bc;
  float* blk = scratch != nullptr ? scratch + t * bc
                                  : reinterpret_cast<float*>(smem4);
  const int nn = min(max(n_num[f], 0), n_bins);
  const int cat_hi = min(max(n_num[f] + n_cat[f], nn), n_bins);

  // 1. copy the block: scalar head up to 16-byte alignment, float4 body,
  //    scalar tail
  int head = (int)(((16 - ((unsigned long long)src & 15)) & 15) >> 2);
  head = min(head, bc);
  const int nvec = (bc - head) >> 2;
  for (int i = tid; i < head; i += kThreads) blk[i] = src[i];
  const float4* v4 = reinterpret_cast<const float4*>(src + head);
  for (int i = tid; i < nvec; i += kThreads) {
    float4 x = __ldg(v4 + i);
    float* d = blk + head + 4 * i;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  for (int i = head + 4 * nvec + tid; i < bc; i += kThreads) blk[i] = src[i];
  if (nn == 0 && tid < c) tot_num_s[tid] = 0.0f;
  __syncthreads();

  // 2. per-thread sums of its bins, then the block's exclusive scan
  const int bpt = (n_bins + kThreads - 1) / kThreads;
  const int lo = min(n_bins, tid * bpt), hi = min(n_bins, lo + bpt);
  float run[CM], tot[CM], tot_num[CM];
#pragma unroll
  for (int i = 0; i < CM; ++i) run[i] = 0.0f;
  for (int b = lo; b < hi; ++b) {
#pragma unroll
    for (int i = 0; i < CM; ++i) if (i < c) run[i] += blk[b * c + i];
  }
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    if (i < c) {
      float incl = run[i];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        float y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      run[i] = lane == 0 ? 0.0f : excl;
      if (lane == 31) warp_tot[warp][i] = incl;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    if (i < c) {
      float base = 0.0f, all = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) base += warp_tot[w][i];
        all += warp_tot[w][i];
      }
      tot[i] = all;
      run[i] = base + run[i];
    }
  }
  // numeric bins become their inclusive prefix; the thread holding bin
  // n_num - 1 publishes tot_num
  for (int b = lo; b < min(hi, nn); ++b) {
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (i < c) {
        run[i] += blk[b * c + i];
        blk[b * c + i] = run[i];
        if (b == nn - 1) tot_num_s[i] = run[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < CM; ++i) if (i < c) tot_num[i] = tot_num_s[i];

  // 3. score the valid candidates, flat order op*B + bin
  float best = kNegInf;
  int best_i = nn < n_bins ? nn : 2 * n_bins;     // first invalid entry
  const int n_cand = 2 * nn + (cat_hi - nn);
  float pos[CM], neg[CM];
  for (int q = tid; q < n_cand; q += kThreads) {
    int op, b;
    if (q < nn) { op = 0; b = q; }
    else if (q < 2 * nn) { op = 1; b = q - nn; }
    else { op = 2; b = q - nn; }                   // nn + (q - 2*nn)
    const float* hb = blk + b * c;
    float cp = 0.0f, cn = 0.0f;
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (i < c) {
        float p = op == 0 ? hb[i] : op == 1 ? tot_num[i] - hb[i] : hb[i];
        pos[i] = p;
        neg[i] = tot[i] - p;
        if (h != kSse) { cp += pos[i]; cn += neg[i]; }
      }
    }
    if (h == kSse) { cp = pos[0]; cn = neg[0]; }
    float sc = kNegInf;
    if (cp >= min_leaf && cn >= min_leaf)
      sc = heuristic_score<CM>(h, pos, neg, c);
    int idx = op * n_bins + b;
    if (better(sc, idx, best, best_i)) { best = sc; best_i = idx; }
  }

  // 4. block argmax with the first-maximum tie rule
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    float os = __shfl_xor_sync(0xffffffffu, best, d);
    int oi = __shfl_xor_sync(0xffffffffu, best_i, d);
    if (better(os, oi, best, best_i)) { best = os; best_i = oi; }
  }
  if (lane == 0) { red_s[warp] = best; red_i[warp] = best_i; }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(red_s[w], red_i[w], best, best_i)) {
        best = red_s[w];
        best_i = red_i[w];
      }
    score_out[t] = best;
    bin_out[t] = best_i % n_bins;
    op_out[t] = best_i / n_bins;
  }
}

// Dynamic shared memory of a block whose [B, C] block sits in shared
// memory.
size_t block_smem(int n_bins, int c) {
  return (size_t)n_bins * c * sizeof(float);
}

template <int CT>
cudaError_t launch(const float* hist, const int* n_num, const int* n_cat,
                   float* score, int* bin, int* op, float* scratch,
                   long long s_k, int k, int n_bins, int c, int h,
                   float min_leaf, cudaStream_t st) {
  size_t smem = scratch != nullptr ? 0 : block_smem(n_bins, c);
  if (smem > 48 * 1024) {     // above the default, opt in for this launch
    cudaError_t e = cudaFuncSetAttribute(
        split_scan_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  split_scan_kernel<CT><<<(unsigned)s_k, kThreads, smem, st>>>(
      hist, n_num, n_cat, score, bin, op, scratch, k, n_bins, c, h, min_leaf);
  return cudaGetLastError();
}

}  // namespace

// Floats of global scratch the scan needs: 0 when a [B, C] block fits in
// shared memory, else one block's worth per (slot, feature).
extern "C" long long udt_split_scan_scratch(int s, int k, int n_bins, int c) {
  long long bc = (long long)n_bins * c;
  return bc * (long long)sizeof(float) <= kSmemLimit ? 0
                                                     : (long long)s * k * bc;
}

// Dynamic shared memory of each block of a udt_split_scan launch at these
// widths (0 when the [B, C] block works in global scratch).
extern "C" long long udt_split_scan_smem(int s, int k, int n_bins, int c) {
  return udt_split_scan_scratch(s, k, n_bins, c) > 0
             ? 0 : (long long)block_smem(n_bins, c);
}

extern "C" int udt_split_scan(const float* hist, const int* n_num,
                              const int* n_cat, float* score, int* bin,
                              int* op, float* scratch, int s, int k,
                              int n_bins, int c, int heuristic,
                              float min_leaf, void* stream) {
  if (c < 1 || c > kMaxC || n_bins < 1) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr && udt_split_scan_scratch(s, k, n_bins, c) > 0)
    return (int)cudaErrorInvalidValue;
  long long s_k = (long long)s * k;
  if (s_k == 0) return 0;
  if (s_k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (c) {
    case 2: e = launch<2>(hist, n_num, n_cat, score, bin, op, scratch, s_k, k,
                          n_bins, c, heuristic, min_leaf, st); break;
    case 3: e = launch<3>(hist, n_num, n_cat, score, bin, op, scratch, s_k, k,
                          n_bins, c, heuristic, min_leaf, st); break;
    case 5: e = launch<5>(hist, n_num, n_cat, score, bin, op, scratch, s_k, k,
                          n_bins, c, heuristic, min_leaf, st); break;
    default: e = launch<0>(hist, n_num, n_cat, score, bin, op, scratch, s_k,
                           k, n_bins, c, heuristic, min_leaf, st);
  }
  return (int)e;
}
