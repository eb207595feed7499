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
//   scores NEG_INF; the first strict maximum in the order op*B + bin wins.
// Outputs score [S,K] f32, bin [S,K] i32, op [S,K] i32.  The cross-feature
// argmax stays in core/split.py::best_splits_kernel.
//
// The heuristics evaluate the formulas of core/heuristics.py in the same
// operation order (the same `> 0` guards, logf and not __logf), and the
// library is built with --fmad=false so no multiply-add is contracted.
//
// Design (the simple, right one): one thread per (slot, feature); it walks
// the B bins in order with the running prefix of the C channels in
// registers (C is a template constant for the common 2, 3 and 5 channels,
// a bounded local array otherwise).  A first pass sums tot and tot_num.
//
// Bound on this card: it reads S*K*B*C*4 B once and writes S*K*12 B, and
// does about 3*S*K*B*(10*C) flops (logf counted as one), so against 3.35
// TB/s and 67 TFLOP/s fp32 it is memory-bound at the main path's shapes.
// With one thread per (slot, feature) a narrow level (S = 16, K = 41) runs
// 656 threads, each a long serial chain of logf: latency, not bytes, bounds
// it today, and neighbouring threads read blocks B*C*4 bytes apart.  A warp
// per (slot, feature) with a warp scan over the bins is the later fix.
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

// CT > 0: C is the compile-time constant CT; CT == 0: C = c_rt <= kMaxC.
template <int CT>
__global__ void split_scan_kernel(const float* __restrict__ hist,
                                  const int* __restrict__ n_num,
                                  const int* __restrict__ n_cat,
                                  float* __restrict__ score_out,
                                  int* __restrict__ bin_out,
                                  int* __restrict__ op_out, int s_k, int k,
                                  int n_bins, int c_rt, int h,
                                  float min_leaf) {
  constexpr int CM = CT > 0 ? CT : kMaxC;
  const int c = CT > 0 ? CT : c_rt;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s_k) return;
  int f = t % k;
  int nn = n_num[f];
  int nc = n_cat[f];
  const float* blk = hist + (long long)t * n_bins * c;   // [B, C]

  float tot[CM], tot_num[CM], prefix[CM], pos[CM], neg[CM];
#pragma unroll
  for (int i = 0; i < CM; ++i) { tot[i] = 0.0f; tot_num[i] = 0.0f; prefix[i] = 0.0f; }
  for (int b = 0; b < n_bins; ++b) {
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (i < c) {
        float v = blk[b * c + i];
        tot[i] += v;
        if (b < nn) tot_num[i] += v;
      }
    }
  }

  float best[3] = {-INFINITY, -INFINITY, -INFINITY};
  int best_bin[3] = {0, 0, 0};
  for (int b = 0; b < n_bins; ++b) {
    bool is_num = b < nn;
    bool is_cat = b >= nn && b < nn + nc;
#pragma unroll
    for (int i = 0; i < CM; ++i)
      if (i < c && is_num) prefix[i] += blk[b * c + i];
#pragma unroll
    for (int op = 0; op < 3; ++op) {
      bool valid = op == 2 ? is_cat : is_num;
      float sc = kNegInf;
      if (valid) {
        float cp = 0.0f, cn = 0.0f;
#pragma unroll
        for (int i = 0; i < CM; ++i) {
          if (i < c) {
            float p = op == 0 ? prefix[i]
                    : op == 1 ? tot_num[i] - prefix[i]
                              : blk[b * c + i];
            pos[i] = p;
            neg[i] = tot[i] - p;
            if (h != kSse) { cp += pos[i]; cn += neg[i]; }
          }
        }
        if (h == kSse) { cp = pos[0]; cn = neg[0]; }
        if (cp >= min_leaf && cn >= min_leaf)
          sc = heuristic_score<CM>(h, pos, neg, c);
      }
      if (sc > best[op]) { best[op] = sc; best_bin[op] = b; }
    }
  }
  // op-major first maximum over the flat [3, B]
  float s_best = best[0];
  int b_best = best_bin[0], o_best = 0;
  if (best[1] > s_best) { s_best = best[1]; b_best = best_bin[1]; o_best = 1; }
  if (best[2] > s_best) { s_best = best[2]; b_best = best_bin[2]; o_best = 2; }
  score_out[t] = s_best;
  bin_out[t] = b_best;
  op_out[t] = o_best;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int udt_split_scan(const float* hist, const int* n_num,
                              const int* n_cat, float* score, int* bin,
                              int* op, int s, int k, int n_bins, int c,
                              int heuristic, float min_leaf, void* stream) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  int s_k = s * k;
  unsigned blocks = (unsigned)((s_k + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 2:
      split_scan_kernel<2><<<blocks, kThreads, 0, st>>>(
          hist, n_num, n_cat, score, bin, op, s_k, k, n_bins, c, heuristic, min_leaf);
      break;
    case 3:
      split_scan_kernel<3><<<blocks, kThreads, 0, st>>>(
          hist, n_num, n_cat, score, bin, op, s_k, k, n_bins, c, heuristic, min_leaf);
      break;
    case 5:
      split_scan_kernel<5><<<blocks, kThreads, 0, st>>>(
          hist, n_num, n_cat, score, bin, op, s_k, k, n_bins, c, heuristic, min_leaf);
      break;
    default:
      split_scan_kernel<0><<<blocks, kThreads, 0, st>>>(
          hist, n_num, n_cat, score, bin, op, s_k, k, n_bins, c, heuristic, min_leaf);
  }
  return (int)cudaGetLastError();
}
