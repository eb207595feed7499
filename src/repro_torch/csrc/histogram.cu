// Kernel A: node / feature / bin histogram, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `histogram_pallas` (body `_hist_kernel`) in
// src/repro/kernels/histogram.py.  That kernel turns the scatter into a
// one-hot x stats product on the MXU only because a TPU has no atomics.
// Hopper has them, so this file ports WHAT the kernel computes, not its
// blocks:
//
//   for every row i whose slot (after the optional slot_map remap, where -1
//   drops the row) lies in [0, num_slots), and every feature k:
//       H[slot, k, bins[i,k], :] += w[i] * stats[i, :]
//
// Design (the simple, right one): one thread per (row, feature) pair, the
// feature index fastest so the [M, K] bin reads are coalesced; each thread
// atomicAdds its C values into H in device memory.  Zero values are not
// added (x + 0 == x for every x the sum can hold, since H starts at +0), so
// one-hot class rows cost one atomic per (row, feature) instead of C.  The
// wrapper zero-fills H and allocates every output; the kernels allocate
// nothing.
//
// Fused sibling mode is a second launch, `sibling_epilogue_kernel`: it reads
// the packed smaller-child block and the parent rows and writes the
// interleaved [2P, K, B, C] child block (side[j] != 0: the computed child is
// the left slot), the layout of kernels/ref.py::sibling_ref.
//
// Bound on this card, per level chunk: about M*K*4 B of bins plus
// M*(C+2)*4 B of stats, slot and weight read, plus S*K*B*C*4 B of H written
// (the fused mode also reads P*K*B*C*4 B of parent rows and writes twice
// that), against 3.35 TB/s of HBM: a memory-bound pass.  The design reads
// each input once and coalesced; what it does not yet address is atomic
// contention where many rows share one (slot, bin), and the H traffic goes
// through L2 atomics rather than shared memory -- both later work.
//
// Class-count channels are integers in f32, so any summation order gives
// the same H below 2**24 rows.  Float channels (moments, weighted rows) are
// summed in the order the atomics land, which varies from run to run.
#include <cuda_runtime.h>

namespace {

__global__ void hist_scatter_kernel(const int* __restrict__ bins,
                                    const float* __restrict__ stats,
                                    const int* __restrict__ slot,
                                    const float* __restrict__ weights,
                                    const int* __restrict__ slot_map,
                                    int n_in, float* __restrict__ out,
                                    long long m, int k, int c,
                                    int num_slots, int n_bins) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * k) return;
  long long i = t / k;
  int f = (int)(t - i * k);
  int s = slot[i];
  if (slot_map != nullptr) s = (s >= 0 && s < n_in) ? slot_map[s] : -1;
  if (s < 0 || s >= num_slots) return;
  int b = bins[t];
  if (b < 0 || b >= n_bins) return;   // never written outside H
  float* dst = out + (((long long)s * k + f) * n_bins + b) * c;
  const float* src = stats + i * c;
  if (weights != nullptr) {
    float w = weights[i];
    for (int ch = 0; ch < c; ++ch) {
      float v = src[ch] * w;
      if (v != 0.0f) atomicAdd(dst + ch, v);
    }
  } else {
    for (int ch = 0; ch < c; ++ch) {
      float v = src[ch];
      if (v != 0.0f) atomicAdd(dst + ch, v);
    }
  }
}

__global__ void sibling_epilogue_kernel(const float* __restrict__ small,
                                        const float* __restrict__ phist,
                                        const int* __restrict__ side,
                                        float* __restrict__ out,
                                        long long pairs, long long kbc) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * pairs * kbc) return;
  long long j = t / (2 * kbc);
  long long r = t - j * 2 * kbc;
  bool right = r >= kbc;
  long long e = j * kbc + (right ? r - kbc : r);
  float sm = small[e];
  float derived = phist[e] - sm;
  bool small_is_left = side[j] != 0;
  out[t] = (small_is_left != right) ? sm : derived;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int udt_histogram(const int* bins, const float* stats,
                             const int* slot, const float* weights,
                             const int* slot_map, int n_in, float* out,
                             long long m, int k, int c, int num_slots,
                             int n_bins, void* stream) {
  long long n = m * k;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  hist_scatter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      bins, stats, slot, weights, slot_map, n_in, out, m, k, c, num_slots,
      n_bins);
  return (int)cudaGetLastError();
}

extern "C" int udt_sibling_epilogue(const float* small, const float* phist,
                                    const int* side, float* out,
                                    long long pairs, long long kbc,
                                    void* stream) {
  long long n = 2 * pairs * kbc;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  sibling_epilogue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      small, phist, side, out, pairs, kbc);
  return (int)cudaGetLastError();
}

extern "C" const char* udt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
