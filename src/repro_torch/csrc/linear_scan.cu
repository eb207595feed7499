// The linear recurrence h_t = a_t * h_{t-1} + b_t and its backward,
// hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence with
// `jax.lax.associative_scan` (src/repro/models/rglru.py:24-31,
// `_scan_linear_recurrence`, the RG-LRU; src/repro/models/xlstm.py:162-163,
// the sLSTM's two scans), which XLA lowers on the TPU.  Without a kernel
// the port ran it as a per-position loop of torch ops, three a position
// forward and an O(T^2)-byte backward.  Contiguous f32 [B, T, D]:
//
//   forward   h_t = a_t * h_{t-1} + b_t,            h_{-1} = 0
//   backward  lam_{T-1} = g_{T-1},  lam_t = g_t + a_{t+1} * lam_{t+1}
//             db_t = lam_t,  da_t = lam_t * h_{t-1}  (h_{-1} = 0)
//
// Every product and sum is one rounded operation in the order written
// (__fmul_rn / __fadd_rn, which are never contracted into a multiply-add),
// so the kernels give the per-position loop's values bit for bit, and
// autograd's through that loop (kernels/linear_scan.py's plain versions).
// No atomics: the same inputs give the same bits on every launch.
//
// Design: one thread per (b, d) channel walks t in order; consecutive
// threads take consecutive d, so every load and store of a step is
// coalesced.  The loads of a step do not depend on the carried value, so
// the unrolled loop keeps several steps' loads in flight.
//
// Bound on this card: the forward reads a and b and writes h (3*B*T*D*4
// bytes), the backward reads a, h and g and writes da and db (5*B*T*D*4
// bytes), two operations an element: bytes bound (3.35 TB/s).  But the
// walk over t is a chain of dependent steps, and at the LM's shapes there
// are few channels (8 x 1,536 = 12,288 threads, ~3 warps an SM), so the
// kernel is bound by the latency of one channel's steps, not by bytes.
// A time-chunked two-pass scan (chunk aggregates, a pass over chunks, a
// fix-up) is the redesign that would fill the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, long long n_ch, long long t_len,
                   long long d) {
  long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= n_ch) return;
  long long o = (ch / d) * t_len * d + ch % d;
  float acc = 0.0f;
#pragma unroll 8
  for (long long t = 0; t < t_len; ++t, o += d) {
    acc = __fadd_rn(__fmul_rn(a[o], acc), b[o]);
    h[o] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
linear_scan_backward_kernel(const float* __restrict__ a,
                            const float* __restrict__ h,
                            const float* __restrict__ g,
                            float* __restrict__ da, float* __restrict__ db,
                            long long n_ch, long long t_len, long long d) {
  long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= n_ch) return;
  long long o = (ch / d) * t_len * d + ch % d + (t_len - 1) * d;
  float lam = g[o];
  float a_next = a[o];
  db[o] = lam;
  da[o] = __fmul_rn(lam, t_len > 1 ? h[o - d] : 0.0f);
#pragma unroll 8
  for (long long t = t_len - 2; t >= 0; --t) {
    o -= d;
    lam = __fadd_rn(g[o], __fmul_rn(a_next, lam));
    a_next = a[o];
    db[o] = lam;
    da[o] = __fmul_rn(lam, t > 0 ? h[o - d] : 0.0f);
  }
}

unsigned blocks_of(long long n_ch) {
  return (unsigned)((n_ch + kThreads - 1) / kThreads);
}

bool bad_shape(long long bsz, long long t_len, long long d) {
  return bsz < 0 || t_len < 0 || d < 0 ||
         (bsz * d + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

// h = linear_scan(a, b) on contiguous f32 [bsz, t_len, d]; a launch on
// `stream`, no host sync.  Returns the launch's CUDA error code.
extern "C" int udt_linear_scan(const float* a, const float* b, float* h,
                               long long bsz, long long t_len, long long d,
                               void* stream) {
  if (bad_shape(bsz, t_len, d)) return (int)cudaErrorInvalidValue;
  long long n_ch = bsz * d;
  if (n_ch == 0 || t_len == 0) return 0;
  linear_scan_kernel<<<blocks_of(n_ch), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, h, n_ch, t_len, d);
  return (int)cudaGetLastError();
}

// (da, db) of linear_scan's backward from a, its output h and the output's
// gradient g, all contiguous f32 [bsz, t_len, d].
extern "C" int udt_linear_scan_backward(const float* a, const float* h,
                                        const float* g, float* da, float* db,
                                        long long bsz, long long t_len,
                                        long long d, void* stream) {
  if (bad_shape(bsz, t_len, d)) return (int)cudaErrorInvalidValue;
  long long n_ch = bsz * d;
  if (n_ch == 0 || t_len == 0) return 0;
  linear_scan_backward_kernel<<<blocks_of(n_ch), kThreads, 0,
                                (cudaStream_t)stream>>>(a, h, g, da, db, n_ch,
                                                        t_len, d);
  return (int)cudaGetLastError();
}
