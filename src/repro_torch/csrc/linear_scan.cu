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
// No atomics and no communication between blocks: the same inputs give the
// same bits on every launch.
//
// Bound on this card: the forward reads a and b and writes h (3*B*T*D*4
// bytes), the backward reads a, h and g and writes da and db (5*B*T*D*4
// bytes), two or three operations an element: bytes bound (3.35 TB/s).
// The walk over t is a chain of dependent steps, but a cheap one (a rounded
// product then a rounded sum, ~8 cycles a step: 32,768 steps take ~0.15 ms
// at ~1.8 GHz against the 0.60 ms bytes bound of [2, 32768, 2560]).  What
// a walk needs to reach the bytes bound is its operands staged far enough
// ahead of it, so both paths below keep the loop's order and differ only in
// how they feed it.
//
// The staged walk (T at least the plan's short-T threshold, D a multiple
// of 4, operands 16-byte aligned).  A block is one warp and owns a tile of
// kTile = 32 consecutive channels of one batch row: lane l walks channel
// d0 + l over t, in order.  The operands stream through shared memory in
// stages of tc time steps (a multiple of kChunk = 32, at most 256): a
// stage holds one [tc, 32] box of each operand, 128 contiguous bytes a
// step.  A ring of `stages` stages is filled by the TMA
// (cp.async.bulk.tensor.3d over a tensor map of the [B, T, D] operand,
// built on the host for each launch, no sync), issued by lane 0 stages - 1
// ahead of the stage the warp walks; each stage has an mbarrier that
// expects the stage's bytes, and the lanes wait on the barrier's phase for
// that use of the slot.  The TMA zero-fills what lies past T and D, and
// the walk never reads it.  A lane takes kChunk steps of a stage into
// registers, then walks them; h (da, db) is written straight from
// registers, a coalesced 128 bytes a step per warp.  The backward walks
// the stages from the last to the first; its h box starts one step back
// (row r holds h_{t0+r-1}; the TMA's zeros at t = -1), so the halo
// h_{t-1} of a stage's first step is in the stage, and a_{t+1} is carried
// in a register from the step before, across stage edges too.
//
// What bounds it, measured on the H100 (tools/linear_scan_sweep.py): with
// fewer tiles than SMs, each tile's own rate, a round trip a stage, so
// the plan takes the longest stages that fit (at [1, 32768, 2560], 80
// tiles: 0.82 ms forward with 32-step stages, 0.38 ms with 256); with more
// tiles than SMs, the memory (~82 % of 3.35 TB/s at the 32k prefill), and
// deeper rings only slowed it (up to 1.5x), so the plan keeps a ring to
// ~40 KB a block there.  kernels/linear_scan.py::scan_plan holds the rule.
// Why the TMA: with cp.async copies of 16 bytes a lane, the same ring of
// 32-step stages ran [2, 32768, 2560] in 1.22 / 1.62 ms (forward /
// backward), the TMA in 0.85 / 1.44 ms.
//
// The short walk (T below the plan's threshold, as decode at T = 1, or a
// D or an alignment the TMA's 16-byte rows do not take): one thread per
// (b, d) channel walks t straight from global memory, consecutive threads
// on consecutive d, several steps' loads in flight.  No staging prologue,
// which at a few steps costs more than it hides.  Both paths are
// bit-equal; kernels/linear_scan.py states the thresholds and the
// measurement behind them.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWalkThreads = 64;   // the short walk: threads a block
constexpr int kTile = 32;          // the staged walk: channels a block (a warp)
constexpr int kChunk = 32;         // steps a lane holds in registers at once
constexpr int kMaxStages = 8;
constexpr int kRingPad = 128;      // the TMA writes to 128-byte aligned boxes

// ---------------------------------------------------------------------------
// the short walk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWalkThreads)
linear_scan_walk_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ h,
                        long long n_ch, long long t_len, long long d) {
  long long ch = (long long)blockIdx.x * kWalkThreads + threadIdx.x;
  if (ch >= n_ch) return;
  long long o = (ch / d) * t_len * d + ch % d;
  float acc = 0.0f;
#pragma unroll 8
  for (long long t = 0; t < t_len; ++t, o += d) {
    acc = __fadd_rn(__fmul_rn(a[o], acc), b[o]);
    h[o] = acc;
  }
}

__global__ void __launch_bounds__(kWalkThreads)
linear_scan_backward_walk_kernel(const float* __restrict__ a,
                                 const float* __restrict__ h,
                                 const float* __restrict__ g,
                                 float* __restrict__ da,
                                 float* __restrict__ db, long long n_ch,
                                 long long t_len, long long d) {
  long long ch = (long long)blockIdx.x * kWalkThreads + threadIdx.x;
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

// ---------------------------------------------------------------------------
// the staged walk: TMA boxes into a ring of shared-memory stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// The one arrival of the barrier's phase, which then completes once `bytes`
// more bytes have landed (the stage's boxes).
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
}

// One [tc, kTile] box of an operand, channels [d0, d0 + kTile) and steps
// [t0, t0 + tc) of batch row bi, into shared memory by the TMA; what lies
// outside [0, D) x [0, T) lands as zeros.  Completes on `bar`.
__device__ __forceinline__ void load_box(float* box, const CUtensorMap& map,
                                         int d0, int t0, int bi,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(box)), "l"(reinterpret_cast<uint64_t>(&map)),
         "r"(d0), "r"(t0), "r"(bi), "r"(smem_addr(bar))
      : "memory");
}

// The tile of block `blockIdx.x`: batch row bi, first channel d0.
struct Tile {
  int bi, d0;
  __device__ explicit Tile(long long d) {
    const long long per_row = (d + kTile - 1) / kTile;
    bi = (int)(blockIdx.x / per_row);
    d0 = (int)(blockIdx.x % per_row) * kTile;
  }
};

// The ring: the dynamic shared memory from its first 128-byte boundary.
__device__ __forceinline__ float* ring_base() {
  extern __shared__ unsigned char dyn[];
  return reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(dyn) + kRingPad - 1) &
      ~(uintptr_t)(kRingPad - 1));
}

// Lane 0 sets up the ring's barriers: one arrival (its own) a phase.
__device__ __forceinline__ void init_ring(uint64_t* bars, int stages) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) bar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
}

// Lane 0 refills a slot the warp has finished reading: order those reads
// (generic proxy) before the TMA's writes (async proxy), then expect the
// stage's bytes.
__device__ __forceinline__ void refill(uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_expect(bar, bytes);
}

// The forward.  A stage is `tc` steps (a multiple of kChunk): one
// [tc, kTile] box of a, then one of b, in slot s % stages of the ring.
__global__ void __launch_bounds__(kTile)
linear_scan_staged_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          float* __restrict__ h, long long t_len,
                          long long d, int tc, int stages) {
  float* ring = ring_base();                      // [stages][2][tc][kTile]
  __shared__ uint64_t bars[kMaxStages];
  const int lane = threadIdx.x;
  const int box = tc * kTile;                     // floats a box
  const Tile tile(d);
  const long long row0 = (long long)tile.bi * t_len;   // row of (bi, t = 0)
  const long long n_st = (t_len + tc - 1) / tc;
  init_ring(bars, stages);

  auto issue = [&](long long s) {                 // stage s into its slot
    if (lane) return;
    const int slot = (int)(s % stages);
    float* dst = ring + slot * 2 * box;
    refill(&bars[slot], 2 * box * sizeof(float));
    load_box(dst, map_a, tile.d0, (int)(s * tc), tile.bi, &bars[slot]);
    load_box(dst + box, map_b, tile.d0, (int)(s * tc), tile.bi, &bars[slot]);
  };

  for (long long s = 0; s < stages - 1 && s < n_st; ++s) issue(s);
  const bool live = tile.d0 + lane < d;
  float* out = h + row0 * d + tile.d0 + lane;
  float acc = 0.0f;
  for (long long s = 0; s < n_st; ++s) {
    if (s + stages - 1 < n_st) issue(s + stages - 1);
    const int slot = (int)(s % stages);
    bar_wait(&bars[slot], (unsigned)((s / stages) & 1));
    const float* sa = ring + slot * 2 * box + lane;
    const float* sb = sa + box;
    float* o = out + s * tc * d;
    const int steps = (int)min((long long)tc, t_len - s * tc);
    if (live) {
      if (steps == tc) {     // kChunk steps' operands into registers first
        for (int c = 0; c < tc; c += kChunk) {
          float va[kChunk], vb[kChunk];
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            va[i] = sa[(c + i) * kTile];
            vb[i] = sb[(c + i) * kTile];
          }
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            acc = __fadd_rn(__fmul_rn(va[i], acc), vb[i]);
            o[(c + i) * d] = acc;
          }
        }
      } else {
        for (int i = 0; i < steps; ++i) {
          acc = __fadd_rn(__fmul_rn(sa[i * kTile], acc), sb[i * kTile]);
          o[i * d] = acc;
        }
      }
    }
    __syncwarp();            // every lane has read the slot before its refill
  }
}

// The backward: boxes of a, g and h (one step back) a stage, the stages
// walked from the last to the first.
__global__ void __launch_bounds__(kTile)
linear_scan_backward_staged_kernel(const __grid_constant__ CUtensorMap map_a,
                                   const __grid_constant__ CUtensorMap map_h,
                                   const __grid_constant__ CUtensorMap map_g,
                                   float* __restrict__ da,
                                   float* __restrict__ db, long long t_len,
                                   long long d, int tc, int stages) {
  float* ring = ring_base();                      // [stages][3][tc][kTile]
  __shared__ uint64_t bars[kMaxStages];
  const int lane = threadIdx.x;
  const int box = tc * kTile;
  const Tile tile(d);
  const long long row0 = (long long)tile.bi * t_len;
  const long long n_st = (t_len + tc - 1) / tc;
  init_ring(bars, stages);

  // The k-th stage walked is time stage n_st - 1 - k: a and g at steps
  // [t0, t0 + tc), h one step earlier (h_{t-1}; the TMA's zeros at -1).
  auto issue = [&](long long k) {
    if (lane) return;
    const int slot = (int)(k % stages);
    const int t0 = (int)((n_st - 1 - k) * tc);
    float* dst = ring + slot * 3 * box;
    refill(&bars[slot], 3 * box * sizeof(float));
    load_box(dst, map_a, tile.d0, t0, tile.bi, &bars[slot]);
    load_box(dst + box, map_g, tile.d0, t0, tile.bi, &bars[slot]);
    load_box(dst + 2 * box, map_h, tile.d0, t0 - 1, tile.bi, &bars[slot]);
  };

  for (long long k = 0; k < stages - 1 && k < n_st; ++k) issue(k);
  const bool live = tile.d0 + lane < d;
  float lam = 0.0f, a_next = 0.0f;
  for (long long k = 0; k < n_st; ++k) {
    if (k + stages - 1 < n_st) issue(k + stages - 1);
    const int slot = (int)(k % stages);
    bar_wait(&bars[slot], (unsigned)((k / stages) & 1));
    const float* sa = ring + slot * 3 * box + lane;
    const float* sg = sa + box;
    const float* sh = sa + 2 * box;
    const long long t0 = (n_st - 1 - k) * tc;
    const long long o0 = (row0 + t0) * d + tile.d0 + lane;
    float* oa = da + o0;
    float* ob = db + o0;
    int i = (int)min((long long)tc, t_len - t0) - 1;
    if (live) {
      if (k == 0) {          // t = T - 1: lam = g, no carried term
        lam = sg[i * kTile];
        a_next = sa[i * kTile];
        ob[i * d] = lam;
        oa[i * d] = __fmul_rn(lam, sh[i * kTile]);
        --i;
      }
      if (i == tc - 1) {
        for (int c = tc - kChunk; c >= 0; c -= kChunk) {
          float va[kChunk], vg[kChunk], vh[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            va[j] = sa[(c + j) * kTile];
            vg[j] = sg[(c + j) * kTile];
            vh[j] = sh[(c + j) * kTile];
          }
#pragma unroll
          for (int j = kChunk - 1; j >= 0; --j) {
            lam = __fadd_rn(vg[j], __fmul_rn(a_next, lam));
            a_next = va[j];
            ob[(c + j) * d] = lam;
            oa[(c + j) * d] = __fmul_rn(lam, vh[j]);
          }
        }
      } else {
        for (int j = i; j >= 0; --j) {
          lam = __fadd_rn(sg[j * kTile], __fmul_rn(a_next, lam));
          a_next = sa[j * kTile];
          ob[j * d] = lam;
          oa[j * d] = __fmul_rn(lam, sh[j * kTile]);
        }
      }
    }
    __syncwarp();
  }
}

// Lift the kernel's dynamic shared-memory cap to the card's opt-in limit
// per block less its static barriers (the plan stays within it), once per
// kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done) {
  constexpr int kDevices = 64;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && done[dev]) return cudaSuccess;
  if ((e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess ||
      (e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           optin - (int)attr.sharedSizeBytes)) != cudaSuccess)
    return e;
  if (dev < kDevices) done[dev] = true;
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, found once through the CUDA runtime's entry-point
// lookup (no link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
#endif
      p = nullptr;
    return (PFN_cuTensorMapEncodeTiled_v12000)p;
  }();
  return fn;
}

// The map of one contiguous f32 [bsz, t_len, d] operand with [tc, kTile]
// boxes (d innermost); zeros outside it.  Host-only, no device call.
bool tensor_map(CUtensorMap* map, const float* p, long long bsz,
                long long t_len, long long d, int tc) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t_len, (cuuint64_t)bsz};
  cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)(t_len * d) * 4};
  cuuint32_t box[3] = {kTile, (cuuint32_t)tc, 1};
  cuuint32_t one[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)p, dims,
                strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bad_shape(long long bsz, long long t_len, long long d) {
  return bsz < 0 || t_len < 0 || d < 0 ||
         (bsz * d + kWalkThreads - 1) / kWalkThreads > 0x7fffffffLL;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Does the plan (kernels/linear_scan.py::scan_plan) fit this kernel and
// these operands?  `boxes`: operands staged (2 forward, 3 backward), each
// of which the TMA reads in 16-byte rows: D a multiple of 4, 16-byte
// aligned, B, T and D in the box coordinates' int32; a stage of tc steps,
// whole chunks of kChunk and at most the TMA's 256 rows a box.
bool bad_plan(long long bsz, long long t_len, long long d, int staged,
              int tc, int stages, long long smem, long long grid, int boxes,
              const float* const* staged_ptrs) {
  if (!staged)
    return tc != 0 || stages != 0 || smem != 0 ||
           grid != (bsz * d + kWalkThreads - 1) / kWalkThreads;
  for (int i = 0; i < boxes; ++i)
    if (!aligned16(staged_ptrs[i])) return true;
  return tc < kChunk || tc > 256 || tc % kChunk || stages < 1 ||
         stages > kMaxStages || d % 4 ||
         smem != (long long)stages * boxes * tc * kTile * 4 + kRingPad ||
         grid != bsz * ((d + kTile - 1) / kTile) || grid > 0x7fffffffLL ||
         t_len > 0x7fffffffLL - 256 || bsz > 0x7fffffffLL ||
         d > 0x7fffffffLL;
}

}  // namespace

// h = linear_scan(a, b) on contiguous f32 [bsz, t_len, d] by the launch
// plan (staged, tc, stages, smem, grid) of kernels/linear_scan.py; a launch
// on `stream`, no host sync.  Returns the launch's CUDA error code
// (cudaErrorInvalidValue for a shape or plan it does not take).
extern "C" int udt_linear_scan(const float* a, const float* b, float* h,
                               long long bsz, long long t_len, long long d,
                               int staged, int tc, int stages, long long smem,
                               long long grid, void* stream) {
  const float* boxed[2] = {a, b};
  if (bad_shape(bsz, t_len, d) ||
      bad_plan(bsz, t_len, d, staged, tc, stages, smem, grid, 2, boxed))
    return (int)cudaErrorInvalidValue;
  if (bsz * d == 0 || t_len == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (!staged) {
    linear_scan_walk_kernel<<<(unsigned)grid, kWalkThreads, 0, st>>>(
        a, b, h, bsz * d, t_len, d);
    return (int)cudaGetLastError();
  }
  static bool done[64] = {};
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, bsz, t_len, d, tc) ||
      !tensor_map(&map_b, b, bsz, t_len, d, tc))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = allow_smem(linear_scan_staged_kernel, done))
    return (int)e;
  linear_scan_staged_kernel<<<(unsigned)grid, kTile, smem, st>>>(
      map_a, map_b, h, t_len, d, tc, stages);
  return (int)cudaGetLastError();
}

// (da, db) of linear_scan's backward from a, its output h and the output's
// gradient g, all contiguous f32 [bsz, t_len, d], by the backward's plan.
extern "C" int udt_linear_scan_backward(const float* a, const float* h,
                                        const float* g, float* da, float* db,
                                        long long bsz, long long t_len,
                                        long long d, int staged, int tc,
                                        int stages, long long smem,
                                        long long grid, void* stream) {
  const float* boxed[3] = {a, h, g};
  if (bad_shape(bsz, t_len, d) ||
      bad_plan(bsz, t_len, d, staged, tc, stages, smem, grid, 3, boxed))
    return (int)cudaErrorInvalidValue;
  if (bsz * d == 0 || t_len == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (!staged) {
    linear_scan_backward_walk_kernel<<<(unsigned)grid, kWalkThreads, 0, st>>>(
        a, h, g, da, db, bsz * d, t_len, d);
    return (int)cudaGetLastError();
  }
  static bool done[64] = {};
  CUtensorMap map_a, map_h, map_g;
  if (!tensor_map(&map_a, a, bsz, t_len, d, tc) ||
      !tensor_map(&map_h, h, bsz, t_len, d, tc) ||
      !tensor_map(&map_g, g, bsz, t_len, d, tc))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = allow_smem(linear_scan_backward_staged_kernel, done))
    return (int)e;
  linear_scan_backward_staged_kernel<<<(unsigned)grid, kTile, smem, st>>>(
      map_a, map_h, map_g, da, db, t_len, d, tc, stages);
  return (int)cudaGetLastError();
}
