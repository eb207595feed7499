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
// Design: group the rows by slot, then build each slot's histogram in
// shared memory and write every output cell once.
//   1. Counting sort of the row ids by (remapped) slot: `count_kernel`
//      counts rows per slot; `plan_kernel` (one block) picks the rows per
//      chunk for this launch (about one wave of tile blocks, at least
//      kMinChunkRows, at most kMaxPartials partials), scans the counts
//      into row offsets and cuts every slot into chunks (an empty slot
//      still gets one, so that its zeros are written); `scatter_kernel`
//      writes the row ids.  Both row passes aggregate per warp
//      (__match_any_sync) and per block in shared memory, so one slot
//      holding every row (the root) costs one global atomic per block.
//   2. `tile_kernel`: a block owns one chunk x one tile of features (and of
//      bins, where one feature's [B, C] does not fit) whose [F, B, C]
//      histogram sits in shared memory (72 KB at K = 41, B = 257, C = 5:
//      14 features, three blocks an SM).  It gathers its rows' bins (a
//      row's features are contiguous, so neighbouring threads read
//      neighbouring features of one row) and stats, and adds them with
//      shared-memory atomics; zero values are skipped.  Then it writes the
//      tile to device memory, coalesced: as the final block when its slot
//      has one chunk, else as a partial (chunk 0 into the output, later
//      chunks into scratch).
//   3. `merge_kernel` sums the partials of every multi-chunk slot in chunk
//      order and writes the final block.
//   Fused sibling mode writes the interleaved pair block directly: `small`
//   on the computed side, `phist - small` on the other (side[j] != 0: the
//   computed child is the left slot), the layout of
//   kernels/ref.py::sibling_ref.  Every output cell is written exactly
//   once by the last pass that touches it, so the wrapper allocates the
//   output with torch.empty; the kernels allocate nothing (the wrapper
//   passes an int workspace and a float scratch sized by
//   udt_histogram_workspace).
//
// Integer accumulation: on this card a float atomicAdd to shared memory is
// a compare-and-swap loop, an int one is a native instruction.
// `count_kernel` checks whether every value the launch adds (w[i] *
// stats[i, c] of a kept row) is an integer no larger than int_bound (so
// that no int32 sum of M of them overflows, and each is exact in f32);
// class counts and integer weights are.  Then the tiles accumulate in int
// and convert once at the flush -- the same sums, exactly.  Otherwise they
// accumulate in float.
//
// Explicit drops, as JAX drops out-of-range scatter targets: slot -1,
// slots past num_slots after the remap, bins outside [0, n_bins).
//
// Bound on this card, per level chunk: the slots read, about M*K*4 B of
// bins plus M*(C+1)*4 B of stats and weight for the rows that land, plus
// S*K*B*C*4 B of H written once (the fused mode also reads the P*K*B*C*4
// B parent rows and writes twice that), against 3.35 TB/s of HBM: a
// memory-bound pass.  On top of it the design reads the slots twice and
// the stats once more, moves the row ids, and writes and reads the
// partial tiles of slots split over several chunks.  What it does not
// reach is the bound's gather rate: a row's bins are read as 56-byte
// pieces at random rows, and a block's gather, atomics and flush run one
// after the other.
//
// Class-count channels are integers in f32, so any summation order gives
// the same H below 2**24 rows.  Float channels (moments, float weights) are
// merged across chunks in a fixed order, but inside a block they are summed
// in the order the shared-memory atomics land, which varies from run to
// run: not run-to-run deterministic.
#include <cuda_runtime.h>

namespace {

// rows a tile block accumulates: chosen per launch by plan_kernel so that
// the tile grid fills about one wave of the card, at least kMinChunkRows
// and large enough that no launch needs more than kMaxPartials partials
constexpr int kMinChunkRows = 512;
constexpr int kMaxPartials = 128;
constexpr int kTileBytes = 72 * 1024; // target shared tile of a block
constexpr int kSmemLimit = 200 * 1024;
constexpr int kTileThreads = 512;
constexpr int kUnroll = 4;            // rows a tile thread loads at once
constexpr int kSortThreads = 256;
constexpr int kSortRowsPerThread = 16;
constexpr int kSortRows = kSortThreads * kSortRowsPerThread;
constexpr int kSlotWindow = 4096;     // slots a sort block counts at once
constexpr int kPlanThreads = 1024;
constexpr int kMergeThreads = 256;
constexpr int kMergeSlotsInFlight = 16;

struct Plan {
  // int workspace, laid out by plan_layout
  int* fraction;   // [1]   nonzero: some added value is not a small integer
  int* counts;     // [S]   rows per slot
  int* offsets;    // [S+1] first row id of each slot in `rows`
  int* cursor;     // [S]   scatter cursor
  int* chunk_off;  // [S+1] first chunk of each slot
  int* part_off;   // [S]   first scratch partial of each slot
  int* multi;      // [S]   slots of more than one chunk, ascending
  int* n_multi;    // [1]
  int* chunk_rows; // [1]   rows per chunk of this launch
  int* chunk_slot; // [S + max_partials] slot of each chunk
  int* rows;       // [M]   row ids grouped by slot
};

Plan plan_layout(int* ws, int s, long long n_partials) {
  Plan p;
  p.fraction = ws;
  p.counts = ws + 1;
  p.offsets = p.counts + s;
  p.cursor = p.offsets + s + 1;
  p.chunk_off = p.cursor + s;
  p.part_off = p.chunk_off + s + 1;
  p.multi = p.part_off + s;
  p.n_multi = p.multi + s;
  p.chunk_rows = p.n_multi + 1;
  p.chunk_slot = p.chunk_rows + 1;
  p.rows = p.chunk_slot + s + n_partials;
  return p;
}

// Partials a launch can need: a slot of n rows in chunks of R has
// ceil(n / R) - 1 <= n / R of them, and R >= max(kMinChunkRows,
// rows / kMaxPartials).
long long max_partials(long long m) {
  long long by_rows = m / kMinChunkRows;
  return by_rows < kMaxPartials ? by_rows : kMaxPartials;
}

struct Tiling {
  int ft, bt, n_ftiles, n_btiles;
  size_t smem;
};

// Feature x bin tile of a block: whole features while one feature's
// [B, C] fits the target, else one feature cut into bin ranges.
bool tiling(int k, int n_bins, int c, Tiling* t) {
  long long per_bin = (long long)c * sizeof(float);
  long long per_feat = per_bin * n_bins;
  if (per_bin > kSmemLimit) return false;
  if (per_feat <= kTileBytes) {
    int ft = (int)(kTileBytes / per_feat);
    if (ft > k) ft = k;
    if (ft > kTileThreads) ft = kTileThreads;   // a thread per feature
    t->n_ftiles = (k + ft - 1) / ft;
    t->ft = (k + t->n_ftiles - 1) / t->n_ftiles;
    t->bt = n_bins;
    t->n_btiles = 1;
  } else {
    int bt = (int)(kTileBytes / per_bin);
    if (bt < 1) bt = 1;
    t->n_btiles = (n_bins + bt - 1) / bt;
    t->bt = (n_bins + t->n_btiles - 1) / t->n_btiles;
    t->ft = 1;
    t->n_ftiles = k;
  }
  t->smem = ((size_t)t->ft * t->bt * per_bin + 15) / 16 * 16;
  return t->smem <= kSmemLimit;
}

__device__ __forceinline__ int mapped_slot(const int* __restrict__ slot,
                                           const int* __restrict__ slot_map,
                                           int n_in, long long i,
                                           int num_slots) {
  int s = slot[i];
  if (slot_map != nullptr) s = (s >= 0 && s < n_in) ? slot_map[s] : -1;
  return (s >= 0 && s < num_slots) ? s : -1;
}

// Rows per slot of window [lo, lo + kSlotWindow) (gridDim.y windows).
// Blocks of the first window also raise `fraction` if a value the tiles
// will add for a kept row (w[i] * stats[i, c]) is not an integer of
// magnitude <= int_bound.
__global__ void __launch_bounds__(kSortThreads)
count_kernel(const int* __restrict__ slot, const int* __restrict__ slot_map,
             const float* __restrict__ stats, const float* __restrict__ weights,
             int n_in, long long m, int c, int num_slots, float int_bound,
             int* __restrict__ counts, int* __restrict__ fraction) {
  __shared__ int cnt[kSlotWindow];
  bool frac = false;
  const int lo = blockIdx.y * kSlotWindow;
  const int hi = min(num_slots, lo + kSlotWindow);
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads) cnt[j] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortRows;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < kSortRowsPerThread; ++j) {
    long long i = base + (long long)j * kSortThreads + threadIdx.x;
    int s = i < m ? mapped_slot(slot, slot_map, n_in, i, num_slots) : -1;
    int key = (s >= lo && s < hi) ? s - lo : -1;
    unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[key], __popc(peers));
    if (s >= 0 && blockIdx.y == 0) {
      // the values tile_kernel adds for this row
      const float w = weights != nullptr ? weights[i] : 1.0f;
      for (int ch = 0; ch < c; ++ch) {
        float v = stats[i * c + ch];
        if (weights != nullptr) v *= w;
        frac |= !(v == truncf(v) && fabsf(v) <= int_bound);
      }
    }
  }
  if (__syncthreads_or(frac) && threadIdx.x == 0) atomicOr(fraction, 1);
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads)
    if (cnt[j]) atomicAdd(&counts[lo + j], cnt[j]);
}

// Row ids grouped by slot: a block ranks its rows per slot in shared
// memory, reserves one range per slot with one global atomic, and writes.
__global__ void __launch_bounds__(kSortThreads)
scatter_kernel(const int* __restrict__ slot, const int* __restrict__ slot_map,
               int n_in, long long m, int num_slots, int* __restrict__ cursor,
               int* __restrict__ rows) {
  __shared__ int cnt[kSlotWindow];
  const int lo = blockIdx.y * kSlotWindow;
  const int hi = min(num_slots, lo + kSlotWindow);
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads) cnt[j] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortRows;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int key[kSortRowsPerThread], rank[kSortRowsPerThread];
#pragma unroll
  for (int j = 0; j < kSortRowsPerThread; ++j) {
    long long i = base + (long long)j * kSortThreads + threadIdx.x;
    int s = i < m ? mapped_slot(slot, slot_map, n_in, i, num_slots) : -1;
    key[j] = (s >= lo && s < hi) ? s - lo : -1;
    unsigned peers = __match_any_sync(0xffffffffu, key[j]);
    int leader = __ffs(peers) - 1;
    int first = 0;
    if (key[j] >= 0 && lane == leader)
      first = atomicAdd(&cnt[key[j]], __popc(peers));
    first = __shfl_sync(0xffffffffu, first, leader);
    rank[j] = first + __popc(peers & below);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads)
    if (cnt[j]) cnt[j] = atomicAdd(&cursor[lo + j], cnt[j]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortRowsPerThread; ++j)
    if (key[j] >= 0)
      rows[cnt[key[j]] + rank[j]] =
          (int)(base + (long long)j * kSortThreads + threadIdx.x);
}

// One block.  Picks the rows per chunk from the total row count, then
// takes exclusive scans over the slots of (rows, chunks, extra chunks,
// is-multi), giving offsets, cursor, chunk_off, part_off, multi.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(int num_slots, int tiles, int wave_blocks, Plan p) {
  __shared__ int warp_sum[kPlanThreads / 32][4];
  __shared__ int rows_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (num_slots + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(num_slots, tid * per), hi = min(num_slots, lo + per);
  int total = 0;
  for (int s = lo; s < hi; ++s) total += p.counts[s];
  total = __reduce_add_sync(0xffffffffu, total);
  if (lane == 0) warp_sum[warp][0] = total;
  __syncthreads();
  if (tid == 0) {
    long long t = 0;
    for (int w = 0; w < kPlanThreads / 32; ++w) t += warp_sum[w][0];
    long long r = (t * tiles + wave_blocks - 1) / wave_blocks;   // one wave
    long long r_cap = (t + kMaxPartials - 1) / kMaxPartials;     // partials
    if (r < r_cap) r = r_cap;
    if (r < kMinChunkRows) r = kMinChunkRows;
    rows_s = (int)((r + 31) / 32 * 32);
    *p.chunk_rows = rows_s;
  }
  __syncthreads();
  const int chunk_rows = rows_s;
  int sum[4] = {0, 0, 0, 0};
  for (int s = lo; s < hi; ++s) {
    int n = p.counts[s];
    int ch = n > chunk_rows ? (n + chunk_rows - 1) / chunk_rows : 1;
    sum[0] += n;
    sum[1] += ch;
    sum[2] += ch - 1;
    sum[3] += ch > 1;
  }
  int excl[4];
  __syncthreads();                       // warp_sum is reused
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    int incl = sum[v];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    excl[v] = incl - sum[v];
    if (lane == 31) warp_sum[warp][v] = incl;
  }
  __syncthreads();
  int totals[4] = {0, 0, 0, 0};
  for (int w = 0; w < kPlanThreads / 32; ++w) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (w < warp) excl[v] += warp_sum[w][v];
      totals[v] += warp_sum[w][v];
    }
  }
  for (int s = lo; s < hi; ++s) {
    int n = p.counts[s];
    int ch = n > chunk_rows ? (n + chunk_rows - 1) / chunk_rows : 1;
    p.offsets[s] = excl[0];
    p.cursor[s] = excl[0];
    p.chunk_off[s] = excl[1];
    p.part_off[s] = excl[2];
    if (ch > 1) p.multi[excl[3]] = s;
    for (int q = 0; q < ch; ++q) p.chunk_slot[excl[1] + q] = s;
    excl[0] += n;
    excl[1] += ch;
    excl[2] += ch - 1;
    excl[3] += ch > 1;
  }
  if (tid == 0) {
    p.offsets[num_slots] = totals[0];
    p.chunk_off[num_slots] = totals[1];
    *p.n_multi = totals[3];
  }
}

// Where slot s's computed block goes: its own slot, or in fused mode the
// side of pair s that holds the computed child (the other gets derived).
__device__ __forceinline__ long long small_slot(int s, const int* side) {
  return side == nullptr ? s : 2LL * s + (side[s] != 0 ? 0 : 1);
}
__device__ __forceinline__ long long derived_slot(int s, const int* side) {
  return 2LL * s + (side[s] != 0 ? 1 : 0);
}

// Add rows [r0, r1) of the grouped row list into the shared tile `acc`
// ([fn, bn, C]), feature f0.. and bin b0.. of the block.  Thread (g, f)
// takes feature f of rows g, g + groups, ...: neighbouring threads read
// neighbouring features of one row, and the bins of kUnroll rows are
// loaded before their atomics so that the loads overlap.  T = int adds
// each value as an integer (native shared-memory atomics); T = float uses
// the float atomic, a compare-and-swap loop on this card.
template <typename T>
__device__ __forceinline__ void accumulate(
    T* acc, const int* __restrict__ rows, const int* __restrict__ bins,
    const float* __restrict__ stats, const float* __restrict__ weights,
    int r0, int r1, int k, int c, int f0, int fn, int b0, int bn) {
  const int groups = kTileThreads / fn;
  const int g = threadIdx.x / fn, f = threadIdx.x - g * fn;
  if (g >= groups) return;
  for (int r = r0 + g; r < r1; r += kUnroll * groups) {
    int b[kUnroll];
    long long i[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * groups;
      i[u] = ru < r1 ? rows[ru] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      b[u] = i[u] >= 0 ? bins[i[u] * k + f0 + f] - b0 : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // also drops bins outside [0, n_bins)
      if ((unsigned)b[u] >= (unsigned)bn) continue;
      T* dst = acc + (f * bn + b[u]) * c;
      const float* src = stats + i[u] * c;
      const float w = weights != nullptr ? weights[i[u]] : 1.0f;
      for (int ch = 0; ch < c; ++ch) {
        float v = src[ch];
        if (weights != nullptr) v *= w;
        if (v != 0.0f) atomicAdd(dst + ch, (T)v);
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const int* __restrict__ bins, const float* __restrict__ stats,
            const float* __restrict__ weights, const Plan p, int num_slots,
            int k, int c, int n_bins, Tiling tl,
            const float* __restrict__ phist, const int* __restrict__ side,
            float* __restrict__ out, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int chunk = blockIdx.x;
  if (chunk >= p.chunk_off[num_slots]) return;
  const int s = p.chunk_slot[chunk];
  const int q = chunk - p.chunk_off[s];
  const int nq = p.chunk_off[s + 1] - p.chunk_off[s];
  const int chunk_rows = *p.chunk_rows;
  const int r0 = p.offsets[s] + q * chunk_rows;
  const int r1 = min(p.offsets[s + 1], r0 + chunk_rows);
  const int f0 = (blockIdx.y % tl.n_ftiles) * tl.ft;
  const int b0 = (blockIdx.y / tl.n_ftiles) * tl.bt;
  const int fn = min(tl.ft, k - f0), bn = min(tl.bt, n_bins - b0);
  if (fn <= 0 || bn <= 0) return;
  const int tile_n = fn * bn * c;
  const int tid = threadIdx.x;
  for (int e = tid; e < (tile_n + 3) / 4; e += kTileThreads)
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // +0.0f is int 0
  __syncthreads();
  const bool ints = *p.fraction == 0;
  if (ints)
    accumulate(reinterpret_cast<int*>(smem4), p.rows, bins, stats, weights,
               r0, r1, k, c, f0, fn, b0, bn);
  else
    accumulate(reinterpret_cast<float*>(smem4), p.rows, bins, stats, weights,
               r0, r1, k, c, f0, fn, b0, bn);
  __syncthreads();

  // write the tile once, coalesced along each feature's [bn, C] run (one
  // run for the whole tile when it holds whole features)
  const long long kbc = (long long)k * n_bins * c;
  float* dst;
  if (nq == 1 || q == 0) dst = out + small_slot(s, side) * kbc;
  else dst = partial + (long long)(p.part_off[s] + q - 1) * kbc;
  const bool final_fused = nq == 1 && side != nullptr;
  const float* ph = final_fused ? phist + s * kbc : nullptr;
  float* der = final_fused ? out + derived_slot(s, side) * kbc : nullptr;
  const int run = bn * c;
  const long long base = (long long)f0 * n_bins * c + (long long)b0 * c;
  const float* accf = reinterpret_cast<const float*>(smem4);
  const int* acci = reinterpret_cast<const int*>(smem4);
  auto value = [&](int e) { return ints ? (float)acci[e] : accf[e]; };
  if (bn == n_bins && !final_fused) {
    // whole features: the tile is one run of the output; 16-byte stores
    // after a scalar head up to the first aligned address
    float* d = dst + base;
    const int head = min(
        tile_n, (int)(((16 - ((unsigned long long)d & 15)) & 15) >> 2));
    const int nv = (tile_n - head) >> 2;
    for (int e = tid; e < head; e += kTileThreads) d[e] = value(e);
    float4* d4 = reinterpret_cast<float4*>(d + head);
    for (int j = tid; j < nv; j += kTileThreads) {
      const int e = head + 4 * j;
      d4[j] = make_float4(value(e), value(e + 1), value(e + 2), value(e + 3));
    }
    for (int e = head + 4 * nv + tid; e < tile_n; e += kTileThreads)
      d[e] = value(e);
    return;
  }
  for (int e = tid; e < tile_n; e += kTileThreads) {
    long long off = base + e;
    if (bn != n_bins) {
      const int ff = e / run;
      off += (long long)ff * (n_bins - bn) * c;
    }
    const float v = value(e);
    dst[off] = v;
    if (final_fused) der[off] = ph[off] - v;
  }
}

// Partials of every multi-chunk slot summed in chunk order: chunk 0's tile
// is in the output, chunks 1.. in scratch.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const Plan p, long long kbc, const float* __restrict__ phist,
             const int* __restrict__ side, float* __restrict__ out,
             const float* __restrict__ partial) {
  const long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= kbc) return;
  const int n_multi = *p.n_multi;
  for (int y = blockIdx.y; y < n_multi; y += gridDim.y) {
    const int s = p.multi[y];
    const int nq = p.chunk_off[s + 1] - p.chunk_off[s];
    const float* part = partial + (long long)p.part_off[s] * kbc + e;
    float* small = out + small_slot(s, side) * kbc + e;
    float v = *small;
    for (int q = 1; q < nq; ++q) v += part[(long long)(q - 1) * kbc];
    *small = v;
    if (side != nullptr)
      out[derived_slot(s, side) * kbc + e] = phist[s * kbc + e] - v;
  }
}

// Blocks of tile_kernel the card runs at once with `smem` bytes of shared
// memory each, after opting the kernel in to kSmemLimit bytes.  Kept per
// device: the queries would cost host time on every launch otherwise.
cudaError_t tile_wave(size_t smem, int* wave) {
  constexpr int kDevices = 64;
  static size_t known_smem[kDevices] = {};
  static int known_wave[kDevices] = {};
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && known_smem[dev] == smem) {
    *wave = known_wave[dev];
    return cudaSuccess;
  }
  if ((e = cudaFuncSetAttribute(tile_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemLimit)) != cudaSuccess
      || (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess
      || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, tile_kernel, kTileThreads, smem)) != cudaSuccess)
    return e;
  *wave = n_sm * (per_sm > 0 ? per_sm : 1);
  if (dev < kDevices) {
    known_wave[dev] = *wave;
    known_smem[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// Sizes of the int workspace and the float scratch that udt_histogram
// needs for these shapes; returns a CUDA error code (invalid value when a
// tile cannot fit in shared memory or the rows do not fit an int).
extern "C" int udt_histogram_workspace(long long m, int k, int c,
                                       int num_slots, int n_bins,
                                       long long* n_ints,
                                       long long* n_floats) {
  Tiling tl;
  if (m < 0 || m >= 0x7fffffffLL || k < 1 || c < 1 || num_slots < 1
      || n_bins < 1 || !tiling(k, n_bins, c, &tl))
    return (int)cudaErrorInvalidValue;
  *n_ints = 7LL * num_slots + 5 + max_partials(m) + m;
  *n_floats = max_partials(m) * (long long)k * n_bins * c;
  return 0;
}

extern "C" int udt_histogram(const int* bins, const float* stats,
                             const int* slot, const float* weights,
                             const int* slot_map, int n_in,
                             const float* phist, const int* side, float* out,
                             int* iws, float* fws, long long m, int k, int c,
                             int num_slots, int n_bins, void* stream) {
  long long n_ints, n_floats;
  int err = udt_histogram_workspace(m, k, c, num_slots, n_bins, &n_ints,
                                    &n_floats);
  if (err) return err;
  if ((phist == nullptr) != (side == nullptr)) return (int)cudaErrorInvalidValue;
  Tiling tl;
  tiling(k, n_bins, c, &tl);
  cudaStream_t st = (cudaStream_t)stream;
  Plan p = plan_layout(iws, num_slots, max_partials(m));
  // values up to int_bound add as exact ints: no int32 sum of m of them
  // overflows, and each is exact in f32
  const float int_bound =
      (float)(m > 0 && 0x7fffffffLL / m < (1 << 24) ? 0x7fffffffLL / m
                                                     : 1 << 24);
  cudaError_t e = cudaMemsetAsync(iws, 0, sizeof(int) * (num_slots + 1), st);
  if (e != cudaSuccess) return (int)e;
  dim3 sort_grid((unsigned)((m + kSortRows - 1) / kSortRows),
                 (unsigned)((num_slots + kSlotWindow - 1) / kSlotWindow));
  if (m > 0)
    count_kernel<<<sort_grid, kSortThreads, 0, st>>>(
        slot, slot_map, stats, weights, n_in, m, c, num_slots, int_bound,
        p.counts, p.fraction);
  int wave = 0;
  if ((e = tile_wave(tl.smem, &wave)) != cudaSuccess) return (int)e;
  const int tiles = tl.n_ftiles * tl.n_btiles;
  plan_kernel<<<1, kPlanThreads, 0, st>>>(num_slots, tiles, wave, p);
  if (m > 0)
    scatter_kernel<<<sort_grid, kSortThreads, 0, st>>>(
        slot, slot_map, n_in, m, num_slots, p.cursor, p.rows);
  // chunks: one per slot plus at most one per partial
  dim3 tile_grid((unsigned)(num_slots + max_partials(m)), (unsigned)tiles);
  tile_kernel<<<tile_grid, kTileThreads, tl.smem, st>>>(
      bins, stats, weights, p, num_slots, k, c, n_bins, tl, phist, side, out,
      fws);
  long long multi_max = max_partials(m);   // each multi slot has a partial
  if (multi_max > num_slots) multi_max = num_slots;
  if (multi_max > 0) {
    long long kbc = (long long)k * n_bins * c;
    dim3 merge_grid((unsigned)((kbc + kMergeThreads - 1) / kMergeThreads),
                    (unsigned)(multi_max < kMergeSlotsInFlight
                                   ? multi_max : kMergeSlotsInFlight));
    merge_kernel<<<merge_grid, kMergeThreads, 0, st>>>(p, kbc, phist, side,
                                                       out, fws);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* udt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
