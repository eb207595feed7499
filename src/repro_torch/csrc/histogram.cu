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
//      has one chunk, else as a partial (int32 tiles: chunk 0 into the
//      output, later chunks into scratch; fixed-point tiles: every chunk's
//      int64 tile into scratch).
//   3. `merge_kernel` sums the partials of every multi-chunk slot and
//      writes the final block.
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
// and convert once at the flush -- the same sums, exactly.
//
// Fixed-point accumulation (every other launch: float weights, moment
// stats).  `count_kernel` also takes the largest |value| the launch adds;
// `plan_kernel` picks a power of two 2**e so that T * max|value| * 2**e
// stays below 2**62, T the rows the launch keeps.  Every value is rounded
// once to the int64 nearest value * 2**e and added as an int64 (in shared
// memory, then across chunks in `merge_kernel`); the cell converts to f32
// once, as sum * 2**-e.  Integer addition does not depend on its order, so
// H is bit for bit the same on every launch with the same inputs, whatever
// order the scatter gives a slot's rows and whatever order the atomics
// land in.  Precision: each value keeps its bits down to 2**-e, that is
// about 62 - ceil(log2 T) bits below the launch's largest value (43 at
// T = 494,021), against f32's 24 for a single sum; a cell is then rounded
// to f32 once.  A non-finite value makes every cell of the launch NaN.
// An int64 tile takes twice the bytes of an int32 one, so the fixed-point
// kernel runs two blocks per tile, each over one half of its features (or
// of its bins).  On this card a 64-bit shared-memory atomicAdd is a
// compare-and-swap loop (ATOMS.CAST.SPIN.64 in the SASS), not a native
// add, so the fixed-point path is the slower of the two.

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
constexpr int kNonFinite = -2147483647 - 1;   // scale_exp: a value is inf/NaN

struct Plan {
  // int workspace, laid out by plan_layout
  int* fraction;   // [1]   nonzero: some added value is not a small integer
  int* vmax;       // [1]   bits of the largest |added value| (f32, >= 0)
  int* scale_exp;  // [1]   e of the fixed-point scale 2**e (kNonFinite)
  int* counts;     // [S]   rows per slot
  int* offsets;    // [S+1] first row id of each slot in `rows`
  int* cursor;     // [S]   scatter cursor
  int* chunk_off;  // [S+1] first chunk of each slot
  int* part_off;   // [S]   first scratch partial of each slot
  int* wide_off;   // [S]   first int64 partial of each multi-chunk slot
  int* multi;      // [S]   slots of more than one chunk, ascending
  int* n_multi;    // [1]
  int* chunk_rows; // [1]   rows per chunk of this launch
  int* chunk_slot; // [S + max_partials] slot of each chunk
  int* rows;       // [M]   row ids grouped by slot
};

Plan plan_layout(int* ws, int s, long long n_partials) {
  Plan p;
  p.fraction = ws;
  p.vmax = ws + 1;
  p.scale_exp = ws + 2;
  p.counts = ws + 3;
  p.offsets = p.counts + s;
  p.cursor = p.offsets + s + 1;
  p.chunk_off = p.cursor + s;
  p.part_off = p.chunk_off + s + 1;
  p.wide_off = p.part_off + s;
  p.multi = p.wide_off + s;
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
  // int32 tile, or half of it as int64 (features split in two when there
  // are several, else bins)
  size_t ints = (size_t)t->ft * t->bt * per_bin;
  size_t fixed = (size_t)(t->ft > 1 ? (t->ft + 1) / 2 * (long long)t->bt
                                    : (t->bt + 1) / 2) * c * 8;
  t->smem = ((ints > fixed ? ints : fixed) + 15) / 16 * 16;
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
// magnitude <= int_bound, and raise `vmax` to the largest |value|.
__global__ void __launch_bounds__(kSortThreads)
count_kernel(const int* __restrict__ slot, const int* __restrict__ slot_map,
             const float* __restrict__ stats, const float* __restrict__ weights,
             int n_in, long long m, int c, int num_slots, float int_bound,
             int* __restrict__ counts, int* __restrict__ fraction,
             int* __restrict__ vmax) {
  __shared__ int cnt[kSlotWindow];
  bool frac = false;
  unsigned big = 0;   // bits of the largest |value|: ordered like the floats
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
        big = max(big, __float_as_uint(fabsf(v)));
      }
    }
  }
  big = __reduce_max_sync(0xffffffffu, big);
  if (big && lane == 0) atomicMax(vmax, (int)big);
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
plan_kernel(int num_slots, int tiles, int wave_int, int wave_fixed, Plan p) {
  // the fixed-point kernel runs two blocks (halves) per tile
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
    const bool fixed = *p.fraction != 0;
    const int wave_blocks = fixed ? wave_fixed : wave_int;
    const long long blocks = fixed ? 2LL * tiles : tiles;
    long long r = (t * blocks + wave_blocks - 1) / wave_blocks;  // one wave
    long long r_cap = (t + kMaxPartials - 1) / kMaxPartials;     // partials
    if (r < r_cap) r = r_cap;
    if (r < kMinChunkRows) r = kMinChunkRows;
    rows_s = (int)((r + 31) / 32 * 32);
    *p.chunk_rows = rows_s;
    // fixed-point scale: t values below 2**ex each sum below 2**62
    const float big = __int_as_float(*p.vmax);
    int e = 0;
    if (!(big <= 3.4028235e38f)) {
      e = kNonFinite;
    } else if (big > 0.0f) {
      int ex;
      frexpf(big, &ex);                          // big < 2**ex
      const int lg = t > 1 ? 64 - __clzll(t - 1) : 0;   // t <= 2**lg
      e = 62 - ex - lg;
    }
    *p.scale_exp = e;
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
    // chunks of the multi-chunk slots before s: their partials, plus one
    // each for chunk 0
    p.wide_off[s] = excl[2] + excl[3];
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
// loaded before their atomics so that the loads overlap.  Fixed = false
// adds each value as an int32 (native shared-memory atomics); Fixed = true
// adds round(value * scale) as an int64.
template <bool Fixed, typename T>
__device__ __forceinline__ void accumulate(
    T* acc, const int* __restrict__ rows, const int* __restrict__ bins,
    const float* __restrict__ stats, const float* __restrict__ weights,
    int r0, int r1, int k, int c, int f0, int fn, int b0, int bn,
    double scale) {
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
        if (v == 0.0f) continue;
        if constexpr (Fixed) {
          const long long q = __double2ll_rn((double)v * scale);
          if (q != 0)
            atomicAdd(reinterpret_cast<unsigned long long*>(dst + ch),
                      (unsigned long long)q);
        } else {
          atomicAdd(dst + ch, (T)v);
        }
      }
    }
  }
}

// Write a [fn, bn, C] tile (features f0.., bins b0..) of one slot's
// [K, B, C] block `dst`, value(e) giving cell e of the tile; coalesced
// along each feature's [bn, C] run (one run for the whole tile when it
// holds whole features).  With `ph`, also write der = ph - value (fused).
template <typename V>
__device__ __forceinline__ void store_tile(
    float* dst, const float* ph, float* der, int k, int c, int n_bins,
    int f0, int fn, int b0, int bn, V value) {
  const int tid = threadIdx.x;
  const int tile_n = fn * bn * c;
  const int run = bn * c;
  const long long base = (long long)f0 * n_bins * c + (long long)b0 * c;
  if (bn == n_bins && ph == nullptr) {
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
    if (bn != n_bins) off += (long long)(e / run) * (n_bins - bn) * c;
    const float v = value(e);
    dst[off] = v;
    if (ph != nullptr) der[off] = ph[off] - v;
  }
}

// A fixed-point sum as f32: sum * 2**-e, NaN when a value was not finite.
__device__ __forceinline__ float from_fixed(long long sum, int e) {
  return e == kNonFinite ? __int_as_float(0x7fc00000)
                         : (float)((double)sum * scalbn(1.0, -e));
}

// Fixed = false is the int32 kernel (blockIdx.y: the tile), Fixed = true
// the fixed-point one (blockIdx.y: the tile and which half of it); both are
// launched and the one that does not match `fraction` returns at once (two
// kernels, so that the int32 one keeps its 40 registers and three
// blocks an SM; the empty launch costs a few microseconds).
template <bool Fixed>
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const int* __restrict__ bins, const float* __restrict__ stats,
            const float* __restrict__ weights, const Plan p, int num_slots,
            int k, int c, int n_bins, Tiling tl,
            const float* __restrict__ phist, const int* __restrict__ side,
            float* __restrict__ out, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int chunk = blockIdx.x;
  if ((*p.fraction != 0) != Fixed || chunk >= p.chunk_off[num_slots]) return;
  const int s = p.chunk_slot[chunk];
  const int q = chunk - p.chunk_off[s];
  const int nq = p.chunk_off[s + 1] - p.chunk_off[s];
  const int chunk_rows = *p.chunk_rows;
  const int r0 = p.offsets[s] + q * chunk_rows;
  const int r1 = min(p.offsets[s + 1], r0 + chunk_rows);
  const int tile = Fixed ? blockIdx.y >> 1 : blockIdx.y;
  const int f0 = (tile % tl.n_ftiles) * tl.ft;
  const int b0 = (tile / tl.n_ftiles) * tl.bt;
  const int fn = min(tl.ft, k - f0), bn = min(tl.bt, n_bins - b0);
  if (fn <= 0 || bn <= 0) return;
  const int tid = threadIdx.x;
  const long long kbc = (long long)k * n_bins * c;
  // The final block of a one-chunk slot goes to the output (the fused pair
  // block included); a multi-chunk slot's chunks are merged afterwards.
  // Taken after the accumulation, so that the pointers are not live across
  // its loop (registers: three blocks an SM).
  auto final_ph = [&]() {
    return nq == 1 && side != nullptr ? phist + s * kbc : nullptr;
  };
  auto final_der = [&]() {
    return nq == 1 && side != nullptr ? out + derived_slot(s, side) * kbc
                                      : nullptr;
  };

  if constexpr (!Fixed) {
    // every value a small integer: one int32 pass over the whole tile
    int* acc = reinterpret_cast<int*>(smem4);
    const int tile_n = fn * bn * c;
    for (int e = tid; e < (tile_n + 3) / 4; e += kTileThreads)
      smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // +0.0f is int 0
    __syncthreads();
    accumulate<false>(acc, p.rows, bins, stats, weights, r0, r1, k, c, f0,
                      fn, b0, bn, 0.0);
    __syncthreads();
    // chunk 0 into the output, later chunks into scratch; merged in order
    float* dst = (nq == 1 || q == 0)
        ? out + small_slot(s, side) * kbc
        : partial + (long long)(p.part_off[s] + q - 1) * kbc;
    store_tile(dst, final_ph(), final_der(), k, c, n_bins, f0, fn, b0, bn,
               [&](int e) { return (float)acc[e]; });
    return;
  } else {
    // fixed point: an int64 tile holds half of the int32 tile, so this
    // block takes one half of it: a feature half, or a bin half of a
    // single feature
    const int half = blockIdx.y & 1;
    const int fh = fn > 1 ? (fn + 1) / 2 : fn;
    const int bh = fn > 1 ? bn : (bn + 1) / 2;
    const int sf0 = fn > 1 ? f0 + half * fh : f0;
    const int sfn = fn > 1 ? min(fh, fn - half * fh) : fn;
    const int sb0 = fn > 1 ? b0 : b0 + half * bh;
    const int sbn = fn > 1 ? bn : min(bh, bn - half * bh);
    if (sfn <= 0 || sbn <= 0) return;
    long long* acc = reinterpret_cast<long long*>(smem4);
    const int e2 = *p.scale_exp;
    const double scale = e2 == kNonFinite ? 0.0 : scalbn(1.0, e2);
    const int tile_n = sfn * sbn * c;
    for (int e = tid; e < tile_n; e += kTileThreads) acc[e] = 0;
    __syncthreads();
    accumulate<true>(acc, p.rows, bins, stats, weights, r0, r1, k, c, sf0,
                     sfn, sb0, sbn, scale);
    __syncthreads();
    if (nq == 1) {
      store_tile(out + small_slot(s, side) * kbc, final_ph(), final_der(), k,
                 c, n_bins, sf0, sfn, sb0, sbn,
                 [&](int e) { return from_fixed(acc[e], e2); });
      return;
    }
    // the int64 partial of this chunk, laid out as the [K, B, C] block
    long long* wide = reinterpret_cast<long long*>(partial)
                      + (long long)(p.wide_off[s] + q) * kbc;
    const int run = sbn * c;
    const long long base = (long long)sf0 * n_bins * c + (long long)sb0 * c;
    for (int e = tid; e < tile_n; e += kTileThreads)
      wide[base + e + (long long)(e / run) * (n_bins - sbn) * c] = acc[e];
  }
}

// Partials of every multi-chunk slot summed in chunk order: for int32
// tiles chunk 0's tile is in the output and chunks 1.. in scratch; for
// fixed-point tiles every chunk's int64 tile is in scratch.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const Plan p, long long kbc, const float* __restrict__ phist,
             const int* __restrict__ side, float* __restrict__ out,
             const float* __restrict__ partial) {
  const long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= kbc) return;
  const int n_multi = *p.n_multi;
  const bool fixed = *p.fraction != 0;
  const int e2 = *p.scale_exp;
  for (int y = blockIdx.y; y < n_multi; y += gridDim.y) {
    const int s = p.multi[y];
    const int nq = p.chunk_off[s + 1] - p.chunk_off[s];
    float* small = out + small_slot(s, side) * kbc + e;
    float v;
    if (fixed) {
      const long long* part = reinterpret_cast<const long long*>(partial)
                              + (long long)p.wide_off[s] * kbc + e;
      long long sum = 0;
      for (int q = 0; q < nq; ++q) sum += part[(long long)q * kbc];
      v = from_fixed(sum, e2);
    } else {
      const float* part = partial + (long long)p.part_off[s] * kbc + e;
      v = *small;
      for (int q = 1; q < nq; ++q) v += part[(long long)(q - 1) * kbc];
    }
    *small = v;
    if (side != nullptr)
      out[derived_slot(s, side) * kbc + e] = phist[s * kbc + e] - v;
  }
}

// Blocks of tile_kernel<Fixed> the card runs at once with `smem` bytes of
// shared memory each, after opting the kernel in to kSmemLimit bytes.  Kept
// per device: the queries would cost host time on every launch otherwise.
template <bool Fixed>
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
  if ((e = cudaFuncSetAttribute(tile_kernel<Fixed>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemLimit)) != cudaSuccess
      || (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess
      || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, tile_kernel<Fixed>, kTileThreads, smem)) != cudaSuccess)
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
  const long long kbc = (long long)k * n_bins * c;
  const long long maxp = max_partials(m);
  *n_ints = 8LL * num_slots + 7 + maxp + m;
  // int32 tiles: one float partial per extra chunk; fixed-point tiles: one
  // int64 (two floats) per chunk of a multi-chunk slot, each such slot
  // adding at least one extra chunk
  const long long wide = 2 * (maxp + (num_slots < maxp ? num_slots : maxp));
  *n_floats = (maxp > wide ? maxp : wide) * kbc;
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
  // fraction, vmax, scale_exp and counts start at 0
  cudaError_t e = cudaMemsetAsync(iws, 0, sizeof(int) * (num_slots + 3), st);
  if (e != cudaSuccess) return (int)e;
  dim3 sort_grid((unsigned)((m + kSortRows - 1) / kSortRows),
                 (unsigned)((num_slots + kSlotWindow - 1) / kSlotWindow));
  if (m > 0)
    count_kernel<<<sort_grid, kSortThreads, 0, st>>>(
        slot, slot_map, stats, weights, n_in, m, c, num_slots, int_bound,
        p.counts, p.fraction, p.vmax);
  int wave_int = 0, wave_fixed = 0;
  if ((e = tile_wave<false>(tl.smem, &wave_int)) != cudaSuccess
      || (e = tile_wave<true>(tl.smem, &wave_fixed)) != cudaSuccess)
    return (int)e;
  const int tiles = tl.n_ftiles * tl.n_btiles;
  plan_kernel<<<1, kPlanThreads, 0, st>>>(num_slots, tiles, wave_int,
                                          wave_fixed, p);
  if (m > 0)
    scatter_kernel<<<sort_grid, kSortThreads, 0, st>>>(
        slot, slot_map, n_in, m, num_slots, p.cursor, p.rows);
  // chunks: one per slot plus at most one per partial
  dim3 tile_grid((unsigned)(num_slots + max_partials(m)), (unsigned)tiles);
  tile_kernel<false><<<tile_grid, kTileThreads, tl.smem, st>>>(
      bins, stats, weights, p, num_slots, k, c, n_bins, tl, phist, side, out,
      fws);
  tile_grid.y *= 2;
  tile_kernel<true><<<tile_grid, kTileThreads, tl.smem, st>>>(
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
