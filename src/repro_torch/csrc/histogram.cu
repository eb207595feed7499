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
//   kernels/ref.py::sibling_ref.  Pairs mode is the fused mode with the
//   computed child chosen here: given the raw child slots [0, 2P) and no
//   slot_map or side, `count_kernel` counts the rows of every raw slot
//   (and keeps each raw slot's largest |value| and integer flag), and
//   `plan_kernel` picks per pair the child with fewer rows (the left one on
//   a tie), writes side and the raw-slot -> pair map into the workspace,
//   and takes the counts, largest |value| and flag of the chosen children
//   only; the later passes read the map and side from there.  So a pairs
//   launch makes the same choice of int32 or fixed point, at the same
//   scale, as a fused launch given that choice: H is bit for bit the
//   same.  Every output cell is written exactly
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
// Class-stacked mode (`lanes` L > 1): the reference gets it from jax.vmap
// over histogram_pallas (the multiclass level step, _chunk_step_classes),
// which adds a batch grid axis.  Here the lane is folded into the slot
// axis: stats [L, M, C], slot [L, M] and weights [L, M] are L rows blocks
// over one shared bins [M, K] (never copied per lane); row r = l * M + i
// reads bins[i], and its slot becomes l * S + slot (fused: pair l * P + j,
// so phist [L, P, K, B, C] and side [L, P] are read in place and the
// output is [L, S | 2P, K, B, C]).  One launch serves every lane.  Each
// lane keeps its own int32-or-fixed choice, largest |value|, kept-row
// count and scale 2**e, so lane l's cells are bit for bit those of a
// one-lane launch on lane l's inputs; a lane's chunks read its flag and
// its scale.  Int32 partials then sit after the int64 ones in the scratch
// (lanes of both kinds can share a launch).
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
// after the other.  A class-stacked launch's bound reads the shared bins
// once (M*K*4 B) plus L*M*(C+1)*4 B of stats and weights; this design
// gathers the bins once per lane.
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
constexpr int kTileBlocksPerSm = 3;   // both tile kernels: <= 42 registers
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
  // int workspace, laid out by plan_layout; S counts the slots of every
  // lane (L * slots per lane), rows run over every lane (L * M)
  int* fraction;   // [L]   nonzero: some added value is not a small integer
  int* vmax;       // [L]   bits of the largest |added value| (f32, >= 0)
  int* scale_exp;  // [L]   e of the fixed-point scale 2**e (kNonFinite)
  int* counts;     // [S]   rows per slot
  int* raw_counts; // [2S]  pairs mode: rows per raw child slot
  int* raw_vmax;   // [2S]  pairs mode: vmax of each raw child slot
  int* raw_frac;   // [2S]  pairs mode: fraction of each raw child slot
  int* side;       // [S]   pairs mode: 1 where the left child is computed
  int* pair_map;   // [2S]  pairs mode: raw slot -> pair in its lane, or -1
  int* offsets;    // [S+1] first row id of each slot in `rows`
  int* cursor;     // [S]   scatter cursor
  int* chunk_off;  // [S+1] first chunk of each slot
  int* part_off;   // [S]   first scratch partial of each slot
  int* wide_off;   // [S]   first int64 partial of each multi-chunk slot
  int* multi;      // [S]   slots of more than one chunk, ascending
  int* n_multi;    // [1]
  int* chunk_rows; // [1]   rows per chunk of this launch
  int* kinds;      // [1]   bit 0: some lane adds int32, bit 1: fixed point
  int* chunk_slot; // [S + max_partials] slot of each chunk
  int* rows;       // [M]   row ids grouped by slot
};

Plan plan_layout(int* ws, int lanes, int s, long long n_partials) {
  Plan p;
  p.fraction = ws;
  p.vmax = ws + lanes;
  p.scale_exp = ws + 2 * lanes;
  p.counts = ws + 3 * lanes;
  p.raw_counts = p.counts + s;
  p.raw_vmax = p.raw_counts + 2 * s;
  p.raw_frac = p.raw_vmax + 2 * s;
  p.side = p.raw_frac + 2 * s;
  p.pair_map = p.side + s;
  p.offsets = p.pair_map + 2 * s;
  p.cursor = p.offsets + s + 1;
  p.chunk_off = p.cursor + s;
  p.part_off = p.chunk_off + s + 1;
  p.wide_off = p.part_off + s;
  p.multi = p.wide_off + s;
  p.n_multi = p.multi + s;
  p.chunk_rows = p.n_multi + 1;
  p.kinds = p.chunk_rows + 1;
  p.chunk_slot = p.kinds + 1;
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

// Lane of row r (rows of lane l are l * m_lane ..), for a block's first
// row; a stacked row pass then steps each thread's lane forward as its rows
// grow (a compare per row, no division).
__device__ __forceinline__ int lane_of(int r, int m_lane) {
  return r >= m_lane ? r / m_lane : 0;
}

// Slot of row r over every lane's slots (lane * num_slots + slot), -1 when
// the row is dropped; slot_map is [lanes, n_in], num_slots per lane.
__device__ __forceinline__ int mapped_slot(const int* __restrict__ slot,
                                           const int* __restrict__ slot_map,
                                           int n_in, int r, int lane,
                                           int num_slots) {
  int s = slot[r];
  if (slot_map != nullptr)
    s = (s >= 0 && s < n_in) ? slot_map[(long long)lane * n_in + s] : -1;
  return (s >= 0 && s < num_slots) ? lane * num_slots + s : -1;
}

// The values tile_kernel adds for row r (w[r] * stats[r, c]): whether one
// is not an integer of magnitude <= int_bound, and the bits of the largest
// |value| (ordered like the floats).
__device__ __forceinline__ void row_values(const float* __restrict__ stats,
                                           const float* __restrict__ weights,
                                           int r, int c, float int_bound,
                                           bool* frac, unsigned* big) {
  const float w = weights != nullptr ? weights[r] : 1.0f;
  for (int ch = 0; ch < c; ++ch) {
    float v = stats[(long long)r * c + ch];
    if (weights != nullptr) v *= w;
    *frac |= !(v == truncf(v) && fabsf(v) <= int_bound);
    *big = max(*big, __float_as_uint(fabsf(v)));
  }
}

// Rows per slot of window [lo, lo + kSlotWindow) (gridDim.y windows) of
// the n_slots = lanes * num_slots slots.  PerSlot = false: blocks of the
// first window also raise their lane's `fraction` if a value the tiles
// will add for a kept row is not an integer of magnitude <= int_bound, and
// raise the lane's `vmax` to its largest |value|; a block whose rows all
// lie in one lane (every block of a one-lane launch: Stacked = false)
// reduces per warp and per block first, a block that straddles lanes (at
// most lanes - 1 of them) adds per thread and lane.  PerSlot = true (pairs
// mode, over the raw child slots): `fraction` and `vmax` are per slot, and
// each window's blocks take them for their window's rows, reduced per warp
// over the rows of one slot and per block in shared memory.
template <bool Stacked, bool PerSlot>
__global__ void __launch_bounds__(kSortThreads)
count_kernel(const int* __restrict__ slot, const int* __restrict__ slot_map,
             const float* __restrict__ stats, const float* __restrict__ weights,
             int n_in, int m, int m_lane, int c, int num_slots, int n_slots,
             float int_bound, int* __restrict__ counts,
             int* __restrict__ fraction, int* __restrict__ vmax) {
  __shared__ int cnt[kSlotWindow];
  __shared__ unsigned big_s[PerSlot ? kSlotWindow : 1];
  __shared__ unsigned frac_s[PerSlot ? kSlotWindow / 32 : 1];
  const int lo = blockIdx.y * kSlotWindow;
  const int hi = min(n_slots, lo + kSlotWindow);
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads) {
    cnt[j] = 0;
    if constexpr (PerSlot) big_s[j] = 0;
  }
  if constexpr (PerSlot)
    for (int j = threadIdx.x; j < kSlotWindow / 32; j += kSortThreads)
      frac_s[j] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortRows;
  const int lane = threadIdx.x & 31;
  const int lane0 = Stacked ? lane_of(base, m_lane) : 0;
  const bool one_lane =
      !Stacked || lane_of(min(m, base + kSortRows) - 1, m_lane) == lane0;
  int cur = lane0;
  int l = lane0, next = (lane0 + 1) * m_lane;   // this thread's lane
  bool frac = false;
  unsigned big = 0;   // bits of the largest |value|: ordered like the floats
#pragma unroll 4
  for (int j = 0; j < kSortRowsPerThread; ++j) {
    const int r = base + j * kSortThreads + threadIdx.x;
    if constexpr (Stacked) {
      while (r >= next && r < m) {
        ++l;
        next += m_lane;
      }
    }
    const int s = r < m ? mapped_slot(slot, slot_map, n_in, r, l, num_slots)
                        : -1;
    const int key = (s >= lo && s < hi) ? s - lo : -1;
    unsigned peers = __match_any_sync(0xffffffffu, key);
    const bool leader = key >= 0 && lane == __ffs(peers) - 1;
    if (leader) atomicAdd(&cnt[key], __popc(peers));
    if constexpr (PerSlot) {
      bool f = false;
      unsigned b = 0;
      if (key >= 0) row_values(stats, weights, r, c, int_bound, &f, &b);
      b = __reduce_max_sync(peers, b);
      const unsigned fo = __reduce_or_sync(peers, f ? 1u : 0u);
      if (leader) {
        if (b) atomicMax(&big_s[key], b);
        if (fo) atomicOr(&frac_s[key >> 5], 1u << (key & 31));
      }
    } else if (s >= 0 && blockIdx.y == 0) {
      if (Stacked && l != cur) {    // only where the block straddles lanes
        if (big) atomicMax(&vmax[cur], (int)big);
        if (frac) atomicOr(&fraction[cur], 1);
        frac = false;
        big = 0;
        cur = l;
      }
      row_values(stats, weights, r, c, int_bound, &frac, &big);
    }
  }
  // every branch ends in a barrier: the shared counts are complete
  if constexpr (PerSlot) {
    __syncthreads();
    for (int j = threadIdx.x; j < hi - lo; j += kSortThreads) {
      if (big_s[j]) atomicMax(&vmax[lo + j], (int)big_s[j]);
      if ((frac_s[j >> 5] >> (j & 31)) & 1u) atomicOr(&fraction[lo + j], 1);
    }
  } else if (one_lane) {
    big = __reduce_max_sync(0xffffffffu, big);
    if (big && lane == 0) atomicMax(&vmax[lane0], (int)big);
    if (__syncthreads_or(frac) && threadIdx.x == 0)
      atomicOr(&fraction[lane0], 1);
  } else {
    if (big) atomicMax(&vmax[cur], (int)big);
    if (frac) atomicOr(&fraction[cur], 1);
    __syncthreads();
  }
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads)
    if (cnt[j]) atomicAdd(&counts[lo + j], cnt[j]);
}

// Row ids grouped by slot: a block ranks its rows per slot in shared
// memory, reserves one range per slot with one global atomic, and writes
// each row's id within its lane (r - lane * m_lane).
template <bool Stacked>
__global__ void __launch_bounds__(kSortThreads)
scatter_kernel(const int* __restrict__ slot, const int* __restrict__ slot_map,
               int n_in, int m, int m_lane, int num_slots, int n_slots,
               int* __restrict__ cursor, int* __restrict__ rows) {
  __shared__ int cnt[kSlotWindow];
  const int lo = blockIdx.y * kSlotWindow;
  const int hi = min(n_slots, lo + kSlotWindow);
  for (int j = threadIdx.x; j < hi - lo; j += kSortThreads) cnt[j] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortRows;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int key[kSortRowsPerThread], rank[kSortRowsPerThread];
  int l = Stacked ? lane_of(base, m_lane) : 0, next = (l + 1) * m_lane;
#pragma unroll
  for (int j = 0; j < kSortRowsPerThread; ++j) {
    const int r = base + j * kSortThreads + threadIdx.x;
    if constexpr (Stacked) {
      while (r >= next && r < m) {
        ++l;
        next += m_lane;
      }
    }
    const int s = r < m ? mapped_slot(slot, slot_map, n_in, r, l, num_slots)
                        : -1;
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
  for (int j = 0; j < kSortRowsPerThread; ++j) {
    if (key[j] < 0) continue;
    int r = base + j * kSortThreads + threadIdx.x;
    if constexpr (Stacked) r -= lane_of(r, m_lane) * m_lane;
    rows[cnt[key[j]] + rank[j]] = r;
  }
}

// One block.  In pairs mode it first picks each pair's computed child
// from the raw counts: the one with fewer rows, the left one on a tie (the
// rule of kernels/histogram.py::smaller_children), and takes the pair's
// count, and its lane's largest |value| and integer flag, from that child
// alone.  Then it picks the rows per chunk from the total row count, and
// takes exclusive scans over the n_slots slots of (rows, chunks, extra
// chunks, is-multi), giving offsets, cursor, chunk_off, part_off, multi.
// Last, each lane's fixed-point scale from its largest |value| and its
// kept rows (its slots' share of the offsets).
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(int n_slots, int num_slots, int lanes, int tiles, int wave_int,
            int wave_fixed, bool pairs, Plan p) {
  // the fixed-point kernel runs two blocks (halves) per tile
  __shared__ int warp_sum[kPlanThreads / 32][4];
  __shared__ int rows_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (pairs) {
    for (int s = tid; s < n_slots; s += kPlanThreads) {
      const int left_n = p.raw_counts[2 * s], right_n = p.raw_counts[2 * s + 1];
      const bool left = left_n <= right_n;
      const int chosen = 2 * s + (left ? 0 : 1);   // lane l's raw slots
      const int l = s / num_slots;                 // start at 2 * l * P
      p.side[s] = left;
      p.counts[s] = left ? left_n : right_n;
      p.pair_map[chosen] = s - l * num_slots;
      p.pair_map[chosen ^ 1] = -1;
      if (p.raw_vmax[chosen]) atomicMax(&p.vmax[l], p.raw_vmax[chosen]);
      if (p.raw_frac[chosen]) atomicOr(&p.fraction[l], 1);
    }
    __syncthreads();                     // counts, vmax, fraction complete
  }
  const int per = (n_slots + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(n_slots, tid * per), hi = min(n_slots, lo + per);
  int total = 0;
  for (int s = lo; s < hi; ++s) total += p.counts[s];
  total = __reduce_add_sync(0xffffffffu, total);
  if (lane == 0) warp_sum[warp][0] = total;
  __syncthreads();
  if (tid == 0) {
    long long t = 0;
    for (int w = 0; w < kPlanThreads / 32; ++w) t += warp_sum[w][0];
    int kinds = 0;
    for (int l = 0; l < lanes; ++l) kinds |= p.fraction[l] != 0 ? 2 : 1;
    *p.kinds = kinds;
    const bool fixed = kinds & 2;  // chunks sized for the slower kernel
    const int wave_blocks = fixed ? wave_fixed : wave_int;
    const long long blocks = fixed ? 2LL * tiles : tiles;
    long long r = (t * blocks + wave_blocks - 1) / wave_blocks;  // one wave
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
    p.offsets[n_slots] = totals[0];
    p.chunk_off[n_slots] = totals[1];
    *p.n_multi = totals[3];
  }
  __syncthreads();                       // offsets are complete
  // fixed-point scale of each lane: its t values below 2**ex each sum
  // below 2**62
  for (int l = tid; l < lanes; l += kPlanThreads) {
    const long long t = (long long)p.offsets[(l + 1) * num_slots]
                        - p.offsets[l * num_slots];
    const float big = __int_as_float(p.vmax[l]);
    int e = 0;
    if (!(big <= 3.4028235e38f)) {
      e = kNonFinite;
    } else if (big > 0.0f) {
      int ex;
      frexpf(big, &ex);                          // big < 2**ex
      const int lg = t > 1 ? 64 - __clzll(t - 1) : 0;   // t <= 2**lg
      e = 62 - ex - lg;
    }
    p.scale_exp[l] = e;
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
// ([fn, bn, C]), feature f0.. and bin b0.. of the block; the row ids are
// within the block's lane (stats and weights point at the lane's rows, the
// bins are shared).  Thread (g, f)
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
    int i[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * groups;
      i[u] = ru < r1 ? rows[ru] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      b[u] = i[u] >= 0 ? bins[(long long)i[u] * k + f0 + f] - b0 : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // also drops bins outside [0, n_bins)
      if ((unsigned)b[u] >= (unsigned)bn) continue;
      T* dst = acc + (f * bn + b[u]) * c;
      const float* src = stats + (long long)i[u] * c;
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
// launched and a chunk whose lane's `fraction` does not match returns at
// once (two kernels, so that the int32 one keeps its 40 registers and
// three blocks an SM; the empty launch costs a few microseconds).
// n_slots counts every lane's slots, num_slots one lane's; Stacked = false
// (one lane) keeps the lane arithmetic out of the kernel.
template <bool Fixed, bool Stacked>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
tile_kernel(const int* __restrict__ bins, const float* __restrict__ stats,
            const float* __restrict__ weights, const Plan p, int n_slots,
            int num_slots, int m_lane, int k, int c, int n_bins, Tiling tl,
            const float* __restrict__ phist, const int* __restrict__ side,
            float* __restrict__ out, float* __restrict__ partial,
            long long int_base) {
  extern __shared__ float4 smem4[];
  const int chunk = blockIdx.x;
  // one word first: a launch with no lane of this kind returns at once
  const int kinds = *p.kinds;
  if (!(kinds & (Fixed ? 2 : 1)) || chunk >= p.chunk_off[n_slots]) return;
  const int s = p.chunk_slot[chunk];
  int lane = 0;
  if constexpr (Stacked) {
    lane = s / num_slots;
    if (kinds == 3 && (p.fraction[lane] != 0) != Fixed) return;   // mixed
    // the lane's rows: row ids in p.rows count from its first row
    stats += (long long)lane * m_lane * c;
    if (weights != nullptr) weights += (long long)lane * m_lane;
  }
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
        : partial + (Stacked ? int_base : 0)
              + (long long)(p.part_off[s] + q - 1) * kbc;
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
    const int e2 = p.scale_exp[lane];
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
// tiles chunk 0's tile is in the output and chunks 1.. in scratch (from
// int_base on); for fixed-point tiles every chunk's int64 tile is in
// scratch.  Each slot reads its lane's flag and scale.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const Plan p, int num_slots, long long kbc, long long int_base,
             const float* __restrict__ phist, const int* __restrict__ side,
             float* __restrict__ out, const float* __restrict__ partial) {
  const long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= kbc) return;
  const int n_multi = *p.n_multi;
  for (int y = blockIdx.y; y < n_multi; y += gridDim.y) {
    const int s = p.multi[y];
    const int lane = s / num_slots;
    const bool fixed = p.fraction[lane] != 0;
    const int e2 = p.scale_exp[lane];
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
      const float* part = partial + int_base + (long long)p.part_off[s] * kbc
                          + e;
      v = *small;
      for (int q = 1; q < nq; ++q) v += part[(long long)(q - 1) * kbc];
    }
    *small = v;
    if (side != nullptr)
      out[derived_slot(s, side) * kbc + e] = phist[s * kbc + e] - v;
  }
}

// Blocks of tile_kernel<Fixed, Stacked> the card runs at once with `smem`
// bytes of shared memory each, after opting the kernel in to kSmemLimit
// bytes.  Kept per device: the queries would cost host time on every launch
// otherwise.
template <bool Fixed, bool Stacked>
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
  if ((e = cudaFuncSetAttribute(tile_kernel<Fixed, Stacked>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemLimit)) != cudaSuccess
      || (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess
      || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, tile_kernel<Fixed, Stacked>, kTileThreads, smem))
          != cudaSuccess)
    return e;
  *wave = n_sm * (per_sm > 0 ? per_sm : 1);
  if (dev < kDevices) {
    known_wave[dev] = *wave;
    known_smem[dev] = smem;
  }
  return cudaSuccess;
}

template <bool Stacked>
cudaError_t tile_waves(size_t smem, int* wave_int, int* wave_fixed) {
  cudaError_t e = tile_wave<false, Stacked>(smem, wave_int);
  return e != cudaSuccess ? e : tile_wave<true, Stacked>(smem, wave_fixed);
}

struct TileArgs {
  const int* bins;
  const float* stats;
  const float* weights;
  Plan p;
  int n_slots, num_slots, m_lane, k, c, n_bins;
  Tiling tl;
  const float* phist;
  const int* side;
  float* out;
  float* partial;
  long long int_base;
};

// Both tile kernels: a chunk runs in the one whose kind its lane has.
template <bool Stacked>
void launch_tiles(const TileArgs& a, dim3 grid, cudaStream_t st) {
  tile_kernel<false, Stacked><<<grid, kTileThreads, a.tl.smem, st>>>(
      a.bins, a.stats, a.weights, a.p, a.n_slots, a.num_slots, a.m_lane, a.k,
      a.c, a.n_bins, a.tl, a.phist, a.side, a.out, a.partial, a.int_base);
  grid.y *= 2;
  tile_kernel<true, Stacked><<<grid, kTileThreads, a.tl.smem, st>>>(
      a.bins, a.stats, a.weights, a.p, a.n_slots, a.num_slots, a.m_lane, a.k,
      a.c, a.n_bins, a.tl, a.phist, a.side, a.out, a.partial, a.int_base);
}

// Scratch offset (in floats) of the int32 partials: after the int64 ones
// when lanes of both kinds can share a launch, else at 0 (one kind only).
long long int_partials_at(long long maxp, long long n_slots, long long kbc,
                          int lanes) {
  return lanes > 1 ? 2 * (maxp + (n_slots < maxp ? n_slots : maxp)) * kbc : 0;
}

}  // namespace

// Sizes of the int workspace and the float scratch that udt_histogram
// needs for these shapes (m rows and num_slots slots per lane); returns a
// CUDA error code (invalid value when a tile cannot fit in shared memory or
// the rows of all lanes do not fit an int).
extern "C" int udt_histogram_workspace(long long m, int lanes, int k, int c,
                                       int num_slots, int n_bins,
                                       long long* n_ints,
                                       long long* n_floats) {
  Tiling tl;
  if (m < 0 || lanes < 1 || k < 1 || c < 1 || num_slots < 1 || n_bins < 1
      || m * lanes >= 0x7fffffffLL - kSortRows
      || (long long)num_slots * lanes >= 0x7fffffffLL
      || !tiling(k, n_bins, c, &tl))
    return (int)cudaErrorInvalidValue;
  const long long rows = m * lanes, n_slots = (long long)num_slots * lanes;
  const long long kbc = (long long)k * n_bins * c;
  const long long maxp = max_partials(rows);
  *n_ints = 3LL * lanes + 17 * n_slots + 5 + maxp + rows;
  // int32 tiles: one float partial per extra chunk; fixed-point tiles: one
  // int64 (two floats) per chunk of a multi-chunk slot, each such slot
  // adding at least one extra chunk
  const long long wide = 2 * (maxp + (n_slots < maxp ? n_slots : maxp));
  const long long ints_at = int_partials_at(maxp, n_slots, kbc, lanes);
  *n_floats = lanes > 1 ? ints_at + maxp * kbc
                        : (maxp > wide ? maxp : wide) * kbc;
  return 0;
}

// Dynamic shared memory of each tile_kernel block of a udt_histogram
// launch at these widths (the tiling the launch uses); returns a CUDA error
// code (invalid value when no tile fits in shared memory).
extern "C" int udt_histogram_smem(int k, int c, int n_bins, long long* smem) {
  Tiling tl;
  if (k < 1 || c < 1 || n_bins < 1 || !tiling(k, n_bins, c, &tl))
    return (int)cudaErrorInvalidValue;
  *smem = (long long)tl.smem;
  return 0;
}

namespace {

// The count pass over n_slots = lanes * num_slots slots (PerSlot: the
// per-slot `fraction` and `vmax` of pairs mode).
template <bool PerSlot>
void launch_count(const int* slot, const int* slot_map, const float* stats,
                  const float* weights, int n_in, int rows, int m, int c,
                  int num_slots, int n_slots, int lanes, float int_bound,
                  int* counts, int* fraction, int* vmax, cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kSortRows - 1) / kSortRows),
                  (unsigned)((n_slots + kSlotWindow - 1) / kSlotWindow));
  if (rows > 0 && lanes > 1)
    count_kernel<true, PerSlot><<<grid, kSortThreads, 0, st>>>(
        slot, slot_map, stats, weights, n_in, rows, m, c, num_slots, n_slots,
        int_bound, counts, fraction, vmax);
  else if (rows > 0)
    count_kernel<false, PerSlot><<<grid, kSortThreads, 0, st>>>(
        slot, slot_map, stats, weights, n_in, rows, m, c, num_slots, n_slots,
        int_bound, counts, fraction, vmax);
}

}  // namespace

// lanes == 1: bins [m, k], stats [m, c], slot [m], weights [m], slot_map
// [n_in], phist [num_slots, k, n_bins, c], side [num_slots].  lanes > 1
// (class-stacked): stats, slot, weights, slot_map, phist and side gain a
// leading [lanes] axis, bins stay [m, k].  pairs != 0: the fused mode with
// the computed child chosen in the launch; slot holds raw child slots
// [0, 2 * num_slots), and slot_map and side are null.
extern "C" int udt_histogram(const int* bins, const float* stats,
                             const int* slot, const float* weights,
                             const int* slot_map, int n_in,
                             const float* phist, const int* side, int pairs,
                             float* out, int* iws, float* fws, long long m,
                             int lanes, int k, int c, int num_slots,
                             int n_bins, void* stream) {
  long long n_ints, n_floats;
  int err = udt_histogram_workspace(m, lanes, k, c, num_slots, n_bins,
                                    &n_ints, &n_floats);
  if (err) return err;
  if (pairs ? (phist == nullptr || side != nullptr || slot_map != nullptr
               || 2LL * num_slots * lanes >= 0x7fffffffLL)
            : (phist == nullptr) != (side == nullptr))
    return (int)cudaErrorInvalidValue;
  Tiling tl;
  tiling(k, n_bins, c, &tl);
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (int)(m * lanes), n_slots = num_slots * lanes;
  const long long maxp = max_partials(rows);
  const long long kbc = (long long)k * n_bins * c;
  Plan p = plan_layout(iws, lanes, n_slots, maxp);
  // values up to int_bound add as exact ints: no int32 sum of a lane's m of
  // them overflows, and each is exact in f32
  const float int_bound =
      (float)(m > 0 && 0x7fffffffLL / m < (1 << 24) ? 0x7fffffffLL / m
                                                     : 1 << 24);
  // fraction, vmax, scale_exp and counts (pairs: and the raw counts, vmax
  // and fraction) start at 0
  cudaError_t e = cudaMemsetAsync(
      iws, 0, sizeof(int) * (3LL * lanes + (pairs ? 7 : 1) * n_slots), st);
  if (e != cudaSuccess) return (int)e;
  if (pairs) {
    // the raw child slots; the map and side come from plan_kernel
    launch_count<true>(slot, nullptr, stats, weights, 0, rows, (int)m, c,
                       2 * num_slots, 2 * n_slots, lanes, int_bound,
                       p.raw_counts, p.raw_frac, p.raw_vmax, st);
    slot_map = p.pair_map;
    n_in = 2 * num_slots;
    side = p.side;
  } else {
    launch_count<false>(slot, slot_map, stats, weights, n_in, rows, (int)m,
                        c, num_slots, n_slots, lanes, int_bound, p.counts,
                        p.fraction, p.vmax, st);
  }
  const dim3 sort_grid((unsigned)((rows + kSortRows - 1) / kSortRows),
                       (unsigned)((n_slots + kSlotWindow - 1) / kSlotWindow));
  int wave_int = 0, wave_fixed = 0;
  if ((e = lanes > 1 ? tile_waves<true>(tl.smem, &wave_int, &wave_fixed)
                     : tile_waves<false>(tl.smem, &wave_int, &wave_fixed))
      != cudaSuccess)
    return (int)e;
  const int tiles = tl.n_ftiles * tl.n_btiles;
  plan_kernel<<<1, kPlanThreads, 0, st>>>(n_slots, num_slots, lanes, tiles,
                                          wave_int, wave_fixed, pairs != 0,
                                          p);
  if (rows > 0 && lanes > 1)
    scatter_kernel<true><<<sort_grid, kSortThreads, 0, st>>>(
        slot, slot_map, n_in, rows, (int)m, num_slots, n_slots, p.cursor,
        p.rows);
  else if (rows > 0)
    scatter_kernel<false><<<sort_grid, kSortThreads, 0, st>>>(
        slot, slot_map, n_in, rows, (int)m, num_slots, n_slots, p.cursor,
        p.rows);
  const long long ints_at = int_partials_at(maxp, n_slots, kbc, lanes);
  // chunks: one per slot plus at most one per partial
  const dim3 tile_grid((unsigned)(n_slots + maxp), (unsigned)tiles);
  const TileArgs a{bins, stats, weights, p, n_slots, num_slots, (int)m, k, c,
                   n_bins, tl, phist, side, out, fws, ints_at};
  if (lanes > 1)
    launch_tiles<true>(a, tile_grid, st);
  else
    launch_tiles<false>(a, tile_grid, st);
  long long multi_max = maxp;   // each multi slot has a partial
  if (multi_max > n_slots) multi_max = n_slots;
  if (multi_max > 0) {
    dim3 merge_grid((unsigned)((kbc + kMergeThreads - 1) / kMergeThreads),
                    (unsigned)(multi_max < kMergeSlotsInFlight
                                   ? multi_max : kMergeSlotsInFlight));
    merge_kernel<<<merge_grid, kMergeThreads, 0, st>>>(
        p, num_slots, kbc, ints_at, phist, side, out, fws);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* udt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
