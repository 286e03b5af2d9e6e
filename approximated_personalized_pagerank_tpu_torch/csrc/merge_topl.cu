// Fused basket merge for Hopper (sm_90a): per candidate row,
//
//     sort by id  ->  sum each run of equal ids  ->  top-l_pad by score
//
// Replaces the TPU kernel fused_merge_topl (approximated_personalized_pagerank_tpu/
// ops/pallas/merge_kernel.py, body _merge_kernel), which GRank's merge calls for
// every candidate row whose padded width lies in [256, 8192].
//
// Two entry points share one device-side core (merge_kernel below):
//   ppr_merge_topl         the matrix entry: rows of a [C, W] candidate matrix,
//                          ids int32 (dead slots PAD_ID or negative), scores
//                          f32; W a power of two in [2, 8192].
//   ppr_gather_merge_topl  the gather entry: each block builds its own row from
//                          the successors' baskets (ids int32 / scores f32
//                          [N, Lb]), succ int64 [C, D] padded with -1: every
//                          live basket entry of every valid successor, its
//                          score times scale[c], plus the self entry
//                          (rows[c], self_scores[c]) unless self_scores is
//                          null.  D*Lb (+1) <= 8192.  The [C, W] candidate
//                          matrix never reaches device memory.
// Both write [C, out_width] ids (-1 padding) and scores (0 padding), the first
// out_width <= l_pad slots of the row's top l_pad by descending score, times
// post_scale[c] when given.  A run of PAD ids is dropped; a live total of 0
// (damping 1) still beats every dead slot.
//
// What bounds it on an H100.  Device memory sets a floor of one read of each
// candidate (8 B, or the successor and basket bytes for the gather entry) and
// one write of each output slot, at 3.35 TB/s: about 10 us for Eat's widest
// chunk (517 rows of 8192).  The sort is the work between: W/2 * log2(W) *
// (log2(W)+1)/2 compare-exchanges per row, 372,736 at W=8192.  A sort that
// runs every stage through shared memory moves ~20 B per compare-exchange and
// waits on a block barrier per stage (182 per row for two sorts), which
// put the first version of this kernel 60x above the byte floor.  The design
// keeps the network out of shared memory:
//
//  1. Load.  Each slot becomes one 64-bit key (uint32(id) << 32 | score bits),
//     a negative id becoming PAD_ID.  One 64-bit compare orders by id, and
//     equal ids by score bits, so the sorted row, each run's summation order
//     and hence the output are bitwise deterministic and invariant under a
//     permutation of the row's candidates.  Slot e*T + t goes to thread t:
//     neighbouring threads read neighbouring slots (coalesced).  Slots past
//     the row's width are dead: the row is padded to a power of two
//     virtually.
//  2. Sort by id, register-resident.  Thread t holds E keys, elements
//     t*E .. t*E+E-1 of a bitonic network.  Distances below E run in
//     registers, distances below 32*E through __shfl_xor_sync, and only those
//     of 32*E and above through shared memory (10 of 91 stages at W=8192,
//     E=16, T=512): ~10 barriers per row instead of 182.  Shared-memory slots
//     are padded one per 16 (pad_idx), so a warp's 64-bit accesses at stride E
//     are free of bank conflicts.  Once the traffic is gone the sort is bound
//     by the instructions of its compare-exchanges, so the network is the
//     direction-free form (sort_keys), which spends none on a direction: the
//     form with directions took 0.22 ms at W=8192, C=517, this one 0.14 ms
//     (chip_smoke.py phase 1, H100 80GB HBM3, 700 W).
//  3. Run sums.  The sorted row goes to shared memory once; each run start
//     sums its run forward in sorted order.  Every other slot, and a PAD
//     run, is dead.
//  4. Top-l_pad, by the TPU kernel's rule.  That kernel sorts its row of W
//     slots by id (PAD slots last; W: the matrix entry's width, or the
//     gather entry's candidates padded to a power of two and to at least
//     l_pad, as _merge_rows pads them), sums each run into the run's last
//     slot (segmented_sum_sorted) and runs bitonic_prune_topk
//     (ops/bitonic.py:205), a network that compares scores alone, with
//     strict < and >.  So where two survivors hold one total, or the cut
//     falls inside a run of equal totals, the network's shape and each
//     total's run-end position p decide which ids survive and in what
//     order; p = (slots with id <= the run's id) - 1 depends only on the
//     row's multiset of ids.  This kernel computes the same function:
//     4a. A radix select over the order-preserving bits of the totals
//        (8-bit digits, shared-memory histograms with warp-aggregated
//        atomics, 4 passes; dead slots take no part) finds the l_pad-th
//        largest, thr.
//     4b. A row whose cut splits a run of equal totals is tied.
//     4c. The live totals, those above thr and (unless the row has no more
//        than l_pad) those equal to it, m of them, go to step 4d's map at
//        their positions p (step 3 keeps each run's last slot), and their
//        positions to a list, in block-scan order.  Unless the cut splits,
//        they are the survivors: compacted (~total << 32 | id) into
//        shared memory past the row, and one warp sorts them in registers
//        and shuffles (l_pad <= 256; the whole block for wider l_pad),
//        descending.  Survivors that repeat a total are now adjacent: such
//        a row is tied too.  Every other row has one answer, whatever the
//        rule for ties, and is written.
//     4d. A tied row runs the prune network (tied_topl) on the live totals
//        alone: the totals below thr never reach the output and move no
//        live one (a compare of a live total with a lower one goes one
//        way either way), so they are dead slots.  A stage of the network
//        is a no-op on two dead slots, and on a dead and a live slot its
//        result is fixed (the live total is the larger), so the network's
//        function follows from the live keys' moves alone: each key, in a
//        register with its slot, reads its partner's slot in a map of the
//        W slots in shared memory (64 KB at 8192, where the sorted row
//        was), moves, and writes; a prune round drops its losers.  That is
//        work in m, not W, and one barrier a stage among ceil(m/32) warps
//        (a key a lane, up to four).  Most tied GRank rows are repeat
//        only, m <= l_pad.  Where m is a large share of the row (a cut
//        inside thousands of equal visit counts) a stage of the live form
//        costs more than one pass over the row, and for m above n/4
//        (kLiveShare; n the sort width) the dense network runs instead
//        (prune_network: block-wide stages in shared memory, one barrier
//        each, dead k-blocks skipped, the prune rounds halving the row in
//        place).  On an H100 80GB HBM3 at 700 W (profile_port.py
//        tiebranch) the two forms are within 3% at m = n/4, the live one
//        ahead below and 18-19% behind at n/2 (widths 1024-2048); at
//        GRank's shape (8192, 517, 128) a tied row of m = 128 takes 1.16x
//        an untied one (the dense network 1.64x).  Two stages a barrier
//        (a key reads the four slots two stages touch) was slower: past a
//        few warps the live form is bound by instructions, not barriers.
//     Slots past the live count are written as (-1, 0).  Ids, scores and
//     order are bitwise the TPU kernel's wherever the run sums are exact
//     (visit counts, dyadic scores); elsewhere ties are decided on this
//     kernel's sums, which differ from the TPU kernel's scan in last bits.

// The gather entry's rows of 8192 sort by run (rows below 8192, and the
// matrix entry, keep steps 1-2 above).  The gather entry replaces the same
// TPU kernel with the gather that fed it, _bucket_candidates
// (approximated_personalized_pagerank_tpu/ops/merge.py:188).  A row is D
// runs, one successor's basket row of Lb keys each, and the self entry, a
// run of one.  Its bound is the same byte floor (the successor matrix, the
// basket rows read once and the output: 6.5 us for Eat's widest bucket);
// the network spends its instructions on dead slots (absent successors, -1
// tails, the power-of-two padding) and on sorting across keys of one run.
// The run merge (merge_kernel<16, true, true>):
//
//  a. Load by run.  A warp takes one successor at a time: its basket row is
//     read once, coalesced (slot e*32 + lane to key[e]), succ once a run.
//     Keys are packed as above, so every comparison, the summation order and
//     the output are bitwise the network's.
//  b. Sort each run inside its warp (sort_keys over next_pow2(Lb) keys,
//     Lb <= 512: at most 16 keys a lane, no block barrier) and write only its
//     live prefix; a warp scan of the live counts places the runs.
//  c. Merge the runs pairwise, ceil(log2(runs)) levels.  Each thread emits
//     outputs t*E .. t*E+E-1 of a level from a merge-path split (a binary
//     search on the diagonal, then one step a key); a level reads every key
//     into registers before a barrier and writes after it, so one buffer of
//     n keys (64 KB at 8192) suffices and two blocks share an SM.  The last
//     level's outputs stay in registers as step 3's input: the network's
//     sorted row without its dead slots.
//  d. Steps 3-4 as above (p is a key's index in the merged row: the keys
//     left out are all dead, and lie at the end of the TPU kernel's row);
//     warps whose keys are all past the live count skip the radix select's
//     per-key work, as do digit passes no key of a warp is in.
//
// Rows with Lb > 512 (D <= 16) or more than 512 runs keep the block network.
// Measured on an H100 (chip_smoke.py phases 1-4, PERF.md section 6): a merge
// step is a dependent shared-memory load and the binary searches add more,
// so the levels cost about what the network's cross-run stages do.  At 8192
// the run merge is a few percent faster than the network on real basket
// state; at 4096 and below it was slower (about 20% at 4096), hence the
// width it is launched at.  Sorting runs of 16 keys a lane in groups of
// lanes, and merging each thread's outputs through a register network,
// spilled under the 64-register cap and were slower; so was one block per
// SM; sorting only the span up to a run's last live slot gained nothing.
//
// Registers: E=16 keys are 32 registers; __launch_bounds__(512, 2) keeps two
// 512-thread blocks (W=8192) on an SM, each with 68 KB of dynamic shared
// memory for the row, 8.5 bytes a slot of l_pad for the survivors, and 2.5
// bytes a slot of the row for the run ends and step 4d's live list (92 KB
// at l_pad 512), above the 48 KB static limit, hence cudaFuncSetAttribute
// below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPadId = 0x7fffffffu;
constexpr int kMaxWidth = 8192;
constexpr int kMinSortWidth = 256;
constexpr unsigned kFull = 0xffffffffu;
// A dead candidate: PAD id, score 0.
constexpr uint64_t kDeadKey = static_cast<uint64_t>(kPadId) << 32;
// An empty slot of the top list: sorts after every survivor.
constexpr uint64_t kEmptyKey = ~0ull;

__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 4); }

// The kernel's dynamic shared memory, as step 4d's function sees it.
extern __shared__ uint64_t dyn_sm[];

__host__ __device__ constexpr int padded_words(int n) { return n + (n >> 4); }

__device__ __forceinline__ uint64_t pack(int id, float score) {
  const uint32_t u = id < 0 ? kPadId : static_cast<uint32_t>(id);
  return (static_cast<uint64_t>(u) << 32) | __float_as_uint(score);
}

__device__ __forceinline__ uint32_t key_id(uint64_t k) {
  return static_cast<uint32_t>(k >> 32);
}

__device__ __forceinline__ float key_score(uint64_t k) {
  return __uint_as_float(static_cast<uint32_t>(k));
}

// Order-preserving map of f32 bits to uint32: every non-NaN total maps to
// >= 1, so 0 marks a dead slot.
__device__ __forceinline__ uint32_t ordered(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t m) {
  return __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// Orders a pair ascending: the smaller key to a.
__device__ __forceinline__ void order_pair(uint64_t& a, uint64_t& b) {
  const uint64_t lo = umin64(a, b);
  b = umax64(a, b);
  a = lo;
}

// Keeps the smaller of mine and the partner's key when `keep_min`, else the
// larger.
__device__ __forceinline__ uint64_t keep(uint64_t mine, uint64_t other,
                                         bool keep_min) {
  return ((other < mine) == keep_min) ? other : mine;
}

// Shared-memory stage of the network: each pair (i, partner) with bit j of i
// clear, partner = i ^ (k-1) for the flip stage, i + j after it; the smaller
// key goes to i.
__device__ __forceinline__ void smem_stage(uint64_t* sm, int t, int nt, int n,
                                           int k, int j, bool flip) {
  for (int p = t; p < (n >> 1); p += nt) {
    const int i = 2 * p - (p & (j - 1));
    const int l = flip ? (i ^ (k - 1)) : (i + j);
    const uint64_t a = sm[pad_idx(i)], b = sm[pad_idx(l)];
    if (b < a) {
      sm[pad_idx(i)] = b;
      sm[pad_idx(l)] = a;
    }
  }
  __syncthreads();
}

// Bitonic sort, ascending, of the n = T*E keys held by the T participating
// threads (t = 0..T-1, whole warps): key[e] of thread t is element t*E + e.
// The network is the direction-free form: each merge of two sorted halves
// of k elements starts with a flip stage (i against i ^ (k-1)) and goes on
// with half-cleaners (i against i + j), every compare-exchange ascending, so
// no stage computes a direction.  Stages at distance >= 32*E go through `sm`
// (pad_idx layout, all threads of the block must call); a single warp
// (T = 32) never touches `sm`.
template <int E>
__device__ __forceinline__ void sort_keys(uint64_t (&key)[E], int t, int n,
                                          uint64_t* sm) {
  const int nt = n / E;
  // merges of up to E elements: inside each thread
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if ((e & (k >> 1)) == 0) order_pair(key[e], key[e ^ (k - 1)]);
#pragma unroll
    for (int jj = k >> 2; jj >= 1; jj >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & jj) == 0) order_pair(key[e], key[e | jj]);
    }
  }
  for (int k = 2 * E; k <= n; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * E) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm[pad_idx(t * E + e)] = key[e];
      __syncthreads();
      smem_stage(sm, t, nt, n, k, j, true);
      for (j >>= 1; j >= 32 * E; j >>= 1) smem_stage(sm, t, nt, n, k, j, false);
      // each thread reads back only the slots it wrote, so the next write
      // needs no barrier
#pragma unroll
      for (int e = 0; e < E; ++e) key[e] = sm[pad_idx(t * E + e)];
    } else {
      // flip: element t*E+e against (t ^ (k/E-1))*E + (E-1-e)
      const int m = k / E - 1;
      const bool low = (t & (j / E)) == 0;
#pragma unroll
      for (int e = 0; e < E / 2; ++e) {
        const uint64_t o1 = __shfl_xor_sync(kFull, key[E - 1 - e], m);
        const uint64_t o2 = __shfl_xor_sync(kFull, key[e], m);
        key[e] = keep(key[e], o1, low);
        key[E - 1 - e] = keep(key[E - 1 - e], o2, low);
      }
      if constexpr (E == 1) {
        const uint64_t o = __shfl_xor_sync(kFull, key[0], m);
        key[0] = keep(key[0], o, low);
      }
      j >>= 1;
    }
    for (; j >= E; j >>= 1) {
      // half-cleaner: element t*E+e against lane t ^ (j/E), same register
      const int m = j / E;
      const bool low = (t & m) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        key[e] = keep(key[e], __shfl_xor_sync(kFull, key[e], m), low);
    }
#pragma unroll
    for (int jj = E / 2; jj >= 1; jj >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & jj) == 0) order_pair(key[e], key[e | jj]);
    }
  }
}

// Exclusive prefix sum of v over the block's threads in thread order; the
// block total goes to *total.  ws holds 33 words.
__device__ __forceinline__ unsigned block_scan(unsigned v, int t, int nt,
                                               unsigned* ws, unsigned* total) {
  const int lane = t & 31, w = t >> 5, nw = nt >> 5;
  unsigned x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += o;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    const unsigned y = lane < nw ? ws[lane] : 0u;
    unsigned z = y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, z, off);
      if (lane >= off) z += o;
    }
    ws[lane] = z - y;
    if (lane == 31) ws[32] = z;
  }
  __syncthreads();
  *total = ws[32];
  return ws[w] + x - v;
}

// Sorts the first n = T*EF slots of s (T threads) ascending, in place.
template <int EF>
__device__ __forceinline__ void sort_in_place(int t, int n, uint64_t* s) {
  uint64_t key[EF];
#pragma unroll
  for (int e = 0; e < EF; ++e) key[e] = s[t * EF + e];
  if (n > 32 * EF) __syncthreads();  // the block sort overwrites s
  sort_keys<EF>(key, t, n, s);
  if (n > 32 * EF) __syncthreads();  // and reads it in another layout
#pragma unroll
  for (int e = 0; e < EF; ++e) s[t * EF + e] = key[e];
}

struct Gather {
  const int* basket_ids;      // [N, lb]
  const float* basket_scores; // [N, lb]
  long long n_basket;
  int lb;
  const long long* succ;      // [C, d], -1 padded
  int d;
  const long long* rows;      // [C], read when self_scores is set
  const float* scale;         // [C]
  const float* self_scores;   // [C] or null
};

// The run merge takes rows of kRunMergeWidth (below it the network is faster
// on the card: PERF.md section 6) of at most kMaxRuns runs (successors and
// the self entry) of at most kMaxRunWidth keys each.
constexpr int kRunMergeWidth = kMaxWidth;
constexpr int kMaxRuns = 512;
constexpr int kMaxRunWidth = 512;

// One warp loads basket row s (lb slots, slot e*32 + lane to key[e]:
// coalesced), sorts it ascending in registers and shuffles, writes its live
// prefix to sm[pad_idx(base + i)], and returns the live count.  Dead keys
// sort last, so the live keys are a prefix.
template <int EW>
__device__ __forceinline__ int sort_run(const Gather& g, long long s, float sc,
                                        int lane, uint64_t* sm, int base) {
  const int lb = g.lb;
  const int* ids = g.basket_ids + s * lb;
  const float* scs = g.basket_scores + s * lb;
  uint64_t key[EW];
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int p = e * 32 + lane;
    const int id = p < lb ? ids[p] : -1;
    key[e] = id >= 0 ? pack(id, scs[p] * sc) : kDeadKey;
  }
  sort_keys<EW>(key, lane, 32 * EW, sm);  // one warp: sm is not touched
  int live = 0;
#pragma unroll
  for (int e = 0; e < EW; ++e) live += key[e] != kDeadKey ? 1 : 0;
  live = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(live)));
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int i = lane * EW + e;
    if (i < live) sm[pad_idx(base + i)] = key[e];
  }
  return live;
}

// Merge-path split of the merge of sorted A[0, la) and B[0, lb) (ties from
// A first): how many of the first k outputs come from A.
__device__ __forceinline__ int merge_split(const uint64_t* sm, int a0, int la,
                                           int b0, int lb, int k) {
  int lo = k > lb ? k - lb : 0;
  int hi = k < la ? k : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sm[pad_idx(a0 + mid)] <= sm[pad_idx(b0 + k - 1 - mid)])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The runs of one merge level: pair p merges the runs of input groups 2p and
// 2p+1, each `s` original runs wide; cum[r] is the live count of original
// runs below r, so a group [r0, r1) holds cum[r1] - cum[r0] keys and writes
// its merged output to [cum[r0], cum[r1]).  Level 0 reads run r at r*lb.
struct Pair {
  int a0, la, b0, lb, end;
};

__device__ __forceinline__ Pair level_pair(const int* cum, int n_runs, int s,
                                           bool first, int lb, int p) {
  const int ra = min(2 * s * p, n_runs), rb = min(ra + s, n_runs),
            rc = min(rb + s, n_runs);
  Pair q;
  q.a0 = first ? ra * lb : cum[ra];
  q.b0 = first ? rb * lb : cum[rb];
  q.la = cum[rb] - cum[ra];
  q.lb = cum[rc] - cum[rb];
  q.end = cum[rc];
  return q;
}

// The gather entry's steps 1-2 by run: row `row`'s sorted live candidates,
// element t*E + e in key[e] (kDeadKey past the live count), as the network
// of sort_keys would leave them.  Warps sort one run each (a successor's
// basket row, or the self entry), the live counts are scanned into cum, and
// ceil(log2(runs)) levels of pairwise merges follow, each thread emitting
// outputs t*E .. t*E+E-1 of a level from a merge-path split.  A level reads
// every key before any is written (registers, then a barrier), so it merges
// in place; the last level's outputs stay in registers.  Returns the live
// count.
template <int E>
__device__ __forceinline__ int gather_by_run(const Gather& g, long long row,
                                              int t, int nt, uint64_t* sm,
                                              int* cum, uint64_t (&key)[E]) {
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int n_runs = g.d + (g.self_scores != nullptr ? 1 : 0);
  const float sc = g.scale[row];
  const long long* succ = g.succ + row * g.d;
  int ew = 1;
  while (32 * ew < g.lb) ew <<= 1;
  for (int r = warp; r < n_runs; r += nw) {
    int live = 0;
    if (r < g.d) {
      const long long s = succ[r];
      if (s >= g.n_basket) __trap();  // an out-of-range successor
      if (s >= 0) {
        const int base = r * g.lb;
        switch (ew) {
          case 1: live = sort_run<1>(g, s, sc, lane, sm, base); break;
          case 2: live = sort_run<2>(g, s, sc, lane, sm, base); break;
          case 4: live = sort_run<4>(g, s, sc, lane, sm, base); break;
          case 8: live = sort_run<8>(g, s, sc, lane, sm, base); break;
          default: live = sort_run<16>(g, s, sc, lane, sm, base); break;
        }
      }
    } else {  // the self entry, a run of one
      const uint64_t k = pack(static_cast<int>(g.rows[row]), g.self_scores[row]);
      live = k != kDeadKey ? 1 : 0;
      if (lane == 0) sm[pad_idx(r * g.lb)] = k;
    }
    if (lane == 0) cum[r + 1] = live;
  }
  if (t == 0) cum[0] = 0;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of cum[1 .. n_runs]
    const int per = (n_runs + 31) / 32;
    const int lo = 1 + lane * per;
    const int hi = min(lo + per, n_runs + 1);
    int own = 0;
    for (int i = lo; i < hi; ++i) own += cum[i];
    int x = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    int run = x - own;
    for (int i = lo; i < hi; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
  const int total = cum[n_runs];
  const int q0 = t * E;
  int levels = 0;
  while ((1 << levels) < n_runs) ++levels;
  if (levels == 0) {  // one run: it lies at 0 already
#pragma unroll
    for (int e = 0; e < E; ++e)
      key[e] = q0 + e < total ? sm[pad_idx(q0 + e)] : kDeadKey;
  }
  for (int lv = 0; lv < levels; ++lv) {
    const int s = 1 << lv;
    const bool first = lv == 0;
    const int n_pairs = (n_runs + 2 * s - 1) / (2 * s);
    if (q0 < total) {
      // the last pair whose output starts at or before q0: it holds q0
      int lo = 0, hi = n_pairs - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (cum[min(2 * s * mid, n_runs)] <= q0)
          lo = mid;
        else
          hi = mid - 1;
      }
      int p = lo;
      Pair q = level_pair(cum, n_runs, s, first, g.lb, p);
      const int start = q.end - q.la - q.lb;
      int i = merge_split(sm, q.a0, q.la, q.b0, q.lb, q0 - start);
      int j = q0 - start - i;
      uint64_t va = i < q.la ? sm[pad_idx(q.a0 + i)] : kEmptyKey;
      uint64_t vb = j < q.lb ? sm[pad_idx(q.b0 + j)] : kEmptyKey;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int pos = q0 + e;
        uint64_t out = kDeadKey;
        if (pos < total) {
          while (pos >= q.end) {  // the next pair starts at its diagonal 0
            q = level_pair(cum, n_runs, s, first, g.lb, ++p);
            i = 0;
            j = 0;
            va = q.la > 0 ? sm[pad_idx(q.a0)] : kEmptyKey;
            vb = q.lb > 0 ? sm[pad_idx(q.b0)] : kEmptyKey;
          }
          if (va <= vb) {
            out = va;
            ++i;
            va = i < q.la ? sm[pad_idx(q.a0 + i)] : kEmptyKey;
          } else {
            out = vb;
            ++j;
            vb = j < q.lb ? sm[pad_idx(q.b0 + j)] : kEmptyKey;
          }
        }
        key[e] = out;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) key[e] = kDeadKey;
    }
    if (lv + 1 < levels) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (q0 + e < total) sm[pad_idx(q0 + e)] = key[e];
      __syncthreads();
    }
  }
  __syncthreads();  // every read of sm is done before step 3 writes it
  return total;
}

// One compare-exchange stage of the TPU kernel's top-k network at distance j
// (< k) over logical slots [0, len), len a multiple of 2j: logical slot q is
// sm[pad_idx((q / k) * span + q % k)] (a k-block's slots stay together while
// the prune rounds halve the row in place), its code in the high word.  The
// pair (q, q + j) with bit j of q clear sorts descending where bit `dir` of q
// is set (clear, with `flip`; everywhere, with `all_desc`), else ascending;
// equal codes never swap.
__device__ __forceinline__ void net_stage(uint64_t* sm, int t, int nt, int len,
                                          int j, int k_shift, int span, int dir,
                                          bool flip, bool all_desc) {
  const int k_mask = (1 << k_shift) - 1;
  for (int p = t; p < (len >> 1); p += nt) {
    const int q = 2 * p - (p & (j - 1));
    const bool desc = all_desc || (((q & dir) != 0) != flip);
    const int a = (q >> k_shift) * span + (q & k_mask);
    const uint64_t x = sm[pad_idx(a)], y = sm[pad_idx(a + j)];
    const uint32_t cx = key_id(x), cy = key_id(y);
    if (desc ? cx < cy : cx > cy) {
      sm[pad_idx(a)] = y;
      sm[pad_idx(a + j)] = x;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) & ~(m - 1); }

// The TPU kernel's top-k (bitonic_prune_topk, approximated_personalized_
// pagerank_tpu/ops/bitonic.py:205) on the w slots of sm, code << 32 | id with
// code 0 dead: afterwards slots 0..k-1 hold the row's top k, descending, equal
// codes in the order that network leaves them.  k = w: a bitonic sort,
// descending.  Else k-blocks sort ascending and descending in turn; then each
// round keeps, in each pair of blocks, the larger of each two slots k apart
// (the first block's on a tie) and merges the survivors back into blocks of
// alternating direction, descending in the last round.  Blocks past `live`
// (one past the last live slot) hold only dead slots and take no part: a
// compare-exchange of two dead slots never swaps.
__device__ __forceinline__ void prune_network(uint64_t* sm, int t, int nt, int w,
                                              int k, int live) {
  const int k_shift = __ffs(k) - 1;
  if (k == w) {
    for (int size = 2; size <= w; size <<= 1)
      for (int j = size >> 1; j >= 1; j >>= 1)
        net_stage(sm, t, nt, round_up(live, size), j, k_shift, k, size, true, false);
    return;
  }
  for (int size = 2; size <= k; size <<= 1)
    for (int j = size >> 1; j >= 1; j >>= 1)
      net_stage(sm, t, nt, round_up(live, size), j, k_shift, k, size, false, false);
  int blocks = (live + k - 1) >> k_shift;  // k-blocks that may hold a live slot
  int span = k;                            // the stride of k-blocks in sm
  for (int wc = w; wc > k; wc >>= 1) {
    for (int p = t; p < (blocks >> 1) << k_shift; p += nt) {
      const int a = (p >> k_shift) * 2 * span + (p & (k - 1));
      const uint64_t y = sm[pad_idx(a + span)];
      if (key_id(y) > key_id(sm[pad_idx(a)])) sm[pad_idx(a)] = y;
    }
    __syncthreads();
    blocks = (blocks + 1) >> 1;
    span <<= 1;
    for (int j = k >> 1; j >= 1; j >>= 1)
      net_stage(sm, t, nt, blocks << k_shift, j, k_shift, span, k, false, wc == 2 * k);
  }
}

// Step 4d's live form (the note): prune_network's function computed on the
// m live keys alone, by the first nw warps, each lane with K keys: lane t's
// key[e] is key i = e*32*nw + t of `live` (the positions, in scan order),
// pos[e] its slot (-1: none).  The map, map[P] over the row's w slots (no
// padding: the accesses are scattered anyway), holds each live key at its
// slot and 0 elsewhere, in prune_network's layout (logical slot q at
// (q / k) * span + q % k), so a partner at distance j < k is slot ^ j and
// a prune round's partner slot ^ span.  A key reads and writes only its
// own pair's slots in a stage, and no other pair touches them, so a stage
// is a map read, a write and one barrier, before the next stage's reads.
// Once a few warps take part this is bound by the instructions of the
// keys' stages: the keys are spread one a lane over as many warps as the
// block has before a lane takes two or four.
constexpr int kLiveKeysPerLane = 4;  // at most
// The live form runs while m <= n / kLiveShare (n: the row's sort width);
// above, the dense network (prune_network) does: the live keys are then a
// large share of the row, and a stage of the live form costs more than the
// dense one's pass over it.  Measured on an H100 (PERF.md section 6,
// `python3 profile_port.py tiebranch`): the two are within 3% at n/4 at
// widths 1024-8192, and the live form 18-19% behind at n/2.
constexpr int kLiveShare = 4;

// The most live keys the live form takes in a row of sort width n, nt
// threads.
__host__ __device__ constexpr int live_cap(int n, int nt) {
  return n / kLiveShare < kLiveKeysPerLane * nt ? n / kLiveShare : kLiveKeysPerLane * nt;
}

// A barrier of the first nw warps.
__device__ __forceinline__ void group_sync(int nw) {
  if (nw == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
}

// A slot's code: the high word of its key.
__device__ __forceinline__ uint32_t code_at(const uint64_t* map, int slot) {
  return reinterpret_cast<const uint32_t*>(map)[2 * slot + 1];
}

// One stage at distance j.  Every key reads its partner's code (a pair's
// two keys each read the other's slot before either writes: each writes
// only after its own read, and only the slot it moves to, or its own); a
// key whose partner holds an equal code stays, and any other goes to the
// pair's lower slot if it is the larger of the two and the pair sorts
// descending, or the smaller and it sorts ascending (a dead slot, code 0,
// is the smaller); a key that moves writes its new slot and, beside a dead
// partner, clears its old one.  The pair sorts descending where (bit dbit
// of its slot) ^ fm is set: fm = dbit flips the direction, dbit = 0 and
// fm = 1 make every pair descending.
template <int K>
__device__ __forceinline__ void live_stage(uint64_t* map, const uint64_t (&key)[K],
                                           int (&pos)[K], int nw, int j, int dbit, int fm) {
  uint32_t co[K];
#pragma unroll
  for (int e = 0; e < K; ++e) co[e] = pos[e] >= 0 ? code_at(map, pos[e] ^ j) : 0u;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const int p = pos[e];
    const uint32_t cm = key_id(key[e]);
    if (p < 0 || co[e] == cm) continue;
    const bool desc = ((p & dbit) ^ fm) != 0;
    const int to = desc == (cm > co[e]) ? (p & ~j) : (p | j);
    if (to != p) {
      map[to] = key[e];
      if (co[e] == 0) map[p] = 0;
      pos[e] = to;
    }
  }
  group_sync(nw);
}

// One prune round: the first block's key stays unless its partner's code
// is larger; a second block's key that wins takes the first block's slot
// (its own leaves the halved row; the first block's key never writes).  A
// loser drops out.
template <int K>
__device__ __forceinline__ void live_prune(uint64_t* map, const uint64_t (&key)[K],
                                           int (&pos)[K], int nw, int span) {
  uint32_t co[K];
#pragma unroll
  for (int e = 0; e < K; ++e) co[e] = pos[e] >= 0 ? code_at(map, pos[e] ^ span) : 0u;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const int p = pos[e];
    if (p < 0) continue;
    const uint32_t cm = key_id(key[e]);
    if ((p & span) == 0) {
      if (co[e] > cm) pos[e] = -1;
    } else if (cm > co[e]) {
      map[p ^ span] = key[e];
      pos[e] = p ^ span;
    } else {
      pos[e] = -1;
    }
  }
  group_sync(nw);
}

// prune_network's stages, k = l_pad over w slots, on the live keys alone.
template <int K>
__device__ void live_network(uint64_t* map, const uint16_t* live, int t, int nw, int m,
                             int w, int k) {
  uint64_t key[K];
  int pos[K];
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const int i = e * 32 * nw + t;
    pos[e] = i < m ? static_cast<int>(live[i]) : -1;
    key[e] = pos[e] >= 0 ? map[pos[e]] : 0ull;
  }
  group_sync(nw);  // a partner may write this slot in the first stage
  if (k == w) {  // a full sort, descending where the size bit is clear
    for (int size = 2; size <= w; size <<= 1)
      for (int j = size >> 1; j >= 1; j >>= 1)
        live_stage<K>(map, key, pos, nw, j, size, size);
    return;
  }
  for (int size = 2; size <= k; size <<= 1)
    for (int j = size >> 1; j >= 1; j >>= 1)
      live_stage<K>(map, key, pos, nw, j, size, 0);
  int span = k;
  for (int wc = w; wc > k; wc >>= 1) {
    live_prune<K>(map, key, pos, nw, span);
    span <<= 1;
    const bool last = wc == 2 * k;
    for (int j = k >> 1; j >= 1; j >>= 1)
      live_stage<K>(map, key, pos, nw, j, last ? 0 : span, last ? 1 : 0);
  }
}

// Step 4d (the note) on a tied row: the m live totals (code << 32 | id) at
// their positions in the map, dyn_sm over the row's net_width slots (when
// m <= live_cap(n, nt), unpadded, with `live` their positions; else the dense
// network's pad_idx layout, live_end one past the last).  Runs the prune
// network, live form or dense by m, and writes the top out_width.  Out of
// line: only tied rows call it.
__device__ __noinline__ void tied_topl(int t, int nt, int n, int net_width, int l_pad, int m,
                                       int live_end, const uint16_t* live, int* o_ids,
                                       float* o_sc, int out_width, float post) {
  const bool live_form = m <= live_cap(n, nt);
  if (live_form) {
    const int per = m <= nt ? 1 : m <= 2 * nt ? 2 : 4;
    const int nw = (m + 32 * per - 1) / (32 * per);
    if (t < 32 * nw) {
      switch (per) {
        case 1: live_network<1>(dyn_sm, live, t, nw, m, net_width, l_pad); break;
        case 2: live_network<2>(dyn_sm, live, t, nw, m, net_width, l_pad); break;
        default: live_network<4>(dyn_sm, live, t, nw, m, net_width, l_pad); break;
      }
    }
    __syncthreads();
  } else {
    prune_network(dyn_sm, t, nt, net_width, l_pad, live_end);
  }
  for (int i = t; i < out_width; i += nt) {
    const uint64_t k = dyn_sm[live_form ? i : pad_idx(i)];
    const uint32_t code = key_id(k);
    o_ids[i] = code != 0 ? static_cast<int>(static_cast<uint32_t>(k)) : -1;
    o_sc[i] = code != 0 ? unordered(code) * post : 0.0f;
  }
}

// Threads of the widest row a kernel with E keys a thread sorts: E=16 for
// rows of 4096 and 8192, E=8 below.
template <int E>
constexpr int max_threads() {
  return E == 8 ? 2048 / 8 : kMaxWidth / E;
}

// kByRun: the gather entry's run merge (steps a-d of the note), its own
// instantiation, so the network kernels keep their registers.
template <int E, bool kGather, bool kByRun = false>
__global__ void __launch_bounds__(max_threads<E>(), 2)
    merge_kernel(const int* __restrict__ in_ids,
                 const float* __restrict__ in_scores, int width, Gather g,
                 const float* __restrict__ post_scale, int* __restrict__ out_ids,
                 float* __restrict__ out_scores, int out_width, int l_pad,
                 int net_width, unsigned long long* __restrict__ tie_counts) {
  extern __shared__ uint64_t sm[];
  __shared__ unsigned hist[256];
  __shared__ unsigned ws[33];
  __shared__ unsigned sel[3];  // prefix, need, all-live flag
  __shared__ int cum[kByRun ? kMaxRuns + 1 : 1];
  __shared__ int live_end;  // one past the last live total's position (4d)

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int n = nt * E;
  const int lane = t & 31;
  const long long row = blockIdx.x;

  // 1-2. load and sort by id: by run, or slot e*nt + t to thread t, then
  //      one network over the row
  uint64_t key[E];
  int live_n = n;  // keys t*E + e at or past live_n are dead
  if constexpr (kByRun) {
    live_n = gather_by_run<E>(g, row, t, nt, sm, cum, key);
  } else if constexpr (kGather) {
    const float sc = g.scale[row];
    const int w_real = g.d * g.lb;
    const long long* succ = g.succ + row * g.d;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * nt + t;
      uint64_t k = kDeadKey;
      if (i < w_real) {
        const int dd = i / g.lb;
        const long long s = succ[dd];
        if (s >= 0) {
          if (s >= g.n_basket) __trap();  // an out-of-range successor
          const long long off = s * g.lb + (i - dd * g.lb);
          const int id = g.basket_ids[off];
          if (id >= 0) k = pack(id, g.basket_scores[off] * sc);
        }
      } else if (i == w_real && g.self_scores != nullptr) {
        k = pack(static_cast<int>(g.rows[row]), g.self_scores[row]);
      }
      key[e] = k;
    }
  } else {
    const int* ids = in_ids + row * width;
    const float* scs = in_scores + row * width;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * nt + t;
      key[e] = i < width ? pack(ids[i], scs[i]) : kDeadKey;
    }
  }
  if constexpr (!kByRun) sort_keys<E>(key, t, n, sm);
  // the run merge skips per-key work in warps that hold only dead keys, and
  // digit passes that no key of the warp is in
  const bool warp_dead = kByRun && (t & ~31) * E >= live_n;

  // 3. run sums: a live run start sums its run forward; the rest is dead (0).
  //    The run's last slot, p, goes to run_end at the start's slot (step 4d
  //    reads it in the same thread).
  uint64_t* top = sm + padded_words(n);
  const int n_final = l_pad < 32 ? 32 : l_pad;
  uint16_t* live = reinterpret_cast<uint16_t*>(top + padded_words(n_final));
  uint16_t* run_end = live + live_cap(n, nt);
#pragma unroll
  for (int e = 0; e < E; ++e) sm[pad_idx(t * E + e)] = key[e];
  __syncthreads();
  uint32_t tot[E];
  uint32_t ids[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    const uint32_t id = key_id(key[e]);
    bool start = true;
    if (e > 0) {
      start = key_id(key[e - 1]) != id;
    } else if (i > 0) {
      start = key_id(sm[pad_idx(i - 1)]) != id;
    }
    uint32_t m = 0;
    if (start && id != kPadId) {
      float s = key_score(key[e]);
      int q = i + 1;
      for (; q < n; ++q) {
        const uint64_t kq = sm[pad_idx(q)];
        if (key_id(kq) != id) break;
        s += key_score(kq);
      }
      m = ordered(s + 0.0f);  // -0.0 becomes +0.0, as in the TPU kernel's scan
      run_end[i] = static_cast<uint16_t>(q - 1);
    }
    tot[e] = m;
    ids[e] = id;
  }

  // 4a. radix select: the l_pad-th largest live total, thr, and how many of
  //     the totals equal to it survive (need).  all_live: every live total
  //     survives (no more than l_pad of them).
  uint32_t prefix = 0, need = static_cast<uint32_t>(l_pad);
  bool all_live = false;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = t; b < 256; b += nt) hist[b] = 0;
    __syncthreads();
    const uint32_t mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (warp_dead) break;
      const bool in = tot[e] != 0 && (tot[e] & mask) == prefix;
      if (kByRun && pass > 0 && !__any_sync(kFull, in)) continue;
      const unsigned dg = in ? (tot[e] >> shift) & 0xffu : 256u;
      const unsigned peers = __match_any_sync(kFull, dg);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[dg], __popc(peers));
    }
    __syncthreads();
    if (t < 32) {
      unsigned h[8];
      unsigned own = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        h[b] = hist[lane * 8 + b];
        own += h[b];
      }
      unsigned above = own;  // keys in this lane's bins and all higher ones
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_down_sync(kFull, above, off);
        if (lane + off < 32) above += o;
      }
      const unsigned total = __shfl_sync(kFull, above, 0);
      if (pass == 0 && total <= need) {
        if (lane == 0) {
          sel[0] = 0;
          sel[1] = 0;
          sel[2] = 1;
        }
      } else {
        unsigned cum = above - own;
#pragma unroll
        for (int b = 7; b >= 0; --b) {
          if (cum < need && cum + h[b] >= need) {
            sel[0] = prefix | (static_cast<uint32_t>(lane * 8 + b) << shift);
            sel[1] = need - cum;
            sel[2] = 0;
          }
          cum += h[b];
        }
      }
    }
    __syncthreads();
    prefix = sel[0];
    need = sel[1];
    if (sel[2]) {
      all_live = true;
      break;
    }
  }
  const uint32_t thr = prefix;  // 0 when all_live: every live total is > 0
  // the sorted row is read no more: its words become step 4d's map, all
  // dead (the block scan's barriers order this before the map is filled)
  for (int i = t; i < padded_words(n); i += nt) sm[i] = 0ull;
  if (t == 0) live_end = 0;

  // 4b. the survivors: the totals above thr and, unless all_live, `need` of
  //     those equal to it.  A row whose cut splits a run of equal totals is
  //     tied: the TPU kernel's network decides which of them survive.
  unsigned cnt = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cnt += tot[e] > thr ? 1u : 0u;
    cnt += (!all_live && tot[e] == thr) ? (1u << 16) : 0u;
  }
  unsigned total;
  const unsigned base = block_scan(cnt, t, nt, ws, &total);
  const bool split = !all_live && (total >> 16) > need;

  // 4c. the live totals (those above thr and, unless all_live, those equal
  //     to it; m of them) go to step 4d's map at their positions p, and
  //     their positions, in scan order, to `live`.  Unless split, they are
  //     the survivors: compacted (~total << 32 | id) into `top`, shared
  //     memory past the row, and sorted descending by total.  Survivors
  //     that repeat a total are adjacent now; a row that has them is tied
  //     too, as the network decides their order.  Every other row has one
  //     answer, written from `top`.
  const unsigned n_gt = total & 0xffffu;
  const int m_live = static_cast<int>(n_gt + (total >> 16));
  const bool live_form = m_live <= live_cap(n, nt);  // step 4d's map unpadded
  {
    unsigned gt_pos = base & 0xffffu, eq_pos = n_gt + (base >> 16);
    int end = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool above = tot[e] > thr;
      if (above || (!all_live && tot[e] == thr)) {
        const unsigned idx = above ? gt_pos++ : eq_pos++;
        const int p = run_end[t * E + e];
        sm[live_form ? p : pad_idx(p)] = (static_cast<uint64_t>(tot[e]) << 32) | ids[e];
        if (live_form) live[idx] = static_cast<uint16_t>(p);
        if (!split) top[idx] = (static_cast<uint64_t>(~tot[e]) << 32) | ids[e];
        end = p + 1;  // p grows with e
      }
    }
    end = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(end)));
    if (lane == 0 && end > 0) atomicMax(&live_end, end);
  }
  int repeat = 0;
  if (!split) {
    const int kept = static_cast<int>(n_gt + (all_live ? 0u : need));
    for (int i = kept + t; i < n_final; i += nt) top[i] = kEmptyKey;
    __syncthreads();
    if (n_final <= 256) {
      if (t < 32) {  // one warp, in registers and shuffles
        switch (n_final) {
          case 32: sort_in_place<1>(t, 32, top); break;
          case 64: sort_in_place<2>(t, 64, top); break;
          case 128: sort_in_place<4>(t, 128, top); break;
          default: sort_in_place<8>(t, 256, top); break;
        }
      }
    } else {
      // l_pad >= 512 >= nt, and l_pad <= n, so l_pad / nt is 1..E
      switch (n_final / nt) {
        case 1: sort_in_place<1>(t, n_final, top); break;
        case 2: sort_in_place<2>(t, n_final, top); break;
        case 4: sort_in_place<4>(t, n_final, top); break;
        case 8: sort_in_place<8>(t, n_final, top); break;
        default:
          if constexpr (E >= 16) sort_in_place<16>(t, n_final, top);
          break;
      }
    }
    __syncthreads();
    for (int i = t; i + 1 < kept; i += nt)
      repeat |= key_id(top[i]) == key_id(top[i + 1]) ? 1 : 0;
  }
  const bool tied = __syncthreads_or(repeat) || split;
  if (tie_counts != nullptr && tied && t == 0) {
    atomicAdd(tie_counts + (split ? 0 : 1), 1ull);
    atomicAdd(tie_counts + 2 + (m_live <= 128 ? 0 : m_live <= 512 ? 1 : m_live <= 2048 ? 2 : 3),
              1ull);
  }
  const float post = post_scale != nullptr ? post_scale[row] : 1.0f;
  int* o_ids = out_ids + row * out_width;
  float* o_sc = out_scores + row * out_width;
  if (!tied) {
    for (int i = t; i < out_width; i += nt) {
      const uint64_t k = top[i];
      const bool live = k != kEmptyKey;
      o_ids[i] = live ? static_cast<int>(static_cast<uint32_t>(k)) : -1;
      o_sc[i] = live ? unordered(~key_id(k)) * post : 0.0f;
    }
    return;
  }

  tied_topl(t, nt, n, net_width, l_pad, m_live, live_end, live, o_ids, o_sc, out_width, post);
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int E, bool kGather, bool kByRun = false>
int launch(int rows, int n, const int* ids, const float* scores, int width,
           const Gather& g, const float* post_scale, int* out_ids,
           float* out_scores, int out_width, int l_pad, int net_width,
           unsigned long long* tie_counts, cudaStream_t stream) {
  // the row, then the survivors (step 4c), then the live positions (4d)
  // and the run ends (3)
  const int smem = (padded_words(n) + padded_words(l_pad < 32 ? 32 : l_pad)) *
                       static_cast<int>(sizeof(uint64_t)) +
                   (live_cap(n, n / E) + n) * static_cast<int>(sizeof(uint16_t));
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<E, kGather, kByRun>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<E, kGather, kByRun><<<rows, n / E, smem, stream>>>(
      ids, scores, width, g, post_scale, out_ids, out_scores, out_width, l_pad,
      net_width, tie_counts);
  return static_cast<int>(cudaGetLastError());
}

// n: the row's sort width, a power of two in [256, 8192].  E=16 keys a thread
// from 4096 up (256 and 512 threads), E=8 below (32 to 256 threads).
// net_width: the width of the TPU kernel's row, <= n (step 4d).  by_run: the
// gather entry's run merge (n == kRunMergeWidth).
template <bool kGather>
int dispatch(int rows, int n, const int* ids, const float* scores, int width,
             const Gather& g, const float* post_scale, int* out_ids,
             float* out_scores, int out_width, int l_pad, int net_width,
             unsigned long long* tie_counts, void* stream, bool by_run = false) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (by_run)
    return launch<16, true, true>(rows, n, ids, scores, width, g, post_scale,
                                  out_ids, out_scores, out_width, l_pad,
                                  net_width, tie_counts, st);
  if (n >= 4096)
    return launch<16, kGather>(rows, n, ids, scores, width, g, post_scale,
                               out_ids, out_scores, out_width, l_pad, net_width,
                               tie_counts, st);
  return launch<8, kGather>(rows, n, ids, scores, width, g, post_scale, out_ids,
                            out_scores, out_width, l_pad, net_width, tie_counts,
                            st);
}

}  // namespace

extern "C" {

// tie_counts, in both entries: null, or six counters.  Each row that takes
// step 4d adds one to the first when its cut splits a run of equal totals,
// else to the second (only survivors repeat a total), and one to the third
// to sixth by its live count m: <= 128, <= 512, <= 2048, above.

// The matrix entry.  Launches on `stream` for `rows` rows of width `width`;
// writes [rows, l_pad].  Returns the CUDA error code of the launch (0 on
// success).  Does not synchronise.
int ppr_merge_topl(const int* ids, const float* scores, int* out_ids,
                   float* out_scores, int rows, int width, int l_pad,
                   unsigned long long* tie_counts, void* stream) {
  if (rows <= 0) return 0;
  if (width < 2 || width > kMaxWidth || !pow2(width) || !pow2(l_pad) ||
      l_pad > width)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = width < kMinSortWidth ? kMinSortWidth : width;
  Gather g{};
  return dispatch<false>(rows, n, ids, scores, width, g, nullptr, out_ids,
                         out_scores, l_pad, l_pad, width, tie_counts, stream);
}

// The gather entry.  Row c's candidates are the live entries of the baskets
// of succ[c, :] (scaled by scale[c]) and, when self_scores is not null, the
// self entry (row_ids[c], self_scores[c]).  Writes [rows, out_width], the
// first out_width slots of the top l_pad, scores times post_scale[c] (when
// not null).  Returns the CUDA error code of the launch.
int ppr_gather_merge_topl(const int* basket_ids, const float* basket_scores,
                          long long n_basket, int lb, const long long* succ,
                          int d, const long long* row_ids, const float* scale,
                          const float* self_scores, const float* post_scale,
                          int* out_ids, float* out_scores, int rows,
                          int out_width, int l_pad,
                          unsigned long long* tie_counts, void* stream) {
  if (rows <= 0) return 0;
  const long long w = static_cast<long long>(d) * lb + (self_scores ? 1 : 0);
  if (lb < 1 || d < 0 || w < 1 || w > kMaxWidth || !pow2(l_pad) ||
      l_pad > kMaxWidth || out_width < 1 || out_width > l_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  // the TPU kernel's row: the candidates padded to a power of two, and to
  // at least l_pad (ops/merge_kernel.py::pad_candidates)
  int net_width = next_pow2(static_cast<int>(w));
  if (net_width < l_pad) net_width = l_pad;
  const int n = net_width < kMinSortWidth ? kMinSortWidth : net_width;
  const int n_runs = d + (self_scores ? 1 : 0);
  const bool by_run =
      n == kRunMergeWidth && lb <= kMaxRunWidth && n_runs <= kMaxRuns;
  Gather g{basket_ids, basket_scores, n_basket, lb, succ, d, row_ids, scale,
           self_scores};
  return dispatch<true>(rows, n, nullptr, nullptr, 0, g, post_scale, out_ids,
                        out_scores, out_width, l_pad, net_width, tie_counts,
                        stream, by_run);
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
