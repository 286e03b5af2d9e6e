// Monte-Carlo walk cohort for Hopper (sm_90a): one whole source chunk of
// MCCompletePathV2's trace engine (ops/walk.py::walk_trace_chunk) in one
// launch.
//
// It replaces no TPU kernel: the JAX package's walker is jnp under a
// while_loop (its ops/walk.py), which XLA fuses into a few device loops.
// The port's plain version is the same hop written as ~37 small PyTorch
// ops on a [C, S] cohort, each a launch, with a host read of "any walk
// alive" per 32-hop macro step: on Eat ~490k launches a job, the card idle
// over 90% of it.  This kernel walks the chunk with no launch per hop and
// no host read until the chunk is done.
//
// Function (bit for bit the plain loop, ops/walk.py::_cohort_hop, and so
// the JAX package's walks):
//   * one warp per source row c, the row's slot s on lane s (S <= 32); cur,
//     alive and the row's pool of unstarted walks (rem) stay in registers
//     for the whole chunk;
//   * the draws are threefry-2x32 (utils/prng.py): macro step t's keys are
//     split(fold_in(key, t)); hop h's uniform of slot (c, s) hashes the
//     flat index (h * row_total + row_offset + c) * S + s of the
//     (unroll, row_total, S) draw, and its bits b1 ^ b2 become
//     ((b1 ^ b2) >> 9 | 0x3F800000) - 1 as a float;
//   * a hop: j = min(trunc(u * float(deg)), deg - 1) in float32 round to
//     nearest (the stratified first hop: (trunc(u[c, 0] * deg) + s) mod
//     max(deg, 1)); a walk ends where it is alive and stands at a dangling
//     node or draws u2 > damping; ending slots claim unstarted walks by
//     their inclusive rank among the row's ending slots (ballot + popc);
//     the trace column (t * unroll + h) * S + s gets the node stepped to,
//     or SENTINEL for an idle slot;
//   * a row whose slots are all dead at the start of a macro step stops
//     and fills the rest of its trace row with SENTINEL: rows never
//     interact, and such a row would only record SENTINEL, so the trace
//     equals that of a loop that runs until no row of the chunk is alive.
//     Each row writes its abandoned walks (alive slots + rem) and raises
//     the chunk's count of macro steps begun to its own.
//
// What bounds it on an H100.  Per slot and hop: two threefry hashes (20
// rounds each, ~200 integer instructions together), a 16-byte read of
// start_deg[cur], an 8-byte read of indices[start + j] that depends on it,
// and a 4-byte trace store.  Eat's CSR (~2.9 MB) sits in L2, so the byte
// floor is the trace write (~15 MB a 512-row chunk, ~5 us at 3.35 TB/s)
// and the integer floor ~2 us; what sets the time is the chain of the two
// dependent L2 reads a hop, ~0.5-1 us, times the chunk's ~450 hops.  The
// design keeps everything else off that chain: no state or draw goes to
// device memory, and the draws of a hop are computed while its first read
// is in flight.  A wider chunk (the 4.8M-node north star's 32,768 rows)
// puts more warps on each SM to hide the same latency.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
// Source rows a block: one warp each.
constexpr int ROWS_PER_BLOCK = 4;
// A trace slot with no visit (ops/basket.py::SENTINEL).
constexpr int SENTINEL = -1;
// Threefry-2x32's key-schedule parity constant (Salmon et al., SC'11).
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2) under
// the key (k1, k2): utils/prng.py::threefry2x32.
__device__ __forceinline__ Words threefry2x32(uint32_t k1, uint32_t k2, uint32_t x1,
                                              uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ KS_PARITY};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = rotl(x2, kRot[i & 1][r]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x1, x2};
}

// jax.random.uniform's float32 of the element at flat index idx under key k.
__device__ __forceinline__ float uniform_at(Words k, unsigned long long idx) {
  const Words h = threefry2x32(k.a, k.b, static_cast<uint32_t>(idx >> 32),
                               static_cast<uint32_t>(idx));
  return __uint_as_float(((h.a ^ h.b) >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
walk_cohort_kernel(const long long* __restrict__ start_deg,  // [n, 2]
                   const long long* __restrict__ indices,    // [E]
                   const long long* __restrict__ sources,    // [rows]
                   const float* __restrict__ damping_ptr,    // 0-d
                   int rows, int slots, int macro_steps, int unroll, long long total,
                   bool stratified, long long row_offset, long long row_total,
                   uint32_t k1, uint32_t k2,
                   int* __restrict__ trace,        // [rows, macro_steps * unroll * slots]
                   long long* __restrict__ info) {  // [rows] abandoned, then macro steps
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (c >= rows) return;  // the whole warp
  const bool is_slot = lane < slots;
  const float damping = *damping_ptr;
  const long long src = sources[c];
  const long long hop_cols = static_cast<long long>(unroll) * slots;
  const long long width = macro_steps * hop_cols;
  int* const row_trace = trace + c * width;

  // _cohort_init: a dangling source starts with nothing
  const bool has_edges = start_deg[2 * src + 1] > 0;
  long long cur = src;
  bool alive = is_slot && has_edges && lane < total;
  long long rem = has_edges ? max(total - slots, 0LL) : 0LL;
  // the draw's flat index of this slot at hop 0; hop h adds h * hop_stride
  const unsigned long long idx0 = static_cast<unsigned long long>(row_offset + c) * slots + lane;
  const unsigned long long hop_stride = static_cast<unsigned long long>(row_total) * slots;

  int step = 0;
  for (; step < macro_steps; ++step) {
    if (!__any_sync(FULL_MASK, alive)) break;
    const Words kt = threefry2x32(k1, k2, 0u, static_cast<uint32_t>(step));
    const Words k_choice = threefry2x32(kt.a, kt.b, 0u, 0u);
    const Words k_cont = threefry2x32(kt.a, kt.b, 0u, 1u);
    int* const out = row_trace + step * hop_cols + lane;
#pragma unroll 2
    for (int h = 0; h < unroll; ++h) {
      long long start = 0, deg = 0;
      if (is_slot) {
        start = start_deg[2 * cur];
        deg = start_deg[2 * cur + 1];
      }
      const unsigned long long idx = idx0 + h * hop_stride;
      const float u = uniform_at(k_choice, idx);
      const float u2 = uniform_at(k_cont, idx);
      const bool dead_end = deg == 0;
      const bool stepping = alive && !dead_end;
      const float degf = static_cast<float>(deg);
      long long j;
      if (stratified && step == 0 && h == 0) {
        const float u_first = __shfl_sync(FULL_MASK, u, 0);
        j = (static_cast<long long>(__fmul_rn(u_first, degf)) + lane) % max(deg, 1LL);
      } else {
        j = min(static_cast<long long>(__fmul_rn(u, degf)), max(deg - 1, 0LL));
      }
      const long long nxt = stepping ? indices[start + j] : 0LL;
      const bool walk_ends = alive && (dead_end || u2 > damping);
      const unsigned ends = __ballot_sync(FULL_MASK, walk_ends);
      const int rank = __popc(ends & (FULL_MASK >> (31 - lane)));  // inclusive
      const bool restart = walk_ends && rank <= rem;
      rem = max(rem - __popc(ends), 0LL);
      alive = (alive && !walk_ends) || restart;
      cur = (stepping && !walk_ends) ? nxt : src;
      if (is_slot) out[h * slots] = stepping ? static_cast<int>(nxt) : SENTINEL;
    }
  }
  for (long long col = step * hop_cols + lane; col < width; col += 32) {
    row_trace[col] = SENTINEL;
  }
  const int live = __popc(__ballot_sync(FULL_MASK, alive));
  if (lane == 0) {
    info[c] = live + rem;
    atomicMax(reinterpret_cast<unsigned long long*>(info + rows),
              static_cast<unsigned long long>(step));
  }
}

}  // namespace

extern "C" {

// Walks `rows` source rows on `stream`: writes trace [rows, macro_steps *
// unroll * slots] (int32), info[0..rows) the rows' abandoned walks and
// info[rows] the most macro steps any row began (int64).  Returns the CUDA
// error code of the launch (0 on success).
int ppr_walk_cohort(const void* start_deg, const void* indices, const void* sources,
                    const void* damping, int rows, int slots, int macro_steps, int unroll,
                    long long total, int stratified, long long row_offset,
                    long long row_total, unsigned k1, unsigned k2, void* trace, void* info,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* const out_info = static_cast<long long*>(info);
  cudaError_t err = cudaMemsetAsync(out_info + rows, 0, sizeof(long long), s);
  if (err != cudaSuccess || rows == 0) return static_cast<int>(err);
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  walk_cohort_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, s>>>(
      static_cast<const long long*>(start_deg), static_cast<const long long*>(indices),
      static_cast<const long long*>(sources), static_cast<const float*>(damping), rows,
      slots, macro_steps, unroll, total, stratified != 0, row_offset, row_total, k1, k2,
      static_cast<int*>(trace), out_info);
  return static_cast<int>(cudaGetLastError());
}

const char* ppr_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
