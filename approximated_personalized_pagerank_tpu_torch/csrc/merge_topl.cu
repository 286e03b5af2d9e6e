// Fused basket merge for Hopper (sm_90a): per candidate row,
//
//     sort by id  ->  sum each run of equal ids  ->  top-l_pad by score
//
// Replaces the TPU kernel fused_merge_topl (approximated_personalized_pagerank_tpu/
// ops/pallas/merge_kernel.py, body _merge_kernel), which GRank's merge calls for
// every candidate row whose padded width lies in [256, 8192].
//
// Contract (the wrapper, ops/merge_kernel.py, checks shapes and types):
//   in : ids int32 [C, W] (dead slots PAD_ID = 2^31-1, no negative ids),
//        scores f32 [C, W]; W a power of two, 256 <= W <= 8192.
//   out: ids int32 [C, l_pad] (-1 padding), scores f32 [C, l_pad] (0 padding),
//        l_pad a power of two <= W, rows sorted by descending score.
//   A run of PAD ids is dropped.  Dead slots sort as -inf, so a live entry
//   of score 0 (damping 1) still beats a dead slot.
//
// What bounds it on an H100: each row is read once (8 B per element) and
// its top l_pad written once, so device memory sets a floor of
// C*W*8 + C*l_pad*8 bytes at 3.35 TB/s.  The work between is two bitonic
// networks of W/2 * log2(W) * (log2(W)+1) / 2 compare-exchanges each, which
// run in shared memory; at these widths the shared-memory traffic of the
// networks, not device memory, is expected to be what the kernel waits on.
//
// Design: one block per row.  The row's W (id, score) pairs live in dynamic
// shared memory (64 KB at W=8192, above the 48 KB static limit, hence the
// cudaFuncSetAttribute below), so device memory is touched once on the way
// in and once on the way out.  Then
//   1. a bitonic sort ascending by id, __syncthreads between stages;
//   2. each run start sums its run serially (runs are short: an id appears
//      at most once per successor basket) and every other slot, and every
//      PAD run, becomes dead (score -inf);
//   3. a bitonic sort descending by score, and the first l_pad slots are
//      written out.
// Warp shuffles for the short distances, a pruned top-k in place of the
// second full sort, and a fused candidate gather are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kPadId = 0x7fffffff;
constexpr int kMaxWidth = 8192;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void swap_pair(int* ids, float* sc, int a, int b) {
  int ti = ids[a];
  ids[a] = ids[b];
  ids[b] = ti;
  float ts = sc[a];
  sc[a] = sc[b];
  sc[b] = ts;
}

__global__ void merge_topl_kernel(const int* __restrict__ in_ids,
                                  const float* __restrict__ in_scores,
                                  int* __restrict__ out_ids,
                                  float* __restrict__ out_scores, int width,
                                  int l_pad) {
  extern __shared__ unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem);
  float* sc = reinterpret_cast<float*>(smem + sizeof(int) * width);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t row = blockIdx.x;
  const int* row_ids = in_ids + row * width;
  const float* row_sc = in_scores + row * width;
  for (int i = tid; i < width; i += nt) {
    ids[i] = row_ids[i];
    sc[i] = row_sc[i];
  }
  __syncthreads();

  const int half = width >> 1;

  // 1. bitonic sort ascending by id, scores carried.
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < half; p += nt) {
        int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        int l = i + j;
        bool asc = (i & k) == 0;
        int a = ids[i], b = ids[l];
        if (asc ? (a > b) : (a < b)) swap_pair(ids, sc, i, l);
      }
      __syncthreads();
    }
  }

  // 2. run sums.  A run start sums its run into its own slot: only the
  //    start's thread reads the run's later slots, and no thread writes
  //    a slot another thread reads.
  for (int i = tid; i < width; i += nt) {
    int id = ids[i];
    if ((i == 0 || ids[i - 1] != id) && id >= 0 && id != kPadId) {
      float s = sc[i];
      for (int e = i + 1; e < width && ids[e] == id; ++e) s += sc[e];
      sc[i] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < width; i += nt) {
    int id = ids[i];
    bool live = (i == 0 || ids[i - 1] != id) && id >= 0 && id != kPadId;
    if (!live) sc[i] = -CUDART_INF_F;
  }
  __syncthreads();

  // 3. bitonic sort descending by score, ids carried.
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < half; p += nt) {
        int i = 2 * p - (p & (j - 1));
        int l = i + j;
        bool desc = (i & k) == 0;
        float a = sc[i], b = sc[l];
        if (desc ? (a < b) : (a > b)) swap_pair(ids, sc, i, l);
      }
      __syncthreads();
    }
  }

  int* o_ids = out_ids + row * l_pad;
  float* o_sc = out_scores + row * l_pad;
  for (int i = tid; i < l_pad; i += nt) {
    float s = sc[i];
    bool live = s > -CUDART_INF_F;
    o_ids[i] = live ? ids[i] : -1;
    o_sc[i] = live ? s : 0.0f;
  }
}

}  // namespace

extern "C" {

// Launches the merge on `stream` for `rows` rows; returns the CUDA error
// code of the launch (0 on success).  Does not synchronise.
int ppr_merge_topl(const int* ids, const float* scores, int* out_ids,
                   float* out_scores, int rows, int width, int l_pad,
                   void* stream) {
  if (rows <= 0) return 0;
  if (width < 2 || width > kMaxWidth || (width & (width - 1)) != 0 ||
      l_pad < 1 || l_pad > width || (l_pad & (l_pad - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = static_cast<size_t>(width) * (sizeof(int) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      merge_topl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = width / 2 < kMaxThreads ? width / 2 : kMaxThreads;
  merge_topl_kernel<<<rows, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      ids, scores, out_ids, out_scores, width, l_pad);
  return static_cast<int>(cudaGetLastError());
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
