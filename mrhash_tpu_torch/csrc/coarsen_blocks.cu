// K10-K12: variance-adaptive coarsening on the card — the selection of
// the decided window entries fused with the frees, the heap pushes and
// the low-heap split (K10), the merge of each served fine block into a
// staging buffer fused with the clear of its window (K11), and the
// scatter of the staged coarse voxels into the blocks the insert drew
// (K12).  The res-1 insert between K11 and K12 is K9
// (csrc/alloc_blocks.cu).
//
// These replace no TPU kernel: the JAX package coarsens with jnp ops
// (mrhash_tpu/ops/integrate.py coarsen_by_variance,
// _downsample_into_coarse; mrhash_tpu/ops/hashtable.py free_slots,
// split_high_blocks).  The port ran the same steps as eager torch ops:
// ~150 small launches and ~17 host reads on a scan that coarsens.  Here a
// coarsening step is five launches (K10, K11, K9's two kernels, K12) and
// two host reads, taken by the wrapper (ops/coarsen_blocks.py): K10's
// counts, and K9's.  Against the plain PyTorch twin,
// ops/integrate.py::coarsen_by_variance_ref:
//   K10 equals free_slots, the freed mask and split_high_blocks bit for
//       bit (table, heaps, counts, the served keys in window order);
//   K11 + K12 equal _clear_blocks and _downsample_into_coarse in weight
//       and colour bit for bit (integer weights make every sum exact and
//       the division rounds correctly); sdf and sumsq sum the children in
//       the order of torch's reductions on a card, and divide by the half
//       voxel as a product with its reciprocal, as torch does there, so
//       they equal the twin run on a card (PORT_NOTES.md P71).
//
// Design:
//   - K10 is one CTA of 1024 threads, since its steps are ordered over
//     the window: 4 entries a thread a tile and a block-wide prefix sum
//     take the decided entries in window order up to max_coarsen_per_frame
//     (K8's compaction); each served entry writes its key row for K9, its
//     ptr and res, frees its table slot (ptr FREE; pos, res, fp 0) and its
//     freed flag; a second pass over the served entries pushes their block
//     ids on the high (res 0) or low (res 1) heap with prefix ranks, in
//     the twin's order; if the low heap is then shorter than the served
//     count, up to low_split_chunk ids are popped from the top of the high
//     heap (the ids just pushed first) and their 8 sub-block ids pushed on
//     the low heap.  stats gets (served, high count, low count).
//   - K11 is one CTA of 512 threads per served block: each thread reads
//     one fine voxel's four fields into shared memory and clears its lane
//     of the block's window; 64 threads then merge 8 children each into
//     one coarse voxel of the staging buffer.  The split can put a coarse
//     block in a row that was fine a moment before, so every fine row is
//     read to staging before K9 draws and K12 writes.
//   - K12 is one CTA of 64 threads per served block: where K9 inserted
//     it, the 64 staged voxels go to the block's lanes.
//
// Bound: bytes.  K10 reads the decisions, the served entries' slots,
// keys, ptrs and res, and writes the freed mask, the table's four
// fields, the key rows and the heap ids; K11 reads and clears 512 voxels
// of 16 B a served block and writes 64 staged voxels; K12 moves 64
// voxels.  A scan serves ~25 blocks, so all three are a few tens of KB:
// what they remove is the host's dispatch of ~150 torch ops and ~14 of
// their host reads.
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int32_t kFree = -2;
constexpr int32_t kHighLanes = 512;
constexpr int32_t kLowLanes = 64;
constexpr int32_t kBranch = 8;
constexpr int kPerThread = 4;

struct Select {
  const uint8_t* decide;  // bool[A]
  const int64_t* slots;   // i64[A]
  const int32_t* bpos;    // i32[A,3]
  int64_t n_window, cap;
  // the hash table, updated in place
  int32_t* pos;
  int32_t* ptr;
  int32_t* res;
  int32_t* fp;
  int32_t* heap_high;
  int32_t* heap_low;
  int64_t n_high, n_low;  // heap lengths
  int64_t high_count, low_count, split_chunk;
  // outputs
  uint8_t* freed;         // bool[A]
  int32_t* keys;          // i32[cap,3]
  int32_t* fptr;          // i32[cap]
  int32_t* fres;          // i32[cap]
  int32_t* stats;         // i32[4]
};

// K10: hashtable.py::free_slots over the first `cap` decided entries, the
// freed mask, and split_high_blocks where the low heap is short
__global__ void __launch_bounds__(kScanCta) coarsen_select_kernel(Select a) {
  // 1. the decided entries in window order, capped: their key rows, ptr
  // and res, their slots freed
  const int64_t tile = (int64_t)kScanCta * kPerThread;
  int64_t n = 0;
  for (int64_t t0 = 0; t0 < a.n_window; t0 += tile) {
    const int64_t i0 = t0 + (int64_t)threadIdx.x * kPerThread;
    bool d[kPerThread];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      d[j] = i0 + j < a.n_window && a.decide[i0 + j];
      cnt += d[j];
    }
    int total;
    int64_t o = n + block_scan(cnt, &total);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t i = i0 + j;
      if (i >= a.n_window) break;
      const bool take = d[j] && o < a.cap;
      a.freed[i] = take ? 1 : 0;
      if (take) {
        const int64_t s = a.slots[i];
        const int32_t p = a.ptr[s];
        a.keys[3 * o] = a.bpos[3 * i];
        a.keys[3 * o + 1] = a.bpos[3 * i + 1];
        a.keys[3 * o + 2] = a.bpos[3 * i + 2];
        a.fptr[o] = p;
        a.fres[o] = a.res[s];
        if (p != kFree) {
          a.ptr[s] = kFree;
          a.pos[3 * s] = 0;
          a.pos[3 * s + 1] = 0;
          a.pos[3 * s + 2] = 0;
          a.res[s] = 0;
          a.fp[s] = 0;
        }
      }
      o += d[j];
    }
    n += total;
  }
  const int64_t decided = n;
  if (n > a.cap) n = a.cap;
  __syncthreads();
  // 2. the occupied served entries' block ids on their heaps, in order
  int64_t high = a.high_count, low = a.low_count;
  for (int64_t o0 = 0; o0 < n; o0 += kScanCta) {
    const int64_t o = o0 + threadIdx.x;
    int32_t p = kFree;
    bool hi = false, lo = false;
    if (o < n) {
      p = a.fptr[o];
      hi = p != kFree && a.fres[o] == 0;
      lo = p != kFree && a.fres[o] != 0;
    }
    int th, tl;
    const int64_t rh = high + block_scan(hi, &th);
    const int64_t rl = low + block_scan(lo, &tl);
    if (hi && rh < a.n_high) a.heap_high[rh] = p / kHighLanes;
    if (lo && rl < a.n_low) a.heap_low[rl] = p / kLowLanes;
    high += th;
    low += tl;
  }
  __syncthreads();
  // 3. allocateMemoryLow: where the low heap is short, the top of the high
  // heap split into 8 sub-blocks each, in order
  if (low < n) {
    const int64_t m = a.split_chunk < high ? a.split_chunk : high;
    for (int64_t r = threadIdx.x; r < m; r += kScanCta) {
      const int32_t id = a.heap_high[high - 1 - r];
#pragma unroll
      for (int j = 0; j < kBranch; ++j) {
        const int64_t q = low + r * kBranch + j;
        if (q < a.n_low) a.heap_low[q] = id * kBranch + j;
      }
    }
    high -= m;
    low += m * kBranch;
  }
  if (threadIdx.x == 0) {
    a.stats[0] = (int32_t)n;
    a.stats[1] = (int32_t)high;
    a.stats[2] = (int32_t)low;
    a.stats[3] = (int32_t)(decided - n);   // decisions left unserved
  }
}

struct Pool {
  float* sdf;
  float* sumsq;
  int32_t* weight;
  int32_t* rgbp;
};

// torch's sum on a card of 8 (4) values v[i] over dims of size 2 whose
// fastest is summed, i counting the fastest dim first: one value a
// thread, then shuffles down by 4, 2, 1 (2, 1), so the slowest dim pairs
// first (measured on an H100, torch 2.11)
__device__ __forceinline__ float tree4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}

__device__ __forceinline__ float tree8(const float* v) {
  return tree4(v[0] + v[4], v[1] + v[5], v[2] + v[6], v[3] + v[7]);
}

// K11: one CTA per served block: its fine row into the staging buffer's
// 64 coarse voxels (integrate.py::_downsample_into_coarse) when `merge`,
// and its window cleared (integrate.py::_clear_blocks)
__global__ void __launch_bounds__(kHighLanes) coarsen_merge_kernel(
    const int32_t* __restrict__ fptr, const int32_t* __restrict__ fres,
    Pool pool, int merge, float half_voxel, float weight_max, Pool stage) {
  __shared__ float wf[kHighLanes], sd[kHighLanes], ssq[kHighLanes];
  __shared__ int32_t col[kHighLanes];
  const int64_t i = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t p = fptr[i];
  if (p == kFree) return;      // the whole CTA: nothing was freed
  if (merge) {
    const int64_t v = (int64_t)(p / kHighLanes) * kHighLanes + t;
    const float w = (float)pool.weight[v];
    wf[t] = w;
    sd[t] = pool.sdf[v];
    ssq[t] = w > 0.0f ? pool.sumsq[v] : 0.0f;
    col[t] = pool.rgbp[v];
  }
  __syncthreads();
  if (t < (fres[i] == 1 ? kLowLanes : kHighLanes)) {
    const int64_t v = (int64_t)p + t;
    pool.sdf[v] = 0.0f;
    pool.sumsq[v] = 0.0f;
    pool.weight[v] = 0;
    pool.rgbp[v] = 0;
  }
  if (!merge || t >= kLowLanes) return;
  // coarse lane t = cz*16 + cy*4 + cx; fine lane z*64 + y*8 + x with
  // (z, y, x) = 2 (cz, cy, cx) + (dz, dy, dx); child k = dz*4 + dy*2 + dx
  const int cz = t >> 4, cy = (t >> 2) & 3, cx = t & 3;
  int lane[8];
  float w[8], ws[8];
  float w_c = 0.0f, c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  float w_ax[3][2] = {};                 // per child axis, d = 0 / 1
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int l = (2 * cz + dz) * 64 + (2 * cy + dy) * 8 + 2 * cx + dx;
    lane[k] = l;
    w[k] = wf[l];
    ws[k] = w[k] * sd[l];
    const int32_t c = col[l];
    w_c += w[k];
    c_r += w[k] * (float)(c & 255);
    c_g += w[k] * (float)((c >> 8) & 255);
    c_b += w[k] * (float)((c >> 16) & 255);
    w_ax[0][dz] += w[k];
    w_ax[1][dy] += w[k];
    w_ax[2][dx] += w[k];
  }
  // the sdf sums in the order of the twin's torch reductions on a card,
  // so that sdf equals the twin's bit for bit (weights and colours are
  // exact in any order): the sum over the 8 children pairs dz, then dy,
  // then dx (tree8); a dz or dy half's sum over 4 children pairs the
  // other slow dim, then dx (tree4); a dx half's adds in turn, dy first
  const float s_c = tree8(ws);
  float s_ax[3][2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    s_ax[0][d] = tree4(ws[4 * d], ws[4 * d + 1], ws[4 * d + 2],
                       ws[4 * d + 3]);
    s_ax[1][d] = tree4(ws[2 * d], ws[2 * d + 1], ws[4 + 2 * d],
                       ws[5 + 2 * d]);
    s_ax[2][d] = ((ws[d] + ws[2 + d]) + ws[4 + d]) + ws[6 + d];
  }
  const float w_safe = w_c < 1.0f ? 1.0f : w_c;
  float m = s_c / w_safe;
  // de-bias: the coarse voxel's centre is its (0,0,0) child; correct the
  // mean by the per-axis SDF step times the centroid's offset, on axes
  // with data on both sides
  float corr = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float w_lo = w_ax[a][0], w_hi = w_ax[a][1];
    const float m_lo = s_ax[a][0] / (w_lo < 1.0f ? 1.0f : w_lo);
    const float m_hi = s_ax[a][1] / (w_hi < 1.0f ? 1.0f : w_hi);
    corr = corr + (w_lo > 0.0f && w_hi > 0.0f
                       ? (w_hi / w_safe) * (m_hi - m_lo) : 0.0f);
  }
  m = m - corr;
  // Chan's combination of the children's sumsq under the half-voxel
  // normalisation; torch divides a card tensor by a number as a product
  // with its reciprocal
  const float inv_half = 1.0f / half_voxel;
  float q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int l = lane[k];
    const float dev = (sd[l] - m) * inv_half;
    q[k] = ssq[l] + wf[l] * dev * dev;
  }
  const float ssq_c = tree8(q);
  const bool occ = w_c > 0.0f;
  const int32_t r = occ ? (int32_t)floorf(c_r / w_safe + 0.5f) : 0;
  const int32_t g = occ ? (int32_t)floorf(c_g / w_safe + 0.5f) : 0;
  const int32_t b = occ ? (int32_t)floorf(c_b / w_safe + 0.5f) : 0;
  const int64_t o = i * kLowLanes + t;
  stage.sdf[o] = occ ? m : 0.0f;
  stage.sumsq[o] = occ ? ssq_c : 0.0f;
  stage.weight[o] = (int32_t)(w_c > weight_max ? weight_max : w_c);
  stage.rgbp[o] = r | (g << 8) | (b << 16);
}

// K12: the staged coarse voxels of each served block that K9 inserted to
// its 64 lanes
__global__ void __launch_bounds__(kLowLanes) coarsen_scatter_kernel(
    const uint8_t* __restrict__ was_new, const int32_t* __restrict__ nptr,
    Pool stage, Pool pool) {
  const int64_t i = blockIdx.x;
  if (!was_new[i]) return;
  const int64_t o = i * kLowLanes + threadIdx.x;
  const int64_t v = (int64_t)nptr[i] + threadIdx.x;
  pool.sdf[v] = stage.sdf[o];
  pool.sumsq[v] = stage.sumsq[o];
  pool.weight[v] = stage.weight[o];
  pool.rgbp[v] = stage.rgbp[o];
}

Pool pool_of(void* sdf, void* sumsq, void* weight, void* rgbp) {
  Pool p;
  p.sdf = (float*)sdf;
  p.sumsq = (float*)sumsq;
  p.weight = (int32_t*)weight;
  p.rgbp = (int32_t*)rgbp;
  return p;
}

}  // namespace

// K10: select and free the decided entries, push their ids, split where
// the low heap is short; stats[0..3] get the served count, the new high
// and low heap counts, and the decisions the cap left unserved.  Returns
// cudaGetLastError().
extern "C" int mrhash_coarsen_select(
    const void* decide, const void* slots, const void* bpos,
    int64_t n_window, int64_t cap, void* pos, void* ptr, void* res,
    void* fp, void* heap_high, int64_t n_high, int64_t high_count,
    void* heap_low, int64_t n_low, int64_t low_count, int64_t split_chunk,
    void* freed, void* keys, void* fptr, void* fres, void* stats,
    void* stream) {
  Select a;
  a.decide = (const uint8_t*)decide;
  a.slots = (const int64_t*)slots;
  a.bpos = (const int32_t*)bpos;
  a.n_window = n_window;
  a.cap = cap;
  a.pos = (int32_t*)pos;
  a.ptr = (int32_t*)ptr;
  a.res = (int32_t*)res;
  a.fp = (int32_t*)fp;
  a.heap_high = (int32_t*)heap_high;
  a.heap_low = (int32_t*)heap_low;
  a.n_high = n_high;
  a.n_low = n_low;
  a.high_count = high_count;
  a.low_count = low_count;
  a.split_chunk = split_chunk;
  a.freed = (uint8_t*)freed;
  a.keys = (int32_t*)keys;
  a.fptr = (int32_t*)fptr;
  a.fres = (int32_t*)fres;
  a.stats = (int32_t*)stats;
  coarsen_select_kernel<<<1, kScanCta, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K11 over n served blocks; merge 0 clears only.  Returns
// cudaGetLastError().
extern "C" int mrhash_coarsen_merge(
    const void* fptr, const void* fres, int64_t n, void* sdf, void* sumsq,
    void* weight, void* rgbp, int merge, float half_voxel, float weight_max,
    void* st_sdf, void* st_sumsq, void* st_weight, void* st_rgbp,
    void* stream) {
  if (n > 0)
    coarsen_merge_kernel<<<(unsigned)n, kHighLanes, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)fptr, (const int32_t*)fres,
        pool_of(sdf, sumsq, weight, rgbp), merge, half_voxel, weight_max,
        pool_of(st_sdf, st_sumsq, st_weight, st_rgbp));
  return (int)cudaGetLastError();
}

// K12 over n served blocks.  Returns cudaGetLastError().
extern "C" int mrhash_coarsen_scatter(
    const void* was_new, const void* nptr, int64_t n, void* st_sdf,
    void* st_sumsq, void* st_weight, void* st_rgbp, void* sdf, void* sumsq,
    void* weight, void* rgbp, void* stream) {
  if (n > 0)
    coarsen_scatter_kernel<<<(unsigned)n, kLowLanes, 0,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)was_new, (const int32_t*)nptr,
        pool_of(st_sdf, st_sumsq, st_weight, st_rgbp),
        pool_of(sdf, sumsq, weight, rgbp));
  return (int)cudaGetLastError();
}
