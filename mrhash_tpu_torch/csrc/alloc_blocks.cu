// K7-K9: block allocation on the card — the DDA candidate walk fused with
// the salted dedup scatter (K7), the compaction of the dedup scratch (K8)
// and the batched hash insert (K9: a lookup kernel and a one-CTA claim
// kernel).
//
// These replace no TPU kernel: the JAX package allocates with jnp ops
// (mrhash_tpu/ops/integrate.py alloc_candidates_*, dedup_candidates,
// alloc_blocks; mrhash_tpu/ops/hashtable.py insert).  The port ran the
// same steps as eager torch ops: a few hundred small launches and up to
// 13 host reads per frame.  Here an allocation round is five launches
// (the scratch fill, K7, K8, K9's two kernels) and one host read of the
// round's counts, taken by the wrapper (ops/alloc_blocks.py).  Every
// result equals the plain PyTorch twins bit for bit:
//   K7  ops/integrate.py::alloc_candidates_depth_ref (with
//       ::_tile_segments), ::alloc_candidates_points_ref (::_dda_visit,
//       block level) and ::dedup_scatter;
//   K8  ops/integrate.py::dedup_compact;
//   K9  ops/hashtable.py::insert_ref.
//
// Design:
//   - K7 is one thread per ray: a pixel of the stride-s, phase-rotated
//     grid of the depth image, an s x s tile of it (its nearest and
//     farthest return give the band, the tile path that GeoWrapper takes),
//     or a LiDAR point (along its camera ray or its normal).  It takes the
//     truncation band, the inverse projection and cam_to_world in the
//     twin's f32 operation order (-fmad=false, IEEE division and sqrt),
//     walks the block DDA for num_steps steps in registers, writes each
//     step's key and liveness at flat index step * R + ray (the twin's
//     stack(...).reshape(-1) order) and, given a scratch, does atomicMax
//     of that index into the step's salted scratch cell.  "Highest index
//     wins" is the twin's scatter_reduce("amax"), exactly; the cell hash
//     runs in uint32 arithmetic, as the twin's int64 halves emulate it.
//   - K8 is one CTA: 4 cells a thread a tile, a block-wide prefix sum, the
//     winners' keys written in cell order up to max_alloc_per_frame, the
//     count left on the card (stats[0]).  No nonzero, no host read.
//   - K9's lookup is one thread per key over the 17-slot probe window:
//     the fingerprint filter, the exact compare, and for a fingerprint
//     collision the exact compare over the whole window (no suspect cap).
//   - K9's claim kernel is one CTA of 1024 threads, since its steps are
//     ordered over the batch: the pending keys compacted in key order;
//     their (bucket, index) pairs sorted (bitonic, in a global workspace
//     that stays in L2) for the rank among same-bucket pending keys; the
//     (rank+1)-th free slot of the window; the election of the highest
//     pending index per slot by a second sort of (slot, index); prefix
//     ranked draws from the high and low heaps in key order; the writes of
//     pos, ptr, res, fp; the new heap counts in stats[1], stats[2].  Once
//     a map has settled a round has a handful of pending keys, so the
//     sorts are a few passes.
//
// Bound: K7 bytes — the frame (or its grid's pixels) or the points read
// once, 13 B written per candidate (key and liveness), one atomic per
// live candidate; K8 the scratch read once and the served keys written;
// K9 the probe windows read (17 fingerprints, a key compare) and the new
// slots written.  All three are small next to the frame's other work;
// what they remove is the host's dispatch of the torch ops and their
// syncs.
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr uint32_t kP0 = 73856093u;
constexpr uint32_t kP1 = 19349669u;
constexpr uint32_t kP2 = 83492791u;
constexpr int kBucketSize = 10;
constexpr int kNumProbes = 17;
constexpr int32_t kFree = -2;
constexpr int32_t kSdfBlock = 8;
constexpr int32_t kHighLanes = 512;
constexpr int32_t kLowLanes = 64;
constexpr float kFloatEps = 1e-6f;
constexpr float kCoordEps = 1e-5f;
constexpr int kWalkThreads = 256;
constexpr int kLookupThreads = 256;
constexpr int kOneCta = kScanCta;
constexpr int kCellsPerThread = 4;
constexpr int64_t kSortPad = INT64_MAX;

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// integrate.py::dedup_scatter's salted cell of a key
__device__ __forceinline__ int64_t dedup_cell(int32_t x, int32_t y,
                                              int32_t z, uint32_t salt,
                                              int64_t n_cells) {
  uint32_t h = avalanche((uint32_t)x * kP1 + salt);
  h = avalanche(h ^ ((uint32_t)y * kP2));
  h = avalanche(h ^ ((uint32_t)z * kP0));
  return (int64_t)(h % (uint64_t)n_cells);
}

// hashtable.py::fingerprint
__device__ __forceinline__ int32_t fingerprint(int32_t x, int32_t y,
                                               int32_t z) {
  uint32_t h = avalanche((uint32_t)x * 0x9E3779B1u);
  h = avalanche(h ^ ((uint32_t)y * 0x7FEB352Du));
  h = avalanche(h ^ ((uint32_t)z * 0x846CA68Bu));
  return (int32_t)(h == 0u ? 1u : h);
}

// hashtable.py::calculate_hash
__device__ __forceinline__ int64_t bucket_of(int32_t x, int32_t y, int32_t z,
                                             int64_t n_buckets) {
  const uint32_t h = ((uint32_t)x * kP0) ^ ((uint32_t)y * kP1) ^
                     ((uint32_t)z * kP2);
  return (int64_t)(h % (uint64_t)n_buckets);
}

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// torch.clamp(v, max=m): NaN stays NaN
__device__ __forceinline__ float clamp_max(float v, float m) {
  return v > m ? m : v;
}

// coords.py::_sign_aware_floor
__device__ __forceinline__ int32_t sign_aware_floor(float v) {
  return (int32_t)(v >= 0.0f ? floorf(v + kCoordEps) : ceilf(v - kCoordEps));
}

// coords.py::world_point_to_sdf_block, one axis
__device__ __forceinline__ int32_t block_of(float p, float vvs, float ext) {
  const float q = p / vvs;
  int32_t vp = sign_aware_floor(q + sign_f(q) * 0.5f);
  if (vp < 0) vp -= kSdfBlock - 1;
  const float pw = (float)vp * vvs;
  const float metric = ext * 8.0f * vvs;
  return sign_aware_floor(pw / metric);
}

struct Walk {
  int mode;  // 0 depth pixel grid, 1 points, 2 depth tiles
  // modes 0 and 2: the depth image (h x w, strides in elements); mode 0
  // walks pixels (py + s*a, px + s*b), b < ws; mode 2 s x s tiles, ws a
  // row, from pixel (py, px) of each, the far band if `far`
  const float* depth;
  int64_t rs, cs;
  int s, py, px, ws, row0, h, w, far;
  // mode 1: points f32[R,3], normals f32[R,3] or null (camera rays)
  const float* points;
  const float* normals;
  // the camera: fx, fy, cx, cy (f32 scalars), rot f32[3,3], trans f32[3]
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* rot;
  const float* trans;
  float t0, t1, mdist, vvs, ex, ey, ez;
  int64_t n_rays;
  int steps;
  int32_t* keys;
  uint8_t* valid;
  int32_t* scratch;  // null: walk only
  int64_t n_cells;
  uint32_t salt;
};

// camera.py::cam_to_world, per-axis sums in the twin's order
__device__ __forceinline__ void cam_to_world(const float* r, const float* t,
                                             float p0, float p1, float p2,
                                             float* w) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[i] = p0 * r[3 * i] + p1 * r[3 * i + 1] + p2 * r[3 * i + 2] + t[i];
}

__global__ void __launch_bounds__(kWalkThreads) alloc_walk_kernel(Walk a) {
  const int64_t ray = (int64_t)blockIdx.x * kWalkThreads + threadIdx.x;
  if (ray >= a.n_rays) return;
  float wmin[3], wmax[3];
  bool alive;
  if (a.mode != 1) {
    const int64_t gy = ray / a.ws, gx = ray % a.ws;
    float lo, hi;
    int64_t iy, ix;
    if (a.mode == 0) {
      // alloc_candidates_depth_ref: the band [d - t, d + t] of pixel
      // (iy, ix)
      iy = a.py + a.s * gy;
      ix = a.px + a.s * gx;
      const float d = a.depth[iy * a.rs + ix * a.cs];
      const float t = a.t0 + a.t1 * d;
      lo = clamp_max(d - t, a.mdist);
      hi = clamp_max(d + t, a.mdist);
      alive = d != 0.0f && lo < hi;
    } else {
      // integrate.py::_tile_segments: the tile's nearest and farthest
      // return (the image zero-padded to whole tiles), the near band on
      // even frames, the far band on odd ones, through pixel (py, px) of
      // the tile
      float dmin = INFINITY, dmax = -INFINITY;
      bool any = false;
      for (int u = 0; u < a.s; ++u) {
        const int64_t y = a.s * gy + u;
        for (int v = 0; v < a.s; ++v) {
          const int64_t x = a.s * gx + v;
          const float d = y < a.h && x < a.w ? a.depth[y * a.rs + x * a.cs]
                                             : 0.0f;
          if (d > 0.0f) {
            dmin = d < dmin ? d : dmin;
            dmax = d > dmax ? d : dmax;
            any = true;
          }
        }
      }
      const float t_lo = a.t0 + a.t1 * dmin;
      const float t_hi = a.t0 + a.t1 * dmax;
      const float a_max = clamp_max(dmin + t_lo, a.mdist);
      if (a.far) {
        const float near_end = dmax - t_hi;
        lo = clamp_max(near_end > a_max ? near_end : a_max, a.mdist);
        hi = clamp_max(dmax + t_hi, a.mdist);
      } else {
        lo = clamp_max(dmin - t_lo, a.mdist);
        hi = a_max;
      }
      alive = any && lo < hi;
      iy = a.py + a.s * gy;
      ix = a.px + a.s * gx;
    }
    const float rowf = (float)(int32_t)(iy + a.row0);
    const float colf = (float)(int32_t)ix;
    const float x = (colf - *a.cx - 0.5f) / *a.fx;
    const float y = (rowf - *a.cy - 0.5f) / *a.fy;
    cam_to_world(a.rot, a.trans, lo * x, lo * y, lo * 1.0f, wmin);
    cam_to_world(a.rot, a.trans, hi * x, hi * y, hi * 1.0f, wmax);
  } else {
    // alloc_candidates_points_ref: the band [r - t, r + t] along the
    // camera ray or the normal
    const float p0 = a.points[3 * ray], p1 = a.points[3 * ray + 1],
                p2 = a.points[3 * ray + 2];
    const float rng = sqrtf(p0 * p0 + p1 * p1 + p2 * p2);
    const float sr = rng == 0.0f ? 1.0f : rng;
    float w0 = p0 / sr, w1 = p1 / sr, w2 = p2 / sr;
    if (a.normals) {
      const float n0 = a.normals[3 * ray], n1 = a.normals[3 * ray + 1],
                  n2 = a.normals[3 * ray + 2];
      const float nn = sqrtf(n0 * n0 + n1 * n1 + n2 * n2);
      const float sn = nn == 0.0f ? 1.0f : nn;
      w0 = n0 / sn;
      w1 = n1 / sn;
      w2 = n2 / sn;
    }
    const float t = a.t0 + a.t1 * rng;
    const float dmin = clamp_max(rng - t, a.mdist);
    const float dmax = clamp_max(rng + t, a.mdist);
    alive = rng != 0.0f && dmin < dmax;
    const float lo = dmin - rng, hi = dmax - rng;
    cam_to_world(a.rot, a.trans, p0 + w0 * lo, p1 + w1 * lo, p2 + w2 * lo,
                 wmin);
    cam_to_world(a.rot, a.trans, p0 + w0 * hi, p1 + w1 * hi, p2 + w2 * hi,
                 wmax);
  }

  // integrate.py::_dda_visit(block_level=True)
  const float ext[3] = {a.ex, a.ey, a.ez};
  const float seg[3] = {wmax[0] - wmin[0], wmax[1] - wmin[1],
                        wmax[2] - wmin[2]};
  const float seg_len = sqrtf(seg[0] * seg[0] + seg[1] * seg[1] +
                              seg[2] * seg[2]);
  const float sl = seg_len == 0.0f ? 1.0f : seg_len;
  const float cell_metric = 8.0f * a.vvs;
  const float half = 0.5f * a.vvs;
  int32_t id[3], bound[3], istep[3];
  float tmax[3], tdelta[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dir = seg[i] / sl;
    const float step = sign_f(dir);
    const int32_t step01 = step > 0.0f ? 1 : 0;
    id[i] = block_of(wmin[i], a.vvs, ext[i]);
    const int32_t id_end = block_of(wmax[i], a.vvs, ext[i]);
    const float boundary = (float)((id[i] + step01) * kSdfBlock) * a.vvs -
                           half;
    const float safe = dir == 0.0f ? 1.0f : dir;
    const bool degenerate = fabsf(dir) < kFloatEps ||
                            fabsf(boundary - dir) < kFloatEps;
    tmax[i] = degenerate ? INFINITY : (boundary - wmin[i]) / safe;
    tdelta[i] = degenerate ? INFINITY : (step * cell_metric) / safe;
    bound[i] = (int32_t)((float)id_end + step);
    istep[i] = (int32_t)step;
  }
  for (int k = 0; k < a.steps; ++k) {
    const int64_t idx = (int64_t)k * a.n_rays + ray;
    a.keys[3 * idx] = id[0];
    a.keys[3 * idx + 1] = id[1];
    a.keys[3 * idx + 2] = id[2];
    a.valid[idx] = alive ? 1 : 0;
    if (alive && a.scratch)
      atomicMax(a.scratch + dedup_cell(id[0], id[1], id[2], a.salt,
                                       a.n_cells),
                (int32_t)idx);
    const bool ax_x = tmax[0] < tmax[1] && tmax[0] < tmax[2];
    const bool ax_z = !ax_x && tmax[2] < tmax[1];
    const int ax = ax_x ? 0 : (ax_z ? 2 : 1);
    id[ax] += istep[ax];
    const bool hit = id[ax] == bound[ax];
    tmax[ax] = tmax[ax] + tdelta[ax];
    alive = alive && !hit;
  }
}

// the scatter alone, for the rounds after the first
__global__ void __launch_bounds__(kWalkThreads) alloc_scatter_kernel(
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    int64_t n, int32_t* __restrict__ scratch, int64_t n_cells,
    uint32_t salt) {
  const int64_t i = (int64_t)blockIdx.x * kWalkThreads + threadIdx.x;
  if (i >= n || !valid[i]) return;
  atomicMax(scratch + dedup_cell(keys[3 * i], keys[3 * i + 1],
                                 keys[3 * i + 2], salt, n_cells),
            (int32_t)i);
}

// K8: the occupied scratch cells in cell order, capped at u_max; their
// candidates' keys to ukeys, the count to stats[0]
__global__ void __launch_bounds__(kOneCta) alloc_compact_kernel(
    const int32_t* __restrict__ scratch, int64_t n_cells,
    const int32_t* __restrict__ keys, int64_t u_max,
    int32_t* __restrict__ ukeys, int32_t* __restrict__ stats) {
  const int64_t tile = (int64_t)kOneCta * kCellsPerThread;
  int64_t base = 0;
  for (int64_t t0 = 0; t0 < n_cells && base < u_max; t0 += tile) {
    const int64_t c0 = t0 + (int64_t)threadIdx.x * kCellsPerThread;
    int32_t v[kCellsPerThread];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      v[j] = c0 + j < n_cells ? scratch[c0 + j] : -1;
      cnt += v[j] >= 0;
    }
    int total;
    int64_t o = base + block_scan(cnt, &total);
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      if (v[j] >= 0) {
        if (o < u_max) {
          const int64_t k = v[j];
          ukeys[3 * o] = keys[3 * k];
          ukeys[3 * o + 1] = keys[3 * k + 1];
          ukeys[3 * o + 2] = keys[3 * k + 2];
        }
        ++o;
      }
    }
    base += total;
  }
  if (threadIdx.x == 0) stats[0] = (int32_t)(base < u_max ? base : u_max);
}

struct Table {
  int32_t* pos;
  int32_t* ptr;
  int32_t* res;
  int32_t* fp;
  const int32_t* heap_high;
  const int32_t* heap_low;
  int64_t n_high, n_low;       // heap lengths
  int64_t high_count, low_count;
  int64_t n_buckets, capacity;
};

struct Batch {
  const int32_t* keys;   // i32[n_max,3]
  const int32_t* n_dev;  // the key count on the card, or null: n_host
  int64_t n_host, n_max;
  const int32_t* res;    // i32[n_max], or null: res_const for every key
  int32_t res_const;
  int64_t* slot;         // outputs per key
  int32_t* ptr;
  int32_t* res_out;
  uint8_t* was_new;
  uint8_t* present;
};

__device__ __forceinline__ int64_t batch_count(const Batch& b) {
  return b.n_dev ? (int64_t)*b.n_dev : b.n_host;
}

__device__ __forceinline__ int32_t batch_res(const Batch& b, int64_t i) {
  return b.res ? b.res[i] : b.res_const;
}

// K9, first kernel: hashtable.py::lookup of every key
__global__ void __launch_bounds__(kLookupThreads) alloc_lookup_kernel(
    Table t, Batch b) {
  const int64_t i = (int64_t)blockIdx.x * kLookupThreads + threadIdx.x;
  if (i >= batch_count(b)) return;
  const int32_t x = b.keys[3 * i], y = b.keys[3 * i + 1],
                z = b.keys[3 * i + 2];
  const int64_t base = bucket_of(x, y, z, t.n_buckets) * kBucketSize;
  const int32_t fpk = fingerprint(x, y, z);
  int64_t first = -1;
  for (int j = 0; j < kNumProbes; ++j) {
    const int64_t s = (base + j) % t.capacity;
    if (t.fp[s] == fpk) {
      first = s;
      break;
    }
  }
  int64_t slot = -1;
  if (first >= 0) {
    if (t.pos[3 * first] == x && t.pos[3 * first + 1] == y &&
        t.pos[3 * first + 2] == z) {
      slot = first;
    } else {  // a fingerprint collision: the exact compare over the window
      for (int j = 0; j < kNumProbes; ++j) {
        const int64_t s = (base + j) % t.capacity;
        if (t.ptr[s] != kFree && t.pos[3 * s] == x &&
            t.pos[3 * s + 1] == y && t.pos[3 * s + 2] == z) {
          slot = s;
          break;
        }
      }
    }
  }
  const bool found = slot >= 0;
  b.slot[i] = slot;
  b.ptr[i] = found ? t.ptr[slot] : kFree;
  b.res_out[i] = found ? t.res[slot] : batch_res(b, i);
  b.was_new[i] = 0;
  b.present[i] = found ? 1 : 0;
}

// Ascending bitonic sort of a[0, n) (n a power of two) by one CTA
__device__ void block_sort(int64_t* a, int64_t n) {
  for (int64_t k = 2; k <= n; k <<= 1) {
    for (int64_t j = k >> 1; j > 0; j >>= 1) {
      for (int64_t i = threadIdx.x; i < n; i += kOneCta) {
        const int64_t l = i ^ j;
        if (l > i) {
          const int64_t ai = a[i], al = a[l];
          const bool up = (i & k) == 0;
          if (up ? ai > al : ai < al) {
            a[i] = al;
            a[l] = ai;
          }
        }
      }
      __syncthreads();
    }
  }
}

// K9, second kernel: hashtable.py::insert_ref's claims for the keys the
// lookup did not find, by one CTA.  Workspace: sorted i64[p2] (p2 the
// least power of two >= n_max), pend, rank_slot and win i32[n_max] each.
__global__ void __launch_bounds__(kOneCta) alloc_claim_kernel(
    Table t, Batch b, int64_t* __restrict__ sorted,
    int32_t* __restrict__ pend, int32_t* __restrict__ rank_slot,
    int32_t* __restrict__ win, int32_t* __restrict__ stats) {
  const int64_t n = batch_count(b);
  // 1. the pending keys, in key order
  int64_t np = 0;
  for (int64_t i0 = 0; i0 < n; i0 += kOneCta) {
    const int64_t i = i0 + threadIdx.x;
    const int flag = i < n && !b.present[i];
    int total;
    const int o = block_scan(flag, &total);
    if (flag) pend[np + o] = (int32_t)i;
    np += total;
  }
  __syncthreads();
  int64_t high = t.high_count, low = t.low_count;
  if (np > 0) {
    int64_t p = 1;
    while (p < np) p <<= 1;
    // 2. the rank among same-bucket pending keys: sort (bucket, index)
    for (int64_t q = threadIdx.x; q < p; q += kOneCta) {
      int64_t v = kSortPad;
      if (q < np) {
        const int32_t* k = b.keys + 3 * (int64_t)pend[q];
        v = (bucket_of(k[0], k[1], k[2], t.n_buckets) << 32) | q;
      }
      sorted[q] = v;
    }
    __syncthreads();
    block_sort(sorted, p);
    for (int64_t q = threadIdx.x; q < np; q += kOneCta) {
      const int64_t v = sorted[q], bk = v >> 32;
      int64_t lo = 0, hi = q;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if ((sorted[mid] >> 32) < bk) lo = mid + 1; else hi = mid;
      }
      rank_slot[v & 0xffffffff] = (int32_t)(q - lo);
    }
    __syncthreads();
    // 3. the (rank + 1)-th free slot of the probe window, or -1
    for (int64_t q = threadIdx.x; q < np; q += kOneCta) {
      const int32_t* k = b.keys + 3 * (int64_t)pend[q];
      const int64_t base = bucket_of(k[0], k[1], k[2], t.n_buckets) *
                           kBucketSize;
      int want = rank_slot[q] + 1;
      int32_t slot = -1;
      for (int j = 0; j < kNumProbes; ++j) {
        const int64_t s = (base + j) % t.capacity;
        if (t.fp[s] == 0 && --want == 0) {
          slot = (int32_t)s;
          break;
        }
      }
      rank_slot[q] = slot;
      win[q] = 0;
    }
    __syncthreads();
    // 4. one winner per slot, the highest pending index: sort (slot,
    // index) and take each slot's last
    for (int64_t q = threadIdx.x; q < p; q += kOneCta)
      sorted[q] = q < np && rank_slot[q] >= 0
                      ? ((int64_t)rank_slot[q] << 32) | q : kSortPad;
    __syncthreads();
    block_sort(sorted, p);
    for (int64_t q = threadIdx.x; q < p; q += kOneCta) {
      const int64_t v = sorted[q];
      if (v == kSortPad) continue;
      const int64_t next = q + 1 < p ? sorted[q + 1] : kSortPad;
      if (next == kSortPad || (next >> 32) != (v >> 32))
        win[v & 0xffffffff] = 1;
    }
    __syncthreads();
    // 5. prefix-ranked heap draws in key order, and the writes
    int64_t got_high = 0, got_low = 0;
    for (int64_t q0 = 0; q0 < np; q0 += kOneCta) {
      const int64_t q = q0 + threadIdx.x;
      int64_t i = 0;
      int32_t r = -1;
      bool wh = false, wl = false;
      if (q < np) {
        i = pend[q];
        r = batch_res(b, i);
        wh = win[q] && r == 0;
        wl = win[q] && r == 1;
      }
      int th, tl;
      const int64_t rh = got_high + block_scan(wh, &th);
      const int64_t rl = got_low + block_scan(wl, &tl);
      const bool gh = wh && rh < high, gl = wl && rl < low;
      if (gh || gl) {
        int32_t pptr;
        if (gh) {
          int64_t h = high - 1 - rh;
          h = h < 0 ? 0 : (h > t.n_high - 1 ? t.n_high - 1 : h);
          pptr = t.heap_high[h] * kHighLanes;
        } else {
          int64_t h = low - 1 - rl;
          h = h < 0 ? 0 : (h > t.n_low - 1 ? t.n_low - 1 : h);
          pptr = t.heap_low[h] * kLowLanes;
        }
        const int64_t s = rank_slot[q];
        const int32_t* k = b.keys + 3 * i;
        t.pos[3 * s] = k[0];
        t.pos[3 * s + 1] = k[1];
        t.pos[3 * s + 2] = k[2];
        t.ptr[s] = pptr;
        t.res[s] = r;
        t.fp[s] = fingerprint(k[0], k[1], k[2]);
        b.slot[i] = s;
        b.ptr[i] = pptr;
        b.was_new[i] = 1;
        b.present[i] = 1;
      }
      got_high += th;
      got_low += tl;
    }
    high -= got_high < high ? got_high : high;
    low -= got_low < low ? got_low : low;
  }
  if (threadIdx.x == 0) {
    stats[0] = (int32_t)n;
    stats[1] = (int32_t)high;
    stats[2] = (int32_t)low;
  }
}

inline unsigned grid_of(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// K7: walk the rays (mode 0 depth pixels, 1 points, 2 depth tiles) and, with
// a scratch, scatter each live candidate's index into its salted cell.
// Returns cudaGetLastError().
extern "C" int mrhash_alloc_walk(
    int mode, const void* depth, int64_t rs, int64_t cs, int s, int py,
    int px, int ws, int row0, int h, int w, int far, const void* points,
    const void* normals, const void* fx, const void* fy, const void* cx, const void* cy,
    const void* rot, const void* trans, float t0, float t1, float mdist,
    float vvs, float ex, float ey, float ez, int64_t n_rays, int steps,
    void* keys, void* valid, void* scratch, int64_t n_cells, uint32_t salt,
    void* stream) {
  Walk a;
  a.mode = mode;
  a.depth = (const float*)depth;
  a.rs = rs;
  a.cs = cs;
  a.s = s;
  a.py = py;
  a.px = px;
  a.ws = ws;
  a.row0 = row0;
  a.h = h;
  a.w = w;
  a.far = far;
  a.points = (const float*)points;
  a.normals = (const float*)normals;
  a.fx = (const float*)fx;
  a.fy = (const float*)fy;
  a.cx = (const float*)cx;
  a.cy = (const float*)cy;
  a.rot = (const float*)rot;
  a.trans = (const float*)trans;
  a.t0 = t0;
  a.t1 = t1;
  a.mdist = mdist;
  a.vvs = vvs;
  a.ex = ex;
  a.ey = ey;
  a.ez = ez;
  a.n_rays = n_rays;
  a.steps = steps;
  a.keys = (int32_t*)keys;
  a.valid = (uint8_t*)valid;
  a.scratch = (int32_t*)scratch;
  a.n_cells = n_cells;
  a.salt = salt;
  if (n_rays > 0)
    alloc_walk_kernel<<<grid_of(n_rays, kWalkThreads), kWalkThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K7's scatter alone over stored candidates.  Returns cudaGetLastError().
extern "C" int mrhash_alloc_scatter(const void* keys, const void* valid,
                                    int64_t n, void* scratch, int64_t n_cells,
                                    uint32_t salt, void* stream) {
  if (n > 0)
    alloc_scatter_kernel<<<grid_of(n, kWalkThreads), kWalkThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const uint8_t*)valid, n, (int32_t*)scratch,
        n_cells, salt);
  return (int)cudaGetLastError();
}

// K8.  Returns cudaGetLastError().
extern "C" int mrhash_alloc_compact(const void* scratch, int64_t n_cells,
                                    const void* keys, int64_t u_max,
                                    void* ukeys, void* stats, void* stream) {
  alloc_compact_kernel<<<1, kOneCta, 0, (cudaStream_t)stream>>>(
      (const int32_t*)scratch, n_cells, (const int32_t*)keys, u_max,
      (int32_t*)ukeys, (int32_t*)stats);
  return (int)cudaGetLastError();
}

// K9: the lookup and the claims of a key batch; stats[0..2] get the key
// count and the new high and low heap counts.  Returns cudaGetLastError().
extern "C" int mrhash_alloc_insert(
    const void* keys, const void* n_dev, int64_t n_host, int64_t n_max,
    const void* res, int res_const, int64_t n_buckets, int64_t capacity,
    void* pos, void* ptr, void* res_tab, void* fp, const void* heap_high,
    int64_t n_high, int64_t high_count, const void* heap_low, int64_t n_low,
    int64_t low_count, void* out_slot, void* out_ptr, void* out_res,
    void* out_new, void* out_present, void* sorted, void* ws32,
    void* stats, void* stream) {
  Table t;
  t.pos = (int32_t*)pos;
  t.ptr = (int32_t*)ptr;
  t.res = (int32_t*)res_tab;
  t.fp = (int32_t*)fp;
  t.heap_high = (const int32_t*)heap_high;
  t.heap_low = (const int32_t*)heap_low;
  t.n_high = n_high;
  t.n_low = n_low;
  t.high_count = high_count;
  t.low_count = low_count;
  t.n_buckets = n_buckets;
  t.capacity = capacity;
  Batch b;
  b.keys = (const int32_t*)keys;
  b.n_dev = (const int32_t*)n_dev;
  b.n_host = n_host;
  b.n_max = n_max;
  b.res = (const int32_t*)res;
  b.res_const = res_const;
  b.slot = (int64_t*)out_slot;
  b.ptr = (int32_t*)out_ptr;
  b.res_out = (int32_t*)out_res;
  b.was_new = (uint8_t*)out_new;
  b.present = (uint8_t*)out_present;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_max > 0)
    alloc_lookup_kernel<<<grid_of(n_max, kLookupThreads), kLookupThreads, 0,
                          st>>>(t, b);
  int32_t* w = (int32_t*)ws32;
  alloc_claim_kernel<<<1, kOneCta, 0, st>>>(
      t, b, (int64_t*)sorted, w, w + n_max, w + 2 * n_max,
      (int32_t*)stats);
  return (int)cudaGetLastError();
}
