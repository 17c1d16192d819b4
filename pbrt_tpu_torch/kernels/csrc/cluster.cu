// Tile×cluster ray-tracing kernels for Hopper (sm_90a): coverage, closest
// hit and any hit, plus two probe kernels built on the same helpers. Plain
// C interface, loaded with ctypes by pbrt_tpu_torch/kernels/cluster_cuda.py
// and kernels/probes.py, which also hold the plain PyTorch version of each
// kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libcluster.so cluster.cu
//
// Every product and sum is rounded on its own (-fmad=false, and the
// __fmul_rn/__fadd_rn intrinsics, which are never fused), in the order
// the plain PyTorch version evaluates them, so the two agree bit for bit.
//
// Layouts (nt tiles of `tile` lanes, lanes sorted by coherence key):
//   rays     (8, nt*tile) f32   ox oy oz dx dy dz tmin tmax
//   bounds   (6, cpad)    f32   lo_x hi_x lo_y hi_y lo_z hi_z per cluster,
//                               zero in pad columns
//   packed   (C, 24, k)   f32   0:3 U0 | 3:6 V0 | 6:9 U1 | 9:12 V1 |
//                               12:15 U2 | 15:18 V2 | 18:21 n | 21 k_plane
//   tnear    (nt, W)      f32   per-tile entry t, ascending (closest hit)
//   corder   (nt, W)      i32   matching cluster ids
//   covbits  (nt, cpad/32, tile) i32  bit c%32 of word c/32: lane enters c
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCovClusters = 128;   // clusters per coverage block
constexpr int kThreads = 256;       // threads per coverage block
constexpr int kTraceThreads = 512;  // threads per closest-hit and any-hit block
constexpr int kMaxLanes = 4;        // lanes per thread: tile <= 1024
constexpr int kNF = 24;             // features per triangle slot
constexpr int kMaxCH = 16;          // clusters per closest-hit round
constexpr int kSlotMask = 2047;     // low mantissa bits of t carry the slot
constexpr float kBig = 3e37f;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ------------------------------------------------------------- coverage
// One block per (tile, 128 clusters); each thread owns up to 4 lanes.
// Slab test t = b·inv + (−o·inv), far t ×1.0001, hit iff tn <= tf.
// tnear is the min entry t over the tile's lanes (warp shuffle, then
// shared memory); covbits words are ORed per lane over 32 clusters.
__global__ void __launch_bounds__(kThreads) coverage_kernel(
    const float* __restrict__ rays, const float* __restrict__ bounds,
    const int* __restrict__ n_live_tiles, float* __restrict__ tnear,
    int* __restrict__ covbits, int nt, int tile, int cpad, int n_clusters) {
  const int t = blockIdx.y;
  const int c0 = blockIdx.x * kCovClusters;
  const int nwords = kCovClusters / 32;
  int* cb = covbits + ((size_t)t * (cpad / 32) + c0 / 32) * tile;
  if (t >= n_live_tiles[0]) {   // dead lanes sort to the suffix
    for (int i = threadIdx.x; i < kCovClusters; i += blockDim.x)
      tnear[(size_t)t * cpad + c0 + i] = CUDART_INF_F;
    for (int i = threadIdx.x; i < nwords * tile; i += blockDim.x) cb[i] = 0;
    return;
  }
  __shared__ float sb[6][kCovClusters];
  __shared__ float smin[kThreads / 32][kCovClusters];
  for (int i = threadIdx.x; i < 6 * kCovClusters; i += blockDim.x)
    sb[i / kCovClusters][i % kCovClusters] =
        bounds[(size_t)(i / kCovClusters) * cpad + c0 + i % kCovClusters];
  __syncthreads();

  const size_t nl = (size_t)nt * tile;
  const int lpt = tile / kThreads;
  float inv[kMaxLanes][3], noi[kMaxLanes][3], tmn[kMaxLanes], tmx[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < lpt) {
      const size_t g = (size_t)t * tile + threadIdx.x + l * kThreads;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float o = rays[ax * nl + g];
        const float d = rays[(3 + ax) * nl + g];
        const float dd = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
        inv[l][ax] = 1.0f / dd;
        noi[l][ax] = mul(-o, inv[l][ax]);
      }
      tmn[l] = clampf(rays[6 * nl + g], -kBig, kBig);
      tmx[l] = clampf(rays[7 * nl + g], -kBig, kBig);
    }
  }
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int w = 0; w < nwords; ++w) {
    unsigned word[kMaxLanes] = {0u, 0u, 0u, 0u};
    for (int cc = 0; cc < 32; ++cc) {
      const int c = w * 32 + cc;
      float m = CUDART_INF_F;
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l < lpt) {
          float tn = tmn[l], tf = tmx[l];
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float lo = add(mul(sb[2 * ax][c], inv[l][ax]), noi[l][ax]);
            const float hi = add(mul(sb[2 * ax + 1][c], inv[l][ax]), noi[l][ax]);
            tn = fmaxf(tn, fminf(lo, hi));
            tf = fminf(tf, mul(fmaxf(lo, hi), 1.0001f));
          }
          if (tn <= tf) {
            word[l] |= 1u << cc;
            m = fminf(m, tn);
          }
        }
      }
      for (int off = 16; off; off >>= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (wl == 0) smin[warp][c] = m;
    }
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l)
      if (l < lpt) cb[(size_t)w * tile + threadIdx.x + l * kThreads] = (int)word[l];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kCovClusters; c += blockDim.x) {
    float m = smin[0][c];
    for (int w = 1; w < kThreads / 32; ++w) m = fminf(m, smin[w][c]);
    tnear[(size_t)t * cpad + c0 + c] = (c0 + c < n_clusters) ? m : CUDART_INF_F;
  }
}

// ------------------------------------------------- shared by the tracers
// The closest-hit and any-hit kernels (and the probes) are built from the
// same helpers, so the two tracers cannot drift apart: one block per tile,
// the tile's clusters taken `ch` at a time in corder order, each round's
// features staged in shared memory, the round's joining lanes compacted
// into a list, and a group of `ch` threads per listed lane, thread j
// testing cluster j's k slots.
struct SlotTest {
  float w0, w1, w2, nd, tnum;
};

__device__ __forceinline__ float plucker(float dx, float dy, float dz, float mx,
                                         float my, float mz, float ux, float uy,
                                         float uz, float vx, float vy, float vz) {
  float w = mul(dx, ux);
  w = add(w, mul(dy, uy));
  w = add(w, mul(dz, uz));
  w = add(w, mul(mx, vx));
  w = add(w, mul(my, vy));
  w = add(w, mul(mz, vz));
  return w;
}

struct LaneRay {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, tmin;
};

// f: one slot's 24 features, 16-byte aligned
__device__ __forceinline__ SlotTest slot_test(const float* f, const LaneRay& L) {
  const float ox = L.ox, oy = L.oy, oz = L.oz, dx = L.dx, dy = L.dy, dz = L.dz;
  const float mx = L.mx, my = L.my, mz = L.mz;
  const float4* F = reinterpret_cast<const float4*>(f);
  const float4 a = F[0], b = F[1], c = F[2], d = F[3], e = F[4], g = F[5];
  // a: U0 V0x | b: V0y V0z U1x U1y | c: U1z V1 | d: U2 V2x | e: V2y V2z nx ny
  // g: nz k_plane
  SlotTest s;
  s.w0 = plucker(dx, dy, dz, mx, my, mz, a.x, a.y, a.z, a.w, b.x, b.y);
  s.w1 = plucker(dx, dy, dz, mx, my, mz, b.z, b.w, c.x, c.y, c.z, c.w);
  s.w2 = plucker(dx, dy, dz, mx, my, mz, d.x, d.y, d.z, d.w, e.x, e.y);
  const float nx = e.z, ny = e.w, nz = g.x;
  s.nd = add(add(mul(dx, nx), mul(dy, ny)), mul(dz, nz));
  s.tnum = add(add(add(mul(-nx, ox), mul(-ny, oy)), mul(-nz, oz)), g.y);
  return s;
}

// The ray's line passes inside the triangle: the three Plücker volumes
// share the sign of n·d.
__device__ __forceinline__ bool slot_inside(const SlotTest& s) {
  return fminf(fminf(mul(s.w0, s.nd), mul(s.w1, s.nd)), mul(s.w2, s.nd)) >= 0.0f;
}

// Plane t = (k − n·o)·(1/(n·d)).
__device__ __forceinline__ float slot_t(const SlotTest& s) {
  return mul(s.tnum, 1.0f / s.nd);
}

// Stages clusters cid[0..ch)'s features into feat (ch, k·kNF + 4) floats,
// slot-major (24 floats a slot, read as six float4), each cluster's block
// padded by one float4 so that the ch threads of a group, which read the
// same slot of ch clusters, hit distinct banks. Callers synchronise before
// reading feat.
__device__ __forceinline__ void stage_clusters(const float* __restrict__ packed,
                                               const int* cid, int ch, int k,
                                               float* feat) {
  const int cstride = k * kNF + 4;
  for (int i = threadIdx.x; i < ch * k * kNF; i += blockDim.x) {
    const int jj = i / (kNF * k);
    const int rem = i - jj * kNF * k;
    const int f = rem / k, kk = rem - f * k;
    feat[jj * cstride + kk * kNF + f] = packed[(size_t)cid[jj] * kNF * k + rem];
  }
}

// Rank-based lane compaction: writes the lanes i < tile with pred(i) to
// list in ascending order and returns their count. Every thread of the
// block calls it (blockDim a multiple of 32, at most kTraceThreads); it
// ends with a barrier, so list and whatever the block wrote before the
// call are visible to all threads after it.
template <class Pred>
__device__ __forceinline__ int compact_lanes(int tile, Pred pred, int* list,
                                             int* s_scan) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int base = 0;
  for (int i0 = 0; i0 < tile; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool p = i < tile && pred(i);
    const unsigned ballot = __ballot_sync(0xffffffffu, p);
    if (wl == 0) s_scan[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = s_scan[w];
        s_scan[w] = run;
        run += c;
      }
      s_scan[nw] = run;
    }
    __syncthreads();
    if (p) list[base + s_scan[warp] + __popc(ballot & ((1u << wl) - 1u))] = i;
    base += s_scan[nw];
    __syncthreads();   // s_scan is rewritten by the next pass
  }
  return base;
}

// lane state in shared memory, (planes, tile) floats: the ray planes both
// tracers share, then each kernel's own
enum { kOx, kOy, kOz, kDx, kDy, kDz, kMx, kMy, kMz, kTmin, kRayPlanes };

// Stages lane i's ray (global index g) into the state planes: origin,
// direction, Plücker moment m = o × d and the clamped t_min. Returns the
// clamped t_max.
__device__ __forceinline__ float stage_ray(const float* __restrict__ rays,
                                           size_t nl, size_t g, float* st,
                                           int tile, int i) {
  const float ox = rays[g], oy = rays[nl + g], oz = rays[2 * nl + g];
  const float dx = rays[3 * nl + g], dy = rays[4 * nl + g], dz = rays[5 * nl + g];
  st[kOx * tile + i] = ox;
  st[kOy * tile + i] = oy;
  st[kOz * tile + i] = oz;
  st[kDx * tile + i] = dx;
  st[kDy * tile + i] = dy;
  st[kDz * tile + i] = dz;
  st[kMx * tile + i] = __fsub_rn(mul(oy, dz), mul(oz, dy));
  st[kMy * tile + i] = __fsub_rn(mul(oz, dx), mul(ox, dz));
  st[kMz * tile + i] = __fsub_rn(mul(ox, dy), mul(oy, dx));
  st[kTmin * tile + i] = clampf(rays[6 * nl + g], -kBig, kBig);
  return clampf(rays[7 * nl + g], -kBig, kBig);
}

__device__ __forceinline__ LaneRay lane_ray(const float* st, int tile, int i) {
  return LaneRay{st[kOx * tile + i], st[kOy * tile + i], st[kOz * tile + i],
                 st[kDx * tile + i], st[kDy * tile + i], st[kDz * tile + i],
                 st[kMx * tile + i], st[kMy * tile + i], st[kMz * tile + i],
                 st[kTmin * tile + i]};
}

// Lane i of tile t enters cluster cid (its covbit).
__device__ __forceinline__ bool covered(const int* __restrict__ covbits, int t,
                                        int nb32, int tile, int i, int cid) {
  return (covbits[((size_t)t * nb32 + (cid >> 5)) * tile + i] >> (cid & 31)) & 1;
}

// ---------------------------------------------------------- closest hit
// A lane joins a round iff it enters one of the round's clusters (its
// covbit) no later than its best hit so far — decided for every lane at
// the start of the round — and then tests all ch·k slots. The (t|slot)
// key keeps the slot in t's low 11 mantissa bits so one min picks the
// winner; the group's minimum key comes from warp shuffles. Shadow lanes
// (anyhit > 0) drop their best t to −1 after their first hit. The tile
// stops when the next round's entry t >= max best t. `slot_tests`, when
// given, accumulates the slot tests run; `needed_tests` the slot tests the
// function needs: the k slots of each (lane, cluster) pair whose covbit is
// set and whose entry t is within the lane's best t, pad positions past
// counts left out (the work that bounds the kernel). Shared memory: 98,432
// bytes of features (ch = 8, k = 128) + 16 state planes and the list,
// 69,632 bytes at tile 1024: one block of 16 warps per SM.
enum { kTbest = kRayPlanes, kTb0, kTb1, kTb2, kSlot, kAh, kClosestPlanes };

__global__ void __launch_bounds__(kTraceThreads) closest_kernel(
    const float* __restrict__ packed, const float* __restrict__ rays,
    const float* __restrict__ anyhit, const int* __restrict__ corder,
    const float* __restrict__ tnear, const int* __restrict__ counts,
    const int* __restrict__ covbits, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ bary_out,
    unsigned long long* __restrict__ slot_tests,
    unsigned long long* __restrict__ needed_tests, int nt, int tile, int W,
    int nb32, int k, int ch) {
  extern __shared__ float4 smem4[];
  const int cstride = k * kNF + 4;                 // floats per staged cluster
  float* feat = reinterpret_cast<float*>(smem4);   // (ch, k·kNF + 4)
  float* st = feat + (size_t)ch * cstride;         // (kClosestPlanes, tile)
  int* list = reinterpret_cast<int*>(st + (size_t)kClosestPlanes * tile);   // (tile,)
  __shared__ int s_cid[kMaxCH];
  __shared__ float s_tn[kMaxCH];
  __shared__ float s_red[kTraceThreads / 32];
  __shared__ int s_scan[kTraceThreads / 32 + 1];
  __shared__ int s_done;
  const int t = blockIdx.x;
  const size_t nl = (size_t)nt * tile;
  const int n_count = counts[t];
  const int n_rounds = (n_count + ch - 1) / ch;
  float* bary0 = bary_out + (size_t)t * 2 * tile;
  if (n_rounds == 0) {   // tile enters no cluster: every lane misses
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const size_t g = (size_t)t * tile + i;
      t_out[g] = rays[7 * nl + g];
      slot_out[g] = -1;
      bary0[i] = 0.0f;
      bary0[tile + i] = 0.0f;
    }
    return;
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = (size_t)t * tile + i;
    const float tmax = stage_ray(rays, nl, g, st, tile, i);
    st[kTbest * tile + i] = tmax;
    st[kTb0 * tile + i] = tmax;
    st[kTb1 * tile + i] = 0.0f;
    st[kTb2 * tile + i] = 0.0f;
    st[kSlot * tile + i] = __int_as_float(-1);
    st[kAh * tile + i] = (anyhit != nullptr && anyhit[g] > 0.0f) ? 1.0f : 0.0f;
  }
  const int chk = ch * k;
  const int j = threadIdx.x % ch;                  // this thread's cluster
  const int group = threadIdx.x / ch;
  const int n_groups = blockDim.x / ch;
  const int wl = threadIdx.x & 31;
  const unsigned gmask = (ch == 32 ? 0xffffffffu : ((1u << ch) - 1u) << (wl & ~(ch - 1)));
  unsigned long long n_tests = 0, n_needed = 0;
  for (int r = 0; r < n_rounds; ++r) {
    __syncthreads();   // the previous round's shared-memory reads are done
    if (threadIdx.x < ch) {
      s_cid[threadIdx.x] = corder[(size_t)t * W + r * ch + threadIdx.x];
      s_tn[threadIdx.x] = tnear[(size_t)t * W + r * ch + threadIdx.x];
    }
    __syncthreads();
    stage_clusters(packed, s_cid, ch, k, feat);
    // the round's joining lanes, from best t at the start of the round
    const int m = compact_lanes(tile, [&](int i) {
      const float tb = st[kTbest * tile + i];
      bool mask = false;
      for (int jj = 0; jj < ch; ++jj) {
        mask |= covered(covbits, t, nb32, tile, i, s_cid[jj]) && (tb >= s_tn[jj]);
      }
      return mask;
    }, list, s_scan);
    for (int e = group; e < m; e += n_groups) {
      const int i = list[e];
      const LaneRay L = lane_ray(st, tile, i);
      if (needed_tests != nullptr && r * ch + j < n_count &&
          covered(covbits, t, nb32, tile, i, s_cid[j]) &&
          st[kTbest * tile + i] >= s_tn[j])
        n_needed += k;
      int kmin = 0x7FFFFFFF;
      const float* fj = feat + (size_t)j * cstride;
      for (int kk = 0; kk < k; ++kk) {
        const SlotTest sl = slot_test(fj + kk * kNF, L);
        if (!slot_inside(sl)) continue;
        const float tt = slot_t(sl);
        if (!(tt > L.tmin)) continue;
        kmin = min(kmin, (__float_as_int(tt) & ~kSlotMask) | (j * k + kk));
      }
      for (int off = ch >> 1; off; off >>= 1)
        kmin = min(kmin, __shfl_xor_sync(gmask, kmin, off));
      if (j == 0) {
        n_tests += chk;
        const float tj = __int_as_float(kmin & ~kSlotMask);
        if (tj < st[kTbest * tile + i]) {
          const int s = kmin & kSlotMask;
          const SlotTest sl = slot_test(feat + (size_t)(s / k) * cstride + (s % k) * kNF, L);
          const float snd = fabsf(sl.nd) > 1e-12f ? sl.nd : 1e-12f;
          const float sum = add(add(sl.w0, sl.w1), sl.w2);
          const float inv = 1.0f / (fabsf(sum) > 1e-30f ? sum : 1e-30f);
          st[kTb0 * tile + i] = sl.tnum / snd;
          st[kTb1 * tile + i] = mul(sl.w2, inv);
          st[kTb2 * tile + i] = mul(sl.w0, inv);
          st[kSlot * tile + i] = __int_as_float(s_cid[s / k] * k + s % k);
          st[kTbest * tile + i] = st[kAh * tile + i] > 0.0f ? -1.0f : tj;
        }
      }
    }
    __syncthreads();
    // ordered-entry-t pruning over the whole tile
    float lmax = -CUDART_INF_F;
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      lmax = fmaxf(lmax, st[kTbest * tile + i]);
    for (int off = 16; off; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    if (wl == 0) s_red[threadIdx.x >> 5] = lmax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float mm = s_red[0];
      for (int w = 1; w < kTraceThreads / 32; ++w) mm = fmaxf(mm, s_red[w]);
      s_done = tnear[(size_t)t * W + min((r + 1) * ch, W - 1)] >= mm;
    }
    __syncthreads();
    if (s_done) break;
  }
  if (slot_tests != nullptr && n_tests) atomicAdd(slot_tests, n_tests);
  if (needed_tests != nullptr && n_needed) atomicAdd(needed_tests, n_needed);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = (size_t)t * tile + i;
    t_out[g] = st[kTb0 * tile + i];
    slot_out[g] = __float_as_int(st[kSlot * tile + i]);
    bary0[i] = st[kTb1 * tile + i];
    bary0[tile + i] = st[kTb2 * tile + i];
  }
}

// -------------------------------------------------------------- any hit
// Per lane: does any triangle of the tile's covered clusters lie at
// tmin < t < tmax — the exact window, not the (t|slot) key of the fused
// shadow lanes above. A round's lanes are those that enter one of its
// clusters, are live (tmax > tmin) and are not yet occluded at the start
// of the round: the list is built once per round, so lanes occluded during
// the round do not change it (the frozen mask of the LC kernel). Thread j
// of a lane's group stops at cluster j's first hit in slot order; a slot
// test counted in `slot_tests` is a slot test run, so the count is exact
// and the plain version reproduces it. `needed_tests` counts the work the
// function needs: per lane, the slots of the clusters it enters, in corder
// and slot order, up to its first hit — the other clusters of the round,
// pad positions past counts and the slots after a hit in an earlier
// cluster of the round are left out. The tile stops before a round in
// which every live lane is occluded (a block-wide vote; padding lanes,
// t_max = −1, count as done). No per-lane best t, barycentrics or slot: 12 state
// planes and the list, 53,248 bytes at tile 1024, plus the 98,432 bytes
// of features (ch = 8, k = 128) — 151,680 bytes, still one block of 16
// warps per SM (two would need 303 KB).
enum { kTmax = kRayPlanes, kOcc, kAnyPlanes };

__global__ void __launch_bounds__(kTraceThreads) occluded_kernel(
    const float* __restrict__ packed, const float* __restrict__ rays,
    const int* __restrict__ corder, const int* __restrict__ counts,
    const int* __restrict__ covbits, unsigned char* __restrict__ occ_out,
    unsigned long long* __restrict__ slot_tests,
    unsigned long long* __restrict__ needed_tests, int nt, int tile, int W,
    int nb32, int k, int ch) {
  extern __shared__ float4 smem4[];
  const int cstride = k * kNF + 4;
  float* feat = reinterpret_cast<float*>(smem4);   // (ch, k·kNF + 4)
  float* st = feat + (size_t)ch * cstride;         // (kAnyPlanes, tile)
  int* list = reinterpret_cast<int*>(st + (size_t)kAnyPlanes * tile);   // (tile,)
  __shared__ int s_cid[kMaxCH];
  __shared__ int s_scan[kTraceThreads / 32 + 1];
  const int t = blockIdx.x;
  const size_t nl = (size_t)nt * tile;
  const int n_count = counts[t];
  const int n_rounds = (n_count + ch - 1) / ch;
  unsigned char* occ_t = occ_out + (size_t)t * tile;
  if (n_rounds == 0) {   // tile enters no cluster: nothing is occluded
    for (int i = threadIdx.x; i < tile; i += blockDim.x) occ_t[i] = 0;
    return;
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    st[kTmax * tile + i] = stage_ray(rays, nl, (size_t)t * tile + i, st, tile, i);
    st[kOcc * tile + i] = 0.0f;
  }
  const int j = threadIdx.x % ch;
  const int group = threadIdx.x / ch;
  const int n_groups = blockDim.x / ch;
  const int wl = threadIdx.x & 31;
  const unsigned gmask = (ch == 32 ? 0xffffffffu : ((1u << ch) - 1u) << (wl & ~(ch - 1)));
  unsigned long long n_tests = 0, n_needed = 0;
  for (int r = 0; r < n_rounds; ++r) {
    __syncthreads();   // lane set-up, or the previous round's tests, are done
    int done = 1;
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      done &= (st[kOcc * tile + i] != 0.0f) || !(st[kTmax * tile + i] > st[kTmin * tile + i]);
    if (__syncthreads_and(done)) break;
    if (threadIdx.x < ch) s_cid[threadIdx.x] = corder[(size_t)t * W + r * ch + threadIdx.x];
    __syncthreads();
    stage_clusters(packed, s_cid, ch, k, feat);
    const int m = compact_lanes(tile, [&](int i) {
      if (st[kOcc * tile + i] != 0.0f || !(st[kTmax * tile + i] > st[kTmin * tile + i]))
        return false;
      bool cov = false;
      for (int jj = 0; jj < ch; ++jj) cov |= covered(covbits, t, nb32, tile, i, s_cid[jj]);
      return cov;
    }, list, s_scan);
    for (int e = group; e < m; e += n_groups) {
      const int i = list[e];
      const LaneRay L = lane_ray(st, tile, i);
      const float tmax = st[kTmax * tile + i];
      const float* fj = feat + (size_t)j * cstride;
      int kk = 0;
      bool hit = false;
      for (; kk < k && !hit; ++kk) {
        const SlotTest sl = slot_test(fj + kk * kNF, L);
        if (!slot_inside(sl)) continue;
        const float tt = slot_t(sl);
        hit = tt > L.tmin && tt < tmax;
      }
      n_tests += kk;
      if (needed_tests != nullptr) {
        // needed: cluster j is entered and no entered cluster j' < j hit
        const bool need = r * ch + j < n_count && covered(covbits, t, nb32, tile, i, s_cid[j]);
        const unsigned first = __ballot_sync(gmask, need && hit) & gmask;
        if (need && !(first & ((1u << wl) - 1u))) n_needed += kk;
      }
      if (hit) st[kOcc * tile + i] = 1.0f;
    }
  }
  if (slot_tests != nullptr && n_tests) atomicAdd(slot_tests, n_tests);
  if (needed_tests != nullptr && n_needed) atomicAdd(needed_tests, n_needed);
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    occ_t[i] = st[kOcc * tile + i] != 0.0f;
}

// --------------------------------------------------------------- probes
// Lane compaction probe: compacts a (1, tile) mask into a list with
// compact_lanes, gathers val into the compacted domain, then expands it
// back through the list: out = val where the mask is set (else 0), slot =
// 1 there (else −1).
__global__ void __launch_bounds__(kTraceThreads) compact_probe_kernel(
    const float* __restrict__ mask, const float* __restrict__ val,
    float* __restrict__ out, int* __restrict__ slot, int tile) {
  __shared__ int list[1024];
  __shared__ float vc[1024];
  __shared__ int s_scan[kTraceThreads / 32 + 1];
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    out[i] = 0.0f;
    slot[i] = -1;
  }
  const int m = compact_lanes(tile, [&](int i) { return mask[i] > 0.5f; }, list, s_scan);
  for (int e = threadIdx.x; e < m; e += blockDim.x) vc[e] = val[list[e]];
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    out[list[e]] = vc[e];
    slot[list[e]] = 1;
  }
}

// Per-block overhead probe with the tracers' block structure: one block per
// tile, one thread per lane, rounds of ch clusters in corder order.
//   kind 0  empty:          out = ray plane 0
//   kind 1  stage:          stage each round's clusters (stage_clusters),
//                           acc += the first staged feature
//   kind 2  stage+compute:  acc += min over the round's ch·k slots of the
//                           dot of the slot's first 16 features with the
//                           lane's 8 ray planes taken twice
__global__ void __launch_bounds__(1024) overhead_probe_kernel(
    int kind, const float* __restrict__ packed, const float* __restrict__ planes,
    const int* __restrict__ corder, const int* __restrict__ counts,
    float* __restrict__ out, int nt, int tile, int cpad, int k, int ch) {
  extern __shared__ float4 smem4[];
  float* feat = reinterpret_cast<float*>(smem4);
  __shared__ int s_cid[kMaxCH];
  const int t = blockIdx.x, i = threadIdx.x;
  const size_t nl = (size_t)nt * tile, g = (size_t)t * tile + i;
  if (kind == 0) {
    out[g] = planes[g];
    return;
  }
  float lane[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) lane[p] = planes[p * nl + g];
  const int cstride = k * kNF + 4;
  const int n_rounds = (counts[t] + ch - 1) / ch;
  float acc = 0.0f;
  for (int r = 0; r < n_rounds; ++r) {
    __syncthreads();
    if (i < ch) s_cid[i] = corder[(size_t)t * cpad + r * ch + i];
    __syncthreads();
    stage_clusters(packed, s_cid, ch, k, feat);
    __syncthreads();
    if (kind == 1) {
      acc = add(acc, feat[0]);
      continue;
    }
    float m = CUDART_INF_F;
    for (int jj = 0; jj < ch; ++jj) {
      for (int kk = 0; kk < k; ++kk) {
        const float* f = feat + jj * cstride + kk * kNF;
        float d = mul(f[0], lane[0]);
#pragma unroll
        for (int q = 1; q < 16; ++q) d = add(d, mul(f[q], lane[q & 7]));
        m = fminf(m, d);
      }
    }
    acc = add(acc, m);
  }
  out[g] = acc;
}

bool bad_trace_shape(int tile, int W, int k, int ch) {
  // a group of ch threads shares one warp; k slots keep float4 alignment
  return tile <= 0 || tile > 1024 || ch < 1 || ch > kMaxCH || (ch & (ch - 1)) ||
         ch * k > kSlotMask + 1 || W % ch != 0;
}

}  // namespace

extern "C" {

int pbrt_coverage(const void* rays, const void* bounds, const void* n_live_tiles,
                  void* tnear, void* covbits, int nt, int tile, int cpad,
                  int n_clusters, void* stream) {
  if (tile % kThreads != 0 || tile / kThreads > kMaxLanes ||
      cpad % kCovClusters != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cpad / kCovClusters, nt);
  coverage_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)bounds, (const int*)n_live_tiles,
      (float*)tnear, (int*)covbits, nt, tile, cpad, n_clusters);
  return (int)cudaGetLastError();
}

int pbrt_closest(const void* packed, const void* rays, const void* anyhit,
                 const void* corder, const void* tnear, const void* counts,
                 const void* covbits, void* t_out, void* slot_out,
                 void* bary_out, void* slot_tests, void* needed_tests, int nt,
                 int tile, int W, int nb32, int k, int ch, void* stream) {
  if (bad_trace_shape(tile, W, k, ch)) return (int)cudaErrorInvalidValue;
  const int smem = (ch * (k * kNF + 4) + kClosestPlanes * tile + tile) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      closest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  closest_kernel<<<nt, kTraceThreads, smem, (cudaStream_t)stream>>>(
      (const float*)packed, (const float*)rays, (const float*)anyhit,
      (const int*)corder, (const float*)tnear, (const int*)counts,
      (const int*)covbits, (float*)t_out, (int*)slot_out, (float*)bary_out,
      (unsigned long long*)slot_tests, (unsigned long long*)needed_tests, nt, tile,
      W, nb32, k, ch);
  return (int)cudaGetLastError();
}

int pbrt_occluded(const void* packed, const void* rays, const void* corder,
                  const void* counts, const void* covbits, void* occ_out,
                  void* slot_tests, void* needed_tests, int nt, int tile, int W,
                  int nb32, int k, int ch, void* stream) {
  if (bad_trace_shape(tile, W, k, ch)) return (int)cudaErrorInvalidValue;
  const int smem = (ch * (k * kNF + 4) + kAnyPlanes * tile + tile) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      occluded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  occluded_kernel<<<nt, kTraceThreads, smem, (cudaStream_t)stream>>>(
      (const float*)packed, (const float*)rays, (const int*)corder,
      (const int*)counts, (const int*)covbits, (unsigned char*)occ_out,
      (unsigned long long*)slot_tests, (unsigned long long*)needed_tests, nt, tile,
      W, nb32, k, ch);
  return (int)cudaGetLastError();
}

int pbrt_compact_probe(const void* mask, const void* val, void* out, void* slot,
                       int tile, void* stream) {
  if (tile <= 0 || tile > 1024) return (int)cudaErrorInvalidValue;
  compact_probe_kernel<<<1, kTraceThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (const float*)val, (float*)out, (int*)slot, tile);
  return (int)cudaGetLastError();
}

int pbrt_overhead_probe(int kind, const void* packed, const void* planes,
                        const void* corder, const void* counts, void* out, int nt,
                        int tile, int cpad, int k, int ch, void* stream) {
  if (kind < 0 || kind > 2 || tile <= 0 || tile > 1024 || tile % 32 ||
      ch < 1 || ch > kMaxCH || cpad % ch)
    return (int)cudaErrorInvalidValue;
  const int smem = kind == 0 ? 0 : ch * (k * kNF + 4) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      overhead_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  overhead_probe_kernel<<<nt, tile, smem, (cudaStream_t)stream>>>(
      kind, (const float*)packed, (const float*)planes, (const int*)corder,
      (const int*)counts, (float*)out, nt, tile, cpad, k, ch);
  return (int)cudaGetLastError();
}

}  // extern "C"
