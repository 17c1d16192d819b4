// Tile×cluster ray-tracing kernels for Hopper (sm_90a): coverage, closest
// hit and any hit, plus two probe kernels (lane compaction, and the
// per-block overhead of the TPU tracer's structure, staged by bulk copies)
// and an empty kernel, the launch floor. Plain C interface, loaded with
// ctypes by pbrt_tpu_torch/kernels/cluster_cuda.py and kernels/probes.py,
// which also hold the plain PyTorch version of each kernel.
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
//                               (the overhead probe's: (C, 16, n5, k))
//   tnear    (nt, W)      f32   per-tile entry t, ascending (closest hit)
//   corder   (nt, W)      i32   matching cluster ids
//   covbits  (nt, cpad/32, tile) i32  bit c%32 of word c/32: lane enters c
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kNF = 24;             // features per triangle slot
constexpr int kSlotMask = 2047;     // low mantissa bits of t carry the slot
constexpr float kBig = 3e37f;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// Adds a block's counts to a global counter: a warp sum, then one atomic
// per warp.
__device__ __forceinline__ void add_count(unsigned long long* __restrict__ out,
                                          unsigned long long n) {
  for (int off = 16; off; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(out, n);
}

// ------------------------------------------------------------- coverage
// Replaces coverage_tiles (pbrt_tpu/kernels/cluster_pallas.py:303, body
// _make_coverage_kernel). The function: the slab test of every lane of a
// tile against every column (cluster AABB) of `bounds`, pad columns
// included; covbits bit cc of word w is "lane enters column 32·w + cc",
// tnear the least entry t over the tile's lanes (INF in pad columns).
//
// Slab test (slab() below, the same ops in the same order for a column
// and for a word box): per axis lo = b_lo·inv + noi, hi = b_hi·inv + noi
// with noi = −o·inv, tn = max(tn, min(lo, hi)), tf = min(tf,
// max(lo, hi)·1.0001), from tn = tmin and tf = tmax (both clamped to
// ±3e37); the lane enters iff tn <= tf.
//
// Design: a two-level walk. Word box G_w = per axis the least of the
// min(lo, hi) and the greatest of the max(lo, hi) over the word's 32
// columns (pad columns as `bounds` holds them). Why skipping is exact:
// b·inv and (·) + noi round to nearest, so each is monotone in b
// (non-decreasing for inv > 0, non-increasing for inv < 0), and so are
// min, max, the ×1.0001 and the clamps; inv is finite (the 1e-12 clamp of
// d), and with finite products no NaN arises. So every column c of word
// w, whose faces lie inside G_w's, has tn(G_w) <= tn(c) and tf(G_w) >=
// tf(c): a lane that enters c enters G_w. A lane that misses G_w has word
// w = 0 and adds nothing to the tnear of w's columns.
// Two launches:
//   1. coverage_lanes_kernel, one block per 256 lanes of a tile: the word
//      boxes (a warp reduction per word, into shared memory); each thread
//      takes a lane, writes the ray's 8 terms (inv, tmin | noi, tmax) to
//      scratch and tests the word boxes, a ballot per (warp, word) giving
//      the word's mask of those 32 lanes. An empty mask's 32 covbits words
//      are stored as zeros at once (128 contiguous bytes); the others go
//      into a list of units (tile, word, 32-lane chunk, mask), appended a
//      block at a time. tnear starts at INF.
//   2. coverage_columns_kernel: the launch's warps take the listed units
//      in turn, so the work spreads over the card whatever the tiles'
//      loads (the tiles differ several fold in the words their lanes
//      enter; with one block a tile, the heaviest tiles set a launch's
//      time) and no warp walks an empty unit. A
//      dense unit (more than kSparseLanes lanes) is walked lane-parallel:
//      the warp stages the word's 32 column boxes in shared memory, and a
//      thread whose lane is in the mask holds its ray in registers and
//      tests it against the 32 columns in turn (each box a shared-memory
//      broadcast, 32 independent tests for the scheduler to overlap),
//      setting its covbits word's bits; a hit's entry t goes into the
//      column's int key in shared memory by atomicMin. A sparse unit is
//      walked column-parallel: a thread holds its column's box, the warp
//      stages the chunk's rays in shared memory and tests the mask's
//      lanes one at a time (a ray broadcast each), the ballot of the 32
//      results being that lane's covbits word, and each thread keeps its
//      column's least key. Either way the warp then stores the 32 words at
//      once (128 contiguous bytes) and merges each column's key into tnear
//      by a float atomic min, so tnear does not depend on the order of the
//      units.
// Work: tile·words box tests and 32 column tests per (lane, word) entry,
// not tile·CPAD column tests. Bound on the card: the float32 operations
// of those tests (28 a test) against the 67 TFLOP/s rate, or the bytes
// (rays in, covbits and tnear out), whichever is larger. What holds it
// in practice: the issue of about 32 (lane-parallel) to 45 (ballot walk)
// instructions a test, of which 28 are the test's float operations, and,
// on wavefronts with many dead tiles, the lane pass's stores of zero
// covbits words. `tests_run` counts the tests the two passes make,
// `tests_needed` the same from the lane pass's masks: they are equal.
constexpr int kLaneThreads = 256;    // threads (= lanes) per lane-pass block
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kWordGroup = 32;       // words a lane-pass block lists between flushes
constexpr int kColThreads = 256;     // threads per column-pass block
constexpr int kColWarps = kColThreads / 32;
constexpr int kColBlocksPerSM = 6;   // column-pass blocks an SM (<= 40 registers)
constexpr int kSparseLanes = 20;     // a unit with at most these lanes is walked column-parallel
constexpr int kInfKey = 0x7F800000;  // the key of +INF

// The slab test: tn of the box (lx hx ly hy lz hz) for the ray whose
// terms are a = (inv, tmin) and b = (noi, tmax); *hit = the lane enters.
__device__ __forceinline__ float slab(float lx, float hx, float ly, float hy, float lz,
                                      float hz, float4 a, float4 b, bool* hit) {
  float tn = a.w, tf = b.w, lo, hi;
  lo = add(mul(lx, a.x), b.x);
  hi = add(mul(hx, a.x), b.x);
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, mul(fmaxf(lo, hi), 1.0001f));
  lo = add(mul(ly, a.y), b.y);
  hi = add(mul(hy, a.y), b.y);
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, mul(fmaxf(lo, hi), 1.0001f));
  lo = add(mul(lz, a.z), b.z);
  hi = add(mul(hz, a.z), b.z);
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, mul(fmaxf(lo, hi), 1.0001f));
  *hit = tn <= tf;
  return tn;
}

// A float as an int whose order is the float's (−0 below +0).
__device__ __forceinline__ int min_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

// *addr = min(*addr, the float of key k), in the keys' order, for a float
// in memory: a sign-clear value by an int min, a sign-set one by an
// unsigned max of the bits.
__device__ __forceinline__ void atomic_min_key(float* addr, int k) {
  if (k >= 0)
    atomicMin(reinterpret_cast<int*>(addr), k);
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), (unsigned)(k ^ 0x7FFFFFFF));
}

// A listed unit: the chunk's mask of lanes that enter the word box, and
// (t·nw + w) << 5 | j for tile t, word w, 32-lane chunk j.
struct CovUnit {
  unsigned mask, where;
};

// Pass 1. rays (8, nt·tile) → terms (nt·tile, 2) float4, the zero covbits
// words, units[0, *n_units) (n_units zero before the launch), tnear (nt,
// cpad) = INF. Block (t, p) takes lanes p·kLaneThreads onwards of tile t,
// one a thread. Dynamic shared memory: the word boxes (nw × 2 float4).
__global__ void __launch_bounds__(kLaneThreads) coverage_lanes_kernel(
    const float* __restrict__ rays, const float* __restrict__ bounds,
    const int* __restrict__ n_live_tiles, float4* __restrict__ terms,
    CovUnit* __restrict__ units, int* __restrict__ n_units, float* __restrict__ tnear,
    int* __restrict__ covbits, unsigned long long* __restrict__ tests_run,
    unsigned long long* __restrict__ tests_needed, int nt, int tile, int cpad) {
  extern __shared__ float4 s_box[];   // word w: [2w] lx hx ly hy, [2w+1] lz hz
  __shared__ CovUnit s_units[kLaneWarps * kWordGroup];
  __shared__ int s_count, s_base;
  const int parts = (tile + kLaneThreads - 1) / kLaneThreads;
  const int t = blockIdx.x / parts;
  const int i = (blockIdx.x - t * parts) * kLaneThreads + threadIdx.x;   // the lane
  const bool lane_ok = i < tile;   // whole warps: tile is a multiple of 32
  const int nw = cpad / 32;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  int* cb = covbits + (size_t)t * nw * tile + i;   // word w at w·tile
  if (blockIdx.x == t * parts)
    for (int c = threadIdx.x; c < cpad; c += kLaneThreads)
      tnear[(size_t)t * cpad + c] = CUDART_INF_F;
  if (t >= n_live_tiles[0]) {   // dead lanes sort to the suffix: no word entered
    if (lane_ok)
      for (int w = 0; w < nw; ++w) cb[(size_t)w * tile] = 0;
    return;
  }
  for (int w = warp; w < nw; w += kLaneWarps) {
    const int c = w * 32 + wl;
    float v[6];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float lo = bounds[(size_t)(2 * ax) * cpad + c];
      const float hi = bounds[(size_t)(2 * ax + 1) * cpad + c];
      v[2 * ax] = fminf(lo, hi);
      v[2 * ax + 1] = fmaxf(lo, hi);
    }
    for (int off = 16; off; off >>= 1) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        v[2 * ax] = fminf(v[2 * ax], __shfl_xor_sync(0xffffffffu, v[2 * ax], off));
        v[2 * ax + 1] = fmaxf(v[2 * ax + 1], __shfl_xor_sync(0xffffffffu, v[2 * ax + 1], off));
      }
    }
    if (wl == 0) {
      s_box[2 * w] = make_float4(v[0], v[1], v[2], v[3]);
      s_box[2 * w + 1] = make_float4(v[4], v[5], 0.0f, 0.0f);
    }
  }
  if (threadIdx.x == 0) s_count = 0;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
  if (lane_ok) {
    const size_t nl = (size_t)nt * tile, g = (size_t)t * tile + i;
    float inv[3], noi[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float o = rays[ax * nl + g];
      const float d = rays[(3 + ax) * nl + g];
      const float dd = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
      inv[ax] = 1.0f / dd;
      noi[ax] = mul(-o, inv[ax]);
    }
    a = make_float4(inv[0], inv[1], inv[2], clampf(rays[6 * nl + g], -kBig, kBig));
    b = make_float4(noi[0], noi[1], noi[2], clampf(rays[7 * nl + g], -kBig, kBig));
    terms[2 * g] = a;
    terms[2 * g + 1] = b;
  }
  __syncthreads();
  unsigned long long needed = 0;   // counted by each warp's lane 0
  for (int w0 = 0; w0 < nw; w0 += kWordGroup) {
    if (lane_ok) {
      for (int w = w0; w < min(w0 + kWordGroup, nw); ++w) {
        const float4 p = s_box[2 * w], q = s_box[2 * w + 1];
        bool hit;
        slab(p.x, p.y, p.z, p.w, q.x, q.y, a, b, &hit);
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m == 0u) {
          cb[(size_t)w * tile] = 0;
        } else if (wl == 0) {
          s_units[atomicAdd(&s_count, 1)] = CovUnit{m, (unsigned)((t * nw + w) << 5 | (i >> 5))};
        }
        if (wl == 0) needed += 32u * (1u + __popc(m));   // 32 box tests, 32 column tests a lane entering
      }
    }
    __syncthreads();   // the group's units are listed
    const int n = s_count;
    if (threadIdx.x == 0) s_base = n ? atomicAdd(n_units, n) : 0;
    __syncthreads();   // every thread has read s_count
    if (threadIdx.x == 0) s_count = 0;
    for (int k = threadIdx.x; k < n; k += kLaneThreads) units[s_base + k] = s_units[k];
    __syncthreads();   // s_units is rewritten by the next group
  }
  // the box tests made (32 a warp and word), by lane 0 of each warp
  if (tests_run != nullptr) add_count(tests_run, lane_ok && wl == 0 ? 32ull * nw : 0ull);
  if (tests_needed != nullptr) add_count(tests_needed, needed);
}

// Pass 2. The listed units, the launch's warps in turn, each walked
// column-parallel (at most kSparseLanes lanes) or lane-parallel: a lane's
// 32 tests take 32 steps of the warp either way, a step of the ballot walk
// costs more.
__global__ void __launch_bounds__(kColThreads, kColBlocksPerSM) coverage_columns_kernel(
    const float4* __restrict__ terms, const float* __restrict__ bounds,
    const CovUnit* __restrict__ units, const int* __restrict__ n_units,
    float* __restrict__ tnear, int* __restrict__ covbits,
    unsigned long long* __restrict__ tests_run, int tile, int cpad, int n_clusters) {
  __shared__ float4 s_lh[kColWarps][32];   // column cc: lx hx ly hy
  __shared__ float2 s_z[kColWarps][32];    // lz hz
  __shared__ int s_key[kColWarps][32];     // the column's least entry t, as a key
  __shared__ float4 s_ray[kColWarps][64];  // lane l of the chunk: [2l] inv tmin, [2l+1] noi tmax
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int nw = cpad / 32;
  const int n = *n_units;
  unsigned long long run = 0;   // counted by each warp's lane 0
  for (int k = blockIdx.x * kColWarps + warp; k < n; k += gridDim.x * kColWarps) {
    const CovUnit u = units[k];
    const int tw = u.where >> 5, j = u.where & 31;
    const int t = tw / nw, w = tw - t * nw;
    const int c = w * 32 + wl;
    const size_t g = (size_t)t * tile + j * 32 + wl;   // this thread's lane of the chunk
    const float4 p = make_float4(bounds[c], bounds[cpad + c], bounds[2 * (size_t)cpad + c],
                                 bounds[3 * (size_t)cpad + c]);
    const float2 q = make_float2(bounds[4 * (size_t)cpad + c], bounds[5 * (size_t)cpad + c]);
    const int lanes = __popc(u.mask);
    if (wl == 0) run += 32u * lanes;
    unsigned out = 0;
    if (lanes <= kSparseLanes) {   // column-parallel
      s_ray[warp][2 * wl] = terms[2 * g];
      s_ray[warp][2 * wl + 1] = terms[2 * g + 1];
      __syncwarp();
      int m = kInfKey;
      for (unsigned bits = u.mask; bits; bits &= bits - 1u) {
        const int l = __ffs(bits) - 1;
        bool hit;
        const float tn = slab(p.x, p.y, p.z, p.w, q.x, q.y, s_ray[warp][2 * l],
                              s_ray[warp][2 * l + 1], &hit);
        const unsigned word = __ballot_sync(0xffffffffu, hit);
        if (wl == l) out = word;
        if (hit) m = min(m, min_key(tn));
      }
      s_key[warp][wl] = m;
    } else {   // lane-parallel
      s_lh[warp][wl] = p;
      s_z[warp][wl] = q;
      s_key[warp][wl] = kInfKey;
      __syncwarp();
      if ((u.mask >> wl) & 1u) {
        const float4 a = terms[2 * g], b = terms[2 * g + 1];
#pragma unroll
        for (int cc = 0; cc < 32; ++cc) {
          const float4 pc = s_lh[warp][cc];
          const float2 qc = s_z[warp][cc];
          bool hit;
          const float tn = slab(pc.x, pc.y, pc.z, pc.w, qc.x, qc.y, a, b, &hit);
          if (hit) {
            out |= 1u << cc;
            atomicMin(&s_key[warp][cc], min_key(tn));
          }
        }
      }
    }
    __syncwarp();
    covbits[(size_t)tw * tile + j * 32 + wl] = (int)out;
    const int key = s_key[warp][wl];
    if (key != kInfKey && c < n_clusters) atomic_min_key(tnear + (size_t)t * cpad + c, key);
    __syncwarp();   // the warp's shared memory is rewritten by its next unit
  }
  if (tests_run != nullptr) add_count(tests_run, run);
}

// ------------------------------------------------- shared by the tracers
// The closest-hit and any-hit kernels are built from the same helpers, so
// the two cannot drift apart. One block of kLanes threads owns kLanes
// consecutive lanes of a tile (one thread per lane for the lane's state)
// and walks the tile's clusters kCH at a time in corder order. A round:
//   1. each thread lists the round's (lane, cluster) pairs of its lane, a
//      bit per cluster; the block gathers them into one lane mask per
//      cluster (a ballot per warp) and cuts each mask into work items of
//      at least 32 lanes;
//   2. the round's units (a work item against 32 slots of its cluster)
//      are handed out to warps. A warp loads its unit's slot features from
//      `packed` into registers (feature f of 32 neighbouring slots: 128
//      contiguous bytes), then runs over the item's lanes; each lane's ray
//      comes from shared memory as a broadcast, each thread tests its own
//      slot, and a hit goes into the lane's int in shared memory by
//      atomicMin;
//   3. each thread reads its lane's result.
// What bounds it on the card: the rounds are sparse (on the bench's
// bounce wavefronts more than half a block's rounds hold no pair, the
// others a few tens), so a block's time goes to each unit's feature loads
// from L2 and the round's barriers, not to issue, and the blocks of the
// tiles with the longest cluster lists set a launch's time. So the
// features never pass through shared memory (whose read pipe bounded the
// earlier one-block-per-tile design at 96 bytes a test); shared memory
// holds only the lanes' rays and results and the tile's cluster list
// (about 13 KB a block on the bench scene), so six blocks share an SM; a
// tile's lanes spread over tile/kLanes blocks; a work item spans enough
// lanes that its feature loads serve a few tens of tests; and block b
// takes the tile of rank b/q by descending count (tile_order_kernel, run
// once before each tracer launch), so the longest chains of rounds start
// first.
constexpr int kLanes = 128;      // lanes (= threads) per tracer block (cluster_cuda.BLOCK)
constexpr int kOrderThreads = 1024;   // the one block of tile_order_kernel
constexpr int kMinBlocks = 6;    // blocks per SM the registers allow: at most 80 a thread
constexpr int kWarps = kLanes / 32;
constexpr int kItemLanes = 32;   // a work item's lanes, at least (but for a cluster's last)
constexpr int kCH = 8;   // clusters per tracer round (cluster_cuda.CH)
constexpr int kInt = 0x7FFFFFFF;
static_assert(kLanes % 32 == 0 && kLanes <= 1024, "tracer block");

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
  float ox, oy, oz, dx, dy, dz, mx, my, mz, tmin, tmax;
};

// F(q): feature q of one slot, 0:3 U0 | 3:6 V0 | 6:9 U1 | 9:12 V1 |
// 12:15 U2 | 15:18 V2 | 18:21 n | 21 k_plane. The three Plücker volumes
// and n·d decide whether the line passes inside; the plane numerator is
// needed only then.
template <class F>
__device__ __forceinline__ SlotTest slot_volumes(F f, const LaneRay& L) {
  SlotTest s;
  s.w0 = plucker(L.dx, L.dy, L.dz, L.mx, L.my, L.mz, f(0), f(1), f(2), f(3), f(4), f(5));
  s.w1 = plucker(L.dx, L.dy, L.dz, L.mx, L.my, L.mz, f(6), f(7), f(8), f(9), f(10), f(11));
  s.w2 = plucker(L.dx, L.dy, L.dz, L.mx, L.my, L.mz, f(12), f(13), f(14), f(15), f(16),
                 f(17));
  s.nd = add(add(mul(L.dx, f(18)), mul(L.dy, f(19))), mul(L.dz, f(20)));
  return s;
}

template <class F>
__device__ __forceinline__ float slot_tnum(F f, const LaneRay& L) {
  return add(add(add(mul(-f(18), L.ox), mul(-f(19), L.oy)), mul(-f(20), L.oz)), f(21));
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

// The block's shared state: each lane's ray as three float4 (ox oy oz dx |
// dy dz mx my | mz tmin tmax −), its int result of the round (closest hit:
// the (t|slot) key; any hit: the position j·k + kk of its first hit), the
// round's lane mask of each cluster, the work items and the next unit to
// hand out. Behind it, in dynamic shared memory, the tile's cluster ids
// (and entry t) by position.
struct TraceShared {
  float4 ray[3 * kLanes];
  int res[kLanes];
  unsigned mask[kCH][kWarps];
  int items[kCH * kWarps];   // j << 16 | first mask word << 8 | end word
  int n_items;
  int next;
};


// The tracers' tile order, made once before each tracer launch by one
// block: order[r] is the tile of rank r by descending count (clamped to
// W; ties in any order), so the tiles with the longest cluster lists,
// whose blocks walk the most rounds, start first. A histogram of the
// counts in shared memory (bin W − count), its exclusive prefix sums, then
// each tile's place by an atomic on its bin. The order only schedules: a
// block's results depend on its tile alone.
__global__ void __launch_bounds__(kOrderThreads) tile_order_kernel(
    const int* __restrict__ counts, int nt, int W, int* __restrict__ order) {
  extern __shared__ int bins[];   // (W + 1,)
  __shared__ int warp_sum[kOrderThreads / 32];
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int b = threadIdx.x; b <= W; b += kOrderThreads) bins[b] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += kOrderThreads)
    atomicAdd(&bins[W - min(max(counts[t], 0), W)], 1);
  __syncthreads();
  const int per = (W + kOrderThreads) / kOrderThreads;   // bins a thread, W + 1 in all
  const int b0 = min(threadIdx.x * per, W + 1), b1 = min(b0 + per, W + 1);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += bins[b];
  int inc = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (wl >= off) inc += y;
  }
  if (wl == 31) warp_sum[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int b = b0; b < b1; ++b) {   // a thread's own bins: no other reads them here
    const int h = bins[b];
    bins[b] = run;
    run += h;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += kOrderThreads)
    order[atomicAdd(&bins[W - min(max(counts[t], 0), W)], 1)] = t;
}

// Stages lane i's ray (global index g): origin, direction, Plücker moment
// m = o × d, the clamped t_min and t_max. Returns the clamped t_max.
__device__ __forceinline__ float stage_ray(const float* __restrict__ rays, size_t nl,
                                           size_t g, TraceShared& S, int i) {
  const float ox = rays[g], oy = rays[nl + g], oz = rays[2 * nl + g];
  const float dx = rays[3 * nl + g], dy = rays[4 * nl + g], dz = rays[5 * nl + g];
  const float mx = __fsub_rn(mul(oy, dz), mul(oz, dy));
  const float my = __fsub_rn(mul(oz, dx), mul(ox, dz));
  const float mz = __fsub_rn(mul(ox, dy), mul(oy, dx));
  const float tmin = clampf(rays[6 * nl + g], -kBig, kBig);
  const float tmax = clampf(rays[7 * nl + g], -kBig, kBig);
  S.ray[3 * i] = make_float4(ox, oy, oz, dx);
  S.ray[3 * i + 1] = make_float4(dy, dz, mx, my);
  S.ray[3 * i + 2] = make_float4(mz, tmin, tmax, 0.0f);
  return tmax;
}

__device__ __forceinline__ LaneRay lane_ray(const TraceShared& S, int i) {
  const float4 a = S.ray[3 * i], b = S.ray[3 * i + 1], c = S.ray[3 * i + 2];
  return LaneRay{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z};
}

// The covbit words of round r's clusters for this thread's lane (0 past
// the count): loaded a round ahead, so their latency hides behind the
// round's tests. cov points at the lane's word 0, words `tile` apart.
__device__ __forceinline__ void load_cov_words(const int* __restrict__ cov, int tile,
                                               const int* s_cid, int r, int n_count,
                                               int (&cw)[kCH]) {
#pragma unroll
  for (int j = 0; j < kCH; ++j) {
    const int p = r * kCH + j;
    cw[j] = p < n_count ? cov[(size_t)(s_cid[p] >> 5) * tile] : 0;
  }
}

// Step 1 of a round: every thread passes its lane's pair bits (bit j: the
// pair with the round's cluster j); mask[j] collects them. The caller
// synchronises, cuts the masks into work items (make_items) and
// synchronises again before step 2; n_items and next were reset in the
// previous round's step 3.
__device__ __forceinline__ void gather_pairs(unsigned bits, TraceShared& S) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kCH; ++j) {
    const unsigned b = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
    if (wl == 0) S.mask[j][warp] = b;
  }
}

// After the barrier that follows gather_pairs: thread j cuts cluster j's
// mask words into work items of at least kItemLanes lanes (a cluster's
// last item may have fewer), so that a unit's feature loads serve a few
// tens of tests even in sparse rounds. The caller synchronises after it.
__device__ __forceinline__ void make_items(TraceShared& S) {
  if (threadIdx.x >= kCH) return;
  const int j = threadIdx.x;
  int w0 = 0, acc = 0;
  for (int w = 0; w < kWarps; ++w) {
    acc += __popc(S.mask[j][w]);
    if (acc == 0) {
      w0 = w + 1;
    } else if (acc >= kItemLanes || w == kWarps - 1) {
      S.items[atomicAdd(&S.n_items, 1)] = j << 16 | w0 << 8 | (w + 1);
      acc = 0;
      w0 = w + 1;
    }
  }
}

// Step 2 of a round: the warps take the round's units (a work item's
// lanes against 32 slots of its cluster) one at a time; a warp loads the
// unit's slot features from `packed` into registers, one slot a thread,
// then runs over the item's lanes. on(i, j, kk, t, L) is called for every
// slot kk whose triangle the line of lane i passes inside, with its plane
// t. Returns the slot tests run by this warp's lane-0 thread (32 per lane
// and unit), 0 on the other threads.
template <class On>
__device__ __forceinline__ unsigned long long test_units(
    const float* __restrict__ packed, const int* s_cid, int k, TraceShared& S, On on) {
  const int wl = threadIdx.x & 31;
  const int nchunk = k >> 5;               // a power of two (bad_trace_shape)
  const int csh = __ffs(nchunk) - 1;
  const int n_units = S.n_items * nchunk;
  unsigned long long n = 0;
  for (;;) {
    int u = 0;
    if (wl == 0) u = atomicAdd(&S.next, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    if (u >= n_units) break;
    const int item = S.items[u >> csh];
    const int j = item >> 16;
    const int kk = (u & (nchunk - 1)) * 32 + wl;
    const float* src = packed + (size_t)s_cid[j] * kNF * k + kk;
    float f[22];
#pragma unroll
    for (int q = 0; q < 22; ++q) f[q] = __ldg(src + q * k);
    const auto F = [&](int q) { return f[q]; };
    for (int w = (item >> 8) & 255; w < (item & 255); ++w) {
      unsigned bits = S.mask[j][w];
      if (wl == 0) n += 32u * __popc(bits);
      while (bits) {
        const int i = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        const LaneRay L = lane_ray(S, i);
        SlotTest sl = slot_volumes(F, L);
        if (slot_inside(sl)) {
          sl.tnum = slot_tnum(F, L);
          on(i, j, kk, slot_t(sl), L);
        }
      }
    }
  }
  return n;
}

// ---------------------------------------------------------- closest hit
// Replaces traverse_tiles (pbrt_tpu/kernels/cluster_pallas.py:876, body
// _make_closest_kernel_lc). Closest hit per lane over the tile's covered
// clusters in ascending entry t. A round's pairs are decided at its start
// (the LC kernel's frozen mask): the lane's covbit of cluster j is set,
// the position lies within counts[t], and the cluster's tile entry t is
// no later than the lane's best t. The (t|slot) key keeps the round's slot
// j·k + kk in t's low 11 mantissa bits, so an int atomicMin in shared
// memory picks the winner whatever the order of the hits; after the
// round's barrier each thread keeps its lane's winning slot, and resolves
// the last one into t and barycentrics at the end (features from
// `packed`). Shadow lanes (anyhit > 0) drop their best t to −1 after their
// first hit. A block stops when the next round's entry t >= the max best t
// of its own lanes (no lane of the block could join a later pair).
// `slot_tests` accumulates the slot tests run, k per pair; `needed_tests`
// the tests the function needs, k per pair: the two are equal, the kernel
// runs no test the data does not need. Bound on the card: the float32
// operations of the needed tests.
__global__ void __launch_bounds__(kLanes, kMinBlocks) closest_kernel(
    const float* __restrict__ packed, const float* __restrict__ rays,
    const float* __restrict__ anyhit, const int* __restrict__ corder,
    const float* __restrict__ tnear, const int* __restrict__ counts,
    const int* __restrict__ covbits, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ bary_out,
    unsigned long long* __restrict__ slot_tests,
    unsigned long long* __restrict__ needed_tests, const int* __restrict__ order,
    int nt, int tile, int W, int nb32, int k) {
  __shared__ TraceShared S;
  __shared__ float s_red[kWarps];
  extern __shared__ int s_dyn[];
  int* s_cid = s_dyn;                                     // (W,)
  float* s_tn = reinterpret_cast<float*>(s_dyn + W);      // (W,)
  const int q = tile / kLanes;
  const int t = order[blockIdx.x / q];
  const int i = threadIdx.x;                      // this thread's lane
  const int li = (blockIdx.x % q) * kLanes + i;   // its index in the tile
  const size_t nl = (size_t)nt * tile, g = (size_t)t * tile + li;
  const int n_count = min(counts[t], W);   // the staged list holds W positions
  const int n_rounds = (n_count + kCH - 1) / kCH;
  float* bary0 = bary_out + (size_t)t * 2 * tile;
  if (n_rounds == 0) {   // tile enters no cluster: every lane misses
    t_out[g] = rays[7 * nl + g];
    slot_out[g] = -1;
    bary0[li] = 0.0f;
    bary0[tile + li] = 0.0f;
    return;
  }
  for (int p = i; p < n_count; p += kLanes) {
    s_cid[p] = corder[(size_t)t * W + p];
    s_tn[p] = tnear[(size_t)t * W + p];
  }
  const float tmax = stage_ray(rays, nl, g, S, i);
  float tbest = tmax;
  int slot = -1;
  const bool ah = anyhit != nullptr && anyhit[g] > 0.0f;
  S.res[i] = kInt;
  if (i == 0) S.n_items = S.next = 0;
  const int* cov = covbits + (size_t)t * nb32 * tile + li;
  const int wl = threadIdx.x & 31;
  unsigned long long n_tests = 0, n_needed = 0;
  int cw[kCH];
  const auto block_max = [&](float x) {   // every thread gets the max
    for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (wl == 0) s_red[threadIdx.x >> 5] = x;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) x = fmaxf(x, s_red[w]);
    return x;
  };
  __syncthreads();
  load_cov_words(cov, tile, s_cid, 0, n_count, cw);
  for (int r = 0; r < n_rounds; ++r) {
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kCH; ++j) {
      const int p = r * kCH + j;
      if (p < n_count && tbest >= s_tn[p] && ((cw[j] >> (s_cid[p] & 31)) & 1))
        bits |= 1u << j;
    }
    n_needed += (unsigned long long)k * __popc(bits);
    gather_pairs(bits, S);
    __syncthreads();
    make_items(S);
    __syncthreads();
    load_cov_words(cov, tile, s_cid, r + 1, n_count, cw);   // next round's, ahead
    n_tests += test_units(packed, s_cid + r * kCH, k, S,
                          [&](int li2, int j, int kk, float tt, const LaneRay& L) {
      if (tt > L.tmin)
        atomicMin(&S.res[li2], (__float_as_int(tt) & ~kSlotMask) | (j * k + kk));
    });
    __syncthreads();
    const int kmin = S.res[i];
    S.res[i] = kInt;
    if (i == 0) S.n_items = S.next = 0;
    const float tj = __int_as_float(kmin & ~kSlotMask);
    if (tj < tbest) {   // never for kInt: its t bits are a NaN
      const int s = kmin & kSlotMask, jw = s / k;
      slot = s_cid[r * kCH + jw] * k + (s - jw * k);
      tbest = ah ? -1.0f : tj;
    }
    // ordered-entry-t pruning over the block's lanes
    if (r + 1 < n_rounds && s_tn[(r + 1) * kCH] >= block_max(tbest)) break;
  }
  if (slot_tests != nullptr) add_count(slot_tests, n_tests);
  if (needed_tests != nullptr) add_count(needed_tests, n_needed);
  float tb0 = tmax, tb1 = 0.0f, tb2 = 0.0f;
  if (slot >= 0) {   // the winning slot, resolved once
    const float* src = packed + (size_t)(slot / k) * kNF * k + slot % k;
    const auto F = [&](int f) { return __ldg(src + (size_t)f * k); };
    const LaneRay L = lane_ray(S, i);
    SlotTest sl = slot_volumes(F, L);
    sl.tnum = slot_tnum(F, L);
    const float snd = fabsf(sl.nd) > 1e-12f ? sl.nd : 1e-12f;
    const float sum = add(add(sl.w0, sl.w1), sl.w2);
    const float inv = 1.0f / (fabsf(sum) > 1e-30f ? sum : 1e-30f);
    tb0 = sl.tnum / snd;
    tb1 = mul(sl.w2, inv);
    tb2 = mul(sl.w0, inv);
  }
  t_out[g] = tb0;
  slot_out[g] = slot;
  bary0[li] = tb1;
  bary0[tile + li] = tb2;
}

// -------------------------------------------------------------- any hit
// Replaces occluded_tiles (pbrt_tpu/kernels/cluster_pallas.py:924, body
// _make_anyhit_kernel_lc). Per lane: does any triangle of the tile's
// covered clusters lie at tmin < t < tmax — the exact window, not the
// (t|slot) key of the fused shadow lanes above. A round's pairs are
// decided at its start (the frozen mask): the lane's covbit of cluster j
// is set, the position lies within the count, and the lane is live
// (tmax > tmin) and not yet occluded; lanes occluded during the round
// leave at the next. A hit writes its position j·k + kk into the lane's
// int by atomicMin, so the lane's first hit in (cluster, slot) order is
// known whatever the order of the hits. `slot_tests` accumulates the slot
// tests run, k per pair; `needed_tests` the tests the function needs: per
// lane, k per pair before its first hitting pair and that pair's slots
// up to its first hit. A block stops before a round in which every live
// lane of its own is occluded (a block-wide vote; padding lanes, t_max =
// −1, count as done). Bound on the card: the float32 operations of the
// needed tests.
__global__ void __launch_bounds__(kLanes, kMinBlocks) occluded_kernel(
    const float* __restrict__ packed, const float* __restrict__ rays,
    const int* __restrict__ corder, const int* __restrict__ counts,
    const int* __restrict__ covbits, unsigned char* __restrict__ occ_out,
    unsigned long long* __restrict__ slot_tests,
    unsigned long long* __restrict__ needed_tests, const int* __restrict__ order,
    int nt, int tile, int W, int nb32, int k) {
  __shared__ TraceShared S;
  extern __shared__ int s_cid[];   // (W,)
  const int q = tile / kLanes;
  const int t = order[blockIdx.x / q];
  const int i = threadIdx.x;
  const int li = (blockIdx.x % q) * kLanes + i;
  const size_t nl = (size_t)nt * tile, g = (size_t)t * tile + li;
  const int n_count = min(counts[t], W);   // the staged list holds W positions
  const int n_rounds = (n_count + kCH - 1) / kCH;
  if (n_rounds == 0) {   // tile enters no cluster: nothing is occluded
    occ_out[g] = 0;
    return;
  }
  for (int p = i; p < n_count; p += kLanes) s_cid[p] = corder[(size_t)t * W + p];
  const float tmax = stage_ray(rays, nl, g, S, i);
  const bool live = tmax > clampf(rays[6 * nl + g], -kBig, kBig);
  bool occ = false;
  S.res[i] = kInt;
  if (i == 0) S.n_items = S.next = 0;
  const int* cov = covbits + (size_t)t * nb32 * tile + li;
  unsigned long long n_tests = 0, n_needed = 0;
  int cw[kCH];
  __syncthreads();
  load_cov_words(cov, tile, s_cid, 0, n_count, cw);
  for (int r = 0; r < n_rounds; ++r) {
    // set-up, or the previous round's step 3, is done
    if (__syncthreads_and(occ || !live)) break;
    unsigned bits = 0;
    if (live && !occ) {
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const int p = r * kCH + j;
        if (p < n_count && ((cw[j] >> (s_cid[p] & 31)) & 1)) bits |= 1u << j;
      }
    }
    gather_pairs(bits, S);
    __syncthreads();
    make_items(S);
    __syncthreads();
    load_cov_words(cov, tile, s_cid, r + 1, n_count, cw);   // next round's, ahead
    n_tests += test_units(packed, s_cid + r * kCH, k, S,
                          [&](int li2, int j, int kk, float tt, const LaneRay& L) {
      if (tt > L.tmin && tt < L.tmax) atomicMin(&S.res[li2], j * k + kk);
    });
    __syncthreads();
    const int first = S.res[i];
    S.res[i] = kInt;
    if (i == 0) S.n_items = S.next = 0;
    if (first != kInt) {
      const int jf = first / k;
      occ = true;
      n_needed += (unsigned long long)k * __popc(bits & ((1u << jf) - 1u)) + first - jf * k + 1;
    } else {
      n_needed += (unsigned long long)k * __popc(bits);
    }
  }
  if (slot_tests != nullptr) add_count(slot_tests, n_tests);
  if (needed_tests != nullptr) add_count(needed_tests, n_needed);
  occ_out[g] = occ;
}

// --------------------------------------------------------------- probes
// Lane compaction probe. Replaces the probe `main` of debug_lc_prim2.py:89
// (body `kernel` :38), whose rank-based compaction of a (1, tile) mask
// returns out = val and slot = 1 where the mask is set (> 0.5) and val is
// nonzero, else out = 0 and slot = −1: the reference expands a lane only
// where its gathered value vc != 0, so a set lane whose val is 0 or −0
// stays 0, −1. One block of ceil(tile/32)·32 threads, a lane a thread, one
// pass: each thread reads its lane's mask and val together (val into
// shared memory: the kernel's one round trip to device memory), a ballot
// and popcount rank each set lane within its warp, warp 0 scans the warp
// totals with shuffles, each set lane writes its index to list[rank] (an
// unset lane writes its 0 and −1 at once), and thread e gathers vc =
// val[list[e]] into the compacted domain and expands it back,
// out[list[e]] = vc, slot[list[e]] = 1 where vc != 0 (else 0, −1).
// Bound: one launch's latency (the bytes are a few KB); launch_floor_kernel,
// empty, is the floor beside it.
__global__ void __launch_bounds__(1024) compact_probe_kernel(
    const float* __restrict__ mask, const float* __restrict__ val,
    float* __restrict__ out, int* __restrict__ slot, int tile) {
  __shared__ int list[1024];
  __shared__ float sval[1024];
  __shared__ int base[33];   // each warp's first rank, then the total
  const int i = threadIdx.x, warp = i >> 5, wl = i & 31;
  const int nw = (int)(blockDim.x >> 5);
  const float m = i < tile ? mask[i] : 0.0f;
  if (i < tile) sval[i] = val[i];
  const bool p = m > 0.5f;
  const unsigned ballot = __ballot_sync(0xffffffffu, p);
  if (wl == 0) base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int n = wl < nw ? base[wl] : 0;
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (wl >= off) incl += up;
    }
    if (wl < nw) base[wl] = incl - n;
    if (wl == 31) base[32] = incl;
  }
  __syncthreads();
  if (p) {
    list[base[warp] + __popc(ballot & ((1u << wl) - 1u))] = i;
  } else if (i < tile) {
    out[i] = 0.0f;
    slot[i] = -1;
  }
  __syncthreads();
  if (i < base[32]) {
    const int l = list[i];
    const float vc = sval[l];
    out[l] = vc != 0.0f ? vc : 0.0f;
    slot[l] = vc != 0.0f ? 1 : -1;
  }
}

// An empty kernel: the device time of a one-block launch that does nothing.
__global__ void launch_floor_kernel() {}

// Overhead probe. Replaces `run` of profile_overhead.py:111 (body `make`
// :38), the per-grid-step cost of traverse_tiles' block structure: one
// block a tile, rounds of kProbeCH clusters in corder order, a cluster
// being kProbeFeat features of n5·k slots, feature-major (packed (C, 16,
// n5, k), 16·n5·k floats a cluster, contiguous).
//   kind 0  empty:          out = ray plane 0
//   kind 1  stage:          stage every cluster of each round; acc +=
//                           feature 0 of the round's first cluster's slot 0
//   kind 2  stage+compute:  acc += min over the round's kProbeCH·n5·k
//                           slots of Σ_q F[q]·plane[q mod 8], the q = 0
//                           product first, then q = 1..15 added in turn
// A round stages all of its clusters even where the tile's count ends in
// it, as the reference does.
//
// Design. A thread holds two lanes (i and i + tile/2), their 16 plane
// values in registers; `groups` groups of tile/2 threads each take their
// share of every cluster's slots (two groups wherever the block's 1,024
// threads allow, as at tile 256: 8 compute warps a block, twice the warps
// to hide latency with), and at a round's end group 0 takes the minimum
// over the groups' minima (exact in any order). Staging is a ring of
// kProbeRing = 2 cluster buffers in dynamic shared memory (80 KB at n5 =
// 5, so two blocks share an SM; three to five buffers, one block an SM,
// ran slower at n5 = 5, and at n5 = 1 no ring size ran faster than
// another). One producer warp, beside the
// compute threads, has its first thread keep the ring full with one 1-D
// bulk copy (cp.async.bulk, no tensor map) per cluster, which completes on
// the buffer's `full` mbarrier (armed with expect_tx); it crosses round
// boundaries, so the next round's clusters are in flight while this one
// is computed. A buffer is refilled only once every compute thread has
// arrived on its `empty` mbarrier after its last read. The compute reads
// a buffer as packed lays it out: every thread of a warp reads the same
// address (a broadcast), and one float4 load gives 4 slots of a feature,
// so 16 loads feed 8 (lane, slot) dots of 31 float operations each, and
// the FP32 pipes, not shared memory, set the pace. Each lane keeps its
// running minimum over a round's clusters and adds it into acc at the
// round's end.
// Bound: operations, 32 f32 ops per (lane, slot) at 67 TFLOP/s, a rate
// only fused multiply-adds reach. Built with -fmad=false (bit parity with
// the plain version), the 16 products and 15 sums are separate
// instructions, so the FP32 issue rate caps the kernel at twice the bound.
// Tensor cores are out: mma/wgmma on f32 inputs round them to TF32, and
// even a 3×TF32 split is not exact, so no tensor-core design can equal
// the plain version bit for bit.
constexpr int kProbeCH = 8;       // clusters per overhead-probe round
constexpr int kProbeFeat = 16;    // features per overhead-probe slot
constexpr int kProbeRing = 2;     // cluster buffers of the overhead probe's ring
constexpr int kMaxDynSmem = 232448;   // 227 KB: what a block may take

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of the given parity. A
// wait of some 10 s (2^34 cycles) can only be a broken pipeline: it traps,
// failing the launch, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// A barrier of the n compute threads (warps 0 .. n/32 − 1), without the
// producer warp.
__device__ __forceinline__ void compute_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// NK4 = n5·k/4, the float4 columns of a feature: 160 and 32 at the probe's
// shapes (n5 = 5 and 1, k = 128), fixed at compile time so that every
// shared-memory load takes an immediate offset.
template <int NK4>
__global__ void __launch_bounds__(1024) overhead_probe_kernel(
    int kind, const float* __restrict__ packed, const float* __restrict__ planes,
    const int* __restrict__ corder, const int* __restrict__ counts,
    float* __restrict__ out, int nt, int tile, int cpad, int groups) {
  constexpr int nk4 = NK4, ring = kProbeRing;
  const int half = tile / 2, i = threadIdx.x, t = blockIdx.x;
  const int n_comp = half * groups, li = i % half, grp = i / half;
  const size_t nl = (size_t)nt * tile, g = (size_t)t * tile + li;
  if (kind == 0) {   // tile/2 threads, no producer warp, no shared memory
    out[g] = planes[g];
    out[g + half] = planes[g + half];
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cl_floats = kProbeFeat * 4 * nk4;
  float* feat = reinterpret_cast<float*>(smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  uint64_t* full = reinterpret_cast<uint64_t*>(feat + (size_t)ring * cl_floats);
  uint64_t* empty = full + ring;
  float* part = reinterpret_cast<float*>(empty + ring);   // (groups − 1, tile) minima
  const int count = counts[t];
  const int n_rounds =
      count <= 0 ? 0 : min(count / kProbeCH + (count % kProbeCH != 0), cpad / kProbeCH);
  const int total = n_rounds * kProbeCH;   // clusters staged, never past the tile's corder
  if (i == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_comp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (i >= n_comp) {   // the producer warp: its first thread keeps the ring full
    if (i == n_comp) {
      const uint32_t bytes = (uint32_t)cl_floats * 4u;
      const int* ids = corder + (size_t)t * cpad;
      for (int c = 0; c < total; ++c) {
        const int s = c % ring;
        if (c >= ring) mbar_wait(&empty[s], ((c / ring) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        bulk_load(feat + (size_t)s * cl_floats, packed + (size_t)ids[c] * cl_floats, bytes,
                  &full[s]);
      }
    }
    return;
  }

  float la[8], lb[8];
  if (kind == 2) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      la[p] = planes[p * nl + g];
      lb[p] = planes[p * nl + g + half];
    }
  }
  float acc_a = 0.0f, acc_b = 0.0f, ma = CUDART_INF_F, mb = CUDART_INF_F;
  const int s4_lo = nk4 * grp / groups, s4_hi = nk4 * (grp + 1) / groups;   // this group's
  for (int c = 0; c < total; ++c) {
    const int s = c % ring, j = c % kProbeCH;
    mbar_wait(&full[s], (c / ring) & 1);
    const float* f = feat + (size_t)s * cl_floats;
    if (kind == 1) {
      if (j == 0 && grp == 0) {
        acc_a = add(acc_a, f[0]);
        acc_b = add(acc_b, f[0]);
      }
    } else {
      const float4* f4 = reinterpret_cast<const float4*>(f);
      for (int s4 = s4_lo; s4 < s4_hi; ++s4) {
        float4 F = f4[s4];
        float a0 = mul(F.x, la[0]), a1 = mul(F.y, la[0]), a2 = mul(F.z, la[0]),
              a3 = mul(F.w, la[0]);
        float b0 = mul(F.x, lb[0]), b1 = mul(F.y, lb[0]), b2 = mul(F.z, lb[0]),
              b3 = mul(F.w, lb[0]);
#pragma unroll
        for (int q = 1; q < kProbeFeat; ++q) {
          F = f4[q * nk4 + s4];
          a0 = add(a0, mul(F.x, la[q & 7]));
          a1 = add(a1, mul(F.y, la[q & 7]));
          a2 = add(a2, mul(F.z, la[q & 7]));
          a3 = add(a3, mul(F.w, la[q & 7]));
          b0 = add(b0, mul(F.x, lb[q & 7]));
          b1 = add(b1, mul(F.y, lb[q & 7]));
          b2 = add(b2, mul(F.z, lb[q & 7]));
          b3 = add(b3, mul(F.w, lb[q & 7]));
        }
        ma = fminf(ma, fminf(fminf(a0, a1), fminf(a2, a3)));
        mb = fminf(mb, fminf(fminf(b0, b1), fminf(b2, b3)));
      }
    }
    mbar_arrive(&empty[s]);   // this thread's reads of buffer s are done
    if (kind == 2 && j == kProbeCH - 1) {   // the round's minima, over the groups
      if (groups > 1) {
        if (grp > 0) {
          part[(grp - 1) * tile + li] = ma;
          part[(grp - 1) * tile + li + half] = mb;
        }
        compute_sync(n_comp);
        for (int h = 1; grp == 0 && h < groups; ++h) {
          ma = fminf(ma, part[(h - 1) * tile + li]);
          mb = fminf(mb, part[(h - 1) * tile + li + half]);
        }
        compute_sync(n_comp);   // part is rewritten at the next round's end
      }
      acc_a = add(acc_a, ma);
      acc_b = add(acc_b, mb);
      ma = mb = CUDART_INF_F;
    }
  }
  if (grp == 0) {
    out[g] = acc_a;
    out[g + half] = acc_b;
  }
}

// One launch of overhead_probe_kernel<NK4>, its dynamic shared memory
// allowed first.
template <int NK4>
int launch_overhead_probe(int kind, const void* packed, const void* planes,
                          const void* corder, const void* counts, void* out, int nt,
                          int tile, int cpad, int groups, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      overhead_probe_kernel<NK4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  overhead_probe_kernel<NK4>
      <<<nt, kind == 0 ? tile / 2 : tile / 2 * groups + 32, smem, stream>>>(
          kind, (const float*)packed, (const float*)planes, (const int*)corder,
          (const int*)counts, (float*)out, nt, tile, cpad, groups);
  return (int)cudaGetLastError();
}

bool bad_trace_shape(int tile, int W, int k, int ch) {
  // whole blocks; k slots in a power of two of 32-slot units; the round's
  // pair bits and the (t|slot) key as the kernels lay them out
  const int nchunk = k / 32;
  return tile <= 0 || tile % kLanes || ch != kCH || k <= 0 || k % 32 ||
         (nchunk & (nchunk - 1)) || ch * k > kSlotMask + 1 || W <= 0 || W % ch != 0;
}

// Dynamic shared memory beyond the default 48 KB (with the kernel's
// static part, `fixed` bytes) needs the attribute.
template <class K>
cudaError_t allow_smem(K kernel, int dyn, int fixed) {
  if (dyn + fixed + 64 <= 48 * 1024) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Stream-ordered scratch of `bytes` (a launch's tile order, coverage's
// ray terms and unit list), from a memory pool of this library's own on the
// current device, which keeps its memory between launches (the device's
// default pool hands it back to the driver at every synchronisation).
cudaError_t scratch_alloc(size_t bytes, cudaStream_t stream, void** out) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static cudaMemPool_t pools[kMaxDevices] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (pools[dev] == nullptr) {
      cudaMemPoolProps props = {};
      props.allocType = cudaMemAllocationTypePinned;
      props.location.type = cudaMemLocationTypeDevice;
      props.location.id = dev;
      cudaMemPool_t pool;
      if ((e = cudaMemPoolCreate(&pool, &props)) != cudaSuccess) return e;
      uint64_t keep = UINT64_MAX;
      e = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
      if (e != cudaSuccess) return e;
      pools[dev] = pool;
    }
  }
  return cudaMallocFromPoolAsync(out, bytes, pools[dev], stream);
}

// Blocks of the column pass: enough to fill every SM, fewer for a small
// launch.
int column_blocks(long long units) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long need = (units + kColWarps - 1) / kColWarps;
  return (int)(need < (long long)sms * kColBlocksPerSM ? need : (long long)sms * kColBlocksPerSM);
}

// A tracer launch: checks its shape, allows its dynamic shared memory
// (dyn bytes), orders the tiles (tile_order_kernel), then calls
// launch(order, blocks, dyn); the order's scratch is freed in stream order.
template <class K, class L>
int launch_tracer(K kernel, const void* counts, int nt, int tile, int W, int k, int ch,
                  int dyn, cudaStream_t stream, L launch) {
  if (bad_trace_shape(tile, W, k, ch)) return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  const int order_dyn = (W + 1) * (int)sizeof(int);
  cudaError_t e = allow_smem(kernel, dyn, (int)sizeof(TraceShared) + kWarps * 4);
  if (e == cudaSuccess) e = allow_smem(tile_order_kernel, order_dyn, kOrderThreads / 8);
  if (e != cudaSuccess) return (int)e;
  int* order = nullptr;
  if ((e = scratch_alloc((size_t)nt * sizeof(int), stream, (void**)&order)) != cudaSuccess)
    return (int)e;
  tile_order_kernel<<<1, kOrderThreads, order_dyn, stream>>>((const int*)counts, nt, W,
                                                             order);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    launch(order, nt * (tile / kLanes), dyn);
    e = cudaGetLastError();
  }
  const cudaError_t f = cudaFreeAsync(order, stream);
  return (int)(e != cudaSuccess ? e : f);
}

}  // namespace

extern "C" {

// Coverage with its test counters (either may be NULL): the lane pass,
// then the column pass, with the ray terms, the unit list and its count in
// scratch.
int pbrt_coverage_counted(const void* rays, const void* bounds, const void* n_live_tiles,
                          void* tnear, void* covbits, void* tests_run, void* tests_needed,
                          int nt, int tile, int cpad, int n_clusters, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int box_smem = (cpad / 32) * 2 * (int)sizeof(float4);
  const long long max_units = (long long)nt * (cpad / 32) * (tile / 32);
  // a unit's `where` holds (t·nw + w) in 27 bits and the chunk in 5
  if (tile <= 0 || tile % 32 || tile > 1024 || cpad <= 0 || cpad % 32 ||
      box_smem > 200 * 1024 || (long long)nt * (cpad / 32) >= (1ll << 27))
    return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  cudaError_t e = allow_smem(coverage_lanes_kernel, box_smem, (int)(kLaneWarps * kWordGroup *
                                                                    sizeof(CovUnit)));
  if (e != cudaSuccess) return (int)e;
  const size_t lanes = (size_t)nt * tile;
  void* scratch = nullptr;
  e = scratch_alloc(lanes * 2 * sizeof(float4) + max_units * sizeof(CovUnit) + sizeof(int), s,
                    &scratch);
  if (e != cudaSuccess) return (int)e;
  float4* terms = (float4*)scratch;
  CovUnit* units = (CovUnit*)(terms + 2 * lanes);
  int* n_units = (int*)(units + max_units);
  e = cudaMemsetAsync(n_units, 0, sizeof(int), s);
  if (e == cudaSuccess) {
    coverage_lanes_kernel<<<nt * ((tile + kLaneThreads - 1) / kLaneThreads), kLaneThreads,
                            box_smem, s>>>(
        (const float*)rays, (const float*)bounds, (const int*)n_live_tiles, terms, units,
        n_units, (float*)tnear, (int*)covbits, (unsigned long long*)tests_run,
        (unsigned long long*)tests_needed, nt, tile, cpad);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    coverage_columns_kernel<<<column_blocks(max_units), kColThreads, 0, s>>>(
        terms, (const float*)bounds, units, n_units, (float*)tnear, (int*)covbits,
        (unsigned long long*)tests_run, tile, cpad, n_clusters);
    e = cudaGetLastError();
  }
  const cudaError_t f = cudaFreeAsync(scratch, s);
  return (int)(e != cudaSuccess ? e : f);
}

int pbrt_coverage(const void* rays, const void* bounds, const void* n_live_tiles,
                  void* tnear, void* covbits, int nt, int tile, int cpad,
                  int n_clusters, void* stream) {
  return pbrt_coverage_counted(rays, bounds, n_live_tiles, tnear, covbits, nullptr, nullptr,
                               nt, tile, cpad, n_clusters, stream);
}

int pbrt_closest(const void* packed, const void* rays, const void* anyhit,
                 const void* corder, const void* tnear, const void* counts,
                 const void* covbits, void* t_out, void* slot_out,
                 void* bary_out, void* slot_tests, void* needed_tests, int nt,
                 int tile, int W, int nb32, int k, int ch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  // dynamic shared memory: the tile's cluster ids and entry t
  return launch_tracer(closest_kernel, counts, nt, tile, W, k, ch, 2 * W * (int)sizeof(int), s,
                       [&](const int* order, int blocks, int dyn) {
    closest_kernel<<<blocks, kLanes, dyn, s>>>(
        (const float*)packed, (const float*)rays, (const float*)anyhit,
        (const int*)corder, (const float*)tnear, (const int*)counts,
        (const int*)covbits, (float*)t_out, (int*)slot_out, (float*)bary_out,
        (unsigned long long*)slot_tests, (unsigned long long*)needed_tests, order, nt,
        tile, W, nb32, k);
  });
}

int pbrt_occluded(const void* packed, const void* rays, const void* corder,
                  const void* counts, const void* covbits, void* occ_out,
                  void* slot_tests, void* needed_tests, int nt, int tile, int W,
                  int nb32, int k, int ch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  // dynamic shared memory: the tile's cluster ids
  return launch_tracer(occluded_kernel, counts, nt, tile, W, k, ch, W * (int)sizeof(int), s,
                       [&](const int* order, int blocks, int dyn) {
    occluded_kernel<<<blocks, kLanes, dyn, s>>>(
        (const float*)packed, (const float*)rays, (const int*)corder,
        (const int*)counts, (const int*)covbits, (unsigned char*)occ_out,
        (unsigned long long*)slot_tests, (unsigned long long*)needed_tests, order, nt,
        tile, W, nb32, k);
  });
}

int pbrt_compact_probe(const void* mask, const void* val, void* out, void* slot,
                       int tile, void* stream) {
  if (tile <= 0 || tile > 1024) return (int)cudaErrorInvalidValue;
  compact_probe_kernel<<<1, (tile + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (const float*)val, (float*)out, (int*)slot, tile);
  return (int)cudaGetLastError();
}

int pbrt_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The overhead probe: packed (C, 16, n5, 128), n5 5 or 1. A block has two
// groups of tile/2 compute threads where they and the producer warp fit in
// 1,024 threads (tile ≤ 960), else one.
int pbrt_overhead_probe(int kind, const void* packed, const void* planes,
                        const void* corder, const void* counts, void* out, int nt,
                        int tile, int cpad, int n5, int k, void* stream) {
  const int groups = tile + 32 <= 1024 ? 2 : 1;
  const long long cl_bytes = 4ll * kProbeFeat * n5 * k;
  const long long smem =
      kind == 0 ? 0 : kProbeRing * (cl_bytes + 16) + 128 + 4ll * (groups - 1) * tile;
  if (kind < 0 || kind > 2 || tile <= 0 || tile > 1024 || tile % 64 || (n5 != 5 && n5 != 1) ||
      k != 128 || cpad <= 0 || cpad % kProbeCH || smem > kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  auto launch = n5 == 5 ? launch_overhead_probe<160> : launch_overhead_probe<32>;
  return launch(kind, packed, planes, corder, counts, out, nt, tile, cpad, groups, (int)smem,
                (cudaStream_t)stream);
}

}  // extern "C"
