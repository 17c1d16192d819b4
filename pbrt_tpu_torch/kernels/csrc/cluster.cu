// Tile×cluster ray-tracing kernels for Hopper (sm_90a): coverage and
// closest hit. Plain C interface, loaded with ctypes by
// pbrt_tpu_torch/kernels/cluster_cuda.py, which also holds the plain
// PyTorch version of each kernel.
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
constexpr int kClosestThreads = 512;  // threads per closest-hit block
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

// ---------------------------------------------------------- closest hit
// One block per tile. The tile's clusters are taken `ch` at a time in
// ascending entry t; each round's features are staged in shared memory,
// slot-major (24 floats a slot, read as six float4). A lane joins a round
// iff it enters one of the round's clusters (its covbit) no later than
// its best hit so far — decided for every lane at the start of the round —
// and then tests all ch·k slots (Plücker volumes w_i = d·U_i + m·V_i,
// plane t = (k − n·o)/(n·d)). The (t|slot) key keeps the slot in t's low
// 11 mantissa bits so one min picks the winner. Shadow lanes (anyhit > 0)
// drop their best t to −1 after their first hit. The tile stops when the
// next round's entry t >= max best t.
//
// Work layout: the round's joining lanes are compacted into a list; a
// group of `ch` threads takes one lane, thread j testing cluster j's k
// slots, and the group's minimum key comes from warp shuffles. Lane state
// lives in shared memory, so any group can take any lane. Each cluster's
// block of slots is padded by one float4 so that the group's ch threads,
// which read the same slot of ch clusters, hit distinct banks. `slot_tests`,
// when given, accumulates the slot tests run (the data-dependent work
// that bounds the kernel).
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

// f: one slot's 24 features, 16-byte aligned
__device__ __forceinline__ SlotTest slot_test(const float* f, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, float mx, float my,
                                              float mz) {
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

// lane state in shared memory, (kState, tile) floats
enum { kOx, kOy, kOz, kDx, kDy, kDz, kMx, kMy, kMz, kTmin, kTbest, kTb0, kTb1,
       kTb2, kSlot, kAh, kState };

__global__ void __launch_bounds__(kClosestThreads) closest_kernel(
    const float* __restrict__ packed, const float* __restrict__ rays,
    const float* __restrict__ anyhit, const int* __restrict__ corder,
    const float* __restrict__ tnear, const int* __restrict__ counts,
    const int* __restrict__ covbits, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ bary_out,
    unsigned long long* __restrict__ slot_tests, int nt, int tile, int W,
    int nb32, int k, int ch) {
  extern __shared__ float4 smem4[];
  const int cstride = k * kNF + 4;                 // floats per staged cluster
  float* feat = reinterpret_cast<float*>(smem4);   // (ch, k·kNF + 4)
  float* st = feat + (size_t)ch * cstride;         // (kState, tile)
  int* list = reinterpret_cast<int*>(st + (size_t)kState * tile);   // (tile,)
  __shared__ int s_cid[kMaxCH];
  __shared__ float s_tn[kMaxCH];
  __shared__ float s_red[kClosestThreads / 32];
  __shared__ int s_count;
  __shared__ int s_done;
  const int t = blockIdx.x;
  const size_t nl = (size_t)nt * tile;
  const int n_rounds = (counts[t] + ch - 1) / ch;
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
    const float tmax = clampf(rays[7 * nl + g], -kBig, kBig);
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
  unsigned long long n_tests = 0;
  for (int r = 0; r < n_rounds; ++r) {
    __syncthreads();   // the previous round's shared-memory reads are done
    if (threadIdx.x < ch) {
      s_cid[threadIdx.x] = corder[(size_t)t * W + r * ch + threadIdx.x];
      s_tn[threadIdx.x] = tnear[(size_t)t * W + r * ch + threadIdx.x];
    }
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < chk * kNF; i += blockDim.x) {
      const int jj = i / (kNF * k);
      const int rem = i - jj * kNF * k;
      const int f = rem / k, kk = rem - f * k;
      feat[jj * cstride + kk * kNF + f] = packed[(size_t)s_cid[jj] * kNF * k + rem];
    }
    // the round's joining lanes, from best t at the start of the round
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const float tb = st[kTbest * tile + i];
      bool mask = false;
      for (int jj = 0; jj < ch; ++jj) {
        const int cid = s_cid[jj];
        const int word = covbits[((size_t)t * nb32 + (cid >> 5)) * tile + i];
        mask |= ((word >> (cid & 31)) & 1) && (tb >= s_tn[jj]);
      }
      if (mask) list[atomicAdd(&s_count, 1)] = i;
    }
    __syncthreads();
    const int m = s_count;
    for (int e = group; e < m; e += n_groups) {
      const int i = list[e];
      const float ox = st[kOx * tile + i], oy = st[kOy * tile + i], oz = st[kOz * tile + i];
      const float dx = st[kDx * tile + i], dy = st[kDy * tile + i], dz = st[kDz * tile + i];
      const float mx = st[kMx * tile + i], my = st[kMy * tile + i], mz = st[kMz * tile + i];
      const float tmin = st[kTmin * tile + i];
      int kmin = 0x7FFFFFFF;
      const float* fj = feat + (size_t)j * cstride;
      for (int kk = 0; kk < k; ++kk) {
        const SlotTest sl = slot_test(fj + kk * kNF, ox, oy, oz, dx, dy, dz, mx, my, mz);
        const float hm = fminf(fminf(mul(sl.w0, sl.nd), mul(sl.w1, sl.nd)),
                               mul(sl.w2, sl.nd));
        if (!(hm >= 0.0f)) continue;
        const float tt = mul(sl.tnum, 1.0f / sl.nd);
        if (!(tt > tmin)) continue;
        kmin = min(kmin, (__float_as_int(tt) & ~kSlotMask) | (j * k + kk));
      }
      for (int off = ch >> 1; off; off >>= 1)
        kmin = min(kmin, __shfl_xor_sync(gmask, kmin, off));
      if (j == 0) {
        n_tests += chk;
        const float tj = __int_as_float(kmin & ~kSlotMask);
        if (tj < st[kTbest * tile + i]) {
          const int s = kmin & kSlotMask;
          const SlotTest sl = slot_test(feat + (size_t)(s / k) * cstride + (s % k) * kNF,
                                        ox, oy, oz, dx, dy, dz, mx, my, mz);
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
      for (int w = 1; w < kClosestThreads / 32; ++w) mm = fmaxf(mm, s_red[w]);
      s_done = tnear[(size_t)t * W + min((r + 1) * ch, W - 1)] >= mm;
    }
    __syncthreads();
    if (s_done) break;
  }
  if (slot_tests != nullptr && n_tests) atomicAdd(slot_tests, n_tests);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = (size_t)t * tile + i;
    t_out[g] = st[kTb0 * tile + i];
    slot_out[g] = __float_as_int(st[kSlot * tile + i]);
    bary0[i] = st[kTb1 * tile + i];
    bary0[tile + i] = st[kTb2 * tile + i];
  }
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
                 void* bary_out, void* slot_tests, int nt, int tile, int W,
                 int nb32, int k, int ch, void* stream) {
  // a group of ch threads shares one warp; k slots keep float4 alignment
  if (tile <= 0 || tile > 1024 || ch < 1 || ch > kMaxCH || (ch & (ch - 1)) ||
      ch * k > kSlotMask + 1 || W % ch != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (ch * (k * kNF + 4) + kState * tile + tile) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      closest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  closest_kernel<<<nt, kClosestThreads, smem, (cudaStream_t)stream>>>(
      (const float*)packed, (const float*)rays, (const float*)anyhit,
      (const int*)corder, (const float*)tnear, (const int*)counts,
      (const int*)covbits, (float*)t_out, (int*)slot_out, (float*)bary_out,
      (unsigned long long*)slot_tests, nt, tile, W, nb32, k, ch);
  return (int)cudaGetLastError();
}

}  // extern "C"
