// Per-class bucketized water-fill over all scheduling classes, for Hopper.
//
// Replaces the TPU kernel `_pallas_class_fill` (ray_tpu/scheduler/
// jax_backend.py, pallas_call at :374).  The math is `_bucket_fill_step`
// (same file, :127): for each class c in order, against the availability
// left by class c-1,
//
//   cap[n]    = clip(floor(min_{r: d_r>0} av[r,n]/max(d_r,eps) + eps), 0, cnt)
//   score[n]  = max over demanded r (all r if none) of (total-av)/max(total,eps)
//   bucket[n] = one of 35 fill buckets (cost pre-buckets, spread zone,
//               16 utilization levels, accelerator-avoid, empty)
//   prefix[n] = exclusive prefix of cap in (bucket, node id rotated by
//               shifts[c]) order
//   take[n]   = clip(cnt - prefix[n], 0, cap[n]);  av[:,n] -= d * take[n]
//
// Design: ONE persistent thread-block cluster (8 blocks of 1024 threads,
// one per SM) walks the classes in order, because class c+1 reads the
// availability class c left; a cluster barrier ends each class.  The
// availability [R, N] lives in global memory (it outgrows shared memory at
// the bench shape) and stays in L2.  Per class, block k owns the k-th
// eighth of the class's ROTATED node order and each of its threads a
// contiguous run of it, so a per-thread partial sum per bucket, an
// exclusive scan of those partials across the block's threads, the other
// blocks' bucket totals (read from their shared memory) and a scan over
// the 35 global bucket totals give every node its prefix directly.
//
// The 32 runs of a warp form one contiguous range, so the node-local work
// (cap and bucket from av/total/cost; allocs and the availability update
// from take) reads and writes that range lane-interleaved, coalesced, and
// only the scan walks the per-thread runs, through a [N] scratch row of
// cap (then take) and bucket.  Only the resources a class demands are
// read, and nodes that take nothing are not written back.
//
// All partial sums are integers below 2^24 wherever the result matters, so
// the summation order changes nothing and the output is bit-equal to the
// plain PyTorch version (built without FMA contraction: -fmad=false, no
// fast math).
//
// Availability and the per-node flags are written by one SM and read by
// another, so they are read through L2 (__ldcg), never from a stale L1
// line; the cluster barriers order those writes and reads.
//
// Plain C entry point, bound with ctypes; returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Blocks of the thread-block cluster (8, the portable maximum) and
// threads per block.
constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kPer = kThreads / 32;   // partials each lane scans
constexpr int kWarps = kThreads / 32;
constexpr int kUtilLevels = 16;
constexpr int kCostBuckets = 16;
constexpr int kBuckets = kCostBuckets + kUtilLevels + 3;   // 35
// Row stride of the [bucket][thread] partials: one pad float per 32
// threads so a lane walking its 32 consecutive entries hits other banks
// than its neighbours.
constexpr int kRow = kThreads + kThreads / 32;
constexpr float kEps = 1e-6f;
constexpr float kBig = 1e9f;
// Static per-node flags, computed once per call.
constexpr uint8_t kAccelNode = 1;
constexpr uint8_t kEmpty = 2;

__device__ __forceinline__ int pad_idx(int t) { return t + (t >> 5); }

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
class_fill_kernel(const float* __restrict__ av0,
                  const float* __restrict__ total,
                  const float* __restrict__ demand,
                  const float* __restrict__ counts,
                  const uint8_t* __restrict__ accel_class,
                  const uint8_t* __restrict__ accel_node,
                  const int* __restrict__ shifts,
                  const float* __restrict__ cost,
                  const float* __restrict__ scalars,   // [thr, invert]
                  float* __restrict__ av,              // out: [R, N]
                  float* __restrict__ allocs,          // out: [C, N]
                  float* __restrict__ cap_buf,         // scratch [N]
                  int* __restrict__ bucket_buf,        // scratch [N]
                  uint8_t* __restrict__ flags,         // scratch [N]
                  int c_pad, int n_pad, int r_pad) {
  extern __shared__ float part[];                      // [kBuckets][kRow]
  __shared__ float btot[kBuckets];     // this block's bucket totals
  __shared__ float base[kBuckets];     // global bucket prefix + block offset
  __shared__ float part_tot[kBuckets]; // global bucket totals
  __shared__ float dem[64];
  __shared__ unsigned long long used;   // bit b: bucket b holds a node

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // Block `rank` owns positions [rank * kThreads * chunk, ...) of the
  // rotated order; thread t of it a run of `chunk` positions.
  const int chunk = (n_pad + kCluster * kThreads - 1) / (kCluster * kThreads);
  const int bbase = rank * kThreads * chunk;
  const int j0 = min(bbase + t * chunk, n_pad);
  const int j1 = min(j0 + chunk, n_pad);
  // A warp owns the 32 runs of its threads: one contiguous range of
  // positions, read lane-interleaved for the node-local work.
  const int wbase = min(bbase + warp * 32 * chunk, n_pad);
  const int wend = min(wbase + 32 * chunk, n_pad);
  const int gt = rank * kThreads + t;
  constexpr int kStride = kCluster * kThreads;

  for (int i = gt; i < r_pad * n_pad; i += kStride) av[i] = av0[i];
  for (int n = gt; n < n_pad; n += kStride) {
    float tot_max = -CUDART_INF_F;
    for (int r = 0; r < r_pad; ++r)
      tot_max = fmaxf(tot_max, total[(size_t)r * n_pad + n]);
    flags[n] = (accel_node[n] ? kAccelNode : 0) |
               (tot_max <= 0.0f ? kEmpty : 0);
  }

  const float thr = scalars[0];
  const bool invert = scalars[1] > 0.0f;
  const float scale = (float)kUtilLevels / fmaxf(1.0f - thr, kEps);
  cluster.sync();

  for (int c = 0; c < c_pad; ++c) {
    const float cnt = counts[c];
    const bool is_accel = accel_class[c] != 0;
    const int shift = ((shifts[c] % n_pad) + n_pad) % n_pad;
    const float* cost_row = cost + (size_t)c * n_pad;
    if (t < r_pad) dem[t] = demand[(size_t)c * r_pad + t];
    if (t == 0) used = 0ull;
    for (int b = 0; b < kBuckets; ++b) part[b * kRow + pad_idx(t)] = 0.0f;
    __syncthreads();
    bool any_demand = false, all_demand = true;
    for (int r = 0; r < r_pad; ++r) {
      any_demand |= dem[r] > 0.0f;
      all_demand &= dem[r] > 0.0f;
    }
    // min over r of (demanded ? av/d : BIG), as the plain version has it.
    const float ratio_init = all_demand ? CUDART_INF_F : kBig;

    // Phase 1a: cap and bucket of every position the warp owns, with
    // lane-interleaved (coalesced) reads of av, total and cost.  Only the
    // demanded resources are read (all of them for a class that demands
    // none); the branch is uniform across the block.
    for (int p = wbase + lane; p < wend; p += 32) {
      int n = shift + p;
      if (n >= n_pad) n -= n_pad;
      float ratio_min = ratio_init;
      float s_dem = -CUDART_INF_F, s_all = -CUDART_INF_F;
      for (int r = 0; r < r_pad; ++r) {
        const float d = dem[r];
        if (d > 0.0f) {
          const float a = __ldcg(av + (size_t)r * n_pad + n);
          const float tt = total[(size_t)r * n_pad + n];
          ratio_min = fminf(ratio_min, a / fmaxf(d, kEps));
          s_dem = fmaxf(s_dem,
                        tt > 0.0f ? (tt - a) / fmaxf(tt, kEps) : 0.0f);
        } else if (!any_demand) {
          const float a = __ldcg(av + (size_t)r * n_pad + n);
          const float tt = total[(size_t)r * n_pad + n];
          s_all = fmaxf(s_all,
                        tt > 0.0f ? (tt - a) / fmaxf(tt, kEps) : 0.0f);
        }
      }
      float cap = floorf(ratio_min + kEps);
      cap = fminf(fmaxf(cap, 0.0f), cnt);
      float score = any_demand ? s_dem : s_all;
      if (invert) score = 1.0f - score;
      float lvl = floorf((score - thr) * scale) + 1.0f;
      lvl = fminf(fmaxf(lvl, 1.0f), (float)kUtilLevels);
      const float b_util = score < thr ? 0.0f : lvl;
      const float cost_b = floorf(cost_row[n] * scale + 0.5f);
      float bf = b_util + (float)kCostBuckets + cost_b;
      bf = fminf(fmaxf(bf, 0.0f), (float)(kCostBuckets + kUtilLevels));
      const uint8_t f = __ldcg(flags + n);
      if ((f & kAccelNode) && !is_accel)
        bf = (float)(kCostBuckets + kUtilLevels + 1);
      if (f & kEmpty) bf = (float)(kBuckets - 1);
      cap_buf[p] = cap;
      bucket_buf[p] = (int)bf;
    }
    __syncwarp();
    // Phase 1b: per-thread per-bucket sums over its contiguous run.
    unsigned long long mine = 0ull;
    for (int j = j0; j < j1; ++j) {
      const int b = bucket_buf[j];
      part[b * kRow + pad_idx(t)] += cap_buf[j];
      mine |= 1ull << b;
    }
    if (mine) atomicOr(&used, mine);
    __syncthreads();

    // Phase 2: exclusive scan of each used bucket's partials across
    // threads (an unused bucket's row stays zero and its total is zero);
    // warp w scans the used buckets w, w + 32, ...  Each lane takes 32
    // consecutive threads' entries, then the lanes scan their sums with
    // shuffles.
    const unsigned long long used_now = used;
    if (t < kBuckets && !((used_now >> t) & 1ull)) btot[t] = 0.0f;
    const int n_used = __popcll(used_now);
    for (int k = warp; k < n_used; k += kWarps) {
      unsigned long long m = used_now;
      for (int i = 0; i < k; ++i) m &= m - 1;   // drop the k lowest bits
      const int b = __ffsll((long long)m) - 1;
      float* row = part + b * kRow;
      float s = 0.0f;
      for (int i = 0; i < kPer; ++i) s += row[pad_idx(lane * kPer + i)];
      float incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float run = incl - s;
      for (int i = 0; i < kPer; ++i) {
        const int k = pad_idx(lane * kPer + i);
        const float v = row[k];
        row[k] = run;
        run += v;
      }
      const float btotal = __shfl_sync(0xffffffffu, incl, 31);
      if (lane == 0) btot[b] = btotal;
    }
    // Every block's bucket totals, read through distributed shared
    // memory: the global bucket totals, and this block's offset within
    // each bucket (the totals of the blocks before it).
    cluster.sync();
    if (t < kBuckets) {
      float before = 0.0f, all = 0.0f;
      for (int k = 0; k < kCluster; ++k) {
        const float v = cluster.map_shared_rank(btot, k)[t];
        if (k < rank) before += v;
        all += v;
      }
      base[t] = before;
      part_tot[t] = all;
    }
    __syncthreads();
    if (t == 0) {
      float run = 0.0f;
      for (int b = 0; b < kBuckets; ++b) {
        base[b] = run + base[b];
        run += part_tot[b];
      }
    }
    __syncthreads();

    // Phase 3a: each thread walks its run again in order; its own
    // column of the partials is its running offset per bucket.  The take
    // replaces the cap in the scratch row.
    for (int j = j0; j < j1; ++j) {
      const float cap = cap_buf[j];
      float* off = part + bucket_buf[j] * kRow + pad_idx(t);
      const float prefix = base[bucket_buf[j]] + *off;
      *off += cap;
      cap_buf[j] = fminf(fmaxf(cnt - prefix, 0.0f), cap);
    }
    __syncwarp();
    // Phase 3b: coalesced writes of allocs and the availability update.
    for (int p = wbase + lane; p < wend; p += 32) {
      int n = shift + p;
      if (n >= n_pad) n -= n_pad;
      const float take = cap_buf[p];
      allocs[(size_t)c * n_pad + n] = take;
      // av - 0 * d == av: nodes that take nothing, and resources the
      // class does not demand, are left as they are.
      if (take != 0.0f) {
        for (int r = 0; r < r_pad; ++r)
          if (dem[r] != 0.0f) {
            float* a = av + (size_t)r * n_pad + n;
            *a = __ldcg(a) - take * dem[r];
          }
      }
    }
    // The next class reads availability other blocks wrote.
    cluster.sync();
  }
}

}  // namespace

extern "C" int class_fill_launch(const void* av0, const void* total,
                                 const void* demand, const void* counts,
                                 const void* accel_class,
                                 const void* accel_node, const void* shifts,
                                 const void* cost, const void* scalars,
                                 void* av_out, void* allocs, void* cap_buf,
                                 void* bucket_buf, void* flags,
                                 int c_pad, int n_pad,
                                 int r_pad, void* stream) {
  if (r_pad > 64) return (int)cudaErrorInvalidValue;
  const int smem = kBuckets * kRow * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      class_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  class_fill_kernel<<<kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)av0, (const float*)total, (const float*)demand,
      (const float*)counts, (const uint8_t*)accel_class,
      (const uint8_t*)accel_node, (const int*)shifts, (const float*)cost,
      (const float*)scalars, (float*)av_out, (float*)allocs,
      (float*)cap_buf, (int*)bucket_buf, (uint8_t*)flags, c_pad, n_pad,
      r_pad);
  return (int)cudaGetLastError();
}
