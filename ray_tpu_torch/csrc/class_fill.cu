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
// What bounds it: class c+1 reads the availability class c left, so the
// call is a chain of C dependent class steps, each a scan over all nodes.
// Its bytes (cost and allocs, C x N each, and av and total once) take
// about 6.5 us at the bench shape; the chain's latency is what costs.
//
// Design: ONE persistent thread-block cluster (8 blocks of 1024 threads,
// one per SM) walks the classes in order, with ONE cluster barrier per
// class.
//
//   * Fixed node ownership.  Block k owns node ids [k N/8, (k+1) N/8) in
//     id order for the whole call; its rows of availability and total
//     (R_pad x 1,264 float32 each at the bench shape) sit in its shared
//     memory from the first class to the last (on the shared route,
//     below), and availability goes back to device memory once, at the
//     end.  So no class step touches device
//     memory except to read its cost row (prefetched into registers
//     during the previous class's barrier) and write its allocs row.
//   * Analytic rotation.  For shift s, the rotated order is the nodes
//     [s, N) in id order, then [0, s).  Each block splits its range into
//     segment 1 (ids >= s) and segment 0 (ids < s), one of them empty
//     unless the block holds s, so the rotated order is every block's
//     segment 1 in block order, then every block's segment 0 in block
//     order.  A node's prefix within its bucket b is then
//       sum of segment-1 totals of b over blocks < k              (seg 1)
//       all segment-1 totals of b + segment-0 totals over blocks < k (seg 0)
//     plus its prefix inside its own block and segment, plus the total of
//     the buckets before b.  Every term is a sum of non-negative values
//     in some order, with no subtraction.
//   * One exchange per class.  Inside a block, a warp takes 32 nodes a
//     round, 1-4 rounds of consecutive ids: a lane's prefix among the
//     lower lanes of the same (segment, bucket) comes from __match_any
//     and one ballot per bit of the largest cap in the warp (exact integer
//     sums), and a per-warp running total of each of the 70 (segment,
//     bucket) keys carries it across rounds.  280 threads scan the 32
//     warps' totals (4 a key, 8 warps each, then a 4-lane shuffle scan)
//     and store the block's 70 totals into every block's shared memory
//     (distributed shared memory); one cluster.sync() follows.  The
//     slots alternate by class parity, so the next class's stores never
//     meet this class's reads and no second barrier is needed.  After the
//     barrier one warp turns the 8 x 70 totals into this block's 70
//     offsets (a warp scan over the buckets).
//   * Resource loops.  The solvers pad up to 8 resources to R_pad = 8,
//     and an instance for R_pad = 8 fixes the loops over resources at
//     compile time, so that they unroll; another takes any R_pad.
//   * Two routes for the rows.  While a block's 2 x R_pad x ceil(N_pad / 8)
//     floats of availability and totals (and the class's demand row)
//     fit kSmemBudget bytes of shared memory, they live there, as above
//     ("shared").  Past it ("global": a wide R_pad, such as a view that
//     placement-group bundles have widened by hundreds of formatted
//     resource columns, at many nodes) the kernel water-fills in place
//     in av_out, which it first fills from av0, reads totals and demand
//     from device memory, and keeps only the per-node flags in shared
//     memory.  Each node is read and written by one thread only, so the
//     route needs no more synchronisation than the shared one; a class
//     step touches only the rows its class demands (all rows when it
//     demands none), which stay in L2 from step to step.  The arithmetic
//     is the same in both routes.
//
// Bit-equality with the plain PyTorch version: every cap is an integer
// (float32), and while a class's caps sum below 2^24 every partial sum
// here and in the plain version is an exact integer, so the order of
// summation changes nothing (a sum of non-negative integers that reaches
// 2^24 stays >= 2^24 >= cnt in any order, and takes nothing either way).
// Built without FMA contraction (-fmad=false) and without fast math, so
// cap, score and bucket round as in PyTorch.
//
// Limits: ceil(N_pad / 8) <= 4096 nodes a block (N_pad up to 32,768);
// any R_pad.  The wrapper raises beyond them.
//
// Plain C entry point, bound with ctypes; returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Blocks of the thread-block cluster (8, the portable maximum), threads
// per block and node rounds a warp may take.
constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 4;
constexpr int kUtilLevels = 16;
constexpr int kCostBuckets = 16;
constexpr int kBuckets = kCostBuckets + kUtilLevels + 3;   // 35
constexpr int kKeys = 2 * kBuckets;        // (segment, bucket)
// Threads of the scan over warps: 4 a key, in whole warps.
constexpr int kScanThreads = (4 * kKeys + 31) / 32 * 32;
static_assert(kWarps % 4 == 0 && 2 * 4 == kCluster && kScanThreads <= kThreads,
              "4 threads a key scan 8 warps each and store to 2 blocks each");
// Dynamic shared memory a block may use for its nodes (the static arrays
// below take about 14 KB of the 227 KB).
constexpr int kSmemBudget = 212 * 1024;
constexpr float kEps = 1e-6f;
constexpr float kBig = 1e9f;
// Static per-node flags, computed once per call.
constexpr uint8_t kAccelNode = 1;
constexpr uint8_t kEmpty = 2;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int nodes_per_block(int n_pad) {
  return (n_pad + kCluster - 1) / kCluster;
}

__host__ __device__ __forceinline__ long long flag_bytes(int n_pad) {
  return (nodes_per_block(n_pad) + 15) & ~15;
}

// Dynamic shared memory of a block on the shared route: availability and
// totals of its nodes, the demand rows of two classes, the node flags.
__host__ __device__ __forceinline__ long long shared_route_bytes(int n_pad,
                                                                 int r_pad) {
  const long long nk = nodes_per_block(n_pad);
  return (2 * (long long)r_pad * nk + 2 * (long long)r_pad) *
             (long long)sizeof(float) + flag_bytes(n_pad);
}

// RP > 0: R_pad fixed at compile time, so the loops over resources
// unroll; the solvers pad up to 8 resources to R_pad = 8, which takes that
// instance.  RP = 0: any R_pad.  GLOBAL: the global route (header).
template <int RP, bool GLOBAL>
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
                  float* __restrict__ av_out,          // [R, N]
                  float* __restrict__ allocs,          // [C, N]
                  int c_pad, int n_pad, int r_pad_arg) {
  const int r_pad = RP > 0 ? RP : r_pad_arg;
  extern __shared__ float dyn[];
  // Per warp: running totals of each key over its rounds, then (after
  // the block scan) the warp's offset within the block.
  __shared__ float wtab[kWarps][kKeys];
  // Every block's 70 key totals, written by that block, by class parity.
  __shared__ float slots[2][kCluster][kKeys];
  __shared__ float goff[kKeys];        // this block's offset of each key
  __shared__ float cnt_s[2];           // class parameters, by parity
  __shared__ int accel_s[2];
  __shared__ int shift_s[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nk_max = nodes_per_block(n_pad);
  const int n0 = (int)((long long)rank * n_pad / kCluster);
  const int nk = (int)((long long)(rank + 1) * n_pad / kCluster) - n0;
  const int rounds = (nk_max + kThreads - 1) / kThreads;
  // Row r of node i (a local index) is av_w[r * rs + i] and
  // tot_r[r * rs + i]: in shared memory, or in place in av_out and total.
  const size_t shared_rows = GLOBAL ? 0 : (size_t)r_pad * nk_max;
  float* av_w = GLOBAL ? av_out + n0 : dyn;
  const float* tot_r = GLOBAL ? total + n0 : dyn + shared_rows;
  const size_t rs = GLOBAL ? (size_t)n_pad : (size_t)nk_max;
  float* dem_s = dyn + 2 * shared_rows;               // [2][r_pad], shared
  uint8_t* flag_s = reinterpret_cast<uint8_t*>(
      dem_s + (GLOBAL ? 0 : 2 * r_pad));

  for (int i = t; i < nk; i += kThreads) {
    float tot_max = -CUDART_INF_F;
    for (int r = 0; r < r_pad; ++r) {
      const size_t g = (size_t)r * n_pad + n0 + i;
      const float tt = total[g];
      av_w[r * rs + i] = av0[g];
      if (!GLOBAL) dyn[shared_rows + r * rs + i] = tt;
      tot_max = fmaxf(tot_max, tt);
    }
    flag_s[i] = (accel_node[n0 + i] ? kAccelNode : 0) |
                (tot_max <= 0.0f ? kEmpty : 0);
  }
  const float thr = scalars[0];
  const bool invert = scalars[1] > 0.0f;
  const float scale = (float)kUtilLevels / fmaxf(1.0f - thr, kEps);

  // Node of round j of this lane: local index (warp * rounds + j) * 32 +
  // lane, so a warp's rounds cover consecutive ids.
  float cst[kMaxRounds];   // the class's cost of each node
#pragma unroll
  for (int j = 0; j < kMaxRounds; ++j) {
    const int i = (warp * rounds + j) * 32 + lane;
    cst[j] = (j < rounds && i < nk && c_pad > 0) ? cost[n0 + i] : 0.0f;
  }
  if (c_pad > 0) {
    if (!GLOBAL && t < r_pad) dem_s[t] = demand[t];
    if (t == kThreads - 1) {
      cnt_s[0] = counts[0];
      accel_s[0] = accel_class[0];
      shift_s[0] = ((shifts[0] % n_pad) + n_pad) % n_pad;
    }
  }
  // Every block of the cluster is running before the first exchange (the
  // barrier also orders this block's writes above).
  cluster.sync();

  for (int c = 0; c < c_pad; ++c) {
    const int par = c & 1;
    const bool more = c + 1 < c_pad;
    // The next class's parameters, on their way during this class.
    float d_next = 0.0f, cnt_next = 0.0f;
    int accel_next = 0, shift_next = 0;
    if (!GLOBAL && more && t < r_pad)
      d_next = demand[(size_t)(c + 1) * r_pad + t];
    if (more && t == kThreads - 1) {
      cnt_next = counts[c + 1];
      accel_next = accel_class[c + 1];
      shift_next = shifts[c + 1];
    }
    const float cnt = cnt_s[par];
    const bool is_accel = accel_s[par] != 0;
    const int shift = shift_s[par];
    const float* dem =
        GLOBAL ? demand + (size_t)c * r_pad : dem_s + par * r_pad;
    bool any_demand = false, all_demand = true;
    for (int r = 0; r < r_pad; ++r) {
      any_demand |= dem[r] > 0.0f;
      all_demand &= dem[r] > 0.0f;
    }
    // min over r of (demanded ? av/d : BIG), as the plain version has it.
    const float ratio_init = all_demand ? CUDART_INF_F : kBig;

    __syncwarp();
    for (int k = lane; k < kKeys; k += 32) wtab[warp][k] = 0.0f;
    __syncwarp();

    // Cap and key of each node, and its prefix within the warp.
    float capv[kMaxRounds], pw[kMaxRounds];
    int keyv[kMaxRounds];
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {
      capv[j] = 0.0f;
      pw[j] = 0.0f;
      keyv[j] = 0;
      if (j >= rounds) continue;   // uniform across the block
      const int i = (warp * rounds + j) * 32 + lane;
      const bool valid = i < nk;
      float cap = 0.0f;
      int key = kKeys + lane;      // a key no other lane has
      if (valid) {
        float ratio_min = ratio_init;
        float s_dem = -CUDART_INF_F, s_all = -CUDART_INF_F;
        for (int r = 0; r < r_pad; ++r) {
          const float d = dem[r];
          if (d > 0.0f) {
            const float a = av_w[r * rs + i];
            const float tt = tot_r[r * rs + i];
            ratio_min = fminf(ratio_min, a / fmaxf(d, kEps));
            s_dem = fmaxf(s_dem,
                          tt > 0.0f ? (tt - a) / fmaxf(tt, kEps) : 0.0f);
          } else if (!any_demand) {
            const float a = av_w[r * rs + i];
            const float tt = tot_r[r * rs + i];
            s_all = fmaxf(s_all,
                          tt > 0.0f ? (tt - a) / fmaxf(tt, kEps) : 0.0f);
          }
        }
        cap = floorf(ratio_min + kEps);
        cap = fminf(fmaxf(cap, 0.0f), cnt);
        float score = any_demand ? s_dem : s_all;
        if (invert) score = 1.0f - score;
        float lvl = floorf((score - thr) * scale) + 1.0f;
        lvl = fminf(fmaxf(lvl, 1.0f), (float)kUtilLevels);
        const float b_util = score < thr ? 0.0f : lvl;
        const float cost_b = floorf(cst[j] * scale + 0.5f);
        float bf = b_util + (float)kCostBuckets + cost_b;
        bf = fminf(fmaxf(bf, 0.0f), (float)(kCostBuckets + kUtilLevels));
        const uint8_t f = flag_s[i];
        if ((f & kAccelNode) && !is_accel)
          bf = (float)(kCostBuckets + kUtilLevels + 1);
        if (f & kEmpty) bf = (float)(kBuckets - 1);
        key = (n0 + i >= shift ? kBuckets : 0) + (int)bf;
      }
      // Sum of the caps of the lower lanes with the same key, bit by bit
      // of the integer caps (exact; a cap is at most cnt, taken below
      // 2^24 here so that 31 of them fit in 32 bits).
      const unsigned peers = __match_any_sync(kFull, key);
      const unsigned lower_mask = peers & ((1u << lane) - 1u);
      const unsigned ci = (unsigned)fminf(cap, 16777216.0f);
      const unsigned mx = __reduce_max_sync(kFull, ci);
      unsigned lower = 0;
      for (int bit = 0; (mx >> bit) != 0u; ++bit)
        lower += (unsigned)__popc(__ballot_sync(kFull, (ci >> bit) & 1u) &
                                  lower_mask) << bit;
      const float before = valid ? wtab[warp][key] : 0.0f;
      __syncwarp();
      // The highest lane of each key carries the key's running total.
      if (valid && (peers >> lane) == 1u)
        wtab[warp][key] = before + (float)(lower + ci);
      __syncwarp();
      capv[j] = cap;
      keyv[j] = key;
      pw[j] = before + (float)lower;
    }
    __syncthreads();

    // The block's scan over warps: four neighbouring threads a key, each
    // over 8 warps, and a scan of their 4 sums by shuffles (whole warps
    // take part; threads past the last key carry zeros).  The block's
    // totals go into every block's slot for this parity, two blocks a
    // thread.
    if (t < kScanThreads) {
      const int key = t >> 2, part = t & 3;
      const bool live = key < kKeys;
      float v[kWarps / 4];
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps / 4; ++w) {
        v[w] = live ? wtab[part * (kWarps / 4) + w][key] : 0.0f;
        sum += v[w];
      }
      float incl = sum;
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float u = __shfl_up_sync(kFull, incl, o, 4);
        if (part >= o) incl += u;
      }
      const float before = __shfl_up_sync(kFull, incl, 1, 4);
      const float total = __shfl_sync(kFull, incl, 3, 4);
      if (live) {
        float run = part == 0 ? 0.0f : before;
#pragma unroll
        for (int w = 0; w < kWarps / 4; ++w) {
          wtab[part * (kWarps / 4) + w][key] = run;
          run += v[w];
        }
        for (int k = 2 * part; k < 2 * part + 2; ++k)
          cluster.map_shared_rank(&slots[par][rank][0], k)[key] = total;
      }
    }
    if (more) {
      if (!GLOBAL && t < r_pad) dem_s[(par ^ 1) * r_pad + t] = d_next;
      if (t == kThreads - 1) {
        cnt_s[par ^ 1] = cnt_next;
        accel_s[par ^ 1] = accel_next;
        shift_s[par ^ 1] = ((shift_next % n_pad) + n_pad) % n_pad;
      }
#pragma unroll
      for (int j = 0; j < kMaxRounds; ++j) {
        const int i = (warp * rounds + j) * 32 + lane;
        if (j < rounds && i < nk)
          cst[j] = cost[(size_t)(c + 1) * n_pad + n0 + i];
      }
    }
    cluster.sync();   // the class's one cluster barrier

    // Offsets of this block's keys: lane b takes buckets b and b + 32.
    if (warp == 0) {
      float carry = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = lane + 32 * hh;
        float t0 = 0.0f, t1 = 0.0f, p0 = 0.0f, p1 = 0.0f;
        if (b < kBuckets) {
          for (int k = 0; k < kCluster; ++k) {
            const float v0 = slots[par][k][b];
            const float v1 = slots[par][k][kBuckets + b];
            if (k < rank) {
              p0 += v0;
              p1 += v1;
            }
            t0 += v0;
            t1 += v1;
          }
        }
        // Exclusive scan of the bucket totals, as sums (no subtraction).
        float incl = t0 + t1;
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const float up = __shfl_up_sync(kFull, incl, 1);
        const float excl = lane == 0 ? carry : carry + up;
        if (b < kBuckets) {
          goff[kBuckets + b] = excl + p1;
          goff[b] = excl + t1 + p0;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
    }
    __syncthreads();

    // Take, allocs row, availability update (av - 0 * d == av: nodes that
    // take nothing and resources the class does not demand stay as they
    // are).
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {
      const int i = (warp * rounds + j) * 32 + lane;
      if (j >= rounds || i >= nk) continue;
      const int key = keyv[j];
      const float prefix = goff[key] + wtab[warp][key] + pw[j];
      const float take = fminf(fmaxf(cnt - prefix, 0.0f), capv[j]);
      allocs[(size_t)c * n_pad + n0 + i] = take;
      if (take != 0.0f) {
        for (int r = 0; r < r_pad; ++r)
          if (dem[r] != 0.0f)
            av_w[r * rs + i] = av_w[r * rs + i] - take * dem[r];
      }
    }
  }

  if (GLOBAL) return;   // av_out already holds the result
  __syncthreads();
  for (int i = t; i < nk; i += kThreads)
    for (int r = 0; r < r_pad; ++r)
      av_out[(size_t)r * n_pad + n0 + i] = av_w[r * rs + i];
}

// One cluster of the fill kernel's shape that only crosses `iters`
// cluster barriers: the latency of one class step's barrier, read by
// tools/profile_class_fill.py.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
barrier_probe_kernel(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
}

}  // namespace

extern "C" int class_fill_barrier_probe(int iters, void* stream) {
  barrier_probe_kernel<<<kCluster, kThreads, 0, (cudaStream_t)stream>>>(
      iters);
  return (int)cudaGetLastError();
}

extern "C" int class_fill_launch(const void* av0, const void* total,
                                 const void* demand, const void* counts,
                                 const void* accel_class,
                                 const void* accel_node, const void* shifts,
                                 const void* cost, const void* scalars,
                                 void* av_out, void* allocs, int c_pad,
                                 int n_pad, int r_pad, int global_route,
                                 void* stream) {
  if (r_pad < 1 || n_pad < 1 || c_pad < 0 ||
      nodes_per_block(n_pad) > kMaxRounds * kThreads ||
      (!global_route && (r_pad > kThreads ||
                         shared_route_bytes(n_pad, r_pad) > kSmemBudget)))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(global_route ? flag_bytes(n_pad)
                                      : shared_route_bytes(n_pad, r_pad));
  auto kernel = global_route ? class_fill_kernel<0, true>
                : r_pad == 8 ? class_fill_kernel<8, false>
                             : class_fill_kernel<0, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)av0, (const float*)total, (const float*)demand,
      (const float*)counts, (const uint8_t*)accel_class,
      (const uint8_t*)accel_node, (const int*)shifts, (const float*)cost,
      (const float*)scalars, (float*)av_out, (float*)allocs, c_pad, n_pad,
      r_pad);
  return (int)cudaGetLastError();
}
