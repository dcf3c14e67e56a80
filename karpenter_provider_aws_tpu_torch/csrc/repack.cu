// The consolidation repack screen, for Hopper (sm_90a).
//
// Replaces the TPU kernel karpenter_provider_aws_tpu/ops/repack_pallas.py::_kernel
// and computes what ops/consolidate.py::repack_check (the plain version)
// computes: for each candidate node i, with a private copy of free[N, R],
// for each slot s of i's slot table (group g, count cnt),
//   k[n]  = min over r with req[g, r] > 0 of floor((free[n, r] + 1e-4) / req[g, r]),
//           clamped to [0, 2^30], then min(k, cap[g, n]), then 0 at n = i;
//   place = clip(cnt - exclusive_prefix_sum(k), 0, k)   (first fit, index order);
//   free -= place * req[g];
//   leftover += cnt - sum(place);
// and ok[i] = (leftover == 0). A slot with cnt <= 0 places nothing and adds
// cnt to leftover.
//
// The observations the design rests on:
// - A candidate's private free differs from the base free only at rows its
//   own earlier slots filled, never at its own row. So the fit k_g[n] over
//   the base free, and its sum over the nodes, are the same for every
//   candidate, and are computed once per screen.
// - A slot's first fit is fixed by two numbers: its stop row, where the
//   running total of the fit first reaches its count, and the remainder it
//   places there. Every row before the stop row takes its whole fit, no row
//   after it takes a pod. So a row's free after any of the candidate's
//   slots is replayed from the base free and those pairs, in slot order,
//   with the plain version's subtractions, and nothing else is kept.
//
// Three launches on one stream:
//  A. repack_table_kernel, one block of 1,024 threads per group and tile of
//     1,024 nodes: k_g[n] for each node (one a thread, the plain version's
//     arithmetic in its order) to a [G, N] int32 table in device memory (20
//     KB at config4: it stays in L2), and the tile's sum of k and count of
//     rows with room. Then repack_carry_kernel, a second short pass over the
//     same tiles, lists each group's rows with room (k_g[n] > 0) in index
//     order, with their k, and writes each group's total fit. The table
//     costs G * N whatever C is, also for a screen of few candidates.
//  B. repack_verdict_kernel, one warp per candidate, up to 8 a block, each
//     with its candidate's slot table in shared memory (96 bytes a slot:
//     group, count, request row, the room on the other nodes' base free,
//     and once placed the stop row, remainder and rows listed).
//     The warp walks the candidate's slots in order:
//     - the pods a live slot (cnt > 0) places: min(cnt, total_g - k_g[i] +
//       D), where D sums, over the rows the earlier slots may have filled
//       (each one's first listed rows up to its stop row, a row once), g's
//       fit on the row's replayed free less the table's; the earlier slots'
//       lists are taken end to end, 32 rows at a time;
//     - the last live slot stops there: no later slot reads where its pods
//       go. At config4 every candidate has one live slot, so its verdict is
//       two loads from the table;
//     - an earlier live slot that places every pod finds its stop row among
//       its group's rows with room, 32 at a time (lane j the j-th, its fit
//       replayed where an earlier slot may have filled the row, a warp scan
//       for the running total); one that places some takes every row's
//       whole fit (stop row N), one that places none nothing (stop row -1).
//       Lane 0 writes the stop row, the remainder and the count of rows
//       listed up to the stop row to the slot's entry;
//     - a replay loads the row and its cap before it reads the earlier
//       slots' table entries, and the requests come from the slot table,
//       so each earlier slot costs one round trip to L2, not three;
//     - once pods are left over and no later slot has a negative count to
//       cancel them, the verdict is no, and the warp stops.
//     Nothing bounds the rows a candidate may fill: a replay costs the
//     candidate's earlier live slots, D the rows they may have filled. A
//     list of the rows a candidate filled, kept in shared memory, would
//     need a cap, and a candidate past it another path.
//
// Sound because requests and caps are not negative: a filled row then
// never has more room than the table gives it, so a slot's pods go only to
// its group's listed rows, and a row no earlier slot listed up to its stop
// row holds the base free. The table kernel traps on a negative or NaN
// request or float cap, so such input raises at the next synchronisation
// instead of giving another verdict than the plain version's.
//
// What bounds it on this card: bytes. At config4 (C = N = 5,000, G = 1, one
// live slot, R = 10) the inputs are about 0.27 MB: ~0.08 us at 3.35 TB/s.
// The operations are the table's G * N * (3 * axes + 6) and a handful a
// candidate: ~0.1 M, ~0.002 us at 67 TFLOP/s. A walk over every node for
// every candidate does C * S * N * (3 * axes + 6), 0.375 G operations.
// What the time is made of then: three launches and the dependent loads of
// each warp (its slots, the table, a filled row's replay).
//
// Rounding matches the plain version bit for bit: free carries from slot to
// slot, so every sum, quotient, product and difference is written with an
// explicit IEEE round-to-nearest intrinsic, and the build adds --fmad=false,
// so no fused multiply-add changes a later floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

namespace {

constexpr int kMaxR = 16;
constexpr float kBig = 1073741824.f;  // 2^30: uncapped
constexpr float kEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kTableThreads = 1024;  // phase A: one row a thread, 1,024 a tile
constexpr int kCountBits = 11;       // a tile's count of rows with room fits in 11 bits
constexpr int kThreads = 256;        // phase B: up to 8 warps, one candidate each
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may take

enum CapKind { kCapBool = 0, kCapU16 = 1, kCapF32 = 2 };

__device__ __forceinline__ float cap_at(const void* cap, int kind, size_t idx) {
  if (kind == kCapBool) return static_cast<const uint8_t*>(cap)[idx] ? kBig : 0.f;
  if (kind == kCapU16) return (float)static_cast<const uint16_t*>(cap)[idx];
  return static_cast<const float*>(cap)[idx];
}

__device__ __forceinline__ void load_row(float (&f)[kMaxR], const float* src, int R) {
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) f[r] = r < R ? src[r] : 0.f;
}

// The fit of one row: the plain version's arithmetic in its order.
__device__ __forceinline__ int fit(const float (&f)[kMaxR], const float* req, int R,
                                   float capv) {
  float kf = INFINITY;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
      const float q = req[r];
      if (q > 0.f) kf = fminf(kf, floorf(__fdiv_rn(__fadd_rn(f[r], kEps), q)));
    }
  }
  kf = fminf(fmaxf(kf, 0.f), kBig);
  return (int)fminf(kf, capv);
}

__device__ __noinline__ void refuse(const char* what, int row, int col, float v) {
  printf("repack: %s[%d, %d] = %f, but the kernels take values >= 0\n", what, row, col, v);
  __trap();
}

// Exclusive block-wide prefix sum of one int64 per thread over W warps;
// *total gets the block sum. warp_sums is shared scratch of W entries.
template <int W>
__device__ __forceinline__ long long block_exclusive_scan(long long v, long long* warp_sums,
                                                          long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < W ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < W) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[W - 1];
  const long long out = (warp ? warp_sums[warp - 1] : 0) + x - v;
  __syncthreads();  // warp_sums may be rewritten by the next call
  return out;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kTableThreads)
repack_table_kernel(int N, int R, int G,
                    const float* __restrict__ free0,  // [N, R] base free capacity
                    const float* __restrict__ req,    // [G, R]
                    const void* __restrict__ cap,     // [G, N]
                    int cap_kind,
                    int* __restrict__ K,              // [G, N] out: the fit
                    long long* __restrict__ tiles) {  // [G, n_tiles] out: tile sums, packed
  __shared__ float req_s[kMaxR];
  __shared__ long long warp_sums[kTableThreads / 32];
  const int g = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  if (tid < R) {
    const float q = req[(size_t)g * R + tid];
    if (!(q >= 0.f)) refuse("requests", g, tid, q);
    req_s[tid] = q;
  }
  __syncthreads();
  const int n = tile * kTableThreads + tid;
  long long k = 0;
  if (n < N) {
    const float capv = cap_at(cap, cap_kind, (size_t)g * N + n);
    if (!(capv >= 0.f)) refuse("cap", g, n, capv);
    float f[kMaxR];
    load_row(f, free0 + (size_t)n * R, R);
    k = fit(f, req_s, R, capv);
    K[(size_t)g * N + n] = (int)k;
  }
  // one sum carries the fit's sum in the high bits and the count of rows
  // with room in the low kCountBits (a tile holds 1,024 rows; k <= 2^30)
  long long total;
  block_exclusive_scan<kTableThreads / 32>((k << kCountBits) | (k > 0 ? 1 : 0), warp_sums,
                                           &total);
  if (tid == 0) tiles[(size_t)g * gridDim.y + tile] = total;
}

// The second short pass, on every tile: list the rows with room (k > 0) of
// each group in index order, with their k, after the rows with room of the
// tiles before it: the rows a slot's pods may go to. The last tile also
// writes the group's total fit.
__global__ void __launch_bounds__(kTableThreads)
repack_carry_kernel(int N, const long long* __restrict__ tiles, int n_tiles,
                    const int* __restrict__ K,
                    unsigned long long* __restrict__ targets,  // [G, N] out: k << 32 | row
                    long long* __restrict__ n_targets,         // [G] out
                    long long* __restrict__ fit_total) {       // [G] out: sum of k over n
  __shared__ long long warp_sums[kTableThreads / 32];
  const int g = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  long long ck = 0, cc = 0;
  for (int t = tid; t < tile; t += kTableThreads) {
    const long long x = tiles[(size_t)g * n_tiles + t];
    ck += x >> kCountBits;
    cc += x & ((1 << kCountBits) - 1);
  }
  long long carry_k, carry_c, in_tile;
  block_exclusive_scan<kTableThreads / 32>(ck, warp_sums, &carry_k);
  block_exclusive_scan<kTableThreads / 32>(cc, warp_sums, &carry_c);
  const int n = tile * kTableThreads + tid;
  const int k = n < N ? K[(size_t)g * N + n] : 0;
  const long long slot =
      carry_c + block_exclusive_scan<kTableThreads / 32>(k > 0 ? 1 : 0, warp_sums, &in_tile);
  if (k > 0) targets[(size_t)g * N + slot] = ((unsigned long long)k << 32) | (unsigned)n;
  if (tile == n_tiles - 1 && tid == 0) {
    n_targets[g] = carry_c + in_tile;
    fit_total[g] = carry_k + (tiles[(size_t)g * n_tiles + tile] >> kCountBits);
  }
}

struct Args {
  int C, N, R, S, G, cap_kind;
  const float* free0;   // [N, R]
  const float* req;     // [G, R]
  const int* gids;      // [N, S] group per slot
  const int* gcnt;      // [N, S] pods per slot
  const void* cap;      // [G, N] bool / uint16 / f32
  const int* cand;      // [C] node index per candidate
  const int* K;         // [G, N] phase A's fit
  const long long* fit_total;         // [G] its sum over the nodes
  const unsigned long long* targets;  // [G, N] the rows with room, k << 32 | row
  const long long* n_targets;         // [G]
  uint8_t* ok;          // [C] out
};

// One slot of a warp's candidate, in shared memory. The warp fills g, cnt,
// base and req when it starts; lane 0 writes stop, rem and npos after the
// warp has placed the slot, and the warp reads them after a __syncwarp.
struct __align__(16) Slot {
  int g;           // the group, or -1 if the slot is not live or its group is out of range
  int stop;        // the stop row: N if every row took its whole fit, -1 if none took a pod
  int rem;         // the pods placed on the stop row
  int npos;        // the group's rows with room up to the stop row
  long long base;  // total_g - k_g[i]: the room on the other nodes' base free
  int cnt;         // the count
  int pad;
  float req[kMaxR];
};
static_assert(sizeof(Slot) == 96, "ops/repack_cuda.py's MAX_SLOTS counts 96 bytes a slot");

struct Cand {
  int i;           // its node
  Slot* slot;      // [S]
  int max_stop;    // the largest stop row of the slots placed so far
};

__device__ __forceinline__ int table_k(const Args& a, int g, int n) {
  return a.K[(size_t)g * a.N + n];
}

// An earlier slot m may have filled row n: n is one of its group's rows
// with room, at or before its stop row.
__device__ __forceinline__ bool may_fill(const Args& a, const Slot& m, int n) {
  return m.g >= 0 && n <= m.stop && table_k(a, m.g, n) > 0;
}

// Group g's (slot s's) fit on row n before slot s: the row's free replayed
// through the candidate's earlier slots that may have filled it, in slot
// order, with the plain version's subtractions; the table's kg where none
// did; 0 at the candidate's own row. The row and its cap are loaded before
// the earlier slots' table entries are read.
__device__ int fit_before(const Args& a, const Cand& cd, int s, int n, int kg) {
  if (n == cd.i) return 0;
  if (n > cd.max_stop) return kg;  // no earlier slot reached it
  const int R = a.R, g = cd.slot[s].g;
  float f[kMaxR];
  load_row(f, a.free0 + (size_t)n * R, R);
  const float capg = cap_at(a.cap, a.cap_kind, (size_t)g * a.N + n);
  bool filled = false;
  for (int sp = 0; sp < s; ++sp) {
    const Slot& m = cd.slot[sp];
    if (m.g < 0 || n > m.stop) continue;
    const int kt = table_k(a, m.g, n);
    const float capv = cap_at(a.cap, a.cap_kind, (size_t)m.g * a.N + n);
    if (kt <= 0) continue;
    filled = true;
    const int k = fit(f, m.req, R, capv);
    const int p = n < m.stop ? k : m.rem;  // the whole fit before the stop row
    if (p > 0) {
      const float pf = (float)p;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R) f[r] = __fsub_rn(f[r], __fmul_rn(pf, m.req[r]));
    }
  }
  return filled ? fit(f, cd.slot[s].req, R, capg) : kg;
}

// D for slot s of group g: over the rows the slots before s may have
// filled, each once, g's fit on the replayed free less the table's. Those
// rows are each earlier slot's first listed rows, up to its stop row; the
// lists are taken end to end, 32 rows at a time, and a row an earlier slot
// listed already is skipped.
__device__ long long filled_delta(const Args& a, const Cand& cd, int s, int g) {
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int sp = 0; sp < s; ++sp) total += cd.slot[sp].npos;
  long long d = 0;
  for (int idx = lane; idx < total; idx += 32) {
    int sp = 0, pos = idx;
    while (pos >= cd.slot[sp].npos) pos -= cd.slot[sp++].npos;
    const int n = (int)(unsigned)a.targets[(size_t)cd.slot[sp].g * a.N + pos];
    if (n == cd.i) continue;
    const int kg = table_k(a, g, n);
    bool seen = false;
    for (int spp = 0; spp < sp; ++spp) seen |= may_fill(a, cd.slot[spp], n);
    if (!seen) d += fit_before(a, cd, s, n, kg) - kg;
  }
  return warp_sum(d);
}

// Slot s's stop row (group g, count cnt, all of which fit): the first of
// g's rows with room where the running total of the fit reaches cnt, with
// the remainder placed there and the rows listed up to it. Not found only
// if a request is negative, which phase A refuses; every row's whole fit
// then.
__device__ int3 place_all(const Args& a, const Cand& cd, int s, int g, int cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned long long* Tg = a.targets + (size_t)g * a.N;
  const int M = (int)a.n_targets[g];
  long long carry = 0;
  for (int q = 0; q < M; q += 32) {
    int n = -1;
    long long k = 0;
    if (q + lane < M) {
      const unsigned long long e = Tg[q + lane];
      n = (int)(unsigned)e;
      k = fit_before(a, cd, s, n, (int)(e >> 32));
    }
    long long incl = k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned reach = __ballot_sync(kFull, carry + incl >= cnt);
    if (reach) {
      const int j = __ffs(reach) - 1;
      const int stop = __shfl_sync(kFull, n, j);
      const long long before = carry + __shfl_sync(kFull, incl - k, j);
      return make_int3(stop, (int)(cnt - before), q + j + 1);
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  return make_int3(a.N, 0, M);
}

// Phase B for candidate c on one warp; slot is the warp's [S] in shared
// memory.
__device__ void verdict_warp(const Args& a, int c, Slot* slot) {
  const int lane = threadIdx.x & 31;
  const int N = a.N, R = a.R;
  const int i = a.cand[c];
  if (i < 0 || i >= N) {  // memory guard; the wrapper's callers pass rows
    if (lane == 0) a.ok[c] = 0;
    return;
  }
  int last = -1, last_neg = -1;  // the last live slot, the last negative count
  for (int s = lane; s < a.S; s += 32) {  // a lane a slot
    const int cnt = a.gcnt[(size_t)i * a.S + s];
    int g = a.gids[(size_t)i * a.S + s];
    g = cnt > 0 && g >= 0 && g < a.G ? g : -1;
    Slot& m = slot[s];
    m.g = g;
    m.stop = -1;
    m.rem = m.npos = 0;
    m.cnt = cnt;
    if (g >= 0) {
      m.base = a.fit_total[g] - table_k(a, g, i);
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) m.req[r] = r < R ? a.req[(size_t)g * R + r] : 0.f;
    }
    if (cnt > 0) last = s;
    if (cnt < 0) last_neg = s;
  }
  last = __reduce_max_sync(kFull, last);
  last_neg = __reduce_max_sync(kFull, last_neg);
  __syncwarp();  // the slots before any lane reads them
  Cand cd{i, slot, -1};
  long long leftover = 0;  // uniform over the warp
  for (int s = 0; s < a.S; ++s) {
    if (leftover > 0 && s > last_neg) break;  // nothing left to cancel it
    const int cnt = slot[s].cnt, g = slot[s].g;
    if (g < 0) {  // places nothing (as the plain version)
      leftover += cnt;
      continue;
    }
    const long long placed = min((long long)cnt, slot[s].base + filled_delta(a, cd, s, g));
    leftover += cnt - placed;
    if (s == last) continue;  // no later slot reads where these pods go
    // all placed: find the stop row; some: every row's whole fit; none: no row
    const int3 e = placed == cnt ? place_all(a, cd, s, g, cnt)
                                 : placed > 0 ? make_int3(N, 0, (int)a.n_targets[g])
                                              : make_int3(-1, 0, 0);
    if (lane == 0) {
      slot[s].stop = e.x;
      slot[s].rem = e.y;
      slot[s].npos = e.z;
    }
    cd.max_stop = max(cd.max_stop, e.x);
    __syncwarp();  // the entry before any lane reads it
  }
  if (lane == 0) a.ok[c] = leftover == 0 ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
repack_verdict_kernel(Args a) {
  extern __shared__ Slot slots[];  // [warps, S]
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * warps + warp;
  if (c < a.C) verdict_warp(a, c, slots + (size_t)warp * a.S);
}

}  // namespace

extern "C" {

// Launches the screen of C candidates on ``stream``: the table (phase A,
// and its carry pass), then the verdicts (phase B), one warp per
// candidate, as many warps a block (up to 8) as shared memory holds their
// slot tables. ``work`` holds, in int64 words: the tiles' sums (G *
// n_tiles), the rows with room (G * N), their count (G), the groups' total
// fit (G), then the fit, G * N int32. Returns the first cudaGetLastError()
// that is not success (or cudaErrorInvalidValue for shapes the kernels do
// not take).
int repack_launch(int C, int N, int R, int S, int G,
                  const void* free0, const void* req, const void* gids,
                  const void* gcnt, const void* cap, int cap_kind,
                  const void* cand, void* ok, void* work, void* stream) {
  const int n_tiles = (N + kTableThreads - 1) / kTableThreads;
  const size_t slot_bytes = (size_t)S * sizeof(Slot);
  if (R < 1 || R > kMaxR || N < 1 || C < 1 || S < 0 || G < 0 || n_tiles > 65535 ||
      slot_bytes > kSmemLimit || cap_kind < kCapBool || cap_kind > kCapF32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* tiles = static_cast<long long*>(work);
  unsigned long long* targets = reinterpret_cast<unsigned long long*>(tiles + (size_t)G * n_tiles);
  long long* n_targets = reinterpret_cast<long long*>(targets + (size_t)G * N);
  long long* fit_total = n_targets + G;
  int* K = reinterpret_cast<int*>(fit_total + G);
  cudaError_t err;
  if (G > 0) {  // no group, no table: every live slot is refused
    repack_table_kernel<<<dim3(G, n_tiles), kTableThreads, 0, st>>>(
        N, R, G, static_cast<const float*>(free0), static_cast<const float*>(req), cap,
        cap_kind, K, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    repack_carry_kernel<<<dim3(G, n_tiles), kTableThreads, 0, st>>>(N, tiles, n_tiles, K,
                                                                   targets, n_targets, fit_total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int warps = slot_bytes ? (int)std::min<size_t>(kWarps, kSmemLimit / slot_bytes) : kWarps;
  const size_t smem = warps * slot_bytes;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(repack_verdict_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{C, N, R, S, G, cap_kind,
         static_cast<const float*>(free0), static_cast<const float*>(req),
         static_cast<const int*>(gids), static_cast<const int*>(gcnt), cap,
         static_cast<const int*>(cand), K, fit_total, targets, n_targets,
         static_cast<uint8_t*>(ok)};
  repack_verdict_kernel<<<(C + warps - 1) / warps, warps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

const char* repack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
