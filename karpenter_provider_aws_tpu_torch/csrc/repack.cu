// The consolidation repack screen, for Hopper (sm_90a).
//
// Replaces the TPU kernel karpenter_provider_aws_tpu/ops/repack_pallas.py::_kernel
// and computes what ops/consolidate.py::repack_check (the plain version)
// computes: for each candidate node i, with a private copy of free[N, R],
// for each slot s of i's slot table (group g, count cnt > 0),
//   k[n]  = min over r with req[g, r] > 0 of floor((free[n, r] + 1e-4) / req[g, r]),
//           clamped to [0, 2^30], then min(k, cap[g, n]), then 0 at n = i;
//   place = clip(cnt - exclusive_prefix_sum(k), 0, k)   (first fit, index order);
//   free -= place * req[g];
//   leftover += cnt - sum(place);
// and ok[i] = (leftover == 0). Zero-count slots are no-ops wherever they
// sit, so the loop skips them: that is the reference's live-slot bound.
//
// What the TPU design had that this one drops: the 256-wide candidate bands
// (they existed for the TPU's scalar memory), the host-side gather of the cap
// rows into slot order and the one-hot request select (Mosaic cannot index
// sublanes at run time), and the roll-based prefix sum (Mosaic has no
// cumsum). This kernel reads req[g, :], cap[g, n] and group_ids[i, s]
// directly and scans with warp shuffles.
//
// What bounds it on this card: operations, not bytes. At the 5,000-node
// config4 cluster (C = N = 5,000, one live slot, R = 10) the inputs are
// about 0.29 MB, read once: ~0.09 us at 3.35 TB/s. The pods there request
// 3 of the R resources, and the fit skips the others, so the fit, the scan
// and the placement are about C * S * N * (3 * 3 + 6) = 0.375 G f32
// operations: ~5.6 us at 67 TFLOP/s. Each candidate also copies the 200 KB base free matrix from
// L2 into shared memory (1 GB of on-chip traffic over the sweep), and with
// 200 KB of shared memory a block, one block fits on an SM: 5,000
// candidates run as 38 waves of 132.
// What the design does about it: ONE launch covers every candidate (a
// grid-stride loop over C, one block per candidate at a time), and each
// block keeps the candidate's private free matrix in shared memory, so the
// slot loop never touches device memory. A block of 1,024 threads gives each
// thread a contiguous run of at most 8 nodes per tile of 8,192, keeps their
// k in registers, and runs one block-wide int64 scan per tile. Where N * R * 4
// bytes do not fit in shared memory (N above ~5,800 at R = 10), the wrapper
// passes a global scratch of [gridDim.x, N, R] floats and the same code runs
// on it. Later work: skip the private copy for a single-slot candidate,
// several candidates per block when N is small, TMA loads of the base free.
//
// Rounding matches the plain version bit for bit: free carries from slot to
// slot, so every sum, quotient, product and difference is written with an
// explicit IEEE round-to-nearest intrinsic, and the build adds --fmad=false,
// so no fused multiply-add changes a later floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;  // nodes per thread per tile
constexpr int kMaxR = 16;
constexpr float kBig = 1073741824.f;  // 2^30: uncapped
constexpr float kEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may use on this card, and the part of it the
// static scratch below may take (repack_cuda.py's budget uses both)
constexpr size_t kSmemLimit = 232448;
constexpr size_t kStaticReserve = 512;
static_assert(kMaxR * sizeof(float) + kWarps * sizeof(long long) <= kStaticReserve,
              "static shared scratch outgrew its reserve");

enum CapKind { kCapBool = 0, kCapU16 = 1, kCapF32 = 2 };

__device__ __forceinline__ float cap_at(const void* cap, int kind, size_t idx) {
  if (kind == kCapBool) return static_cast<const uint8_t*>(cap)[idx] ? kBig : 0.f;
  if (kind == kCapU16) return (float)static_cast<const uint16_t*>(cap)[idx];
  return static_cast<const float*>(cap)[idx];
}

// Exclusive block-wide prefix sum of one int64 per thread; *total gets the
// block sum. warp_sums is shared scratch of kWarps entries.
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* warp_sums,
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
    long long w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  const long long out = (warp ? warp_sums[warp - 1] : 0) + x - v;
  __syncthreads();  // warp_sums may be rewritten by the next call
  return out;
}

__global__ void __launch_bounds__(kThreads)
repack_kernel(int C, int N, int R, int S, int G,
              const float* __restrict__ free0,    // [N, R] base free capacity
              const float* __restrict__ req,      // [G, R]
              const int* __restrict__ gids,       // [N, S] group per slot
              const int* __restrict__ gcnt,       // [N, S] pods per slot
              const void* __restrict__ cap,       // [G, N] bool / uint16 / f32
              int cap_kind,
              const int* __restrict__ cand,       // [C] node index per candidate
              uint8_t* __restrict__ ok,           // [C] out
              float* __restrict__ scratch) {      // [gridDim.x, N, R] or null
  extern __shared__ float smem_free[];            // [N, R] when scratch is null
  __shared__ float req_s[kMaxR];
  __shared__ long long warp_sums[kWarps];

  const int tid = threadIdx.x;
  const size_t NR = (size_t)N * R;
  float* fc = scratch ? scratch + (size_t)blockIdx.x * NR : smem_free;

  for (int c = blockIdx.x; c < C; c += gridDim.x) {
    const int i = cand[c];
    if (i < 0 || i >= N) {  // memory guard; the wrapper's callers pass rows
      if (tid == 0) ok[c] = 0;
      continue;
    }
    for (size_t j = tid; j < NR; j += kThreads) fc[j] = free0[j];
    __syncthreads();  // the private copy before any row is read
    long long leftover = 0;  // uniform: every thread tracks it
    for (int s = 0; s < S; ++s) {
      const int cnt = gcnt[(size_t)i * S + s];
      if (cnt <= 0) {  // places nothing (as the plain version)
        leftover += cnt;
        continue;
      }
      const int g = gids[(size_t)i * S + s];
      if (g < 0 || g >= G) {  // memory guard; the host rejects such tables
        leftover += cnt;
        continue;
      }
      if (tid < R) req_s[tid] = req[(size_t)g * R + tid];
      __syncthreads();  // req_s
      const size_t cap_row = (size_t)g * N;
      long long carry = 0;  // placements' prefix over earlier tiles
      for (int t0 = 0; t0 < N; t0 += kThreads * kPer) {
        const int tn = min(N - t0, kThreads * kPer);
        const int per = (tn + kThreads - 1) / kThreads;  // <= kPer
        const int lo = t0 + min(tid * per, tn), hi = t0 + min(tid * per + per, tn);
        int kr[kPer];
        long long mine = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int n = lo + j;
          int k = 0;
          if (n < hi && n != i) {
            const float* f = fc + (size_t)n * R;
            float kf = INFINITY;
            for (int r = 0; r < R; ++r) {
              const float q = req_s[r];
              if (q > 0.f) kf = fminf(kf, floorf(__fdiv_rn(__fadd_rn(f[r], kEps), q)));
            }
            kf = fminf(fmaxf(kf, 0.f), kBig);
            kf = fminf(kf, cap_at(cap, cap_kind, cap_row + n));
            k = (int)kf;
          }
          kr[j] = k;
          mine += k;
        }
        long long total;
        long long before = carry + block_exclusive_scan(mine, warp_sums, &total);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int n = lo + j;
          const long long k = kr[j];  // 0 past hi
          long long p = (long long)cnt - before;
          p = p < 0 ? 0 : (p > k ? k : p);
          before += k;
          if (p > 0) {
            const float pf = (float)p;
            float* f = fc + (size_t)n * R;
            for (int r = 0; r < R; ++r) f[r] = __fsub_rn(f[r], __fmul_rn(pf, req_s[r]));
          }
        }
        carry += total;
      }
      // sum(place) = min(cnt, sum(k)) for cnt > 0 (first fit stops at cnt)
      leftover += (long long)cnt - min((long long)cnt, carry);
      __syncthreads();  // req_s is rewritten by the next slot
    }
    if (tid == 0) ok[c] = leftover == 0 ? 1 : 0;
    __syncthreads();  // fc is rewritten by the next candidate
  }
}

}  // namespace

extern "C" {

// Launches the screen of C candidates on ``stream`` with ``grid`` blocks;
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes the kernel
// does not take). ``scratch`` null keeps each block's free matrix in shared
// memory, which then needs N * R * 4 bytes.
int repack_launch(int grid, int C, int N, int R, int S, int G,
                  const void* free0, const void* req, const void* gids,
                  const void* gcnt, const void* cap, int cap_kind,
                  const void* cand, void* ok, void* scratch, void* stream) {
  if (R < 1 || R > kMaxR || N < 1 || C < 1 || grid < 1 || S < 0 ||
      cap_kind < kCapBool || cap_kind > kCapF32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scratch ? 0 : (size_t)N * R * sizeof(float);
  if (smem + kStaticReserve > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      repack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  repack_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      C, N, R, S, G, static_cast<const float*>(free0), static_cast<const float*>(req),
      static_cast<const int*>(gids), static_cast<const int*>(gcnt), cap, cap_kind,
      static_cast<const int*>(cand), static_cast<uint8_t*>(ok),
      static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}

const char* repack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
