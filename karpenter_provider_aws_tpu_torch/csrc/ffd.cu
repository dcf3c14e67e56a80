// First-fit-decreasing bin packing over pod groups, for Hopper (sm_90a).
//
// Replaces the TPU kernel karpenter_provider_aws_tpu/ops/ffd_pallas.py::_kernel
// and computes what ops/ffd.py::_step scanned over the G groups computes:
// per group g,
//   1. first fit onto open rows: k[n] = min_r floor((cap - used + 1e-4) / req)
//      over req > 0, capped by the hostname cap mpn, zero where the committed
//      type is incompatible, the row's window bits miss the group's, or the
//      row is pre-opened and the group is hostname-capped. An exclusive
//      prefix sum turns k into placements; touched rows narrow their window.
//   2. while pods remain: take the first type minimising
//      price / max(min(k_type, mpn, rem), 1) and open every full row of it
//      at once, plus one partial tail.
//
// What bounds it on this card: the serial chain of groups, not bytes or
// operations. A group's arithmetic is a few divisions a row; what it waits
// for is latency: the prefix sum needs every row's fit before any row
// places, and the next group needs this one's state. So each group's
// critical path is kept to on-chip loads and as few barriers as the
// dependence allows. A cluster barrier costs far more than a block barrier
// on an H100 (PERF.md), which sets the layout below.
//
// What the design does about it:
// - One launch per solve, one thread-block cluster of kCluster CTAs per
//   problem (per lane). A prologue spread over the whole cluster compacts
//   the real groups (count > 0) into records (group, count, cap, window,
//   the requested axes and their requests) and computes every real group's
//   per-type fit (the compat bit in its top bit) and masked price into a
//   global table, so the group loop skips count-0 groups (the wrapper's
//   zeroed placed and unplaced hold their result) and the open phase
//   computes no fit.
// - The node state lives in shared memory as structure-of-arrays ([R][rows]
//   used and cap, committed type, window bits), loaded and stored
//   coalesced. Up to ~2,150 rows (R = 10) it sits in CTA 0 alone and the
//   other CTAs leave after the prologue: a group then costs block barriers
//   only. Past that, each of the kCluster CTAs holds a contiguous slice, and
//   each real group pays one exchange across the cluster: every CTA scans
//   its slice and pushes its total into every peer's shared memory with
//   st.async, which counts the bytes on the peer's mbarrier; each CTA waits
//   on its own mbarrier, then adds the totals of the lower ranks. The slots
//   and the mbarriers alternate with the group's parity, and no CTA waits
//   for more than the totals it needs (a cluster.sync() a group would add a
//   cluster barrier's cost to every group). Past the shared-memory budget
//   (ops/ffd_cuda.py::
//   ffd_smem_bytes) the same code runs on a [R][N] global scratch (the
//   kResident = false branch).
// - Each thread owns up to kPer contiguous rows and keeps their fits in
//   registers between the scan and the placement. The fit runs over the
//   group's requested axes only, three at a time with their loads in flight
//   together. The prefix saturates at the group's count in uint32, which is
//   exact: a row's placement depends on its prefix only through
//   min(prefix, count).
// - While group k runs, cp.async copies group k+1's table row and group
//   k+2's record into shared memory; they land before k's scan barrier.
//   Every active CTA runs the open phase's argmin redundantly on the same
//   inputs (a warp min-reduction, one block barrier, another), so rem,
//   n_open and the chosen type stay uniform with no cross-CTA traffic; each
//   CTA writes the opened rows it owns.
//
// Rounding matches the plain version bit for bit: every product, sum and
// quotient is written with an explicit IEEE round-to-nearest intrinsic, and
// the build adds --fmad=false, so no fused multiply-add changes a floor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;      // CTAs per problem: the portable cluster size
constexpr int kResPer = 3;       // rows a thread owns, resident branch
constexpr int kGlobalPer = 8;    // rows a thread owns, global branch
constexpr int kMaxR = 16;
constexpr int kMaxT = 2048;
constexpr int kMaxTPer = kMaxT / kThreads;  // types a thread scores
constexpr int kStage = 64;       // records a CTA stages at once in the prologue
constexpr int kBig = 1 << 30;
constexpr unsigned kCompatBit = 1u << 31;   // in the type table's fit word
constexpr float kEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// One real group, as the prologue compacts it: the requested axes (ax, q)
// first, the rest of both repeating the first, so a min over any prefix of
// them is the min over the requested ones.
struct alignas(16) GroupRec {
  int g, cnt, mpn, gw;      // group index, count, hostname cap (<= 2^30), window bits
  int nq, pad[3];           // requested axes
  uint8_t ax[kMaxR];
  float q[kMaxR];
  float req[kMaxR];         // the whole request, 0 past R
};
constexpr int kRecChunks = sizeof(GroupRec) / 16;

// shared memory a block may use on this card, and the part of it the static
// scratch below may take (ffd_cuda.py's budget uses both)
constexpr size_t kSmemLimit = 232448;
constexpr size_t kStaticReserve = 42 * 1024;
static_assert(2 * kMaxT * 8 + kMaxT * 4 + 4 * sizeof(GroupRec) + kWarps * 4 +
                  2 * kCluster * 4 + 2 * 8 + 2 * kWarps * 8 <= kStaticReserve,
              "static shared scratch outgrew its reserve");
static_assert(kStage * sizeof(GroupRec) <= 2 * kMaxT * 4, "prologue stage outgrew fit_s");

// One axis of the fit: floor((cap - used + eps) / q), used == nullptr for
// an empty row.
__device__ __forceinline__ float axis_fit(const float* cap, const float* used, int off, float q) {
  const float c = cap[off];
  const float free_r = used ? __fsub_rn(c, used[off]) : c;
  return floorf(__fdiv_rn(__fadd_rn(free_r, kEps), q));
}

// min over the requested axes of floor((cap - used + eps) / req), in
// [0, 2^30] (2^30 where nothing is requested); the row's r-th value sits at
// cap[r * ld].
__device__ __forceinline__ int fit_count(const float* cap, const float* used, int ld,
                                         const GroupRec& rec) {
  if (rec.nq == 0) return kBig;
  float k = INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i) k = fminf(k, axis_fit(cap, used, rec.ax[i] * ld, rec.q[i]));
  for (int i = 3; i < rec.nq; ++i) k = fminf(k, axis_fit(cap, used, rec.ax[i] * ld, rec.q[i]));
  return (int)fminf(fmaxf(k, 0.f), (float)kBig);
}

// a + b, saturated at c (a, b <= c < 2^31, so the sum cannot wrap)
__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b, unsigned c) {
  return min(a + b, c);
}

// A non-NaN float as an unsigned key in the same order, -0 as +0 (they
// compare equal), so that an unsigned min is the float min.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Warp-wide first-occurrence argmin: every lane gets the least key (in
// *min_key) and, among the lanes that hold it, the least index.
__device__ __forceinline__ unsigned warp_argmin(unsigned key, unsigned idx, unsigned* min_key) {
  const unsigned m = __reduce_min_sync(kFull, key);
  *min_key = m;
  return __reduce_min_sync(kFull, key == m ? idx : kFull);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Store v into CTA ``peer``'s copy of *slot and count its 4 bytes on that
// CTA's copy of *bar (distributed shared memory; the peer waits on bar).
__device__ __forceinline__ void push_to_peer(unsigned* slot, unsigned long long* bar, int peer,
                                             unsigned v) {
  asm volatile(
      "{\n\t.reg .b32 ra, rb;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %2;\n\t"
      "mapa.shared::cluster.u32 rb, %1, %2;\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [ra], %3, [rb];\n\t}"
      ::"r"(smem_u32(slot)), "r"(smem_u32(bar)), "r"(peer), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// This CTA's one arrival on *bar, expecting ``bytes`` from the peers.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned phase) {
  unsigned done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The record of group g from the request and scalar inputs.
__device__ void make_record(GroupRec* out, int g, int cnt, int R, const float* requests,
                            const int* mpn_in, const int* gwbits) {
  GroupRec rec;
  rec.g = g;
  rec.cnt = cnt;
  rec.mpn = min(__ldg(mpn_in + g), kBig);
  rec.gw = __ldg(gwbits + g);
  rec.pad[0] = rec.pad[1] = rec.pad[2] = 0;
  int nq = 0;
  for (int r = 0; r < kMaxR; ++r) {
    const float q = r < R ? __ldg(requests + (size_t)g * R + r) : 0.f;
    rec.req[r] = q;
    if (q > 0.f) {
      rec.ax[nq] = (uint8_t)r;
      rec.q[nq] = q;
      ++nq;
    }
  }
  rec.nq = nq;
  for (int i = nq; i < kMaxR; ++i) {
    rec.ax[i] = nq ? rec.ax[0] : 0;
    rec.q[i] = nq ? rec.q[0] : 1.f;
  }
  *out = rec;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
ffd_kernel(int G, int T, int Tp, int R, int N, int nact,
           const float* __restrict__ requests,   // [L, G, R]
           const int* __restrict__ counts,       // [L, G]
           const uint8_t* __restrict__ compat,   // [L, G, T]
           const float* __restrict__ capacity,   // [L, T, R]
           const float* __restrict__ price,      // [L, G, T] inf = unusable
           const int* __restrict__ gwbits,       // [L, G]
           const int* __restrict__ twbits,       // [L, T]
           const int* __restrict__ mpn_in,       // [L, G]
           const int* __restrict__ n_pre_in,     // [L]
           const int* __restrict__ ntype0,       // [L, N] initial state
           const float* __restrict__ nprice0,    // [L, N]
           const float* __restrict__ used0,      // [L, N, R]
           const float* __restrict__ cap0,       // [L, N, R]
           const int* __restrict__ wbits0,       // [L, N]
           const int* __restrict__ nopen0,       // [L]
           int* __restrict__ ntype,              // [L, N] final state
           float* __restrict__ nprice,           // [L, N]
           float* __restrict__ used,             // [L, N, R]
           float* __restrict__ ncap,             // [L, N, R]
           int* __restrict__ wbits,              // [L, N]
           int* __restrict__ placed,             // [L, G, N] zeroed by the caller
           int* __restrict__ unplaced,           // [L, G] zeroed by the caller
           int* __restrict__ n_open_out,         // [L]
           unsigned* __restrict__ type_fit,      // [L, G, Tp] scratch: fit | compat bit
           float* __restrict__ type_price,       // [L, G, Tp] scratch: masked price
           GroupRec* __restrict__ recs,          // [L, G + 1] scratch: real groups, then n_real
           float* __restrict__ gstate) {         // [L, 2, R, N] scratch, global branch
  constexpr int kPer = kResident ? kResPer : kGlobalPer;
  extern __shared__ float dyn[];  // resident branch: [R][rows] used, cap; ntype; wbits
  // staged per real group k: the table row is read in phase 1 (before k's
  // scan barrier) and in the open phase, which ends with a block barrier
  // (two buffers); the records two groups ahead (a ring of four)
  __shared__ __align__(16) unsigned fit_s[2][kMaxT];
  __shared__ __align__(16) float pm_s[2][kMaxT];
  __shared__ int tw_s[kMaxT];  // the types' window bits
  __shared__ GroupRec rec_s[4];
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned slots[2][kCluster];      // the CTA totals, by group parity
  __shared__ unsigned long long xbar[2];       // their arrival, by group parity
  __shared__ unsigned red_key[2][kWarps];
  __shared__ unsigned red_idx[2][kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane_id = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t GR = (size_t)G * R, GT = (size_t)G * T, TR = (size_t)T * R;
  const size_t NR = (size_t)N * R, GN = (size_t)G * N, GTp = (size_t)G * Tp;
  requests += lane_id * GR;
  counts += (size_t)lane_id * G;
  compat += lane_id * GT;
  capacity += lane_id * TR;
  price += lane_id * GT;
  gwbits += (size_t)lane_id * G;
  twbits += (size_t)lane_id * T;
  mpn_in += (size_t)lane_id * G;
  placed += lane_id * GN;
  unplaced += (size_t)lane_id * G;
  type_fit += lane_id * GTp;
  type_price += lane_id * GTp;
  recs += (size_t)lane_id * (G + 1);

  // -- prologue: records, then the table, spread over the whole cluster ----
  if (rank == 0) {  // the real groups, in order
    int count = 0;  // uniform
    for (int g0 = 0; g0 < G; g0 += kThreads) {
      const int g = g0 + tid;
      const int c = g < G ? __ldg(counts + g) : 0;
      const unsigned m = __ballot_sync(kFull, c > 0);
      if (lane == 0) warp_sums[warp] = __popc(m);
      __syncthreads();
      int before = 0, chunk = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int v = (int)warp_sums[w];
        before += w < warp ? v : 0;
        chunk += v;
      }
      if (c > 0)
        make_record(recs + count + before + __popc(m & ((1u << lane) - 1)), g, c, R, requests,
                    mpn_in, gwbits);
      count += chunk;
      __syncthreads();  // warp_sums is rewritten by the next chunk
    }
    if (tid == 0) recs[G].g = count;
  }
  if (tid == 0) {
    mbar_init(&xbar[0]);
    mbar_init(&xbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // the records and the exchange barriers; every peer has started
  const int n_real = __ldcg(&recs[G].g);
  {
    // real groups k = rank, rank + kCluster, ...: a chunk of their records
    // staged in shared memory, then each thread's types, eight groups at a
    // time so that their price and compat loads are in flight together
    GroupRec* stage = reinterpret_cast<GroupRec*>(&fit_s[0][0]);
    for (int k0 = rank; k0 < n_real; k0 += kCluster * kStage) {
      const int ns = min(kStage, (n_real - k0 + kCluster - 1) / kCluster);
      for (int i = tid; i < ns * kRecChunks; i += kThreads) {
        const int j = i / kRecChunks;
        reinterpret_cast<int4*>(stage + j)[i - j * kRecChunks] =
            __ldcg(reinterpret_cast<const int4*>(recs + k0 + j * kCluster) + (i - j * kRecChunks));
      }
      __syncthreads();
      for (int t = tid; t < T; t += kThreads) {
        for (int j0 = 0; j0 < ns; j0 += 8) {
          float p[8];
          uint8_t c[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const bool in = j0 + u < ns;
            const size_t i = (size_t)stage[in ? j0 + u : 0].g * T + t;
            p[u] = in ? __ldg(price + i) : 0.f;
            c[u] = in ? __ldg(compat + i) : 0;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (j0 + u < ns) {
              const size_t o = (size_t)(k0 + (j0 + u) * kCluster) * Tp + t;
              const int kt = c[u] ? fit_count(capacity + (size_t)t * R, nullptr, 1, stage[j0 + u])
                                  : 0;  // read only through a compatible type
              type_fit[o] = (unsigned)kt | (c[u] ? kCompatBit : 0u);
              type_price[o] = (c[u] && kt >= 1 && isfinite(p[u])) ? p[u] : INFINITY;
            }
          }
        }
      }
      __syncthreads();  // the stage is rewritten by the next chunk
    }
  }
  cluster.sync();  // the table
  // only the first nact CTAs hold rows; the others were here for the table
  if (rank >= nact) return;

  ntype0 += (size_t)lane_id * N;
  nprice0 += (size_t)lane_id * N;
  wbits0 += (size_t)lane_id * N;
  used0 += lane_id * NR;
  cap0 += lane_id * NR;
  ntype += (size_t)lane_id * N;
  nprice += (size_t)lane_id * N;
  wbits += (size_t)lane_id * N;
  used += lane_id * NR;
  ncap += lane_id * NR;

  // this CTA's slice of rows [base, base + rows), and this thread's part of
  // it [lo, lo + per) in slice-local indices
  const int rows_cta = (N + nact - 1) / nact;
  const int base = min(rank * rows_cta, N);
  const int rows = min(rows_cta, N - base);
  const int per = (rows_cta + kThreads - 1) / kThreads;  // <= kPer (wrapper)
  const int lo = tid * per;

  // the state: the r-th value of slice row l is at su[r * ld + l], an int
  // offset (below kMaxR * kCluster * kThreads * kGlobalPer = 2^20)
  float* su;
  float* sc;
  int* snt;
  int* swb;
  int ld;
  if (kResident) {
    ld = rows_cta;
    su = dyn;
    sc = su + (size_t)R * rows_cta;
    snt = reinterpret_cast<int*>(sc + (size_t)R * rows_cta);
    swb = snt + rows_cta;
  } else {
    ld = N;
    su = gstate + lane_id * 2 * NR + base;
    sc = su + NR;
    snt = ntype + base;
    swb = wbits + base;
  }
#pragma unroll 1
  for (int i = tid; i < rows * R; i += kThreads) {  // coalesced over [rows, R]
    const int l = i / R, r = i - l * R;
    su[r * ld + l] = used0[(size_t)base * R + i];
    sc[r * ld + l] = cap0[(size_t)base * R + i];
  }
  for (int l = tid; l < rows; l += kThreads) {
    snt[l] = ntype0[base + l];
    swb[l] = wbits0[base + l];
    nprice[base + l] = nprice0[base + l];
  }
  const int n_pre = n_pre_in[lane_id];
  int n_open = nopen0[lane_id];  // uniform: every thread tracks it
  if (n_real > 0) {
    if (tid < 2 * kRecChunks && tid / kRecChunks < n_real)
      reinterpret_cast<int4*>(rec_s)[tid] = __ldcg(reinterpret_cast<const int4*>(recs) + tid);
    for (int t = tid; t < T; t += kThreads) {
      fit_s[0][t] = __ldcg(type_fit + t);
      pm_s[0][t] = __ldcg(type_price + t);
      tw_s[t] = __ldg(twbits + t);
    }
  }
  __syncthreads();

  int tp = 0;  // parity of the argmin trip
  for (int k = 0; k < n_real; ++k) {
    const int b = k & 1;
    const GroupRec& rec = rec_s[k & 3];
    const int g = rec.g, cnt = rec.cnt, mpn = rec.mpn, gw = rec.gw;
    const bool pre_ok = mpn >= kBig;
    const unsigned* fit_t = fit_s[b];
    const float* pm_t = pm_s[b];
    // stage group k+1's table row and group k+2's record (16 bytes a
    // thread); waited for just before this group's scan barrier
    if (k + 1 < n_real) {
      const int chunks = Tp / 4;  // Tp is a multiple of 4
      if (tid < chunks)
        cp_async16(&fit_s[b ^ 1][4 * tid], type_fit + (size_t)(k + 1) * Tp + 4 * tid);
      else if (tid < 2 * chunks)
        cp_async16(&pm_s[b ^ 1][4 * (tid - chunks)],
                   type_price + (size_t)(k + 1) * Tp + 4 * (tid - chunks));
    }
    if (k + 2 < n_real && tid >= kThreads - kRecChunks)
      cp_async16(reinterpret_cast<int4*>(&rec_s[(k + 2) & 3]) + (tid - (kThreads - kRecChunks)),
                 reinterpret_cast<const int4*>(recs + k + 2) + (tid - (kThreads - kRecChunks)));
    cp_async_commit();

    // -- 1. first fit onto open rows ------------------------------------
    int kr[kPer];
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int l = lo + j;
      const int n = base + l;
      int kk = 0;
      if (j < per && l < rows && n < n_open && (pre_ok || n >= n_pre) && (swb[l] & gw) != 0) {
        const int nt = snt[l];
        if ((unsigned)nt < (unsigned)T && (fit_t[nt] & kCompatBit))
          kk = min(fit_count(sc + l, su + l, ld, rec), mpn);
      }
      kr[j] = kk;
      mine = sat_add(mine, (unsigned)kk, (unsigned)cnt);
    }
    // exclusive scan over the CTA: warp shuffles, one barrier (which also
    // publishes the staged copies), then every warp reduces the warp totals
    // itself
    unsigned x = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = sat_add(x, y, cnt);
    }
    unsigned excl = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) excl = 0;
    if (lane == 31) warp_sums[warp] = x;
    cp_async_wait_all();
    __syncthreads();
    unsigned w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = sat_add(w, y, cnt);
    }
    const unsigned warp_before = __shfl_sync(kFull, w, (warp + 31) & 31);
    unsigned before = sat_add(warp ? warp_before : 0u, excl, cnt);
    unsigned total = __shfl_sync(kFull, w, 31);
    if (nact > 1) {
      // push the CTA's total into every peer's slot and wait for theirs:
      // the slot and the barrier alternate with the group's parity, and a
      // peer writes a slot again only after this CTA has sent it the next
      // group's total, by when this CTA has read the slot
      if (tid == 0) mbar_expect(&xbar[b], 4u * nact);
      if (tid < nact) push_to_peer(&slots[b][rank], &xbar[b], tid, total);
      mbar_wait(&xbar[b], (unsigned)(k >> 1) & 1u);
      total = 0;
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        const unsigned v = c < nact ? slots[b][c] : 0u;
        if (c < rank) before = sat_add(before, v, cnt);
        total = sat_add(total, v, cnt);
      }
    }
    int* placed_g = placed + (size_t)g * N;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned kk = (unsigned)kr[j];  // 0 past the thread's rows
      const unsigned p = min((unsigned)cnt - before, kk);  // before <= cnt
      before = sat_add(before, kk, cnt);
      if (p > 0) {
        const int l = lo + j;
        const float pf = (float)p;
        for (int i = 0; i < rec.nq; ++i) {  // the other axes add 0
          float* u = su + rec.ax[i] * ld + l;
          *u = __fadd_rn(*u, __fmul_rn(pf, rec.q[i]));
        }
        swb[l] &= gw;
        placed_g[base + l] = (int)p;
      }
    }
    int rem = cnt - (int)total;
    int unpl = 0;

    // -- 2. open new rows for the remainder (uniform over the cluster) ----
    if (rem > 0) {
      while (rem > 0) {
        const int rem1 = max(rem, 1);
        // this thread's types in increasing order, so the first strict
        // minimum is the first occurrence
        unsigned key = kFull, idx = kFull;
#pragma unroll
        for (int i = 0; i < kMaxTPer; ++i) {
          const int t = tid + i * kThreads;
          if (t < T) {
            const float pm = pm_t[t];
            if (pm < INFINITY) {
              const int kt = (int)(fit_t[t] & ~kCompatBit);
              const int eff = max(min(min(kt, mpn), rem1), 1);
              const unsigned kt_key = order_key(__fdiv_rn(pm, (float)eff));
              if (kt_key < key) { key = kt_key; idx = (unsigned)t; }
            }
          }
        }
        unsigned wkey;
        const unsigned widx = warp_argmin(key, idx, &wkey);
        if (lane == 0) {
          red_key[tp][warp] = wkey;
          red_idx[tp][warp] = widx;
        }
        __syncthreads();
        unsigned bkey;
        const int bi = (int)warp_argmin(red_key[tp][lane], red_idx[tp][lane], &bkey);
        tp ^= 1;  // the next trip writes the other buffer: no second barrier
        const int room = N - n_open;
        if (bkey == kFull || room <= 0) {  // no feasible type, or no row
          unpl += rem;
          break;
        }
        const int k_star = max(min((int)(fit_t[bi] & ~kCompatBit), mpn), 1);
        int q = rem / k_star;
        q = min(q >= 1 ? q : 1, room);
        // the opened rows [n_open, n_open + q) this CTA owns
        const int o_lo = max(n_open, base), o_hi = min(n_open + q, base + rows);
        if (o_lo < o_hi) {
          const float p_star = pm_t[bi];  // finite: the type's price
          const int win = gw & tw_s[bi];
          float cap_t[kMaxR];  // the type's capacity, its loads in flight together
          if (o_lo + tid < o_hi) {
#pragma unroll
            for (int r = 0; r < kMaxR; ++r)
              cap_t[r] = r < R ? __ldg(capacity + (size_t)bi * R + r) : 0.f;
          }
          for (int n = o_lo + tid; n < o_hi; n += kThreads) {
            const int l = n - base;
            long long tk = (long long)rem - (long long)(n - n_open) * k_star;
            tk = tk < 0 ? 0 : (tk > k_star ? k_star : tk);
            const float tf = (float)tk;
#pragma unroll
            for (int r = 0; r < kMaxR; ++r) {
              if (r < R) {
                su[r * ld + l] = __fmul_rn(tf, rec.req[r]);
                sc[r * ld + l] = cap_t[r];
              }
            }
            snt[l] = bi;
            swb[l] = win;
            nprice[n] = p_star;
            if (tk > 0) placed_g[n] = (int)tk;
          }
        }
        rem -= (int)min((long long)rem, (long long)q * k_star);
        n_open += q;
      }
      __syncthreads();  // opened rows before their owners read them
    }
    if (rank == 0 && tid == 0 && unpl) unplaced[g] = unpl;
  }

  // -- epilogue: the slice back to [N, R], coalesced ----------------------
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < rows * R; i += kThreads) {
    const int l = i / R, r = i - l * R;
    used[(size_t)base * R + i] = su[r * ld + l];
    ncap[(size_t)base * R + i] = sc[r * ld + l];
  }
  if (kResident) {
    for (int l = tid; l < rows; l += kThreads) {
      ntype[base + l] = snt[l];
      wbits[base + l] = swb[l];
    }
  }
  if (rank == 0 && tid == 0) n_open_out[lane_id] = n_open;
  if (nact > 1) cluster.sync();  // no CTA leaves while a peer may address its slots
}

cudaLaunchConfig_t launch_config(int lanes, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Rows of one active CTA's slice, and the dynamic shared memory of the
// resident branch: the slice's state (ffd_cuda.py::ffd_smem_bytes).
int rows_per_cta(int N, int nact) { return (N + nact - 1) / nact; }

size_t resident_smem(int N, int R, int nact) {
  return (size_t)rows_per_cta(N, nact) * (2 * (size_t)R * sizeof(float) + 2 * sizeof(int));
}

bool shapes_ok(int lanes, int nact, int G, int T, int R, int N, bool resident) {
  return lanes >= 1 && (nact == 1 || nact == kCluster) && G >= 0 && T >= 1 && T <= kMaxT &&
         R >= 1 && R <= kMaxR && N >= 1 &&
         rows_per_cta(N, nact) <= kThreads * (resident ? kResPer : kGlobalPer);
}

template <bool kResident>
cudaError_t prepare(int N, int R, int nact, size_t* smem) {
  *smem = kResident ? resident_smem(N, R, nact) : 0;
  if (*smem + kStaticReserve > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(ffd_kernel<kResident>),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <bool kResident>
cudaError_t occupancy(int N, int R, int nact, int* clusters) {
  size_t smem;
  cudaError_t err = prepare<kResident>(N, R, nact, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(ffd_kernel<kResident>), &cfg);
}

}  // namespace

extern "C" {

// Bytes of one group record (``recs`` holds G + 1 of them a lane).
int ffd_record_bytes() { return (int)sizeof(GroupRec); }

// How many clusters of the kernel's branch (``resident`` 0: the global
// branch) fit on the card at once for N rows and R resources, with the rows
// on ``nact`` CTAs (1 or kCluster); 0 means it cannot launch.
int ffd_max_active_clusters(int N, int R, int nact, int resident, int* clusters) {
  if (!shapes_ok(1, nact, 0, 1, R, N, resident)) return (int)cudaErrorInvalidValue;
  return (int)(resident ? occupancy<true>(N, R, nact, clusters)
                        : occupancy<false>(N, R, nact, clusters));
}

// Launches one solve per lane on ``stream``, one cluster of kCluster CTAs
// per lane, the rows on the first ``nact`` of them (1 or kCluster); returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes the kernel does
// not take). ``gstate`` null keeps the node state in shared memory, which
// then needs ``resident_smem`` bytes a CTA; otherwise it is a [lanes, 2, R,
// N] float scratch. ``placed`` and ``unplaced`` must be zeroed on the same
// stream; ``type_fit`` and ``type_price`` ([lanes, G, Tp], Tp = T rounded
// up to a multiple of 4) and ``recs`` ([lanes, G + 1] records) are scratch.
int ffd_solve_launch(int lanes, int nact, int G, int T, int R, int N,
                     const void* requests, const void* counts, const void* compat,
                     const void* capacity, const void* price, const void* gwbits,
                     const void* twbits, const void* mpn, const void* n_pre,
                     const void* ntype0, const void* nprice0, const void* used0,
                     const void* cap0, const void* wbits0, const void* nopen0,
                     void* ntype, void* nprice, void* used, void* ncap, void* wbits,
                     void* placed, void* unplaced, void* n_open, void* type_fit,
                     void* type_price, void* recs, void* gstate, void* stream) {
  const bool resident = gstate == nullptr;
  if (!shapes_ok(lanes, nact, G, T, R, N, resident)) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = resident ? prepare<true>(N, R, nact, &smem)
                             : prepare<false>(N, R, nact, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(lanes, smem, static_cast<cudaStream_t>(stream), &attr);
  const int Tp = (T + 3) / 4 * 4;
  auto kernel = resident ? ffd_kernel<true> : ffd_kernel<false>;
  err = cudaLaunchKernelEx(
      &cfg, kernel, G, T, Tp, R, N, nact, static_cast<const float*>(requests),
      static_cast<const int*>(counts), static_cast<const uint8_t*>(compat),
      static_cast<const float*>(capacity), static_cast<const float*>(price),
      static_cast<const int*>(gwbits), static_cast<const int*>(twbits),
      static_cast<const int*>(mpn), static_cast<const int*>(n_pre),
      static_cast<const int*>(ntype0), static_cast<const float*>(nprice0),
      static_cast<const float*>(used0), static_cast<const float*>(cap0),
      static_cast<const int*>(wbits0), static_cast<const int*>(nopen0),
      static_cast<int*>(ntype), static_cast<float*>(nprice), static_cast<float*>(used),
      static_cast<float*>(ncap), static_cast<int*>(wbits), static_cast<int*>(placed),
      static_cast<int*>(unplaced), static_cast<int*>(n_open),
      static_cast<unsigned*>(type_fit), static_cast<float*>(type_price),
      static_cast<GroupRec*>(recs), static_cast<float*>(gstate));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* ffd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
