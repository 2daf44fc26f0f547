// QC LDPC decode kernels for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of the JAX package and their shared body:
//   * ldpc_tpu/ops/mc_pallas.py  make_mc_decoder  (body :295-376) -> mc_decoder_kernel
//     modulation, noise (injected words or Philox), Box-Muller with a 48-bit
//     radial uniform, channel LLRs, the QC decode loop, info-bit error counts,
//     optionally the channel LLRs out for phase 2;
//   * ldpc_tpu/ops/mc_pallas.py  make_llr_decoder (body :561-601) -> llr_decoder_kernel
//     the same decode and counts from given LLRs with a per-lane pre-done mask;
//   * ldpc_tpu/ops/spa_pallas.py make_qc_decoder  (body :686-708) -> qc_decoder_kernel
//     the standalone decode of given channel LLRs (the unfused path): layered
//     or flooding, hard decisions, ok, conv, the normalized-LLR flip metric;
//   * ldpc_tpu/ops/spa_pallas.py make_decode_loop / make_check_update
//     (:126-574) -> decode_group, the one decode body of all three kernels,
//     with check_update and exclusive_combine.
//
// What bounds them: a codeword's decode is a chain of dependent steps (a
// layer of the layered schedule, or the check then the posterior phase of a
// flooding sweep), each a gather along Z, a leave-one-out combine (tanh/log
// or min/sign) and a scatter, with a barrier between steps. Device-memory
// traffic is small (code bits or LLRs in; counters, decisions or LLRs out),
// so of the two bounds operations bind. On the H100 the kernels are bound by
// instruction issue: SPA's tanhf / logf / division chains (about 5 issued
// instructions per census op on the bench frame's mix, which the K5 probe
// sustains at 6.9e12 census ops/s), with the step's shared-memory loads and
// its barrier on the critical path; no matrix product, so wgmma and TMA do
// not apply. What the card offers them: 227 KB of shared memory per block
// (228 KB per SM), 64K registers per SM.
//
// The design, the same for K1, K2 and K3 (PERF.md has the times of each point):
//   1. Per-codeword progress. A block is one barrier group: one codeword
//      whose R*Z threads fill whole warps (padded to a multiple of 32), or,
//      where R*Z < 32, up to 8 codewords sharing one warp. The block syncs on
//      barrier 0 and leaves the loop on a block-uniform test once its
//      codewords pass the syndrome check (the barrier reduction
//      __syncthreads_or, or a warp vote where codewords share the warp). The
//      block plan (mc_kernels.py fused_plan) is computed once in Python; the
//      entry points only validate it. At WiMAX 1152 a block is 96 threads
//      (paired layers, or flooding's 2 rows per step) or 64 (48 active,
//      serial layers), several resident per SM, so a converged codeword frees
//      its slot for the next block at once. `iters` is the block's trips,
//      the max over its codewords (a codeword's own trips at one per block).
//   2. No spills. __launch_bounds__(768, 1), the largest block any plan
//      launches, gives 80 registers a thread; the leave-one-out combine
//      keeps its suffixes and one running prefix (2 x DMAX values, not 4),
//      and the min-sum family folds signs to a parity and magnitudes to the
//      two smallest (exact in any order, so bit-equal to exclusive_combine).
//      The flip metric is compiled in only where it is used (NORM).
//   3. Precomputed gathers. The L offset slot_col*Z + (z+shift) mod Z of
//      every (edge slot, z) is a uint16 table built on the host and staged
//      in shared memory; an edge reads one offset for its gather and again
//      for its write-back, and the syndrome check reads the same table.
//   4. Coalesced device memory. K1 / K2's [n, B] arrays are read and written
//      lane-fastest (a warp reads the block's adjacent codewords of one row;
//      L is padded per codeword so those lanes start in different banks).
//      K3's [B, n] arrays are read and written codeword-major: a block's
//      codewords are adjacent rows, one contiguous range.
// Multi-diagonal layers (CCSDS) stage each edge's extrinsic delta at the
// position it updates and add them per position after the block's barrier
// (the additive update of the reference).
//
// Flooding (K3). Thread (r, z) runs the check phase of base rows r, r+R, ...
// at check row z (R = 2 where the code has 2 rows); after the barrier, every
// thread of the block, padding included, runs the posterior phase at
// positions t, t+threads, ... (where codewords share a warp, a codeword's
// own R*Z threads), summing in column-slot order; then a barrier. Every
// sweep restarts the posteriors from the channel LLRs X. Where X lives: the
// shared memory of one codeword is L + E + the gather table + the tables,
// 4n + 4 e_slots Z + 2 e_slots Z + about 1.4 KB: 27,912 B at WiMAX 1152 and
// 213,384 B at n=9216 (Z=384, 76 edge slots). X in shared memory would add
// 4n (4,608 B; 36,864 B), which at n=9216 exceeds the 232,448 B of a block
// and at 1152 lowers the resident blocks per SM from 8 to 6. Registers
// would need n / threads = 12 more per thread, above the 80 of the bound.
// So every code reads X from device memory: K3's own input row [B][n]
// (negated on read), four positions' loads issued together; the rows of the
// resident blocks stay in L1 / L2.
//
// The flip metric (K3, NORM). After each check window every live codeword
// counts, over its info bits, the posteriors with |L| <= 7 whose sign
// differs from the previous window's, as an integer: each thread over its
// positions of the posterior map, a warp sum (__reduce_add_sync), one shared
// word per warp, summed by the codeword's leader; the previous posteriors
// stay in device memory as an internal [B][n] buffer, so a codeword's
// threads read adjacent words.
//
// A roll along Z is an indexed shared-memory read, and in a single-diagonal
// layer every posterior is read and written by one thread, so a layer needs
// no atomics; the rows of a paired group run in the same step. Every op is
// per codeword, so the outputs other than `iters` do not depend on the plan.
// Built with -fmad=false so each op rounds as the plain PyTorch version
// (ldpc_tpu_torch/ops/decode_loop.py, mc_kernels.py, qc_kernels.py) does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CPG = 8;  // codewords per block
constexpr float TANH_IN_CLIP = 17.5f;
constexpr float PROD_CLIP = 0x1.fffffep-1f;  // largest float below 1
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float U24 = 0x1p-24f;
constexpr float HALF_U24 = 0x1p-25f;
constexpr float U48 = 0x1p-48f;
constexpr float HALF_U48 = 0x1p-49f;
constexpr float ONE_MINUS_U24 = 0x1.fffffep-1f;
constexpr float LLR_WINDOW = 7.0f;  // normalized-LLR confidence window

// Every block launches at most MAX_THREADS threads (R * Z <= 768 for every
// code the plan takes); the bound caps a thread at 80 registers, which keeps
// the DMAX=8 bodies out of local memory.
constexpr int MAX_THREADS = 768, MIN_BLOCKS = 1, MAX_WARPS = MAX_THREADS / 32;

struct Loop {
  const int* row_off;     // [mb + 1] first flattened slot of each base row
  const int* slot_col;    // [e_slots] base column of each slot
  const int* slot_shift;  // [e_slots] circulant shift of each slot
  const int* groups;      // [ngroups * R] rows of each layer step, -1 = none
  const int* grp_dup;     // [ngroups] the step holds a multi-diagonal row
  const int* row_dup;     // [mb] multi-diagonal row
  const int* col_off;     // flooding: [nb + 1] first column slot of each base column
  const int* col_slot;    // flooding: [e_slots] flattened E slot, column order
  const int* col_shift;   // flooding: [e_slots] circulant shift, column order
  const unsigned short* goff;  // [e_slots * Z] L offset of every (slot, z)
  const int* info_mask;   // [n] 1 at info-bit positions (device memory)
  const float* xg;        // K3: channel LLRs [B][n] (LLR > 0 <=> bit 1; device memory)
  float* prior;           // K3 with the flip metric: previous posteriors [B][n]
  int n, Z, nb, mb, e_slots, ngroups, R, B;
  int max_it, check_every, variant;  // variant: 0 spa, 1 minsum, 2 nms, 3 oms
  float alpha, beta;
  int has_dup, flood;
  float kf;  // info positions the flip metric divides by (at least 1)
  // the block plan (mc_kernels.py fused_plan, checked by bad_plan)
  int cpg;  // codewords per block
  int tpg;  // threads per block
  int Ls;   // L stride per codeword
};

// ints of the gather offsets (two uint16 per int)
__host__ __device__ inline int gather_words(const Loop& P) { return (P.e_slots * P.Z + 1) / 2; }

__host__ __device__ inline int table_len(const Loop& P) {
  return (P.mb + 1) + 2 * P.e_slots + P.ngroups * P.R + P.ngroups + P.mb +
         (P.flood ? (P.nb + 1) + 2 * P.e_slots : 0) + gather_words(P);
}

__shared__ int s_done[MAX_CPG];
__shared__ int s_conv[MAX_CPG];
__shared__ int s_err[MAX_CPG];
__shared__ int s_pre[MAX_CPG];  // lane pre-marked done: no load, no count
__shared__ float s_norm[MAX_CPG];
__shared__ int s_flips[MAX_WARPS];  // the flip metric: one word per warp
__shared__ int s_iters;             // the block's trips (max over its codewords)

// Copy the schedule tables into shared memory and point P at the copies.
__device__ void stage_tables(Loop& P, const int* tab, int* stab) {
  const int len = table_len(P);
  for (int i = threadIdx.x; i < len; i += blockDim.x) stab[i] = tab[i];
  P.row_off = stab;
  P.slot_col = P.row_off + P.mb + 1;
  P.slot_shift = P.slot_col + P.e_slots;
  P.groups = P.slot_shift + P.e_slots;
  P.grp_dup = P.groups + P.ngroups * P.R;
  P.row_dup = P.grp_dup + P.ngroups;
  P.col_off = P.row_dup + P.mb;
  P.col_slot = P.col_off + P.nb + 1;
  P.col_shift = P.col_slot + P.e_slots;
  P.goff = reinterpret_cast<const unsigned short*>(stab + len - gather_words(P));
  P.info_mask = tab + len;
}

struct MulOp {
  __device__ float operator()(float a, float b) const { return a * b; }
};

// Leave-one-out combine in place, in the order of ldpc_tpu/ops/spa.py
// exclusive_combine: prefix[i] folds v[0..i-1] left to right, suffix[i]
// folds v[d-1..i+1] right to left, v[j] <- op(prefix[j], suffix[j]); `none`
// stands for an empty fold. The suffixes live in one array and the prefix in
// one running value, so a row holds 2 x DMAX values, not 4.
template <int DMAX, class Op>
__device__ __forceinline__ void exclusive_combine(float (&v)[DMAX], int d, float none, Op op) {
  float suf[DMAX];
#pragma unroll
  for (int i = DMAX - 2; i >= 0; --i)
    if (i <= d - 2) suf[i] = (i == d - 2) ? v[i + 1] : op(suf[i + 1], v[i + 1]);
  float pre = none;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      const bool hp = j > 0, hs = j < d - 1;
      const float out = hp ? (hs ? op(pre, suf[j]) : pre) : (hs ? suf[j] : none);
      if (hs) pre = hp ? op(pre, v[j]) : v[0];
      v[j] = out;
    }
  }
}

// make_check_update (spa_pallas.py:126-173): messages m -> extrinsics e.
template <int DMAX>
__device__ __forceinline__ void check_update(const float (&m)[DMAX], float (&e)[DMAX], int d,
                                             int variant, float alpha, float beta) {
  if (variant == 0) {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j < d) {
        const float x = fminf(fmaxf(m[j] * 0.5f, -TANH_IN_CLIP), TANH_IN_CLIP);
        e[j] = fminf(fmaxf(tanhf(x), -PROD_CLIP), PROD_CLIP);
      }
    }
    exclusive_combine<DMAX>(e, d, 1.0f, MulOp());
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j < d) {
        const float p = fminf(fmaxf(e[j], -PROD_CLIP), PROD_CLIP);
        e[j] = logf((1.0f + p) / (1.0f - p));
      }
    }
    return;
  }
  // min-sum family: the leave-one-out sign is a product of +-1 and the
  // leave-one-out magnitude a minimum, both exact in any order, so the
  // exclusive_combine folds reduce to the sign parity and the two smallest
  // magnitudes (out[j] = the smallest, or the second smallest at the first
  // index of the smallest; `none` = 1e30 where a row has one slot)
  float min1 = 1e30f, min2 = 1e30f, sgn = 1.0f;
  int at = -1;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      const float a = fabsf(m[j]);
      if (m[j] < 0.0f) sgn = -sgn;
      if (a < min1) {
        min2 = min1;
        min1 = a;
        at = j;
      } else {
        min2 = fminf(min2, a);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      float mag = (d == 1) ? 1e30f : (j == at ? min2 : min1);
      if (variant == 2) {
        mag = alpha * mag;
      } else if (variant == 3) {
        mag = fmaxf(mag - beta, 0.0f);
      }
      e[j] = (m[j] < 0.0f ? -sgn : sgn) * mag;
    }
  }
}

__device__ __forceinline__ int wrap(int x, int Z) {
  return x >= Z ? x - Z : (x < 0 ? x + Z : x);
}

// The thread map of the decode. Thread t holds slot k = t / (R*Z) of the
// block, row r and position z; a block is one codeword over whole warps
// (R*Z >= 32, padded to a multiple of 32: the padding threads meet every
// barrier and help in the codeword-wide passes), or cpg codewords sharing
// one warp (R*Z < 32). Codeword-wide passes (the flooding posterior, the
// flip count) take positions wi, wi + nw, ...
struct Lanes {
  int k, rz, r, z;
  bool on;   // holds a (row, z) of a codeword
  int c;     // the codeword of the block this thread serves
  int wi, nw;
  bool wide;  // takes part in the codeword-wide passes
};

__device__ __forceinline__ Lanes lanes_of(const Loop& P) {
  Lanes T;
  const int RZ = P.R * P.Z, t = threadIdx.x;
  T.k = t / RZ;
  T.rz = t - T.k * RZ;
  T.r = T.rz / P.Z;
  T.z = T.rz - T.r * P.Z;
  T.on = T.k < P.cpg;
  T.c = P.cpg == 1 ? 0 : (T.on ? T.k : 0);
  T.wi = P.cpg == 1 ? t : T.rz;
  T.nw = P.cpg == 1 ? P.tpg : RZ;
  T.wide = P.cpg == 1 || T.on;
  return T;
}

// The flooding check phase of base row bi at check row z: messages
// roll(L) - E, the check update, extrinsics back to E.
template <int DMAX>
__device__ __forceinline__ void flood_check_row(const Loop& P, const float* Lc, float* Ec, int bi,
                                                int z) {
  const int Z = P.Z;
  const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
  const unsigned short* gz = P.goff + off * Z + z;  // slot j's offset at gz[j * Z]
  float* ez = Ec + off * Z + z;                     // slot j's E at ez[j * Z]
  float m[DMAX], e[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) m[j] = Lc[gz[j * Z]] - ez[j * Z];
  }
  check_update<DMAX>(m, e, d, P.variant, P.alpha, P.beta);
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) ez[j * Z] = e[j];
  }
}

// The flooding posterior (spa_pallas.py:466-471): L = X + sum of
// roll(E[slot], -s) in column-slot order, at positions wi, wi + nw, ... of
// the codeword; X is read from its row xr of device memory (negated into
// log(p0/p1)), four positions' loads issued together.
__device__ __forceinline__ void flood_posterior(const Loop& P, float* Lc, const float* Ec,
                                                const float* xr, int wi, int nw) {
  const int Z = P.Z, n = P.n, dq = nw / Z, dr = nw - dq * Z;
  int col = wi / Z, zz = wi - col * Z;
  for (int pos0 = wi; pos0 < n; pos0 += 4 * nw) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = pos0 + u * nw;
      x[u] = pos < n ? __ldg(xr + pos) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = pos0 + u * nw;
      if (pos < n) {
        float acc = -x[u];
        for (int q = P.col_off[col]; q < P.col_off[col + 1]; ++q)
          acc = acc + Ec[P.col_slot[q] * Z + wrap(zz - P.col_shift[q], Z)];
        Lc[pos] = acc;
      }
      col += dq;
      zz += dr;
      if (zz >= Z) {
        zz -= Z;
        ++col;
      }
    }
  }
}

// make_decode_loop (spa_pallas.py:176-574), layered or (FLOOD) flooding, in
// place on the block's L [cpg][Ls] and E [cpg][e_slots * Z] (D: the
// multi-diagonal deltas, [cpg][R * DMAX * Z]); b0 is the block's first
// codeword. A codeword runs from its entry in s_done until it passes a
// syndrome check or the budget ends; the block leaves the loop when all its
// codewords have (a block-uniform test: the state comes out of the same
// barrier reduction or warp vote on every thread). NORM counts the flip
// metric per check window. Each codeword's leader then writes s_done /
// s_conv (/ s_norm) and folds its trips into s_iters (their max).
template <int DMAX, bool FLOOD, bool NORM>
__device__ void decode_group(const Loop& P, float* L, float* E, float* D, int b0) {
  const int Z = P.Z, R = P.R, RZ = R * Z, cpg = P.cpg, n = P.n;
  const Lanes T = lanes_of(P);
  float* Lc = L + T.c * P.Ls;
  float* Ec = E + T.c * P.e_slots * Z;
  float* Dc = D + T.c * R * DMAX * Z;
  const size_t row = (size_t)(b0 + T.c) * n;  // the codeword's row of [B][n] arrays
  const unsigned short* goff = P.goff;
  bool done = (cpg > 1 && !T.on) ? true : s_done[T.c] != 0;
  int conv = -1, trips = 0, it = 0;
  float nrm = 0.0f;
  while (it < P.max_it && (cpg == 1 ? !done : __any_sync(0xffffffffu, !done))) {
    // `active` is fixed for the whole check window (spa_pallas.py:527-529)
    const bool live = !done, active = T.on && live;
    for (int step = 0; step < P.check_every; ++step) {
      if (FLOOD) {
        // spa_pallas.py:453-471: every check row from roll(L) - E, then
        // every posterior from X and E
        if (active) {
          for (int bi = T.r; bi < P.mb; bi += R) flood_check_row<DMAX>(P, Lc, Ec, bi, T.z);
        }
        __syncthreads();
        if (T.wide && live) flood_posterior(P, Lc, Ec, P.xg + row, T.wi, T.nw);
        __syncthreads();
        continue;
      }
      for (int g = 0; g < P.ngroups; ++g) {
        const int bi = active ? P.groups[g * R + T.r] : -1;
        int off = 0, d = 0;
        bool dup = false;
        if (bi >= 0) {
          off = P.row_off[bi];
          d = P.row_off[bi + 1] - off;
          dup = P.row_dup[bi] != 0;
          const unsigned short* gz = goff + off * Z + T.z;  // slot j's offset at gz[j * Z]
          float* ez = Ec + off * Z + T.z;                      // slot j's E at ez[j * Z]
          float m[DMAX], e[DMAX];
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) m[j] = Lc[gz[j * Z]] - ez[j * Z];
          }
          check_update<DMAX>(m, e, d, P.variant, P.alpha, P.beta);
          // the offsets are read again rather than held through the update
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) {
              const int li = gz[j * Z];
              if (dup) {
                // the delta lands at the position it updates
                Dc[(T.r * DMAX + j) * Z + li - P.slot_col[off + j] * Z] = e[j] - ez[j * Z];
              } else {
                Lc[li] = m[j] + e[j];
              }
              ez[j * Z] = e[j];
            }
          }
        }
        if (P.grp_dup[g]) {
          // multi-diagonal row: after every read of L, add each base column's
          // deltas (summed in slot order) at this thread's position z
          __syncthreads();
          if (bi >= 0 && dup) {
            for (int j = 0; j < d; ++j) {
              const int col = P.slot_col[off + j];
              bool first = true;
              for (int jj = 0; jj < j; ++jj) first &= P.slot_col[off + jj] != col;
              if (!first) continue;
              float acc = 0.0f;
              for (int jj = j; jj < d; ++jj) {
                if (P.slot_col[off + jj] != col) continue;
                const float dv = Dc[(T.r * DMAX + jj) * Z + T.z];
                acc = (jj == j) ? dv : acc + dv;
              }
              Lc[col * Z + T.z] = Lc[col * Z + T.z] + acc;
            }
          }
        }
        __syncthreads();
      }
    }
    // syndrome of the window's last sweep (exact rule: bit = L < 0)
    bool unsat = false;
    if (active) {
      for (int bi = T.r; bi < P.mb; bi += R) {
        const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
        int par = 0;
        for (int j = 0; j < d; ++j) par ^= Lc[goff[(off + j) * Z + T.z]] < 0.0f;
        unsat |= par != 0;
      }
    }
    // the flip metric (spa_pallas.py:437-446): over the info bits, the
    // count of (|L| <= 7) & (prior * L < 0), as an integer; then prior = L
    int cnt = 0;
    if (NORM && T.wide && live) {
      float* pr = P.prior + row;
      for (int pos = T.wi; pos < n; pos += T.nw) {
        if (P.info_mask[pos]) {
          const float l = Lc[pos];
          cnt += (fabsf(l) <= LLR_WINDOW && pr[pos] * l < 0.0f) ? 1 : 0;
          pr[pos] = l;
        }
      }
    }
    bool bad;
    if (cpg == 1) {
      if (NORM) {
        const int w = __reduce_add_sync(0xffffffffu, cnt);
        if ((threadIdx.x & 31) == 0) s_flips[threadIdx.x >> 5] = w;
      }
      bad = __syncthreads_or(unsat) != 0;
      if (NORM && threadIdx.x == 0 && live) {
        int flips = 0;
        for (int w = 0; w < P.tpg / 32; ++w) flips += s_flips[w];
        nrm = (float)flips / P.kf;
      }
    } else {
      // the block is one warp; each codeword its own R*Z lanes
      const unsigned mask = __ballot_sync(0xffffffffu, unsat);
      bad = T.on && ((mask >> (T.k * RZ)) & ((1u << RZ) - 1u)) != 0u;
      if (NORM) {
        for (int q = 0; q < cpg; ++q) {
          const int flips = __reduce_add_sync(0xffffffffu, T.k == q ? cnt : 0);
          if (T.k == q && active) nrm = (float)flips / P.kf;
        }
      }
      // the block's barrier (its one warp): every read of L above before the
      // next window's writes
      __syncthreads();
    }
    if (live && !bad) {
      done = true;
      conv = it + P.check_every - 1;  // the check iteration
    }
    it += P.check_every;
    if (live) trips = it;
  }
  if (T.on && T.rz == 0) {
    s_done[T.c] = done ? 1 : 0;
    s_conv[T.c] = conv;
    if (NORM) s_norm[T.c] = nrm;
    atomicMax(&s_iters, trips);
  }
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform01(unsigned w) {
  return (float)(int)(w >> 8) * U24 + HALF_U24;
}

// mc_pallas.py:82-120: 48-bit radial uniform, cos to the first normal and
// sin to the second.
__device__ __forceinline__ void box_muller2(unsigned hi, unsigned lo, unsigned ang_w,
                                            float& z0, float& z1) {
  const float h = (float)(int)(hi >> 8), l = (float)(int)(lo >> 8);
  const float u1 = fminf(h * U24 + (l * U48 + HALF_U48), ONE_MINUS_U24);
  const float u2 = uniform01(ang_w);
  const float rad = sqrtf(-2.0f * logf(u1));
  const float ang = TWO_PI_F * u2;
  z0 = rad * cosf(ang);
  z1 = rad * sinf(ang);
}

// Count info-bit mismatches of the decisions against the sent word
// (lane-fastest: thread tid serves codeword lane = tid % cpg at item
// tid / cpg) and write the block's per-lane outputs (a pre-done lane counts
// 0 errors; `iters` is the block's trips).
__device__ void finish(const Loop& P, const float* L, const float* w, int lane, int item0,
                       int nitems, int b, bool valid, int* err, unsigned char* ok, int* conv,
                       float* norm, int* iters) {
  int cnt = 0;
  if (valid && !s_pre[lane]) {
    for (int pos = item0; pos < P.n; pos += nitems) {
      if (P.info_mask[pos]) {
        const bool est = L[lane * P.Ls + pos] < 0.0f;
        const bool x = w[(size_t)pos * P.B + b] != 0.0f;
        cnt += est != x;
      }
    }
  }
  if (cnt) atomicAdd(&s_err[lane], cnt);
  __syncthreads();
  if (threadIdx.x < P.cpg && valid) {
    err[b] = s_err[lane];
    ok[b] = s_done[lane] ? 1 : 0;
    conv[b] = s_conv[lane];
    norm[b] = 0.0f;  // the fused kernels do not count the flip metric
    iters[b] = s_iters;
  }
}

// The shared-memory arrays of a block: L, E, D, then the tables.
struct Smem {
  float *L, *E, *D;
  int* tables;
};

template <int DMAX>
__device__ __forceinline__ Smem block_smem(const Loop& P, float* smem) {
  Smem S;
  S.L = smem;
  S.E = S.L + P.cpg * P.Ls;
  S.D = S.E + P.cpg * P.e_slots * P.Z;
  S.tables = reinterpret_cast<int*>(S.D + (P.has_dup ? P.cpg * P.R * DMAX * P.Z : 0));
  return S;
}

template <int DMAX>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
mc_decoder_kernel(Loop P, const int* tab, const float* w, const unsigned* raw, const float* consts,
                  int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                  float* llr_out, int mode, float amp, int noise_input, unsigned key0,
                  unsigned key1, int skip) {
  extern __shared__ float smem[];
  const Smem S = block_smem<DMAX>(P, smem);
  stage_tables(P, tab, S.tables);
  const int cpg = P.cpg, Z = P.Z, n = P.n, B = P.B;
  const int tid = threadIdx.x, lane = tid % cpg, item0 = tid / cpg, nitems = blockDim.x / cpg;
  const int b = blockIdx.x * cpg + lane;
  const bool valid = b < B;
  if (tid < cpg) {
    s_done[tid] = (skip || !valid) ? 1 : 0;
    s_pre[tid] = 0;
    s_conv[tid] = -1;
    s_err[tid] = 0;
  }
  if (tid == 0) s_iters = 0;
  for (int i = tid; i < cpg * P.e_slots * Z; i += blockDim.x) S.E[i] = 0.0f;
  const float c_noise1 = consts[0], c_scale = consts[1], c_s1 = consts[2], c_s2 = consts[3];
  const float c_lc1 = consts[4], c_lc2 = consts[5], c_lc3 = consts[6], c_p = consts[7];
  float* Ll = S.L + lane * P.Ls;

  // channel_fill (mc_pallas.py:253-293): base columns 2p and 2p+1 share one
  // draw triple per normal, from column 2p's planes
  auto channel = [&](int col, int zz, float za, float zb, unsigned jam_w) {
    const size_t pos = (size_t)col * Z + zz;
    const float sym = (2.0f * w[pos * B + b] - 1.0f) * amp;
    float llr;
    if (mode == 1) {
      llr = -(c_scale * (sym + c_noise1 * za));
    } else {
      const float n1 = c_s1 * za, n2 = c_s2 * zb;
      if (mode == 2) {
        llr = -(uniform01(jam_w) < c_p ? (sym + n1 + n2) * c_lc2 : (sym + n1) * c_lc1);
      } else {
        llr = -(((sym + n1 + n2) * c_p + (sym + n1) * (1.0f - c_p)) * c_lc3);
      }
    }
    Ll[pos] = llr;
    if (llr_out) llr_out[pos * B + b] = llr;
  };
  if (valid) {
    const int npairs = (P.nb + 1) / 2;
    const size_t nB = (size_t)n * B;
    for (int item = item0; item < npairs * Z; item += nitems) {
      const int p = item / Z, zz = item - p * Z, c0 = 2 * p, c1 = c0 + 1;
      const bool has1 = c1 < P.nb;
      unsigned a0, a1, a2, b0 = 0, b1 = 0, b2 = 0, j0 = 0, j1 = 0;
      if (noise_input) {
        const size_t at = ((size_t)c0 * Z + zz) * B + b;
        a0 = raw[at];
        a1 = raw[nB + at];
        a2 = raw[2 * nB + at];
        if (mode != 1) {
          b0 = raw[3 * nB + at];
          b1 = raw[4 * nB + at];
          b2 = raw[5 * nB + at];
        }
        if (mode == 2) {
          j0 = raw[6 * nB + at];
          if (has1) j1 = raw[6 * nB + ((size_t)c1 * Z + zz) * B + b];
        }
      } else {
        // Philox words laid out as ldpc_tpu_torch/ops/mc_kernels.py philox_raw
        const uint2 key = make_uint2(key0, key1);
        const uint4 x = philox4x32_10(make_uint4((unsigned)b, (unsigned)item, 0u, 0u), key);
        a0 = x.x;
        a1 = x.y;
        a2 = x.z;
        j0 = x.w;
        if (mode != 1) {
          const uint4 y = philox4x32_10(make_uint4((unsigned)b, (unsigned)item, 1u, 0u), key);
          b0 = y.x;
          b1 = y.y;
          b2 = y.z;
          j1 = y.w;
        }
      }
      float za0, za1, zb0 = 0.0f, zb1 = 0.0f;
      box_muller2(a0, a1, a2, za0, za1);
      if (mode != 1) box_muller2(b0, b1, b2, zb0, zb1);
      channel(c0, zz, za0, zb0, j0);
      if (has1) channel(c1, zz, za1, zb1, j1);
    }
  }
  __syncthreads();
  decode_group<DMAX, false, false>(P, S.L, S.E, S.D, blockIdx.x * cpg);
  __syncthreads();
  finish(P, S.L, w, lane, item0, nitems, b, valid, err, ok, conv, norm, iters);
}

template <int DMAX>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
llr_decoder_kernel(Loop P, const int* tab, const float* llr, const float* w, const float* done0,
                   int* err, unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ float smem[];
  const int cpg = P.cpg, B = P.B;
  const int tid = threadIdx.x, lane = tid % cpg, item0 = tid / cpg, nitems = blockDim.x / cpg;
  const int b = blockIdx.x * cpg + lane;
  const bool valid = b < B;
  if (tid < cpg) {
    s_done[tid] = (!valid || done0[b] > 0.5f) ? 1 : 0;
    s_pre[tid] = s_done[tid];
    s_conv[tid] = -1;
    s_err[tid] = 0;
  }
  if (tid == 0) s_iters = 0;
  __syncthreads();
  bool all_pre = true;
  for (int l = 0; l < cpg; ++l) all_pre &= s_pre[l] != 0;
  if (all_pre) {  // a block of placeholders (the split's converged tail)
    if (tid < cpg && valid) {
      err[b] = 0;
      ok[b] = 1;
      conv[b] = -1;
      norm[b] = 0.0f;
      iters[b] = 0;
    }
    return;
  }
  const Smem S = block_smem<DMAX>(P, smem);
  stage_tables(P, tab, S.tables);
  for (int i = tid; i < cpg * P.e_slots * P.Z; i += blockDim.x) S.E[i] = 0.0f;
  // pre-done lanes are placeholders: their LLRs are never read
  if (valid && !s_pre[lane]) {
    for (int pos = item0; pos < P.n; pos += nitems)
      S.L[lane * P.Ls + pos] = llr[(size_t)pos * B + b];
  }
  __syncthreads();
  decode_group<DMAX, false, false>(P, S.L, S.E, S.D, blockIdx.x * cpg);
  __syncthreads();
  finish(P, S.L, w, lane, item0, nitems, b, valid, err, ok, conv, norm, iters);
}

// spa_pallas.py:686-708: decode the channel LLRs ``llr`` [B, n] (LLR > 0 <=>
// bit 1, negated on load into log(p0/p1)), then write the hard decisions
// est [B, n] (1 <=> L < 0, frozen per codeword at its convergence) and the
// per-codeword ok / conv / norm / iters. ``skip`` pre-marks every codeword
// done. The block's nv codewords are adjacent rows of llr and est: the block
// reads and writes one contiguous range of nv * n words.
template <int DMAX, bool FLOOD, bool NORM>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
qc_decoder_kernel(Loop P, const int* tab, const float* llr, int skip, unsigned char* est,
                  unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ float smem[];
  const Smem S = block_smem<DMAX>(P, smem);
  stage_tables(P, tab, S.tables);
  const int cpg = P.cpg, n = P.n, tid = threadIdx.x, b0 = blockIdx.x * cpg;
  const int nv = min(cpg, P.B - b0);  // codewords of this block in the batch
  if (tid < cpg) {
    s_done[tid] = (skip || tid >= nv) ? 1 : 0;
    s_conv[tid] = -1;
    s_norm[tid] = 0.0f;
  }
  if (tid == 0) s_iters = 0;
  for (int i = tid; i < cpg * P.e_slots * P.Z; i += blockDim.x) S.E[i] = 0.0f;
  const size_t base = (size_t)b0 * n;
  for (int i = tid; i < nv * n; i += blockDim.x) {
    const int q = cpg == 1 ? 0 : i / n, pos = i - q * n;
    const float v = -llr[base + i];
    S.L[q * P.Ls + pos] = v;
    if (NORM && P.info_mask[pos]) P.prior[base + i] = v;
  }
  __syncthreads();
  decode_group<DMAX, FLOOD, NORM>(P, S.L, S.E, S.D, b0);
  __syncthreads();
  for (int i = tid; i < nv * n; i += blockDim.x) {
    const int q = cpg == 1 ? 0 : i / n, pos = i - q * n;
    est[base + i] = S.L[q * P.Ls + pos] < 0.0f ? 1 : 0;
  }
  if (tid < nv) {
    ok[b0 + tid] = s_done[tid] ? 1 : 0;
    conv[b0 + tid] = s_conv[tid];
    norm[b0 + tid] = s_norm[tid];
    iters[b0 + tid] = s_iters;
  }
}

// kernel kinds of the entry points and the occupancy query
constexpr int K_MC = 0, K_LLR = 1, K_QC = 2;

template <int D>
const void* kernel_at(int kind, bool flood, bool norm) {
  switch (kind) {
    case K_MC:
      return (const void*)mc_decoder_kernel<D>;
    case K_LLR:
      return (const void*)llr_decoder_kernel<D>;
    case K_QC:
      return flood ? (norm ? (const void*)qc_decoder_kernel<D, true, true>
                           : (const void*)qc_decoder_kernel<D, true, false>)
                   : (norm ? (const void*)qc_decoder_kernel<D, false, true>
                           : (const void*)qc_decoder_kernel<D, false, false>);
    default:
      return nullptr;
  }
}

// The kernel of `kind` instantiated for row degrees up to dmax (8, 16, 32).
const void* kernel_of(int kind, int dmax, bool flood, bool norm) {
  switch (dmax) {
    case 8:
      return kernel_at<8>(kind, flood, norm);
    case 16:
      return kernel_at<16>(kind, flood, norm);
    case 32:
      return kernel_at<32>(kind, flood, norm);
    default:
      return nullptr;
  }
}

Loop make_loop(const int* tab, int n, int Z, int nb, int mb, int e_slots, int ngroups, int R, int B,
               int max_it, int check_every, int variant, float alpha, float beta, int has_dup,
               int cpg, int tpg, int Ls) {
  Loop P = {};
  P.row_off = tab;  // replaced by the shared-memory copies in-kernel
  P.n = n;
  P.Z = Z;
  P.nb = nb;
  P.mb = mb;
  P.e_slots = e_slots;
  P.ngroups = ngroups;
  P.R = R;
  P.B = B;
  P.max_it = max_it;
  P.check_every = check_every;
  P.variant = variant;
  P.alpha = alpha;
  P.beta = beta;
  P.has_dup = has_dup;
  P.kf = 1.0f;
  P.cpg = cpg;
  P.tpg = tpg;
  P.Ls = Ls;
  return P;
}

// Dynamic shared memory of a block: L, E (and the multi-diagonal deltas)
// per codeword, then the tables with the gather offsets.
size_t smem_bytes(const Loop& P, int dmax) {
  const size_t floats = (size_t)P.cpg * (P.Ls + (size_t)P.e_slots * P.Z +
                                         (P.has_dup ? (size_t)P.R * dmax * P.Z : 0));
  return 4 * (floats + table_len(P));
}

// A plan the kernels can run: 1, 2, 4 or 8 codewords per block, whole warps
// holding their codewords' R*Z threads each, one warp where codewords share
// it (the warp vote of decode_group); at most MAX_THREADS threads; an L
// stride of at least n; positions that fit the uint16 gather offsets; no
// layer groups or multi-diagonal deltas under flooding; and `smem`, the
// caller's size, equal to the layout's.
bool bad_plan(const Loop& P, int dmax, int smem) {
  const int cpg = P.cpg, tpg = P.tpg;
  return cpg < 1 || cpg > MAX_CPG || (cpg & (cpg - 1)) || P.R < 1 || P.R > 2 || P.mb < 1 ||
         tpg < 32 || tpg % 32 || tpg > MAX_THREADS || cpg * P.R * P.Z > tpg ||
         (cpg > 1 && tpg != 32) || P.Ls < P.n || P.n > 65535 || P.B < 0 ||
         (P.flood && (P.has_dup || P.ngroups)) || kernel_of(K_MC, dmax, false, false) == nullptr ||
         smem != (long long)smem_bytes(P, dmax);
}

// Launch `kernel` over the plan's blocks with the kernel's arguments `args`
// (pointers to each, P first).
cudaError_t launch(const void* kernel, const Loop& P, int dmax, int device, void* stream,
                   void** args) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(P, dmax);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.cpg - 1) / P.cpg), block(P.tpg);
  e = cudaLaunchKernel(kernel, grid, block, args, smem, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int mc_decoder_launch(const float* w, const unsigned* raw, const float* consts,
                                 int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                                 float* llr_out, const int* tab, int n, int Z, int nb, int mb,
                                 int e_slots, int ngroups, int R, int B, int max_it,
                                 int check_every, int variant, float alpha, float beta, int dmax,
                                 int has_dup, int cpg, int tpg, int Ls, int smem, int mode,
                                 float amp, int noise_input, unsigned key0, unsigned key1,
                                 int skip, int device, void* stream) {
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, B, max_it, check_every, variant,
                     alpha, beta, has_dup, cpg, tpg, Ls);
  if (bad_plan(P, dmax, smem) || (noise_input && raw == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  void* args[] = {&P,    &tab,     &w,    &raw, &consts,      &err, &ok,  &conv, &norm,
                  &iters, &llr_out, &mode, &amp, &noise_input, &key0, &key1, &skip};
  return launch(kernel_of(K_MC, dmax, false, false), P, dmax, device, stream, args);
}

extern "C" int llr_decoder_launch(const float* llr, const float* w, const float* done0,
                                  int* err, unsigned char* ok, int* conv, float* norm,
                                  int* iters, const int* tab, int n, int Z, int nb, int mb,
                                  int e_slots, int ngroups, int R, int B, int max_it,
                                  int check_every, int variant, float alpha, float beta,
                                  int dmax, int has_dup, int cpg, int tpg, int Ls, int smem,
                                  int device, void* stream) {
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, B, max_it, check_every, variant,
                     alpha, beta, has_dup, cpg, tpg, Ls);
  if (bad_plan(P, dmax, smem)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  void* args[] = {&P, &tab, &llr, &w, &done0, &err, &ok, &conv, &norm, &iters};
  return launch(kernel_of(K_LLR, dmax, false, false), P, dmax, device, stream, args);
}

extern "C" int qc_decoder_launch(const float* llr, float* prior, unsigned char* est,
                                 unsigned char* ok, int* conv, float* norm, int* iters,
                                 const int* tab, int n, int Z, int nb, int mb, int e_slots,
                                 int ngroups, int R, int B, int max_it, int check_every,
                                 int variant, float alpha, float beta, int dmax, int has_dup,
                                 int cpg, int tpg, int Ls, int smem, int flood, int track_norm,
                                 int k, int skip, int device, void* stream) {
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, B, max_it, check_every, variant,
                     alpha, beta, has_dup, cpg, tpg, Ls);
  P.flood = flood;
  P.xg = llr;
  P.prior = prior;
  P.kf = (float)(k > 1 ? k : 1);
  if (bad_plan(P, dmax, smem) || (track_norm && prior == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  void* args[] = {&P, &tab, &llr, &skip, &est, &ok, &conv, &norm, &iters};
  return launch(kernel_of(K_QC, dmax, flood != 0, track_norm != 0), P, dmax, device, stream,
                args);
}

// Resident blocks per SM of K1 (kind 0), K2 (1) or K3 (2; flooding, flip
// metric) at a block of `threads` threads and `smem` bytes of dynamic
// shared memory.
extern "C" int decoder_occupancy(int kind, int dmax, int flood, int norm, int threads, int smem,
                                 int* blocks) {
  const void* f = kernel_of(kind, dmax, flood != 0, norm != 0);
  if (f == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, threads, (size_t)smem);
}
