// The QC decode body shared by the three decode kernels for Hopper (sm_90a):
// K1 mc_decoder.cu, K2 llr_decoder.cu and K3 qc_decoder.cu, one translation
// unit and one library each (ops/build.py starts one nvcc per source).
//
// Replaces the body of three Pallas TPU kernels of the JAX package:
//   * ldpc_tpu/ops/spa_pallas.py make_decode_loop / make_check_update
//     (:126-574) -> decode_group, with check_update and exclusive_combine;
//     resolve_alpha_schedule / _sched_at / alpha_of (:70-123, :387-397) ->
//     alpha_of; the int8 E grid E_read / E_quantize / E_write (:107-112,
//     :365-385) -> EStore.
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
//      K1's one pass at codewords sharing a warp, over more than one wave of
//      blocks, instead refills a stopped codeword's lanes with the next
//      codeword (the Refill hook of decode_group, mc_decoder.cu), and
//      `iters` is a codeword's own trips.
//   2. No spills. __launch_bounds__(768, 1), the largest block any plan
//      launches, gives 80 registers a thread; the leave-one-out combine
//      keeps its suffixes and one running prefix (2 x DMAX values, not 4),
//      and the min-sum family folds signs to a parity and magnitudes to the
//      two smallest (exact in any order, so bit-equal to exclusive_combine).
//      The flooding schedule (FLOOD), the flip metric (NORM) and the int8 E
//      store (Q8) are template flags, compiled in only where used; Q8 bodies
//      hold the min-sum family alone (int8 E is refused for SPA).
//   3. Precomputed gathers. The L offset slot_col*Z + (z+shift) mod Z of
//      every (edge slot, z) is a uint16 table built on the host and staged
//      in shared memory; an edge reads one offset for its gather and again
//      for its write-back, and the syndrome check reads the same table.
//   4. Coalesced device memory. K1 / K2's [n, B] arrays are read and written
//      lane-fastest (a warp reads the block's adjacent codewords of one row;
//      L is padded per codeword so those lanes start in different banks).
//      K3's [B, n] arrays and the internal [B, n] rows (flooding's channel
//      LLRs, the flip metric's previous posteriors) are read and written
//      codeword-major: a block's codewords are adjacent rows.
// Multi-diagonal layers (CCSDS) stage each edge's extrinsic delta at the
// position it updates and add them per position after the block's barrier
// (the additive update of the reference).
//
// Flooding. Thread (r, z) runs the check phase of base rows r, r+R, ... at
// check row z (R = 2 where the code has 2 rows); after the barrier, every
// thread of the block, padding included, runs the posterior phase at
// positions t, t+threads, ... (where codewords share a warp, a codeword's
// own R*Z threads), summing in column-slot order; then a barrier. Every
// sweep restarts the posteriors from the channel LLRs X, kept in the channel
// sign convention (LLR > 0 <=> bit 1, negated on read). Where X lives: K3
// reads its own input row [B][n]; K1 (which makes X in its channel fill) and
// K2 (which receives X as [n][B], strided by B along a codeword) write each
// codeword's X once (stage_x) into an internal [B][n] row in device memory,
// read back four positions' loads at a time (the rows of the resident blocks
// stay in L1 / L2). The shared memory of one codeword is L + E + the gather
// table + the tables, 4n + 4 e_slots Z + 2 e_slots Z + about 1.4 KB: 27,912
// B at WiMAX 1152 and 213,384 B at n=9216 (Z=384, 76 edge slots). X in
// shared memory would add 4n B a codeword: at 1152 it cost 8 -> 6 blocks/SM
// and 8% of K1's time (PERF.md), at n=9216 it exceeds the 232,448 B of a
// block.
//
// int8 E (Q8). E holds levels q in [-127, 127] of the grid q * E_SCALE over
// [-24, 24] (e_slots Z bytes a codeword, against 4 e_slots Z): read as
// (float)q * E_SCALE, written as rintf(clip(e) * E_INV) (round half to even,
// as jnp.round; roundf would round half away from zero), and the posteriors
// are updated from the quantized value, so roll(L) - E reproduces the
// messages. What follows E in shared memory starts on a 16-byte boundary.
//
// Alpha schedules. A normalized min-sum alpha per sweep: atab [T][D] in
// device memory, row class acls[bi] (a [T] schedule is D = 1), the value at
// sweep it is atab[min(it, T-1)][acls[bi]], each entry cast to f32 once on
// the host; a null atab keeps the scalar alpha.
//
// The flip metric (NORM). After each check window every live codeword
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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CPG = 8;  // codewords per block
constexpr float TANH_IN_CLIP = 17.5f;
constexpr float PROD_CLIP = 0x1.fffffep-1f;  // largest float below 1
constexpr float LLR_WINDOW = 7.0f;           // normalized-LLR confidence window
// the int8 grid (spa_pallas.py:111-112): f32(24 / 127) and f32(127 / 24),
// each rounded once from float64 (decode_loop.py E_SCALE_F32 / E_INV_F32)
constexpr float E_CLIP = 24.0f;
constexpr float E_SCALE = 0x1.83060cp-3f;
constexpr float E_INV = 0x1.52aaaap+2f;

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
  const float* atab;      // alpha schedule [aT][aD] (device memory), or null
  const int* acls;        // [mb] each base row's column of atab
  float* prior;           // the flip metric: previous posteriors [B][n]
  int n, Z, nb, mb, e_slots, ngroups, R, B;
  int max_it, check_every, variant;  // variant: 0 spa, 1 minsum, 2 nms, 3 oms
  float alpha, beta;
  int aT, aD;
  int has_dup, flood, int8, track_norm;
  float kf;       // info positions the flip metric divides by (at least 1)
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

// The extrinsic store: f32, or (Q8) the int8 level q of q * E_SCALE.
// get: the stored value as f32 (E_read); put: the value kept for extrinsic
// e, and its stored form (E_quantize, then E_write).
template <bool Q8>
struct EStore;

template <>
struct EStore<false> {
  using T = float;
  static __device__ __forceinline__ float get(T v) { return v; }
  static __device__ __forceinline__ float put(float e, T& q) {
    q = e;
    return e;
  }
};

template <>
struct EStore<true> {
  using T = signed char;
  static __device__ __forceinline__ float get(T v) { return (float)v * E_SCALE; }
  static __device__ __forceinline__ float put(float e, T& q) {
    const float l = rintf(fminf(fmaxf(e, -E_CLIP), E_CLIP) * E_INV);
    q = (signed char)l;
    return l * E_SCALE;
  }
};

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

// The normalized min-sum scale of base row bi at sweep `sweep`
// (spa_pallas.py alpha_of / _sched_at).
__device__ __forceinline__ float alpha_of(const Loop& P, int sweep, int bi) {
  if (P.atab == nullptr) return P.alpha;
  return __ldg(P.atab + min(sweep, P.aT - 1) * P.aD + __ldg(P.acls + bi));
}

// make_check_update (spa_pallas.py:126-173): messages m -> extrinsics e of
// base row bi at sweep `sweep`. MS: the min-sum family only (the SPA branch
// compiled out). The alpha is looked up only where normalized min-sum scales
// by it, so the other variants' steps carry no schedule lookup.
template <int DMAX, bool MS>
__device__ __forceinline__ void check_update(const float (&m)[DMAX], float (&e)[DMAX], int d,
                                             const Loop& P, int sweep, int bi) {
  const int variant = P.variant;
  if (!MS && variant == 0) {
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
  const float alpha = variant == 2 ? alpha_of(P, sweep, bi) : 0.0f, beta = P.beta;
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
template <int DMAX, bool Q8>
__device__ __forceinline__ void flood_check_row(const Loop& P, const float* Lc,
                                                typename EStore<Q8>::T* Ec, int bi, int z,
                                                int sweep) {
  using ES = EStore<Q8>;
  const int Z = P.Z;
  const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
  const unsigned short* gz = P.goff + off * Z + z;  // slot j's offset at gz[j * Z]
  typename ES::T* ez = Ec + off * Z + z;            // slot j's E at ez[j * Z]
  float m[DMAX], e[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) m[j] = Lc[gz[j * Z]] - ES::get(ez[j * Z]);
  }
  check_update<DMAX, Q8>(m, e, d, P, sweep, bi);
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) ES::put(e[j], ez[j * Z]);
  }
}

// The flooding posterior (spa_pallas.py:466-471): L = X + sum of
// roll(E[slot], -s) in column-slot order, at positions wi, wi + nw, ... of
// the codeword; X is read from the codeword's row xr (negated into
// log(p0/p1)), four positions' loads issued together. RO: xr is the kernel's
// read-only input (K3), read through the read-only cache; else the internal
// row the kernel wrote (K1, K2).
template <bool RO, bool Q8>
__device__ __forceinline__ void flood_posterior(const Loop& P, float* Lc,
                                                const typename EStore<Q8>::T* Ec,
                                                const float* xr, int wi, int nw) {
  using ES = EStore<Q8>;
  const int Z = P.Z, n = P.n, dq = nw / Z, dr = nw - dq * Z;
  int col = wi / Z, zz = wi - col * Z;
  for (int pos0 = wi; pos0 < n; pos0 += 4 * nw) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = pos0 + u * nw;
      x[u] = pos < n ? (RO ? __ldg(xr + pos) : xr[pos]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = pos0 + u * nw;
      if (pos < n) {
        float acc = -x[u];
        for (int q = P.col_off[col]; q < P.col_off[col + 1]; ++q)
          acc = acc + ES::get(Ec[P.col_slot[q] * Z + wrap(zz - P.col_shift[q], Z)]);
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

// The refill hook of decode_group, off: the block's codewords are its own
// until they stop (K1's refill is K1Refill in mc_decoder.cu).
struct NoRefill {
  static constexpr bool REFILL = false;
};

// make_decode_loop (spa_pallas.py:176-574), layered or (FLOOD) flooding, in
// place on the block's L [cpg][Ls] and E [cpg][e_slots * Z] (D: the
// multi-diagonal deltas, [cpg][R * DMAX * Z]; X: flooding's channel LLRs,
// the [B][n] row of the block's first codeword, read-only input where XRO,
// see flood_posterior); b0 is the block's first
// codeword. A codeword runs from its entry in s_done until it
// passes a syndrome check or the budget ends; the block leaves the loop when
// all its codewords have (a block-uniform test: the state comes out of the
// same barrier reduction or warp vote on every thread). NORM counts the flip
// metric per check window. Each codeword's leader then writes s_done /
// s_conv (/ s_norm) and folds its trips into s_iters (their max).
//
// Where Refill::REFILL (layered, codewords sharing the warp, no flip
// metric), each codeword's lane group keeps its own sweep count and budget,
// and at each check window's end, after the warp vote, rf->window_end
// finishes the codewords that stopped (converged or spent their budget) and
// gives their lanes the next codeword, or none; the warp runs while any of
// its lane groups holds one, and writes nothing to s_*.
template <int DMAX, bool FLOOD, bool NORM, bool Q8, bool XRO, class Refill = NoRefill>
__device__ void decode_group(const Loop& P, float* L, typename EStore<Q8>::T* E, float* D,
                             const float* X, int b0, Refill* rf = nullptr) {
  using ES = EStore<Q8>;
  using ET = typename ES::T;
  const int Z = P.Z, R = P.R, RZ = R * Z, cpg = P.cpg, n = P.n;
  const Lanes T = lanes_of(P);
  float* Lc = L + T.c * P.Ls;
  ET* Ec = E + T.c * P.e_slots * Z;
  float* Dc = D + T.c * R * DMAX * Z;
  const size_t row = (size_t)(b0 + T.c) * n;  // the codeword's row of [B][n] arrays
  const unsigned short* goff = P.goff;
  bool done = (cpg > 1 && !T.on) ? true : s_done[T.c] != 0;
  int conv = -1, trips = 0, it = 0;
  float nrm = 0.0f;
  while ((Refill::REFILL || it < P.max_it) &&
         (cpg == 1 ? !done : __any_sync(0xffffffffu, !done))) {
    // `active` is fixed for the whole check window (spa_pallas.py:527-529)
    const bool live = !done, active = T.on && live;
    for (int step = 0; step < P.check_every; ++step) {
      if (FLOOD) {
        // spa_pallas.py:453-471: every check row from roll(L) - E, then
        // every posterior from X and E
        if (active) {
          for (int bi = T.r; bi < P.mb; bi += R)
            flood_check_row<DMAX, Q8>(P, Lc, Ec, bi, T.z, it + step);
        }
        __syncthreads();
        if (T.wide && live)
          flood_posterior<XRO, Q8>(P, Lc, Ec, X + T.c * n, T.wi, T.nw);
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
          ET* ez = Ec + off * Z + T.z;                         // slot j's E at ez[j * Z]
          float m[DMAX], e[DMAX];
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) m[j] = Lc[gz[j * Z]] - ES::get(ez[j * Z]);
          }
          check_update<DMAX, Q8>(m, e, d, P, it + step, bi);
          // the offsets are read again rather than held through the update;
          // L takes the value E keeps (spa_pallas.py:504-523)
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) {
              const int li = gz[j * Z];
              ET q;
              const float ev = ES::put(e[j], q);
              if (dup) {
                // the delta lands at the position it updates
                Dc[(T.r * DMAX + j) * Z + li - P.slot_col[off + j] * Z] = ev - ES::get(ez[j * Z]);
              } else {
                Lc[li] = m[j] + ev;
              }
              ez[j * Z] = q;
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
    if constexpr (Refill::REFILL) {
      const bool stop = live && (done || it >= P.max_it);
      const bool next = rf->window_end(P, T, Lc, Ec, live, stop, done, conv, it);
      if (stop) {
        done = !next;
        conv = -1;
        it = 0;
      }
    }
  }
  if (!Refill::REFILL && T.on && T.rz == 0) {
    s_done[T.c] = done ? 1 : 0;
    s_conv[T.c] = conv;
    if (NORM) s_norm[T.c] = nrm;
    atomicMax(&s_iters, trips);
  }
}

// Flooding's channel LLRs X (channel sign, the block's rows of the internal
// [B][n] buffer) and the flip metric's first previous posteriors (the info
// positions), from the channel LLRs the block loaded into L, codeword-major
// (K1, K2: once, between the load and the decode, so that the load's loop
// carries neither row).
template <bool FLOOD, bool NORM>
__device__ __forceinline__ void stage_x(const Loop& P, const float* L, float* X, int b0) {
  const int n = P.n, nv = min(P.cpg, P.B - b0);
  for (int i = threadIdx.x; i < nv * n; i += blockDim.x) {
    const int q = P.cpg == 1 ? 0 : i / n, pos = i - q * n;
    const float v = L[q * P.Ls + pos];
    if (FLOOD) X[i] = -v;
    if (NORM && P.info_mask[pos]) P.prior[(size_t)(b0 + q) * n + pos] = v;
  }
}

// The shared-memory arrays of a block: L, E, then, from a 16-byte boundary
// where E is int8, D and the tables.
template <bool Q8>
struct Smem {
  float* L;
  typename EStore<Q8>::T* E;
  float* D;
  int* tables;
};

template <int DMAX, bool Q8>
__device__ __forceinline__ Smem<Q8> block_smem(const Loop& P, float* smem) {
  Smem<Q8> S;
  S.L = smem;
  S.E = reinterpret_cast<typename EStore<Q8>::T*>(S.L + P.cpg * P.Ls);
  size_t off = reinterpret_cast<char*>(S.E + P.cpg * P.e_slots * P.Z) -
               reinterpret_cast<char*>(smem);
  if (Q8) off = (off + 15) & ~(size_t)15;
  S.D = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + off);
  S.tables = reinterpret_cast<int*>(S.D + (P.has_dup ? P.cpg * P.R * DMAX * P.Z : 0));
  return S;
}

// The E store of a block zeroed (spa_pallas.py:545-547).
template <bool Q8>
__device__ __forceinline__ void zero_e(const Loop& P, typename EStore<Q8>::T* E) {
  for (int i = threadIdx.x; i < P.cpg * P.e_slots * P.Z; i += blockDim.x) E[i] = 0;
}

// K1 / K2's lane map: thread tid serves codeword lane = tid % cpg of the
// block at items tid / cpg, tid / cpg + nitems, ... (lane-fastest).
struct LaneMap {
  int lane, item0, nitems, b;
  bool valid;
};

__device__ __forceinline__ LaneMap lane_map(const Loop& P) {
  LaneMap M;
  M.lane = threadIdx.x % P.cpg;
  M.item0 = threadIdx.x / P.cpg;
  M.nitems = blockDim.x / P.cpg;
  M.b = blockIdx.x * P.cpg + M.lane;
  M.valid = M.b < P.B;
  return M;
}

// Count info-bit mismatches of the decisions in L against the sent word
// and write the block's per-lane outputs (a pre-done lane counts 0 errors
// and its flip metric 0; `iters` is the block's trips). K1 and K2; the lane
// map is computed anew here, so that it holds no register through the
// decode.
__device__ void finish(const Loop& P, const float* L, const float* w, int* err,
                       unsigned char* ok, int* conv, float* norm, int* iters) {
  const LaneMap M = lane_map(P);
  const int lane = M.lane, item0 = M.item0, nitems = M.nitems, b = M.b;
  const bool valid = M.valid;
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
    norm[b] = s_norm[lane];
    iters[b] = s_iters;
  }
}

// The kernel of K (a struct whose get<DMAX, FLOOD, NORM, Q8>() names one
// instantiation) for row degrees up to dmax (8, 16, 32) and the flags.
template <class K, int D, bool F, bool N>
const void* pick_q8(bool q8) {
  return q8 ? K::template get<D, F, N, true>() : K::template get<D, F, N, false>();
}

template <class K, int D, bool F>
const void* pick_norm(bool norm, bool q8) {
  return norm ? pick_q8<K, D, F, true>(q8) : pick_q8<K, D, F, false>(q8);
}

template <class K, int D>
const void* pick_flood(bool flood, bool norm, bool q8) {
  return flood ? pick_norm<K, D, true>(norm, q8) : pick_norm<K, D, false>(norm, q8);
}

template <class K>
const void* kernel_of(int dmax, bool flood, bool norm, bool q8) {
  switch (dmax) {
    case 8:
      return pick_flood<K, 8>(flood, norm, q8);
    case 16:
      return pick_flood<K, 16>(flood, norm, q8);
    case 32:
      return pick_flood<K, 32>(flood, norm, q8);
    default:
      return nullptr;
  }
}

Loop make_loop(const int* tab, int n, int Z, int nb, int mb, int e_slots, int ngroups, int R, int B,
               int max_it, int check_every, int variant, float alpha, float beta,
               const float* atab, const int* acls, int aT, int aD, int track_norm, int k,
               int flood, int int8, int has_dup, int cpg, int tpg, int Ls) {
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
  P.atab = atab;
  P.acls = acls;
  P.aT = aT;
  P.aD = aD;
  P.track_norm = track_norm;
  P.kf = (float)(k > 1 ? k : 1);
  P.flood = flood;
  P.int8 = int8;
  P.has_dup = has_dup;
  P.cpg = cpg;
  P.tpg = tpg;
  P.Ls = Ls;
  return P;
}

// Dynamic shared memory of a block: L per codeword, E, then from a 16-byte
// boundary where E is int8 the multi-diagonal deltas and the tables with the
// gather offsets (mc_kernels.py fused_smem_bytes).
size_t smem_bytes(const Loop& P, int dmax) {
  size_t head = 4 * (size_t)P.cpg * P.Ls + (size_t)P.cpg * P.e_slots * P.Z * (P.int8 ? 1 : 4);
  if (P.int8) head = (head + 15) & ~(size_t)15;
  if (P.has_dup) head += 4 * (size_t)P.cpg * P.R * dmax * P.Z;
  return head + 4 * (size_t)table_len(P);
}

// A plan the kernels can run: 1, 2, 4 or 8 codewords per block, whole warps
// holding their codewords' R*Z threads each, one warp where codewords share
// it (the warp vote of decode_group); at most MAX_THREADS threads; an L
// stride of at least n; positions that fit the uint16 gather offsets; no
// layer groups or multi-diagonal deltas under flooding; int8 E only for the
// min-sum family; an alpha
// schedule only for normalized min-sum; the flip metric only at a check
// every sweep and with its buffer; and `smem`, the caller's size, equal to
// the layout's.
bool bad_plan(const Loop& P, int dmax, int smem) {
  const int cpg = P.cpg, tpg = P.tpg;
  return cpg < 1 || cpg > MAX_CPG || (cpg & (cpg - 1)) || P.R < 1 || P.R > 2 || P.mb < 1 ||
         tpg < 32 || tpg % 32 || tpg > MAX_THREADS || cpg * P.R * P.Z > tpg ||
         (cpg > 1 && tpg != 32) || P.Ls < P.n || P.n > 65535 || P.B < 0 ||
         (P.flood && (P.has_dup || P.ngroups)) ||
         (P.int8 && P.variant == 0) ||
         (P.atab && (P.variant != 2 || P.acls == nullptr || P.aT < 1 || P.aD < 1)) ||
         (P.track_norm && (P.check_every != 1 || P.prior == nullptr)) ||
         (dmax != 8 && dmax != 16 && dmax != 32) || smem != (long long)smem_bytes(P, dmax);
}

// Launch `kernel` over the plan's blocks, or over `blocks` blocks where
// given (K1's refill), with the kernel's arguments `args` (pointers to
// each, P first).
cudaError_t launch(const void* kernel, const Loop& P, int dmax, int device, void* stream,
                   void** args, int blocks = 0) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(P, dmax);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks ? blocks : (P.B + P.cpg - 1) / P.cpg), block(P.tpg);
  e = cudaLaunchKernel(kernel, grid, block, args, smem, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Resident blocks per SM of `kernel` at a block of `threads` threads and
// `smem` bytes of dynamic shared memory.
int occupancy(const void* kernel, int threads, int smem, int* blocks) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, (size_t)smem);
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
