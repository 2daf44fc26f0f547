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
//     (:126-574) -> decode_group (K1, K2) and decode_block / flood_sweep
//     (K3), sharing check_update and exclusive_combine.
//
// What bounds them: a codeword's decode is a chain of dependent steps (a
// layer of the layered schedule, or the check then the posterior phase of a
// flooding sweep), each a gather along Z, a leave-one-out combine (tanh/log
// or min/sign) and a scatter, with a barrier between steps. Device-memory
// traffic is small (code bits or LLRs in; counters, decisions or LLRs out),
// so of the two bounds operations bind. On the H100 K1 and K2 are bound by
// instruction issue: SPA's tanhf / logf / division chains (about 5 issued
// instructions per census op on the bench frame's mix, which the K5 probe
// sustains at 6.9e12 census ops/s), with the step's shared-memory loads and
// its barrier on the critical path; no matrix product, so wgmma and TMA do
// not apply. What the card offers them: 227 KB of shared memory per block
// (228 KB per SM), 64K registers per SM and 16 named barriers per block.
//
// K1 / K2 design (PERF.md has the times of each point):
//   1. Per-codeword progress. The decode runs codeword-major: a codeword's
//      R*Z threads fill whole warps (padded to a multiple of 32), or, where
//      R*Z < 32, up to 8 codewords share one warp; each such barrier group
//      syncs on its own barrier (barrier 0 when the block is one group, a
//      named barrier `bar.sync 1+g, n` otherwise) and leaves the loop on a
//      warp-uniform test once its codewords pass the syndrome check (the
//      test is a barrier reduction, bar.red.or, or a warp vote). The block
//      plan (mc_kernels.py fused_plan) is one group per block: at the bench
//      code one codeword of 96 threads, 8 blocks resident per SM, so a
//      converged codeword frees its slot for the next block at once. `iters`
//      is the block's trips, the max over its codewords.
//   2. No spills. __launch_bounds__(768, 1), the largest block any plan
//      launches, gives 80 registers a thread; the leave-one-out combine
//      keeps its suffixes and one running prefix (2 x DMAX values, not 4),
//      and the min-sum family folds signs to a parity and magnitudes to the
//      two smallest (exact in any order, so bit-equal to exclusive_combine).
//   3. Precomputed gathers. The L offset slot_col*Z + (z+shift) mod Z of
//      every (edge slot, z) is a uint16 table built on the host and staged
//      in shared memory; an edge reads one offset for its gather and again
//      for its write-back, and the syndrome check reads the same table.
//   4. Coalesced device memory. Loads and stores (channel fill, K2's LLR
//      load, the error count) run lane-fastest: a warp reads lpb adjacent
//      codewords of one row; L is padded per codeword so those lanes start
//      in different banks.
// Multi-diagonal layers (CCSDS) stage each edge's extrinsic delta at the
// position it updates and add them per position after the group's barrier
// (the additive update of the reference).
//
// K3 keeps the first design until its own redesign: a block holds `lpb`
// codewords, L [n][lpb] and E [edge slots * Z][lpb] interleaved in shared
// memory (flooding also keeps the channel LLRs X there; the flip metric's
// previous posteriors stay in device memory), thread (r, z, lane) owns check
// row z of the r-th row of every layer group (flooding: of base rows r,
// r+R, ...), a block barrier between steps, and the block loops until all
// its codewords are done (decode_block / flood_sweep).
//
// In both designs a roll along Z is an indexed shared-memory read, and in a
// single-diagonal layer every posterior is read and written by one thread,
// so a layer needs no atomics; the rows of a paired group run in the same
// step. Every op is per codeword, so the outputs other than `iters` do not
// depend on the plan. Built with -fmad=false so each op rounds as the plain
// PyTorch version (ldpc_tpu_torch/ops/decode_loop.py, mc_kernels.py,
// qc_kernels.py) does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LPB = 8;
constexpr float TANH_IN_CLIP = 17.5f;
constexpr float PROD_CLIP = 0x1.fffffep-1f;  // largest float below 1
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float U24 = 0x1p-24f;
constexpr float HALF_U24 = 0x1p-25f;
constexpr float U48 = 0x1p-48f;
constexpr float HALF_U48 = 0x1p-49f;
constexpr float ONE_MINUS_U24 = 0x1.fffffep-1f;
constexpr float LLR_WINDOW = 7.0f;  // normalized-LLR confidence window

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
  const int* info_mask;   // [n] 1 at info-bit positions (device memory)
  float* prior;           // track_norm: [n, B] previous posteriors (device memory)
  int n, Z, nb, mb, e_slots, ngroups, R, lpb, B;
  int max_it, check_every, variant;  // variant: 0 spa, 1 minsum, 2 nms, 3 oms
  float alpha, beta;
  int has_dup, flood, track_norm;
  float kf;  // info positions the flip metric divides by (at least 1)
  // the fused kernels' layout (K1, K2; mc_kernels.py fused_plan, checked by bad_fused)
  const unsigned short* goff;  // [e_slots * Z] L offset of every (slot, z)
  int gathers;                 // the table holds goff
  int cpg, tpg;                // codewords per barrier group, threads per group
  int Ls;                      // L stride per codeword
};

// ints of the gather offsets (two uint16 per int)
__host__ __device__ inline int gather_words(const Loop& P) {
  return P.gathers ? (P.e_slots * P.Z + 1) / 2 : 0;
}

__host__ __device__ inline int table_len(const Loop& P) {
  return (P.mb + 1) + 2 * P.e_slots + P.ngroups * P.R + P.ngroups + P.mb +
         (P.flood ? (P.nb + 1) + 2 * P.e_slots : 0) + gather_words(P);
}

__shared__ int s_done[MAX_LPB];
__shared__ int s_unsat[MAX_LPB];
__shared__ int s_conv[MAX_LPB];
__shared__ int s_err[MAX_LPB];
__shared__ int s_pre[MAX_LPB];  // lane pre-marked done: no load, no count
__shared__ int s_flips[MAX_LPB];
__shared__ float s_norm[MAX_LPB];
__shared__ int s_iters;  // fused kernels: the block's trips (max over its codewords)

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

// One flooding sweep (spa_pallas.py:453-471): every base row's check update
// from roll(L) - E, written to E where the lane is active; after a barrier,
// every posterior L[bj] = X[bj] + sum of roll(E[slot], -s) in column-slot
// (edge) order.
template <int DMAX>
__device__ void flood_sweep(const Loop& P, float* L, float* E, const float* X, int lane,
                            int r, int z, bool active) {
  const int lpb = P.lpb, Z = P.Z;
  if (active) {
    for (int bi = r; bi < P.mb; bi += P.R) {
      const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
      float m[DMAX], e[DMAX];
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) {
          const int li = (P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane;
          m[j] = L[li] - E[((off + j) * Z + z) * lpb + lane];
        }
      }
      check_update<DMAX>(m, e, d, P.variant, P.alpha, P.beta);
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) E[((off + j) * Z + z) * lpb + lane] = e[j];
      }
    }
  }
  __syncthreads();
  if (active) {
    for (int pos = r * Z + z; pos < P.n; pos += P.R * Z) {
      const int col = pos / Z;
      float acc = X[pos * lpb + lane];
      for (int t = P.col_off[col]; t < P.col_off[col + 1]; ++t)
        acc = acc + E[(P.col_slot[t] * Z + wrap(z - P.col_shift[t], Z)) * lpb + lane];
      L[pos * lpb + lane] = acc;
    }
  }
  __syncthreads();
}

// make_decode_loop (spa_pallas.py:176-574), layered or (FLOOD) flooding
// schedule. L holds the channel LLRs (log(p0/p1)) on entry and the final
// posteriors on exit (flooding reads the channel LLRs from X on every sweep);
// s_done / s_conv (and s_norm when NORM and P.track_norm) hold each lane's
// state. NORM compiles the flip metric in (the standalone decoder only, so
// the fused kernels keep their registers). Returns the block's trip count.
template <int DMAX, bool FLOOD, bool NORM>
__device__ int decode_block(const Loop& P, float* L, float* E, float* D, const float* X,
                            int lane, int r, int z, bool valid) {
  const int lpb = P.lpb, Z = P.Z;
  for (int i = threadIdx.x; i < P.e_slots * Z * lpb; i += blockDim.x) E[i] = 0.0f;
  __syncthreads();
  int it = 0;
  for (;;) {
    bool live = false;
    for (int l = 0; l < lpb; ++l) live |= (s_done[l] == 0);
    if (!(it < P.max_it && live)) break;
    // `active` is fixed for the whole check window (spa_pallas.py:527-529)
    const bool active = valid && s_done[lane] == 0;
    for (int step = 0; step < P.check_every; ++step) {
      if (FLOOD) {
        flood_sweep<DMAX>(P, L, E, X, lane, r, z, active);
        continue;
      }
      for (int g = 0; g < P.ngroups; ++g) {
        const int bi = P.groups[g * P.R + r];
        const bool row_on = active && bi >= 0;
        int off = 0, d = 0;
        bool dup = false;
        if (row_on) {
          off = P.row_off[bi];
          d = P.row_off[bi + 1] - off;
          dup = P.row_dup[bi] != 0;
          float m[DMAX], e[DMAX];
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) {
              const int li = (P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane;
              m[j] = L[li] - E[((off + j) * Z + z) * lpb + lane];
            }
          }
          check_update<DMAX>(m, e, d, P.variant, P.alpha, P.beta);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) {
              const int ei = ((off + j) * Z + z) * lpb + lane;
              if (dup) {
                D[((r * DMAX + j) * Z + z) * lpb + lane] = e[j] - E[ei];
              } else {
                const int li = (P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane;
                L[li] = m[j] + e[j];
              }
              E[ei] = e[j];
            }
          }
        }
        if (P.grp_dup[g]) {
          // multi-diagonal row: after every read of L, add each base column's
          // deltas (summed in slot order) at this thread's position z
          __syncthreads();
          if (row_on && dup) {
            for (int j = 0; j < d; ++j) {
              const int col = P.slot_col[off + j];
              bool first = true;
              for (int jj = 0; jj < j; ++jj) first &= P.slot_col[off + jj] != col;
              if (!first) continue;
              float acc = 0.0f;
              for (int jj = j; jj < d; ++jj) {
                if (P.slot_col[off + jj] != col) continue;
                const float dv = D[((r * DMAX + jj) * Z + wrap(z - P.slot_shift[off + jj], Z)) * lpb + lane];
                acc = (jj == j) ? dv : acc + dv;
              }
              const int li = (col * Z + z) * lpb + lane;
              L[li] = L[li] + acc;
            }
          }
        }
        __syncthreads();
      }
    }
    // syndrome of the window's last sweep (exact rule: bit = L < 0)
    if (threadIdx.x < lpb) {
      s_unsat[threadIdx.x] = 0;
      if (NORM) s_flips[threadIdx.x] = 0;
    }
    __syncthreads();
    bool unsat = false;
    if (active) {
      for (int bi = r; bi < P.mb; bi += P.R) {
        const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
        int par = 0;
        for (int j = 0; j < d; ++j)
          par ^= L[(P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane] < 0.0f;
        unsat |= par != 0;
      }
    }
    if (unsat) s_unsat[lane] = 1;
    if (NORM && P.track_norm && active) {
      // flips = sum over info bits of (|L| <= 7) & (prior * L < 0), counted
      // as an integer; then prior = L (spa_pallas.py:437-446)
      const size_t b = (size_t)blockIdx.x * lpb + lane;
      int cnt = 0;
      for (int pos = r * Z + z; pos < P.n; pos += P.R * Z) {
        if (P.info_mask[pos]) {
          const float l = L[pos * lpb + lane];
          float* pr = P.prior + (size_t)pos * P.B + b;
          cnt += (fabsf(l) <= LLR_WINDOW && *pr * l < 0.0f) ? 1 : 0;
          *pr = l;
        }
      }
      if (cnt) atomicAdd(&s_flips[lane], cnt);
    }
    __syncthreads();
    if (threadIdx.x < lpb) {
      const int l = threadIdx.x;
      if (s_done[l] == 0) {
        if (NORM && P.track_norm) s_norm[l] = (float)s_flips[l] / P.kf;
        if (s_unsat[l] == 0) {
          s_conv[l] = it + P.check_every - 1;  // the check iteration
          s_done[l] = 1;
        }
      }
    }
    it += P.check_every;
    __syncthreads();
  }
  return it;
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

// ---- the fused kernels (K1, K2) ----
//
// Two thread maps. Loads and stores of device memory run lane-fastest:
// thread tid serves codeword lane = tid % lpb at item tid / lpb, so a warp
// reads lpb adjacent codewords of one row (whole 32-byte sectors at lpb=8).
// The decode runs codeword-major: barrier group gid = tid / tpg holds cpg
// codewords; thread t = tid % tpg holds slot k = t / (R*Z) of it, row
// r and position z. A group is one codeword over whole warps (R*Z >= 32,
// padded to a multiple of 32: the padding threads follow their codeword
// through every barrier), or cpg codewords sharing one warp (R*Z < 32).

// named barrier `id` (1..15) of `n` threads, a multiple of 32
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// named_sync that also returns whether `v` holds on any of the n threads
__device__ __forceinline__ bool named_any(int id, int n, bool v) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\tselp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"((int)v), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// The barrier of one codeword group. SOLO: the block is one group, which
// takes the block's barrier 0. Otherwise named barrier `id`: ptxas cannot
// tell which ids a register names, so it reserves all 16 for the block, and
// the occupancy query then allows at most 4 such blocks per SM (PERF.md); a
// SOLO block uses one barrier and is bound by its registers and shared
// memory alone.
template <bool SOLO>
__device__ __forceinline__ void group_sync(int id, int n) {
  if (SOLO) {
    __syncthreads();
  } else {
    named_sync(id, n);
  }
}

template <bool SOLO>
__device__ __forceinline__ bool group_any(int id, int n, bool v) {
  return SOLO ? __syncthreads_or(v) != 0 : named_any(id, n, v);
}

// The layered decode loop (spa_pallas.py:176-574) of this thread's barrier
// group, in place on its codewords' L [lpb][Ls] and E [lpb][e_slots * Z]
// (D: the multi-diagonal deltas, [lpb][R * DMAX * Z]). A codeword runs from
// its entry in s_done until it passes a syndrome check or the budget ends;
// the group leaves the loop when all its codewords have (a warp-uniform
// test: the group's state comes out of the same barrier reduction or warp
// vote on every thread). Each codeword's leader then writes its s_done /
// s_conv and folds its trips into the block's s_iters (their max).
template <int DMAX, bool SOLO>
__device__ void decode_group(const Loop& P, float* L, float* E, float* D) {
  const int Z = P.Z, R = P.R, RZ = R * Z, cpg = P.cpg, tpg = P.tpg;
  const int gid = threadIdx.x / tpg, t = threadIdx.x - gid * tpg, id = 1 + gid;
  const int k = t / RZ, rz = t - k * RZ, r = rz / Z, z = rz - r * Z;
  const bool on = k < cpg;  // holds a (row, z) of a codeword
  const int c = gid * cpg + (cpg == 1 ? 0 : (on ? k : 0));
  float* Lc = L + c * P.Ls;
  float* Ec = E + c * P.e_slots * Z;
  float* Dc = D + c * R * DMAX * Z;
  const unsigned short* goff = P.goff;
  bool done = (cpg > 1 && !on) ? true : s_done[c] != 0;
  int conv = -1, trips = 0, it = 0;
  while (it < P.max_it && (cpg == 1 ? !done : __any_sync(0xffffffffu, !done))) {
    // `active` is fixed for the whole check window (spa_pallas.py:527-529)
    const bool active = on && !done, live = !done;
    for (int step = 0; step < P.check_every; ++step) {
      for (int g = 0; g < P.ngroups; ++g) {
        const int bi = active ? P.groups[g * R + r] : -1;
        int off = 0, d = 0;
        bool dup = false;
        if (bi >= 0) {
          off = P.row_off[bi];
          d = P.row_off[bi + 1] - off;
          dup = P.row_dup[bi] != 0;
          const unsigned short* gz = goff + off * Z + z;  // slot j's offset at gz[j * Z]
          float* ez = Ec + off * Z + z;                      // slot j's E at ez[j * Z]
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
                Dc[(r * DMAX + j) * Z + li - P.slot_col[off + j] * Z] = e[j] - ez[j * Z];
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
          group_sync<SOLO>(id, tpg);
          if (bi >= 0 && dup) {
            for (int j = 0; j < d; ++j) {
              const int col = P.slot_col[off + j];
              bool first = true;
              for (int jj = 0; jj < j; ++jj) first &= P.slot_col[off + jj] != col;
              if (!first) continue;
              float acc = 0.0f;
              for (int jj = j; jj < d; ++jj) {
                if (P.slot_col[off + jj] != col) continue;
                const float dv = Dc[(r * DMAX + jj) * Z + z];
                acc = (jj == j) ? dv : acc + dv;
              }
              Lc[col * Z + z] = Lc[col * Z + z] + acc;
            }
          }
        }
        group_sync<SOLO>(id, tpg);
      }
    }
    // syndrome of the window's last sweep (exact rule: bit = L < 0)
    bool unsat = false;
    if (active) {
      for (int bi = r; bi < P.mb; bi += R) {
        const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
        int par = 0;
        for (int j = 0; j < d; ++j) par ^= Lc[goff[(off + j) * Z + z]] < 0.0f;
        unsat |= par != 0;
      }
    }
    bool bad;
    if (cpg == 1) {
      bad = group_any<SOLO>(id, tpg, unsat);
    } else {
      const unsigned mask = __ballot_sync(0xffffffffu, unsat);
      bad = on && ((mask >> (k * RZ)) & ((1u << RZ) - 1u)) != 0u;
    }
    if (live && !bad) {
      done = true;
      conv = it + P.check_every - 1;  // the check iteration
    }
    it += P.check_every;
    if (live) trips = it;
  }
  if (on && rz == 0) {
    s_done[c] = done ? 1 : 0;
    s_conv[c] = conv;
    atomicMax(&s_iters, trips);
  }
}

// Count info-bit mismatches of the decisions against the sent word
// (lane-fastest) and write the block's per-lane outputs (a pre-done lane
// counts 0 errors; `iters` is the block's trips).
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
  if (threadIdx.x < P.lpb && valid) {
    err[b] = s_err[lane];
    ok[b] = s_done[lane] ? 1 : 0;
    conv[b] = s_conv[lane];
    norm[b] = 0.0f;  // the normalized-LLR metric is not ported
    iters[b] = s_iters;
  }
}

// The shared-memory arrays of a fused block: L, E, D, then the tables.
struct FusedSmem {
  float *L, *E, *D;
  int* tables;
};

template <int DMAX>
__device__ __forceinline__ FusedSmem fused_smem(const Loop& P, float* smem) {
  FusedSmem S;
  S.L = smem;
  S.E = S.L + P.lpb * P.Ls;
  S.D = S.E + P.lpb * P.e_slots * P.Z;
  S.tables = reinterpret_cast<int*>(S.D + (P.has_dup ? P.lpb * P.R * DMAX * P.Z : 0));
  return S;
}

template <int DMAX, int MAXT, int MINB, bool SOLO>
__global__ void __launch_bounds__(MAXT, MINB)
mc_decoder_kernel(Loop P, const int* tab, const float* w, const unsigned* raw, const float* consts,
                  int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                  float* llr_out, int mode, float amp, int noise_input, unsigned key0,
                  unsigned key1, int skip) {
  extern __shared__ float smem[];
  const FusedSmem S = fused_smem<DMAX>(P, smem);
  stage_tables(P, tab, S.tables);
  const int lpb = P.lpb, Z = P.Z, n = P.n, B = P.B;
  const int tid = threadIdx.x, lane = tid % lpb, item0 = tid / lpb, nitems = blockDim.x / lpb;
  const int b = blockIdx.x * lpb + lane;
  const bool valid = b < B;
  if (tid < lpb) {
    s_done[tid] = (skip || !valid) ? 1 : 0;
    s_pre[tid] = 0;
    s_conv[tid] = -1;
    s_err[tid] = 0;
  }
  if (tid == 0) s_iters = 0;
  for (int i = tid; i < lpb * P.e_slots * Z; i += blockDim.x) S.E[i] = 0.0f;
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
  decode_group<DMAX, SOLO>(P, S.L, S.E, S.D);
  __syncthreads();
  finish(P, S.L, w, lane, item0, nitems, b, valid, err, ok, conv, norm, iters);
}

template <int DMAX, int MAXT, int MINB, bool SOLO>
__global__ void __launch_bounds__(MAXT, MINB)
llr_decoder_kernel(Loop P, const int* tab, const float* llr, const float* w, const float* done0,
                   int* err, unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ float smem[];
  const int lpb = P.lpb, B = P.B;
  const int tid = threadIdx.x, lane = tid % lpb, item0 = tid / lpb, nitems = blockDim.x / lpb;
  const int b = blockIdx.x * lpb + lane;
  const bool valid = b < B;
  if (tid < lpb) {
    s_done[tid] = (!valid || done0[b] > 0.5f) ? 1 : 0;
    s_pre[tid] = s_done[tid];
    s_conv[tid] = -1;
    s_err[tid] = 0;
  }
  if (tid == 0) s_iters = 0;
  __syncthreads();
  bool all_pre = true;
  for (int l = 0; l < lpb; ++l) all_pre &= s_pre[l] != 0;
  if (all_pre) {  // a block of placeholders (the split's converged tail)
    if (tid < lpb && valid) {
      err[b] = 0;
      ok[b] = 1;
      conv[b] = -1;
      norm[b] = 0.0f;
      iters[b] = 0;
    }
    return;
  }
  const FusedSmem S = fused_smem<DMAX>(P, smem);
  stage_tables(P, tab, S.tables);
  for (int i = tid; i < lpb * P.e_slots * P.Z; i += blockDim.x) S.E[i] = 0.0f;
  // pre-done lanes are placeholders: their LLRs are never read
  if (valid && !s_pre[lane]) {
    for (int pos = item0; pos < P.n; pos += nitems)
      S.L[lane * P.Ls + pos] = llr[(size_t)pos * B + b];
  }
  __syncthreads();
  decode_group<DMAX, SOLO>(P, S.L, S.E, S.D);
  __syncthreads();
  finish(P, S.L, w, lane, item0, nitems, b, valid, err, ok, conv, norm, iters);
}

// spa_pallas.py:686-708: decode the channel LLRs ``llr`` [B, n] (LLR > 0 <=>
// bit 1, negated on load into log(p0/p1)), then write the hard decisions
// est [B, n] (1 <=> L < 0, frozen per lane at its convergence) and the
// per-lane ok / conv / norm / iters. ``skip`` pre-marks every lane done.
template <int DMAX, bool FLOOD>
__global__ void __launch_bounds__(1024)
qc_decoder_kernel(Loop P, const int* tab, const float* llr, int skip, unsigned char* est,
                  unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ float smem[];
  const int lpb = P.lpb, Z = P.Z, n = P.n;
  float* L = smem;
  float* E = L + n * lpb;
  float* D = E + P.e_slots * Z * lpb;
  float* X = D + (P.has_dup ? P.R * DMAX * Z * lpb : 0);
  stage_tables(P, tab, reinterpret_cast<int*>(X + (FLOOD ? n * lpb : 0)));
  const int tid = threadIdx.x, lane = tid % lpb, rz = tid / lpb, r = rz / Z, z = rz % Z;
  const int b = blockIdx.x * lpb + lane;
  const bool valid = b < P.B;
  if (tid < lpb) {
    s_done[tid] = (skip || !valid) ? 1 : 0;
    s_conv[tid] = -1;
    s_norm[tid] = 0.0f;
  }
  if (valid) {
    for (int pos = rz; pos < n; pos += P.R * Z) {
      const float v = -llr[(size_t)b * n + pos];
      L[pos * lpb + lane] = v;
      if (FLOOD) X[pos * lpb + lane] = v;
      if (P.track_norm && P.info_mask[pos]) P.prior[(size_t)pos * P.B + b] = v;
    }
  }
  __syncthreads();
  const int it = decode_block<DMAX, FLOOD, true>(P, L, E, D, X, lane, r, z, valid);
  if (valid) {
    for (int pos = rz; pos < n; pos += P.R * Z)
      est[(size_t)b * n + pos] = L[pos * lpb + lane] < 0.0f ? 1 : 0;
  }
  if (tid < lpb && valid) {
    ok[b] = s_done[lane] ? 1 : 0;
    conv[b] = s_conv[lane];
    norm[b] = s_norm[lane];
    iters[b] = it;
  }
}

Loop make_loop(const int* tab, int n, int Z, int nb, int mb, int e_slots, int ngroups, int R,
               int lpb, int B, int max_it, int check_every, int variant, float alpha, float beta,
               int has_dup) {
  Loop P = {};
  P.row_off = tab;  // replaced by the shared-memory copies in-kernel
  P.n = n;
  P.Z = Z;
  P.nb = nb;
  P.mb = mb;
  P.e_slots = e_slots;
  P.ngroups = ngroups;
  P.R = R;
  P.lpb = lpb;
  P.B = B;
  P.max_it = max_it;
  P.check_every = check_every;
  P.variant = variant;
  P.alpha = alpha;
  P.beta = beta;
  P.has_dup = has_dup;
  P.kf = 1.0f;
  return P;
}

size_t smem_bytes(const Loop& P, int dmax) {
  size_t floats = (size_t)P.lpb * (P.n + (size_t)P.e_slots * P.Z +
                                   (P.has_dup ? (size_t)P.R * dmax * P.Z : 0) +
                                   (P.flood ? P.n : 0));
  return 4 * (floats + table_len(P));
}

// The fused kernels' block as the caller planned it
// (ldpc_tpu_torch/ops/mc_kernels.py fused_plan): barrier groups of cpg
// codewords and tpg threads, and the L stride Ls; bad_fused checks it.
Loop fused_loop(Loop P, int cpg, int tpg, int Ls) {
  P.cpg = cpg;
  P.tpg = tpg;
  P.Ls = Ls;
  P.gathers = 1;
  return P;
}

int fused_threads(const Loop& P) { return P.lpb / P.cpg * P.tpg; }

size_t fused_smem_bytes(const Loop& P, int dmax) {
  const size_t floats = (size_t)P.lpb * (P.Ls + (size_t)P.e_slots * P.Z +
                                         (P.has_dup ? (size_t)P.R * dmax * P.Z : 0));
  return 4 * (floats + table_len(P));
}

// Every fused block launches at most FUSED_MAX_THREADS threads (R * Z <= 768
// for every code the plan takes), and 768 resident threads per SM is what
// the shared memory of any plan allows at the bench code; the bound caps a
// thread at 80 registers, which keeps the DMAX=8 bodies out of local memory.
constexpr int FUSED_MAX_THREADS = 768, FUSED_MIN_BLOCKS = 1;

bool solo(const Loop& P) { return P.lpb == P.cpg; }

template <int DMAX>
cudaError_t launch_mc(const Loop& P, const int* tab, const float* w, const unsigned* raw,
                      const float* consts, int* err, unsigned char* ok, int* conv, float* norm,
                      int* iters, float* llr_out, int mode, float amp, int noise_input,
                      unsigned key0, unsigned key1, int skip, cudaStream_t stream) {
  auto kernel = solo(P) ? mc_decoder_kernel<DMAX, FUSED_MAX_THREADS, FUSED_MIN_BLOCKS, true>
                        : mc_decoder_kernel<DMAX, FUSED_MAX_THREADS, FUSED_MIN_BLOCKS, false>;
  const size_t smem = fused_smem_bytes(P, DMAX);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.lpb - 1) / P.lpb), block(fused_threads(P));
  kernel<<<grid, block, smem, stream>>>(P, tab, w, raw, consts, err, ok, conv, norm, iters,
                                        llr_out, mode, amp, noise_input, key0, key1, skip);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_llr(const Loop& P, const int* tab, const float* llr, const float* w,
                       const float* done0, int* err, unsigned char* ok, int* conv, float* norm,
                       int* iters, cudaStream_t stream) {
  auto kernel = solo(P) ? llr_decoder_kernel<DMAX, FUSED_MAX_THREADS, FUSED_MIN_BLOCKS, true>
                        : llr_decoder_kernel<DMAX, FUSED_MAX_THREADS, FUSED_MIN_BLOCKS, false>;
  const size_t smem = fused_smem_bytes(P, DMAX);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.lpb - 1) / P.lpb), block(fused_threads(P));
  kernel<<<grid, block, smem, stream>>>(P, tab, llr, w, done0, err, ok, conv, norm, iters);
  return cudaGetLastError();
}

template <int DMAX, bool FLOOD>
cudaError_t launch_qc(const Loop& P, const int* tab, const float* llr, int skip,
                      unsigned char* est, unsigned char* ok, int* conv, float* norm, int* iters,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(P, DMAX);
  cudaError_t e = cudaFuncSetAttribute(qc_decoder_kernel<DMAX, FLOOD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.lpb - 1) / P.lpb), block(P.lpb * P.R * P.Z);
  qc_decoder_kernel<DMAX, FLOOD><<<grid, block, smem, stream>>>(P, tab, llr, skip, est, ok, conv,
                                                                norm, iters);
  return cudaGetLastError();
}

bool bad_shape(int lpb, int R, int Z, int B) {
  return lpb < 1 || lpb > MAX_LPB || R < 1 || R > 2 || lpb * R * Z > 1024 || B < 0;
}

// A fused plan the kernels can run: 1, 2, 4 or 8 codewords in groups of a
// power of two; a group's threads whole warps holding its codewords' R*Z
// each, and one warp where codewords share it (the warp vote of
// decode_group); at most FUSED_MAX_THREADS threads; an L stride of at least
// n; positions that fit the uint16 gather offsets; and `smem`, the caller's
// size, equal to the layout's.
bool bad_fused(const Loop& P, int dmax, int smem) {
  const int lpb = P.lpb, cpg = P.cpg, tpg = P.tpg;
  return lpb < 1 || lpb > MAX_LPB || (lpb & (lpb - 1)) || cpg < 1 || (cpg & (cpg - 1)) ||
         lpb % cpg || P.R < 1 || P.R > 2 || tpg < 32 || tpg % 32 ||
         cpg * P.R * P.Z > tpg || (cpg > 1 && tpg != 32) ||
         fused_threads(P) > FUSED_MAX_THREADS || P.Ls < P.n || P.n > 65535 || P.B < 0 ||
         smem != (long long)fused_smem_bytes(P, dmax);
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int mc_decoder_launch(const float* w, const unsigned* raw, const float* consts,
                                 int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                                 float* llr_out, const int* tab, int n, int Z, int nb, int mb,
                                 int e_slots, int ngroups, int R, int lpb, int B, int max_it,
                                 int check_every, int variant, float alpha, float beta, int dmax,
                                 int has_dup, int cpg, int tpg, int Ls, int smem, int mode,
                                 float amp, int noise_input, unsigned key0, unsigned key1,
                                 int skip, int device, void* stream) {
  const Loop P = fused_loop(make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, lpb, B, max_it,
                                      check_every, variant, alpha, beta, has_dup),
                            cpg, tpg, Ls);
  if (bad_fused(P, dmax, smem) || (noise_input && raw == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax) {
    case 8:
      return launch_mc<8>(P, tab, w, raw, consts, err, ok, conv, norm, iters, llr_out, mode, amp,
                          noise_input, key0, key1, skip, s);
    case 16:
      return launch_mc<16>(P, tab, w, raw, consts, err, ok, conv, norm, iters, llr_out, mode,
                           amp, noise_input, key0, key1, skip, s);
    case 32:
      return launch_mc<32>(P, tab, w, raw, consts, err, ok, conv, norm, iters, llr_out, mode,
                           amp, noise_input, key0, key1, skip, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int llr_decoder_launch(const float* llr, const float* w, const float* done0,
                                  int* err, unsigned char* ok, int* conv, float* norm,
                                  int* iters, const int* tab, int n, int Z, int nb, int mb,
                                  int e_slots, int ngroups, int R, int lpb, int B, int max_it,
                                  int check_every, int variant, float alpha, float beta,
                                  int dmax, int has_dup, int cpg, int tpg, int Ls, int smem,
                                  int device, void* stream) {
  const Loop P = fused_loop(make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, lpb, B, max_it,
                                      check_every, variant, alpha, beta, has_dup),
                            cpg, tpg, Ls);
  if (bad_fused(P, dmax, smem)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax) {
    case 8:
      return launch_llr<8>(P, tab, llr, w, done0, err, ok, conv, norm, iters, s);
    case 16:
      return launch_llr<16>(P, tab, llr, w, done0, err, ok, conv, norm, iters, s);
    case 32:
      return launch_llr<32>(P, tab, llr, w, done0, err, ok, conv, norm, iters, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of K1 (llr = 0) or K2 (llr = 1) at a block of
// `threads` threads and `smem` bytes of dynamic shared memory, in one
// barrier group (solo = 1) or several.
extern "C" int fused_occupancy(int llr, int dmax, int solo, int threads, int smem, int* blocks) {
  const void* f = nullptr;
#define OCC_KERNEL(K, D, S) (const void*)K<D, FUSED_MAX_THREADS, FUSED_MIN_BLOCKS, S>
#define OCC_CASE(D)                                                               \
  case D:                                                                         \
    f = llr ? (solo ? OCC_KERNEL(llr_decoder_kernel, D, true)                     \
                    : OCC_KERNEL(llr_decoder_kernel, D, false))                   \
            : (solo ? OCC_KERNEL(mc_decoder_kernel, D, true)                      \
                    : OCC_KERNEL(mc_decoder_kernel, D, false));                   \
    break;
  switch (dmax) {
    OCC_CASE(8)
    OCC_CASE(16)
    OCC_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef OCC_CASE
#undef OCC_KERNEL
  cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, threads, (size_t)smem);
}

extern "C" int qc_decoder_launch(const float* llr, float* prior, unsigned char* est,
                                 unsigned char* ok, int* conv, float* norm, int* iters,
                                 const int* tab, int n, int Z, int nb, int mb, int e_slots,
                                 int ngroups, int R, int lpb, int B, int max_it, int check_every,
                                 int variant, float alpha, float beta, int dmax, int has_dup,
                                 int flood, int track_norm, int k, int skip, int device,
                                 void* stream) {
  if (bad_shape(lpb, R, Z, B) || (track_norm && prior == nullptr) ||
      (flood && (has_dup || ngroups))) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, lpb, B, max_it, check_every, variant,
                     alpha, beta, has_dup);
  P.flood = flood;
  P.track_norm = track_norm;
  P.prior = prior;
  P.kf = (float)(k > 1 ? k : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QC_CASE(D)                                                                    \
  case D:                                                                             \
    return flood ? launch_qc<D, true>(P, tab, llr, skip, est, ok, conv, norm, iters, s) \
                 : launch_qc<D, false>(P, tab, llr, skip, est, ok, conv, norm, iters, s);
  switch (dmax) {
    QC_CASE(8)
    QC_CASE(16)
    QC_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef QC_CASE
}
