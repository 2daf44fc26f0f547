// K2: the LLR decode kernel of two-phase dispatch for Hopper (sm_90a), plain
// C interface.
//
// Replaces ldpc_tpu/ops/mc_pallas.py make_llr_decoder (body :561-601,
// pallas_call :603) -> llr_decoder_kernel: the decode of K1 (decode_group.cuh)
// and its error counts from given channel LLRs [n][B] with a per-lane
// pre-done mask. The design note is in decode_group.cuh.
//
// The load reads each live codeword's LLRs once, lane-fastest, into L; then,
// under flooding, X in the channel sign convention goes from L into the
// internal [B][n] row `xbuf` (a codeword's column of [n][B] is strided by B;
// its row of xbuf is contiguous for the posterior passes), and with the flip
// metric the info positions' LLRs into the previous-posterior row
// (stage_x).

#include "decode_group.cuh"

namespace {

template <int DMAX, bool FLOOD, bool NORM, bool Q8>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
llr_decoder_kernel(Loop P, const int* tab, const float* llr, const float* w, const float* done0,
                   int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                   float* xbuf) {
  extern __shared__ __align__(16) float smem[];
  const int cpg = P.cpg, B = P.B, n = P.n;
  const LaneMap M = lane_map(P);
  const int tid = threadIdx.x, lane = M.lane, item0 = M.item0, nitems = M.nitems, b = M.b;
  const bool valid = M.valid;
  if (tid < cpg) {
    s_done[tid] = (!valid || done0[b] > 0.5f) ? 1 : 0;
    s_pre[tid] = s_done[tid];
    s_conv[tid] = -1;
    s_err[tid] = 0;
    s_norm[tid] = 0.0f;
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
  const Smem<Q8> S = block_smem<DMAX, Q8>(P, smem);
  stage_tables(P, tab, S.tables);
  zero_e<Q8>(P, S.E);
  // pre-done lanes are placeholders: their LLRs are never read
  if (valid && !s_pre[lane]) {
    for (int pos = item0; pos < n; pos += nitems) S.L[lane * P.Ls + pos] = llr[(size_t)pos * B + b];
  }
  float* X = FLOOD ? xbuf + (size_t)blockIdx.x * cpg * n : nullptr;
  __syncthreads();
  if (FLOOD || NORM) {
    stage_x<FLOOD, NORM>(P, S.L, X, blockIdx.x * cpg);
    __syncthreads();
  }
  decode_group<DMAX, FLOOD, NORM, Q8, false>(P, S.L, S.E, S.D, X, blockIdx.x * cpg);
  __syncthreads();
  finish(P, smem, w, err, ok, conv, norm, iters);
}

struct LLR {
  template <int D, bool F, bool N, bool Q>
  static const void* get() {
    return (const void*)llr_decoder_kernel<D, F, N, Q>;
  }
};

}  // namespace

extern "C" int llr_decoder_launch(const float* llr, const float* w, const float* done0,
                                  int* err, unsigned char* ok, int* conv, float* norm,
                                  int* iters, float* xbuf, float* prior, const int* tab, int n,
                                  int Z, int nb, int mb, int e_slots, int ngroups, int R, int B,
                                  int max_it, int check_every, int variant, float alpha,
                                  float beta, const float* atab, const int* acls, int aT, int aD,
                                  int track_norm, int k, int flood, int int8,
                                  int dmax, int has_dup, int cpg, int tpg, int Ls, int smem,
                                  int device, void* stream) {
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, B, max_it, check_every, variant,
                     alpha, beta, atab, acls, aT, aD, track_norm, k, flood, int8,
                     has_dup, cpg, tpg, Ls);
  P.prior = prior;
  if (bad_plan(P, dmax, smem) || (flood && xbuf == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  void* args[] = {&P, &tab, &llr, &w, &done0, &err, &ok, &conv, &norm, &iters, &xbuf};
  return launch(kernel_of<LLR>(dmax, flood, track_norm, int8), P, dmax, device, stream, args);
}

// Resident blocks per SM of K2 at these flags, a block of `threads` threads
// and `smem` bytes of dynamic shared memory.
extern "C" int decoder_occupancy(int dmax, int flood, int norm, int int8, int threads, int smem,
                                 int* blocks) {
  return occupancy(kernel_of<LLR>(dmax, flood, norm, int8), threads, smem, blocks);
}
