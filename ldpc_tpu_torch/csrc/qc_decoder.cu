// K3: the standalone QC decode kernel for Hopper (sm_90a), plain C interface.
//
// Replaces ldpc_tpu/ops/spa_pallas.py make_qc_decoder (body :686-708,
// pallas_call :710) -> qc_decoder_kernel: the decode of given channel LLRs
// (the unfused path), layered or flooding, scalar or scheduled alpha, f32 or
// int8 E (decode_group.cuh), then hard decisions, ok, conv, the
// normalized-LLR flip metric and the trip count. The design note is in
// decode_group.cuh.

#include "decode_group.cuh"

namespace {

// spa_pallas.py:686-708: decode the channel LLRs ``llr`` [B, n] (LLR > 0 <=>
// bit 1, negated on load into log(p0/p1)), then write the hard decisions
// est [B, n] (1 <=> L < 0, frozen per codeword at its convergence) and the
// per-codeword ok / conv / norm / iters. ``skip`` pre-marks every codeword
// done. The block's nv codewords are adjacent rows of llr and est: the block
// reads and writes one contiguous range of nv * n words. Flooding reads X
// from the block's rows of ``llr``.
template <int DMAX, bool FLOOD, bool NORM, bool Q8>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
qc_decoder_kernel(Loop P, const int* tab, const float* llr, int skip, unsigned char* est,
                  unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ __align__(16) float smem[];
  const Smem<Q8> S = block_smem<DMAX, Q8>(P, smem);
  stage_tables(P, tab, S.tables);
  const int cpg = P.cpg, n = P.n, tid = threadIdx.x, b0 = blockIdx.x * cpg;
  const int nv = min(cpg, P.B - b0);  // codewords of this block in the batch
  if (tid < cpg) {
    s_done[tid] = (skip || tid >= nv) ? 1 : 0;
    s_conv[tid] = -1;
    s_norm[tid] = 0.0f;
  }
  if (tid == 0) s_iters = 0;
  zero_e<Q8>(P, S.E);
  const size_t base = (size_t)b0 * n;
  for (int i = tid; i < nv * n; i += blockDim.x) {
    const int q = cpg == 1 ? 0 : i / n, pos = i - q * n;
    const float v = -llr[base + i];
    S.L[q * P.Ls + pos] = v;
    if (NORM && P.info_mask[pos]) P.prior[base + i] = v;
  }
  __syncthreads();
  decode_group<DMAX, FLOOD, NORM, Q8, true>(P, S.L, S.E, S.D, llr + base, b0);
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

struct QC {
  template <int D, bool F, bool N, bool Q>
  static const void* get() {
    return (const void*)qc_decoder_kernel<D, F, N, Q>;
  }
};

}  // namespace

extern "C" int qc_decoder_launch(const float* llr, float* prior, unsigned char* est,
                                 unsigned char* ok, int* conv, float* norm, int* iters,
                                 const int* tab, int n, int Z, int nb, int mb, int e_slots,
                                 int ngroups, int R, int B, int max_it, int check_every,
                                 int variant, float alpha, float beta, const float* atab,
                                 const int* acls, int aT, int aD, int track_norm, int k,
                                 int flood, int int8, int dmax, int has_dup, int cpg,
                                 int tpg, int Ls, int smem, int skip, int device, void* stream) {
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, B, max_it, check_every, variant,
                     alpha, beta, atab, acls, aT, aD, track_norm, k, flood, int8,
                     has_dup, cpg, tpg, Ls);
  P.prior = prior;
  if (bad_plan(P, dmax, smem)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  void* args[] = {&P, &tab, &llr, &skip, &est, &ok, &conv, &norm, &iters};
  return launch(kernel_of<QC>(dmax, flood, track_norm, int8), P, dmax, device, stream, args);
}

// Resident blocks per SM of K3 at these flags, a block of `threads` threads
// and `smem` bytes of dynamic shared memory.
extern "C" int decoder_occupancy(int dmax, int flood, int norm, int int8, int threads, int smem,
                                 int* blocks) {
  return occupancy(kernel_of<QC>(dmax, flood, norm, int8), threads, smem, blocks);
}
