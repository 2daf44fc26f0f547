// K8: the GF(2) encode of a batch of info words into f32 0/1 codewords, for
// Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package encodes with one dense matrix
// product (ldpc_tpu/ops/encode.py make_encoder, make_encoder_T), left to XLA
// and the MXU. The port ran it as a widening cast of the uint8 bits to f32, a
// dense f32 GEMM (n x k x B: 1152 x 576 x 4096 at WiMAX) and a remainder by 2:
// three launches, and the GEMM multiplied the k identity columns of the
// systematic part as well.
//
// What bounds it on the card: bytes. Per frame it reads k bytes of info bits
// and writes 4 n bytes of codeword: 2.36 MB + 18.9 MB at B = 4096, n = 1152,
// about 6.3 us at 3.35 TB/s. Bit-packed, the arithmetic is n x ceil(k/32)
// AND-XORs a frame (one LOP3 each) and a popcount an output bit.
//
// Design: a block of 256 threads takes a tile of 64 frames x 128 codeword
// columns (3 blocks an SM; 576 blocks at B = 4096, n = 1152) and walks the
// info words in tiles of WT = 32 words (k up to 1024 in one tile; longer
// codes, k = 4608 say, loop). For each word tile it stages in shared memory
// the generator's words of its 128 columns (the table is word-major, columns
// contiguous: 16-byte loads) and its frames' info words, packed once from
// their bytes: 16-byte loads of consecutive 32-byte runs of a row, one run
// at a time a thread, 4 bits from each 4 bytes by one multiply; byte by byte
// where k is not a multiple of 32 or the bits are not 16-byte aligned. Each
// thread then XORs ``info word & column word`` into 32 accumulators in
// registers; an output bit is the parity of its accumulator's popcount. The
// roles follow the layout, so that every warp's store is 128 contiguous bytes:
//  * frames minor ([n, B], for K1 and K2): a lane holds a frame of each of the
//    tile's 2 groups of 32 frames, and its warp 16 columns; per word a lane
//    reads its frames' words (a row stride of 33 words: no bank conflict) and
//    the 16 columns' words as 4 broadcast 16-byte loads;
//  * frames major ([B, n], the unfused path and K6): a lane holds a column of
//    each of the tile's 4 groups of 32 columns, and its warp 8 frames; per
//    word a lane reads its columns' words and the 8 frames' as broadcasts.
// Padding frames and columns hold zero words and are not stored. Only the low
// bit of each info byte counts, as in the product mod 2. Integer work only, so
// the answer is exactly the product's mod 2, on every code. Measured on an
// H100 (a tile of 128 frames, 64 accumulators and 2 blocks an SM took 0.0214
// ms at B = 4096, n = 1152; 32 frames a tile spilled at 4 blocks an SM; four
// runs in flight a thread spilled 20-24 B and took 0.0174 ms against one's
// 0.0157).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;              // codeword columns of a block's tile
constexpr int FRAMES = 64;             // frames of a block's tile
constexpr int WT = 32;                 // info words of a word tile
constexpr int ROW = WT + 1;            // a frame's row in shared memory, words
// frames minor: lanes hold frames (FRAMES / 32 groups), a warp 16 columns;
// frames major: lanes hold columns (4 groups), a warp FRAMES / 8 frames
constexpr int GROUPS_MINOR = FRAMES / 32, CHUNK_MINOR = TILE / WARPS;
constexpr int GROUPS_MAJOR = TILE / 32, CHUNK_MAJOR = FRAMES / WARPS;

// bits 0-3 of the result: the low bits of the four bytes of ``x``, byte 0
// first (no two partial products meet, so the multiply makes no carry)
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 | nibble(v.w) << 12;
}

__device__ __forceinline__ float parity(uint32_t acc) {
  return __uint_as_float((__popc(acc) & 1u) * 0x3f800000u);  // 0.0f or 1.0f
}

// Stage word tile [w0, w0 + wt) of the block's tile in shared memory: the
// generator's words of its columns and its frames' info words, packed from
// their bytes (zero for frames past the batch).
__device__ __forceinline__ void stage(const uint8_t* __restrict__ u,
                                      const uint32_t* __restrict__ table, uint32_t (*gs)[TILE],
                                      uint32_t (*us)[ROW], int f0, int j0, int w0, int wt,
                                      int frames, int k, int table_cols, int vector) {
  for (int i = threadIdx.x; i < wt * (TILE / 4); i += THREADS) {
    const int w = i / (TILE / 4), c4 = i % (TILE / 4);
    reinterpret_cast<uint4*>(gs[w])[c4] = __ldg(
        reinterpret_cast<const uint4*>(table + (size_t)(w0 + w) * table_cols + j0) + c4);
  }
  const int items = FRAMES * wt;  // (frame, word) pairs
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int f = i / wt, w = w0 + i % wt;
    uint32_t word = 0u;
    if (f0 + f < frames) {
      const uint8_t* row = u + (size_t)(f0 + f) * k;
      if (vector) {
        const uint4* q = reinterpret_cast<const uint4*>(row + 32 * w);
        word = pack16(__ldg(q)) | pack16(__ldg(q + 1)) << 16;
      } else {
        for (int b = 0; b < 32 && 32 * w + b < k; ++b)
          word |= (uint32_t)(row[32 * w + b] & 1u) << b;
      }
    }
    us[f][w - w0] = word;
  }
}

template <bool FRAMES_MINOR>
__global__ void __launch_bounds__(THREADS, 3)
gf2_encode_kernel(const uint8_t* __restrict__ u, const uint32_t* __restrict__ table,
                  float* __restrict__ out, int frames, int k, int n, int words,
                  int table_cols, int vector) {
  constexpr int GROUPS = FRAMES_MINOR ? GROUPS_MINOR : GROUPS_MAJOR;
  constexpr int CHUNK = FRAMES_MINOR ? CHUNK_MINOR : CHUNK_MAJOR;
  __shared__ __align__(16) uint32_t gs[WT][TILE];  // column words, [word][column]
  __shared__ uint32_t us[FRAMES][ROW];              // info words, [frame][word]
  const int f0 = blockIdx.x * FRAMES, j0 = blockIdx.y * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t acc[GROUPS][CHUNK];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) acc[g][c] = 0u;

  for (int w0 = 0; w0 < words; w0 += WT) {
    const int wt = min(WT, words - w0);
    __syncthreads();  // the previous word tile is consumed
    stage(u, table, gs, us, f0, j0, w0, wt, frames, k, table_cols, vector);
    __syncthreads();
    for (int w = 0; w < wt; ++w) {
      uint32_t x[GROUPS];
      if constexpr (FRAMES_MINOR) {
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) x[g] = us[32 * g + lane][w];
        const uint4* y4 = reinterpret_cast<const uint4*>(&gs[w][CHUNK * warp]);
#pragma unroll
        for (int q = 0; q < CHUNK / 4; ++q) {
          const uint4 y = y4[q];
#pragma unroll
          for (int g = 0; g < GROUPS; ++g) {
            acc[g][4 * q] ^= x[g] & y.x;
            acc[g][4 * q + 1] ^= x[g] & y.y;
            acc[g][4 * q + 2] ^= x[g] & y.z;
            acc[g][4 * q + 3] ^= x[g] & y.w;
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) x[g] = gs[w][32 * g + lane];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const uint32_t y = us[CHUNK * warp + c][w];
#pragma unroll
          for (int g = 0; g < GROUPS; ++g) acc[g][c] ^= x[g] & y;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if constexpr (FRAMES_MINOR) {
        const int f = f0 + 32 * g + lane, j = j0 + CHUNK * warp + c;
        if (f < frames && j < n) out[(size_t)j * frames + f] = parity(acc[g][c]);
      } else {
        const int f = f0 + CHUNK * warp + c, j = j0 + 32 * g + lane;
        if (f < frames && j < n) out[(size_t)f * n + j] = parity(acc[g][c]);
      }
    }
}

// Run on ``device`` and put the caller's device back.
struct OnDevice {
  int prev = -1;
  cudaError_t err;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// ``u`` [frames, k] bytes, rows contiguous; ``table`` [words, table_cols]
// uint32, words = ceil(k / 32), table_cols a multiple of 128 and >= n, bit b
// of word w of column j the generator's entry of info bit 32 w + b, zero past
// n and k; ``out`` f32 [n, frames] (``frames_minor``) or [frames, n].
extern "C" int gf2_encode_launch(const uint8_t* u, const uint32_t* table, float* out,
                                 int frames, int k, int n, int words, int table_cols,
                                 int frames_minor, int device, void* stream) {
  if (frames < 1 || k < 1 || n < 1 || words != (k + 31) / 32 || table_cols < n ||
      table_cols % TILE != 0 || !aligned(table, 16))
    return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  const int vector = k % 32 == 0 && aligned(u, 16);
  const dim3 grid((frames + FRAMES - 1) / FRAMES, table_cols / TILE);
  const auto s = static_cast<cudaStream_t>(stream);
  if (frames_minor)
    gf2_encode_kernel<true><<<grid, THREADS, 0, s>>>(u, table, out, frames, k, n, words,
                                                      table_cols, vector);
  else
    gf2_encode_kernel<false><<<grid, THREADS, 0, s>>>(u, table, out, frames, k, n, words,
                                                       table_cols, vector);
  return cudaGetLastError();
}
