// v2 batch sync for Hopper (sm_90a): the bf16 sliding normalised cross-
// correlation of every row against the four band templates, on the tensor
// cores, with the lag mask of the batch stage in its epilogue.  Per row x
// (fp32, length T), band b, lag t in [0, T - L]:
//   e2[t]      = sum_k bf16(x[t+k] * x[t+k])          (squared in fp32)
//   corr[b, t] = sum_k bf16(x[t+k]) * bf16(tmpl[b, k])
//                / (sqrt(max(e2[t], 0)) + 1e-12)
//   corr[b, t] = -inf where t > n_valid[row] - span
// Every product of two bf16 values is exact and every sum is a float32
// accumulation over the window itself (no prefix-sum difference).
//
// Replaces no Pallas kernel: echoseal_tpu/ops/demod.py::normalized_xcorr
// with compute_dtype=bfloat16 is two convolutions that XLA lowers to
// implicit GEMMs on the TPU's matrix unit.  The port ran them as two cuDNN
// conv1d calls on bf16-rounded float32 operands (conv2d_grouped_direct), at
// about 180 ms for the v2 batch stage's 1024 rows of 160 384 samples: 80 %
// of a v2 verify_batch call and some 180 times this kernel's bound.
//
// Bound.  Five 504-tap rows (four templates and the energy's ones) over
// 1024 x 159 881 lags are 2 * 1024 * 159 881 * 5 * 504 = 0.83 TFLOP, 0.84 ms
// at 989 TFLOP/s (bf16 tensor cores, fp32 accumulators).  The bytes are
// 657 MB of fp32 rows read once and 2.62 GB of fp32 corr written once,
// 0.98 ms at 3.35 TB/s.  So the two are near balance and the bound is about
// 1 ms; on the SIMT fp32 units alone the operations would take 12.4 ms.
//
// Design.  Cut the lags into rows of P = 8: row q of a block's GEMM is
// A[q, kappa] = x[t0 + 8q + kappa], kappa in [0, K), K = 16 * ceil((L + 7)
// / 16) (512 at L = 504), and column (b, r) of B is B[kappa, r] =
// tmpl[b, kappa - r] (0 outside [0, L)), so C[q, (b, r)] = corr[b, t0 + 8q
// + r] with 512 MACs for 504 useful ones.  Row q + 1 of A starts 16 bytes
// after row q in the staged bf16 copy of x, so each 8 x 8 ldmatrix tile is
// 128 contiguous bytes: aligned and free of bank conflicts, with no im2col
// in memory.  The energy is the same product on the staged bf16(x^2) with a
// fifth "template" of ones.  B is Toeplitz: a B fragment register of
// mma.m16n8k16 holds two consecutive template samples, tmpl[b, 16j + 2c -
// g] and the next, so B is read from a 10 KB table of packed sample pairs
// built once per block, one 32-bit shared load a register, shared by every
// M tile of the warp.  Each warp owns 4 M tiles (512 lags) and keeps their
// 4 x 5 accumulator fragments in registers over all K; the epilogue divides
// by its own energy fragment (the same (q, r) positions) and stores straight
// from registers, each warp writing runs of 64 consecutive lags a band.
// Blocks are persistent over (row, 2048-lag) tiles and copy the next
// tile's 2560 fp32 samples into shared memory with cp.async while they
// compute the current one, then round them to bf16 there; a tile wholly
// past the row's last valid lag writes -inf and computes nothing, a warp
// past it skips its products.  At 1024 x 160 384 the kernel takes about
// 2.6 ms, bound by shared-memory reads: 42 wavefronts (8 ldmatrix.x4 and
// 10 table loads) feed a warp's 20 MMAs a k-step; leaving out the x^2
// tiles' ldmatrix alone takes it to 2.1 ms, the energy's MMAs alone nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBands = 4;                 // template rows
constexpr int kCols = kBands + 1;         // + the energy's ones
constexpr int kLagsPerRow = 8;            // P: lags of one GEMM row
constexpr int kMaxSteps = 32;             // k-steps of 16: K <= 512
constexpr int kMaxL = 16 * kMaxSteps - kLagsPerRow + 1;   // 505
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = 4;          // 16-row M tiles a warp
constexpr int kRowsPerWarp = 16 * kTilesPerWarp;
constexpr int kLagsPerBlock = kWarps * kRowsPerWarp * kLagsPerRow;   // 2048
constexpr int kStage = kLagsPerBlock + 16 * kMaxSteps;   // staged samples
constexpr int kTabOff = 8;                // pair index -7 .. 16 K - 2
constexpr int kTab = 16 * kMaxSteps + kTabOff;
constexpr unsigned kOneBf16 = 0x3f80u;

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 4-byte asynchronous copy global -> shared; zero-filled where !ok (then
// src is only a valid address, not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of samples [t0, t0 + stage) of one row into raw (fp32).
__device__ __forceinline__ void prefetch(uint32_t raw, const float* xrow,
                                         int T, long long t0, int stage) {
  for (int s = threadIdx.x; s < stage; s += kThreads) {
    const long long p = t0 + s;
    cp_async4(raw + 4u * s, p < T ? xrow + p : xrow, p < T);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One template sample as bf16 bits, 0 outside [0, L); column kBands is ones.
__device__ __forceinline__ unsigned tap(const float* tmpl, int L, int b,
                                        int i) {
  if (i < 0 || i >= L) return 0u;
  return b < kBands ? bf16_bits(__ldg(tmpl + b * L + i)) : kOneBf16;
}

template <typename NV>
__global__ void __launch_bounds__(kThreads, 3)
sync_xcorr_kernel(const float* __restrict__ x, long long ldx, int T,
                  const float* __restrict__ tmpl, int L,
                  const NV* __restrict__ n_valid, long long span,
                  float* __restrict__ out, int rows) {
  __shared__ __align__(16) float raw[kStage];
  __shared__ __align__(16) __nv_bfloat16 xs[kStage];
  __shared__ __align__(16) __nv_bfloat16 x2s[kStage];
  __shared__ uint32_t tab[kCols][kTab];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                // C / B fragment row group
  const int c = lane & 3;
  const int steps = (L + kLagsPerRow - 1 + 15) / 16;
  const int stage = kLagsPerBlock + 16 * steps;
  const long long Tout = static_cast<long long>(T) - L + 1;
  const long long tiles_per_row = (Tout + kLagsPerBlock - 1) / kLagsPerBlock;
  const long long n_tiles = tiles_per_row * rows;
  const float neg_inf = __int_as_float(0xff800000);

  // tab[b][i + kTabOff] = (tmpl[b, i], tmpl[b, i + 1]) as packed bf16
  for (int e = tid; e < kCols * kTab; e += kThreads) {
    const int b = e / kTab, i = e % kTab - kTabOff;
    tab[b][e % kTab] = tap(tmpl, L, b, i) | (tap(tmpl, L, b, i + 1) << 16);
  }

  // this lane's ldmatrix row: matrix lane / 8 of the A fragment
  // (rows 0-7 | 8-15) x (cols 0-7 | 8-15), row lane % 8 of it
  const int a_row = warp * kRowsPerWarp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const uint32_t raw_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t xs_base = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const uint32_t x2s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(x2s));

  // raw holds the block's next tile: its copy runs while the block
  // computes the one before
  if (blockIdx.x < n_tiles)
    prefetch(raw_base, x + blockIdx.x / tiles_per_row * ldx, T,
             blockIdx.x % tiles_per_row * kLagsPerBlock, stage);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row = tile / tiles_per_row;
    const long long t0 = (tile % tiles_per_row) * kLagsPerBlock;
    const long long limit = static_cast<long long>(n_valid[row]) - span;
    const bool skip = t0 > limit;         // every lag of the tile masked
    cp_async_wait_all();
    __syncthreads();                      // raw is this tile; xs is free
    if (!skip) {
      for (int s = 2 * tid; s < stage; s += 2 * kThreads) {
        const float2 v = *reinterpret_cast<const float2*>(raw + s);
        *reinterpret_cast<uint32_t*>(xs + s) =
            bf16_bits(v.x) | (bf16_bits(v.y) << 16);
        *reinterpret_cast<uint32_t*>(x2s + s) =
            bf16_bits(v.x * v.x) | (bf16_bits(v.y * v.y) << 16);
      }
    }
    __syncthreads();                      // xs is this tile; raw is free
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      prefetch(raw_base, x + next / tiles_per_row * ldx, T,
               next % tiles_per_row * kLagsPerBlock, stage);
    float* orow = out + row * kBands * Tout;
    if (skip) {
      for (int e = tid; e < kBands * kLagsPerBlock; e += kThreads) {
        const long long lag = t0 + e % kLagsPerBlock;
        if (lag < Tout) orow[(e / kLagsPerBlock) * Tout + lag] = neg_inf;
      }
      continue;
    }

    float acc[kTilesPerWarp][kCols][4];
#pragma unroll
    for (int m = 0; m < kTilesPerWarp; ++m)
#pragma unroll
      for (int b = 0; b < kCols; ++b)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[m][b][k] = 0.f;

    const long long w_lag0 = t0 + warp * kRowsPerWarp * kLagsPerRow;
    if (w_lag0 <= limit && w_lag0 < Tout) {
#pragma unroll 2
      for (int j = 0; j < steps; ++j) {
        uint32_t bf[kCols][2];
        const int ti = 16 * j + 2 * c - g + kTabOff;
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          bf[b][0] = tab[b][ti];
          bf[b][1] = tab[b][ti + 8];
        }
#pragma unroll
        for (int m = 0; m < kTilesPerWarp; ++m) {
          // bf16 element offset of this lane's row: 8 (q) + 16 j + col
          const uint32_t off =
              2u * static_cast<uint32_t>(8 * (a_row + 16 * m) + 16 * j + a_col);
          uint32_t a[4], a2[4];
          ldsm_x4(xs_base + off, a);
          ldsm_x4(x2s_base + off, a2);
#pragma unroll
          for (int b = 0; b < kBands; ++b) mma_bf16(acc[m][b], a, bf[b][0],
                                                    bf[b][1]);
          mma_bf16(acc[m][kBands], a2, bf[kBands][0], bf[kBands][1]);
        }
      }
    }

    // C fragment: acc[.][.][2h + e] is GEMM row g + 8h, column 2c + e
#pragma unroll
    for (int m = 0; m < kTilesPerWarp; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long lag =
            w_lag0 + (16 * m + g + 8 * h) * kLagsPerRow + 2 * c;
        float v[kBands][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float den = sqrtf(fmaxf(acc[m][kBands][2 * h + e], 0.f)) +
                            1e-12f;
          const bool masked = lag + e > limit;
#pragma unroll
          for (int b = 0; b < kBands; ++b)
            v[b][e] = masked ? neg_inf : acc[m][b][2 * h + e] / den;
        }
#pragma unroll
        for (int b = 0; b < kBands; ++b) {
          float* o = orow + b * Tout + lag;
          // the parity of b * Tout + lag is the warp's (lag is even)
          if (((b * Tout) & 1) == 0 && lag + 1 < Tout) {
            *reinterpret_cast<float2*>(o) = make_float2(v[b][0], v[b][1]);
          } else {
            if (lag < Tout) o[0] = v[b][0];
            if (lag + 1 < Tout) o[1] = v[b][1];
          }
        }
      }
    }
  }
}

template <typename NV>
int grid_for(long long n_tiles) {
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sync_xcorr_kernel<NV>, kThreads, 0);
    cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  return static_cast<int>(n_tiles < cap ? n_tiles : cap);
}

template <typename NV>
void launch(const float* x, long long ldx, int T, const float* tmpl, int L,
            const void* n_valid, long long span, float* out, int rows,
            cudaStream_t st) {
  const long long Tout = static_cast<long long>(T) - L + 1;
  const long long n_tiles =
      (Tout + kLagsPerBlock - 1) / kLagsPerBlock * rows;
  sync_xcorr_kernel<NV><<<grid_for<NV>(n_tiles), kThreads, 0, st>>>(
      x, ldx, T, tmpl, L, static_cast<const NV*>(n_valid), span, out, rows);
}

}  // namespace

// x (rows, T) fp32 with row stride ldx; tmpl (4, L) fp32 contiguous;
// n_valid (rows,) int32 or int64; out (rows, 4, T - L + 1) fp32 contiguous.
// Returns a cudaError_t (22 = cudaErrorInvalidValue for refused shapes:
// L above kMaxL = 505, ops/demod.py's SYNC_MAX_L).
extern "C" int sync_xcorr_launch(const float* x, long long ldx, int T,
                                 const float* tmpl, int L,
                                 const void* n_valid, int nv_is64,
                                 long long span, float* out, int rows,
                                 void* stream) {
  if (L < 1 || L > kMaxL || T < L || rows < 0) return 22;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nv_is64) {
    launch<long long>(x, ldx, T, tmpl, L, n_valid, span, out, rows, st);
  } else {
    launch<int32_t>(x, ldx, T, tmpl, L, n_valid, span, out, rows, st);
  }
  return static_cast<int>(cudaGetLastError());
}
