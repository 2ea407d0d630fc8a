// Time-scale scan for Hopper (sm_90a): for every clip and every row of the
// scaled sync-template bank, the largest normalised correlation over the
// clip's valid lags, in one kernel.  Per clip x (fp32, length T), bank row
// b_r (length L, zero-padded), lag t in [0, T - L]:
//   corr[r, t]  = sum_j x[t + j] * b_r[j]
//   score[r]    = max over t <= min(n_valid, T) - L of corr[r, t] / energy[t]
// where energy (B, T - L + 1) fp32 is the caller's float64 window sum,
// square-rooted (models/robust.py::_window_energy); a clip with no valid lag
// scores -inf.  All arithmetic is fp32.
//
// Replaces no Pallas kernel: echoseal_tpu/models/robust.py::_scale_scan_batch
// is a full-length jnp.fft correlation that XLA runs on the TPU.  The port ran
// the same formula with cuFFT: per 4-row chunk of the 124-row bank a
// (128, 4, 184 384) fp32 cube written, divided, masked and reduced in device
// memory (about 840 GB moved a 1024-clip call), over rows of 2^6 * 43 * 67
// samples that cuFFT can only cut into prime-factor passes: 120 ms a
// 128-clip chunk, 0.96 s a recovery call.
//
// Bound.  Overlap-save over segments of N samples (H = N - L + 1 lags each)
// needs, per pair of segments and bank row, one complex N-point inverse FFT
// (the pair packed as real and imaginary parts).  At N = 4096 and L = 530 a
// 128-clip chunk of the recovery (168 000 valid samples) is 3 072 pairs, each
// one forward and 124 inverse transforms (5 N log2 N operations) with 124
// spectral products and normalised maxima: 109 GFLOP, 1.6 ms at 67 TFLOP/s.
// The bytes are the clips and the energies read once (0.19 GB, 0.06 ms at
// 3.35 TB/s) and the (R, N/2 + 1) spectra table, which stays in L2.  So the
// scan is bound by fp32 operations, not by device memory.
//
// Design.  N is 4096: a thread holds 16 values, and a block of 256 threads
// one segment pair.  N >= 4 L, so banks up to 1024 taps; the scan's bank
// is about 63 S / 0.95 = 530 taps at the robust profile's S = 8 at any
// rate (its rows are the templates resampled to fs / r).  At 8 widths (N =
// 8192, 32 values a thread) the registers spilled and a chunk took 1.5x
// as long.  A block owns two consecutive segments of one clip and packs
// them as z = x_a + i x_b.  It transforms z once (three radix-16 Stockham
// passes, the first in registers, the next two through shared memory) and
// keeps the spectrum Z in registers, each thread the bins tid + 256 m.
// Then, for each bank row: multiply by the row's conjugate spectrum (read
// from the fp32 table, bins above N/2 by Hermitian symmetry), inverse
// transform the same way, and the real and imaginary parts of the output
// are the two segments' correlations, held in registers at the lags
// tid + 256 m: each times its segment's 1 / (N energy) from shared memory
// (NaN at lags past the segment's H or the clip's last valid lag, which
// fmaxf skips) into a running max.  A warp's max goes to shared memory each
// row; the block writes its two segments' (R,) maxima at the end, and the
// wrapper takes the max over segments.  Nothing of size (B, R, T) exists.
// One spectrum row read from L2 serves two segments.  Shared buffers are
// padded by one slot every 16 so that the first pass's strided stores hit
// distinct banks; two buffers alternate so a pass needs one barrier.  Every
// register index is a compile-time constant (the DFT's levels and its bit
// reversal are unrolled by templates): a level loop that nvcc kept rolled
// put the values in local memory and took six times as long.
//
// Measured (H100 80GB HBM3, 700 W): 4.8 ms a 128 x 184 384 chunk at N = 4096,
// 203 registers, one block of 8 warps an SM, bound by the instruction rate
// at about 1 075 instructions a thread a row (three radix-16 DFTs, the
// twiddle powers of two passes, the product and the epilogue); at 128
// registers (two blocks an SM) it spills and takes 5.5 ms; N = 8192 took
// 7.3 ms.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 4096;                   // segment length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = kN / kThreads;          // values a thread holds: 16
constexpr int kPad = kN + kN / kE;         // shared slots of one buffer
constexpr int kMaxL = kN / 4;
constexpr int kMaxRows = 256;

// exp(2 pi i t / 16), t < 8: the in-register DFTs' twiddles
__constant__ float2 c_w16[8] = {
    {1.000000000e+00f, 0.000000000e+00f},
    {9.238795325e-01f, 3.826834324e-01f},
    {7.071067812e-01f, 7.071067812e-01f},
    {3.826834324e-01f, 9.238795325e-01f},
    {0.000000000e+00f, 1.000000000e+00f},
    {-3.826834324e-01f, 9.238795325e-01f},
    {-7.071067812e-01f, 7.071067812e-01f},
    {-9.238795325e-01f, 3.826834324e-01f},
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * exp(SIGN 2 pi i t / 16); t is a constant once unrolled
template <int SIGN>
__device__ __forceinline__ float2 twiddle16(float2 a, int t) {
  if (t == 0) return a;
  if (t == 4) {
    return SIGN > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  }
  const float2 w = c_w16[t];
  const float s = SIGN > 0 ? w.y : -w.y;
  return make_float2(a.x * w.x - a.y * s, a.x * s + a.y * w.x);
}

__host__ __device__ constexpr int bit_reverse4(int i) {
  return ((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3);
}

// v[I..16) = t[bit_reverse4(I..16)], every index a compile-time constant
template <int I = 0>
__device__ __forceinline__ void bit_reversed(float2* v, const float2* t) {
  if constexpr (I < 16) {
    v[I] = t[bit_reverse4(I)];
    bit_reversed<I + 1>(v, t);
  }
}

// One radix-2 level of decimation in frequency over 16 values, sub-DFTs of
// 2 HALF points, then the levels below it
template <int SIGN, int HALF>
__device__ __forceinline__ void dif_levels(float2* v) {
#pragma unroll
  for (int blk = 0; blk < 16; blk += 2 * HALF) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float2 a = v[blk + i], b = v[blk + i + HALF];
      v[blk + i] = cadd(a, b);
      v[blk + i + HALF] = twiddle16<SIGN>(csub(a, b), i * (8 / HALF));
    }
  }
  if constexpr (HALF > 1) dif_levels<SIGN, HALF / 2>(v);
}

// In-register 16-point DFT, exp(SIGN 2 pi i n k / 16), natural order in and
// out (radix-2 decimation in frequency, then the bit reversal as a renaming
// of registers).  Every index is a compile-time constant, so v stays in
// registers.
template <int SIGN>
__device__ __forceinline__ void dft16(float2* v) {
  dif_levels<SIGN, 8>(v);
  float2 t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = v[i];
  bit_reversed(v, t);
}

// v[r] *= w^r for r < 16 (powers by successive products)
__device__ __forceinline__ void twiddle_powers(float2* v, float2 w) {
  float2 p = w;
#pragma unroll
  for (int r = 1; r < 16; ++r) {
    v[r] = cmul(v[r], p);
    if (r < 15) p = cmul(p, w);
  }
}

__device__ __forceinline__ int slot(int i) { return i + i / kE; }

// The N-point DFT exp(SIGN 2 pi i n k / N) of the values v[r] = z[tid + 256
// r], in three Stockham passes of radix 16; on return v[r] holds bin tid +
// 256 r.  w2, w3: the last two passes' base twiddles for SIGN = +1
// (conjugated for SIGN = -1).  Two barriers; bufA and bufB may be reused as
// soon as the next call's first barrier is passed.
template <int SIGN>
__device__ __forceinline__ void fft(float2* v, float2* bufA, float2* bufB,
                                    float2 w2, float2 w3, int tid) {
  if (SIGN < 0) {
    w2.y = -w2.y;
    w3.y = -w3.y;
  }
  // pass 1, Ns = 1: outputs to tid * 16 + r
  dft16<SIGN>(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) bufA[slot(tid * 16 + r)] = v[r];
  __syncthreads();
  // pass 2, Ns = 16: outputs to (tid / 16) * 256 + tid % 16 + 16 r
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = bufA[slot(tid + kThreads * r)];
  twiddle_powers(v, w2);
  dft16<SIGN>(v);
  const int base = (tid / 16) * 256 + tid % 16;
#pragma unroll
  for (int r = 0; r < 16; ++r) bufB[slot(base + 16 * r)] = v[r];
  __syncthreads();
  // pass 3, Ns = 256: outputs stay in registers
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = bufB[slot(tid + kThreads * r)];
  twiddle_powers(v, w3);
  dft16<SIGN>(v);
}

__global__ void __launch_bounds__(kThreads, 1)
scale_scan_kernel(const float* __restrict__ x, long long ldx, int T,
                  const long long* __restrict__ n_valid,
                  const float* __restrict__ energy, long long lde,
                  const float2* __restrict__ spec, int R, int L,
                  float* __restrict__ out, int nseg, int npair) {
  extern __shared__ float4 smem[];
  float2* bufA = reinterpret_cast<float2*>(smem);
  float2* bufB = bufA + kPad;
  float2* inv = bufB + kPad;                     // (N,): segment a, b
  float2* red = inv + kN;                        // (R, kWarps)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = kN - L + 1;
  const long long clip = blockIdx.x / npair;
  const int pair = static_cast<int>(blockIdx.x % npair);
  const int sa = 2 * pair;
  const bool has_b = sa + 1 < nseg;
  const long long nv = n_valid[clip];
  const long long lim = (nv < T ? nv : T) - L;     // last valid lag
  const long long s0 = static_cast<long long>(sa) * H;
  float* out_a = out + (clip * nseg + sa) * R;
  float* out_b = out_a + R;
  if (s0 > lim) {               // both segments wholly past the valid lags
    for (int r = tid; r < R; r += kThreads) {
      out_a[r] = -INFINITY;
      if (has_b) out_b[r] = -INFINITY;
    }
    return;
  }

  // 1 / (N energy) at each lag of the two segments, NaN where masked
  const float* e_row = energy + clip * lde;
  const float inv_n = 1.0f / kN;
  for (int n = tid; n < kN; n += kThreads) {
    const long long ta = s0 + n, tb = s0 + H + n;
    inv[n] = make_float2(
        n < H && ta <= lim ? (1.0f / e_row[ta]) * inv_n : NAN,
        has_b && n < H && tb <= lim ? (1.0f / e_row[tb]) * inv_n : NAN);
  }

  // the last two passes' base twiddles exp(2 pi i k / (Ns 16))
  float2 w2, w3;
  {
    float s, c;
    sincospif(2.0f * static_cast<float>(tid % 16) / 256, &s, &c);
    w2 = make_float2(c, s);
    sincospif(2.0f * static_cast<float>(tid) / kN, &s, &c);
    w3 = make_float2(c, s);
  }

  // z = x_a + i x_b at n = tid + 256 m, zero past T
  const float* x_row = x + clip * ldx;
  float2 v[kE];
#pragma unroll
  for (int m = 0; m < kE; ++m) {
    const long long ta = s0 + tid + kThreads * m, tb = ta + H;
    v[m] = make_float2(ta < T ? x_row[ta] : 0.0f,
                       has_b && tb < T ? x_row[tb] : 0.0f);
  }
  fft<-1>(v, bufA, bufB, w2, w3, tid);
  float2 z[kE];                 // bin tid + 256 m of the pair's spectrum
#pragma unroll
  for (int m = 0; m < kE; ++m) z[m] = v[m];

  for (int row = 0; row < R; ++row) {
    // bin k = tid + 256 m: B[k] below N/2, conj(B[N - k]) from N/2 on
    // (at m = 8 both read bin N/2 - tid, conjugated for tid = 0 alone)
    const float2* s_lo = spec + static_cast<long long>(row) * (kN / 2 + 1) + tid;
    const float2* s_hi = s_lo + kN - 2 * tid;
#pragma unroll
    for (int m = 0; m < kE; ++m) {
      v[m] = __ldg(m < kE / 2 ? s_lo + kThreads * m : s_hi - kThreads * m);
    }
#pragma unroll
    for (int m = 0; m < kE; ++m) {
      const bool low = m < kE / 2 || (m == kE / 2 && tid == 0);
      v[m] = cmul(z[m], make_float2(v[m].x, low ? -v[m].y : v[m].y));
    }
    fft<1>(v, bufA, bufB, w2, w3, tid);
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const float2 w = inv[tid + kThreads * r];
      ma = fmaxf(ma, v[r].x * w.x);
      mb = fmaxf(mb, v[r].y * w.y);
    }
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    if (lane == 0) red[row * kWarps + warp] = make_float2(ma, mb);
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) {
    float a = -INFINITY, b = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a = fmaxf(a, red[r * kWarps + w].x);
      b = fmaxf(b, red[r * kWarps + w].y);
    }
    out_a[r] = a;
    if (has_b) out_b[r] = b;
  }
}

size_t smem_bytes(int R) {
  return sizeof(float2) * (2 * kPad + kN + static_cast<size_t>(R) * kWarps);
}

}  // namespace

// x (B, T) fp32 with row stride ldx; n_valid (B,) int64; energy (B, T - L
// + 1) fp32 with row stride lde; spec (R, 2049) complex fp32 (interleaved),
// the bank rows' rfft at 4096; out (B, nseg, R) fp32 contiguous, nseg =
// ceil((T - L + 1) / (4097 - L)), every entry written.  L <= 1024.
// Returns a cudaError_t (22 = cudaErrorInvalidValue for refused shapes).
extern "C" int scale_scan_launch(const float* x, long long ldx, int T,
                                 const long long* n_valid,
                                 const float* energy, long long lde,
                                 const void* spec, int R, int L, float* out,
                                 int B, int nseg, void* stream) {
  if (L < 1 || L > kMaxL || T < L || R < 1 || R > kMaxRows || B < 0 ||
      nseg != (T - L + 1 + kN - L) / (kN - L + 1)) {
    return 22;
  }
  if (B == 0) return 0;
  static bool ready[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 22;
  if (!ready[dev]) {
    cudaError_t rc = cudaFuncSetAttribute(
        scale_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxRows)));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(scale_scan_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ready[dev] = true;
  }
  const int npair = (nseg + 1) / 2;
  const long long blocks = static_cast<long long>(B) * npair;
  if (blocks >= (1LL << 31)) return 22;
  scale_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes(R),
                      static_cast<cudaStream_t>(stream)>>>(
      x, ldx, T, n_valid, energy, lde, static_cast<const float2*>(spec), R,
      L, out, nseg, npair);
  return static_cast<int>(cudaGetLastError());
}
