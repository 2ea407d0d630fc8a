// Fused despread + moment-normalised payload LLR for Hopper (sm_90a).
//
// Replaces the TPU kernel echoseal_tpu/ops/pallas/llr_kernel.py
// (payload_llr_pallas, body _kernel): per row of 1024 payload chips
//   z     = chips * pn
//   p     = mean(z^2) + 1e-20
//   zn    = z * rsqrt(p)
//   a     = clip(mean|zn|, 0.05, 1)
//   s2    = max(1 - a^2, 0.05)
//   out   = clip(2 a zn / s2, -16, 16)
//
// Bound: memory.  Each row reads 4 KB of chips and 4 KB of PN and writes
// 4 KB of LLRs for ~10 flops per element, far below the card's
// flops-per-byte balance.  The design therefore touches each byte once:
// one warp owns one row, each lane keeps its 32 elements in registers, both
// row sums (sum z^2 and sum |z|) come from that single read through
// __shfl_xor_sync butterflies (no shared memory, no second pass over device
// memory), and mean|zn| is taken as rsqrt(p) * mean|z| so one read suffices.
// The output is written once.  Lane l touches elements l, l+32, ..., so
// every warp-wide load and store is one contiguous 128-byte run.
//
// The chips arrive as a strided view: rows of ``chip_stride`` floats with
// the payload starting at ``chip_offset`` (1215 and 191 on the compat
// path), which avoids copying the payload out.  That base is not 16-byte
// aligned, so loads are scalar (coalesced) rather than float4.  Rows are
// not padded: eight warps per block, and the warps past the last row of
// the ragged final block exit before touching memory.
#include <cuda_runtime.h>

namespace {

constexpr int kRowLen = 1024;
constexpr int kPerLane = kRowLen / 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
payload_llr_kernel(const float* __restrict__ chips, long long chip_stride,
                   int chip_offset, const float* __restrict__ pn,
                   float* __restrict__ out, int n_rows) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform: whole warps leave together

  const float* c = chips + row * chip_stride + chip_offset;
  const float* p = pn + static_cast<long long>(row) * kRowLen;
  float z[kPerLane];
  float sq = 0.f, ab = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int e = lane + 32 * k;
    z[k] = c[e] * p[e];
    sq += z[k] * z[k];
    ab += fabsf(z[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
    ab += __shfl_xor_sync(0xffffffffu, ab, o);
  }
  const float inv = rsqrtf(sq * (1.f / kRowLen) + 1e-20f);
  const float amp = fminf(fmaxf(ab * (1.f / kRowLen) * inv, 0.05f), 1.f);
  const float sigma2 = fmaxf(1.f - amp * amp, 0.05f);
  const float two_amp = 2.f * amp;

  float* o = out + static_cast<long long>(row) * kRowLen;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const float v = two_amp * (z[k] * inv) / sigma2;
    o[lane + 32 * k] = fminf(fmaxf(v, -16.f), 16.f);
  }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int payload_llr_launch(const float* chips, long long chip_stride,
                                  int chip_offset, const float* pn, float* out,
                                  int n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  payload_llr_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      chips, chip_stride, chip_offset, pn, out, n_rows);
  return static_cast<int>(cudaGetLastError());
}
