// Fused payload decode for Hopper (sm_90a): PN gather, despread + LLR, hard
// decision, polar butterfly, data-bit read-out and CRC-8 in one launch.
//
// Redesigns the TPU kernel echoseal_tpu/ops/pallas/llr_kernel.py
// (payload_llr_pallas, body _kernel; ported one to one as payload_llr.cu)
// together with the work every caller wraps around it: the PN gather before
// it and ops/polar.py::hard_decode_batch after it.  Per row r:
//   pn    = 2 * pn_bits[clamp(pn_row[r], 0, M - 1)] - 1   (jnp.take clamps)
//   z     = chips[r] * pn
//   p     = mean(z^2) + 1e-20,  zn = z * rsqrt(p)
//   a     = clip(mean|zn|, 0.05, 1),  s2 = max(1 - a^2, 0.05)
//   llr   = clip(2 a zn / s2, -16, 16)             (written only on request)
//   u     = polar_transform(llr > 0)               (GF(2) butterfly)
//   info  = u[data positions 0 .. info_len-1],  crc = u[the 8 after them]
//   ok    = crc8(info) == crc  &&  any(info)
//
// Bound.  At batch row counts, bytes: per row 4 KB of chips and the index in,
// 4 * info_len bytes of info bits and one byte of verdict out (+ 4 KB of
// LLRs on request), and 1 KB of PN bits per distinct table row the indices
// name (rows that share a counter share it), for ~20 operations per
// element.  At the single-clip row counts (37, 800) the launch and its
// latency: 5 or 100 blocks on 132 SMs, three dependent DRAM round trips
// (tables; index and chips; PN bytes).  The chain this replaces ran ~35
// eager device kernels and two synchronous table uploads per call, and
// wrote and read back a 4 KB float PN row and the LLRs; here nothing but
// the outputs leaves the registers.
//
// Design.  One warp owns one row, as in payload_llr.cu: lane l holds
// elements l + 32k (k = 0..31) in registers, every warp-wide load is one
// contiguous run, and both row sums come from that one read through
// __shfl_xor_sync butterflies.  The PN bytes are read straight from the
// table row.  Each hard bit is the sign of the LLR value this kernel itself
// computed (so it equals the plain version's llr > 0), packed into one
// 32-bit word per lane: bit k is element l + 32k.  The butterfly stage s
// does x[e] ^= x[e + 2^s] where bit s of e is clear; the stages act on
// different index bits and so commute.  Stages 0-4 act on the lane bits,
// one __shfl_xor_sync each; stages 5-9 on the word's bits, one shift-and-
// mask each.  No memory is touched.  Each block copies the spec's two
// small tables (the role of every code position, 2 KB, and each info
// bit's CRC-8 column byte, <= 1 KB) into shared memory once; each lane then
// writes its info bits, XORs the CRC columns of its set info bits and
// collects the received CRC bits, and a warp XOR-reduce gives the computed
// and received CRC bytes.
//
// No TMA: chip row r starts at byte 764 + 4860 r, 4-byte aligned only, and
// TMA needs 16-byte-aligned addresses and strides.  For the same reason the
// chip loads are scalar (coalesced), not float4.  Rows are not padded: the
// warps past the last row of the ragged final block leave after the block's
// shared-memory fill.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowLen = 1024;              // N: code length = payload chips
constexpr int kPerLane = kRowLen / 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
payload_decode_kernel(const float* __restrict__ chips, long long chip_stride,
                      int chip_offset, const uint8_t* __restrict__ pn_bits,
                      long long pn_rows, const Index* __restrict__ pn_row,
                      const int16_t* __restrict__ role,
                      const uint8_t* __restrict__ crc_cols, int info_len,
                      float* __restrict__ llr_out,
                      int32_t* __restrict__ info_out,
                      uint8_t* __restrict__ ok_out, int n_rows) {
  // role[e]: data index of code position e (< info_len: info bit, else
  // CRC bit e - info_len), -1 if frozen; col[i]: CRC-8 of info bit i alone
  __shared__ int16_t s_role[kRowLen];
  __shared__ uint8_t s_col[kRowLen];
  for (int i = threadIdx.x; i < kRowLen; i += kThreads) {
    s_role[i] = role[i];
    if (i < info_len) s_col[i] = crc_cols[i];
  }
  __syncthreads();

  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform: whole warps leave together

  long long pr = static_cast<long long>(pn_row[row]);
  pr = pr < 0 ? 0 : (pr >= pn_rows ? pn_rows - 1 : pr);
  const float* c = chips + row * chip_stride + chip_offset;
  const uint8_t* p = pn_bits + pr * kRowLen;

  // ---- despread and the two row sums (one read) ---------------------------
  float z[kPerLane];
  float sq = 0.f, ab = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int e = lane + 32 * k;
    z[k] = c[e] * (2.f * static_cast<float>(p[e]) - 1.f);
    sq += z[k] * z[k];
    ab += fabsf(z[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(kFull, sq, o);
    ab += __shfl_xor_sync(kFull, ab, o);
  }
  // 1/sqrt(p) rounded once, through double: rsqrtf's ~2-ulp error is
  // magnified ~20-fold in the LLRs of rows whose amplitude nears the clip,
  // which on an H100 doubled their rms distance from a float64 reference
  const float inv = static_cast<float>(
      1.0 / sqrt(static_cast<double>(sq * (1.f / kRowLen) + 1e-20f)));
  const float amp = fminf(fmaxf(ab * (1.f / kRowLen) * inv, 0.05f), 1.f);
  const float sigma2 = fmaxf(1.f - amp * amp, 0.05f);
  const float two_amp = 2.f * amp;

  // ---- LLRs (on request) and the hard bits, one word per lane -------------
  float* o = llr_out ? llr_out + static_cast<long long>(row) * kRowLen
                     : nullptr;
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const float v =
        fminf(fmaxf(two_amp * (z[k] * inv) / sigma2, -16.f), 16.f);
    if (o) o[lane + 32 * k] = v;
    w |= static_cast<uint32_t>(v > 0.f) << k;
  }

  // ---- polar butterfly: stages 0-4 across lanes, 5-9 inside the word ------
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const uint32_t other = __shfl_xor_sync(kFull, w, 1 << s);
    if (!(lane & (1 << s))) w ^= other;
  }
  w ^= (w >> 1) & 0x55555555u;
  w ^= (w >> 2) & 0x33333333u;
  w ^= (w >> 4) & 0x0F0F0F0Fu;
  w ^= (w >> 8) & 0x00FF00FFu;
  w ^= (w >> 16) & 0x0000FFFFu;

  // ---- info bits out, CRC-8 of them, received CRC bits --------------------
  int32_t* info = info_out + static_cast<long long>(row) * info_len;
  uint32_t crc = 0, recv = 0;
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int r = s_role[lane + 32 * k];
    const uint32_t bit = (w >> k) & 1u;
    if (r < 0) continue;
    if (r < info_len) {
      info[r] = static_cast<int32_t>(bit);
      if (bit) {
        crc ^= s_col[r];
        any = true;
      }
    } else {
      recv |= bit << (r - info_len);
    }
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) {
    crc ^= __shfl_xor_sync(kFull, crc, o2);
    recv ^= __shfl_xor_sync(kFull, recv, o2);  // disjoint bits: XOR = OR
  }
  const bool any_set = __any_sync(kFull, any);
  if (lane == 0) ok_out[row] = (crc == recv) && any_set;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() (0 on success).
// ``llr`` may be null (no LLRs written); ``pn_row_is64`` selects int64 or
// int32 indices.
extern "C" int payload_decode_launch(
    const float* chips, long long chip_stride, int chip_offset,
    const void* pn_bits, long long pn_rows, const void* pn_row,
    int pn_row_is64, const void* role, const void* crc_cols, int info_len,
    float* llr, int32_t* info, uint8_t* ok, int n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bits = static_cast<const uint8_t*>(pn_bits);
  const auto* rl = static_cast<const int16_t*>(role);
  const auto* cols = static_cast<const uint8_t*>(crc_cols);
  if (pn_row_is64) {
    payload_decode_kernel<long long><<<blocks, kThreads, 0, st>>>(
        chips, chip_stride, chip_offset, bits, pn_rows,
        static_cast<const long long*>(pn_row), rl, cols, info_len, llr, info,
        ok, n_rows);
  } else {
    payload_decode_kernel<int32_t><<<blocks, kThreads, 0, st>>>(
        chips, chip_stride, chip_offset, bits, pn_rows,
        static_cast<const int32_t*>(pn_row), rl, cols, info_len, llr, info,
        ok, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
