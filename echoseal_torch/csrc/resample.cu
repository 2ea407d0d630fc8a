// Rational polyphase resample for Hopper (sm_90a): scipy resample_poly's
// output on the plan's lattice, for a set of rows of a clip batch, in one
// kernel.  Per output row r (input row rows[r], fp32, length T) and output
// o = j * up + n (lattice block j, phase n < up):
//   y[r, o] = sum_{t < K} x[rows[r], j * down + s0 + off[n] + t] * taps[n, t]
// for o < n_out, reading zero outside [0, T); y[r, o] = 0 for n_out <= o <
// width.  taps (up, K) fp32 and off (up,) int32 are one plan of
// echoseal_torch/ops/resample.py::resample_plan; sums are fp32, in tap order.
//
// Replaces no Pallas kernel: echoseal_tpu/ops/resample.py::_resample_stage is
// K shifted gathers and multiply-adds that XLA fuses on the TPU.  The port
// ran it as torch ops: per tap an index_select materialising a (rows, 216 000)
// copy and an addcmul_ into the accumulator over a strided tap column, about
// five row widths of traffic a tap, 52 launches a row chunk, behind a pad of
// the input, a copy of the group's rows and a fill of the tail: 17 ms for a
// group of 310 recovery rows (H100), some 63 ms of card time a 1024-clip
// recovery call.
//
// Bound.  Each input sample is read and each output written once: for the
// recovery's 1 125 rows of 184 384 samples a call, 1.66 GB, 0.50 ms at 3.35
// TB/s.  The operations (2 K a output, K = 26) are 11 GFLOP, 0.16 ms at 67
// TFLOP/s.  So the resample is bound by device memory.
//
// Design.  The taps depend on the phase alone, so a block owns a tile of
// up to kThreads consecutive phases, thread i the phase of output i of the
// tile, and walks over items: (row, lattice block) pairs, kItems a stage.
// For up below the tile the lattice is taken m = tile / up blocks at a time
// (phase s of the m-block lattice is block s / up, phase s % up), so a tile
// is never mostly idle.  The input that a tile's outputs of one item reach
// is one run of at most ceil((tile - 1) down / up) + K samples (consecutive
// outputs start at most ceil(down / up) apart); the tile is kThreads
// outputs unless that run would pass kMaxSpan, and narrower for the widest
// decimations.  The block copies each item's run into shared memory with
// cp.async (16 bytes a copy from the 16-byte boundary below the run where
// the rows are aligned, else 4; zeros outside the row), the next stage's
// copies in flight while the outputs of this one are formed from shared
// memory and stored, coalesced.  A thread holds kSlice taps of its phase in
// registers and sums an item's outputs slice by slice, in tap order, over
// zero taps past K, with no test in the loop.  Where K fits one slice (the
// recovery's and the 44.1 kHz family, K = 24-26) the slice is read once, a
// tile's table coalesced through shared memory, and kept for the whole
// kernel; a wider K reads each slice again every stage (from L2: the table
// is read by every stage, against the kItems outputs it serves).  Items
// whose outputs all lie at or past n_out copy nothing and store zeros.  The
// rows come by index and the output is as wide as the caller keeps, so no
// copy of the rows, no padded input and no fill exists.  Blocks take about
// kStages stages each, in many waves.
//
// Measured (H100 80GB HBM3, 700 W): 1.70 ms for 1 125 x 184 384 at key 11 640
// (the torch loop 62 ms), 29 % of the bytes' bound.  The copies alone take
// 1.1-1.2 ms and the products alone about 1.0 ms (26 shared-memory loads and
// fused multiply-adds an output), and the two overlap only in part; more
// items a stage made it slower, and 4-byte copies too.  A 384 kHz capture
// to 48 kHz (K = 164, six slices): 2.29 ms for 64 rows of 3.5 s, the loop
// 31.8 ms.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;     // threads a block: outputs of a tile, at most
constexpr int kItems = 8;         // (row, lattice block) items a stage
constexpr int kStages = 32;       // stages a block, about
constexpr int kSlice = 28;        // taps a thread holds in registers
// staged samples an item: ceil((tile - 1) down / up) + K rounded up to
// whole slices, and up to 6 more for the 16-byte copies
constexpr int kMaxSpan = 3200;
// taps a phase: a tile of one output still fits the span (resample.py's
// RESAMPLE_MAX_K)
constexpr int kMaxK = 3072;
// the stage buffers, or the tile's taps while they are read in
constexpr int kMaxSmem = 2 * kItems * kMaxSpan * sizeof(float);  // 200 KB

// asynchronous copy of ``bytes`` (0 to BYTES) of ``src`` into ``dst``,
// zeros after them; with ``bytes`` 0 nothing is read, but ``src`` must still
// be a valid address
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  }
}

// items it0 .. it0 + kItems - 1 as (row r, lattice step g) pairs, item it
// being it = r * n_super + g: one division a stage
__device__ __forceinline__ void items_at(int it0, int n_super, int* r,
                                         int* g) {
  const int r0 = it0 / n_super;
  const int g0 = it0 - r0 * n_super;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int rk = r0, gk = g0 + k;
    if (gk >= n_super) {                       // the stage crosses a row
      rk += gk / n_super;
      gk -= (gk / n_super) * n_super;
    }
    r[k] = rk;
    g[k] = gk;
  }
}

// where item (g, tile) starts reading: the run's first sample, and (VEC)
// that sample's offset past the 16-byte boundary below it, where the
// staged copy starts
template <bool VEC>
__device__ __forceinline__ int lead(long long base) {
  return VEC ? static_cast<int>(base & 3) : 0;
}

// stage items it0 .. it0 + kItems - 1: each item's input run into its slot,
// zeros outside the row
template <bool VEC>
__device__ __forceinline__ void stage(
    float* buf, int it0, int n_items, int n_super, const float* x,
    long long ldx, int T, const long long* rows, int n_rows, int ups,
    long long downs, long long first, int s_first, int span, int n_out) {
  int r[kItems], g[kItems];
  items_at(it0, n_super, r, g);
  long long ro[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {           // independent loads
    ro[k] = rows[min(r[k], n_rows - 1)] * ldx;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (it0 + k >= n_items) break;
    if (static_cast<long long>(g[k]) * ups + s_first >= n_out) continue;
    const float* xr = x + ro[k];
    const long long base = g[k] * downs + first;
    const long long q0 = base - lead<VEC>(base);
    constexpr int W = VEC ? 4 : 1;             // samples a copy
    for (int i = threadIdx.x; i < span / W; i += kThreads) {
      const long long q = q0 + static_cast<long long>(W) * i;
      // q >= 0 or the whole copy lies before the row (q is aligned)
      const long long n = q < 0 ? 0 : min(static_cast<long long>(W), T - q);
      const int bytes = n > 0 ? static_cast<int>(4 * n) : 0;
      copy_async<4 * W>(buf + k * span + W * i, bytes ? xr + q : xr, bytes);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
resample_kernel(const float* __restrict__ x, long long ldx, int T,
                const long long* __restrict__ rows, int n_rows,
                const float* __restrict__ taps, const int* __restrict__ off,
                int up, int K, int down, int s0, int tile, int m, int span,
                int n_out, float* __restrict__ y, int width, int n_super) {
  extern __shared__ __align__(16) float sh[];
  const int ups = m * up;                       // outputs a lattice step
  const long long downs = static_cast<long long>(m) * down;
  const int s_first = blockIdx.x * tile;
  const int s = s_first + threadIdx.x;
  const bool active = threadIdx.x < tile && s < ups;
  const int n_slices = (K + kSlice - 1) / kSlice;
  // the input offset of the tile's first output, and this thread's past it
  const long long off_first =
      static_cast<long long>(s_first / up) * down + off[s_first % up];
  const long long first = s0 + off_first;
  const float* trow = taps + static_cast<long long>(active ? s % up : 0) * K;
  float w[kSlice];
  if (n_slices == 1) {
    // the tile's taps through shared memory (coalesced reads of the
    // table), into registers for the whole kernel, zero past K
    for (int j = threadIdx.x; j < tile * K; j += kThreads) {
      const int si = s_first + j / K;
      sh[j] = si < ups ? taps[static_cast<long long>(si % up) * K + j % K]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kSlice; ++t) {
      w[t] = active && t < K ? sh[threadIdx.x * K + t] : 0.0f;
    }
  }
  int local = 0;
  bool bad = false;
  if (active) {
    local = static_cast<int>(static_cast<long long>(s / up) * down +
                             off[s % up] - off_first);
    // the run holds every sample the thread reads: not a resample_plan
    // table otherwise
    bad = local < 0 || local + (VEC ? 3 : 0) + n_slices * kSlice > span;
    if (bad) local = 0;
  }
  __syncthreads();
  const int n_items = n_rows * n_super;        // < 2**30 (the launcher)
  const int stride = gridDim.y * kItems;
  int it0 = blockIdx.y * kItems;
  // two buffers: a stage's copies are in flight while the last one's
  // outputs are formed
  if (it0 < n_items) {
    stage<VEC>(sh, it0, n_items, n_super, x, ldx, T, rows, n_rows, ups,
               downs, first, s_first, span, n_out);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int st = 0; it0 < n_items; ++st, it0 += stride) {
    const float* cur = sh + (st & 1) * kItems * span;
    if (it0 + stride < n_items) {
      stage<VEC>(sh + ((st + 1) & 1) * kItems * span, it0 + stride, n_items,
                 n_super, x, ldx, T, rows, n_rows, ups, downs, first,
                 s_first, span, n_out);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    int r[kItems], g[kItems];
    items_at(it0, n_super, r, g);
    // each item's first staged sample for this thread (items past the
    // last, or wholly past n_out, read whatever the slot holds and are
    // not stored)
    int at[kItems];
    float acc[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      at[k] = k * span + lead<VEC>(g[k] * downs + first) + local;
      acc[k] = 0.0f;
    }
    for (int c = 0; c < n_slices; ++c) {
      if (n_slices > 1) {
#pragma unroll
        for (int t = 0; t < kSlice; ++t) {
          const int tt = c * kSlice + t;
          w[t] = tt < K ? __ldg(trow + tt) : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const float* p = cur + at[k] + c * kSlice;
#pragma unroll
        for (int t = 0; t < kSlice; ++t) acc[k] = fmaf(p[t], w[t], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (it0 + k >= n_items) break;
      const long long o = static_cast<long long>(g[k]) * ups + s;
      if (!active || o >= width) continue;
      y[static_cast<long long>(r[k]) * width + o] =
          o >= n_out ? 0.0f : bad ? nanf("") : acc[k];
    }
    __syncthreads();
  }
}

}  // namespace

// y (n_rows, width) = the resample of x's rows ``rows`` (see the top); x
// (B, T) fp32 with row stride ldx, rows (n_rows,) int64 in [0, B), taps
// (up, K) fp32 and off (up,) int32 contiguous.  Returns 0, 22 for arguments
// the kernel does not take (checked by the caller too), or a cudaError.
extern "C" int resample_launch(const float* x, long long ldx, int T,
                               const long long* rows, int n_rows,
                               const float* taps, const int* off, int up,
                               int K, int down, int s0, int n_out, float* y,
                               int width, void* stream) {
  if (up < 1 || down < 1 || K < 1 || K > kMaxK || T < 1 || n_rows < 0 ||
      width < 0 || n_out < 0) {
    return 22;
  }
  // the widest tile, at most kThreads outputs, whose run of input samples
  // fits a slot: ceil((tile - 1) down / up) + the slices' taps + 6 samples
  // of the 16-byte copies' lead and rounding
  const long long kpad = (K + kSlice - 1) / kSlice * kSlice;
  const long long room = kMaxSpan - 6 - kpad;
  long long tile = room * up / down + 1;
  if (tile > kThreads) tile = kThreads;
  const long long need = ((tile - 1) * down + up - 1) / up + kpad;
  const int span = static_cast<int>((need + 6) / 4 * 4);
  const int m = up >= tile ? 1 : static_cast<int>(tile / up);
  if (static_cast<long long>(m) * down >= (1LL << 31)) return 22;
  if (n_rows == 0 || width == 0) return 0;
  const long long n_super =
      (static_cast<long long>(width) + m * up - 1) / (m * up);
  if (n_super * n_rows > (1LL << 30)) return 22;
  const int tiles = static_cast<int>((m * up + tile - 1) / tile);
  // the stage buffers, or the tile's taps while a single slice is read in
  const long long table = K <= kSlice ? tile * K : 0;
  const size_t smem =
      sizeof(float) * (2 * kItems * span > table ? 2 * kItems * span : table);
  // 16-byte copies where every row starts on a 16-byte boundary
  const bool vec = reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                   ldx % 4 == 0;
  auto kernel = vec ? resample_kernel<true> : resample_kernel<false>;
  static bool ready[2][64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 0 || dev >= 64) return 22;
  if (!ready[vec][dev]) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ready[vec][dev] = true;
  }
  int sms = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long stages = (n_super * n_rows + kItems - 1) / kItems;
  // many waves of blocks of about kStages stages each, so that no SM idles
  // long at the end; a small group's stages spread over the SMs, 4 blocks
  // an SM
  long long strides = (stages + kStages - 1) / kStages;
  const long long spread = (4LL * sms + tiles - 1) / tiles;
  if (strides < spread) strides = stages < spread ? stages : spread;
  if (strides > 65535) strides = 65535;
  if (strides < 1) strides = 1;
  kernel<<<dim3(tiles, static_cast<unsigned>(strides)), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, ldx, T, rows, n_rows, taps, off, up, K, down, s0,
      static_cast<int>(tile), m, span, n_out, y, width,
      static_cast<int>(n_super));
  return static_cast<int>(cudaGetLastError());
}
