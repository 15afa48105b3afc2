// GenASM-DC window batches on NVIDIA Hopper (sm_90a): two entry points.
//
// Replaces the two Pallas TPU kernels on the read-mapping main path:
//   * genasm_dc_v1  <- src/repro/kernels/genasm_dc.py::window_dc_batch
//     (body _dc_kernel): stores (M, I, D) for every (i, d),
//     out [B, w, k+1, 3, nw] uint32.
//   * genasm_dc_v2  <- src/repro/kernels/genasm_dc_v2.py::window_dc_batch_v2
//     (body _dc_kernel_v2): stores the status rows R for every i plus the
//     all-ones boundary row i = w, out [B, w+1, k+1, nw] uint32.
// Both also write d_min [B] int32: the first d whose MSB is 0, else k+1.
//
// What they compute is the recurrence of _dc_kernel, not its block layout:
// a 5 x nw pattern-mask table from the pattern row (id 4, wildcard /
// sentinel, matches every character; a text char outside 0..4 selects an
// all-zero mask), then a scan of the text i = w-1 .. 0 in which row d of
// step i reads R_old[d-1], R_old[d] and R_new[d-1]:
//   D = R_old[d-1]  S = shl1(D)  I = shl1(R_new[d-1])  M = shl1(R_old[d]) | PM
//   R_new[d] = D & S & I & M,   R_new[0] = shl1(R_old[0]) | PM.
// shl1 carries word j-1's MSB into word j's LSB.
//
// genasm_dc_v1: a per-row wavefront, one window per warp.
//   What bounds it on this card: the traceback store.  At w = 64, k = 24 a
//   window writes 38,400 B against 128 B of input, so B windows move about
//   B x 38,400 B to device memory; the bit operations are ~14 word ops per
//   (i, d, word).  The first design gave each window one thread: its store
//   lay 38 KB from its neighbour's, so no store coalesced, and B = 256
//   windows ran as 8 warps on 2 SMs.
//   What the design does about it: lane d owns row d and at step s works on
//   char i = w-1-(s-d); a window takes w+k steps.  Each step lane d receives
//   lane d-1's newest row, R_new[d-1] at i, by __shfl_up_sync, and keeps the
//   row it received one step before, R_old[d-1] at i+1.  The pattern masks
//   are built by ballots (lane t supplies bit t) and live in registers; the
//   text is staged in shared memory.  The window's whole (M, I, D) store is
//   built in shared memory (38,400 B at w = 64, k = 24; at most 202,752 B at
//   w = 128, k = 32, so one warp per block) and written out at the end with
//   16-byte coalesced stores: a window's 384 nw^2 (k+1) B is a multiple of
//   16.  d_min is the first set bit of a ballot of "MSB is 0" over the rows.
//   At k = 32 (33 rows) lane 0 also runs row 32, one step behind lane 31,
//   fed by a broadcast from lane 31.  B windows are B blocks of one warp.
//   What still holds it back (tools/kernel_times.py; NVIDIA H100 80GB HBM3,
//   700.00 W): at B = 256 the kernel takes 0.0131 ms of device time, 4.5x
//   its bound, and 0.0116-0.0158 ms for any B from 32 to 512: the chain of
//   w+k = 88 steps sets it, ~130 ns a step, and a window's store leaves
//   only after its last step.  From B = 1,024 (0.031 ms, 39 MB) the store's
//   bytes start to show.  Through the wrapper, a launch costs 0.025-0.033
//   ms of host time, twice the kernel.
//
// genasm_dc_v2: one thread per window, in 128-thread blocks (the ragged tail
//   masked), R[k+1][nw] in registers, updated in place with R_old[d-1] kept
//   in a temporary.  What bounds it: its R store, 13,000 B a window at w = 64,
//   k = 24.  It keeps the first design, whose faults v1 had: each thread
//   writes its own window, 13 KB from its neighbour's, so the stores do not
//   coalesce, and B = 256 windows run on 2 SMs.  It is the next kernel to
//   redesign (v1's wavefront with an R store, or a kernel that runs DC and
//   traceback for a whole window loop without storing).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kMaxK = 32;  // v1: rows 0..31 on lanes 0..31, row 32 on lane 0
constexpr int kBlock = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int NW>
__device__ __forceinline__ void shl1(const uint32_t (&x)[NW], uint32_t (&y)[NW]) {
#pragma unroll
  for (int j = NW - 1; j >= 0; --j) {
    y[j] = (x[j] << 1) | (j > 0 ? (x[j - 1] >> 31) : 0u);
  }
}

// v1's (M, I, D) store of one window, in 32-bit words
__host__ __device__ constexpr size_t window_words(int nw, int k) {
  return static_cast<size_t>(nw) * kWordBits * (k + 1) * 3 * nw;
}

// One row of v1 at char i.  `held` is R_old[d-1] (all ones before the first
// char), `in` is R_new[d-1]; row 0 ignores both.  Writes (M, I, D) to the
// window's shared-memory store and returns R_new[d] in `own`.
template <int NW>
__device__ __forceinline__ void v1_row(uint32_t* st, const int8_t* txt,
                                       const uint32_t (&pm)[kNumChars][NW], int i,
                                       int d, int rows, bool first, uint32_t (&own)[NW],
                                       uint32_t (&held)[NW], const uint32_t (&in)[NW]) {
  const int c = txt[i];
  uint32_t m[NW];
  shl1<NW>(own, m);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint32_t cur = 0u;
#pragma unroll
    for (int ch = 0; ch < kNumChars; ++ch) cur = (c == ch) ? pm[ch][j] : cur;
    m[j] |= cur;
  }
  uint32_t* cell = st + (static_cast<size_t>(i) * rows + d) * 3 * NW;
  if (first) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      cell[j] = m[j];
      cell[NW + j] = 0xFFFFFFFFu;
      cell[2 * NW + j] = 0xFFFFFFFFu;
      own[j] = m[j];
    }
    return;
  }
  uint32_t s[NW], ins[NW];
  shl1<NW>(held, s);
  shl1<NW>(in, ins);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    cell[j] = m[j];
    cell[NW + j] = ins[j];
    cell[2 * NW + j] = held[j];
    own[j] = held[j] & s[j] & ins[j] & m[j];
    held[j] = in[j];
  }
}

// EXTRA: k = 32, row 32 on lane 0.  One warp per block, one window per warp.
template <int NW, bool EXTRA>
__global__ void __launch_bounds__(32)
dc_wave_v1(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
           int32_t* __restrict__ d_min, uint32_t* __restrict__ out, int k) {
  constexpr int W = NW * kWordBits;
  extern __shared__ uint4 smem4[];
  const int rows = k + 1;
  const size_t words = window_words(NW, k);
  uint32_t* st = reinterpret_cast<uint32_t*>(smem4);  // [W][k+1][3][NW]
  int8_t* txt = reinterpret_cast<int8_t*>(st + words);  // [W]
  const int b = blockIdx.x, lane = threadIdx.x;
  const int8_t* text = texts + static_cast<size_t>(b) * W;
  const int8_t* pat = patterns + static_cast<size_t>(b) * W;

  for (int x = lane; x < W; x += 32) txt[x] = text[x];
  // PM[c] bit q = 1 iff pattern char at bit q (= pat[W-1-q]) mismatches c
  uint32_t pm[kNumChars][NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int p = pat[W - 1 - (kWordBits * j + lane)];
#pragma unroll
    for (int c = 0; c < kNumChars; ++c) pm[c][j] = __ballot_sync(kFull, !(p == c || p == 4));
  }
  __syncwarp();

  // own: R_old[d] (then R_new[d]); held: R_old[d-1]; row 32's on lane 0
  uint32_t own[NW], held[NW], own32[NW], held32[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) own[j] = held[j] = own32[j] = held32[j] = 0xFFFFFFFFu;

  for (int s = 0; s < W + k; ++s) {
    uint32_t in[NW], in32[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      in[j] = __shfl_up_sync(kFull, own[j], 1);
      if (EXTRA) in32[j] = __shfl_sync(kFull, own[j], 31);
    }
    const int i = W - 1 - s + lane;
    if (lane <= k && i >= 0 && i < W)
      v1_row<NW>(st, txt, pm, i, lane, rows, lane == 0, own, held, in);
    if (EXTRA && lane == 0) {
      const int i32 = W - 1 - s + kMaxK;
      if (i32 >= 0 && i32 < W)
        v1_row<NW>(st, txt, pm, i32, kMaxK, rows, false, own32, held32, in32);
    }
  }

  const unsigned zero_msb = __ballot_sync(kFull, lane <= k && (own[NW - 1] >> 31) == 0u);
  const unsigned zero_msb32 =
      __ballot_sync(kFull, EXTRA && lane == 0 && (own32[NW - 1] >> 31) == 0u);
  if (lane == 0)
    d_min[b] = zero_msb ? __ffs(zero_msb) - 1 : (zero_msb32 ? kMaxK : k + 1);
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * words);
  for (size_t x = lane; x < words / 4; x += 32) dst[x] = smem4[x];
}

template <int NW>
__global__ void __launch_bounds__(kBlock)
dc_kernel_v2(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
             int32_t* __restrict__ d_min, uint32_t* __restrict__ out, int batch, int k) {
  constexpr int W = NW * kWordBits;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int8_t* text = texts + static_cast<size_t>(b) * W;
  const int8_t* pat = patterns + static_cast<size_t>(b) * W;

  // PM[c] bit g = 1 iff pattern char at bit g (= pat[W-1-g]) mismatches c.
  // Every index below is a compile-time constant after unrolling, so the
  // table stays in registers.
  uint32_t pm[kNumChars][NW];
#pragma unroll
  for (int c = 0; c < kNumChars; ++c)
#pragma unroll
    for (int j = 0; j < NW; ++j) pm[c][j] = 0u;
#pragma unroll
  for (int g = 0; g < W; ++g) {
    const int p = pat[W - 1 - g];
#pragma unroll
    for (int c = 0; c < kNumChars; ++c) {
      if (!(p == c || p == 4)) pm[c][g / kWordBits] |= 1u << (g % kWordBits);
    }
  }

  uint32_t R[kMaxK + 1][NW];
#pragma unroll
  for (int d = 0; d <= kMaxK; ++d)
#pragma unroll
    for (int j = 0; j < NW; ++j) R[d][j] = 0xFFFFFFFFu;

  const int rows = k + 1;
  uint32_t* win = out + static_cast<size_t>(b) * (W + 1) * rows * NW;  // [W+1, k+1, NW]

  for (int i = W - 1; i >= 0; --i) {
    // select PM[text[i]] (0 for a char outside 0..4, as _dc_kernel does)
    const int c = text[i];
    uint32_t cur[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      cur[j] = 0u;
#pragma unroll
      for (int ch = 0; ch < kNumChars; ++ch) cur[j] = (c == ch) ? pm[ch][j] : cur[j];
    }
    uint32_t* step = win + static_cast<size_t>(i) * rows * NW;

    uint32_t old_prev[NW];  // R_old[d-1]
    uint32_t sh[NW];
    shl1<NW>(R[0], sh);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      old_prev[j] = R[0][j];
      R[0][j] = sh[j] | cur[j];
      step[j] = R[0][j];
    }

#pragma unroll
    for (int d = 1; d <= kMaxK; ++d) {
      if (d <= k) {
        uint32_t s[NW], ins[NW], m[NW];
        shl1<NW>(old_prev, s);
        shl1<NW>(R[d - 1], ins);
        shl1<NW>(R[d], m);
        uint32_t* cell = step + static_cast<size_t>(d) * NW;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t r_old = R[d][j];
          R[d][j] = old_prev[j] & s[j] & ins[j] & (m[j] | cur[j]);
          old_prev[j] = r_old;
          cell[j] = R[d][j];
        }
      }
    }
  }

  // boundary row i = W: all ones
  uint32_t* edge = win + static_cast<size_t>(W) * rows * NW;
  for (int x = 0; x < rows * NW; ++x) edge[x] = 0xFFFFFFFFu;

  int dm = k + 1;
#pragma unroll
  for (int d = kMaxK; d >= 0; --d) {
    if (d <= k && (R[d][NW - 1] >> 31) == 0u) dm = d;
  }
  d_min[b] = dm;
}

using V1Fn = void (*)(const int8_t*, const int8_t*, int32_t*, uint32_t*, int);

template <int NW>
V1Fn pick_v1(bool extra) {
  return extra ? dc_wave_v1<NW, true> : dc_wave_v1<NW, false>;
}

V1Fn pick_v1_nw(int nw, bool extra) {
  switch (nw) {
    case 1: return pick_v1<1>(extra);
    case 2: return pick_v1<2>(extra);
    case 3: return pick_v1<3>(extra);
    case 4: return pick_v1<4>(extra);
    default: return nullptr;
  }
}

// v1's dynamic shared memory per block: the window's store and its text
size_t v1_smem(int w, int k) { return window_words(w / kWordBits, k) * 4 + w; }

bool bad_args(int batch, int w, int k) {
  return batch < 0 || k < 0 || k > kMaxK || w % kWordBits != 0;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 when the launch was accepted.
int genasm_dc_v1(const void* texts, const void* patterns, void* d_min, void* tb,
                 int batch, int w, int k, int device, void* stream) {
  if (bad_args(batch, w, k)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  V1Fn kern = pick_v1_nw(w / kWordBits, k == kMaxK);
  if (!kern) return cudaErrorInvalidValue;
  const size_t smem = v1_smem(w, k);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(texts), static_cast<const int8_t*>(patterns),
      static_cast<int32_t*>(d_min), static_cast<uint32_t*>(tb), k);
  return cudaGetLastError();
}

int genasm_dc_v2(const void* texts, const void* patterns, void* d_min, void* r_store,
                 int batch, int w, int k, int device, void* stream) {
  if (bad_args(batch, w, k)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const dim3 grid((batch + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int8_t*>(texts);
  auto p = static_cast<const int8_t*>(patterns);
  auto dm = static_cast<int32_t*>(d_min);
  auto o = static_cast<uint32_t*>(r_store);
  switch (w / kWordBits) {
    case 1: dc_kernel_v2<1><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    case 2: dc_kernel_v2<2><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    case 3: dc_kernel_v2<3><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    case 4: dc_kernel_v2<4><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The launch genasm_dc_v1 makes: out[0] warps in the grid, out[1] blocks,
// out[2] dynamic shared memory per block in bytes.
int genasm_dc_v1_geometry(int batch, int w, int k, int* out) {
  if (bad_args(batch, w, k) || w / kWordBits < 1 || w / kWordBits > 4)
    return cudaErrorInvalidValue;
  out[0] = batch;
  out[1] = batch;
  out[2] = static_cast<int>(v1_smem(w, k));
  return 0;
}

int genasm_dc_max_k() { return kMaxK; }

}  // extern "C"
