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
// What bounds them on this card: the traceback store.  At w = 64, k = 24 a
// v1 window writes 38,400 B and a v2 window 13,000 B against 128 B of
// input; the bit operations are ~14 word ops per (i, d, word).  The first
// design gave each window one thread: its store lay 13-38 KB from its
// neighbour's, so no store coalesced, and B = 256 windows ran as 8 warps
// on 2 SMs.
//
// The design, one wavefront body (dc_wave) for both entry functions
// (dc_wave_v1, dc_wave_v2):
// each window is one warp.  Lane d owns row d and at step s works on char
// i = w-1-(s-d); a window takes w+k steps.  Each step lane d receives lane
// d-1's newest row, R_new[d-1] at i, by __shfl_up_sync, and keeps the row
// it received one step before, R_old[d-1] at i+1.  The pattern masks are
// built by ballots (lane t supplies bit t) and live in registers; the text
// is staged in shared memory.  At k = 32 (33 rows) lane 0 also runs row
// 32, one step behind lane 31, fed by a broadcast from lane 31.  d_min is
// the first set bit of a ballot of "MSB is 0" over the rows.  The only
// difference between the two is what a row writes to the window's store,
// which is built in shared memory and written out coalesced at the end:
// v1 writes (M, I, D), v2 writes R_new[d] and the all-ones row i = w.
//
// The write-out.  A block holds P windows, one a warp, and writes their
// stores as one contiguous region of device memory.  v1: P = 1; a window
// is 384 nw^2 (k+1) B, a multiple of 16, so the region is 16-byte aligned.
// v2: P = 4 (3 at w = 128 from k = 28: four such windows, 61,920-68,112 B
// each, do not fit a block's 227 KB).  A v2 window, (w+1)(k+1) nw words, is not a multiple of 16
// B (13,000 B at w = 64, k = 24; 132 B at w = 32, k = 0), so a block's
// region can start 4 or 8 bytes past a 16-byte boundary and end anywhere.
// The block lays its stores in shared memory at the same word offset
// modulo 4 as in device memory, then peels an unaligned head of up to 3
// words, copies the body with 16-byte stores on both sides, and writes a
// tail of up to 3 words.  With P = 4 the head is always empty; the tail is
// not (a ragged last block of odd-sized windows).
//
// Measured (tools/kernel_times.py, device time; NVIDIA H100 80GB HBM3,
// 700.00 W), B = 256, w = 64, k = 24: v1 0.0136-0.0138 ms, 4.6x its
// bound (0.0131-0.0132 before v2 shared its body and write-out; a direct
// 16-byte copy for v1 in place of the shared write-out measured slower,
// 0.0140-0.0142 ms), and
// 0.0116-0.0158 ms for any B from 32 to 512; v2 0.0111-0.0113 ms, 11x its
// bound, against 0.426-0.429 ms for the first v2 design.  The chain of
// w+k = 88 steps sets both, ~130 ns a step, and a window's store leaves
// only after its last step.  Through the wrapper a launch costs 0.02-0.05
// ms of host time, more than the kernel.  What still holds them back: the
// 88-step chain of one warp, and (v2) the traceback that reads R
// afterwards from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kMaxK = 32;  // rows 0..31 on lanes 0..31, row 32 on lane 0
constexpr int kV2Windows = 4;  // v2 windows a block, where they fit
constexpr int kSmemOptin = 232448;  // dynamic shared memory a block, sm_90
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int NW>
__device__ __forceinline__ void shl1(const uint32_t (&x)[NW], uint32_t (&y)[NW]) {
#pragma unroll
  for (int j = NW - 1; j >= 0; --j) {
    y[j] = (x[j] << 1) | (j > 0 ? (x[j - 1] >> 31) : 0u);
  }
}

// One window's store in 32-bit words: v1 (M, I, D) [w][k+1][3][nw],
// v2 R [w+1][k+1][nw]
__host__ __device__ constexpr size_t window_words(bool r_only, int nw, int k) {
  return r_only ? static_cast<size_t>(nw) * (nw * kWordBits + 1) * (k + 1)
                : static_cast<size_t>(nw) * kWordBits * (k + 1) * 3 * nw;
}

// One row at char i.  `held` is R_old[d-1] (all ones before the first
// char), `in` is R_new[d-1]; row 0 ignores both.  Writes the row's part of
// the window's shared-memory store -- (M, I, D) for v1, R_new[d] for v2 --
// and returns R_new[d] in `own`.
template <int NW, bool R_ONLY>
__device__ __forceinline__ void dc_row(uint32_t* st, const int8_t* txt,
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
  uint32_t* cell = st + (static_cast<size_t>(i) * rows + d) * (R_ONLY ? 1 : 3) * NW;
  if (first) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (R_ONLY) {
        cell[j] = m[j];
      } else {
        cell[j] = m[j];
        cell[NW + j] = 0xFFFFFFFFu;
        cell[2 * NW + j] = 0xFFFFFFFFu;
      }
      own[j] = m[j];
    }
    return;
  }
  uint32_t s[NW], ins[NW];
  shl1<NW>(held, s);
  shl1<NW>(in, ins);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    own[j] = held[j] & s[j] & ins[j] & m[j];
    if (R_ONLY) {
      cell[j] = own[j];
    } else {
      cell[j] = m[j];
      cell[NW + j] = ins[j];
      cell[2 * NW + j] = held[j];
    }
    held[j] = in[j];
  }
}

// The body of both kernels.  EXTRA: k = 32, row 32 on lane 0.  One window
// per warp, blockDim.x / 32 windows per block (1 for v1).  Shared memory:
// the block's texts [P][W] bytes, then (v2) up to 3 words of alignment
// pad, then the P stores.
template <int NW, bool EXTRA, bool R_ONLY>
__device__ __forceinline__ void dc_wave(const int8_t* __restrict__ texts,
                                        const int8_t* __restrict__ patterns,
                                        int32_t* __restrict__ d_min,
                                        uint32_t* __restrict__ out, int batch, int k) {
  constexpr int W = NW * kWordBits;
  extern __shared__ uint4 smem4[];
  const int rows = k + 1;
  const size_t words = window_words(R_ONLY, NW, k);
  const int P = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * P + warp;
  const size_t s0 = static_cast<size_t>(blockIdx.x) * P * words;  // region start
  const int pad = R_ONLY ? static_cast<int>(s0 & 3u) : 0;
  int8_t* txt = reinterpret_cast<int8_t*>(smem4) + warp * W;
  uint32_t* region = reinterpret_cast<uint32_t*>(reinterpret_cast<int8_t*>(smem4) + P * W) + pad;
  uint32_t* st = region + warp * words;  // this window's store

  if (b < batch) {  // the whole warp: every lane shares b
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
    if (R_ONLY) {  // the boundary row i = W
      uint32_t* edge = st + static_cast<size_t>(W) * rows * NW;
      for (int x = lane; x < rows * NW; x += 32) edge[x] = 0xFFFFFFFFu;
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
        dc_row<NW, R_ONLY>(st, txt, pm, i, lane, rows, lane == 0, own, held, in);
      if (EXTRA && lane == 0) {
        const int i32 = W - 1 - s + kMaxK;
        if (i32 >= 0 && i32 < W)
          dc_row<NW, R_ONLY>(st, txt, pm, i32, kMaxK, rows, false, own32, held32, in32);
      }
    }

    const unsigned zero_msb = __ballot_sync(kFull, lane <= k && (own[NW - 1] >> 31) == 0u);
    const unsigned zero_msb32 =
        __ballot_sync(kFull, EXTRA && lane == 0 && (own32[NW - 1] >> 31) == 0u);
    if (lane == 0)
      d_min[b] = zero_msb ? __ffs(zero_msb) - 1 : (zero_msb32 ? kMaxK : k + 1);
  }
  __syncthreads();

  // region[x] goes to out[s0 + x]: a head of up to 3 words, a 16-byte body
  // aligned on both sides (region + pad + head is a multiple of 4 words),
  // and a tail of up to 3 words
  const size_t total = static_cast<size_t>(min(P, batch - static_cast<int>(blockIdx.x) * P)) * words;
  uint32_t* dst = out + s0;
  const size_t head = static_cast<size_t>((4 - pad) & 3) < total ? (4 - pad) & 3 : total;
  const size_t body = (total - head) / 4;
  if (threadIdx.x < head) dst[threadIdx.x] = region[threadIdx.x];
  uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
  const uint4* src4 = reinterpret_cast<const uint4*>(region + head);
  for (size_t x = threadIdx.x; x < body; x += blockDim.x) dst4[x] = src4[x];
  for (size_t x = head + 4 * body + threadIdx.x; x < total; x += blockDim.x) dst[x] = region[x];
}

template <int NW, bool EXTRA>
__global__ void __launch_bounds__(32)
dc_wave_v1(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
           int32_t* __restrict__ d_min, uint32_t* __restrict__ out, int batch, int k) {
  dc_wave<NW, EXTRA, false>(texts, patterns, d_min, out, batch, k);
}

// (minimum 1 block an SM: without it ptxas aims at a lower register count
// and spills)
template <int NW, bool EXTRA>
__global__ void __launch_bounds__(32 * kV2Windows, 1)
dc_wave_v2(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
           int32_t* __restrict__ d_min, uint32_t* __restrict__ out, int batch, int k) {
  dc_wave<NW, EXTRA, true>(texts, patterns, d_min, out, batch, k);
}

using WaveFn = void (*)(const int8_t*, const int8_t*, int32_t*, uint32_t*, int, int);

template <int NW, bool R_ONLY>
WaveFn pick(bool extra) {
  if (R_ONLY) return extra ? dc_wave_v2<NW, true> : dc_wave_v2<NW, false>;
  return extra ? dc_wave_v1<NW, true> : dc_wave_v1<NW, false>;
}

template <bool R_ONLY>
WaveFn pick_nw(int nw, bool extra) {
  switch (nw) {
    case 1: return pick<1, R_ONLY>(extra);
    case 2: return pick<2, R_ONLY>(extra);
    case 3: return pick<3, R_ONLY>(extra);
    case 4: return pick<4, R_ONLY>(extra);
    default: return nullptr;
  }
}

bool bad_args(int batch, int w, int k) {
  return batch < 0 || k < 0 || k > kMaxK || w % kWordBits != 0 || w / kWordBits < 1 ||
         w / kWordBits > 4;
}

struct Geometry {
  int windows;  // per block, one a warp
  size_t smem;  // dynamic shared memory per block, bytes
};

// v1: one window a block.  v2: up to kV2Windows a block, as many as fit,
// with 3 words of room for the alignment pad.
Geometry geometry(bool r_only, int w, int k) {
  const size_t words = window_words(r_only, w / kWordBits, k);
  const size_t pad = r_only ? 12 : 0;
  int p = r_only ? kV2Windows : 1;
  while (p > 1 && p * (w + words * 4) + pad > static_cast<size_t>(kSmemOptin)) --p;
  return {p, p * (w + words * 4) + pad};
}

int launch(bool r_only, const void* texts, const void* patterns, void* d_min, void* out,
           int batch, int w, int k, int device, void* stream) {
  if (bad_args(batch, w, k)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  WaveFn kern = r_only ? pick_nw<true>(w / kWordBits, k == kMaxK)
                       : pick_nw<false>(w / kWordBits, k == kMaxK);
  const Geometry g = geometry(r_only, w, k);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  kern<<<(batch + g.windows - 1) / g.windows, 32 * g.windows, g.smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(texts), static_cast<const int8_t*>(patterns),
      static_cast<int32_t*>(d_min), static_cast<uint32_t*>(out), batch, k);
  return cudaGetLastError();
}

int write_geometry(bool r_only, int batch, int w, int k, int* out) {
  if (bad_args(batch, w, k)) return cudaErrorInvalidValue;
  const Geometry g = geometry(r_only, w, k);
  out[0] = batch;
  out[1] = (batch + g.windows - 1) / g.windows;
  out[2] = static_cast<int>(g.smem);
  return 0;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 when the launch was accepted.
int genasm_dc_v1(const void* texts, const void* patterns, void* d_min, void* tb,
                 int batch, int w, int k, int device, void* stream) {
  return launch(false, texts, patterns, d_min, tb, batch, w, k, device, stream);
}

int genasm_dc_v2(const void* texts, const void* patterns, void* d_min, void* r_store,
                 int batch, int w, int k, int device, void* stream) {
  return launch(true, texts, patterns, d_min, r_store, batch, w, k, device, stream);
}

// The launch each entry makes: out[0] warps in the grid, out[1] blocks,
// out[2] dynamic shared memory per block in bytes.
int genasm_dc_v1_geometry(int batch, int w, int k, int* out) {
  return write_geometry(false, batch, w, k, out);
}

int genasm_dc_v2_geometry(int batch, int w, int k, int* out) {
  return write_geometry(true, batch, w, k, out);
}

int genasm_dc_max_k() { return kMaxK; }

}  // extern "C"
