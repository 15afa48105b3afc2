// GenASM-DC window batches on NVIDIA Hopper (sm_90a): two entry points,
// one device body.
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
// What it computes is the recurrence of _dc_kernel, not its block layout.
// The TPU kernel puts one alignment in each vector lane; here each thread
// owns one window: it builds its 5 x nw pattern-mask table from its pattern
// row (id 4, wildcard/sentinel, matches every character), carries
// R[k+1][nw] in registers, and scans its text i = w-1 .. 0.  Row d of step
// i reads R_old[d-1], R_old[d] and R_new[d-1]:
//   D = R_old[d-1]  S = shl1(D)  I = shl1(R_new[d-1])  M = shl1(R_old[d]) | PM
//   R_new[d] = D & S & I & M,   R_new[0] = shl1(R_old[0]) | PM.
// The update is in place, so R_old[d-1] is kept in a temporary before row
// d-1 is overwritten.  shl1 carries word j-1's MSB into word j's LSB.
// Blocks are 128 threads, the grid is ceil(B / 128), and the ragged tail
// is masked: rows are independent, so the batch needs no padding.
//
// What bounds it on this card: the traceback store.  At w = 64, k = 24 each
// window writes 38,400 B (v1) or 13,000 B (v2) against 128 B of input, so
// a batch of B windows moves about B * 38,400 B or B * 13,000 B to device
// memory; the bit operations are ~14 word ops per (i, d, word).  What the
// design does about it: nothing yet.  Each thread writes its own window,
// whose store lies 38 KB (13 KB) away from its neighbour's, so the stores
// do not coalesce; a batch-innermost store layout, or a kernel that runs
// DC and traceback for a whole window loop without storing, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kMaxK = 32;  // rows 0..kMaxK live in registers
constexpr int kBlock = 128;

template <int NW>
__device__ __forceinline__ void shl1(const uint32_t (&x)[NW], uint32_t (&y)[NW]) {
#pragma unroll
  for (int j = NW - 1; j >= 0; --j) {
    y[j] = (x[j] << 1) | (j > 0 ? (x[j - 1] >> 31) : 0u);
  }
}

template <int NW, bool STORE_MID>
__global__ void __launch_bounds__(kBlock)
dc_kernel(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
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
  // v1: [B, W, k+1, 3, NW]; v2: [B, W+1, k+1, NW]
  const size_t row_words = STORE_MID ? 3 * NW : NW;
  uint32_t* win = out + static_cast<size_t>(b) * (STORE_MID ? W : W + 1) * rows * row_words;

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
    uint32_t* step = win + static_cast<size_t>(i) * rows * row_words;

    uint32_t old_prev[NW];  // R_old[d-1]
    uint32_t sh[NW];
    shl1<NW>(R[0], sh);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      old_prev[j] = R[0][j];
      R[0][j] = sh[j] | cur[j];
    }
    if (STORE_MID) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        step[j] = R[0][j];
        step[NW + j] = 0xFFFFFFFFu;
        step[2 * NW + j] = 0xFFFFFFFFu;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) step[j] = R[0][j];
    }

#pragma unroll
    for (int d = 1; d <= kMaxK; ++d) {
      if (d <= k) {
        uint32_t s[NW], ins[NW], m[NW];
        shl1<NW>(old_prev, s);
        shl1<NW>(R[d - 1], ins);
        shl1<NW>(R[d], m);
#pragma unroll
        for (int j = 0; j < NW; ++j) m[j] |= cur[j];
        uint32_t* cell = step + static_cast<size_t>(d) * row_words;
        if (STORE_MID) {
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            cell[j] = m[j];
            cell[NW + j] = ins[j];
            cell[2 * NW + j] = old_prev[j];
          }
        }
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t r_old = R[d][j];
          R[d][j] = old_prev[j] & s[j] & ins[j] & m[j];
          old_prev[j] = r_old;
        }
        if (!STORE_MID) {
#pragma unroll
          for (int j = 0; j < NW; ++j) cell[j] = R[d][j];
        }
      }
    }
  }

  if (!STORE_MID) {  // boundary row i = W: all ones
    uint32_t* edge = win + static_cast<size_t>(W) * rows * row_words;
    for (int x = 0; x < rows * NW; ++x) edge[x] = 0xFFFFFFFFu;
  }

  int dm = k + 1;
#pragma unroll
  for (int d = kMaxK; d >= 0; --d) {
    if (d <= k && (R[d][NW - 1] >> 31) == 0u) dm = d;
  }
  d_min[b] = dm;
}

template <bool STORE_MID>
int launch(const void* texts, const void* patterns, void* d_min, void* out,
           int batch, int w, int k, int device, void* stream) {
  if (batch < 0 || k < 0 || k > kMaxK || w % kWordBits != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const dim3 grid((batch + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int8_t*>(texts);
  auto p = static_cast<const int8_t*>(patterns);
  auto dm = static_cast<int32_t*>(d_min);
  auto o = static_cast<uint32_t*>(out);
  switch (w / kWordBits) {
    case 1: dc_kernel<1, STORE_MID><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    case 2: dc_kernel<2, STORE_MID><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    case 3: dc_kernel<3, STORE_MID><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    case 4: dc_kernel<4, STORE_MID><<<grid, block, 0, s>>>(t, p, dm, o, batch, k); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 when the launch was accepted.
int genasm_dc_v1(const void* texts, const void* patterns, void* d_min, void* tb,
                 int batch, int w, int k, int device, void* stream) {
  return launch<true>(texts, patterns, d_min, tb, batch, w, k, device, stream);
}

int genasm_dc_v2(const void* texts, const void* patterns, void* d_min, void* r_store,
                 int batch, int w, int k, int device, void* stream) {
  return launch<false>(texts, patterns, d_min, r_store, batch, w, k, device, stream);
}

int genasm_dc_max_k() { return kMaxK; }

}  // extern "C"
