// BitAlign DC over linearized subgraphs on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the graph workload:
//   bitalign_dc  <- src/repro/kernels/bitalign.py::bitalign_dc_batch
//   (body _bitalign_kernel, tail mask _tail_mask_wm).
// Inputs, one row per lane b: bases [B, N] int8, succ_bits [B, N] uint32
// hopBits (bit h set <=> node i+1+h is a successor of node i), patterns
// [B, m_bits] int8 wildcard-padded, p_lens [B] int32.  Outputs: dists [B, N]
// int32, the first d whose MSB is 0 (else k+1), and, when r_out is not null,
// the status rows R [B, N, k+1, nw] uint32.  The graph mapper's filter passes
// no R (it keeps only dists); the align loop passes one for its traceback.
//
// What it computes is the recurrence of _bitalign_kernel, not its block
// layout.  Each thread owns one lane: it builds its 5 x nw pattern-mask table
// (id 4, wildcard/sentinel, matches every character; a base outside 0..4
// selects an all-zero mask) and its tail mask (word j clears its low
// clip(m_bits - p_len - 32 j, 0, 32) bits), then scans nodes i = N-1 .. 0:
//   comb[d]  = tail & AND of R_{i+1+h}[d] over the hops h < 16 set in succ[i]
//   R[0]     = (shl1(comb[0]) | PM[base[i]]) & tail
//   R[d]     = comb[d-1] & shl1(comb[d-1]) & shl1(R[d-1])
//              & (shl1(comb[d]) | PM[base[i]]) & tail
// comb is built in the R registers and updated in place, row by row, with
// the old row d-1 kept in a temporary.  shl1 carries word j-1's MSB into
// word j's LSB.
//
// The hop ring -- the last 16 nodes' R rows -- is 16 x (k+1) x nw words per
// lane (768 at k = 11, nw = 4; 800 at k = 24, nw = 2), more than a thread's
// 255 registers.  It lives in dynamic shared memory, laid out
// [16][k+1][nw][lanes] with the lane innermost, so the 32 threads of a warp
// touch 32 consecutive words (no bank conflicts).  Node i's rows go to slot
// i mod 16 (a rotating head instead of the reference's concatenate-shift);
// every slot starts as the tail rows, which is what a hop past N reads: the
// slot of node i+1+h >= N is never overwritten before node i reads it.  Each
// thread touches only its own column, so the block never synchronises.  A
// block is up to 32 lanes, fewer when 32 lanes' rings exceed the card's
// per-block shared memory (at k = 32, nw = 4); the ragged batch is masked.
//
// What bounds it on this card: neither bytes nor operations.  At the filter
// shape (B = 1,024, N = 1,536, m_bits = 128, k = 11) a call moves ~8 MB
// without R and ~300 MB with it, and does ~1 G int32 operations -- tens of
// microseconds at the card's rates.  One thread per lane runs an N-step
// dependent chain, and B = 1,024 lanes in 32-lane blocks busy only 32 SMs
// with one warp each; R stores from one thread land (k+1) x nw x N words
// from its neighbour's and do not coalesce.  The kernel is latency-bound.  A
// warp-parallel hop combine, a batch-innermost store and more lanes per SM
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kHops = 16;   // HOP_LIMIT (src/repro/core/segram/graph.py)
constexpr int kMaxK = 32;   // rows 0..kMaxK live in registers
constexpr int kMaxLanes = 32;

template <int NW>
__device__ __forceinline__ void shl1(const uint32_t (&x)[NW], uint32_t (&y)[NW]) {
#pragma unroll
  for (int j = NW - 1; j >= 0; --j) {
    y[j] = (x[j] << 1) | (j > 0 ? (x[j - 1] >> 31) : 0u);
  }
}

template <int NW>
__global__ void __launch_bounds__(kMaxLanes)
bitalign_kernel(const int8_t* __restrict__ bases, const uint32_t* __restrict__ succ,
                const int8_t* __restrict__ patterns, const int32_t* __restrict__ p_lens,
                int32_t* __restrict__ dists, uint32_t* __restrict__ r_out,
                int batch, int n, int k) {
  extern __shared__ uint32_t ring[];  // [kHops][k+1][NW][lanes]
  constexpr int M = NW * kWordBits;
  const int lanes = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * lanes + t;
  if (b >= batch) return;
  const int rows = k + 1;
  const size_t slot_words = static_cast<size_t>(rows) * NW * lanes;

  // tail: the wildcard tail past p_len is pre-matched (low bits held at 0)
  uint32_t tail[NW];
  const int pad = M - p_lens[b];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int below = min(max(pad - kWordBits * j, 0), kWordBits);
    tail[j] = below >= kWordBits ? 0u : ~((1u << below) - 1u);
  }

  // PM[c] bit g = 1 iff pattern char at bit g (= pat[M-1-g]) mismatches c
  const int8_t* pat = patterns + static_cast<size_t>(b) * M;
  uint32_t pm[kNumChars][NW];
#pragma unroll
  for (int c = 0; c < kNumChars; ++c)
#pragma unroll
    for (int j = 0; j < NW; ++j) pm[c][j] = 0u;
#pragma unroll
  for (int g = 0; g < M; ++g) {
    const int p = pat[M - 1 - g];
#pragma unroll
    for (int c = 0; c < kNumChars; ++c) {
      if (!(p == c || p == 4)) pm[c][g / kWordBits] |= 1u << (g % kWordBits);
    }
  }

  for (int s = 0; s < kHops; ++s) {
    uint32_t* slot = ring + s * slot_words + t;
    for (int d = 0; d < rows; ++d)
#pragma unroll
      for (int j = 0; j < NW; ++j) slot[(d * NW + j) * lanes] = tail[j];
  }

  const int8_t* lane_bases = bases + static_cast<size_t>(b) * n;
  const uint32_t* lane_succ = succ + static_cast<size_t>(b) * n;
  int32_t* lane_dists = dists + static_cast<size_t>(b) * n;
  uint32_t* lane_r = r_out ? r_out + static_cast<size_t>(b) * n * rows * NW : nullptr;

  uint32_t R[kMaxK + 1][NW];
  for (int i = n - 1; i >= 0; --i) {
    // comb: the tail rows ANDed with every successor's rows
    const uint32_t sb = lane_succ[i];
#pragma unroll
    for (int d = 0; d <= kMaxK; ++d)
#pragma unroll
      for (int j = 0; j < NW; ++j) R[d][j] = tail[j];
#pragma unroll 1
    for (int h = 0; h < kHops; ++h) {
      if ((sb >> h) & 1u) {
        const uint32_t* src = ring + ((i + 1 + h) & (kHops - 1)) * slot_words + t;
#pragma unroll
        for (int d = 0; d <= kMaxK; ++d) {
          if (d <= k) {
#pragma unroll
            for (int j = 0; j < NW; ++j) R[d][j] &= src[(d * NW + j) * lanes];
          }
        }
      }
    }

    // select PM[base[i]] (all zero for a base outside 0..4)
    const int c = lane_bases[i];
    uint32_t cur[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      cur[j] = 0u;
#pragma unroll
      for (int ch = 0; ch < kNumChars; ++ch) cur[j] = (c == ch) ? pm[ch][j] : cur[j];
    }

    // the DC step, in place over comb
    uint32_t old_prev[NW];  // comb[d-1]
    uint32_t sh[NW];
    shl1<NW>(R[0], sh);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      old_prev[j] = R[0][j];
      R[0][j] = (sh[j] | cur[j]) & tail[j];
    }
#pragma unroll
    for (int d = 1; d <= kMaxK; ++d) {
      if (d <= k) {
        uint32_t s[NW], ins[NW], m[NW];
        shl1<NW>(old_prev, s);
        shl1<NW>(R[d - 1], ins);
        shl1<NW>(R[d], m);
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t comb_d = R[d][j];
          R[d][j] = old_prev[j] & s[j] & ins[j] & (m[j] | cur[j]) & tail[j];
          old_prev[j] = comb_d;
        }
      }
    }

    uint32_t* dst = ring + (i & (kHops - 1)) * slot_words + t;
    uint32_t* cell = lane_r ? lane_r + static_cast<size_t>(i) * rows * NW : nullptr;
    int dm = k + 1;
#pragma unroll
    for (int d = kMaxK; d >= 0; --d) {
      if (d <= k) {
#pragma unroll
        for (int j = 0; j < NW; ++j) dst[(d * NW + j) * lanes] = R[d][j];
        if (cell) {
#pragma unroll
          for (int j = 0; j < NW; ++j) cell[d * NW + j] = R[d][j];
        }
        if ((R[d][NW - 1] >> 31) == 0u) dm = d;
      }
    }
    lane_dists[i] = dm;
  }
}

template <int NW>
int launch_nw(const int8_t* bases, const uint32_t* succ, const int8_t* patterns,
              const int32_t* p_lens, int32_t* dists, uint32_t* r_out, int batch,
              int n, int k, int max_smem, cudaStream_t stream) {
  const size_t per_lane = static_cast<size_t>(kHops) * (k + 1) * NW * sizeof(uint32_t);
  int lanes = kMaxLanes;
  while (lanes > 1 && per_lane * lanes > static_cast<size_t>(max_smem)) lanes /= 2;
  const size_t smem = per_lane * lanes;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bitalign_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + lanes - 1) / lanes), block(lanes);
  bitalign_kernel<NW><<<grid, block, smem, stream>>>(bases, succ, patterns, p_lens,
                                                     dists, r_out, batch, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted.  r_out may be
// null: the status rows are then not stored.
int bitalign_dc(const void* bases, const void* succ_bits, const void* patterns,
                const void* p_lens, void* dists, void* r_out, int batch, int n,
                int m_bits, int k, int device, void* stream) {
  if (batch < 0 || n < 0 || k < 0 || k > kMaxK || m_bits % kWordBits != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0 || n == 0) return cudaSuccess;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  auto bs = static_cast<const int8_t*>(bases);
  auto sb = static_cast<const uint32_t*>(succ_bits);
  auto pt = static_cast<const int8_t*>(patterns);
  auto pl = static_cast<const int32_t*>(p_lens);
  auto ds = static_cast<int32_t*>(dists);
  auto ro = static_cast<uint32_t*>(r_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m_bits / kWordBits) {
    case 1: return launch_nw<1>(bs, sb, pt, pl, ds, ro, batch, n, k, max_smem, s);
    case 2: return launch_nw<2>(bs, sb, pt, pl, ds, ro, batch, n, k, max_smem, s);
    case 3: return launch_nw<3>(bs, sb, pt, pl, ds, ro, batch, n, k, max_smem, s);
    case 4: return launch_nw<4>(bs, sb, pt, pl, ds, ro, batch, n, k, max_smem, s);
    default: return cudaErrorInvalidValue;
  }
}

int bitalign_max_k() { return kMaxK; }

}  // extern "C"
