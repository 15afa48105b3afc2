// The linear mapper's pre-alignment filter on NVIDIA Hopper (sm_90a): Bitap
// over every read's candidate regions, with the minimum and its first
// position fused.
//
// No Pallas kernel computes this: the reference runs it as plain XLA,
// src/repro/core/genasm_dc.py::bitap_search (a lax.scan over the region)
// followed by min and argmin in src/repro/core/mapper.py.  One entry point:
//   bitap_filter  <- bitap_search + min(-1) + argmin(-1) over [B, C] lanes.
// Inputs: ref [L] int8 (a reference buffer), starts [B, C] int64 (each lane's
// region start in the buffer), reads [B, stride] int8, read_lens [B] int64.
// Outputs: dist [B, C] int32, off [B, C] int32.
//
// What one lane (read b, candidate c) computes, exactly as the plain path:
//   * the region: `region` bases of ref from the start clamped into [0, L];
//     a position at or past L reads the sentinel 4;
//   * the pattern: the read's first m_bits bases, the wildcard 4 at and past
//     read_lens[b]; PM[c] bit q = 1 iff the pattern char at bit q, char
//     m_bits-1-q, mismatches text char c (id 4 in the pattern matches every
//     char; a text char outside 0..4 selects an all-zero mask);
//   * the scan, text position i = region-1 .. 0, from all-ones rows:
//       R[0] = shl1(R_old[0]) | PM[t_i]
//       R[d] = R_old[d-1] & shl1(R_old[d-1]) & (shl1(R_old[d]) | PM[t_i])
//              & shl1(R[d-1])                                   (d = 1..k)
//     where shl1 carries word j-1's MSB into word j; the distance at i is the
//     first d whose row has its top bit 0, else k+1;
//   * dist = the least distance over i, off = the smallest i that reaches it
//     (argmin's first occurrence; 0 when no i has a match).
//
// What bounds it on this card: operations.  A row costs 4 instructions a
// word (two funnel shifts and two three-input logic ops; the shift of
// R_old[d] serves row d's M term and row d+1's S term), and the distance is
// one funnel shift a row: the top bits of the rows are shifted into one word
// and the first zero found with one count-leading-zeros.  Bytes are few: 216
// region bases, 128 pattern bases and 8 output bytes a lane at the main
// shape, against ~50,000 instructions.
//
// The design: one thread a lane, since the lanes are many (a million at the
// main shape) and independent.  Lanes of one read are adjacent threads, so a
// read's pattern comes from L1 once.  The status rows live in registers:
// the kernel is instantiated for nw = 1..4 and for 8, 16 or 32 rows (k up to
// 7, 15 or 31), rows past k skipped by a uniform branch.  The mask table,
// 6 masks x nw words a lane, sits in shared memory laid out [mask][word]
// [thread], so a step's loads do not conflict.  The region comes in aligned
// 16-byte loads, one chunk ahead: when the scan enters a chunk the load of
// the chunk below it is issued, 16 steps before it is needed.  A chunk is
// loaded only if it holds a byte of the region inside the buffer, so no load
// leaves the 16-byte blocks that the buffer's bytes occupy.
//
// Measured (tools/kernel_times.py, device time; NVIDIA H100 80GB HBM3,
// 700.00 W), 262,144 reads x 4 candidates, 216-base regions, 128 bits:
// k = 12 4.31 ms, 2.5x its operations bound of 1.71 ms (chip_smoke.py's
// filter_work count: 4 + 10k int32 operations a word and base, a shift with
// carry counted as 3, plus the distance and the running minimum), against
// 1,336 ms for the plain path; k = 31 13.3 ms, 2.6x.  The first design took 6.54 ms at k = 12 and 27.8 ms at k = 31:
// it kept the region reader's positions and addresses in 64 bits and left
// the row loop by a break, and used 163 registers at the main shape (109
// now) and spilled at 32 rows.  What still holds it back: each step's rows
// form one chain (row d needs row d-1's new value), and 109 registers
// leave 4 blocks of 128 threads an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kMaxK = 31;  // 32 rows
constexpr int kMasks = 6;  // A, C, G, T, the sentinel 4, and the all-zero mask
constexpr int kZeroMask = 5;
constexpr int kWildcard = 4;
constexpr int kThreads = 128;  // lanes a block
constexpr int kMaxRegion = 1 << 30;  // a region's offsets, 16 more, fit an int

template <int NW>
__device__ __forceinline__ void shl1(const uint32_t (&x)[NW], uint32_t (&y)[NW]) {
  y[0] = x[0] << 1;
#pragma unroll
  for (int j = 1; j < NW; ++j) y[j] = __funnelshift_l(x[j - 1], x[j], 1);
}

// The region's bases, read from the highest position down: each call
// returns the char at the next lower position (the sentinel past the
// buffer's end).  Offsets count from the 16-byte block that holds the
// region's first base.
struct RegionReader {
  const uint4* chunks;  // that block
  int pos;              // offset of the base the next call reads
  int vend;             // offsets from `vend` on lie past the buffer's end
  int cb;               // offset of the chunk in `cur`, a multiple of 16
  uint4 cur, nxt;       // the chunk at cb and the one below it

  __device__ __forceinline__ RegionReader(const int8_t* ref, long long ref_len,
                                          long long start, int region) {
    const long long s = start < 0 ? 0 : (start > ref_len ? ref_len : start);
    const uint8_t* first = reinterpret_cast<const uint8_t*>(ref) + s;
    const int lo = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15u);
    chunks = reinterpret_cast<const uint4*>(first - lo);
    pos = lo + region - 1;
    vend = lo + static_cast<int>(ref_len - s < region ? ref_len - s : region);
    cur = nxt = make_uint4(0u, 0u, 0u, 0u);
    cb = 0;
    if (vend > lo) {
      cb = (vend - 1) & ~15;
      cur = __ldg(chunks + (cb >> 4));
      if (cb > 0) nxt = __ldg(chunks + (cb >> 4) - 1);
    }
  }

  __device__ __forceinline__ int next() {
    const int p = pos--;
    if (p >= vend) return kWildcard;
    if (p < cb) {  // entering the chunk below: load the one below that
      cur = nxt;
      cb -= 16;
      if (cb > 0) nxt = __ldg(chunks + (cb >> 4) - 1);
    }
    const int o = p - cb;
    const uint32_t w = o < 8 ? (o < 4 ? cur.x : cur.y) : (o < 12 ? cur.z : cur.w);
    const unsigned c = (w >> (8 * (o & 3))) & 0xFFu;
    return c <= 4u ? static_cast<int>(c) : kZeroMask;
  }
};

// (minimum 1 block an SM: without it ptxas aims at a lower register count
// and spills a few bytes)
template <int NW, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
bitap_filter_scan(const int8_t* __restrict__ ref, long long ref_len,
                  const long long* __restrict__ starts, const int8_t* __restrict__ reads,
                  int read_stride, const long long* __restrict__ read_lens,
                  int32_t* __restrict__ dist_out, int32_t* __restrict__ off_out,
                  long long lanes, int cands, int region, int k) {
  constexpr int W = NW * kWordBits;
  __shared__ uint32_t pm_s[kMasks * NW * kThreads];
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;  // no barrier below: each thread reads its own masks
  const long long b = lane / cands;
  uint32_t* pm = pm_s + threadIdx.x;

  // the mask table: pattern char p sits at bit q = W-1-p
  {
    const long long len = read_lens[b];
    const int plen = len < 0 ? 0 : (len > W ? W : static_cast<int>(len));
    const int8_t* pat = reads + b * read_stride;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t m[kWildcard + 1] = {0u, 0u, 0u, 0u, 0u};
      for (int q = 0; q < kWordBits; ++q) {
        const int p = W - 1 - (kWordBits * j + q);
        const int pc = p < plen ? static_cast<int>(__ldg(pat + p)) : kWildcard;
        // the chars this pattern char mismatches, one bit each of 0..4
        const uint32_t mm = pc == kWildcard ? 0u
                            : (pc >= 0 && pc < kWildcard ? 0x1Fu & ~(1u << pc) : 0x1Fu);
#pragma unroll
        for (int c = 0; c <= kWildcard; ++c) m[c] |= ((mm >> c) & 1u) << q;
      }
#pragma unroll
      for (int c = 0; c <= kWildcard; ++c) pm[(c * NW + j) * kThreads] = m[c];
      pm[(kZeroMask * NW + j) * kThreads] = 0u;
    }
  }

  RegionReader text(ref, ref_len, starts[lane], region);
  uint32_t R[ROWS][NW];
#pragma unroll
  for (int d = 0; d < ROWS; ++d)
#pragma unroll
    for (int j = 0; j < NW; ++j) R[d][j] = 0xFFFFFFFFu;

  int best = k + 1, off = 0;
  uint32_t cur_pm[NW];
  int c = text.next();
#pragma unroll
  for (int j = 0; j < NW; ++j) cur_pm[j] = pm[(c * NW + j) * kThreads];

#pragma unroll 1
  for (int i = region - 1; i >= 0; --i) {
    uint32_t pmv[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) pmv[j] = cur_pm[j];
    if (i > 0) {  // the next step's char and masks, off this step's chain
      c = text.next();
#pragma unroll
      for (int j = 0; j < NW; ++j) cur_pm[j] = pm[(c * NW + j) * kThreads];
    }

    // row 0; `old` holds R_old[d-1] and `sold` shl1(R_old[d-1]) for row d
    uint32_t old[NW], sold[NW], sh[NW];
    shl1<NW>(R[0], sh);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      old[j] = R[0][j];
      sold[j] = sh[j];
      R[0][j] = sh[j] | pmv[j];
    }
    uint32_t tops = __funnelshift_l(R[0][NW - 1], 0xFFFFFFFFu, 1);
#pragma unroll
    for (int d = 1; d < ROWS; ++d) {
      if (d <= k) {
        uint32_t ins[NW];
        shl1<NW>(R[d], sh);       // shl1(R_old[d])
        shl1<NW>(R[d - 1], ins);  // shl1(R_new[d-1])
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t row = old[j] & sold[j] & ins[j] & (sh[j] | pmv[j]);
          old[j] = R[d][j];
          sold[j] = sh[j];
          R[d][j] = row;
        }
        tops = __funnelshift_l(R[d][NW - 1], tops, 1);
      }
    }
    // bit k-d of `tops` is row d's top bit, the bits above k are ones: the
    // first row with a zero top bit is the highest set bit of ~tops
    const int dist = k - (kWordBits - 1) + __clz(~tops);
    if (dist <= best) {  // <=: the scan runs down, so the last hit is the first i
      best = dist;
      off = i;
    }
  }
  dist_out[lane] = best;
  off_out[lane] = off;
}

using ScanFn = void (*)(const int8_t*, long long, const long long*, const int8_t*, int,
                        const long long*, int32_t*, int32_t*, long long, int, int, int);

template <int NW>
ScanFn pick_rows(int k) {
  if (k < 8) return bitap_filter_scan<NW, 8>;
  if (k < 16) return bitap_filter_scan<NW, 16>;
  return bitap_filter_scan<NW, 32>;
}

ScanFn pick(int nw, int k) {
  switch (nw) {
    case 1: return pick_rows<1>(k);
    case 2: return pick_rows<2>(k);
    case 3: return pick_rows<3>(k);
    case 4: return pick_rows<4>(k);
    default: return nullptr;
  }
}

bool bad_args(long long lanes, int cands, int m_bits, int region, int k) {
  return lanes < 0 || (lanes > 0 && cands < 1) || m_bits % kWordBits != 0 || m_bits < kWordBits ||
         m_bits > 4 * kWordBits || region < 1 || region > kMaxRegion || k < 0 || k > kMaxK ||
         (lanes + kThreads - 1) / kThreads > 0x7FFFFFFFLL;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted.
int bitap_filter(const void* ref, long long ref_len, const void* starts, const void* reads,
                 int read_stride, const void* read_lens, void* dist, void* off,
                 long long lanes, int cands, int m_bits, int region, int k, int device,
                 void* stream) {
  if (bad_args(lanes, cands, m_bits, region, k) || ref_len < 0 || read_stride < m_bits)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (lanes == 0) return cudaSuccess;
  ScanFn kern = pick(m_bits / kWordBits, k);
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  kern<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ref), ref_len, static_cast<const long long*>(starts),
      static_cast<const int8_t*>(reads), read_stride,
      static_cast<const long long*>(read_lens), static_cast<int32_t*>(dist),
      static_cast<int32_t*>(off), lanes, cands, region, k);
  return cudaGetLastError();
}

// The launch bitap_filter makes: out[0] warps in the grid, out[1] blocks,
// out[2] static shared memory per block in bytes.
int bitap_filter_geometry(long long lanes, int m_bits, int k, int* out) {
  if (bad_args(lanes, 1, m_bits, 1, k)) return cudaErrorInvalidValue;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  out[0] = static_cast<int>(blocks * (kThreads / 32));
  out[1] = static_cast<int>(blocks);
  out[2] = kMasks * (m_bits / kWordBits) * kThreads * 4;
  return 0;
}

int bitap_filter_max_k() { return kMaxK; }

}  // extern "C"
