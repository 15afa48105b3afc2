// BitAlign DC over linearized subgraphs on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the graph workload:
//   bitalign_dc  <- src/repro/kernels/bitalign.py::bitalign_dc_batch
//   (body _bitalign_kernel, tail mask _tail_mask_wm).
// Inputs, one row per graph lane b: bases [B, N] int8, succ_bits [B, N]
// uint32 hopBits (bit h set <=> node i+1+h is a successor of node i),
// patterns [B, m_bits] int8 wildcard-padded, p_lens [B] int32.  Outputs:
// dists [B, N] int32, the first d whose MSB is 0 (else k+1), and, when r_out
// is not null, the status rows R [B, N, k+1, nw] uint32.  The graph mapper's
// filter passes no R (it keeps only dists); the align loop passes one for its
// traceback.
//
// What it computes is the recurrence of _bitalign_kernel, not its block
// layout.  Per graph lane: a 5 x nw pattern-mask table (id 4, wildcard /
// sentinel, matches every character; a base outside 0..4 selects an all-zero
// mask), a tail mask (word j clears its low clip(m_bits - p_len - 32 j, 0, 32)
// bits), and a scan of nodes i = N-1 .. 0:
//   comb[d]  = tail & AND of R_{i+1+h}[d] over the hops h < 16 set in succ[i]
//   R[0]     = (shl1(comb[0]) | PM[base[i]]) & tail
//   R[d]     = comb[d-1] & shl1(comb[d-1]) & shl1(R[d-1])
//              & (shl1(comb[d]) | PM[base[i]]) & tail
// shl1 carries word j-1's MSB into word j's LSB.
//
// What bounds it on this card: the dependent chain, not bytes or operations.
// At the filter shape (B = 1,024, N = 1,536, m_bits = 128, k = 11, no R) a
// call moves ~8 MB and does ~1 G int32 operations: tens of microseconds at
// the card's rates.  But node i needs every row of nodes i+1 .. i+16, and row
// d needs row d-1 of the same node, so one graph lane is a chain of N x (k+1)
// row steps.  The first design ran that chain on one thread per graph lane
// (32 threads on each of 32 SMs at the filter shape), 4.3 us per node.
//
// What the design does about it: a per-row wavefront, the survey's systolic
// array of one processing element per row mapped onto a warp.  Lane d owns
// row d; at step s it works on node i = N-1-(s-d), so a graph lane takes N+k
// steps of one row each instead of N steps of k+1 rows, and the rows of a
// node run on k+1 lanes at once:
//   * Row d-1's comb and new R at node i reach lane d by one __shfl_up_sync
//     (lane d-1 made both one step before), with the node's packed base and
//     hopBits and the running "first d with MSB 0".  Lane d reads comb[d]
//     from its own column of the hop ring.
//   * When k+1 <= 16, two graph lanes share a warp (width-16 shuffles); else
//     one graph lane per warp.  At k = 32 (33 rows) lane 0 also runs row 32,
//     one step behind lane 31, fed by a broadcast from lane 31.
//   * The hop ring holds each row's last nodes in shared memory as
//     [slot][word][lane], lane innermost: at a step the 32 lanes touch 32
//     banks.  Node i's rows go to slot i mod Q; every slot starts as the tail
//     rows, which is what a hop past N reads (the slot of node i+1+h >= N is
//     never overwritten before node i reads it).  The combine walks the set
//     hop bits only (__ffs loop); the served graph's nodes have one.
//   * Lane 0 takes node i's inputs from a register chunk that the group's
//     lanes load G nodes ahead with coalesced loads, so no step waits on
//     device memory; lane d gets them from lane d-1.
//   * Node i is complete when the last row passes it.  Its dists entry goes
//     to a 16-node stage in shared memory, and every 16 completed nodes the
//     warp writes the stage (and, with R, those 16 nodes' rows straight from
//     the ring, row-contiguous, 16 B per thread at nw = 4) to device memory.
//     With R the ring is Q = 32 (k <= 15) or 64 slots deep, so a node's rows
//     are still in the ring when it is written out (Q >= k + 16); without R,
//     Q = 16.
//   * The kernel is templated on nw, the group width and the extra row, so a
//     step is one row's work whatever k is.
// What still holds it back (tools/kernel_times.py; NVIDIA H100 80GB HBM3,
// 700.00 W): the filter shape takes 0.498 ms of device time, 15.5x its
// bound, and the same 0.495-0.498 ms for 128 as for 1,024 graph lanes, so a
// warp's chain of N+k steps sets it, ~320 ns a step.  A step is ~200 SASS
// instructions (11 shuffles, 17 per hop, the row's integer operations)
// issued back to back by one warp per scheduler.  More independent work per
// warp -- two graph lanes interleaved in a lane, or a row's words split
// across lanes -- is the next lever.  PERF.md has the times of every site.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kHops = 16;    // HOP_LIMIT (src/repro/core/segram/graph.py)
constexpr int kMaxK = 32;    // rows 0..31 on lanes 0..31, row 32 on lane 0
constexpr int kFlush = 16;   // completed nodes per dists / R write-out
constexpr int kMaxWarps = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int NW>
__device__ __forceinline__ void shl1(const uint32_t (&x)[NW], uint32_t (&y)[NW]) {
#pragma unroll
  for (int j = NW - 1; j >= 0; --j) {
    y[j] = (x[j] << 1) | (j > 0 ? (x[j - 1] >> 31) : 0u);
  }
}

struct Geometry {
  int group;    // warp lanes per graph lane: 16 (two graph lanes a warp) or 32
  int ring;     // hop ring depth Q in nodes, a power of two
  int warps;    // warps per block
  int blocks;
  size_t smem;  // dynamic shared memory per block, bytes
};

Geometry geometry(int batch, int nw, int k, bool store_r, int max_smem) {
  Geometry g;
  g.group = k + 1 <= 16 ? 16 : 32;
  g.ring = !store_r ? kHops : (k + kFlush <= 32 ? 32 : 64);
  const int cols = 32 + (k == kMaxK ? 1 : 0);
  const size_t per_warp =
      (static_cast<size_t>(g.ring) * nw * cols + (32 / g.group) * kFlush) * sizeof(uint32_t);
  g.warps = kMaxWarps;
  while (g.warps > 1 && per_warp * g.warps > static_cast<size_t>(max_smem)) --g.warps;
  const int per_block = g.warps * (32 / g.group);
  g.blocks = (batch + per_block - 1) / per_block;
  g.smem = per_warp * g.warps;
  return g;
}

// One row step of one graph lane at node i: comb from the row's ring column,
// then R; writes R to the ring and returns the running first-d-with-MSB-0.
template <int NW, int COLS>
__device__ __forceinline__ int row_step(
    uint32_t* col, int qmask, int i, uint32_t node, const uint32_t (&tail)[NW],
    const uint32_t (&pm)[kNumChars][NW], bool first, const uint32_t (&in_comb)[NW],
    const uint32_t (&in_r)[NW], int in_dm, int d, int k, uint32_t (&comb)[NW],
    uint32_t (&r)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) comb[j] = tail[j];
  uint32_t sb = node & 0xFFFFu;
  while (sb) {
    const int h = __ffs(sb) - 1;
    sb &= sb - 1u;
    const uint32_t* src = col + ((i + 1 + h) & qmask) * NW * COLS;
#pragma unroll
    for (int j = 0; j < NW; ++j) comb[j] &= src[j * COLS];
  }
  // select PM[base[i]] (all zero for a base outside 0..4)
  const int c = static_cast<int8_t>(node >> 16);
  uint32_t cur[NW], m[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    cur[j] = 0u;
#pragma unroll
    for (int ch = 0; ch < kNumChars; ++ch) cur[j] = (c == ch) ? pm[ch][j] : cur[j];
  }
  shl1<NW>(comb, m);
  if (first) {
#pragma unroll
    for (int j = 0; j < NW; ++j) r[j] = (m[j] | cur[j]) & tail[j];
  } else {
    uint32_t s[NW], ins[NW];
    shl1<NW>(in_comb, s);
    shl1<NW>(in_r, ins);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      r[j] = in_comb[j] & s[j] & ins[j] & (m[j] | cur[j]) & tail[j];
  }
  uint32_t* dst = col + (i & qmask) * NW * COLS;
#pragma unroll
  for (int j = 0; j < NW; ++j) dst[j * COLS] = r[j];
  const bool msb0 = (r[NW - 1] >> 31) == 0u;
  if (first) return msb0 ? 0 : k + 1;
  return in_dm <= k ? in_dm : (msb0 ? d : k + 1);
}

// G: warp lanes per graph lane (16 or 32).  EXTRA: k = 32, row 32 on lane 0.
// The launch bound's minimum of 1 block an SM: without it ptxas spills one
// register of the filter's instance, bitalign_wave<4, 16, false>.
template <int NW, int G, bool EXTRA>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
bitalign_wave(const int8_t* __restrict__ bases, const uint32_t* __restrict__ succ,
              const int8_t* __restrict__ patterns, const int32_t* __restrict__ p_lens,
              int32_t* __restrict__ dists, uint32_t* __restrict__ r_out, int batch,
              int n, int k, int ring) {
  constexpr int M = NW * kWordBits;
  constexpr int kGroups = 32 / G;
  constexpr int kCols = 32 + (EXTRA ? 1 : 0);  // ring columns: lanes, row 32
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / G, d = lane % G;
  const int b0 = (blockIdx.x * (blockDim.x / 32) + warp) * kGroups;
  if (b0 >= batch) return;  // the whole warp: no block-wide barrier follows
  const int b = b0 + g;
  const bool live = b < batch;
  const int bl = live ? b : batch - 1;  // a dead group runs a live row, stores nothing
  const int rows = k + 1;
  const int qmask = ring - 1;
  uint32_t* wring = smem + warp * (ring * NW * kCols + kGroups * kFlush);  // [Q][NW][kCols]
  int32_t* dstage = reinterpret_cast<int32_t*>(wring + ring * NW * kCols);  // [kGroups][kFlush]

  // tail: the wildcard tail past p_len is pre-matched (low bits held at 0)
  uint32_t tail[NW];
  const int pad = M - p_lens[bl];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int below = min(max(pad - kWordBits * j, 0), kWordBits);
    tail[j] = below >= kWordBits ? 0u : ~((1u << below) - 1u);
  }

  // PM[c] bit q = 1 iff pattern char at bit q (= pat[M-1-q]) mismatches c:
  // one ballot per (graph lane, char, word), lane t supplying bit t
  uint32_t pm[kNumChars][NW] = {};
#pragma unroll
  for (int gg = 0; gg < kGroups; ++gg) {
    const int8_t* pat = patterns + static_cast<size_t>(min(b0 + gg, batch - 1)) * M;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int p = pat[M - 1 - (kWordBits * j + lane)];
#pragma unroll
      for (int c = 0; c < kNumChars; ++c) {
        const uint32_t bits = __ballot_sync(kFull, !(p == c || p == 4));
        if (g == gg) pm[c][j] = bits;
      }
    }
  }

  uint32_t* col = wring + lane;
  uint32_t* col32 = wring + 32;  // row 32's column (EXTRA only)
  for (int q = 0; q < ring; ++q)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      col[(q * NW + j) * kCols] = tail[j];
      if (EXTRA && lane == 0) col32[(q * NW + j) * kCols] = tail[j];
    }
  __syncwarp();

  // node inputs packed as hopBits | base << 16; lane d of a group loads the
  // node of step s0 + d, and lane 0 reads step s's node from the chunk
  const int8_t* lane_bases = bases + static_cast<size_t>(bl) * n;
  const uint32_t* lane_succ = succ + static_cast<size_t>(bl) * n;
  auto load_node = [&](int s) -> uint32_t {
    const int i = n - 1 - s;
    return i >= 0 ? (lane_succ[i] & 0xFFFFu) |
                        (static_cast<uint32_t>(static_cast<uint8_t>(lane_bases[i])) << 16)
                  : 0u;
  };
  uint32_t nxt = load_node(d), cur = 0u;

  // this lane's values at the end of the last step, passed on to row d+1
  uint32_t o_comb[NW], o_r[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) o_comb[j] = o_r[j] = 0u;
  int o_dm = 0;
  uint32_t o_node = 0u;

  const int steps = n + k;
  for (int s = 0; s < steps; ++s) {
    if (s % G == 0) {
      cur = nxt;
      nxt = load_node(s + G + d);
    }
    uint32_t in_comb[NW], in_r[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      in_comb[j] = __shfl_up_sync(kFull, o_comb[j], 1, G);
      in_r[j] = __shfl_up_sync(kFull, o_r[j], 1, G);
    }
    const int in_dm = __shfl_up_sync(kFull, o_dm, 1, G);
    const uint32_t up_node = __shfl_up_sync(kFull, o_node, 1, G);
    const uint32_t head_node = __shfl_sync(kFull, cur, s % G, G);
    const uint32_t node = d == 0 ? head_node : up_node;
    // row 32 (lane 0) takes row 31's values from lane 31
    uint32_t x_comb[NW], x_r[NW];
    int x_dm = 0;
    uint32_t x_node = 0u;
    if (EXTRA) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        x_comb[j] = __shfl_sync(kFull, o_comb[j], 31);
        x_r[j] = __shfl_sync(kFull, o_r[j], 31);
      }
      x_dm = __shfl_sync(kFull, o_dm, 31);
      x_node = __shfl_sync(kFull, o_node, 31);
    }

    const int i = n - 1 - s + d;
    if (d <= k && i >= 0 && i < n) {
      o_dm = row_step<NW, kCols>(col, qmask, i, node, tail, pm, d == 0, in_comb, in_r,
                                 in_dm, d, k, o_comb, o_r);
      o_node = node;
      if (d == k) dstage[g * kFlush + i % kFlush] = o_dm;
    }
    if (EXTRA && lane == 0) {
      const int i32 = n - 1 - s + kMaxK;
      if (i32 >= 0 && i32 < n) {
        uint32_t comb32[NW], r32[NW];
        dstage[i32 % kFlush] = row_step<NW, kCols>(col32, qmask, i32, x_node, tail, pm,
                                                   false, x_comb, x_r, x_dm, kMaxK, k,
                                                   comb32, r32);
      }
    }

    // the last row finished node ic: every kFlush nodes, write them out
    const int ic = n - 1 - s + k;
    if (ic >= 0 && ic < n && ic % kFlush == 0) {
      __syncwarp();
      const int cnt = min(kFlush, n - ic);
      if (live) {
        if (d < cnt) dists[static_cast<size_t>(b) * n + ic + d] = dstage[g * kFlush + d];
        if (r_out) {
          uint32_t* dst = r_out + (static_cast<size_t>(b) * n + ic) * rows * NW;
          for (int p = d; p < cnt * rows; p += G) {
            const int node_off = p / rows, row = p - node_off * rows;
            const uint32_t* src = wring + ((ic + node_off) & qmask) * NW * kCols +
                                  (row < 32 ? g * G + row : 32);
            uint32_t* cell = dst + static_cast<size_t>(p) * NW;
            if (NW == 4) {
              *reinterpret_cast<uint4*>(cell) =
                  make_uint4(src[0], src[kCols], src[2 * kCols], src[3 * kCols]);
            } else if (NW == 2) {
              *reinterpret_cast<uint2*>(cell) = make_uint2(src[0], src[kCols]);
            } else {
#pragma unroll
              for (int j = 0; j < NW; ++j) cell[j] = src[j * kCols];
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

using KernelFn = void (*)(const int8_t*, const uint32_t*, const int8_t*, const int32_t*,
                          int32_t*, uint32_t*, int, int, int, int);

template <int NW>
KernelFn pick(int group, bool extra) {
  if (group == 16) return bitalign_wave<NW, 16, false>;
  return extra ? bitalign_wave<NW, 32, true> : bitalign_wave<NW, 32, false>;
}

KernelFn pick_nw(int nw, int group, bool extra) {
  switch (nw) {
    case 1: return pick<1>(group, extra);
    case 2: return pick<2>(group, extra);
    case 3: return pick<3>(group, extra);
    case 4: return pick<4>(group, extra);
    default: return nullptr;
  }
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
  KernelFn kern = pick_nw(m_bits / kWordBits, k + 1 <= 16 ? 16 : 32, k == kMaxK);
  if (!kern) return cudaErrorInvalidValue;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const Geometry geo = geometry(batch, m_bits / kWordBits, k, r_out != nullptr, max_smem);
  if (geo.smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(geo.smem));
  if (err != cudaSuccess) return err;
  kern<<<geo.blocks, geo.warps * 32, geo.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bases), static_cast<const uint32_t*>(succ_bits),
      static_cast<const int8_t*>(patterns), static_cast<const int32_t*>(p_lens),
      static_cast<int32_t*>(dists), static_cast<uint32_t*>(r_out), batch, n, k, geo.ring);
  return cudaGetLastError();
}

// The launch bitalign_dc makes for these arguments: out[0] warps in the
// grid, out[1] blocks, out[2] dynamic shared memory per block in bytes.
int bitalign_geometry(int batch, int m_bits, int k, int store_r, int device, int* out) {
  if (batch < 0 || k < 0 || k > kMaxK || m_bits % kWordBits != 0 ||
      m_bits / kWordBits < 1 || m_bits / kWordBits > 4)
    return cudaErrorInvalidValue;
  int max_smem = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const Geometry geo = geometry(batch, m_bits / kWordBits, k, store_r != 0, max_smem);
  out[0] = geo.blocks * geo.warps;
  out[1] = geo.blocks;
  out[2] = static_cast<int>(geo.smem);
  return 0;
}

int bitalign_max_k() { return kMaxK; }

}  // extern "C"
