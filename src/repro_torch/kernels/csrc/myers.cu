// Myers' bit-parallel edit distance on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the edit-distance use case:
//   myers_distance  <- src/repro/kernels/myers.py::myers_distance_batch
//   (body _myers_kernel, PEq table _peq_table, add _add_carry_wm).
// Inputs, one pair per row b: texts [B, n] int8, patterns [B, m_bits] int8
// wildcard-padded, m_lens [B] int32.  Output: out [B] int32, the global (NW)
// score or, in semiglobal mode, the least score over all text prefixes (never
// above m_len).
//
// What it computes is the recurrence of _myers_kernel, not its block layout.
// Bit j of a vector is pattern position j (LSB = pattern[0]); PEq[c] bit j is
// 1 iff pattern[j] == c or pattern[j] is the wildcard 4.  Per text char c:
//   Eq = PEq[c] (all zero for c outside 0..4)
//   Xv = Eq | Mv;  Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq     (multi-word add)
//   Ph = Mv | ~(Xh | Pv);  Mh = Pv & Xh
//   score += bit m_len-1 of Ph - bit m_len-1 of Mh
//   Ph = shl1(Ph) | cin;  Mh = shl1(Mh)       (cin = 1 global, 0 semiglobal)
//   Pv = Mh | ~(Xv | Ph);  Mv = Ph & Xv
// starting from Pv = ~0, Mv = 0, score = m_len.  The score bit lives in no
// word when m_len is 0 or above m_bits: the score then stays m_len, as in the
// Pallas kernel (its word select picks nothing), so m_len = 0 gives 0.
//
// What bounds it on this card: operations, by the count in chip_smoke.py's
// myers_work (23 int32 operations per text char and word): ~0.9 G at
// B = 1,024, n = 1,192, nw = 32 (0.027 ms at 33.5 T ops/s), while its bytes
// take ~0.7 us.  But each pair is a chain of n dependent steps, so at small
// B x nw the chain's latency sets the time, and at L = 100 kbp (B = 8,
// nw = 3,126) one SM a pair can issue only 128 lane operations a cycle.
//
// The design.  Lane l of a pair owns the contiguous words [l S, l S + S) of
// Pv and Mv, in registers (S, words a lane, is a template parameter, so
// every index is a constant).  Per char a lane adds its S words with one
// add.cc/addc chain, then votes generate (the chain carried out) and
// propagate (its S sums are all ones); a single ballot pair resolves the
// carries across the lanes: the carry into lane l is bit l of
// ((G|P) + G + cin) ^ (G|P) ^ G, and each lane adds its carry in with a
// second chain.  The shift crosses lanes with one shuffle of the packed
// (Ph, Mh) top bits.  The lane that owns the score word (m_len-1)/32 keeps
// score and best itself and writes the result; no per-char ballot.  Words
// at or above nw hold zeros and feed nothing below them (carries and shifts
// only move up); lanes with none are kept out of the ballots.
//   * nw <= 320 (m_bits <= 10,240): one pair per LW lanes, LW the power of
//     two that covers nw / S words, S = ceil(nw / 32); several pairs a warp
//     where LW < 32 (segments of the ballots are cut at each pair's top
//     lane), four warps a block.  PEq[5][S] lives in registers; a step
//     selects the next char's words after its own, off the chain.
//   * wider: G warps of one block run one pair, warp g owning words
//     [32 S g, 32 S (g+1)), S = 10.  At step s warp g
//     works on char s-g: its carry out and (Ph, Mh) top bits for that char
//     go to warp g+1 through a two-slot ring in shared memory, slot s & 1,
//     with one __syncthreads a step.  (With one slot, warp g would write
//     char j+1's bits while warp g+1 still reads char j's.)  The chain is
//     n + G - 1 steps.  PEq sits in shared memory, [G][5][S][32] so a warp's
//     loads do not conflict, and each step loads the next char's words
//     before its barrier, off the chain.  At 1,024 threads a thread has 64
//     registers: a lane holds Pv, Mv, Eq and the sums, 4 S words, and one
//     word's Ph and Mh at a time.
// The widest pattern is 32 warps x 32 lanes x 10 words, 327,680 bits, whose
// PEq and ring take 205,056 B of shared memory.
//
// Measured (tools/kernel_times.py, device time; NVIDIA H100 80GB HBM3,
// 700.00 W): 0.149-0.152 ms at L = 1 kbp (B = 1,024; 5.5-5.6x the bound),
// 0.966-0.975 ms at 5 kbp (B = 256; 6.7x) and 66.8-67.5 ms at 100 kbp
// (B = 8; 39x), against 0.249-0.251, 3.150-3.180 and 994-1,003 ms for
// the first design, one warp a pair walking 32-word segments held in
// shared memory.  What still holds it back: at 1 kbp a char is a chain
// of ~75 instructions with two votes and a shuffle on it, ~250 cycles at
// ~2 warps a scheduler; at 100 kbp a pair is one SM's 10 warps, issue-
// bound with a barrier a char, while 124 SMs idle (clusters across SMs
// are the next step).  Other launch shapes, timed from copies of this file
// with kSingleMaxS, kPipeS or S changed: none was more than 3% faster
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kWildcard = 4;
constexpr int kWarp = 32;
constexpr int kBlockWarps = 4;  // warps a block when a pair fits one warp
constexpr int kMaxWarps = 32;  // warps a pair in the pipeline
constexpr int kSingleMaxS = 10;  // one warp a pair up to 32 x 10 words
constexpr int kPipeS = 10;  // words a lane in the pipeline
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t carry_out() {
  uint32_t r;
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(r));
  return r;
}

// A lane's text reader over a segment of `width` lanes (a power of two):
// chars are loaded `width` at a time, one a lane, the next `width` already
// in flight, and shuffled out in order.  The refill is a predicated load,
// not a branch, so a step's code stays one block the compiler can
// schedule across; a lane past the text loads the last char, which no
// step reads.
struct TextStream {
  const int8_t* text;
  int n, ls, width, chunk, next;
  __device__ __forceinline__ void start(const int8_t* t, int n_, int ls_, int width_) {
    text = t, n = n_, ls = ls_, width = width_;
    chunk = text[min(ls, n - 1)];
    next = text[min(width + ls, n - 1)];
  }
  // char j, for j = 0, 1, 2, ... in order
  __device__ __forceinline__ int at(int j) {
    const int q = j & (width - 1);
    const bool refill = q == 0 && j > 0;
    chunk = refill ? next : chunk;
    const int8_t* src = text + min(j + width + ls, n - 1);
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "@p ld.global.nc.s8 %0, [%1];\n\t}"
        : "+r"(next)
        : "l"(src), "r"(static_cast<int>(refill)));
    return __shfl_sync(kFull, chunk, q, width);
  }
};

// One char of one lane: S words of Pv/Mv, updated in place.  `live`: the
// lane holds words below nw and is not the top lane of a pair that shares
// its warp (whose carry out is dropped); `cin`: the carry into lane 0 of
// the warp; `in_bits`: the (Ph, Mh) bits shifted into the segment's first
// lane.  Returns in `cout` the warp's carry out and, above it, the lane's
// (Ph, Mh) top bits; in `ph_bit`/`mh_bit` bit `off` of Ph and Mh in word
// `t0` when `scored`, else 0.
template <int S>
__device__ __forceinline__ void myers_char(const uint32_t (&eq)[S], uint32_t (&pv)[S],
                                           uint32_t (&mv)[S], int lane, int width,
                                           bool live, uint32_t cin,
                                           uint32_t in_bits, bool scored, int t0, int off,
                                           uint32_t& cout, int& ph_bit, int& mh_bit) {
  uint32_t sum[S];
  sum[0] = add_cc(eq[0] & pv[0], pv[0]);
#pragma unroll
  for (int t = 1; t < S; ++t) sum[t] = addc_cc(eq[t] & pv[t], pv[t]);
  const uint32_t gen = carry_out();
  uint32_t all = sum[0];
#pragma unroll
  for (int t = 1; t < S; ++t) all &= sum[t];
  const unsigned g = __ballot_sync(kFull, live && gen);
  const unsigned p = __ballot_sync(kFull, live && all == kFull);
  const unsigned x = g | p;
  const unsigned cmask = (x + g + cin) ^ x ^ g;
  cout = ((g >> 31) | ((p >> 31) & (cmask >> 31))) & 1u;
  if (S == 1) {
    sum[0] += (cmask >> lane) & 1u;
  } else {
    sum[0] = add_cc(sum[0], (cmask >> lane) & 1u);
#pragma unroll
    for (int t = 1; t < S - 1; ++t) sum[t] = addc_cc(sum[t], 0u);
    sum[S - 1] = addc(sum[S - 1], 0u);
  }

  // word S-1 first: its top bits cross to the next lane while the lane
  // works up from word 0, holding one word's Ph and Mh at a time
  const uint32_t xh_top = (sum[S - 1] ^ pv[S - 1]) | eq[S - 1];
  const uint32_t top = ((mv[S - 1] | ~(xh_top | pv[S - 1])) >> 31) |
                       ((pv[S - 1] & xh_top) >> 31 << 1);
  uint32_t up = __shfl_up_sync(kFull, top, 1, width);
  if ((lane & (width - 1)) == 0) up = in_bits;
  cout |= top << 1;  // the warp's top lane passes (carry, Ph, Mh) on
  uint32_t ph_in = up & 1u, mh_in = up >> 1, pw = 0u, mw = 0u;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const uint32_t xh = (sum[t] ^ pv[t]) | eq[t];
    const uint32_t ph = mv[t] | ~(xh | pv[t]);
    const uint32_t mh = pv[t] & xh;
    if (scored && t == t0) pw = ph, mw = mh;
    const uint32_t phs = (ph << 1) | ph_in, mhs = (mh << 1) | mh_in;
    ph_in = ph >> 31;
    mh_in = mh >> 31;
    const uint32_t xv = eq[t] | mv[t];
    pv[t] = mhs | ~(xv | phs);
    mv[t] = phs & xv;
  }
  ph_bit = static_cast<int>((pw >> off) & 1u);
  mh_bit = static_cast<int>((mw >> off) & 1u);
}

// Where a pair's score bit lives: word (m_len-1)/32, none for m_len outside
// [1, m_bits].
struct ScoreBit {
  int word, off;
  __device__ ScoreBit(int m_len, int m_bits)
      : word(m_len >= 1 && m_len <= m_bits ? (m_len - 1) / kWordBits : -1),
        off(m_len >= 1 && m_len <= m_bits ? (m_len - 1) % kWordBits : 0) {}
};

// PEq bits of pattern word w (32 chars), one word per char.
__device__ __forceinline__ void peq_word(const int8_t* pat, int w, int nw,
                                         uint32_t (&eq)[kNumChars]) {
#pragma unroll
  for (int c = 0; c < kNumChars; ++c) eq[c] = 0u;
  if (w >= nw) return;
  for (int q = 0; q < kWordBits; ++q) {
    const int p = pat[w * kWordBits + q];
#pragma unroll
    for (int c = 0; c < kNumChars; ++c) {
      if (p == c || p == kWildcard) eq[c] |= 1u << q;
    }
  }
}

// One pair per `width` lanes (nw <= 32 S), kBlockWarps warps a block.
// (minimum 1 block an SM in both: without it ptxas aims at a lower
// register count and spills)
template <int S>
__global__ void __launch_bounds__(kWarp * kBlockWarps, 1)
myers_lanes(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
            const int32_t* __restrict__ m_lens, int32_t* __restrict__ out, int batch,
            int n, int nw, int width, int global_mode) {
  const int lane = threadIdx.x % kWarp;
  const int per_warp = kWarp / width;
  const int first = (blockIdx.x * kBlockWarps + threadIdx.x / kWarp) * per_warp;
  if (first >= batch) return;  // the whole warp
  const int ls = lane % width;
  const int pair = first + lane / width;
  const int row = min(pair, batch - 1);  // a dead segment runs a live row
  const int m_bits = nw * kWordBits;

  uint32_t peq[kNumChars][S], pv[S], mv[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    uint32_t eq[kNumChars];
    peq_word(patterns + static_cast<size_t>(row) * m_bits, ls * S + t, nw, eq);
#pragma unroll
    for (int c = 0; c < kNumChars; ++c) peq[c][t] = eq[c];
    pv[t] = kFull;
    mv[t] = 0u;
  }
  // a lane with words, and not the top lane of a pair sharing its warp
  const bool live = ls * S < nw && (width == kWarp || ls != width - 1);
  const int m_len = m_lens[row];
  const ScoreBit sb(m_len, m_bits);
  const bool owner = sb.word >= 0 ? ls == sb.word / S : ls == 0;
  const int t0 = sb.word >= 0 ? sb.word % S : 0;
  const uint32_t in_bits = global_mode ? 1u : 0u;
  int score = m_len, best = m_len;

  TextStream ts;
  ts.start(texts + static_cast<size_t>(row) * n, n, ls, width);
  uint32_t eq[S];  // PEq[c] (0 for a char outside 0..4)
  auto select = [&](int c) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      eq[t] = 0u;
#pragma unroll
      for (int ch = 0; ch < kNumChars; ++ch) eq[t] = c == ch ? peq[ch][t] : eq[t];
    }
  };
  select(ts.at(0));
  for (int j = 0; j < n; ++j) {
    uint32_t cout;
    int ph_bit = 0, mh_bit = 0;
    myers_char<S>(eq, pv, mv, lane, width, live, 0u, in_bits, owner && sb.word >= 0, t0,
                  sb.off, cout, ph_bit, mh_bit);
    score += ph_bit - mh_bit;
    best = min(best, score);
    if (j + 1 < n) select(ts.at(j + 1));  // the next char's words, off the chain
  }
  if (owner && pair < batch) out[pair] = global_mode ? score : best;
}

// One pair a block of G = blockDim.x / 32 warps, warp g on words
// [32 S g, 32 S (g+1)), a diagonal pipeline over the chars.
template <int S>
__global__ void __launch_bounds__(kWarp * kMaxWarps, 1)
myers_pipe(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
           const int32_t* __restrict__ m_lens, int32_t* __restrict__ out, int n, int nw,
           int global_mode) {
  extern __shared__ uint32_t smem[];
  const int G = blockDim.x / kWarp, g = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pair = blockIdx.x;
  const int m_bits = nw * kWordBits;
  uint32_t* peq = smem;  // [G][5][S][32]
  uint32_t* ring = smem + G * kNumChars * S * kWarp;  // [2][G]

  const int8_t* pat = patterns + static_cast<size_t>(pair) * m_bits;
  for (int w = threadIdx.x; w < G * kWarp * S; w += blockDim.x) {
    uint32_t eq[kNumChars];
    peq_word(pat, w, nw, eq);
    const int gg = w / (kWarp * S), ll = w % (kWarp * S) / S, t = w % S;
#pragma unroll
    for (int c = 0; c < kNumChars; ++c)
      peq[((gg * kNumChars + c) * S + t) * kWarp + ll] = eq[c];
  }
  __syncthreads();

  const uint32_t* my_peq = peq + g * kNumChars * S * kWarp + lane;
  uint32_t pv[S], mv[S], eq[S];
#pragma unroll
  for (int t = 0; t < S; ++t) pv[t] = kFull, mv[t] = 0u;
  const bool live = (g * kWarp + lane) * S < nw;
  const int m_len = m_lens[pair];
  const ScoreBit sb(m_len, m_bits);
  const int span = kWarp * S;  // words a warp
  const bool scored = sb.word >= 0 && g == sb.word / span;  // warp-uniform
  const bool owner = sb.word >= 0 ? scored && lane == sb.word % span / S
                                  : g == 0 && lane == 0;
  const int t0 = sb.word >= 0 ? sb.word % S : 0;
  const uint32_t in0 = global_mode ? 2u : 0u;  // (carry, Ph, Mh) into warp 0
  int score = m_len, best = m_len;

  auto load_eq = [&](int c) {
    const bool known = c >= 0 && c < kNumChars;
#pragma unroll
    for (int t = 0; t < S; ++t) eq[t] = known ? my_peq[(c * S + t) * kWarp] : 0u;
  };
  TextStream ts;
  ts.start(texts + static_cast<size_t>(pair) * n, n, lane, kWarp);
  int c = ts.at(0);
  load_eq(c);
  for (int s = 0; s < n + G - 1; ++s) {
    const int j = s - g;
    if (j >= 0 && j < n) {  // warp-uniform
      const uint32_t in = g == 0 ? in0 : ring[((s - 1) & 1) * G + g - 1];
      uint32_t cout;
      int ph_bit = 0, mh_bit = 0;
      myers_char<S>(eq, pv, mv, lane, kWarp, live, in & 1u, in >> 1, scored, t0, sb.off,
                    cout, ph_bit, mh_bit);
      if (lane == kWarp - 1 && g + 1 < G) ring[(s & 1) * G + g] = cout;
      if (scored) {
        score += ph_bit - mh_bit;
        best = min(best, score);
      }
      if (j + 1 < n) {  // the next char's words, before the barrier
        c = ts.at(j + 1);
        load_eq(c);
      }
    }
    __syncthreads();
  }
  if (owner) out[pair] = global_mode ? score : best;
}

int max_smem_optin(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

struct Launch {
  int s, width, warps_per_pair;  // words a lane, lanes a pair, warps a pair
  int blocks, threads;
  size_t smem;
};

size_t pipe_smem(int s, int g) {
  return (static_cast<size_t>(g) * kNumChars * s * kWarp + 2 * g) * sizeof(uint32_t);
}

// The launch myers_distance makes for batch x nw; false if the pattern is
// wider than the pipeline takes in max_smem bytes.
bool pick(int batch, int nw, int max_smem, Launch* l) {
  if (nw <= kWarp * kSingleMaxS) {
    const int s = (nw + kWarp - 1) / kWarp, lanes = (nw + s - 1) / s;
    int width = 1;
    while (width < lanes) width *= 2;
    const int pairs = kBlockWarps * (kWarp / width);
    *l = {s, width, 1, (batch + pairs - 1) / pairs, kWarp * kBlockWarps, 0};
    return true;
  }
  const int g = (nw + kWarp * kPipeS - 1) / (kWarp * kPipeS);
  if (g > kMaxWarps || pipe_smem(kPipeS, g) > static_cast<size_t>(max_smem)) return false;
  *l = {kPipeS, kWarp, g, batch, kWarp * g, pipe_smem(kPipeS, g)};
  return true;
}

template <int S>
void run_lanes(const Launch& l, cudaStream_t st, const int8_t* t, const int8_t* p,
               const int32_t* m, int32_t* o, int batch, int n, int nw, int gm) {
  myers_lanes<S><<<l.blocks, l.threads, 0, st>>>(t, p, m, o, batch, n, nw, l.width, gm);
}

cudaError_t run_pipe(const Launch& l, cudaStream_t st, const int8_t* t, const int8_t* p,
                     const int32_t* m, int32_t* o, int n, int nw, int gm) {
  cudaError_t err = cudaFuncSetAttribute(myers_pipe<kPipeS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  myers_pipe<kPipeS><<<l.blocks, l.threads, l.smem, st>>>(t, p, m, o, n, nw, gm);
  return cudaSuccess;
}

cudaError_t run(const Launch& l, const void* texts, const void* patterns, const void* m_lens,
                void* out, int batch, int n, int nw, int global_mode, void* stream) {
  auto t = static_cast<const int8_t*>(texts);
  auto p = static_cast<const int8_t*>(patterns);
  auto m = static_cast<const int32_t*>(m_lens);
  auto o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (l.warps_per_pair == 1) {
    switch (l.s) {
      case 1: run_lanes<1>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 2: run_lanes<2>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 3: run_lanes<3>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 4: run_lanes<4>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 5: run_lanes<5>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 6: run_lanes<6>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 7: run_lanes<7>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 8: run_lanes<8>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 9: run_lanes<9>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      case 10: run_lanes<10>(l, st, t, p, m, o, batch, n, nw, global_mode); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    err = run_pipe(l, st, t, p, m, o, n, nw, global_mode);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_args(int batch, int n, int m_bits) {
  return batch < 0 || n < 0 || m_bits <= 0 || m_bits % kWordBits != 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted (or when B or n
// is 0, where nothing is launched).
int myers_distance(const void* texts, const void* patterns, const void* m_lens, void* out,
                   int batch, int n, int m_bits, int global_mode, int device, void* stream) {
  if (bad_args(batch, n, m_bits)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = static_cast<cudaError_t>(max_smem_optin(device, &max_smem));
  if (err != cudaSuccess) return err;
  Launch l;
  if (!pick(batch, m_bits / kWordBits, max_smem, &l)) return cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return cudaSuccess;
  return run(l, texts, patterns, m_lens, out, batch, n, m_bits / kWordBits, global_mode,
             stream);
}

// The launch myers_distance makes: out[0] warps in the grid, out[1] blocks,
// out[2] dynamic shared memory per block in bytes, out[3] words a lane,
// out[4] lanes a pair, out[5] warps a pair.
int myers_distance_geometry(int batch, int m_bits, int device, int* out) {
  if (bad_args(batch, 0, m_bits)) return cudaErrorInvalidValue;
  int max_smem = 0;
  cudaError_t err = static_cast<cudaError_t>(max_smem_optin(device, &max_smem));
  if (err != cudaSuccess) return err;
  Launch l;
  if (!pick(batch, m_bits / kWordBits, max_smem, &l)) return cudaErrorInvalidValue;
  out[0] = l.blocks * l.threads / kWarp;
  out[1] = l.blocks;
  out[2] = static_cast<int>(l.smem);
  out[3] = l.s;
  out[4] = l.width;
  out[5] = l.warps_per_pair;
  return 0;
}

// The widest pattern the kernels take on `device` (0 on error): the widest
// whose pipeline's PEq and ring fit one block's shared memory.
int myers_max_m_bits(int device) {
  int max_smem = 0;
  if (max_smem_optin(device, &max_smem) != cudaSuccess) return 0;
  for (int g = kMaxWarps; g >= 2; --g) {
    if (pipe_smem(kPipeS, g) <= static_cast<size_t>(max_smem)) return g * kWarp * kPipeS * kWordBits;
  }
  return kWarp * kSingleMaxS * kWordBits;
}

}  // extern "C"
