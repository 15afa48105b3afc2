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
// Pallas kernel (its word select picks nothing), so m_len = 0 gives 0.  The
// C division and modulo of m_len - 1 are never taken for such m_len.
//
// Design.  nw = m_bits / 32 is any size (32 at 1 kbp, 158 at 5 kbp, 3,126 at
// 100 kbp), so Pv, Mv and PEq -- 7 nw words a pair -- do not fit in one
// thread's registers.  One warp runs one pair: its PEq[5][nw], Pv[nw] and
// Mv[nw] live in dynamic shared memory, and the warp walks the vector in
// segments of 32 words, lane l owning word 32 s + l of segment s (no bank
// conflicts).  Per segment the 32-word add with carry is one ballot step:
// every lane adds its word with carry-in 0 and votes generate (G, the sum
// wrapped) and propagate (P, the sum is all ones); the carry into lane l is
// bit l of ((G|P) + G + c) ^ (G|P) ^ G, c the carry out of the segment
// below, and each lane adds its carry in.  The shift left crosses lanes with
// __shfl_up_sync of the top bits and segments through lane 31's top bits.
// The lane that owns word (m_len-1)/32 reads the score bits; a ballot
// broadcasts them.  Text chars are read 32 at a time, one per lane, and
// shuffled out.  A warp touches only its own shared region, so the block
// never synchronises; the tail block's missing warps return at once.
//
// What bounds it on this card: operations, by the count in chip_smoke.py's
// myers_work (23 int32 operations per text char and word): ~0.9 G at
// B = 1,024, n = 1,192, nw = 32, ~27 us at 33.5 T ops/s, while its bytes
// (texts and patterns read once) take ~0.7 us.  The kernel does not reach
// that bound: each warp is a chain of n x segments dependent steps of ~40
// instructions (two ballots and four shuffles among them), and 4 warps a
// block give few warps per SM to hide the latency.  More pairs per warp at
// small nw and register-held vectors are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 32;
constexpr int kNumChars = 5;
constexpr int kWildcard = 4;
constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kWordsPerPair = kNumChars + 2;  // PEq[5], Pv, Mv per word
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
myers_kernel(const int8_t* __restrict__ texts, const int8_t* __restrict__ patterns,
             const int32_t* __restrict__ m_lens, int32_t* __restrict__ out,
             int batch, int n, int nw, int global_mode) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int pair = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (pair >= batch) return;  // the whole warp: every lane shares `pair`

  uint32_t* peq = smem + static_cast<size_t>(warp) * kWordsPerPair * nw;
  uint32_t* pv = peq + static_cast<size_t>(kNumChars) * nw;
  uint32_t* mv = pv + nw;
  const int m_bits = nw * kWordBits;

  const int8_t* pat = patterns + static_cast<size_t>(pair) * m_bits;
  for (int w = lane; w < nw; w += kWarp) {
    uint32_t eq[kNumChars] = {0u, 0u, 0u, 0u, 0u};
    for (int g = 0; g < kWordBits; ++g) {
      const int p = pat[w * kWordBits + g];
#pragma unroll
      for (int c = 0; c < kNumChars; ++c) {
        if (p == c || p == kWildcard) eq[c] |= 1u << g;
      }
    }
#pragma unroll
    for (int c = 0; c < kNumChars; ++c) peq[c * nw + w] = eq[c];
    pv[w] = kFull;
    mv[w] = 0u;
  }
  __syncwarp();

  const int m_len = m_lens[pair];
  const bool has_score = m_len >= 1 && m_len <= m_bits;
  const int score_word = has_score ? (m_len - 1) / kWordBits : -1;
  const int score_off = has_score ? (m_len - 1) % kWordBits : 0;
  const int segs = (nw + kWarp - 1) / kWarp;
  const uint32_t ph_in0 = global_mode ? 1u : 0u;
  const int8_t* text = texts + static_cast<size_t>(pair) * n;
  int score = m_len, best = m_len;
  int chunk = 0;

  for (int j = 0; j < n; ++j) {
    if ((j & (kWarp - 1)) == 0) {
      const int jj = j + lane;
      chunk = jj < n ? text[jj] : kWildcard;
    }
    const int c = __shfl_sync(kFull, chunk, j & (kWarp - 1));
    const bool known = c >= 0 && c < kNumChars;
    uint32_t carry = 0u, ph_in = ph_in0, mh_in = 0u;
    uint32_t ph_bit = 0u, mh_bit = 0u;
    for (int s = 0; s < segs; ++s) {
      const int w = s * kWarp + lane;
      const bool live = w < nw;
      const uint32_t eq = (live && known) ? peq[c * nw + w] : 0u;
      const uint32_t P = live ? pv[w] : 0u;
      const uint32_t M = live ? mv[w] : 0u;
      const uint32_t xv = eq | M;
      const uint32_t a = eq & P;
      const uint32_t sum0 = a + P;
      const unsigned gen = __ballot_sync(kFull, sum0 < a);
      const unsigned prop = __ballot_sync(kFull, sum0 == kFull);
      const unsigned x = gen | prop;
      const unsigned cin_mask = (x + gen + carry) ^ x ^ gen;
      carry = ((gen >> 31) | ((prop >> 31) & (cin_mask >> 31))) & 1u;
      const uint32_t sum = sum0 + ((cin_mask >> lane) & 1u);
      const uint32_t xh = (sum ^ P) | eq;
      const uint32_t ph = M | ~(xh | P);
      const uint32_t mh = P & xh;
      if (w == score_word) {
        ph_bit = (ph >> score_off) & 1u;
        mh_bit = (mh >> score_off) & 1u;
      }
      uint32_t ph_up = __shfl_up_sync(kFull, ph >> 31, 1);
      uint32_t mh_up = __shfl_up_sync(kFull, mh >> 31, 1);
      if (lane == 0) {
        ph_up = ph_in;
        mh_up = mh_in;
      }
      ph_in = __shfl_sync(kFull, ph >> 31, kWarp - 1);
      mh_in = __shfl_sync(kFull, mh >> 31, kWarp - 1);
      const uint32_t phs = (ph << 1) | ph_up;
      const uint32_t mhs = (mh << 1) | mh_up;
      if (live) {
        pv[w] = mhs | ~(xv | phs);
        mv[w] = phs & xv;
      }
    }
    score += static_cast<int>(__ballot_sync(kFull, ph_bit) != 0u)
             - static_cast<int>(__ballot_sync(kFull, mh_bit) != 0u);
    best = min(best, score);
  }
  if (lane == 0) out[pair] = global_mode ? score : best;
}

int max_smem_optin(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted (or when B or n
// is 0, where nothing is launched).
int myers_distance(const void* texts, const void* patterns, const void* m_lens,
                   void* out, int batch, int n, int m_bits, int global_mode,
                   int device, void* stream) {
  if (batch < 0 || n < 0 || m_bits <= 0 || m_bits % kWordBits != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0 || n == 0) return cudaSuccess;
  int max_smem = 0;
  err = static_cast<cudaError_t>(max_smem_optin(device, &max_smem));
  if (err != cudaSuccess) return err;
  const int nw = m_bits / kWordBits;
  const size_t per_warp = static_cast<size_t>(kWordsPerPair) * nw * sizeof(uint32_t);
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && per_warp * warps > static_cast<size_t>(max_smem)) --warps;
  const size_t smem = per_warp * warps;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(myers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + warps - 1) / warps), block(kWarp * warps);
  myers_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(texts), static_cast<const int8_t*>(patterns),
      static_cast<const int32_t*>(m_lens), static_cast<int32_t*>(out), batch, n, nw,
      global_mode);
  return cudaGetLastError();
}

// The widest pattern one warp's shared memory holds on `device` (0 on error).
int myers_max_m_bits(int device) {
  int max_smem = 0;
  if (max_smem_optin(device, &max_smem) != cudaSuccess) return 0;
  return max_smem / (kWordsPerPair * static_cast<int>(sizeof(uint32_t))) * kWordBits;
}

}  // extern "C"
