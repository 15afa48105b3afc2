// The card's rate of the GenASM kernels' 32-bit word operations (sm_90a).
//
// Not a port of a TPU kernel: a measurement.  The operations bounds of the
// port (chip_smoke.py's dc_work / bitalign_work / myers_work, and the
// roofline's peak_word_ops) count operations as the sources write them:
// shl1 is three (two shifts and an OR), the add with carry five (add,
// compare, add the carry in, compare, OR), Mv | ~(Xh | Pv) three.  The
// card runs several of them as one instruction (a funnel shift, a
// three-input LOP3, an add with carry), so its instruction rate, 64
// results a clock per SM, is not their rate.  These two kernels run the
// counted recurrences with nothing else in the way -- no memory traffic,
// no shuffles, no synchronisation -- and so measure it:
//
//   * dc_chain:    the GenASM-DC / BitAlign row recurrence of
//     csrc/genasm_dc.cu on rows 0..kRows of a window of kNW words,
//       R_new[0] = shl1(R_old[0]) | PM
//       R_new[d] = R_old[d-1] & shl1(R_old[d-1]) & shl1(R_new[d-1])
//                  & (shl1(R_old[d]) | PM),
//     (4 + 13 kRows) kNW ops a char, as dc_work counts them;
//   * myers_chain: the Myers step of csrc/myers.cu (semiglobal) on kNW
//     words, 23 kNW + 7 ops a char, as myers_work counts them.
//
// Each thread runs kWindows independent windows in registers over n chars;
// the char's mask alternates between two registers (even and odd chars),
// so selecting it costs nothing.  Whatever the compiler folds or reuses in
// the counted work (a shl1 shared by two rows) counts in the rate's
// favour, as it could in any kernel: the rate is the most the card does
// of this work a second, and a bound from it the least time.  out[t] is
// the XOR of thread t's final state, so the work cannot be dropped and a
// short run can be held against the plain version
// (repro_torch/kernels/word_ops.py).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNW = 2;       // words a window: w = 64
constexpr int kRows = 4;     // DC rows 1..kRows after row 0
constexpr int kWindows = 2;  // independent windows a thread
constexpr int kThreads = 256;

// a thread's seeded word `slot`: the plain version computes the same
__device__ __forceinline__ uint32_t mix32(uint32_t t, uint32_t slot) {
  uint32_t x = t * 0x9E3779B1u + slot * 0x85EBCA77u + 0x165667B1u;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  return x;
}

__device__ __forceinline__ void shl1(const uint32_t (&x)[kNW], uint32_t (&y)[kNW]) {
#pragma unroll
  for (int j = kNW - 1; j >= 0; --j) {
    y[j] = (x[j] << 1) | (j > 0 ? (x[j - 1] >> 31) : 0u);
  }
}

// one text char of the DC recurrence, rows 0..kRows in place
__device__ __forceinline__ void dc_char(uint32_t (&r)[kRows + 1][kNW],
                                        const uint32_t (&pm)[kNW]) {
  uint32_t held[kNW], s[kNW];
#pragma unroll
  for (int j = 0; j < kNW; ++j) held[j] = r[0][j];
  shl1(r[0], s);
#pragma unroll
  for (int j = 0; j < kNW; ++j) r[0][j] = s[j] | pm[j];
#pragma unroll
  for (int d = 1; d <= kRows; ++d) {
    uint32_t own[kNW], sd[kNW], si[kNW], sm[kNW];
#pragma unroll
    for (int j = 0; j < kNW; ++j) own[j] = r[d][j];
    shl1(held, sd);
    shl1(r[d - 1], si);
    shl1(own, sm);
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      r[d][j] = held[j] & sd[j] & si[j] & (sm[j] | pm[j]);
      held[j] = own[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) dc_chain(uint32_t* __restrict__ out,
                                                     int threads, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t r[kWindows][kRows + 1][kNW], pm[kWindows][2][kNW];
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
#pragma unroll
    for (int d = 0; d <= kRows; ++d) {
#pragma unroll
      for (int j = 0; j < kNW; ++j) r[w][d][j] = 0xFFFFFFFFu;
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int j = 0; j < kNW; ++j) pm[w][p][j] = mix32(t, (w * 2 + p) * kNW + j);
    }
  }
  for (int i = 0; i < n; i += 2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int w = 0; w < kWindows; ++w) dc_char(r[w], pm[w][p]);
    }
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
#pragma unroll
    for (int d = 0; d <= kRows; ++d) {
#pragma unroll
      for (int j = 0; j < kNW; ++j) acc ^= r[w][d][j];
    }
  }
  out[t] = acc;
}

// one text char of the Myers step: cin is the bit shifted into Ph's word
// 0 (0 semiglobal), off the score bit of the top word
__device__ __forceinline__ void myers_char(uint32_t (&pv)[kNW], uint32_t (&mv)[kNW],
                                           const uint32_t (&eq)[kNW], int& score,
                                           int& best, uint32_t cin, int off) {
  uint32_t carry = 0u, phin = cin, mhin = 0u, pb = 0u, mb = 0u;
#pragma unroll
  for (int j = 0; j < kNW; ++j) {
    const uint32_t xv = eq[j] | mv[j];
    const uint32_t a = eq[j] & pv[j];
    const uint32_t s = a + pv[j];
    const uint32_t c1 = s < a;
    const uint32_t s2 = s + carry;
    const uint32_t c2 = s2 < s;
    carry = c1 | c2;
    const uint32_t xh = (s2 ^ pv[j]) | eq[j];
    const uint32_t ph = mv[j] | ~(xh | pv[j]);
    const uint32_t mh = pv[j] & xh;
    if (j == kNW - 1) {
      pb = (ph >> off) & 1u;
      mb = (mh >> off) & 1u;
    }
    const uint32_t phs = (ph << 1) | phin;
    phin = ph >> 31;
    const uint32_t mhs = (mh << 1) | mhin;
    mhin = mh >> 31;
    pv[j] = mhs | ~(xv | phs);
    mv[j] = phs & xv;
  }
  score += static_cast<int>(pb) - static_cast<int>(mb);
  best = min(best, score);
}

__global__ void __launch_bounds__(kThreads) myers_chain(uint32_t* __restrict__ out,
                                                        int threads, int n,
                                                        uint32_t cin, int off) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t pv[kWindows][kNW], mv[kWindows][kNW], eq[kWindows][2][kNW];
  int score[kWindows], best[kWindows];
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      pv[w][j] = 0xFFFFFFFFu;
      mv[w][j] = 0u;
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int j = 0; j < kNW; ++j) eq[w][p][j] = mix32(t, (w * 2 + p) * kNW + j);
    }
    score[w] = best[w] = kNW * 32;
  }
  for (int i = 0; i < n; i += 2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int w = 0; w < kWindows; ++w) {
        myers_char(pv[w], mv[w], eq[w][p], score[w], best[w], cin, off);
      }
    }
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
#pragma unroll
    for (int j = 0; j < kNW; ++j) acc ^= pv[w][j] ^ mv[w][j];
    acc ^= static_cast<uint32_t>(score[w]) ^ static_cast<uint32_t>(best[w]);
  }
  out[t] = acc;
}

bool bad_args(int threads, int n) { return threads <= 0 || n < 0 || n % 2 != 0; }

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 when the launch was accepted.
// (out [threads] uint32, threads, n chars (even), device, stream)
int word_ops_dc(void* out, int threads, int n, int device, void* stream) {
  if (bad_args(threads, n)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dc_chain<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out),
                                                   threads, n);
  return cudaGetLastError();
}

// (out, threads, n chars (even), cin, off, device, stream)
int word_ops_myers(void* out, int threads, int n, unsigned cin, int off, int device,
                   void* stream) {
  if (bad_args(threads, n) || off < 0 || off > 31 || cin > 1u) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  myers_chain<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out),
                                                      threads, n, cin, off);
  return cudaGetLastError();
}

// out[0] words a window, out[1] DC rows after row 0, out[2] windows a
// thread, out[3] threads a block
int word_ops_shape(int* out) {
  out[0] = kNW;
  out[1] = kRows;
  out[2] = kWindows;
  out[3] = kThreads;
  return 0;
}

}  // extern "C"
