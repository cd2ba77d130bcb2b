// Fixed-point min-sum flooding decoder for NVIDIA Hopper (sm_90a).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::make_pallas_decoder.kernel
// (:390, reached from pallas_call :1076) in its flooding forms: fixed
// iterations (flood_first :721, flood_iter :659, _cn_minsum :105,
// syndrome_ok :602; K1) and per-lane early termination (run_et with
// latch_hard; K2), both with the fused-IO stages (quant32 :566 in,
// emit_counts :590 out; K1-IO), and the flooding forms of the Monte-Carlo
// megakernel (the mc branch :432-558, reached from pallas_call :990;
// K1-MC). Bit-exact with golden.decoder.decode_fixed(schedule="flooding")
// and with the plain torch version beside the wrapper
// (ldpc_tpu_torch/ops/decode_ref.py).
//
// What bounds it on the H100: not device memory (a codeword brings 4n bytes
// of float LLRs, or n of int8, in and a few bytes of counters out, against
// max_iter * E * Z edge updates: 20 * 88 * 27 = 47,520 for the 802.11n
// n=648 code) but the shared-memory pipe, integer latency and the two block
// barriers an iteration.
//
// Two kernel templates share the library.
//
// flood_packed_kernel<LPT, DMAX, MC>: the fixed-iteration min-sum family
// (K1, K1-IO, K1-MC flooding) wherever a block of four lanes fits, laid out
// for this card:
//  * Thread (x, y) owns LPT codeword lanes (4x .. 4x + 3) of row y of every
//    base row and column. The state keeps the lane index innermost (below),
//    so one LPT-lane word is one shared-memory access and a warp's access
//    covers 32 * LPT bytes of messages (128 for LPT = 4) or 64 * LPT of
//    totals. The template also builds LPT = 2; the library instantiates
//    LPT = 4 only (kLanesPerThread: four lanes beat one, the parent's
//    layout, on n=648; PERF.md section 6).
//  * The entry tables are uniform across the block, so they travel in the
//    kernel's parameter space (the constant bank: `PackedTab`, up to
//    kTabWords words, CUDA >= 12.1) instead of shared memory: no table
//    lookup goes through the shared-memory pipe.
//  * The check row is read once. The reduce pass keeps each entry's
//    value in a register as one byte a lane, min(|raw|, qmax) in 7 bits
//    plus the sign of raw (DMAX registers, DMAX >= the largest base-row
//    degree); the emit pass reads nothing and computes CnRow::emit on the
//    four bytes at once (SWAR: exclusion by value, so ties all get min2o).
//    Per edge a thread makes one totals load, one message load and one
//    message store. A code whose rows are longer than the largest DMAX
//    instance takes DMAX = 0, which reads the row twice.
//  * The arithmetic runs on 16x2 pairs (__vadd2, __vmins2, __vmaxs2: one
//    instruction each on sm_90), and the messages are stored negated, so a
//    row's raw value tot - c2v is one add.
//  * Lanes per block follow the state (packed_shape): of the shapes whose
//    state fits, the fewest lanes keeping 9/10 of the most codewords an SM
//    holds; for n=648 that is twelve one-warp blocks of 4 lanes an SM.
// Shared memory, one block of L lanes:
//   s_flag, s_bits int32 [L]       final syndrome flag, info-bit errors
//   tot   int16 [n][L]              totals chan + sum(c2v); int16 is lossless
//                                   since |tot| <= (dv_max + 1) * qmax, which
//                                   the wrapper checks is < 2^15
//   chan  int8  [n][L]              quantized channel LLRs
//   c2v   int8  [E * Z][L]          check-to-variable messages, negated,
//                                   entry-major
// Each iteration has two phases separated by __syncthreads():
//   V: thread y recomputes tot[j][y] = chan - the sum over the base column's
//      entries (e, s) of c2v[e][(y - s) mod Z] (a gather: no atomics);
//   C: thread y updates check row y of every base row from tot[col][(y +
//      s) mod Z] - c2v[e][y]; only thread y touches c2v[.][y] in this phase.
// Iteration 1 takes c2v = 0 without reading it (flood_first), so the
// buffer is never zeroed, and the MC prologue may borrow it for the
// codeword bits. Lanes past the batch are masked in their data, never in
// their barriers. Device-memory words of chan, info and hard are vectors of
// LPT lanes where aligned and whole, else single lanes.
//
// minsum_flood_kernel<ET, MC, STAR>: the earlier one-lane-a-thread layout,
// kept for early termination (K2), min* (K5, cn_minstar.cuh) and the fixed
// min-sum family on a code that admits no block of four lanes (DVB-S2
// n=16,200, NR BG1 Z=384); the tables sit in shared memory there. Thread
// (x, y) = (codeword lane, row y). The row is read twice (once to reduce,
// once to emit); with min* the two reads are the suffix pass into an int8
// scratch of star_deg slots per row and the prefix pass that emits.
//
// Early termination (template ET). After the V phase of iteration k the
// totals are state k; every thread of a lane that is not done checks its
// check rows and marks the lane's flag with k when one is unsatisfied, and
// after a barrier a lane whose flag is not k is done, with iters = k. A done
// lane skips both phases from then on, which freezes its totals at its first
// success (latch_hard's effect). The block leaves the loop once no lane is
// active (__syncthreads_or gives every thread the same answer).
//
// Monte-Carlo megakernel (template MC, K1-MC; mc_stage.cuh): the channel
// comes from the in-kernel prologue (Philox or injected words -> info bits
// -> structured encode -> BPSK/AWGN/demap/quantize) instead of device
// memory, the codeword bits borrow the c2v buffer, and the error count draws
// each info bit again. The packed kernel runs the prologue on its LPT lanes
// at once (mc_prologue_lanes: the codeword bits of LPT lanes are one word,
// so the encode's XORs take them together), from the parameter-space
// tables.

#include <string.h>

#include <algorithm>

#include "cn_minsum.cuh"
#include "cn_minstar.cuh"
#include "mc_stage.cuh"

namespace {

using ldpc::align16;
using ldpc::Params;

// ---------------------------------------------------------------------------
// The packed fixed-iteration instance.

constexpr int kTabWords = 8000;       // uint32 words of tables in the parameters
constexpr int kSmSmem = 233472;       // shared memory an SM gives its blocks
constexpr int kBlockReserve = 1024;   // the runtime's share per resident block
constexpr int kSmWarps = 64;
constexpr int kSmBlocks = 32;
constexpr int kLanesPerThread = 4;   // the one packed instance built
constexpr int kRowDegrees[3] = {8, 16, 24};   // the DMAX instances

// Entry tables (uint32): layer_ptr[mb + 1], col_ptr[nb + 1],
// ent[E] = (col * Z) << 11 | shift (by base row), col_ent[E] =
// (e * Z) << 11 | shift (by base column); so Z <= 2047 and n, E * Z < 2^21.
// kernels/minsum.py::packed_tables builds them.
struct PackedTab {
  uint32_t w[kTabWords];
};

struct PackedArgs {
  Params p;
  PackedTab t;
};
static_assert(sizeof(PackedArgs) <= 32764, "kernel parameters above 32,764 B");

inline size_t packed_smem(int nb, int Z, int E, int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(8 * size_t(lanes)) + align16(2 * n * lanes)
       + align16(n * lanes) + align16(size_t(E) * Z * lanes);
}

struct PackedShape {
  int lanes, smem, blocks;   // blocks: resident an SM by this rule
};

// Lanes per block at kLanesPerThread lanes a thread: of the block shapes
// (lanes a multiple of it, lanes / kLanesPerThread * Z <= 1024 threads,
// state within the opt-in) the fewest lanes that keep at least 9/10 of the most
// codewords an SM holds (its shared memory with the runtime's reserve per
// block, warps, blocks). Small blocks fill the last wave of a batch finely
// and wait at barriers that span few warps. lanes 0 when no block fits.
inline PackedShape packed_shape(int nb, int Z, int E) {
  PackedShape shapes[ldpc::kMaxThreads];
  int count = 0, most = 0;
  for (int k = 1; k * Z <= ldpc::kMaxThreads; ++k) {
    const int lanes = k * kLanesPerThread;
    const size_t smem = packed_smem(nb, Z, E, lanes);
    if (smem > size_t(ldpc::kMaxSmem)) break;
    const int warps = (k * Z + 31) / 32;
    const int blocks = std::min({kSmSmem / int(smem + kBlockReserve),
                                 kSmWarps / warps, kSmBlocks});
    shapes[count++] = PackedShape{lanes, int(smem), blocks};
    most = std::max(most, blocks * lanes);
  }
  for (int i = 0; i < count; ++i)
    if (10 * shapes[i].blocks * shapes[i].lanes >= 9 * most) return shapes[i];
  return PackedShape{0, 0, 0};
}

// The DMAX instance for a largest base-row degree (0: the two-pass row).
inline int row_instance(int max_deg) {
  for (int i = 0; i < 3; ++i)
    if (max_deg <= kRowDegrees[i]) return i;
  return 3;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// int8 lanes 0, 1 (lo) or 2, 3 (hi) of w, sign-extended into 16x2 pairs.
__device__ __forceinline__ uint32_t widen_lo(uint32_t w) { return prmt(w, 0, 0x9180); }
__device__ __forceinline__ uint32_t widen_hi(uint32_t w) { return prmt(w, 0, 0xB3A2); }

// Words of LPT lanes: int8 lanes in one uint32 (byte k = lane k), int16
// lanes in two (lo: lanes 0, 1; hi: lanes 2, 3). LPT is 2 or 4: every
// access below covers exactly the thread's own lanes.
template <int LPT>
__device__ __forceinline__ uint32_t ld8(const int8_t* a) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  if constexpr (LPT == 4) return *reinterpret_cast<const uint32_t*>(a);
  else return *reinterpret_cast<const uint16_t*>(a);
}

template <int LPT>
__device__ __forceinline__ void st8(int8_t* a, uint32_t w) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  if constexpr (LPT == 4) *reinterpret_cast<uint32_t*>(a) = w;
  else *reinterpret_cast<uint16_t*>(a) = uint16_t(w);
}

template <int LPT>
__device__ __forceinline__ void ld16(const int16_t* a, uint32_t& lo, uint32_t& hi) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  if constexpr (LPT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(a);
    lo = v.x;
    hi = v.y;
  } else {
    lo = *reinterpret_cast<const uint32_t*>(a);
    hi = 0;
  }
}

template <int LPT>
__device__ __forceinline__ void st16(int16_t* a, uint32_t lo, uint32_t hi) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  if constexpr (LPT == 4) *reinterpret_cast<uint2*>(a) = make_uint2(lo, hi);
  else *reinterpret_cast<uint32_t*>(a) = lo;
}

__device__ __forceinline__ int lane8(uint32_t w, int k) {
  return int(int8_t(uint8_t(w >> (8 * k))));
}

__device__ __forceinline__ int lane16(uint32_t lo, uint32_t hi, int k) {
  const uint32_t w = k < 2 ? lo : hi;
  return (k & 1) ? int(w) >> 16 : int(int16_t(uint16_t(w)));
}

template <int LPT, typename T>
__device__ __forceinline__ bool aligned_for(const T* a) {
  return (reinterpret_cast<uintptr_t>(a) & (sizeof(T) * LPT - 1)) == 0;
}

// The quantized channel of LPT lanes at device index g (lanes whole and
// the address aligned: one vector load; else lane by lane, 0 past the
// batch), packed as int8 lanes.
template <int LPT>
__device__ __forceinline__ uint32_t load_chan_lanes(const Params& p, size_t g,
                                                    int nvalid) {
  uint32_t w = 0;
  if (p.chan_is_f32) {
    const float* f = static_cast<const float*>(p.chan) + g;
    float x[LPT];
    if (nvalid == LPT && aligned_for<LPT>(f)) {
      if constexpr (LPT == 4) {
        const float4 v = *reinterpret_cast<const float4*>(f);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(f);
        x[0] = v.x; x[1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < LPT; ++k) x[k] = k < nvalid ? f[k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      w |= uint32_t(uint8_t(ldpc::quant32(x[k], p.scale, p.qmax))) << (8 * k);
    return w;
  }
  const int8_t* c = static_cast<const int8_t*>(p.chan) + g;
  if (nvalid == LPT && aligned_for<LPT>(c)) return ld8<LPT>(c);
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    if (k < nvalid) w |= uint32_t(uint8_t(c[k])) << (8 * k);
  return w;
}

// The int8 lanes of a word of 16x2 pairs (values in [0, 127]): the low
// byte of each half of lo (lanes 0, 1) and hi (lanes 2, 3); with 0x7531,
// the high bytes (each lane's sign in bit 7).
__device__ __forceinline__ uint32_t bytes_of(uint32_t lo, uint32_t hi,
                                             uint32_t sel = 0x6420) {
  return prmt(lo, hi, sel);
}

// One check row's min-sum state for the thread's lanes as NP = LPT / 2
// pairs of 16-bit lanes: CnRow of cn_minsum.cuh, two lanes an
// instruction. The messages are stored negated (n = -c2v), so raw = tot - c2v
// is one add.
template <int LPT>
struct PackedRow {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  static constexpr int NP = LPT / 2;
  uint32_t min1[NP], min2[NP];
  uint32_t ns = 0;   // the row's sign product, bit 7 of each lane's byte

  __device__ __forceinline__ PackedRow() {
#pragma unroll
    for (int k = 0; k < NP; ++k) min1[k] = min2[k] = 0x40004000u;  // kMinSentinel
  }

  // The row bytes of one entry, min(|raw|, qmax) | sign(raw) << 7 a lane,
  // from its totals t (16x2 pairs) and negated old message word n; with ADD
  // the row takes them in. A padded entry (!real) leaves min1, min2 and the
  // sign product as they were: its magnitude 127 is >= every min2 of a row
  // of degree >= 2, and its sign is not taken.
  template <bool ADD>
  __device__ __forceinline__ uint32_t entry(const uint32_t (&t)[2], uint32_t n,
                                            uint32_t q2, bool real = true) {
    uint32_t m[2] = {0u, 0u}, raw[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      raw[k] = __vadd2(t[k], k ? widen_hi(n) : widen_lo(n));
      m[k] = __vmins2(__vmaxs2(raw[k], __vneg2(raw[k])), q2);
      if (ADD) {
        const uint32_t mk = real ? m[k] : 0x007f007fu;
        min2[k] = __vmins2(min2[k], __vmaxs2(min1[k], mk));
        min1[k] = __vmins2(min1[k], mk);
      }
    }
    const uint32_t w = bytes_of(m[0], m[1]) |
                       (bytes_of(raw[0], raw[1], 0x7531) & 0x80808080u);
    if (ADD && real) ns ^= w & 0x80808080u;
    return w;
  }
};

// CnRow::finish and emit on packed lanes: the new negated message bytes of
// an entry from its row bytes w. m1: min1 a byte; o1, o2: min1o, min2o; ns:
// the row's sign product in bit 7 of each byte.
struct PackedEmit {
  uint32_t m1, o1, o2, ns;

  template <int LPT>
  __device__ __forceinline__ PackedEmit(const PackedRow<LPT>& r,
                                        const Params& p) {
    uint32_t a[2] = {r.min1[0], 0u}, b[2] = {r.min2[0], 0u};
    if constexpr (LPT == 4) {
      a[1] = r.min1[1];
      b[1] = r.min2[1];
    }
    m1 = bytes_of(a[0], a[1]);
    if (p.alpha_num != 1 || p.alpha_shift != 0) {
      // (m * num) >> shift a half: m * num < 2^15 carries into no half
      const uint32_t keep = (0xffffu >> p.alpha_shift) * 0x00010001u;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        a[k] = ((a[k] * uint32_t(p.alpha_num)) >> p.alpha_shift) & keep;
        b[k] = ((b[k] * uint32_t(p.alpha_num)) >> p.alpha_shift) & keep;
      }
    }
    if (p.beta) {
      const uint32_t nb = (uint32_t(-p.beta) & 0xffffu) * 0x00010001u;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        a[k] = __viaddmax_s16x2(a[k], nb, 0u);
        b[k] = __viaddmax_s16x2(b[k], nb, 0u);
      }
    }
    o1 = bytes_of(a[0], a[1]);
    o2 = bytes_of(b[0], b[1]);
    ns = r.ns;
  }

  // Every byte at once: bytes of (w & 0x7f) equal to min1 take min2o, the
  // others min1o (a byte x <= 0x7f is nonzero exactly when x + 0x7f sets
  // bit 7, and no byte carries); the stored message is the negated one, so
  // the magnitude (<= 127) is negated per byte, as (0x80 - m) ^ 0x80, where
  // sign(raw) ^ sign product is clear.
  __device__ __forceinline__ uint32_t emit(uint32_t w) const {
    const uint32_t x = (w & 0x7f7f7f7fu) ^ m1;
    const uint32_t ne = (((x + 0x7f7f7f7fu) & 0x80808080u) >> 7) * 0xffu;
    const uint32_t mag = (o1 & ne) | (o2 & ~ne);
    const uint32_t sm = (((w ^ ns) & 0x80808080u) >> 7) * 0xffu;
    const uint32_t negm = (0x80808080u - mag) ^ 0x80808080u;
    return (mag & sm) | (negm & ~sm);
  }
};

// lam_range of mc_stage.cuh for the thread's LPT lanes at once: the XOR
// over base row li's entries with lo <= col < hi (columns ascend within a
// row) of the codeword-bit bytes cw[col][(row + s) mod Z], from the
// parameter-space tables (entry word colZ << 11 | shift).
template <int LPT>
__device__ __forceinline__ uint32_t lam_lanes(const uint32_t* tw, int o_ent,
                                              int li, int lo, int hi,
                                              const int8_t* cw_l, int Z,
                                              int L, int row) {
  uint32_t x = 0;
  for (int e = tw[li]; e < int(tw[li + 1]); ++e) {
    const uint32_t en = tw[o_ent + e];
    const int cz = int(en >> 11);
    if (cz < lo * Z) continue;
    if (cz >= hi * Z) break;
    int c = row + int(en & 0x7ffu);
    if (c >= Z) c -= Z;
    x ^= ld8<LPT>(cw_l + (cz + c) * L);
  }
  return x;
}

// mc_prologue of mc_stage.cuh (the same draws, encode and float stage, in
// the same order a lane) for the thread's LPT lanes at once: the codeword
// bits of LPT lanes are one word of bytes, so the encode's XORs take them
// together, and the lanes' Box-Muller pairs are independent work. Lanes
// past the batch get zero bits and zero LLRs; every thread reaches the
// three barriers.
template <int LPT>
__device__ void mc_prologue_lanes(const Params& p, const uint32_t* tw,
                                  int8_t* cw, int8_t* chan, int nvalid,
                                  long long b0, int row, int lane0) {
  const int Z = p.Z, L = p.lanes, nb = p.nb, mb = p.mb;
  const int kb = p.kb, cb = p.mc.cb, o_ent = mb + nb + 2;
  const int nph = (nb + 1) / 2, k = kb * Z;
  int8_t* const cw_l = cw + lane0;

  // 1. info bits: one word per bit, its least significant bit
  for (int j = 0; j < kb; ++j) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (i < nvalid) w |= uint32_t(ldpc::mc_info_bit(p, b0 + i, j, row)) << (8 * i);
    st8<LPT>(cw_l + (j * Z + row) * L, w);
  }
  __syncthreads();
  // 2. p0 = XOR of the core rows' syndromes of the info part
  uint32_t p0 = 0;
  for (int i = 0; i < cb; ++i)
    p0 ^= lam_lanes<LPT>(tw, o_ent, i, 0, kb, cw_l, Z, L, row);
  st8<LPT>(cw_l + (kb * Z + row) * L, p0);
  __syncthreads();
  // 3. staircase over the core rows
  uint32_t par = 0;
  for (int tt = 0; tt < cb - 1; ++tt) {
    par ^= lam_lanes<LPT>(tw, o_ent, tt, 0, kb + 1, cw_l, Z, L, row);
    st8<LPT>(cw_l + ((kb + tt + 1) * Z + row) * L, par);
  }
  __syncthreads();
  // 4. extension rows: their own identity column from columns < kb + cb
  for (int e = cb; e < mb; ++e)
    st8<LPT>(cw_l + ((kb + e) * Z + row) * L,
             lam_lanes<LPT>(tw, o_ent, e, 0, kb + cb, cw_l, Z, L, row));

  // 5. BPSK + AWGN + demap + quantize on the thread's own rows
  float sigma[LPT], gain[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    sigma[i] = p.mc.sigma;
    gain[i] = p.mc.gain;
    if (p.mc.sigma_lane && i < nvalid) {
      sigma[i] = p.mc.sigma_lane[b0 + i];
      gain[i] = p.mc.gain_lane[b0 + i];
    }
  }
  for (int q = 0; q < nph; ++q) {
    float nrm[LPT][2];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      nrm[i][0] = nrm[i][1] = 0.f;
      if (i < nvalid) {
        const float f1 = ldpc::mc_unit(ldpc::mc_word(p, b0 + i, k + q * Z + row));
        const float f2 =
            ldpc::mc_unit(ldpc::mc_word(p, b0 + i, k + (nph + q) * Z + row));
        const float r = sqrtf(__fmul_rn(-2.f, logf(f1)));
        const float th = __fmul_rn(float(2.0 * 3.14159265358979323846), f2);
        nrm[i][0] = __fmul_rn(r, cosf(th));
        nrm[i][1] = __fmul_rn(r, sinf(th));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * q + h;
      if (j >= nb) break;
      const int v = j * Z + row;
      const uint32_t c = ld8<LPT>(cw_l + v * L);
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        if (i < nvalid)
          w |= uint32_t(uint8_t(ldpc::mc_quant((c >> (8 * i)) & 1, nrm[i][h],
                                               sigma[i], gain[i], p.qmax)))
               << (8 * i);
      st8<LPT>(chan + v * L + lane0, w);
    }
  }
}

template <int LPT, int DMAX, bool MC>
__global__ void __launch_bounds__(1024)
flood_packed_kernel(const __grid_constant__ PackedArgs a) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = a.p;
  const uint32_t* tw = a.t.w;
  const int L = p.lanes, Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const int n = nb * Z, ZL = Z * L;
  const int o_col = mb + 1, o_ent = mb + nb + 2, o_cent = o_ent + E;
  const uint32_t q2 = uint32_t(p.qmax) * 0x00010001u;

  int32_t* s_flag = reinterpret_cast<int32_t*>(smem);
  int32_t* s_bits = s_flag + L;
  unsigned char* cursor = smem + align16(8 * size_t(L));
  int16_t* tot = reinterpret_cast<int16_t*>(cursor);
  cursor += align16(2 * size_t(n) * L);
  int8_t* chan = reinterpret_cast<int8_t*>(cursor);
  cursor += align16(size_t(n) * L);
  int8_t* c2v = reinterpret_cast<int8_t*>(cursor);   // negated messages

  const int row = threadIdx.y;
  const int lane0 = threadIdx.x * LPT;
  const int tid = row * blockDim.x + threadIdx.x;
  const long long b0 = (long long)blockIdx.x * L + lane0;
  const int nvalid = int(min((long long)LPT, max(p.B - b0, 0LL)));
  int16_t* const tot_l = tot + lane0;
  int8_t* const msg_row = c2v + row * L + lane0;   // + e * Z * L: entry e

  for (int i = tid; i < L; i += blockDim.x * blockDim.y) {
    s_flag[i] = 0;
    s_bits[i] = 0;
  }

  // Channel in: this thread owns row `row` of every base column.
  if constexpr (MC) {
    mc_prologue_lanes<LPT>(p, tw, c2v, chan, nvalid, b0, row, lane0);
  } else {
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      st8<LPT>(chan + v * L + lane0,
               load_chan_lanes<LPT>(p, size_t(v) * p.B + b0, nvalid));
    }
  }

  // The totals (16x2 pairs) of entry word en = colZ << 11 | shift: column
  // variable (colZ + (row + shift) mod Z).
  auto tot_of = [&](uint32_t en, uint32_t (&t)[2]) {
    int c = row + int(en & 0x7ffu);
    if (c >= Z) c -= Z;
    ld16<LPT>(tot_l + (int(en >> 11) + c) * L, t[0], t[1]);
  };

  for (int it = 0;; ++it) {
    // V phase: totals of the current messages (state `it`), chan - the sum
    // of the negated messages; c2v = 0 at 0.
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      const uint32_t ch = ld8<LPT>(chan + v * L + lane0);
      uint32_t lo = widen_lo(ch), hi = LPT == 4 ? widen_hi(ch) : 0u;
      if (it) {
        uint32_t s_lo = 0, s_hi = 0;
        const int q1 = tw[o_col + j + 1];
        for (int q = tw[o_col + j]; q < q1; ++q) {
          const uint32_t ce = tw[o_cent + q];   // eZ << 11 | shift
          int r = row - int(ce & 0x7ffu);
          if (r < 0) r += Z;
          const uint32_t m = ld8<LPT>(c2v + (int(ce >> 11) + r) * L + lane0);
          s_lo = __vadd2(s_lo, widen_lo(m));
          if constexpr (LPT == 4) s_hi = __vadd2(s_hi, widen_hi(m));
        }
        lo = __vadd2(lo, __vneg2(s_lo));
        if constexpr (LPT == 4) hi = __vadd2(hi, __vneg2(s_hi));
      }
      st16<LPT>(tot + v * L + lane0, lo, hi);
    }
    __syncthreads();
    if (it == p.max_iter) break;

    // C phase: check row `row` of every base row.
    for (int li = 0; li < mb; ++li) {
      const int e0 = tw[li], d = int(tw[li + 1]) - e0;
      int8_t* const m0 = msg_row + e0 * ZL;
      PackedRow<LPT> cn;
      if constexpr (DMAX > 0) {
        // the row in registers; entries past d repeat the last one's loads
        // and are left out of the reduction and the stores
        uint32_t rb[DMAX];
#pragma unroll
        for (int i = 0; i < DMAX; ++i) {
          const int ei = min(i, d - 1);
          uint32_t t[2];
          tot_of(tw[o_ent + e0 + ei], t);
          const uint32_t nw = it ? ld8<LPT>(m0 + ei * ZL) : 0u;
          rb[i] = cn.template entry<true>(t, nw, q2, i < d);
        }
        const PackedEmit em(cn, p);
#pragma unroll
        for (int i = 0; i < DMAX; ++i)
          if (i < d) st8<LPT>(m0 + i * ZL, em.emit(rb[i]));
      } else {
        // rows longer than every register instance: read twice
        for (int i = 0; i < d; ++i) {
          uint32_t t[2];
          tot_of(tw[o_ent + e0 + i], t);
          cn.template entry<true>(t, it ? ld8<LPT>(m0 + i * ZL) : 0u, q2);
        }
        const PackedEmit em(cn, p);
        for (int i = 0; i < d; ++i) {
          uint32_t t[2];
          tot_of(tw[o_ent + e0 + i], t);
          const uint32_t w = cn.template entry<false>(
              t, it ? ld8<LPT>(m0 + i * ZL) : 0u, q2);
          st8<LPT>(m0 + i * ZL, em.emit(w));
        }
      }
    }
    __syncthreads();
  }

  // Outputs from the final totals: hard bits or info-bit errors, and the
  // syndrome of the hard bits (the XOR of int16 totals carries the parity
  // of their signs in bits 15 and 31).
  int nerr[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) nerr[k] = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    uint32_t lo, hi;
    ld16<LPT>(tot + v * L + lane0, lo, hi);
    const uint32_t h = (bytes_of(lo, hi, 0x7531) >> 7) & 0x01010101u;
    const size_t g = size_t(v) * p.B + b0;
    if (p.hard) {
      uint8_t* out = p.hard + g;
      if (nvalid == LPT && aligned_for<LPT>(out)) {
        st8<LPT>(reinterpret_cast<int8_t*>(out), h);
      } else {
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          if (k < nvalid) out[k] = uint8_t(h >> (8 * k));
      }
    }
    if (j < p.kb && (MC || p.info)) {
      uint32_t ref = 0;
      if constexpr (MC) {
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          if (k < nvalid) ref |= uint32_t(ldpc::mc_info_bit(p, b0 + k, j, row)) << (8 * k);
      } else {
        const int8_t* in = reinterpret_cast<const int8_t*>(p.info + g);
        if (nvalid == LPT && aligned_for<LPT>(in)) {
          ref = ld8<LPT>(in);
        } else {
#pragma unroll
          for (int k = 0; k < LPT; ++k)
            if (k < nvalid) ref |= uint32_t(uint8_t(in[k])) << (8 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) nerr[k] += ((h ^ ref) >> (8 * k)) & 1;
    }
  }
  uint32_t un[2] = {0u, 0u};
  for (int li = 0; li < mb; ++li) {
    uint32_t x[2] = {0u, 0u};
    for (int e = tw[li]; e < int(tw[li + 1]); ++e) {
      uint32_t t[2];
      tot_of(tw[o_ent + e], t);
      x[0] ^= t[0];
      x[1] ^= t[1];
    }
    un[0] |= x[0];
    un[1] |= x[1];
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    if (lane16(un[0], un[1], k) < 0) atomicOr(&s_flag[lane0 + k], 1);
    if (nerr[k]) atomicAdd(&s_bits[lane0 + k], nerr[k]);
  }
  __syncthreads();
  if (row == 0) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      if (k >= nvalid) break;
      const long long b = b0 + k;
      p.iters[b] = p.max_iter;
      p.conv[b] = s_flag[lane0 + k] == 0;
      if (p.bits) {
        p.bits[b] = s_bits[lane0 + k];
        p.frame[b] = s_bits[lane0 + k] > 0;
      }
    }
  }
}

using PackedKernel = void (*)(PackedArgs);

// [DMAX 8, 16, 24, 0][MC], at kLanesPerThread lanes a thread
const PackedKernel kPacked[4][2] = {
    {flood_packed_kernel<kLanesPerThread, 8, false>,
     flood_packed_kernel<kLanesPerThread, 8, true>},
    {flood_packed_kernel<kLanesPerThread, 16, false>,
     flood_packed_kernel<kLanesPerThread, 16, true>},
    {flood_packed_kernel<kLanesPerThread, 24, false>,
     flood_packed_kernel<kLanesPerThread, 24, true>},
    {flood_packed_kernel<kLanesPerThread, 0, false>,
     flood_packed_kernel<kLanesPerThread, 0, true>}};

inline PackedKernel packed_kernel(int max_deg, bool mc) {
  return kPacked[row_instance(max_deg)][mc];
}

inline int packed_max_degree(const uint32_t* tab, int mb) {
  int d = 0;
  for (int i = 0; i < mb; ++i) d = std::max(d, int(tab[i + 1] - tab[i]));
  return d;
}

// Sets the instance's shared-memory attributes (the most dynamic shared
// memory it launches with, the largest carveout) before a launch or an
// occupancy query.
template <typename K>
cudaError_t prepare(K kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// ---------------------------------------------------------------------------
// The one-lane-a-thread template: early termination (K2) and min* (K5).

inline size_t smem_bytes(int nb, int Z, int mb, int E, int star_deg, int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(4 * size_t(ldpc::table_words(nb, mb, E)))
       + align16(8 * size_t(lanes))          // per-lane flag, bit errors
       + align16(2 * n * lanes)               // tot
       + align16(n * lanes)                   // chan
       + align16(size_t(E) * Z * lanes)       // c2v
       + align16(ldpc::star_scratch_bytes(star_deg, Z, lanes));  // min* suffixes
}

template <bool ET, bool MC, bool STAR>
__global__ void minsum_flood_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.lanes, Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const int n = nb * Z;
  const int T = ldpc::table_words(nb, mb, E);

  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  unsigned char* cursor = smem + align16(4 * size_t(T));
  // Fixed form: the final syndrome's unsatisfied flag. ET: the flag stamp.
  int32_t* s_flag = reinterpret_cast<int32_t*>(cursor);
  int32_t* s_bits = s_flag + L;
  cursor += align16(8 * size_t(L));
  int16_t* tot = reinterpret_cast<int16_t*>(cursor);
  cursor += align16(2 * size_t(n) * L);
  int8_t* chan = reinterpret_cast<int8_t*>(cursor);
  cursor += align16(size_t(n) * L);
  int8_t* c2v = reinterpret_cast<int8_t*>(cursor);
  cursor += align16(size_t(E) * Z * L);
  int8_t* scr = reinterpret_cast<int8_t*>(cursor);   // STAR only

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * L + lane;
  const int nthreads = L * Z;
  const long long b = (long long)blockIdx.x * L + lane;
  const bool valid = b < p.B;
  const int qmax = p.qmax;

  for (int i = tid; i < T; i += nthreads) tab[i] = p.tables[i];
  if (tid < L) {
    s_flag[tid] = ET ? -1 : 0;
    s_bits[tid] = 0;
  }
  const ldpc::Tables t = ldpc::tables_at(tab, nb, mb, E);

  // Channel in: this thread owns row `row` of every base column.
  if (MC) {
    __syncthreads();   // the tables, before the encode reads them
    ldpc::mc_prologue(p, t, reinterpret_cast<uint8_t*>(c2v), chan, valid, b,
                      row, lane);
    __syncthreads();   // every codeword bit read, before c2v is zeroed
  } else {
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      const int q = valid ? ldpc::load_chan(p, size_t(v) * p.B + b) : 0;
      chan[v * L + lane] = int8_t(q);
    }
  }
  for (int i = tid; i < E * Z * L; i += nthreads) c2v[i] = 0;
  __syncthreads();

  bool done = !valid;   // ET: lanes past the batch never run
  int iters = p.max_iter;
  for (int it = 0;; ++it) {
    // V phase: totals of the current messages (state `it`).
    if (!ET || !done) {
      for (int j = 0; j < nb; ++j) {
        const int v = j * Z + row;
        int acc = chan[v * L + lane];
        for (int q = t.col_ptr[j]; q < t.col_ptr[j + 1]; ++q) {
          const int e = t.col_ent[q];
          int r = row - t.ent_shift[e];
          if (r < 0) r += Z;
          acc += c2v[(e * Z + r) * L + lane];
        }
        tot[v * L + lane] = int16_t(acc);
      }
    }
    __syncthreads();
    if (ET) {
      if (!done && ldpc::rows_unsat(t, tot, mb, Z, L, row, lane))
        s_flag[lane] = it;
      __syncthreads();
      if (!done && s_flag[lane] != it) {
        done = true;
        iters = it;
      }
      if (it == p.max_iter || !__syncthreads_or(!done)) break;
    } else if (it == p.max_iter) {
      break;
    }

    // C phase: check row `row` of every base row.
    if (!ET || !done) {
      for (int li = 0; li < mb; ++li) {
        const int e0 = t.layer_ptr[li], e1 = t.layer_ptr[li + 1];
        // Second read of the row: entry e takes emit(its index, raw) as its
        // new message.
        auto write_row = [&](auto&& emit) {
          for (int e = e0; e < e1; ++e) {
            int c = row + t.ent_shift[e];
            if (c >= Z) c -= Z;
            const int idx = (e * Z + row) * L + lane;
            const int raw = int(tot[(t.ent_col[e] * Z + c) * L + lane]) - int(c2v[idx]);
            c2v[idx] = int8_t(emit(e - e0, raw));
          }
        };
        if constexpr (STAR) {
          ldpc::StarRow star(scr + row * L + lane, Z * L, e1 - e0);
          for (int e = e1 - 1; e > e0; --e) {
            int c = row + t.ent_shift[e];
            if (c >= Z) c -= Z;
            star.back(p, e - e0, int(tot[(t.ent_col[e] * Z + c) * L + lane])
                                     - int(c2v[(e * Z + row) * L + lane]));
          }
          write_row([&](int i, int raw) { return star.emit(p, i, raw); });
        } else {
          ldpc::CnRow cn;
          for (int e = e0; e < e1; ++e) {
            int c = row + t.ent_shift[e];
            if (c >= Z) c -= Z;
            cn.add(int(tot[(t.ent_col[e] * Z + c) * L + lane])
                   - int(c2v[(e * Z + row) * L + lane]), qmax);
          }
          cn.finish(p);
          write_row([&](int, int raw) { return cn.emit(raw, qmax); });
        }
      }
    }
    __syncthreads();
  }

  // Outputs from the final (for ET: frozen) totals: hard bits or info-bit
  // errors; the fixed form also takes the syndrome here.
  int nerr = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    const int h = tot[v * L + lane] < 0;
    if (valid) {
      const size_t g = size_t(v) * p.B + b;
      if (p.hard) p.hard[g] = uint8_t(h);
      if (MC && j < p.kb) nerr += h ^ ldpc::mc_info_bit(p, b, j, row);
      else if (p.info && j < p.kb) nerr += h ^ int(p.info[g]);
    }
  }
  if (!ET && ldpc::rows_unsat(t, tot, mb, Z, L, row, lane))
    atomicOr(&s_flag[lane], 1);
  if (nerr) atomicAdd(&s_bits[lane], nerr);
  __syncthreads();
  if (row == 0 && valid) {
    p.iters[b] = iters;
    p.conv[b] = ET ? done : s_flag[lane] == 0;
    if (p.bits) {
      p.bits[b] = s_bits[lane];
      p.frame[b] = s_bits[lane] > 0;
    }
  }
}

// kernels[STAR][MC][ET]; the fixed min-sum entries ([0][.][0]) launch only
// for a code whose state admits no block of four lanes (is_packed).
const ldpc::Kernel kOneLane[2][2][2] = {
    {{minsum_flood_kernel<false, false, false>,
      minsum_flood_kernel<true, false, false>},
     {minsum_flood_kernel<false, true, false>,
      minsum_flood_kernel<true, true, false>}},
    {{minsum_flood_kernel<false, false, true>,
      minsum_flood_kernel<true, false, true>},
     {minsum_flood_kernel<false, true, true>,
      minsum_flood_kernel<true, true, true>}}};

// The fixed min-sum family takes the packed kernel wherever a block of
// four lanes fits, and the one-lane template elsewhere.
inline bool is_packed(int nb, int Z, int E, int star_deg, int early_term) {
  return star_deg == 0 && !early_term && packed_shape(nb, Z, E).lanes > 0;
}

}  // namespace

extern "C" {

// The launch shape of one instance for one code: lanes per block, dynamic
// shared-memory bytes, codeword lanes a thread, and the blocks an SM keeps
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers
// included). The fixed min-sum instance (star_deg 0, early_term 0) is the
// packed kernel where a block of four lanes fits, and max_row_deg (the
// largest base-row degree) picks its row instance. Returns
// cudaErrorInvalidConfiguration, lanes 0, when no block shape fits.
int minsum_flood_config(int nb, int Z, int mb, int E, int star_deg,
                        int early_term, int mc, int max_row_deg, int* lanes,
                        int* smem, int* lanes_per_thread,
                        int* blocks_per_sm) {
  *blocks_per_sm = 0;
  if (is_packed(nb, Z, E, star_deg, early_term)) {
    const PackedShape s = packed_shape(nb, Z, E);
    *lanes = s.lanes;
    *smem = s.smem;
    *lanes_per_thread = kLanesPerThread;
    const PackedKernel k = packed_kernel(max_row_deg, mc != 0);
    const cudaError_t err = prepare(k, s.smem);
    if (err != cudaSuccess) return int(err);
    return ldpc::occupancy(k, s.lanes / kLanesPerThread * Z, s.smem,
                           blocks_per_sm);
  }
  *lanes_per_thread = 1;
  const int cfg = ldpc::decoder_config(
      Z, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); }, lanes,
      smem);
  if (cfg) return cfg;
  return ldpc::occupancy(kOneLane[star_deg > 0][mc != 0][early_term != 0],
                         *lanes * Z, *smem, blocks_per_sm);
}

const char* minsum_flood_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers but `mc`, `thr` and `ptab` are device pointers; chan/info/hard/
// bits/frame may be null. With `mc` (host memory) not null it runs the
// Monte-Carlo megakernel (K1-MC): the channel comes from the seed (key0,
// key1) or the injected words, and chan/info are not read. star_deg > 0 (the
// largest base-row degree) selects the min* update with the nthr thresholds
// at `thr` (host memory; beta and alpha are then not read). The fixed
// min-sum instance, where a block of four lanes fits, takes its entry
// tables from `ptab` (host memory, ptab_words uint32 words, packed_tables'
// layout) into its parameters; tables above kTabWords words, or qmax above
// 127, are refused.
int minsum_flood_launch(const void* chan, int chan_is_f32, float scale,
                        const void* info, int kb, void* hard, void* bits,
                        void* frame, void* iters, void* conv,
                        const void* tables, int B, int nb, int Z, int mb,
                        int E, int max_iter, int early_term, int qmax,
                        int beta, int alpha_num, int alpha_shift,
                        int star_deg, const int* thr, int nthr,
                        const ldpc::Mc* mc, const uint32_t* ptab,
                        int ptab_words, void* stream) {
  const Params p = ldpc::make_params(
      chan, chan_is_f32, scale, info, kb, hard, bits, frame, iters, conv,
      tables, B, nb, Z, mb, E, max_iter, qmax, beta, alpha_num, alpha_shift,
      star_deg, thr, nthr);
  if (!is_packed(nb, Z, E, star_deg, early_term))
    return ldpc::launch_instance(
        kOneLane, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); },
        p, early_term, mc, stream);
  if (!ptab || ptab_words != mb + nb + 2 + 2 * E || ptab_words > kTabWords ||
      qmax > 127 || Z > 2047 || size_t(E) * Z >= (size_t(1) << 21))
    return int(cudaErrorInvalidValue);
  const PackedShape s = packed_shape(nb, Z, E);
  static thread_local PackedArgs a;   // 32 KB, off the stack; copied at launch
  static_assert(sizeof(a.t) == 4 * kTabWords, "table words");
  a.p = p;
  a.p.lanes = s.lanes;
  if (mc) a.p.mc = *mc;
  memcpy(a.t.w, ptab, 4 * size_t(ptab_words));
  const PackedKernel k = packed_kernel(packed_max_degree(ptab, mb),
                                       mc != nullptr);
  const cudaError_t err = prepare(k, s.smem);
  if (err != cudaSuccess) return int(err);
  if (B <= 0) return 0;
  const dim3 block(s.lanes / kLanesPerThread, Z);
  const dim3 grid((B + s.lanes - 1) / s.lanes);
  k<<<grid, block, s.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
