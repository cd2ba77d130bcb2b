// The packed datapath shared by the packed decoder kernels of both
// schedules (minsum_flood.cu: flood_packed_kernel, K1/K1-IO, K2, K5 flooding
// and the flooding K1-MC; minsum_layered.cu: layered_packed_kernel, K3, K5
// layered and the layered K1-MC): a thread owns LPT codeword lanes of one
// check row (LPT = 4 wherever a block of four lanes fits; else LPT = 2, the
// two-lane instances flood_two_lane_kernel and layered_two_lane_kernel for
// codes whose state is 70-115 KB a lane, such as NR BG1 Z=384 and DVB-S2
// n=16,200), the state keeps the lane index innermost, so the lanes' int8
// messages are one word and their int16 totals or posteriors one or two
// words of 16x2 pairs, and the entry tables travel in the kernel's
// parameter space.
//
// What is here: the parameter block (PackedArgs: the launch parameters and
// up to kTabWords uint32 table words), the block-shape rule (packed_shape),
// the word helpers (prmt, widen, bytes_of, ld8/st8, ld16/st16), the fused-IO
// channel load of LPT lanes, the min-sum family's check row on 16x2 pairs
// (PackedRow, PackedEmit: CnRow of cn_minsum.cuh two lanes an instruction,
// messages stored negated), the min* combine on packed lanes (star_bp2:
// star_bp2 of cn_minstar.cuh), the Monte-Carlo prologue of LPT lanes at once
// (mc_prologue_lanes: mc_prologue of mc_stage.cuh) and the end of a decode
// (packed_outputs, packed_finish: hard bits or info-bit errors, the
// syndrome, the per-lane outputs). One copy, so the two schedules cannot drift apart.
#pragma once

#include <string.h>

#include <algorithm>

#include "cn_minsum.cuh"
#include "mc_stage.cuh"

namespace ldpc {

constexpr int kTabWords = 8000;       // uint32 words of tables in the parameters
constexpr int kSmSmem = 233472;       // shared memory an SM gives its blocks
constexpr int kBlockReserve = 1024;   // the runtime's share per resident block
constexpr int kSmWarps = 64;
constexpr int kSmBlocks = 32;
constexpr int kLanesPerThread = 4;   // the packed instances, where a block fits
constexpr int kTwoLanes = 2;         // ... else the two-lane instances
// The two-lane instances' launch bound: one block of Z <= 384 check rows (NR
// BG1's largest lifting size) a thread each; at least one block an SM, so
// ptxas may give a thread up to 65,536 / 384 = 170 registers.
constexpr int kTwoLaneThreads = 384;
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
  uint32_t star[2 * kMaxThresholds];   // min*'s threshold constants
  // The two-lane flooding instances' quantized channel in device memory,
  // int8 [block][n][lanes] (their shared memory holds the totals and the
  // messages only); null elsewhere.
  int8_t* chan_q;
  PackedTab t;
};
static_assert(sizeof(PackedArgs) <= 32764, "kernel parameters above 32,764 B");

using PackedKernel = void (*)(PackedArgs);

struct PackedShape {
  int lanes, smem, blocks;   // blocks: resident an SM by this rule
  int lpt;                   // lanes a thread
};

// Lanes per block at lpt lanes a thread: of the block shapes (lanes a
// multiple of lpt, lanes / lpt * Z <= max_threads, state smem_of(lanes)
// within the opt-in) the fewest lanes that keep at least 9/10 of the most
// codewords an SM holds (its shared memory with the runtime's reserve per
// block, warps, blocks). Small blocks fill the last wave of a batch finely
// and wait at barriers that span few warps. lanes 0 when no block fits.
template <typename SmemFn>
inline PackedShape packed_shape(int Z, int max_threads, SmemFn smem_of,
                                int lpt = kLanesPerThread) {
  PackedShape shapes[kMaxThreads];
  int count = 0, most = 0;
  for (int k = 1; k * Z <= max_threads; ++k) {
    const int lanes = k * lpt;
    const size_t smem = smem_of(lanes);
    if (smem > size_t(kMaxSmem)) break;
    const int warps = (k * Z + 31) / 32;
    const int blocks = std::min({kSmSmem / int(smem + kBlockReserve),
                                 kSmWarps / warps, kSmBlocks});
    shapes[count++] = PackedShape{lanes, int(smem), blocks, lpt};
    most = std::max(most, blocks * lanes);
  }
  for (int i = 0; i < count; ++i)
    if (10 * shapes[i].blocks * shapes[i].lanes >= 9 * most) return shapes[i];
  return PackedShape{0, 0, 0, 0};
}

// The DMAX instance for a largest base-row degree (3: the two-pass row).
inline int row_instance(int max_deg) {
  for (int i = 0; i < 3; ++i)
    if (max_deg <= kRowDegrees[i]) return i;
  return 3;
}

inline int packed_max_degree(const uint32_t* tab, int mb) {
  int d = 0;
  for (int i = 0; i < mb; ++i) d = std::max(d, int(tab[i + 1] - tab[i]));
  return d;
}

// Whether `ptab` (ptab_words words) is a packed_tables layout that the
// parameters hold, for a code whose indices fit the entry words, at a
// qmax whose messages fit a byte; the launch refuses anything else.
inline bool packed_args_ok(const uint32_t* ptab, int ptab_words, int nb,
                           int Z, int mb, int E, int qmax, int nthr) {
  return ptab && ptab_words == mb + nb + 2 + 2 * E && ptab_words <= kTabWords
      && qmax <= 127 && Z <= 2047 && size_t(E) * Z < (size_t(1) << 21)
      && nthr >= 0 && nthr <= kMaxThresholds;
}

// Sets the instance's shared-memory attributes (the most dynamic shared
// memory it launches with, the largest carveout) before a launch or an
// occupancy query; an instance that is not built (null: the megakernel at
// two lanes a thread) is refused with cudaErrorNotSupported.
template <typename K>
cudaError_t prepare(K kern, int smem) {
  if (!kern) return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// ---------------------------------------------------------------------------
// Words of lanes.

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

__device__ __forceinline__ int lane16(uint32_t lo, uint32_t hi, int k) {
  const uint32_t w = k < 2 ? lo : hi;
  return (k & 1) ? int(w) >> 16 : int(int16_t(uint16_t(w)));
}

template <int LPT, typename T>
__device__ __forceinline__ bool aligned_for(const T* a) {
  return (reinterpret_cast<uintptr_t>(a) & (sizeof(T) * LPT - 1)) == 0;
}

// The int8 lanes of a word of 16x2 pairs (values in [-128, 127]): the low
// byte of each half of lo (lanes 0, 1) and hi (lanes 2, 3); with 0x7531,
// the high bytes (each lane's sign in bit 7).
__device__ __forceinline__ uint32_t bytes_of(uint32_t lo, uint32_t hi,
                                             uint32_t sel = 0x6420) {
  return prmt(lo, hi, sel);
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
      w |= uint32_t(uint8_t(quant32(x[k], p.scale, p.qmax))) << (8 * k);
    return w;
  }
  const int8_t* c = static_cast<const int8_t*>(p.chan) + g;
  if (nvalid == LPT && aligned_for<LPT>(c)) return ld8<LPT>(c);
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    if (k < nvalid) w |= uint32_t(uint8_t(c[k])) << (8 * k);
  return w;
}

// Stores the int8 lanes of w at a: as they are (int8 state), or widened to
// 16x2 pairs (int16 state).
template <int LPT>
__device__ __forceinline__ void put_lanes(int8_t* a, uint32_t w) {
  st8<LPT>(a, w);
}

template <int LPT>
__device__ __forceinline__ void put_lanes(int16_t* a, uint32_t w) {
  st16<LPT>(a, widen_lo(w), widen_hi(w));
}

// ---------------------------------------------------------------------------
// The min-sum family's check row.

// One check row's min-sum state for the thread's lanes as NP = LPT / 2
// pairs of 16-bit lanes: CnRow of cn_minsum.cuh, two lanes an instruction.
// The messages are stored negated (n = -c2v), so raw = tot - c2v is one add.
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
  // from its totals t (16x2 pairs) and negated old message word n; raw
  // (16x2 pairs, unclipped) is left in `raw`. With ADD the row takes them
  // in. A padded entry (!real) leaves min1, min2 and the sign product as
  // they were: its magnitude 127 is >= every min2 of a row of degree >= 2,
  // and its sign is not taken.
  template <bool ADD>
  __device__ __forceinline__ uint32_t entry(const uint32_t (&t)[2], uint32_t n,
                                            uint32_t q2, bool real,
                                            uint32_t (&raw)[2]) {
    uint32_t m[2] = {0u, 0u};
    raw[0] = raw[1] = 0u;
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

  template <bool ADD>
  __device__ __forceinline__ uint32_t entry(const uint32_t (&t)[2], uint32_t n,
                                            uint32_t q2, bool real = true) {
    uint32_t raw[2];
    return entry<ADD>(t, n, q2, real, raw);
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
  // bit 7, and no byte carries; prmt's sign mode replicates bit 7 over its
  // byte); the stored message is the negated one, so the magnitude (<= 127)
  // is negated per byte, as (0x80 - m) ^ 0x80, where sign(raw) ^ sign
  // product is clear.
  __device__ __forceinline__ uint32_t emit(uint32_t w) const {
    uint32_t msg, nv;
    emit(w, msg, nv);
    return msg;
  }

  // ... and the new message bytes themselves (not negated) in nv.
  __device__ __forceinline__ void emit(uint32_t w, uint32_t& msg,
                                       uint32_t& nv) const {
    const uint32_t x = (w & 0x7f7f7f7fu) ^ m1;
    const uint32_t ne = prmt(x + 0x7f7f7f7fu, 0, 0xBA98);
    const uint32_t mag = (o1 & ne) | (o2 & ~ne);
    const uint32_t sm = prmt(w ^ ns, 0, 0xBA98);
    const uint32_t negm = (0x80808080u - mag) ^ 0x80808080u;
    msg = (mag & sm) | (negm & ~sm);
    nv = (negm & sm) | (mag & ~sm);
  }
};

// ---------------------------------------------------------------------------
// The min* combine (cn_minstar.cuh) on packed lanes.

// A min* value of the thread's lanes: magnitudes (<= qmax) as 16x2 pairs
// (m[0]: lanes 0, 1; m[1]: lanes 2, 3) and the signs in bit 7 of each byte
// of s (its other bits are not read). A magnitude of 0 may carry either
// sign: a combine with a 0 input has magnitude 0 (min 0, and corr(|y|) -
// corr(|y|)), so that sign reaches no nonzero value, and a 0 message is 0
// whatever its sign.
struct StarVal {
  uint32_t m[2], s;
};

// leaf(raw) = sign(raw) * min(|raw|, qmax), raw as 16x2 pairs.
template <int LPT>
__device__ __forceinline__ StarVal star_leaf(const uint32_t (&raw)[2],
                                             uint32_t q2) {
  StarVal v{{0u, 0u}, bytes_of(raw[0], raw[1], 0x7531)};
#pragma unroll
  for (int k = 0; k < LPT / 2; ++k)
    v.m[k] = __vmins2(__vmaxs2(raw[k], __vadd2(~raw[k], 0x00010001u)), q2);
  return v;
}

// A value from its bytes, min(|v|, 127) | sign << 7 a lane, and back.
__device__ __forceinline__ StarVal star_unpack(uint32_t w) {
  const uint32_t mb = w & 0x7f7f7f7fu;
  return StarVal{{prmt(mb, 0, 0x4140), prmt(mb, 0, 0x4342)}, w};
}

__device__ __forceinline__ uint32_t star_pack(const StarVal& v) {
  return bytes_of(v.m[0], v.m[1]) | (v.s & 0x80808080u);
}

// star_bp2 of the thread's lanes: sign(x) ^ sign(y), and the magnitude
// min(|x|, |y|) + corr(|x| + |y|) - corr(||x| - |y||) clipped to [0, qmax],
// where corr(u) = #{i : u <= thr[i]}, so the correction is minus the count
// of thresholds T with d <= T < s (d = ||x| - |y||, s = |x| + |y|): each
// [T < s] = relu(min(s - T, 1)) and [d <= T] = relu(min(T + 1 - d, 1)) is
// one add-min-relu (DPX) on two lanes. tc holds the thresholds as 16x2
// pairs, -T then T + 2 a threshold (star_constants); with tc in the
// kernel's parameters and the thresholds unrolled, each is a constant-bank
// operand.
template <int LPT>
__device__ __forceinline__ StarVal star_bp2(
    const StarVal& x, const StarVal& y,
    const uint32_t (&tc)[2 * kMaxThresholds], int nthr, uint32_t q2) {
  constexpr int NP = LPT / 2;
  StarVal r{{0u, 0u}, x.s ^ y.s};
  uint32_t mn[NP], s[NP], e[NP], acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    mn[k] = __vmins2(x.m[k], y.m[k]);
    r.m[k] = mn[k];
  }
  if (nthr) {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      s[k] = __vadd2(x.m[k], y.m[k]);
      e[k] = __vadd2(mn[k], ~__vmaxs2(x.m[k], y.m[k]));   // -d - 1
      acc[k] = 0u;
    }
#pragma unroll
    for (int i = 0; i < kMaxThresholds; ++i) {
      if (i == nthr) break;
      const uint32_t nt = tc[2 * i], t2 = tc[2 * i + 1];
#pragma unroll
      for (int k = 0; k < NP; ++k)
        acc[k] = __vadd2(acc[k],
                         __vmins2(__viaddmin_s16x2_relu(s[k], nt, 0x00010001u),
                                  __viaddmin_s16x2_relu(e[k], t2, 0x00010001u)));
    }
    // mn - acc = (mn + ~acc) + 1, clipped to [0, qmax]
#pragma unroll
    for (int k = 0; k < NP; ++k)
      r.m[k] = __viaddmin_s16x2_relu(__vadd2(mn[k], ~acc[k]), 0x00010001u, q2);
  }
  return r;
}

// The 16x2 constants of the thresholds for star_bp2: -T, T + 2 each (in
// PackedArgs::star, where the kernel reads them at fixed offsets).
inline void star_constants(const Params& p, uint32_t* tc) {
  for (int i = 0; i < p.nthr; ++i) {
    tc[2 * i] = (uint32_t(-p.thr[i]) & 0xffffu) * 0x00010001u;
    tc[2 * i + 1] = (uint32_t(p.thr[i] + 2) & 0xffffu) * 0x00010001u;
  }
}

// The stored (negated) message bytes and the new message bytes of a value
// whose magnitudes fit a byte: -v = sign ? |v| : -|v| a byte, where -m is
// (0x80 - m) ^ 0x80 (no byte borrows), and the sign is replicated over its
// byte by prmt.
__device__ __forceinline__ void star_bytes(const StarVal& v, uint32_t& msg,
                                           uint32_t& nv) {
  const uint32_t mb = bytes_of(v.m[0], v.m[1]);
  const uint32_t negm = (0x80808080u - mb) ^ 0x80808080u;
  const uint32_t sm = prmt(v.s, 0, 0xBA98);
  msg = (mb & sm) | (negm & ~sm);
  nv = (negm & sm) | (mb & ~sm);
}

// ---------------------------------------------------------------------------
// The Monte-Carlo prologue and the end of a decode.

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
// together, and the lanes' Box-Muller pairs are independent work. The
// quantized LLRs go to out [n][L] (int8 channel or int16 posteriors). Lanes
// past the batch get zero bits and zero LLRs; every thread reaches the
// three barriers.
template <int LPT, typename T>
__device__ void mc_prologue_lanes(const Params& p, const uint32_t* tw,
                                  int8_t* cw, T* out, int nvalid,
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
      if (i < nvalid) w |= uint32_t(mc_info_bit(p, b0 + i, j, row)) << (8 * i);
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
        const float f1 = mc_unit(mc_word(p, b0 + i, k + q * Z + row));
        const float f2 = mc_unit(mc_word(p, b0 + i, k + (nph + q) * Z + row));
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
          w |= uint32_t(uint8_t(mc_quant((c >> (8 * i)) & 1, nrm[i][h],
                                         sigma[i], gain[i], p.qmax)))
               << (8 * i);
      put_lanes<LPT>(out + v * L + lane0, w);
    }
  }
}

// Hard bits or info-bit errors of the thread's lanes whose byte of `mask`
// is set (lanes past the batch never are), from int16 values vals [n][L]
// (sign = hard bit): hard bits to device memory, info-bit errors (MC: each
// info bit drawn again) summed per lane into s_bits. It reads the thread's
// own rows of every base column.
template <int LPT, bool MC>
__device__ void packed_outputs(const Params& p, const int16_t* vals,
                               int32_t* s_bits, int nvalid, long long b0,
                               int row, int lane0, uint32_t mask) {
  const int Z = p.Z, L = p.lanes, nb = p.nb;
  constexpr uint32_t kAll = LPT == 4 ? 0xffffffffu : 0xffffu;
  int nerr[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) nerr[k] = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    uint32_t lo, hi;
    ld16<LPT>(vals + v * L + lane0, lo, hi);
    const uint32_t h = (bytes_of(lo, hi, 0x7531) >> 7) & 0x01010101u;
    const size_t g = size_t(v) * p.B + b0;
    if (p.hard) {
      uint8_t* out = p.hard + g;
      if (mask == kAll && nvalid == LPT && aligned_for<LPT>(out)) {
        st8<LPT>(reinterpret_cast<int8_t*>(out), h);
      } else {
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          if ((mask >> (8 * k)) & 1) out[k] = uint8_t(h >> (8 * k));
      }
    }
    if (j < p.kb && (MC || p.info)) {
      uint32_t ref = 0;
      if constexpr (MC) {
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          if ((mask >> (8 * k)) & 1)
            ref |= uint32_t(mc_info_bit(p, b0 + k, j, row)) << (8 * k);
      } else {
        const int8_t* in = reinterpret_cast<const int8_t*>(p.info + g);
        if (mask == kAll && nvalid == LPT && aligned_for<LPT>(in)) {
          ref = ld8<LPT>(in);
        } else {
#pragma unroll
          for (int k = 0; k < LPT; ++k)
            if ((mask >> (8 * k)) & 1) ref |= uint32_t(uint8_t(in[k])) << (8 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) nerr[k] += ((h ^ ref) >> (8 * k)) & 1;
    }
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    if (((mask >> (8 * k)) & 1) && nerr[k]) atomicAdd(&s_bits[lane0 + k], nerr[k]);
}

// The end of a packed decode for the thread's LPT lanes: packed_outputs of
// the lanes not yet written (ET: those still running, their bytes of `act`
// set; the others wrote theirs when they finished; else every lane of the
// batch) from the final int16 values vals [n][L]; without ET the syndrome
// of the hard bits (the XOR of int16 values carries the parity of their
// signs in bits 15 and 31), which sets the lane's s_flag. After a barrier
// row 0 writes the lanes' iters and conv (ET: iters[k] and whether lane k
// finished, its byte of `act` clear; else max_iter and a zero flag) and the
// counters.
template <int LPT, bool ET, bool MC>
__device__ void packed_finish(const Params& p, const uint32_t* tw,
                              const int16_t* vals, int32_t* s_flag,
                              int32_t* s_bits, int nvalid, long long b0,
                              int row, int lane0, const int (&iters)[LPT],
                              uint32_t act) {
  const int Z = p.Z, L = p.lanes, nb = p.nb, mb = p.mb;
  const int o_ent = mb + nb + 2;
  uint32_t mask = act;
  if constexpr (!ET) {
    mask = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (k < nvalid) mask |= 0xffu << (8 * k);
  }
  if (mask) packed_outputs<LPT, MC>(p, vals, s_bits, nvalid, b0, row, lane0, mask);
  if constexpr (!ET) {
    uint32_t un[2] = {0u, 0u};
    for (int li = 0; li < mb; ++li) {
      uint32_t x[2] = {0u, 0u};
      for (int e = tw[li]; e < int(tw[li + 1]); ++e) {
        const uint32_t en = tw[o_ent + e];
        int c = row + int(en & 0x7ffu);
        if (c >= Z) c -= Z;
        uint32_t t[2];
        ld16<LPT>(vals + (int(en >> 11) + c) * L + lane0, t[0], t[1]);
        x[0] ^= t[0];
        x[1] ^= t[1];
      }
      un[0] |= x[0];
      un[1] |= x[1];
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (lane16(un[0], un[1], k) < 0) atomicOr(&s_flag[lane0 + k], 1);
  }
  __syncthreads();
  if (row == 0) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      if (k >= nvalid) break;
      const long long b = b0 + k;
      p.iters[b] = iters[k];
      p.conv[b] = ET ? ((act >> (8 * k)) & 1) == 0 : s_flag[lane0 + k] == 0;
      if (p.bits) {
        p.bits[b] = s_bits[lane0 + k];
        p.frame[b] = s_bits[lane0 + k] > 0;
      }
    }
  }
}

}  // namespace ldpc
