// Fixed-point min-sum and min* flooding decoder for NVIDIA Hopper (sm_90a).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::make_pallas_decoder.kernel
// (:390, reached from pallas_call :1076) in its flooding forms: fixed
// iterations (flood_first :721, flood_iter :659, _cn_minsum :105,
// syndrome_ok :602; K1) and per-lane early termination (run_et with
// latch_hard; K2), both with the fused-IO stages (quant32 :566 in,
// emit_counts :590 out; K1-IO), and the flooding forms of the Monte-Carlo
// megakernel (the mc branch :432-558, reached from pallas_call :990;
// K1-MC); each with the min* update (K5: _cn_minstar :159 through cn_upd
// :333). Bit-exact with golden.decoder.decode_fixed(schedule="flooding")
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
// flood_packed_kernel: every instance (the min-sum family or min*, fixed or
// early-terminating, fused IO or the megakernel) wherever a block of four
// lanes fits, min* for rows up to 24 entries, one body (flood_packed<LPT,
// DMAX, STAR, ET, MC>) under three launch bounds: flood_packed_kernel<4,
// DMAX, MC> for the fixed min-sum family (K1, K1-IO, K1-MC; up to 1,024
// threads, whose 64 registers these instances fit without spilling),
// flood_packed_kernel<4, DMAX, STAR, ET, MC> for early termination or min*
// (K2, K5 and their K1-MC forms), and flood_two_lane_kernel<DMAX, STAR, ET>
// (every form but the megakernel at LPT = 2) where four lanes of state
// exceed a block's shared memory but two fit. Laid out for this card:
//  * Thread (x, y) owns LPT codeword lanes (LPT x .. LPT x + LPT - 1) of
//    row y of every base row and column. The state keeps the lane index
//    innermost (below), so one LPT-lane word is one shared-memory access
//    and a warp's access covers 32 * LPT bytes of messages (128 for LPT =
//    4) or 64 * LPT of totals. LPT = 4 (kLanesPerThread: four lanes beat
//    one, the parent's layout, on n=648; PERF.md section 6) wherever a
//    block of four lanes fits, else LPT = 2 (kTwoLanes).
//  * The two-lane instances take the codes whose state is 70-115 KB a lane
//    (NR BG1 at Z = 128-384, DVB-S2 n=16,200), which the one-lane template
//    decoded one codeword a block and one a thread's instruction. Their
//    block is two lanes of Z rows (360 or 384 threads: kTwoLaneThreads,
//    the launch bound, at least one block an SM, so up to 170 registers a
//    thread); its shared memory holds the totals and the messages only,
//    and the quantized channel lives in device memory (PackedArgs::chan_q,
//    [block][n][lanes], written once by the channel stage and read by each
//    V phase: n bytes a lane and iteration, 64 contiguous bytes a warp), so
//    NR BG1 Z=384 keeps two lanes in 228,880 of the 232,448 B.
//  * The entry tables are uniform across the block, so they travel in the
//    kernel's parameter space (the constant bank: `PackedTab`, up to
//    kTabWords words, CUDA >= 12.1) instead of shared memory: no table
//    lookup goes through the shared-memory pipe; so do min*'s threshold
//    constants (PackedArgs::star).
//  * The check row is read once. The reduce pass keeps each entry's
//    value in a register as one byte a lane, min(|raw|, qmax) in 7 bits
//    plus the sign of raw (DMAX registers, DMAX >= the largest base-row
//    degree); the emit pass reads nothing and computes CnRow::emit on the
//    four bytes at once (SWAR: exclusion by value, so ties all get min2o).
//    Per edge a thread makes one totals load, one message load and one
//    message store. A code whose rows are longer than the largest DMAX
//    instance takes DMAX = 0, which reads the row twice.
//  * min* (STAR, K5): that row byte is the min* leaf. The suffix pass walks
//    the register row backwards and keeps suf[j] of the four lanes as one
//    byte word a slot (DMAX more registers); the prefix pass walks it
//    forwards and emits out[i] = bp2(pre[i-1], suf[i+1]), the grouping of
//    cn_minstar.cuh (3d - 6 combines in entry order), with bp2 on packed
//    lanes (star_bp2 of cn_packed.cuh). Flooding stores only the message
//    (the V phase rebuilds the totals), so no raw value is kept. Padded
//    slots never enter the row. Rows above 24 entries keep the one-lane
//    template.
//  * The arithmetic runs on 16x2 pairs (__vadd2, __vmins2, __vmaxs2: one
//    instruction each on sm_90), and the messages are stored negated, so a
//    row's raw value tot - c2v is one add.
//  * Lanes per block follow the state (packed_shape): of the shapes whose
//    state fits, the fewest lanes keeping 9/10 of the most codewords an SM
//    holds; for n=648 that is twelve one-warp blocks of 4 lanes an SM. The
//    fixed min-sum instances take up to 1,024 threads a block (64
//    registers); the ET and min* instances are launch-bounded at
//    kFloodEtStarThreads (256) and one block an SM, which leaves ptxas the
//    registers of the row and the suffixes (the layered packed kernel's
//    bound).
// Shared memory, one block of L lanes:
//   s_flag, s_bits int32 [L]       ET's flag stamp or the final syndrome's
//                                   flag, info-bit errors
//   tot   int16 [n][L]              totals chan + sum(c2v); int16 is lossless
//                                   since |tot| <= (dv_max + 1) * qmax, which
//                                   the wrapper checks is < 2^15
//   chan  int8  [n][L]              quantized channel LLRs (four lanes a
//                                   thread; the two-lane instances keep them
//                                   in device memory)
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
// Early termination (ET, K2) with the syndrome fused into the C phase, as
// the reference fuses it into the sweep (cn_sweep(with_synd=True)): the C
// phase of iteration k loads the totals of state k for every entry anyway,
// so it XORs them over each row (bits 15 and 31 of the 16x2 pairs: the
// parity of the lanes' hard bits) and stamps s_flag with k for each running
// lane with an unsatisfied row. `act` holds 0xff in byte q while lane q
// runs. After the C barrier a running lane that no thread stamped is done,
// with iters = k; its hard bits or info-bit errors are written there and
// then from the totals, which still hold state k (packed_outputs reads only
// the thread's own rows, which only its own next V phase overwrites:
// latch_hard's effect). It goes on through the loop with the other lanes of
// its word, but nothing reads its state again. State 0 is checked by the C
// phase of iteration 0 (a noiseless lane: iters 0); state max_iter gets one
// closing syndrome pass, as the reference's final pass. A thread whose four
// lanes are done skips both phases, and the block leaves the loop once no
// lane runs (__syncthreads_or at the V phase's barrier gives every thread
// the same answer): one XOR pair an entry, and no barrier beyond the fixed
// form's two an iteration.
//
// minsum_flood_kernel<ET, MC, STAR>: the earlier one-lane-a-thread layout,
// kept for codes that admit no block of two lanes (NR BG1 Z=384 rate 1/3,
// about 174 KB a lane) and for min* on rows above 24 entries; the tables
// sit in shared memory there. Thread (x, y) = (codeword lane, row y). The row is read
// twice (once to reduce, once to emit); with min* the two reads are the
// suffix pass into an int8 scratch of star_deg slots per row and the prefix
// pass that emits. Early termination there: after the V phase of iteration
// k the totals are state k; every thread of a lane that is not done checks
// its check rows and marks the lane's flag with k when one is unsatisfied,
// and after a barrier a lane whose flag is not k is done, with iters = k. A
// done lane skips both phases from then on, which freezes its totals at its
// first success. The block leaves the loop once no lane is active.
//
// Monte-Carlo megakernel (template MC, K1-MC; mc_stage.cuh): the channel
// comes from the in-kernel prologue (Philox or injected words -> info bits
// -> structured encode -> BPSK/AWGN/demap/quantize) instead of device
// memory, the codeword bits borrow the c2v buffer, and the error count draws
// each info bit again. The packed kernel runs the prologue on its LPT lanes
// at once (mc_prologue_lanes: the codeword bits of LPT lanes are one word,
// so the encode's XORs take them together), from the parameter-space
// tables.
//
// The packed parts (the parameter block, the shape rule, the word helpers,
// PackedRow and PackedEmit, star_bp2, mc_prologue_lanes, packed_outputs,
// packed_finish) live in cn_packed.cuh, which the layered library's packed
// kernel shares.
//
// Three units: build.py compiles this file three times at once, with
// LDPC_UNIT=1 (the C entries, the one-lane template and the four-lane
// instances of rows up to 16 entries), LDPC_UNIT=2 (the two-lane instances,
// through flood_two_lane) and LDPC_UNIT=3 (the four-lane instances of longer
// rows, through flood_four_lane_long), and links them into one library, so
// that its instances build side by side; without LDPC_UNIT the file is one
// unit of all.

#include "cn_minsum.cuh"
#include "cn_minstar.cuh"
#include "cn_packed.cuh"
#include "mc_stage.cuh"

namespace ldpc {
// The two-lane instance for a code (unit 2, below).
PackedKernel flood_two_lane(int max_deg, bool star, bool et, bool mc);
// The four-lane instance for rows above 16 entries (unit 3, below).
PackedKernel flood_four_lane_long(int max_deg, bool star, bool et, bool mc);
}  // namespace ldpc

namespace {

using namespace ldpc;

// ---------------------------------------------------------------------------
// The packed instances.

// The ET and min* instances' launch bound: up to 256 threads a block, at
// least one block an SM, so ptxas may give a thread up to 255 registers for
// the register row, the min* suffixes and the early-termination state. The
// fixed min-sum instances keep 1,024 threads (kMaxThreads: 64 registers).
constexpr int kFloodEtStarThreads = 256;

inline int flood_max_threads(int star_deg, int early_term) {
  return star_deg > 0 || early_term ? kFloodEtStarThreads : kMaxThreads;
}

// The state of a block of `lanes` at lpt lanes a thread: the channel in
// shared memory at four lanes a thread only.
inline size_t packed_smem(int nb, int Z, int E, int lanes, int lpt) {
  const size_t n = size_t(nb) * Z;
  return align16(8 * size_t(lanes)) + align16(2 * n * lanes)
       + (lpt == kTwoLanes ? 0 : align16(n * lanes))
       + align16(size_t(E) * Z * lanes);
}

// packed_shape of cn_packed.cuh for this kernel's state: four lanes a
// thread up to the instance's threads a block where a block fits, else two
// lanes a thread up to kTwoLaneThreads.
inline PackedShape flood_shape(int nb, int Z, int E, int star_deg,
                               int early_term) {
  const PackedShape s = packed_shape(
      Z, flood_max_threads(star_deg, early_term),
      [=](int l) { return packed_smem(nb, Z, E, l, kLanesPerThread); });
  if (s.lanes) return s;
  return packed_shape(
      Z, kTwoLaneThreads,
      [=](int l) { return packed_smem(nb, Z, E, l, kTwoLanes); }, kTwoLanes);
}

// The body of every packed instance; `a` is the kernel's parameter block.
template <int LPT, int DMAX, bool STAR, bool ET, bool MC>
__device__ __forceinline__ void flood_packed(const PackedArgs& a) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  static_assert(DMAX > 0 || !STAR, "min* keeps its row in registers");
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = a.p;
  const uint32_t* tw = a.t.w;
  const int L = p.lanes, Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const int n = nb * Z, ZL = Z * L;
  const int o_col = mb + 1, o_ent = mb + nb + 2, o_cent = o_ent + E;
  const uint32_t (&tc)[2 * kMaxThresholds] = a.star;   // min* constants
  const uint32_t q2 = uint32_t(p.qmax) * 0x00010001u;

  int32_t* s_flag = reinterpret_cast<int32_t*>(smem);
  int32_t* s_bits = s_flag + L;
  unsigned char* cursor = smem + align16(8 * size_t(L));
  int16_t* tot = reinterpret_cast<int16_t*>(cursor);
  cursor += align16(2 * size_t(n) * L);
  // the channel: shared memory at four lanes a thread, the block's slice of
  // chan_q in device memory at two
  int8_t* chan;
  if constexpr (LPT == kTwoLanes) {
    chan = a.chan_q + size_t(blockIdx.x) * n * L;
  } else {
    chan = reinterpret_cast<int8_t*>(cursor);
    cursor += align16(size_t(n) * L);
  }
  int8_t* c2v = reinterpret_cast<int8_t*>(cursor);   // negated messages

  const int row = threadIdx.y;
  const int lane0 = threadIdx.x * LPT;
  const int tid = row * blockDim.x + threadIdx.x;
  const long long b0 = (long long)blockIdx.x * L + lane0;
  const int nvalid = int(min((long long)LPT, max(p.B - b0, 0LL)));
  int16_t* const tot_l = tot + lane0;
  int8_t* const msg_row = c2v + row * L + lane0;   // + e * Z * L: entry e

  for (int i = tid; i < L; i += blockDim.x * blockDim.y) {
    s_flag[i] = ET ? -1 : 0;
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

  // ET: byte q of act is 0xff while lane q runs (lanes past the batch never
  // do); iters[q], the iterations lane q ran (the fixed form sets them
  // after the loop).
  uint32_t act = 0;
  int iters[LPT];
  if constexpr (ET) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      iters[k] = p.max_iter;
      if (k < nvalid) act |= 0xffu << (8 * k);
    }
  }

  // State k: `un` holds, in bit 7 of byte q, whether one of this thread's
  // check rows is unsatisfied for lane q; each running such lane gets its
  // flag stamped with k (every writer stores the same value). After the
  // barrier a running lane that no thread stamped is done, with iters = k,
  // and its outputs are written from the totals of state k.
  auto stamp = [&](uint32_t un, int k) {
    un &= act & 0x80808080u;
#pragma unroll
    for (int q = 0; q < LPT; ++q)
      if ((un >> (8 * q + 7)) & 1) s_flag[lane0 + q] = k;
  };
  auto decide = [&](int k) {
    uint32_t fin = 0;
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      if ((act >> (8 * q)) & 1) {
        iters[q] = k;
        if (s_flag[lane0 + q] != k) fin |= 0xffu << (8 * q);
      }
    }
    if (fin) {
      act &= ~fin;
      packed_outputs<LPT, MC>(p, tot, s_bits, nvalid, b0, row, lane0, fin);
    }
  };

  for (int it = 0;; ++it) {
    // V phase: totals of the current messages (state `it`), chan - the sum
    // of the negated messages; c2v = 0 at 0. The channel word is loaded
    // first and used last, so its latency (device memory at two lanes a
    // thread) runs under the message loads.
    if (!ET || act) {
      for (int j = 0; j < nb; ++j) {
        const int v = j * Z + row;
        const uint32_t ch = ld8<LPT>(chan + v * L + lane0);
        uint32_t s_lo = 0, s_hi = 0;
        if (it) {
          const int q1 = tw[o_col + j + 1];
          for (int q = tw[o_col + j]; q < q1; ++q) {
            const uint32_t ce = tw[o_cent + q];   // eZ << 11 | shift
            int r = row - int(ce & 0x7ffu);
            if (r < 0) r += Z;
            const uint32_t m = ld8<LPT>(c2v + (int(ce >> 11) + r) * L + lane0);
            s_lo = __vadd2(s_lo, widen_lo(m));
            if constexpr (LPT == 4) s_hi = __vadd2(s_hi, widen_hi(m));
          }
        }
        st16<LPT>(tot + v * L + lane0, __vadd2(widen_lo(ch), __vneg2(s_lo)),
                  LPT == 4 ? __vadd2(widen_hi(ch), __vneg2(s_hi)) : 0u);
      }
    }
    if constexpr (ET) {
      if (!__syncthreads_or(act != 0)) break;
    } else {
      __syncthreads();
    }
    if (it == p.max_iter) {
      if constexpr (ET) {
        // The closing syndrome pass of state max_iter; it stops once every
        // running lane has an unsatisfied row.
        const uint32_t need = act & 0x80808080u;
        uint32_t un = 0;
        for (int li = 0; li < mb && (un & need) != need; ++li) {
          uint32_t x[2] = {0u, 0u};
          for (int e = tw[li]; e < int(tw[li + 1]); ++e) {
            uint32_t t[2];
            tot_of(tw[o_ent + e], t);
            x[0] ^= t[0];
            x[1] ^= t[1];
          }
          un |= bytes_of(x[0], x[1], 0x7531);
        }
        stamp(un, it);
        __syncthreads();
        decide(it);
      }
      break;
    }

    // C phase: check row `row` of every base row; with ET the parity of
    // each row's state-`it` hard bits on the way.
    uint32_t un = 0;
    if (!ET || act) {
      for (int li = 0; li < mb; ++li) {
        const int e0 = tw[li], d = int(tw[li + 1]) - e0;
        int8_t* const m0 = msg_row + e0 * ZL;
        uint32_t x[2] = {0u, 0u};   // ET: the XOR of the row's totals
        PackedRow<LPT> cn;
        if constexpr (DMAX > 0) {
          // the row in registers; entries past d repeat the last one's
          // loads and are left out of the reduction and the stores (the ET,
          // min* and two-lane instances skip a group of four slots past d:
          // one uniform branch, which pays where rows differ in degree, as
          // NR BG1's 5-7 and 21-22)
          uint32_t rb[DMAX];   // row bytes: min-sum's, or min*'s leaves
#pragma unroll
          for (int i = 0; i < DMAX; ++i) {
            if constexpr (STAR || ET || LPT == kTwoLanes) {
              if ((i & ~3) >= d) break;
            }
            const int ei = min(i, d - 1);
            uint32_t t[2];
            tot_of(tw[o_ent + e0 + ei], t);
            const uint32_t nw = it ? ld8<LPT>(m0 + ei * ZL) : 0u;
            rb[i] = cn.template entry<!STAR>(t, nw, q2, i < d);
            if constexpr (ET) {
              if (i < d) {
                x[0] ^= t[0];
                x[1] ^= t[1];
              }
            }
          }
          if constexpr (STAR) {
            const int nthr = p.nthr;
            // suf[d - 1] = leaf[d - 1], suf[j] = bp2(leaf[j], suf[j + 1])
            // for j = d - 2 .. 1, as bytes
            uint32_t sf[DMAX];
            StarVal acc{};
#pragma unroll
            for (int j = DMAX - 1; j >= 1; --j) {
              if (j < d) {
                const StarVal lf = star_unpack(rb[j]);
                acc = j == d - 1 ? lf : star_bp2<LPT>(lf, acc, tc, nthr, q2);
                sf[j] = star_pack(acc);
              }
            }
            // out[0] = suf[1], out[i] = bp2(pre[i - 1], suf[i + 1]),
            // out[d - 1] = pre[d - 2]; pre[0] = leaf[0], pre[i] =
            // bp2(pre[i - 1], leaf[i])
            StarVal pre{};
#pragma unroll
            for (int i = 0; i < DMAX; ++i) {
              if (i < d) {
                StarVal out;
                if (i == 0) out = star_unpack(sf[1]);
                else if (i == d - 1) out = pre;
                else out = star_bp2<LPT>(pre, star_unpack(sf[min(i + 1, DMAX - 1)]),
                                         tc, nthr, q2);
                if (i < d - 1)
                  pre = i == 0 ? star_unpack(rb[0])
                               : star_bp2<LPT>(pre, star_unpack(rb[i]), tc, nthr, q2);
                uint32_t msg, nv;
                star_bytes(out, msg, nv);
                st8<LPT>(m0 + i * ZL, msg);
              }
            }
          } else {
            const PackedEmit em(cn, p);
#pragma unroll
            for (int i = 0; i < DMAX; ++i)
              if (i < d) st8<LPT>(m0 + i * ZL, em.emit(rb[i]));
          }
        } else {
          // rows longer than every register instance: read twice
          for (int i = 0; i < d; ++i) {
            uint32_t t[2];
            tot_of(tw[o_ent + e0 + i], t);
            cn.template entry<true>(t, it ? ld8<LPT>(m0 + i * ZL) : 0u, q2);
            if constexpr (ET) {
              x[0] ^= t[0];
              x[1] ^= t[1];
            }
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
        if constexpr (ET) un |= bytes_of(x[0], x[1], 0x7531);
      }
    }
    if constexpr (ET) stamp(un, it);
    __syncthreads();
    if constexpr (ET) decide(it);
  }

  // Outputs of the lanes not yet written (fixed: every lane of the batch),
  // from the final totals; the fixed form also takes the syndrome here.
  if constexpr (!ET) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) iters[k] = p.max_iter;
  }
  packed_finish<LPT, ET, MC>(p, tw, tot, s_flag, s_bits, nvalid, b0, row,
                             lane0, iters, act);
}

// The fixed min-sum family (K1, K1-IO, K1-MC flooding), up to 1,024
// threads a block.
template <int LPT, int DMAX, bool MC>
__global__ void __launch_bounds__(kMaxThreads)
flood_packed_kernel(const __grid_constant__ PackedArgs a) {
  flood_packed<LPT, DMAX, false, false, MC>(a);
}

// Early termination or min* (K2, K5 flooding, their K1-MC forms), up to
// kFloodEtStarThreads threads a block and at least one block an SM.
template <int LPT, int DMAX, bool STAR, bool ET, bool MC>
__global__ void __launch_bounds__(kFloodEtStarThreads, 1)
flood_packed_kernel(const __grid_constant__ PackedArgs a) {
  static_assert(STAR || ET, "the fixed min-sum family takes <LPT, DMAX, MC>");
  flood_packed<LPT, DMAX, STAR, ET, MC>(a);
}

// Every form but the megakernel at two lanes a thread, up to
// kTwoLaneThreads threads a block and at least one block an SM. (No step
// reaches a two-lane megakernel: the codes that need two lanes have n above
// 4,096, which takes the batch-first chain.)
template <int DMAX, bool STAR, bool ET>
__global__ void __launch_bounds__(kTwoLaneThreads, 1)
flood_two_lane_kernel(const __grid_constant__ PackedArgs a) {
  flood_packed<kTwoLanes, DMAX, STAR, ET, false>(a);
}

// (Each specialization is named in an assignment: the template name is
// overloaded, and a conditional expression gives no target type.)
template <int DMAX, bool STAR>
PackedKernel packed_instance(bool et, bool mc) {
  constexpr int P = kLanesPerThread;
  PackedKernel k;
  if (et) {
    if (mc) k = flood_packed_kernel<P, DMAX, STAR, true, true>;
    else k = flood_packed_kernel<P, DMAX, STAR, true, false>;
  } else if constexpr (STAR) {
    if (mc) k = flood_packed_kernel<P, DMAX, true, false, true>;
    else k = flood_packed_kernel<P, DMAX, true, false, false>;
  } else {
    if (mc) k = flood_packed_kernel<P, DMAX, true>;
    else k = flood_packed_kernel<P, DMAX, false>;
  }
  return k;
}

// Null for the megakernel, which is not built at two lanes a thread.
template <int DMAX, bool STAR>
PackedKernel two_lane_instance(bool et, bool mc) {
  if (mc) return nullptr;
  return et ? flood_two_lane_kernel<DMAX, STAR, true>
            : flood_two_lane_kernel<DMAX, STAR, false>;
}

}  // namespace

#if !defined(LDPC_UNIT) || LDPC_UNIT == 2
// The two-lane instance for the largest base-row degree (DMAX 8, 16, 24,
// else the row read twice; min* only up to 24), the update and ET; null
// for the megakernel.
PackedKernel ldpc::flood_two_lane(int max_deg, bool star, bool et, bool mc) {
  switch (row_instance(max_deg)) {
    case 0:
      return star ? two_lane_instance<8, true>(et, mc)
                  : two_lane_instance<8, false>(et, mc);
    case 1:
      return star ? two_lane_instance<16, true>(et, mc)
                  : two_lane_instance<16, false>(et, mc);
    case 2:
      return star ? two_lane_instance<24, true>(et, mc)
                  : two_lane_instance<24, false>(et, mc);
    default:
      return two_lane_instance<0, false>(et, mc);
  }
}
#endif

#if !defined(LDPC_UNIT) || LDPC_UNIT == 3
// The four-lane instance for rows above 16 entries: DMAX 24, else the row
// read twice (min* only up to 24).
PackedKernel ldpc::flood_four_lane_long(int max_deg, bool star, bool et,
                                        bool mc) {
  if (row_instance(max_deg) == 2)
    return star ? packed_instance<24, true>(et, mc)
                : packed_instance<24, false>(et, mc);
  return packed_instance<0, false>(et, mc);
}
#endif

#if !defined(LDPC_UNIT) || LDPC_UNIT == 1
namespace {

// The instance at lpt lanes a thread for the largest base-row degree (DMAX
// 8, 16, 24, else the row read twice; min* only up to 24), the update, ET
// and MC.
inline PackedKernel packed_kernel(int lpt, int max_deg, bool star, bool et,
                                  bool mc) {
  if (lpt == kTwoLanes) return flood_two_lane(max_deg, star, et, mc);
  switch (row_instance(max_deg)) {
    case 0:
      return star ? packed_instance<8, true>(et, mc)
                  : packed_instance<8, false>(et, mc);
    case 1:
      return star ? packed_instance<16, true>(et, mc)
                  : packed_instance<16, false>(et, mc);
    default:
      return flood_four_lane_long(max_deg, star, et, mc);
  }
}

// ---------------------------------------------------------------------------
// The one-lane-a-thread template: codes that admit no block of four or two
// lanes, and min* on rows above 24 entries.

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

// kernels[STAR][MC][ET]; they launch only for a code and update that no
// packed instance takes (is_packed).
const ldpc::Kernel kOneLane[2][2][2] = {
    {{minsum_flood_kernel<false, false, false>,
      minsum_flood_kernel<true, false, false>},
     {minsum_flood_kernel<false, true, false>,
      minsum_flood_kernel<true, true, false>}},
    {{minsum_flood_kernel<false, false, true>,
      minsum_flood_kernel<true, false, true>},
     {minsum_flood_kernel<false, true, true>,
      minsum_flood_kernel<true, true, true>}}};

// The packed kernel takes a code wherever a block of four lanes fits (up to
// the instance's threads a block), else two lanes (up to kTwoLaneThreads),
// min* where its rows (star_deg: the largest base-row degree) fit the
// largest register row; the one-lane template takes the rest.
inline bool is_packed(int nb, int Z, int E, int star_deg, int early_term) {
  return flood_shape(nb, Z, E, star_deg, early_term).lanes > 0
      && row_instance(star_deg) < 3;
}

}  // namespace

extern "C" {

// The launch shape of one instance for one code: lanes per block, dynamic
// shared-memory bytes, codeword lanes a thread, and the blocks an SM keeps
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers
// included). Where a block of four or two lanes fits (and for min* its
// rows fit a register row) the instance is the packed kernel at that many
// lanes a thread, and max_row_deg (the largest base-row degree) picks its
// row instance. Returns cudaErrorInvalidConfiguration, lanes 0, when no
// block shape fits.
int minsum_flood_config(int nb, int Z, int mb, int E, int star_deg,
                        int early_term, int mc, int max_row_deg, int* lanes,
                        int* smem, int* lanes_per_thread,
                        int* blocks_per_sm) {
  *blocks_per_sm = 0;
  if (is_packed(nb, Z, E, star_deg, early_term)) {
    const PackedShape s = flood_shape(nb, Z, E, star_deg, early_term);
    *lanes = s.lanes;
    *smem = s.smem;
    *lanes_per_thread = s.lpt;
    const PackedKernel k = packed_kernel(s.lpt, max_row_deg, star_deg > 0,
                                         early_term != 0, mc != 0);
    const cudaError_t err = prepare(k, s.smem);
    if (err != cudaSuccess) return int(err);
    return ldpc::occupancy(k, s.lanes / s.lpt * Z, s.smem, blocks_per_sm);
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
// at `thr` (host memory; beta and alpha are then not read). The packed
// kernel takes its entry tables from `ptab` (host memory, ptab_words uint32
// words, packed_tables' layout) into its parameters, and min*'s threshold
// constants; tables above kTabWords words, or qmax above 127, are
// refused. A two-lane instance keeps its quantized channel in `chan_q`
// (device memory, at least grid * lanes * n bytes: the batch rounded up to
// the block's lanes, times n), which it refuses null; the other instances
// do not read it. The megakernel at two lanes a thread is not built, and is
// refused (cudaErrorNotSupported), here and in minsum_flood_config.
int minsum_flood_launch(const void* chan, int chan_is_f32, float scale,
                        const void* info, int kb, void* hard, void* bits,
                        void* frame, void* iters, void* conv,
                        const void* tables, int B, int nb, int Z, int mb,
                        int E, int max_iter, int early_term, int qmax,
                        int beta, int alpha_num, int alpha_shift,
                        int star_deg, const int* thr, int nthr,
                        const ldpc::Mc* mc, const uint32_t* ptab,
                        int ptab_words, void* chan_q, void* stream) {
  const Params p = ldpc::make_params(
      chan, chan_is_f32, scale, info, kb, hard, bits, frame, iters, conv,
      tables, B, nb, Z, mb, E, max_iter, qmax, beta, alpha_num, alpha_shift,
      star_deg, thr, nthr);
  if (!is_packed(nb, Z, E, star_deg, early_term))
    return ldpc::launch_instance(
        kOneLane, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); },
        p, early_term, mc, stream);
  const PackedShape s = flood_shape(nb, Z, E, star_deg, early_term);
  if (!packed_args_ok(ptab, ptab_words, nb, Z, mb, E, qmax, nthr) ||
      (s.lpt == kTwoLanes && !chan_q))
    return int(cudaErrorInvalidValue);
  static thread_local PackedArgs a;   // 32 KB, off the stack; copied at launch
  static_assert(sizeof(a.t) == 4 * kTabWords, "table words");
  a.p = p;
  a.p.lanes = s.lanes;
  if (mc) a.p.mc = *mc;
  a.chan_q = static_cast<int8_t*>(chan_q);
  memcpy(a.t.w, ptab, 4 * size_t(ptab_words));
  star_constants(p, a.star);
  const PackedKernel k = packed_kernel(s.lpt, packed_max_degree(ptab, mb),
                                       star_deg > 0, early_term != 0,
                                       mc != nullptr);
  const cudaError_t err = prepare(k, s.smem);
  if (err != cudaSuccess) return int(err);
  if (B <= 0) return 0;
  const dim3 block(s.lanes / s.lpt, Z);
  const dim3 grid((B + s.lanes - 1) / s.lanes);
  k<<<grid, block, s.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
#endif
