// Fixed-point min-sum and min* layered decoder for NVIDIA Hopper (sm_90a).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::make_pallas_decoder.kernel in
// its layered forms (K3): fixed iterations (layered_iter :823 over cn_sweep
// :615, then the hard decision and syndrome_ok :602) and per-lane early
// termination (run_et :830 with latch_hard :644 and syndrome_ok, entered
// with the channel state's syndrome), both with the fused-IO stages
// (quant32 :566 in, emit_counts :590 out); with the min* update (K5,
// _cn_minstar :159 through cn_upd :333); and the layered forms of the
// Monte-Carlo megakernel (the mc branch :432-558, reached from pallas_call
// :990; K1-MC). Bit-exact with golden.decoder.decode_fixed(schedule=
// "layered") and with the plain torch version beside the wrapper
// (ldpc_tpu_torch/ops/decode_ref.py::make_layered_decoder).
//
// What bounds it on the H100: not device memory (a codeword brings about 4n
// bytes of float LLRs in and a few bytes of counters out) but the
// shared-memory pipe, integer instruction throughput and one block barrier a
// layer: up to max_iter * E * Z check-node edge updates (20 * 79 * 81 =
// 127,980 for the 802.11n n=1944 rate 5/6 code).
//
// Three kernel templates share the library.
//
// layered_packed_kernel<LPT, DMAX, STAR, ET, MC>: every instance (the
// min-sum family or min*, fixed or early-terminating, fused IO or the
// megakernel) wherever a block of four lanes fits, laid out for this card
// with the packed parts of cn_packed.cuh (those of flood_packed_kernel);
// its body (layered_packed) also runs at two lanes a thread, in
// layered_two_lane_kernel<DMAX, STAR, ET> (every form but the megakernel),
// where four lanes of state exceed a block's shared memory but two fit (NR BG1 at Z = 256 and 384,
// DVB-S2 n=16,200: 79-115 KB a lane; the one-lane template decoded them
// one lane a thread's instruction, its tables in shared memory, reading
// each row twice): a block of two lanes and Z (360, 384) rows,
// kTwoLaneThreads (384) the launch bound with at least one block an SM, so
// up to 170 registers a thread; NR BG1 Z=384 takes 228,880 B a block.
//  * Thread (x, y) owns codeword lanes LPT x .. LPT x + LPT - 1 of check
//    row y of every base row. Shared memory, one block of L lanes, lane
//    index innermost:
//      s_flag, s_bits int32 [L]    ET's flag stamp or the final syndrome's
//                                  flag, info-bit errors
//      post  int16 [n][L]          posteriors, from the quantized channel
//                                  (no channel buffer); |post| <= 128 +
//                                  dv_max * qmax, which the wrapper checks
//                                  is < 2^15, so the 16x2 adds never leave
//                                  their half
//      c2v   int8  [E * Z][L]      check-to-variable messages, negated,
//                                  entry-major
//    so four lanes' posteriors are one 8-byte access and their messages one
//    4-byte access (two lanes': 4 and 2 bytes).
//  * The entry tables are uniform across the block and travel in the
//    kernel's parameter space (PackedArgs, as the flooding kernel's), with
//    each entry's posterior as a byte offset (the launch computes it for
//    the block's lanes), so an address is a few integer operations.
//  * One layer: thread y reads, for each entry (col, s) of the base row,
//    the posterior pair post[col][(y + s) mod Z] and its negated old
//    message once, keeps raw = post - old (two 16x2 words, unclipped) and
//    its row byte (min(|raw|, qmax) | sign << 7 a lane) in registers (DMAX
//    slots, DMAX (8, 16, 20, 24) >= the largest base-row degree; a row past
//    24 is read twice), reduces the row, then emits from registers: the new
//    negated message bytes and the new bytes (PackedEmit for the min-sum
//    family) and post = raw + new (one 16x2 add a pair), one message store
//    and one posterior store an entry. A base row holds at most one circulant per base
//    column, so within a layer each posterior address is read and written
//    by one thread only; no atomics, one barrier a layer.
//  * min* (STAR, K5): the suffix pass walks the register row backwards and
//    keeps suf[j] of the four lanes as one byte word a slot; the prefix pass
//    walks it forwards and emits out[i] = bp2(pre[i-1], suf[i+1]), the
//    grouping of cn_minstar.cuh (3d - 6 combines in entry order), with bp2
//    on packed lanes (star_bp2: magnitudes as 16x2 pairs, signs as a
//    byte word). Padded slots never enter the row.
//    Rows above 24 entries keep the one-lane template.
//  * Iteration 1 takes every message as 0 without reading it (each entry
//    belongs to one layer), so the buffer is never zeroed and the MC
//    prologue borrows it for the codeword bits.
//  * Early termination (ET) on four lanes: `act` holds 0xff in byte k while
//    lane k runs. Before the first iteration and after each iteration k the
//    syndrome pass XORs the posterior pairs of each check row (one 8-byte
//    load an entry; the parity of four lanes' signs at once) and stops once
//    every running lane has an unsatisfied row; a thread stamps the flag of
//    each such lane with k (every writer stores the same value), and after
//    a barrier a running lane whose flag is not k is done with iters = k.
//    Its hard bits or info-bit errors are written there and then, from that
//    state (latch_hard's effect: packed_outputs), and it goes on through
//    the layers with the other lanes of its word, whose arithmetic it
//    shares, but nothing reads its state again; so no lane is masked in the
//    layer loop. A thread whose four lanes are done skips its layers, and
//    the block leaves the loop once no lane runs (__syncthreads_or gives
//    every thread the same answer).
//  * Lanes past the batch are masked in their data, never in their
//    barriers; device-memory words of chan, info and hard are vectors of
//    four lanes where aligned and whole, else single lanes.
//  * Lanes per block follow packed_shape over this state, up to 256
//    threads a block (the launch bound, which leaves ptxas up to 255
//    registers for the register row; 42-135 used, no spills).
//
// layered_row_kernel<DMAX, STAR, ET>: the one-lane register-row instance,
// for codes whose block of two lanes does not fit (NR BG1 rate 1/3 at Z >=
// 288) and min* rows of 25-28 entries (DVB-S2 n=16,200 rate 8/9), Z <= 384
// and rows of at most 28 entries (DMAX 24 or 28). A block decodes one
// codeword, a thread one check row of each layer (a layer has only Z
// independent rows). The row is read once into registers and written once,
// the tables ride in the parameters (packed_tables' words), and min* runs
// the DPX combine of cn_packed.cuh with its two chains side by side in the
// two halves of a 16x2 word (layered_row_body), half the combines and half
// the chain of the template's walk: 2.0-3.0x the template on its min*
// routes (PERF.md section 6), at 14-22% of the operation bound. What
// bounds it (no profiler on the card): the time followed the combine
// chain's length, not the instruction count alone, so the latency of one
// row's chain a layer at 12 warps an SM. No megakernel.
//
// minsum_layered_kernel<ET, MC, STAR>: the earlier one-lane-a-thread
// layout, kept for codes no packed or register-row instance takes (rows
// above 28 entries for min*: the (3,30) array code) and as the forced
// template (`template_only`). Thread (x, y) = (codeword lane, row y); the tables sit in shared
// memory; the row is read twice (reduce, then emit: c2v[e][y] = new and
// post[j][(y + s) mod Z] += new - old), and with min* the two reads are
// the suffix pass into an int8 scratch of star_deg slots per row and the
// prefix pass that emits. Early termination as above, one lane a thread:
// the flag stamps increase with k, so no reset is needed between
// iterations.
//
// Monte-Carlo megakernel (template MC, K1-MC on the layered schedule;
// mc_stage.cuh): the posteriors start from the in-kernel prologue (Philox
// or injected words -> info bits -> structured encode -> BPSK/AWGN/demap/
// quantize) instead of device memory, the codeword bits borrow the c2v
// buffer (the one-lane template zeroes it after the prologue; the packed
// kernel never reads it in iteration 1), and the error count draws each
// info bit again.
//
// Five units: build.py compiles this file five times at once, with
// LDPC_UNIT=1 (the C entries, the one-lane template and the four-lane
// instances of rows up to 16 entries), LDPC_UNIT=2 (the two-lane instances,
// through layered_two_lane), LDPC_UNIT=3 (the four-lane instances of
// longer rows, through layered_four_lane_long), LDPC_UNIT=4 (the fixed
// register-row instances, through layered_row) and LDPC_UNIT=5 (the
// early-terminating ones, through layered_row_et: the min* walks are the
// library's longest compile), and links them into one library, so that its
// instances build side by side; without LDPC_UNIT the file is one unit of
// all.

#include <type_traits>

#include "cn_minsum.cuh"
#include "cn_minstar.cuh"
#include "cn_packed.cuh"
#include "mc_stage.cuh"

namespace ldpc {
// The two-lane instance for a code (unit 2, below).
PackedKernel layered_two_lane(int max_deg, bool star, bool et, bool mc);
// The four-lane instance for rows above 16 entries (unit 3, below).
PackedKernel layered_four_lane_long(int max_deg, bool star, bool et, bool mc);
// The one-lane register-row instance for a code (unit 4, below), and its
// early-terminating forms (unit 5).
PackedKernel layered_row(int max_deg, bool star, bool et);
PackedKernel layered_row_et(int max_deg, bool star);
}  // namespace ldpc

namespace {

using namespace ldpc;

#if !defined(LDPC_UNIT) || LDPC_UNIT == 1
// ---------------------------------------------------------------------------
// The one-lane-a-thread template (unit 1).

inline size_t smem_bytes(int nb, int Z, int mb, int E, int star_deg, int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(4 * size_t(ldpc::table_words(nb, mb, E)))
       + align16(8 * size_t(lanes))          // per-lane flag, bit errors
       + align16(2 * n * lanes)               // post
       + align16(size_t(E) * Z * lanes)       // c2v
       + align16(ldpc::star_scratch_bytes(star_deg, Z, lanes));  // min* suffixes
}

template <bool ET, bool MC, bool STAR>
__global__ void minsum_layered_kernel(Params p) {
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
  int16_t* post = reinterpret_cast<int16_t*>(cursor);
  cursor += align16(2 * size_t(n) * L);
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
    ldpc::mc_prologue(p, t, reinterpret_cast<uint8_t*>(c2v), post, valid, b,
                      row, lane);
    __syncthreads();   // every codeword bit read, before c2v is zeroed
  } else {
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      const int q = valid ? ldpc::load_chan(p, size_t(v) * p.B + b) : 0;
      post[v * L + lane] = int16_t(q);
    }
  }
  for (int i = tid; i < E * Z * L; i += nthreads) c2v[i] = 0;
  __syncthreads();

  bool done = !valid;   // ET: lanes past the batch never run
  int iters = 0;
  if (ET) {
    // State 0, the channel: done with iters = 0 if it is a codeword.
    if (valid && ldpc::rows_unsat(t, post, mb, Z, L, row, lane)) s_flag[lane] = 0;
    __syncthreads();
    if (valid && s_flag[lane] != 0) done = true;
  }
  for (int it = 0; it < p.max_iter; ++it) {
    if (ET && !__syncthreads_or(!done)) break;
    for (int li = 0; li < mb; ++li) {
      if (!ET || !done) {
        const int e0 = t.layer_ptr[li], e1 = t.layer_ptr[li + 1];
        // Second read of the row: entry e takes emit(its index, raw) as its
        // new message, and the posterior moves by new - old.
        auto write_row = [&](auto&& emit) {
          for (int e = e0; e < e1; ++e) {
            int c = row + t.ent_shift[e];
            if (c >= Z) c -= Z;
            const int idx = (e * Z + row) * L + lane;
            const int pidx = (t.ent_col[e] * Z + c) * L + lane;
            const int old = c2v[idx];
            const int pv = post[pidx];
            const int nw = emit(e - e0, pv - old);
            c2v[idx] = int8_t(nw);
            post[pidx] = int16_t(pv + nw - old);
          }
        };
        if constexpr (STAR) {
          ldpc::StarRow star(scr + row * L + lane, Z * L, e1 - e0);
          for (int e = e1 - 1; e > e0; --e) {
            int c = row + t.ent_shift[e];
            if (c >= Z) c -= Z;
            star.back(p, e - e0, int(post[(t.ent_col[e] * Z + c) * L + lane])
                                     - int(c2v[(e * Z + row) * L + lane]));
          }
          write_row([&](int i, int raw) { return star.emit(p, i, raw); });
        } else {
          ldpc::CnRow cn;
          for (int e = e0; e < e1; ++e) {
            int c = row + t.ent_shift[e];
            if (c >= Z) c -= Z;
            cn.add(int(post[(t.ent_col[e] * Z + c) * L + lane])
                   - int(c2v[(e * Z + row) * L + lane]), qmax);
          }
          cn.finish(p);
          write_row([&](int, int raw) { return cn.emit(raw, qmax); });
        }
      }
      __syncthreads();
    }
    if (ET) {
      // State it + 1: stamp the lane's flag when a row is unsatisfied.
      if (!done && ldpc::rows_unsat(t, post, mb, Z, L, row, lane))
        s_flag[lane] = it + 1;
      __syncthreads();
      if (!done) {
        iters = it + 1;
        done = s_flag[lane] != it + 1;
      }
    }
  }

  // Outputs from the final (for ET: frozen) posteriors: hard bits or
  // info-bit errors; the fixed form also takes the syndrome here.
  int nerr = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    const int h = post[v * L + lane] < 0;
    if (valid) {
      const size_t g = size_t(v) * p.B + b;
      if (p.hard) p.hard[g] = uint8_t(h);
      if (MC && j < p.kb) nerr += h ^ ldpc::mc_info_bit(p, b, j, row);
      else if (p.info && j < p.kb) nerr += h ^ int(p.info[g]);
    }
  }
  if (!ET && ldpc::rows_unsat(t, post, mb, Z, L, row, lane))
    atomicOr(&s_flag[lane], 1);
  if (nerr) atomicAdd(&s_bits[lane], nerr);
  __syncthreads();
  if (row == 0 && valid) {
    p.iters[b] = ET ? iters : p.max_iter;
    p.conv[b] = ET ? done : s_flag[lane] == 0;
    if (p.bits) {
      p.bits[b] = s_bits[lane];
      p.frame[b] = s_bits[lane] > 0;
    }
  }
}

// kernels[STAR][MC][ET]
const ldpc::Kernel kernels[2][2][2] = {
    {{minsum_layered_kernel<false, false, false>,
      minsum_layered_kernel<true, false, false>},
     {minsum_layered_kernel<false, true, false>,
      minsum_layered_kernel<true, true, false>}},
    {{minsum_layered_kernel<false, false, true>,
      minsum_layered_kernel<true, false, true>},
     {minsum_layered_kernel<false, true, true>,
      minsum_layered_kernel<true, true, true>}}};
#endif

// ---------------------------------------------------------------------------
// The packed instance.

// The launch bound: up to 256 threads a block, at least one block an SM.
// Without the second figure ptxas held some instances at 64 registers and
// spilled 4 B around the Monte-Carlo stage's Philox draws; with it no
// instance spills, and each stays within the registers its blocks an SM
// allow (at most 135 a thread).
constexpr int kLayeredMaxThreads = 256;
// The DMAX instances: a row of 19-20 entries (802.11n rate 5/6) would pay
// for 4-5 padded slots at 24.
constexpr int kLayeredRowDegrees[4] = {8, 16, 20, 24};

// The DMAX instance for a largest base-row degree (4: the two-pass row).
inline int layered_row_instance(int max_deg) {
  for (int i = 0; i < 4; ++i)
    if (max_deg <= kLayeredRowDegrees[i]) return i;
  return 4;
}

inline size_t layered_packed_smem(int nb, int Z, int E, int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(8 * size_t(lanes)) + align16(2 * n * lanes)
       + align16(size_t(E) * Z * lanes);
}

// packed_shape of cn_packed.cuh for this kernel's state: four lanes a
// thread up to kLayeredMaxThreads where a block fits, else two lanes a
// thread up to kTwoLaneThreads.
inline PackedShape layered_shape(int nb, int Z, int E) {
  const auto smem = [=](int l) { return layered_packed_smem(nb, Z, E, l); };
  const PackedShape s = packed_shape(Z, kLayeredMaxThreads, smem);
  return s.lanes ? s : packed_shape(Z, kTwoLaneThreads, smem, kTwoLanes);
}

// The packed kernel takes a code wherever a block of four or two lanes
// fits, min* where its rows (star_deg: the largest base-row degree) fit the
// largest register row; the register-row instance takes the rest where
// row_shape does (max_deg: the largest base-row degree); the one-lane
// template the others, and every code when `template_only` asks for it.
inline bool is_packed(int nb, int Z, int E, int star_deg) {
  return layered_shape(nb, Z, E).lanes > 0 && layered_row_instance(star_deg) < 4;
}

// The packed kernel's parameter tables: packed_tables' words (o_ent: the
// entries (col * Z) << 11 | shift by base row), then the entries as byte
// offsets, post_off[E] = (2 * lanes * (col * Z + shift)) << 11 | (Z - shift):
// entry (col, shift) of check row y is posterior byte 2 * lanes * (col * Z
// + (y + shift) mod Z), the offset plus 2 * lanes * y, less 2 * lanes * Z
// where y >= Z - shift.
__host__ __device__ inline int offsets_at(int nb, int mb, int E) {
  return mb + nb + 2 + 2 * E;
}
inline int layered_tab_words(int nb, int mb, int E) {
  return offsets_at(nb, mb, E) + E;
}

// The body of every packed instance; `a` is the kernel's parameter block.
template <int LPT, int DMAX, bool STAR, bool ET, bool MC>
__device__ __forceinline__ void layered_packed(const PackedArgs& a) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  static_assert(DMAX > 0 || !STAR, "min* keeps its row in registers");
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = a.p;
  const uint32_t* tw = a.t.w;
  const int L = p.lanes, Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const int n = nb * Z, ZL = Z * L;
  const uint32_t* const off = tw + offsets_at(nb, mb, E);
  const uint32_t (&tc)[2 * kMaxThresholds] = a.star;   // min* constants
  const uint32_t q2 = uint32_t(p.qmax) * 0x00010001u;

  int32_t* s_flag = reinterpret_cast<int32_t*>(smem);
  int32_t* s_bits = s_flag + L;
  unsigned char* cursor = smem + align16(8 * size_t(L));
  int16_t* post = reinterpret_cast<int16_t*>(cursor);
  cursor += align16(2 * size_t(n) * L);
  int8_t* c2v = reinterpret_cast<int8_t*>(cursor);   // negated messages

  const int row = threadIdx.y;
  const int lane0 = threadIdx.x * LPT;
  const int tid = row * blockDim.x + threadIdx.x;
  const long long b0 = (long long)blockIdx.x * L + lane0;
  const int nvalid = int(min((long long)LPT, max(p.B - b0, 0LL)));
  int16_t* const post_l = post + lane0;
  int8_t* const msg_row = c2v + row * L + lane0;   // + e * Z * L: entry e

  for (int i = tid; i < L; i += blockDim.x * blockDim.y) {
    s_flag[i] = ET ? -1 : 0;
    s_bits[i] = 0;
  }

  // Channel in: this thread owns row `row` of every base column.
  if constexpr (MC) {
    mc_prologue_lanes<LPT>(p, tw, c2v, post, nvalid, b0, row, lane0);
  } else {
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      put_lanes<LPT>(post_l + v * L,
                     load_chan_lanes<LPT>(p, size_t(v) * p.B + b0, nvalid));
    }
  }
  __syncthreads();

  // The posterior pair of entry e of this thread's check row.
  unsigned char* const post_row =
      reinterpret_cast<unsigned char*>(post_l) + 2 * row * L;
  auto post_of = [&](int e) {
    const uint32_t w = off[e];
    return reinterpret_cast<int16_t*>(
        post_row + (w >> 11) - (row >= int(w & 0x7ffu) ? 2 * ZL : 0));
  };

  // ET: byte k of act is 0xff while lane k runs (lanes past the batch never
  // do); iters[k], the iterations lane k ran.
  uint32_t act = 0;
  int iters[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    iters[k] = ET ? 0 : p.max_iter;
    if (k < nvalid) act |= 0xffu << (8 * k);
  }

  // State k: each running lane with an unsatisfied check row among this
  // thread's gets its flag stamped with k (the XOR of its posteriors over a
  // row carries the parity of their signs in bit 15 of its half; the pass
  // stops once every running lane has one); after the barrier a running
  // lane that no thread stamped is done, with iters = k, and its outputs
  // are written from this state (latch_hard's effect). A done lane goes on
  // through the layers with the others of its word, but nothing reads its
  // state again.
  auto check = [&](int k) {
    if (act) {
      const uint32_t need = act & 0x80808080u;
      uint32_t un = 0;
      for (int li = 0; li < mb && (un & need) != need; ++li) {
        uint32_t x[2] = {0u, 0u};
        for (int e = tw[li]; e < int(tw[li + 1]); ++e) {
          uint32_t t[2];
          ld16<LPT>(post_of(e), t[0], t[1]);
          x[0] ^= t[0];
          x[1] ^= t[1];
        }
        un |= bytes_of(x[0], x[1], 0x7531);
      }
      un &= need;
#pragma unroll
      for (int q = 0; q < LPT; ++q)
        if ((un >> (8 * q + 7)) & 1) s_flag[lane0 + q] = k;
    }
    __syncthreads();
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
      packed_outputs<LPT, MC>(p, post, s_bits, nvalid, b0, row, lane0, fin);
    }
  };

  if constexpr (ET) check(0);
  for (int it = 0; it < p.max_iter; ++it) {
    if constexpr (ET) {
      if (!__syncthreads_or(act != 0)) break;
    }
    // One layer a base row li; every thread meets the barrier after it.
    for (int li = 0; li < mb; ++li) {
      if (!ET || act) {
        const int e0 = tw[li], d = int(tw[li + 1]) - e0;
        int8_t* const m0 = msg_row + e0 * ZL;
        // Entry i's stores: its negated new message bytes msg, and the
        // posterior raw + new (nv: the new message bytes).
        auto put = [&](int i, uint32_t msg, uint32_t nv,
                       const uint32_t (&r)[2]) {
          st8<LPT>(m0 + i * ZL, msg);
          st16<LPT>(post_of(e0 + i), __vadd2(r[0], widen_lo(nv)),
                    __vadd2(r[1], widen_hi(nv)));
        };
        if constexpr (DMAX > 0) {
          // The row read once, into registers, in groups of four slots:
          // a group past the row's degree is skipped (one uniform branch),
          // and within a group entries past d repeat the last one's loads
          // and take no part in the row or the stores.
          uint32_t raw[DMAX][2];
          uint32_t rb[DMAX];   // min-sum: row bytes; min*: suffix bytes
          PackedRow<LPT> cn;
#pragma unroll
          for (int i = 0; i < DMAX; ++i) {
            if ((i & ~3) >= d) break;
            const int ei = min(i, d - 1);
            uint32_t t[2];
            ld16<LPT>(post_of(e0 + ei), t[0], t[1]);
            const uint32_t nw = it ? ld8<LPT>(m0 + ei * ZL) : 0u;
            if constexpr (STAR) {
              raw[i][0] = __vadd2(t[0], widen_lo(nw));
              raw[i][1] = LPT == 4 ? __vadd2(t[1], widen_hi(nw)) : 0u;
              rb[i] = 0u;
            } else {
              rb[i] = cn.template entry<true>(t, nw, q2, i < d, raw[i]);
            }
          }
          if constexpr (STAR) {
            auto leaf = [&](int i) { return star_leaf<LPT>(raw[i], q2); };
            const int nthr = p.nthr;
            // suf[d - 1] = leaf[d - 1], suf[j] = bp2(leaf[j], suf[j + 1])
            // for j = d - 2 .. 1, as bytes
            StarVal acc{};
#pragma unroll
            for (int j = DMAX - 1; j >= 1; --j) {
              if (j < d) {
                acc = j == d - 1 ? leaf(j)
                                 : star_bp2<LPT>(leaf(j), acc, tc, nthr, q2);
                rb[j] = star_pack(acc);
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
                if (i == 0) out = star_unpack(rb[1]);
                else if (i == d - 1) out = pre;
                else out = star_bp2<LPT>(pre, star_unpack(rb[min(i + 1, DMAX - 1)]),
                                         tc, nthr, q2);
                if (i < d - 1)
                  pre = i == 0 ? leaf(0) : star_bp2<LPT>(pre, leaf(i), tc, nthr, q2);
                uint32_t msg, nv;
                star_bytes(out, msg, nv);
                put(i, msg, nv, raw[i]);
              }
            }
          } else {
            const PackedEmit em(cn, p);
#pragma unroll
            for (int i = 0; i < DMAX; ++i) {
              if (i < d) {
                uint32_t msg, nv;
                em.emit(rb[i], msg, nv);
                put(i, msg, nv, raw[i]);
              }
            }
          }
        } else {
          // rows longer than every register instance: read twice
          PackedRow<LPT> cn;
          for (int i = 0; i < d; ++i) {
            uint32_t t[2];
            ld16<LPT>(post_of(e0 + i), t[0], t[1]);
            cn.template entry<true>(t, it ? ld8<LPT>(m0 + i * ZL) : 0u, q2);
          }
          const PackedEmit em(cn, p);
          for (int i = 0; i < d; ++i) {
            uint32_t t[2], raw[2], msg, nv;
            ld16<LPT>(post_of(e0 + i), t[0], t[1]);
            em.emit(cn.template entry<false>(
                        t, it ? ld8<LPT>(m0 + i * ZL) : 0u, q2, true, raw),
                    msg, nv);
            put(i, msg, nv, raw);
          }
        }
      }
      __syncthreads();
    }
    if constexpr (ET) check(it + 1);
  }

  // Outputs of the lanes not yet written, from the final posteriors.
  packed_finish<LPT, ET, MC>(p, tw, post, s_flag, s_bits, nvalid, b0, row,
                             lane0, iters, act);
}

// Four lanes a thread, up to kLayeredMaxThreads threads a block.
template <int LPT, int DMAX, bool STAR, bool ET, bool MC>
__global__ void __launch_bounds__(kLayeredMaxThreads, 1)
layered_packed_kernel(const __grid_constant__ PackedArgs a) {
  layered_packed<LPT, DMAX, STAR, ET, MC>(a);
}

// Two lanes a thread, up to kTwoLaneThreads threads a block, every form but
// the megakernel (no step reaches it: the codes that need two lanes have n
// above 4,096, which takes the batch-first chain).
template <int DMAX, bool STAR, bool ET>
__global__ void __launch_bounds__(kTwoLaneThreads, 1)
layered_two_lane_kernel(const __grid_constant__ PackedArgs a) {
  layered_packed<kTwoLanes, DMAX, STAR, ET, false>(a);
}

template <int DMAX, bool STAR>
PackedKernel packed_instance(bool et, bool mc) {
  constexpr int P = kLanesPerThread;
  if (et)
    return mc ? layered_packed_kernel<P, DMAX, STAR, true, true>
              : layered_packed_kernel<P, DMAX, STAR, true, false>;
  return mc ? layered_packed_kernel<P, DMAX, STAR, false, true>
            : layered_packed_kernel<P, DMAX, STAR, false, false>;
}

// Null for the megakernel, which is not built at two lanes a thread.
template <int DMAX, bool STAR>
PackedKernel two_lane_instance(bool et, bool mc) {
  if (mc) return nullptr;
  return et ? layered_two_lane_kernel<DMAX, STAR, true>
            : layered_two_lane_kernel<DMAX, STAR, false>;
}

// ---------------------------------------------------------------------------
// The one-lane register-row instances: a codeword a block, a check row a
// thread.

// The state of one block: the info-bit errors, the int16 posteriors [n],
// the negated int8 messages [E][Z].
inline size_t row_smem(int nb, int Z, int E) {
  return 16 + align16(2 * size_t(nb) * Z) + align16(size_t(E) * Z);
}

// The block shape: Z threads (at most kTwoLaneThreads, the launch bound),
// rows of at most 28 entries, the state within a block's shared memory.
// Threads 0 when the code is not taken.
inline OneLaneShape row_shape(int nb, int Z, int E, int max_deg) {
  if (Z > kTwoLaneThreads || one_lane_row_instance(max_deg) > 1)
    return OneLaneShape{0, 0, 0};
  return one_lane_shape(Z, row_smem(nb, Z, E));
}

// Calls f(std::integral_constant<int, W>) for the min* row width W of a
// row of degree d <= DMAX: d itself up to 8 entries, else d rounded up to a
// multiple of 4 (12 .. DMAX), so that a row runs one of at most twelve
// straight-line walks.
template <int W, int DMAX, typename F>
__device__ __forceinline__ void star_width(int d, F&& f) {
  if constexpr (W <= DMAX) {
    if (W <= 8 ? d == W : d <= W) f(std::integral_constant<int, W>{});
    else star_width<W < 8 ? W + 1 : W + 4, DMAX>(d, f);
  }
}

// The body of every register-row instance: block b decodes codeword b,
// thread y check row y of every base row. A layer reads each entry's
// posterior and old message once into a register row (the raw value post
// - old in the low half of a 16x2 word), and writes each message and
// posterior once. The min-sum family reduces the row with PackedRow<2>,
// whose high half is a lane of zeros. min* puts the high half to work: the
// grouping of cn_minstar.cuh (suf[j] = bp2(leaf[j], suf[j + 1]) from the
// right, pre[i] = bp2(pre[i - 1], leaf[i]) from the left, out[i] =
// bp2(pre[i - 1], suf[i + 1])) runs its two chains side by side, the
// suffix in the low half and the prefix in the high half of one 16x2 word,
// C[t] = (suf[W - 1 - t], pre[t]) = bp2((leaf[W - 1 - t], leaf[t]), C[t -
// 1]), and the outputs in pairs, (out[i], out[W - 1 - i]) =
// bp2((pre[i - 1], pre[W - 2 - i]), (suf[i + 1], suf[W - i])): W - 2 + W / 2
// combines for a row of width W instead of 3 d - 6, every index a constant
// of the straight-line walk of that width (star_width). Slots d .. W - 1
// are padding: the suffix chain holds the identity, a magnitude of 0x4000
// (bp2(x, I) = x: min(|x|, I) = |x|, and no threshold lies between I - |x|
// and I + |x|), until it reaches slot d - 1, pre[-1] and suf[d] are the
// identity, and the outputs of padded slots are not stored.
template <int DMAX, bool STAR, bool ET>
__device__ __forceinline__ void layered_row_body(const PackedArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = a.p;
  const uint32_t* tw = a.t.w;
  const int Z = p.Z, nb = p.nb, mb = p.mb, o_ent = mb + nb + 2;
  const uint32_t (&tc)[2 * kMaxThresholds] = a.star;   // min* constants
  const uint32_t q2 = uint32_t(p.qmax) * 0x00010001u;
  const int row = threadIdx.x;
  const long long b = blockIdx.x;

  int32_t* const s_bits = reinterpret_cast<int32_t*>(smem);
  int16_t* const post = reinterpret_cast<int16_t*>(smem + 16);
  int8_t* const msg_row =
      reinterpret_cast<int8_t*>(smem + 16 + align16(2 * size_t(nb) * Z)) + row;

  if (row == 0) *s_bits = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    post[v] = int16_t(load_chan(p, size_t(v) * p.B + b));
  }
  __syncthreads();

  // The posterior of entry word en = colZ << 11 | shift of this check row.
  auto post_of = [&](uint32_t en) {
    int c = row + int(en & 0x7ffu);
    if (c >= Z) c -= Z;
    return post + int(en >> 11) + c;
  };
  // The block's vote: whether some check row is unsatisfied by the signs of
  // the posteriors (bit 31 of the XOR of the int16 values: the parity of
  // their signs); each thread stops at its first.
  auto unsat = [&]() {
    bool un = false;
    for (int li = 0; li < mb && !un; ++li) {
      int x = 0;
      for (int e = tw[li]; e < int(tw[li + 1]); ++e) x ^= *post_of(tw[o_ent + e]);
      un = x < 0;
    }
    return __syncthreads_or(un) != 0;
  };

  int iters = p.max_iter;
  bool conv = false;
  if constexpr (ET) {
    // state 0, the channel
    if (!unsat()) {
      iters = 0;
      conv = true;
    }
  }
  for (int it = 0; it < p.max_iter && !conv; ++it) {
    // One layer a base row li; every thread meets the barrier after it.
    for (int li = 0; li < mb; ++li) {
      const int e0 = tw[li], d = int(tw[li + 1]) - e0;
      int8_t* const m0 = msg_row + e0 * Z;   // + k Z: entry e0 + k
      // the raw value of slot k of the row (slots past d repeat the last
      // entry's loads and take no part in the row or the stores)
      auto load_raw = [&](int k) {
        const int ek = min(k, d - 1);
        const uint32_t t = uint32_t(uint16_t(*post_of(tw[o_ent + e0 + ek])));
        return __vadd2(t, widen_lo(it ? uint32_t(uint8_t(m0[ek * Z])) : 0u));
      };
      if constexpr (STAR) {
        star_width<2, DMAX>(d, [&](auto width) {
          constexpr int W = decltype(width)::value;
          const int nthr = p.nthr, pad = W - d;
          uint32_t raw[W];   // post - old, unclipped, in the low half
#pragma unroll
          for (int k = 0; k < W; ++k) raw[k] = load_raw(k);
          // (leaf of slot W - 1 - t, leaf of slot t)
          auto leaves = [&](int t) {
            const uint32_t r2[2] = {prmt(raw[W - 1 - t], raw[t], 0x5410), 0u};
            return star_leaf<2>(r2, q2);
          };
          // the suffix half is the identity while slot W - 1 - t is padding
          auto suffix_from = [&](StarVal v, int t) {
            if (t < pad) {
              v.m[0] = (v.m[0] & 0xffff0000u) | 0x4000u;
              v.s &= ~0x80u;
            }
            return v;
          };
          StarVal C[W - 1];   // C[t] = (suf[W - 1 - t], pre[t])
          C[0] = suffix_from(leaves(0), 0);
#pragma unroll
          for (int t = 1; t < W - 1; ++t)
            C[t] = suffix_from(star_bp2<2>(leaves(t), C[t - 1], tc, nthr, q2), t);
          // the stores of slot k from the low byte of msg and nv (the
          // negated and the new message): the message, and the posterior
          // raw + new
          auto put = [&](int k, uint32_t msg, uint32_t nv) {
            m0[k * Z] = int8_t(msg);
            *post_of(tw[o_ent + e0 + k]) =
                int16_t(int(int16_t(raw[k])) + int(int8_t(nv)));
          };
          // (out[i], out[W - 1 - i]) from X = C[i - 1] (the identity at
          // i = 0) and Y = C[W - 2 - i]: bp2((X.hi, Y.hi), (Y.lo, X.lo))
          const StarVal ident{{0x40004000u, 0u}, 0u};
#pragma unroll
          for (int i = 0; i < W / 2; ++i) {
            const StarVal& X = i ? C[i - 1] : ident;
            const StarVal& Y = C[W - 2 - i];
            const StarVal U{{prmt(X.m[0], Y.m[0], 0x7632), 0u},
                            prmt(X.s, Y.s, 0x0051)};
            const StarVal V{{prmt(Y.m[0], X.m[0], 0x5410), 0u},
                            prmt(Y.s, X.s, 0x0040)};
            uint32_t msg, nv;
            star_bytes(star_bp2<2>(U, V, tc, nthr, q2), msg, nv);
            if (i < d) put(i, msg, nv);
            if (W - 1 - i < d) put(W - 1 - i, msg >> 8, nv >> 8);
          }
          if constexpr (W % 2) {
            // the middle slot (W = d): bp2(pre[i - 1], suf[i + 1]), both in
            // C[i - 1]
            constexpr int i = W / 2;
            const StarVal& X = C[i - 1];
            const StarVal V{{prmt(X.m[0], X.m[0], 0x1032), 0u},
                            prmt(X.s, X.s, 0x0001)};
            uint32_t msg, nv;
            star_bytes(star_bp2<2>(X, V, tc, nthr, q2), msg, nv);
            put(i, msg, nv);
          }
        });
      } else {
        uint32_t raw[DMAX];   // post - old, unclipped, in the low half
        uint32_t rb[DMAX];    // row bytes
        PackedRow<2> cn;
        // in groups of four slots: a group past d is skipped
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if ((k & ~3) >= d) break;
          const uint32_t t[2] = {load_raw(k), 0u};
          uint32_t r2[2];
          rb[k] = cn.template entry<true>(t, 0u, q2, k < d, r2);
          raw[k] = r2[0];
        }
        const PackedEmit em(cn, p);
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            uint32_t msg, nv;
            em.emit(rb[k], msg, nv);
            // the negated new message, and the posterior raw + new
            m0[k * Z] = int8_t(msg);
            *post_of(tw[o_ent + e0 + k]) =
                int16_t(__vadd2(raw[k], widen_lo(nv)));
          }
        }
      }
      __syncthreads();
    }
    if constexpr (ET) {
      // state it + 1
      if (!unsat()) {
        iters = it + 1;
        conv = true;
      }
    }
  }
  if constexpr (!ET) conv = !unsat();

  // Hard bits or info-bit errors from the final posteriors.
  int nerr = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    const int h = post[v] < 0;
    const size_t g = size_t(v) * p.B + b;
    if (p.hard) p.hard[g] = uint8_t(h);
    if (p.info && j < p.kb) nerr += h ^ int(p.info[g]);
  }
  if (nerr) atomicAdd(s_bits, nerr);
  __syncthreads();
  if (row == 0) {
    p.iters[b] = iters;
    p.conv[b] = conv;
    if (p.bits) {
      p.bits[b] = *s_bits;
      p.frame[b] = *s_bits > 0;
    }
  }
}

// Every form of the register-row instance (the min-sum family or min*,
// fixed or early-terminating, fused IO; no megakernel), Z <=
// kTwoLaneThreads threads a block, at least one block an SM.
template <int DMAX, bool STAR, bool ET>
__global__ void __launch_bounds__(kTwoLaneThreads, 1)
layered_row_kernel(const __grid_constant__ PackedArgs a) {
  layered_row_body<DMAX, STAR, ET>(a);
}

template <int DMAX, bool ET>
PackedKernel row_instance_of(bool star) {
  return star ? layered_row_kernel<DMAX, true, ET>
              : layered_row_kernel<DMAX, false, ET>;
}

}  // namespace

#if !defined(LDPC_UNIT) || LDPC_UNIT == 5
// The early-terminating register-row instance for the largest base-row
// degree (DMAX 24 or 28) and the update.
PackedKernel ldpc::layered_row_et(int max_deg, bool star) {
  return one_lane_row_instance(max_deg) == 0 ? row_instance_of<24, true>(star)
                                             : row_instance_of<28, true>(star);
}
#endif

#if !defined(LDPC_UNIT) || LDPC_UNIT == 4
// The register-row instance for the largest base-row degree (DMAX 24 or
// 28), the update and ET (the early-terminating forms from unit 5).
PackedKernel ldpc::layered_row(int max_deg, bool star, bool et) {
  if (et) return layered_row_et(max_deg, star);
  return one_lane_row_instance(max_deg) == 0 ? row_instance_of<24, false>(star)
                                             : row_instance_of<28, false>(star);
}
#endif

#if !defined(LDPC_UNIT) || LDPC_UNIT == 2
// The two-lane instance for the largest base-row degree (DMAX 8, 16, 20,
// 24, else the row read twice; min* only up to 24), the update and ET; null
// for the megakernel.
PackedKernel ldpc::layered_two_lane(int max_deg, bool star, bool et,
                                    bool mc) {
  switch (layered_row_instance(max_deg)) {
    case 0:
      return star ? two_lane_instance<8, true>(et, mc)
                  : two_lane_instance<8, false>(et, mc);
    case 1:
      return star ? two_lane_instance<16, true>(et, mc)
                  : two_lane_instance<16, false>(et, mc);
    case 2:
      return star ? two_lane_instance<20, true>(et, mc)
                  : two_lane_instance<20, false>(et, mc);
    case 3:
      return star ? two_lane_instance<24, true>(et, mc)
                  : two_lane_instance<24, false>(et, mc);
    default:
      return two_lane_instance<0, false>(et, mc);
  }
}
#endif

#if !defined(LDPC_UNIT) || LDPC_UNIT == 3
// The four-lane instance for rows above 16 entries: DMAX 20, 24, else the
// row read twice (min* only up to 24).
PackedKernel ldpc::layered_four_lane_long(int max_deg, bool star, bool et,
                                          bool mc) {
  switch (layered_row_instance(max_deg)) {
    case 2:
      return star ? packed_instance<20, true>(et, mc)
                  : packed_instance<20, false>(et, mc);
    case 3:
      return star ? packed_instance<24, true>(et, mc)
                  : packed_instance<24, false>(et, mc);
    default:
      return packed_instance<0, false>(et, mc);
  }
}
#endif

#if !defined(LDPC_UNIT) || LDPC_UNIT == 1
namespace {

inline bool is_row(int nb, int Z, int E, int max_deg, int star_deg) {
  return !is_packed(nb, Z, E, star_deg)
      && row_shape(nb, Z, E, max_deg).threads > 0;
}

// The instance at lpt lanes a thread for the largest base-row degree (DMAX
// 8, 16, 20, 24, else the row read twice; min* only up to 24), the update,
// ET and MC.
inline PackedKernel packed_kernel(int lpt, int max_deg, bool star, bool et,
                                  bool mc) {
  if (lpt == kTwoLanes) return layered_two_lane(max_deg, star, et, mc);
  switch (layered_row_instance(max_deg)) {
    case 0:
      return star ? packed_instance<8, true>(et, mc)
                  : packed_instance<8, false>(et, mc);
    case 1:
      return star ? packed_instance<16, true>(et, mc)
                  : packed_instance<16, false>(et, mc);
    default:
      return layered_four_lane_long(max_deg, star, et, mc);
  }
}

}  // namespace

extern "C" {

// The launch shape of one instance for one code: lanes per block, dynamic
// shared-memory bytes, codeword lanes a thread, and the blocks an SM keeps
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers
// included). Where a block of four or two lanes fits (and for min* its
// rows fit a register row) the instance is the packed kernel at that many
// lanes a thread, and max_row_deg (the largest base-row degree) picks its
// row instance; else the register-row instance where it takes the code
// (one lane, Z threads); else, and with template_only, the one-lane
// template. Returns cudaErrorInvalidConfiguration, lanes 0, when no block
// shape fits (Z > 1024 or state above 227 KB per codeword), and
// cudaErrorNotSupported for the megakernel at two lanes a thread or on the
// register-row instance, which are not built.
int minsum_layered_config(int nb, int Z, int mb, int E, int star_deg,
                          int early_term, int mc, int max_row_deg,
                          int template_only, int* lanes, int* smem,
                          int* lanes_per_thread, int* blocks_per_sm) {
  *blocks_per_sm = 0;
  if (!template_only && is_row(nb, Z, E, max_row_deg, star_deg)) {
    const OneLaneShape s = row_shape(nb, Z, E, max_row_deg);
    *lanes = 1;
    *smem = s.smem;
    *lanes_per_thread = 1;
    const PackedKernel k =
        mc ? nullptr : layered_row(max_row_deg, star_deg > 0, early_term != 0);
    const cudaError_t err = prepare(k, s.smem);
    if (err != cudaSuccess) return int(err);
    return occupancy(k, s.threads, s.smem, blocks_per_sm);
  }
  if (!template_only && is_packed(nb, Z, E, star_deg)) {
    const PackedShape s = layered_shape(nb, Z, E);
    *lanes = s.lanes;
    *smem = s.smem;
    *lanes_per_thread = s.lpt;
    const PackedKernel k = packed_kernel(s.lpt, max_row_deg, star_deg > 0,
                                         early_term != 0, mc != 0);
    const cudaError_t err = prepare(k, s.smem);
    if (err != cudaSuccess) return int(err);
    return occupancy(k, s.lanes / s.lpt * Z, s.smem, blocks_per_sm);
  }
  *lanes_per_thread = 1;
  const int cfg = ldpc::decoder_config(
      Z, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); }, lanes,
      smem);
  if (cfg) return cfg;
  return ldpc::occupancy(kernels[star_deg > 0][mc != 0][early_term != 0],
                         *lanes * Z, *smem, blocks_per_sm);
}

const char* minsum_layered_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers but `mc`, `thr` and `ptab` are device pointers; chan/info/hard/
// bits/frame may be null. With `mc` (host memory) not null it runs the
// Monte-Carlo megakernel (K1-MC): the channel comes from the seed (key0,
// key1) or the injected words, and chan/info are not read. star_deg > 0 (the
// largest base-row degree) selects the min* update with the nthr thresholds
// at `thr` (host memory; beta and alpha are then not read). The packed
// kernel and the register-row instance take their entry tables from `ptab`
// (host memory, ptab_words uint32 words, packed_tables' layout, required
// unless template_only) into their parameters; tables above kTabWords
// words, or qmax above 127, are refused. `chan_q` is not read (the
// flooding library's channel buffer; the two libraries share one
// signature). The megakernel at two lanes a thread or on the register-row
// instance is not built, and is refused (cudaErrorNotSupported), here and
// in minsum_layered_config. template_only != 0 runs the one-lane template
// whatever the code, from `tables`.
int minsum_layered_launch(const void* chan, int chan_is_f32, float scale,
                          const void* info, int kb, void* hard, void* bits,
                          void* frame, void* iters, void* conv,
                          const void* tables, int B, int nb, int Z, int mb,
                          int E, int max_iter, int early_term, int qmax,
                          int beta, int alpha_num, int alpha_shift,
                          int star_deg, const int* thr, int nthr,
                          const ldpc::Mc* mc, const uint32_t* ptab,
                          int ptab_words, void* chan_q, int template_only,
                          void* stream) {
  const Params p = ldpc::make_params(
      chan, chan_is_f32, scale, info, kb, hard, bits, frame, iters, conv,
      tables, B, nb, Z, mb, E, max_iter, qmax, beta, alpha_num, alpha_shift,
      star_deg, thr, nthr);
  if (!template_only && !ptab) return int(cudaErrorInvalidValue);
  const int max_deg = ptab ? packed_max_degree(ptab, mb) : 0;
  const bool row = !template_only && is_row(nb, Z, E, max_deg, star_deg);
  if (template_only || (!row && !is_packed(nb, Z, E, star_deg)))
    return ldpc::launch_instance(
        kernels, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); },
        p, early_term, mc, stream);
  if (!packed_args_ok(ptab, ptab_words, nb, Z, mb, E, qmax, nthr))
    return int(cudaErrorInvalidValue);
  static thread_local PackedArgs a;   // 32 KB, off the stack; copied at launch
  a.p = p;
  if (mc) a.p.mc = *mc;
  memcpy(a.t.w, ptab, 4 * size_t(ptab_words));
  star_constants(p, a.star);
  a.chan_q = nullptr;
  if (row) {
    // the register-row instance: packed_tables' words as they are
    const OneLaneShape s = row_shape(nb, Z, E, max_deg);
    a.p.lanes = 1;
    const PackedKernel k =
        mc ? nullptr : layered_row(max_deg, star_deg > 0, early_term != 0);
    const cudaError_t err = prepare(k, s.smem);
    if (err != cudaSuccess) return int(err);
    if (B <= 0) return 0;
    k<<<dim3(B), dim3(Z), s.smem, static_cast<cudaStream_t>(stream)>>>(a);
    return int(cudaGetLastError());
  }
  const PackedShape s = layered_shape(nb, Z, E);
  if (layered_tab_words(nb, mb, E) > kTabWords ||
      2 * size_t(s.lanes) * (size_t(nb) + 1) * Z >= (size_t(1) << 21))
    return int(cudaErrorInvalidValue);
  a.p.lanes = s.lanes;
  uint32_t* const off = a.t.w + offsets_at(nb, mb, E);
  for (int e = 0; e < E; ++e) {
    const uint32_t w = ptab[mb + nb + 2 + e], shift = w & 0x7ffu;
    off[e] = (2 * uint32_t(s.lanes) * ((w >> 11) + shift)) << 11 | (Z - shift);
  }
  const PackedKernel k = packed_kernel(s.lpt, max_deg, star_deg > 0,
                                       early_term != 0, mc != nullptr);
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
