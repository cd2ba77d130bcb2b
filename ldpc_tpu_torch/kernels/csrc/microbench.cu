// Microbenchmarks of the decoders' building blocks on NVIDIA Hopper (sm_90a).
//
// Six kernels that answer, on this card, what the six Pallas microbenchmarks
// of scripts/microbench_rot.py and scripts/diag_gridstep.py ask of the TPU.
// Each computes what its Pallas body computes, bit for bit; the plain torch
// versions stand beside the wrappers in ldpc_tpu_torch/kernels/microbench.py.
//
//   sweep_kernel    replaces microbench_rot.py::make_sweep.kernel    (:69)
//   minsum_kernel   replaces microbench_rot.py::make_minsum.kernel   (:107)
//   int16_kernel    replaces microbench_rot.py::int16_test.kernel    (:197)
//   opchain_kernel  replaces microbench_rot.py::make_opchain.kernel  (:247)
//   grid32_kernel   replaces diag_gridstep.py::grid32.kernel         (:36)
//   grid1_kernel    replaces diag_gridstep.py::grid1.kernel          (:53)
//
// What bounds them on the H100: integer operations, never bytes. Each reads
// its int8 input once and writes its int8 output once, and between the two
// runs hundreds to millions of dependent integer steps on state that stays
// in shared memory (sweep, minsum) or in registers (the other four). That
// is the point: they time the instruction stream, the shared-memory
// exchange and the launch, with device memory out of the picture.
//
// sweep and minsum (S1, S2). The TPU bodies keep a (24, 27, Bt) int32 state
// in VMEM and rotate rows with concatenations, in two layouts that ask a
// sublane question. Here there is one layout and no rotation, the one the
// decoders' packed kernels take (csrc/cn_packed.cuh), so that S1 and S2 time
// the decoders' datapath without a decode around it:
//  * Thread (x, y) owns four codeword lanes (4x .. 4x + 3) of row y of every
//    base column (S1, S2's V phase) and of every base row (S2's C phase).
//    The state keeps the lane index innermost, so one shared access moves
//    the four lanes: an 8-byte word of int16 totals (16x2 pairs), a 4-byte
//    word of int8 channel values, a 16-byte (int32 messages) or 8-byte
//    (int16) word of messages. A circulant shift is the index (y + s) mod Z.
//    The block shape is the decoders' rule (block_shape: packed_shape of
//    cn_packed.cuh, copied): of the blocks of 4k lanes and kZ threads within
//    the launch bound, the fewest lanes that keep 9/10 of the most codewords
//    an SM holds.
//  * int16 totals. S1 only adds, so the low byte of its sum mod 2^16 is the
//    low byte of the sum mod 2^32 that XLA's int32 wrap leaves: the adds wrap
//    per half (__vadd2, never the saturating __vaddss2). In S2 a message lies
//    in [-qmax, qmax] (qmax <= 127, rows of degree >= 2), so a total stays
//    within 128 + 12 * 127 = 1,652 on columns of up to 12 entries: exact.
//  * The tables travel in the kernel's parameters (SweepArgs::t, the
//    constant bank) in the packed encoding of kernels/minsum.py::
//    packed_tables, (col * Z) << 11 | shift, with the slot of each entry: no
//    table load goes through shared memory. Unrolled at compile time: a
//    column runs the body of its exact degree (1..kColDeg, a switch on a
//    degree the whole block shares), its first two gathers loaded before
//    the previous column's store; a base row runs the body of its exact
//    degree (2..kRowDeg, the larger first), its totals loaded ahead in
//    kRowDeg slots. A circulant's row offset is the block's (col * Z + s)
//    less the thread's wrap. `base` is the same kernel on tables whose
//    shifts are 0.
//   sweep: dst[j][y] = chan[j][y] + the sum over the entries (j, s) of
//     column j of src[j][(y + s) mod Z], gathered by the thread that owns
//     dst[j][y]: no write is shared, one barrier a sweep, two totals buffers.
//   minsum: the reference adds rot(new, Z - s) into the next totals base row
//     by base row, which on threads would make the writer of dst[j][y]
//     change with the base row (a barrier a row). The same sums are taken as
//     the decoders take them: a C phase in which thread y updates check row
//     y of every base row (only it touches the messages of row y), a
//     barrier, and a V phase in which the owner of tot[j][y] gathers chan -
//     the sum of the negated messages n[e][(y - s) mod Z] (stored negated,
//     n = -c2v, as the decoders store them, so that v2c = tot + n is one
//     add): two barriers a sweep, no atomics, one totals buffer (the V phase
//     writes what the C phase has finished reading). Integer addition
//     commutes, so the totals are the reference's. The C phase reads a row
//     once: the clipped v2c of an entry
//     is one byte a lane (min(|v|, qmax) in 7 bits, the sign of v in bit 7),
//     so a row of up to kRowDeg entries sits in kRowDeg registers and the
//     emit computes the four lanes' new messages at once from them (SWAR on
//     bytes). The next row's totals are loaded before this row's stores (the
//     C phase writes no totals); its messages are not (below).
//     The script keys its message slots by (column, shift), so entries of
//     different base rows that share both share a slot (17 pairs in
//     wifi-648): the later row reads as its old message what the earlier row
//     wrote in the same sweep. That is what the body computes, so it is
//     kept: an entry reads its slot and writes its new message to its own
//     c2v[e], which the V phase reads, and where they differ to its slot.
//     Thread y alone touches c2v[.][y] in the C phase, base rows in order,
//     so the sharing needs no barrier. The check-node rule is the script's,
//     not the decoders': min2 starts at 1 << 14, the sign is bit 31 of the
//     XOR of the clipped values (a zero counts as positive), and the
//     excluded minimum is chosen by value (m == min1), not by position. Each
//     variant keeps its declared message width in shared memory, int32
//     (`minsum`) or int16 (`minsum16`): that is the question the pair asks.
//
// int16 (S3): the script's expression on packed pairs of int16 in one
// 32-bit register, with the SIMD-in-a-word intrinsics. jnp.abs wraps on
// int16 (|-32768| = -32768): that is __vabs2, not the saturating __vabsss2.
// `iters` > 1 feeds the result back as `a`, a dependent chain to time.
//
// opchain (S4): the script varies the operand's height at equal total work
// to see a per-op overhead. A thread has no operand height; its counterpart
// is instruction-level parallelism: template ILP = 1, 2, 4 independent
// elements a thread (rows Z, 2Z, 4Z of the same lanes), the chains kept in
// registers. |b - a| is the absolute value of a wrapped difference, and
// |INT_MIN| stays INT_MIN, as in XLA.
//
// grid32 / grid1 (S5, S6): the same step (grid_step: 400 dependent steps an
// element), run once with a block group a tile (grid.y = 32) and once with
// one block group that loops over the 32 tiles. On the TPU the grid runs in
// order, so the difference is a per-step overhead; here blocks run in
// parallel, so it is the price of serialising tiles inside a block against
// scheduling more blocks. What bounds both is integer issue: four
// operations a step, three of them on the chain (add, xor, max). grid32
// has 442,368 threads, enough warps to hide the chain's latency. grid1 has
// one thread a (row, column), 13,824 threads: one warp a scheduler at best,
// so a thread that walked its tiles one chain after another would wait on
// latency 12,800 times. Instead a thread runs kGroup tiles' chains at once,
// interleaved in registers (a ragged rest in groups of 8, 4, 2 and 1), the
// step loop unrolled on a count fixed at compile time (kInner; a second
// instance takes any other count), the next group's loads issued before
// this group's chains, in blocks of kGridThreads so that the 432 warps
// spread over every SM. With one warp a scheduler the floor is the ALU
// pipe's: nvcc makes a step VIADD (the FMA pipe: grid32 runs faster than
// three ALU instructions a step allow), LOP3 and VIADDMNMX (v - 3 and the
// max in one), two ALU instructions of two clocks a warp, 51,200 clocks a
// thread. On the H100 groups of 16 ran faster than groups of 4 or 8, and
// blocks of 32, 64 or 128 threads ran alike.
//
// Beside the six: empty_kernel, whose device time at a launch's grid is
// that launch's floor, and chain_probe_kernel, which times one thread's
// chain of S5/S6 steps or S4 pairs on the SM's clock (the latency that
// bounds S4's one element a thread).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;   // the 227 KB opt-in of sm_90

// The sweeps' block shapes: four lanes a thread, up to kSweepThreads
// threads a block (the launch bound), and the rule's view of an SM (its
// shared memory for blocks, the runtime's reserve per resident block, warps
// and blocks), as in csrc/cn_packed.cuh.
constexpr int kLanesPerThread = 4;
constexpr int kSweepThreads = 256;
constexpr int kSmSmem = 233472;
constexpr int kBlockReserve = 1024;
constexpr int kSmWarps = 64;
constexpr int kSmBlocks = 32;
constexpr int kRowDeg = 8;       // S2's register row: base rows of 2-8 entries
constexpr int kColDeg = 12;      // S1's and S2's unrolled columns: up to 12
constexpr int kTabWords = 960;   // table words in the parameters (< 4 KB)

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// uint32 words of the entry tables (kernels/microbench.py::graph_tables):
// layer_ptr[mb + 1], col_ptr[nb + 1], ent[E] = (col * Z) << 11 | shift by
// base row, col_ent[E] = (e * Z) << 11 | shift by base column, and
// slot[E] = slot(e) * Z by base row.
inline int table_words(int nb, int mb, int E) { return mb + nb + 2 + 3 * E; }

struct SweepTab {
  uint32_t w[kTabWords];
};

struct SweepArgs {
  const int8_t* chan;      // (nb, Z, B), B innermost
  int8_t* out;             // (nb, Z, B)
  int B, nb, Z, mb, E, lanes, iters, qmax;
  SweepTab t;
};
static_assert(sizeof(SweepArgs) <= 4096, "kernel parameters above 4 KB");

// Dynamic shared memory of a block of `lanes` codewords: sweep (c2v_bytes
// 0) two int16 totals buffers and the int8 channel; minsum (2, 4) one
// totals buffer, the channel and E * Z messages of c2v_bytes a lane.
inline size_t state_bytes(int nb, int Z, int E, int c2v_bytes, int lanes) {
  const size_t n = size_t(nb) * Z;
  return (c2v_bytes ? 1 : 2) * align16(2 * n * lanes) + align16(n * lanes)
       + align16(size_t(c2v_bytes) * E * Z * lanes);
}

struct Shape {
  int lanes, smem, blocks;   // blocks: resident an SM by this rule
};

// Of the blocks of 4k lanes (k * Z <= kSweepThreads threads, state within
// the opt-in), the fewest lanes that keep at least 9/10 of the most
// codewords an SM holds; lanes 0 when no block fits.
inline Shape block_shape(int nb, int Z, int E, int c2v_bytes) {
  int most = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k = 1; k * Z <= kSweepThreads; ++k) {
      const int lanes = k * kLanesPerThread;
      const size_t smem = state_bytes(nb, Z, E, c2v_bytes, lanes);
      if (smem > kMaxSmem) break;
      const int warps = (k * Z + 31) / 32;
      const int blocks = std::min({kSmSmem / int(smem + kBlockReserve),
                                   kSmWarps / warps, kSmBlocks});
      if (pass == 0) most = std::max(most, blocks * lanes);
      else if (10 * blocks * lanes >= 9 * most)
        return Shape{lanes, int(smem), blocks};
    }
  }
  return Shape{0, 0, 0};
}

// ---------------------------------------------------------------------------
// Words of four lanes (as csrc/cn_packed.cuh has them; copied, so that this
// library includes no header of the decoders).

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// int8 lanes 0, 1 (lo) or 2, 3 (hi) of w, sign-extended into 16x2 pairs.
__device__ __forceinline__ uint32_t widen_lo(uint32_t w) { return prmt(w, 0, 0x9180); }
__device__ __forceinline__ uint32_t widen_hi(uint32_t w) { return prmt(w, 0, 0xB3A2); }

// The low bytes of the four halves of lo (lanes 0, 1) and hi (lanes 2, 3);
// with 0x7531, the high bytes (each lane's sign in bit 7).
__device__ __forceinline__ uint32_t bytes_of(uint32_t lo, uint32_t hi,
                                             uint32_t sel = 0x6420) {
  return prmt(lo, hi, sel);
}

__device__ __forceinline__ uint32_t ld8x4(const int8_t* a) {
  return *reinterpret_cast<const uint32_t*>(a);
}

__device__ __forceinline__ uint2 ld16x4(const int16_t* a) {
  return *reinterpret_cast<const uint2*>(a);
}

__device__ __forceinline__ void st16x4(int16_t* a, uint32_t lo, uint32_t hi) {
  *reinterpret_cast<uint2*>(a) = make_uint2(lo, hi);
}

__device__ __forceinline__ unsigned smem_addr(const void* a) {
  return static_cast<unsigned>(__cvta_generic_to_shared(a));
}

// A message word of four lanes as two 16x2 pairs (a message fits a half).
__device__ __forceinline__ void ld_msg(const int32_t* a, uint32_t& lo,
                                       uint32_t& hi) {
  const uint4 v = *reinterpret_cast<const uint4*>(a);
  lo = prmt(v.x, v.y, 0x5410);
  hi = prmt(v.z, v.w, 0x5410);
}

__device__ __forceinline__ void ld_msg(const int16_t* a, uint32_t& lo,
                                       uint32_t& hi) {
  const uint2 v = ld16x4(a);
  lo = v.x;
  hi = v.y;
}

// The int8 lanes of w stored at the message width, sign-extended, as one
// vector store (which nvcc otherwise splits into 32-bit stores here).
__device__ __forceinline__ void st_msg(int32_t* a, uint32_t w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(smem_addr(a)), "r"(prmt(w, 0, 0x8880)),
                  "r"(prmt(w, 0, 0x9991)), "r"(prmt(w, 0, 0xAAA2)),
                  "r"(prmt(w, 0, 0xBBB3))
               : "memory");
}

__device__ __forceinline__ void st_msg(int16_t* a, uint32_t w) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};"
               :: "r"(smem_addr(a)), "r"(widen_lo(w)), "r"(widen_hi(w))
               : "memory");
}

// Rows of a circulant, in rows from the thread's own row y of base column
// 0: row (y + s) mod Z of the base column at row colZ (up), row (y - s)
// mod Z (down). The shift and colZ are the same for the whole block, so only
// the wrap is the thread's.
__device__ __forceinline__ int rot_up(int colZ, int s, int y, int Z) {
  return colZ + s - (y >= Z - s ? Z : 0);
}

__device__ __forceinline__ int rot_down(int colZ, int s, int y, int Z) {
  return colZ - s + (y < s ? Z : 0);
}

// The channel of the thread's four lanes at c (a vector load where the lanes
// are whole and aligned; 0 past the batch) and its int8 output.
__device__ __forceinline__ uint32_t load_lanes(const int8_t* c, int nvalid) {
  if (nvalid == 4 && (reinterpret_cast<uintptr_t>(c) & 3) == 0) return ld8x4(c);
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nvalid) w |= uint32_t(uint8_t(c[k])) << (8 * k);
  return w;
}

__device__ __forceinline__ void store_lanes(int8_t* o, uint32_t w, int nvalid) {
  if (nvalid == 4 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(o) = w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nvalid) o[k] = int8_t(w >> (8 * k));
}

// Where the thread's lanes are: its lane word x, row y; the first lane's
// batch index and how many of its four lanes lie in the batch.
struct Lanes {
  int row, lane0, nvalid;
  long long b0;
};

__device__ inline Lanes lanes_of(const SweepArgs& a) {
  Lanes l;
  l.row = threadIdx.y;
  l.lane0 = threadIdx.x * kLanesPerThread;
  l.b0 = (long long)blockIdx.x * a.lanes + l.lane0;
  l.nvalid = int(min(4LL, max(a.B - l.b0, 0LL)));
  return l;
}

// Channel in: chan [n][L] and the first totals tot = chan, row y of every
// base column.
__device__ inline void load_state(const SweepArgs& a, const Lanes& l,
                                  int8_t* chan, int16_t* tot) {
  const int L = a.lanes;
  for (int j = 0; j < a.nb; ++j) {
    const int v = j * a.Z + l.row;
    const uint32_t w =
        load_lanes(a.chan + size_t(v) * a.B + l.b0, l.nvalid);
    *reinterpret_cast<uint32_t*>(chan + v * L + l.lane0) = w;
    st16x4(tot + v * L + l.lane0, widen_lo(w), widen_hi(w));
  }
}

// The totals out as int8: their low byte, not a saturation; lanes past the
// batch are not written.
__device__ inline void store_state(const SweepArgs& a, const Lanes& l,
                                   const int16_t* tot) {
  for (int j = 0; j < a.nb; ++j) {
    const int v = j * a.Z + l.row;
    const uint2 t = ld16x4(tot + v * a.lanes + l.lane0);
    store_lanes(a.out + size_t(v) * a.B + l.b0, bytes_of(t.x, t.y),
                l.nvalid);
  }
}

// f(std::integral_constant<int, d>()) for the block's degree d, 2 <= d <= D:
// a body unrolled for each degree, the larger first.
template <int D, typename F>
__device__ __forceinline__ void with_degree(int d, F& f) {
  if (d == D) f(std::integral_constant<int, D>());
  else if constexpr (D > 2) with_degree<D - 1>(d, f);
}

// The gathers of slots 2 .. D - 1 of a base column of exact degree D added
// to (lo, hi); cw: the column's col_ent words.
template <int D, typename Gather>
__device__ __forceinline__ void add_slots(const uint32_t* cw, int j,
                                          uint32_t& lo, uint32_t& hi,
                                          Gather& gather) {
  uint2 v[D - 2];
#pragma unroll
  for (int i = 2; i < D; ++i) v[i - 2] = gather(j, cw[i]);
#pragma unroll
  for (int i = 0; i < D - 2; ++i) {
    lo = __vadd2(lo, v[i].x);
    hi = __vadd2(hi, v[i].y);
  }
}

// Every base column j of the thread's row: store(j, lo, hi) of chan[j]
// plus (S1) or minus (S2, whose messages are stored negated) the sum over
// column j's entries of gather(j, col_ent word), as 16x2 pairs. A column
// of degree d (1..kColDeg, the same for the whole block) runs a body
// unrolled for d; its first two gathers and its channel word are loaded
// before the previous column's store (what the gathers read, the stores
// never write).
template <bool SUB, typename Gather, typename Store>
__device__ __forceinline__ void column_pass(const uint32_t* tw, int o_col,
                                            int o_cent, int nb,
                                            const int8_t* chan_row, int ZL,
                                            Gather gather, Store store) {
  static_assert(kColDeg == 12, "the bodies below go up to 12 entries");
  uint2 g0, g1;
  uint32_t ch;
  int q0, d;
  auto head = [&](int j) {
    q0 = int(tw[o_col + j]);
    d = int(tw[o_col + j + 1]) - q0;
    ch = ld8x4(chan_row + j * ZL);
    g0 = gather(j, tw[o_cent + q0]);
    g1 = gather(j, tw[o_cent + q0 + min(1, d - 1)]);
  };
  head(0);
  for (int j = 0; j < nb; ++j) {
    uint32_t s_lo = __vadd2(g0.x, d > 1 ? g1.x : 0u);
    uint32_t s_hi = __vadd2(g0.y, d > 1 ? g1.y : 0u);
    const uint32_t* cw = tw + o_cent + q0;
    // columns of 1-3 entries, most of a code's, skip the switch's indirect
    // branch
    if (d == 3) {
      add_slots<3>(cw, j, s_lo, s_hi, gather);
    } else if (d > 3) switch (d) {
      case 4: add_slots<4>(cw, j, s_lo, s_hi, gather); break;
      case 5: add_slots<5>(cw, j, s_lo, s_hi, gather); break;
      case 6: add_slots<6>(cw, j, s_lo, s_hi, gather); break;
      case 7: add_slots<7>(cw, j, s_lo, s_hi, gather); break;
      case 8: add_slots<8>(cw, j, s_lo, s_hi, gather); break;
      case 9: add_slots<9>(cw, j, s_lo, s_hi, gather); break;
      case 10: add_slots<10>(cw, j, s_lo, s_hi, gather); break;
      case 11: add_slots<11>(cw, j, s_lo, s_hi, gather); break;
      case 12: add_slots<12>(cw, j, s_lo, s_hi, gather); break;
      default: break;
    }
    const uint32_t c_lo = widen_lo(ch), c_hi = widen_hi(ch);
    if (j + 1 < nb) head(j + 1);
    if constexpr (SUB) store(j, __vsub2(c_lo, s_lo), __vsub2(c_hi, s_hi));
    else store(j, __vadd2(c_lo, s_lo), __vadd2(c_hi, s_hi));
  }
}

__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const __grid_constant__ SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t* tw = a.t.w;
  const int L = a.lanes, Z = a.Z, nb = a.nb, ZL = Z * L;
  const size_t n = size_t(nb) * Z;
  const int o_col = a.mb + 1, o_cent = a.mb + nb + 2 + a.E;
  int16_t* src = reinterpret_cast<int16_t*>(smem);
  int16_t* dst = reinterpret_cast<int16_t*>(smem + align16(2 * n * L));
  int8_t* chan = reinterpret_cast<int8_t*>(smem + 2 * align16(2 * n * L));
  const Lanes l = lanes_of(a);
  const int row = l.row, own = row * L + l.lane0;   // the thread's word
  load_state(a, l, chan, src);
  __syncthreads();

  const int sweeps = 2 * (a.iters / 2);
  for (int it = 0; it < sweeps; ++it) {
    const int16_t* const src_t = src + own;
    int16_t* const dst_t = dst + own;
    column_pass<false>(
        tw, o_col, o_cent, nb, chan + own, ZL,
        [&](int j, uint32_t ce) {   // ce = (e * Z) << 11 | shift
          return ld16x4(src_t + rot_up(j * Z, int(ce & 0x7ffu), row, Z) * L);
        },
        [&](int j, uint32_t lo, uint32_t hi) {   // wraps, as int32 does
          st16x4(dst_t + j * ZL, lo, hi);
        });
    __syncthreads();
    int16_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  store_state(a, l, src);
}

// S2 with messages of type M (int32_t or int16_t) in shared memory, stored
// negated (n = -c2v, so v2c = tot + n is one add); base rows of 2..RD
// entries.
template <typename M, int RD>
__global__ void __launch_bounds__(kSweepThreads)
minsum_kernel(const __grid_constant__ SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t* tw = a.t.w;
  const int L = a.lanes, Z = a.Z, nb = a.nb, mb = a.mb, E = a.E;
  const int ZL = Z * L;
  const size_t n = size_t(nb) * Z;
  const int o_col = mb + 1, o_ent = mb + nb + 2, o_cent = o_ent + E;
  const int o_slot = o_cent + E;
  int16_t* tot = reinterpret_cast<int16_t*>(smem);
  int8_t* chan = reinterpret_cast<int8_t*>(smem + align16(2 * n * L));
  M* c2v = reinterpret_cast<M*>(smem + align16(2 * n * L) + align16(n * L));
  const Lanes l = lanes_of(a);
  const int row = l.row, own = row * L + l.lane0;   // the thread's word
  M* const msg_t = c2v + own;            // + eZ * L: entry (or slot) e
  const int16_t* const tot_t = tot + own;
  load_state(a, l, chan, tot);
  for (int e = 0; e < E; ++e) st_msg(msg_t + e * ZL, 0u);
  __syncthreads();

  const uint32_t q2 = uint32_t(a.qmax) * 0x00010001u;
  // The totals of base row li's entries at their rotated rows; slots past
  // its degree d (>= 2) repeat its last entry.
  auto row_totals = [&](int li, uint2 (&t)[RD]) {
    const int e0 = int(tw[li]), d = int(tw[li + 1]) - e0;
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      const uint32_t en = tw[o_ent + e0 + (i < 2 ? i : min(i, d - 1))];
      t[i] = ld16x4(tot_t + rot_up(int(en >> 11), int(en & 0x7ffu), row, Z) * L);
    }
  };

  const int sweeps = 2 * (a.iters / 2);
  for (int it = 0; it < sweeps; ++it) {
    // C phase: check row `row` of every base row, in order. A row's old
    // messages are loaded after the previous row's stores (a slot it shares
    // with an earlier row holds what that row wrote in this sweep); its
    // totals are loaded before them.
    uint2 t[RD];
    row_totals(0, t);
    for (int li = 0; li < mb; ++li) {
      const int e0 = int(tw[li]);
      // The row of exactly D entries: its old messages, the row in
      // registers, the next row's totals, the emit.
      auto check_row = [&](auto degree) {
        constexpr int D = decltype(degree)::value;
        int sz[D];                  // the entries' slots, times Z
        uint32_t o[D][2];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          sz[i] = int(tw[o_slot + e0 + i]);
          ld_msg(msg_t + sz[i] * L, o[i][0], o[i][1]);
        }
        uint32_t rb[D];             // the row: min(|v|, qmax) | sign(v) << 7
        uint32_t min1[2] = {0x40004000u, 0x40004000u};   // 1 << 14 a half
        uint32_t min2[2] = {0x40004000u, 0x40004000u};
        uint32_t ns = 0;            // bit 7 of each byte: the sign product
#pragma unroll
        for (int i = 0; i < D; ++i) {
          uint32_t m[2], raw[2];
          const uint32_t tt[2] = {t[i].x, t[i].y};
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            raw[k] = __vadd2(tt[k], o[i][k]);
            m[k] = __vmins2(__vmaxs2(raw[k], __vneg2(raw[k])), q2);
            min2[k] = __vmins2(min2[k], __vmaxs2(min1[k], m[k]));
            min1[k] = __vmins2(min1[k], m[k]);
          }
          rb[i] = bytes_of(m[0], m[1]) |
                  (bytes_of(raw[0], raw[1], 0x7531) & 0x80808080u);
          ns ^= rb[i];
        }
        if (li + 1 < mb) row_totals(li + 1, t);
        // Every byte at once: a lane whose |v| equals min1 takes min2
        // (both <= 127 on a row of degree >= 2), the others min1 (x <= 0x7f
        // is nonzero exactly when x + 0x7f sets bit 7; prmt's sign mode
        // replicates bit 7 over its byte); the new message is negative
        // where the product of the other entries' signs is, and is stored
        // negated, -m being (0x80 - m) ^ 0x80 a byte.
        const uint32_t m1 = bytes_of(min1[0], min1[1]);
        const uint32_t m2 = bytes_of(min2[0], min2[1]);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const uint32_t w = rb[i];
          const uint32_t x = (w & 0x7f7f7f7fu) ^ m1;
          const uint32_t ne = prmt(x + 0x7f7f7f7fu, 0, 0xBA98);
          const uint32_t mag = (m1 & ne) | (m2 & ~ne);
          const uint32_t sm = prmt(w ^ ns, 0, 0xBA98);
          const uint32_t negm = (0x80808080u - mag) ^ 0x80808080u;
          const uint32_t nw = (mag & sm) | (negm & ~sm);   // -new
          const int ez = (e0 + i) * Z;
          st_msg(msg_t + ez * L, nw);
          if (sz[i] != ez) st_msg(msg_t + sz[i] * L, nw);
        }
      };
      with_degree<RD>(int(tw[li + 1]) - e0, check_row);
    }
    __syncthreads();
    // V phase: the next totals, chan - the sum of the negated messages,
    // gathered by their owner.
    int16_t* const tot_w = tot + own;
    column_pass<true>(
        tw, o_col, o_cent, nb, chan + own, ZL,
        [&](int, uint32_t ce) {   // ce = (e * Z) << 11 | shift
          uint2 m;
          ld_msg(msg_t + rot_down(int(ce >> 11), int(ce & 0x7ffu), row, Z) * L,
                 m.x, m.y);
          return m;
        },
        [&](int j, uint32_t lo, uint32_t hi) {
          st16x4(tot_w + j * ZL, lo, hi);
        });
    __syncthreads();
  }
  store_state(a, l, tot);
}

// min(where(a < b, max(a, b), |a|), max(a, 3)) on two int16 a word.
__global__ void int16_kernel(const uint32_t* a, const uint32_t* b,
                             uint32_t* out, int n_words, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  uint32_t x = a[i];
  const uint32_t y = b[i];
  for (int it = 0; it < iters; ++it) {
    const uint32_t lt = __vcmplts2(x, y);          // 0xffff where a < b
    const uint32_t sel = (__vmaxs2(x, y) & lt) | (__vabs2(x) & ~lt);
    x = __vmins2(sel, __vmaxs2(x, 0x00030003u));
  }
  out[i] = x;
}

// One pair of S4's statements: a = |b - a|; b = min(b, max(a, b ^ a)).
__device__ __forceinline__ void opchain_pair(uint32_t& a, uint32_t& b) {
  const uint32_t d = b - a;                        // wraps, as XLA
  a = int32_t(d) < 0 ? 0u - d : d;                 // |INT_MIN| = INT_MIN
  b = uint32_t(min(int32_t(b), max(int32_t(a), int32_t(b ^ a))));
}

// a = x; b = a ^ 11; iters x n_pairs x opchain_pair on ILP independent
// elements a thread; element k of thread i is x[i + k * n_threads].
template <int ILP>
__global__ void opchain_kernel(const int8_t* x, int8_t* out, int n_threads,
                               int n_pairs, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_threads) return;
  uint32_t a[ILP], b[ILP];
#pragma unroll
  for (int k = 0; k < ILP; ++k) {
    a[k] = uint32_t(int(x[size_t(i) + size_t(k) * n_threads]));
    b[k] = a[k] ^ 11u;
  }
  for (int it = 0; it < iters; ++it) {
    for (int q = 0; q < n_pairs; ++q) {
#pragma unroll
      for (int k = 0; k < ILP; ++k) opchain_pair(a[k], b[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < ILP; ++k)
    out[size_t(i) + size_t(k) * n_threads] =
        static_cast<int8_t>(static_cast<uint8_t>(a[k]));
}

// One step of S5/S6: v = max(v ^ (v + 1), v - 3) in wrapping int32.
__device__ __forceinline__ uint32_t grid_step(uint32_t v) {
  const uint32_t p = v ^ (v + 1u);
  const uint32_t m = v - 3u;
  return int32_t(p) > int32_t(m) ? p : m;
}

// `inner` dependent steps.
__device__ inline uint32_t work(uint32_t v, int inner) {
  for (int i = 0; i < inner; ++i) v = grid_step(v);
  return v;
}

__device__ inline void work_tile(const int8_t* x, int8_t* out, int i,
                                 int tile, int tile_w, int n_tiles,
                                 int inner) {
  const size_t idx = size_t(i / tile_w) * (size_t(n_tiles) * tile_w)
                   + size_t(tile) * tile_w + (i % tile_w);
  out[idx] = static_cast<int8_t>(
      static_cast<uint8_t>(work(uint32_t(int(x[idx])), inner)));
}

// x, out (rows, n_tiles * tile_w) int8. grid = (ceil(rows * tile_w /
// threads), n_tiles): a block group a tile.
__global__ void grid32_kernel(const int8_t* x, int8_t* out, int rows,
                              int tile_w, int n_tiles, int inner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows * tile_w)
    work_tile(x, out, i, blockIdx.y, tile_w, n_tiles, inner);
}

constexpr int kGridThreads = 64;   // grid1's block: 216 blocks at (27, 512)
constexpr int kGroup = 16;         // grid1's tiles stepped at once a thread
constexpr int kInner = 400;        // the steps a tile of diag_gridstep.py

// G interleaved chains of `inner` steps; with INNER > 0 the count is
// INNER, fixed at compile time, so the loop unrolls with no remainder.
template <int INNER, int G>
__device__ __forceinline__ void chains(uint32_t (&v)[G], int inner) {
  const int n = INNER > 0 ? INNER : inner;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = grid_step(v[k]);
  }
}

// Tiles t .. t + G - 1 of a thread's element (x, out at its first tile):
// loaded, stepped together, stored.
template <int INNER, int G>
__device__ __forceinline__ void tile_group(const int8_t* __restrict__ x,
                                           int8_t* __restrict__ out,
                                           int tile_w, int t, int inner) {
  uint32_t v[G];
#pragma unroll
  for (int k = 0; k < G; ++k)
    v[k] = uint32_t(int(x[size_t(t + k) * tile_w]));
  chains<INNER, G>(v, inner);
#pragma unroll
  for (int k = 0; k < G; ++k)
    out[size_t(t + k) * tile_w] = static_cast<int8_t>(
        static_cast<uint8_t>(v[k]));
}

// The tiles from t on, fewer than 2G of them, in groups of G, G / 2, ... 1.
template <int INNER, int G>
__device__ __forceinline__ void tile_rest(const int8_t* __restrict__ x,
                                          int8_t* __restrict__ out,
                                          int tile_w, int t, int n_tiles,
                                          int inner) {
  if constexpr (G > 0) {
    if (n_tiles - t >= G) {
      tile_group<INNER, G>(x, out, tile_w, t, inner);
      t += G;
    }
    tile_rest<INNER, G / 2>(x, out, tile_w, t, n_tiles, inner);
  }
}

// grid = ceil(rows * tile_w / kGridThreads): one block group loops over the
// tiles, a thread a (row, column), kGroup tiles at a time.
template <int INNER>
__global__ void __launch_bounds__(kGridThreads)
grid1_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, int rows,
             int tile_w, int n_tiles, int inner) {
  const int i = blockIdx.x * kGridThreads + threadIdx.x;
  if (i >= rows * tile_w) return;
  const size_t at = size_t(i / tile_w) * (size_t(n_tiles) * tile_w)
                  + size_t(i % tile_w);
  x += at;
  out += at;
  const int full = n_tiles - n_tiles % kGroup;
  int8_t next[kGroup];
  if (full) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) next[k] = x[size_t(k) * tile_w];
  }
  for (int t = 0; t < full; t += kGroup) {
    uint32_t v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = uint32_t(int(next[k]));
    if (t + kGroup < full) {   // the next group's loads, ahead of the chains
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        next[k] = x[size_t(t + kGroup + k) * tile_w];
    }
    chains<INNER, kGroup>(v, inner);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      out[size_t(t + k) * tile_w] = static_cast<int8_t>(
          static_cast<uint8_t>(v[k]));
  }
  tile_rest<INNER, kGroup / 2>(x, out, tile_w, full, n_tiles, inner);
}

// No work: its device time at a launch's grid is the floor of that launch.
__global__ void empty_kernel() {}

// One thread's chain of kProbeLen links timed on the SM's clock: with PAIR
// a link is an S4 pair, else an S5/S6 step. in[0] a zero mask that makes
// the chain start after the first clock read, in[1] the start; per_link[0]
// the clock64() difference over kProbeLen, sink[0] the chain's value,
// stored before the second read.
constexpr int kProbeLen = 256;

template <bool PAIR>
__global__ void chain_probe_kernel(const int* in, double* per_link,
                                   int* sink) {
  const long long t0 = clock64();
  uint32_t v = uint32_t(in[1] ^ (int(t0) & in[0]));
  uint32_t b = v ^ 11u;
#pragma unroll
  for (int i = 0; i < kProbeLen; ++i) {
    if constexpr (PAIR) opchain_pair(v, b);
    else v = grid_step(v);
  }
  *static_cast<volatile int*>(sink) = int(v ^ b);
  const long long dt = clock64() - t0;
  per_link[0] = double(dt) / kProbeLen;
}

constexpr int kThreads = 128;   // block size of the other register kernels

// Whether the tables' degrees fit the instances: columns of 1..kColDeg
// entries, and for minsum base rows of 2..kRowDeg (a row of one entry would
// emit min2's start value, which no byte holds).
inline bool degrees_ok(const uint32_t* tab, int nb, int mb, bool rows) {
  for (int i = 0; i < mb && rows; ++i) {
    const int d = int(tab[i + 1] - tab[i]);
    if (d < 2 || d > kRowDeg) return false;
  }
  for (int j = 0; j < nb; ++j) {
    const int d = int(tab[mb + 2 + j] - tab[mb + 1 + j]);
    if (d < 1 || d > kColDeg) return false;
  }
  return true;
}

// Sets an instance's shared-memory attributes (the dynamic shared memory it
// launches with, the largest carveout) before a launch or a query.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// The checks of a sweep launch, the tables (host memory, `words` uint32)
// into the parameters, and the launch of a block of p.lanes codewords
// (p.lanes / 4 x Z threads) for every p.lanes of the batch.
template <typename K>
int launch_sweep(K kernel, SweepArgs& p, const uint32_t* tab, int words,
                 int c2v_bytes, void* stream) {
  const int k = p.lanes / kLanesPerThread;
  if (p.lanes < kLanesPerThread || p.lanes % kLanesPerThread || p.Z < 1
      || p.Z > 2047 || k * p.Z > kSweepThreads || p.B < 1 || p.nb < 1
      || p.mb < 1)
    return int(cudaErrorInvalidConfiguration);
  if (!tab || words != table_words(p.nb, p.mb, p.E) || words > kTabWords
      || size_t(p.E) * p.Z >= (size_t(1) << 21)
      || size_t(p.nb) * p.Z >= (size_t(1) << 21)
      || !degrees_ok(tab, p.nb, p.mb, c2v_bytes != 0)
      || (c2v_bytes && (p.qmax < 0 || p.qmax > 127)))
    return int(cudaErrorInvalidValue);
  memcpy(p.t.w, tab, sizeof(uint32_t) * size_t(words));
  const size_t smem = state_bytes(p.nb, p.Z, p.E, c2v_bytes, p.lanes);
  if (smem > kMaxSmem) return int(cudaErrorInvalidConfiguration);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 block(k, p.Z);
  const unsigned grid = unsigned((p.B + p.lanes - 1) / p.lanes);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// Registers a thread and resident blocks an SM of an instance at a shape
// (-1 where the runtime cannot say).
template <typename K>
void query(K kernel, const Shape& s, int Z, int* regs, int* resident) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) == cudaSuccess) *regs = fa.numRegs;
  int blocks = 0;
  if (s.lanes && prepare(kernel, size_t(s.smem)) == cudaSuccess
      && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kernel, s.lanes / kLanesPerThread * Z, size_t(s.smem))
             == cudaSuccess)
    *resident = blocks;
  cudaGetLastError();   // a failed query leaves no error behind
}

}  // namespace

extern "C" {

const char* microbench_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The block of a sweep (c2v_bytes 0) or minsum (2, 4) launch by the shape
// rule: shape[0] lanes a block, [1] dynamic shared-memory bytes, [2] blocks
// an SM by the rule, [3] blocks an SM by the occupancy API and [4]
// registers a thread of the instance (both -1 where the runtime cannot
// say). Returns cudaErrorInvalidValue for another c2v_bytes.
int microbench_config(int nb, int Z, int E, int c2v_bytes, int* shape) {
  if (c2v_bytes != 0 && c2v_bytes != 2 && c2v_bytes != 4)
    return int(cudaErrorInvalidValue);
  const Shape s = block_shape(nb, Z, E, c2v_bytes);
  shape[0] = s.lanes;
  shape[1] = s.smem;
  shape[2] = s.blocks;
  shape[3] = shape[4] = -1;
  if (c2v_bytes == 0) query(sweep_kernel, s, Z, &shape[4], &shape[3]);
  else if (c2v_bytes == 4)
    query(minsum_kernel<int32_t, kRowDeg>, s, Z, &shape[4], &shape[3]);
  else
    query(minsum_kernel<int16_t, kRowDeg>, s, Z, &shape[4], &shape[3]);
  return 0;
}

// Every launch runs on `stream` and returns cudaGetLastError() (0 on
// success); chan and out are device pointers, tables a host array of
// `words` uint32 (graph_tables).

int microbench_sweep_launch(const void* chan, void* out, const void* tables,
                            int words, int B, int nb, int Z, int mb, int E,
                            int lanes, int iters, void* stream) {
  SweepArgs p{static_cast<const int8_t*>(chan), static_cast<int8_t*>(out),
              B, nb, Z, mb, E, lanes, iters, 0, {}};
  return launch_sweep(sweep_kernel, p,
                      static_cast<const uint32_t*>(tables), words, 0, stream);
}

int microbench_minsum_launch(const void* chan, void* out, const void* tables,
                             int words, int B, int nb, int Z, int mb, int E,
                             int lanes, int iters, int qmax, int c2v_bytes,
                             void* stream) {
  SweepArgs p{static_cast<const int8_t*>(chan), static_cast<int8_t*>(out),
              B, nb, Z, mb, E, lanes, iters, qmax, {}};
  const uint32_t* tab = static_cast<const uint32_t*>(tables);
  if (c2v_bytes == 4)
    return launch_sweep(minsum_kernel<int32_t, kRowDeg>, p, tab,
                        words, 4, stream);
  if (c2v_bytes == 2)
    return launch_sweep(minsum_kernel<int16_t, kRowDeg>, p, tab,
                        words, 2, stream);
  return int(cudaErrorInvalidValue);
}

int microbench_int16_launch(const void* a, const void* b, void* out,
                            int n_words, int iters, void* stream) {
  if (n_words < 1) return int(cudaErrorInvalidValue);
  int16_kernel<<<(n_words + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n_words, iters);
  return int(cudaGetLastError());
}

int microbench_opchain_launch(const void* x, void* out, int n_elems, int ilp,
                              int n_pairs, int iters, void* stream) {
  if (n_elems < 1 || ilp < 1 || n_elems % ilp)
    return int(cudaErrorInvalidValue);
  const int n_threads = n_elems / ilp;
  const int grid = (n_threads + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  if (ilp == 1)
    opchain_kernel<1><<<grid, kThreads, 0, st>>>(xi, oi, n_threads, n_pairs, iters);
  else if (ilp == 2)
    opchain_kernel<2><<<grid, kThreads, 0, st>>>(xi, oi, n_threads, n_pairs, iters);
  else if (ilp == 4)
    opchain_kernel<4><<<grid, kThreads, 0, st>>>(xi, oi, n_threads, n_pairs, iters);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

int microbench_grid32_launch(const void* x, void* out, int rows, int tile_w,
                             int n_tiles, int inner, void* stream) {
  if (rows < 1 || tile_w < 1 || n_tiles < 1 || n_tiles > 65535)
    return int(cudaErrorInvalidValue);
  const dim3 grid((rows * tile_w + kThreads - 1) / kThreads, n_tiles);
  grid32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), rows, tile_w,
      n_tiles, inner);
  return int(cudaGetLastError());
}

int microbench_grid1_launch(const void* x, void* out, int rows, int tile_w,
                            int n_tiles, int inner, void* stream) {
  if (rows < 1 || tile_w < 1 || n_tiles < 1
      || int64_t(rows) * tile_w > INT32_MAX - kGridThreads)
    return int(cudaErrorInvalidValue);
  const int grid = (rows * tile_w + kGridThreads - 1) / kGridThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  if (inner == kInner)
    grid1_kernel<kInner><<<grid, kGridThreads, 0, st>>>(xi, oi, rows, tile_w,
                                                       n_tiles, inner);
  else
    grid1_kernel<0><<<grid, kGridThreads, 0, st>>>(xi, oi, rows, tile_w,
                                                  n_tiles, inner);
  return int(cudaGetLastError());
}

int microbench_empty_launch(int grid_x, int grid_y, int threads,
                            void* stream) {
  if (grid_x < 1 || grid_y < 1 || grid_y > 65535 || threads < 1
      || threads > 1024)
    return int(cudaErrorInvalidValue);
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

// One thread of chain_probe_kernel<pair != 0>; in int[2], per_link one
// double, sink one int32, all device pointers.
int microbench_chain_probe_launch(const void* in, void* per_link, void* sink,
                                  int pair, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(in);
  double* c = static_cast<double*>(per_link);
  int* s = static_cast<int*>(sink);
  if (pair) chain_probe_kernel<true><<<1, 1, 0, st>>>(i, c, s);
  else chain_probe_kernel<false><<<1, 1, 0, st>>>(i, c, s);
  return int(cudaGetLastError());
}

}  // extern "C"
