// Fixed-point layered min-sum decoders for codewords too long for the
// on-chip kernels (minsum_layered.cu), for NVIDIA Hopper (sm_90a). Three
// kernels, one library; all bit-exact with
// golden.decoder.decode_fixed(schedule="layered") and with the plain torch
// version beside the wrapper (ldpc_tpu_torch/ops/decode_qc.py).
//
// Replaces the five kernels of ldpc_tpu/kernels/minsum_stream.py::
// make_stream_decoder: `kernel` (K6b, run-time layer tables) and
// `kernel_static` (K6c, tables unrolled; both: posteriors and messages in
// device memory), `kernel_resident` (K6d: posteriors on chip),
// `kernel_resident_et` (K6e: K6d with per-lane early termination) and
// `kernel_stream_et` (K6f: K6b/c with early termination and only the hard
// bits on chip). They are one computation, the layer update `_layer_cn`, in
// five memory schedules.
//
// 1. stream_pipelined_kernel<DMAX, ET> (instances `stream-pipelined`,
//    `stream-pipelined-et`): K6b/K6c and K6f as the route takes them, for
//    codes whose rows fit its 8-entry register row, and for rows up to 32
//    (register rows of 24, 28 and 32 entries) where no block of the packed
//    resident kernel (3.) fits (DVB-S2 n=64,800: 129,600 B of int16
//    posteriors; rate 1/2: 631 circulants, 90 layers of Z = 360 rows of
//    degree 7 or 8; rate 8/9: 541 circulants, 20 layers of rows of 27 or
//    28; minsum_stream.py::instance_auto).
//
//    What bounds it on the H100. Not bytes: 1,024 such codewords at 20
//    iterations move 9.30 GB of int8 messages, 2.8 ms at 3.35 TB/s, and the
//    132 codewords in flight hold 34 MB, less than the 50 MB L2. Each
//    codeword is 20 x 90 = 1,800 dependent layer steps with a block barrier
//    between them, and one codeword fills an SM's shared memory, so an SM
//    has 360 threads (12 warps) to issue from: the kernel is bound by the
//    instructions a layer step issues and by the latency of the step's
//    chain (table loads, posterior loads, the min1/min2 merge, the emit, the
//    barrier). The template below also read each layer's messages from
//    device memory on that chain.
//
//    Design. One block of Z threads decodes one codeword (grid = batch);
//    thread y owns check row y of every base row. The posteriors sit in
//    shared memory for the whole decode. A layer's old messages do not
//    depend on the layer before (they were written one iteration earlier),
//    so each thread copies its own row's messages for layer step t +
//    kRingAhead into a ring of kRingStages slots in shared memory with
//    cp.async (LDGSTS), and waits for step t's copy with
//    cp.async.wait_group: a thread reads only its own rows, so nothing else
//    guards the ring. The first iteration takes old = 0 and copies nothing,
//    so the scratch needs no zeroing. A layer step is straight-line code
//    for its row degree (a body for each degree 2-8, and for 27 and 28 in
//    the 28-entry register row; other rows of the 24-, 28- and 32-entry
//    rows keep a run-time guard an entry, under a launch bound of 512
//    threads (128 registers) at 24, 384 (168) at 28, which one block an SM
//    of 360 threads leaves free anyway, and 256 (255) at 32): the tables
//    (layer_ptr, base2, thr) ride in the kernel's parameters, read with
//    uniform loads (ULDC) in the bodies of degree 2-8 and with constant
//    loads (LDC) in the longer rows; the row's v2c values and posterior
//    addresses stay in registers between the reduction and the emit; the
//    new messages leave in one coalesced store a thread that nothing in
//    the same iteration reads back. The
//    block's barrier is split (an mbarrier): a thread arrives when its
//    posterior writes are done and waits only before its next posterior
//    read, so its next step's ring read, table loads and addresses overlap
//    the wait. Messages are stored as int8, DMAX bytes a row (on rows of
//    27-28, 28-byte rows in seven 4-byte copies beat 32-byte rows, and a
//    reduce pass with an emit pass that reads the posteriors again lost to
//    the register row: PERF.md section 6). (One uint32
//    word a check row, min1o, min2o, the position of a minimum and a sign
//    an entry, halves those bytes; it was built and timed, and lost at
//    every shape: the kernel is bound by issued instructions, and the
//    word's rebuild costs more than the bytes save.) Early termination
//    checks the resident posteriors' signs: the block votes with
//    __syncthreads_or every kSyndromeChunk layers, so an unconverged
//    codeword stops the check at the first unsatisfied chunk, and a block
//    that finishes frees its SM for the next codeword.
//
// 2. minsum_stream_kernel<RESIDENT, ET> (instances `stream`,
//    `stream-resident`, `stream-resident-et`, `stream-et`; K6b/K6c, K6d, K6e,
//    K6f): the template the library began with, which the route keeps for
//    the codes no other kernel takes: posteriors and messages in device
//    memory (K6b/K6c, K6f: forced, `resident=False`, or rows longer than
//    32, or of 29-32 at Z above 256), and the posteriors in shared memory
//    (K6d, K6e) for the codes no block of the packed resident kernel (3.)
//    takes (n=64,800: 129,600 B of posteriors a lane).
//    One block owns one whole codeword, thread y check row y; the state is
//    codeword major with the row index innermost,
//      post int16 [B][nb * Z]   (device memory; shared memory when RESIDENT)
//      c2v  int8  [B][E * Z]    (device memory)
//    so a circulant shift is index arithmetic and a warp's accesses are
//    contiguous but for the wrap. One layer: the thread reads its row twice
//    (reduce with CnRow::add, then emit; the second read hits the L1),
//    writes c2v = new and post += new - old, and all threads meet at
//    __syncthreads(). No ring, no forward table: the caches and the other
//    blocks of the SM hide what latency they can. Early termination keeps one
//    hard-bit byte a variable in shared memory when the posteriors stream
//    (K6f's int8 hard-bit state).
//
// 3. resident_packed_kernel<LPT, ET> (instances `stream-resident`,
//    `stream-resident-et` wherever its block fits; K6d, K6e): the
//    posteriors of LPT = 2 or 4 codeword lanes on chip for the whole decode,
//    each layer's messages copied in ahead, the check row on packed lanes.
//
//    What bounds it on the H100. NR BG1 Z=384 (24 base rows of degree 5-7
//    and 21-22, 206 circulants) at B = 1,024 and 20 iterations needs 1.94e10
//    integer operations (12 an edge: 0.29 ms at the data sheet's 67e12/s)
//    and moves 3.24 GB
//    of int8 messages (0.97 ms at 3.35 TB/s if none stays in L2). The
//    template's one lane a thread issues every min, sign and offset once a
//    codeword, loads two table words an entry from shared memory, reads
//    each layer's messages from device memory on the step's dependent chain
//    and meets a full barrier a layer, in two 384-thread blocks an SM.
//
//    Design. One block decodes LPT codeword lanes; thread y owns check row y
//    of every base row for all of them (blockDim = Z), with the lane index
//    innermost as in the packed on-chip kernels (cn_packed.cuh):
//      post int16 [n][LPT]      shared memory, 16x2 pairs (ld16/st16)
//      msg  4-byte words        device memory, (block, word, row): a base
//                               row of d entries has ceil(d LPT / 4) words,
//                               EPW = 4 / LPT entries a word, negated
//    so a warp's message access is 128 contiguous bytes, and the row is
//    computed by PackedRow/PackedEmit, two lanes an instruction. The tables
//    (layer_ptr, each row's first word, each entry's posterior byte offset)
//    ride in the parameters and are read with uniform loads. Each thread
//    copies its own words of layer step t + kResidentAhead into a ring of
//    kResidentStages stages in shared memory with cp.async and waits for
//    step t's with cp.async.wait_group; the block's barrier between steps
//    is the pipelined kernel's split mbarrier. A row of up to kResidentRow
//    entries sits in registers (groups of four slots, a group past the
//    degree skipped); a longer row (NR BG1's 21-22, DVB-S2 rate 8/9's
//    27-28) is reduced in one pass and emitted in a second that reads its
//    posteriors and ring words again from shared memory. Early termination
//    checks the resident posteriors' signs in packed form: the block
//    votes every kResidentVote base rows which lanes have an unsatisfied
//    row (an OR into a shared word between two barriers, so no thread ORs
//    into it before every thread has read it) and stops once every running
//    lane has one; a lane writes its outputs at
//    its first success and runs on unread; __syncthreads_or lets the block
//    leave once every lane is done. Lanes past the batch are masked in their
//    data, never in their barriers. The wrapper picks LPT by the batch
//    (minsum_stream.py::resident_lanes): four lanes halve the instructions
//    a codeword, two keep twice the blocks (B = 256 is 64 blocks of four on
//    132 SMs).
//
// All: a base row has at most one circulant per base column, so within a
// layer every address is read and written by one thread only (no atomics);
// state 0 (the channel) is checked under early termination, a codeword whose
// hard bits satisfy every check is done (its hard bits latch at the first
// success) and iters counts the iterations it ran; indices into the batch's
// state are size_t (B * E * Z passes 2^31 at B >= 9,455 for n = 64,800).

#include <string.h>

#include "cn_minsum.cuh"
#include "cn_packed.cuh"

namespace {

using ldpc::align16;
using ldpc::Params;

struct StreamParams {
  Params p;        // chan int8 (B, n); hard (B, n); iters, conv (B,)
  int16_t* post;   // scratch (B, n), unused when the posteriors are resident
  int8_t* c2v;     // scratch (B, E * Z)
};

inline size_t smem_bytes(int nb, int Z, int mb, int E, bool resident, bool et) {
  const size_t n = size_t(nb) * Z;
  return align16(4 * size_t(ldpc::table_words(nb, mb, E)))
       + align16(4)                                   // the syndrome flag
       + (resident ? align16(2 * n) : 0)              // post
       + (!resident && et ? align16(n) : 0);          // hard bits
}

// Whether one codeword's block fits 1024 threads and the shared-memory opt-in.
inline bool block_fits(int nb, int Z, int mb, int E, bool resident, bool et) {
  return Z > 0 && Z <= ldpc::kMaxThreads
      && smem_bytes(nb, Z, mb, E, resident, et) <= size_t(ldpc::kMaxSmem);
}

// 1 when check row `row` of some base row is unsatisfied; sign(v) is an int
// whose sign bit is the hard bit of variable v of the block's codeword.
template <typename Sign>
__device__ inline int rows_unsat(const ldpc::Tables& t, int mb, int Z, int row,
                                 Sign sign) {
  int unsat = 0;
  for (int li = 0; li < mb; ++li) {
    int x = 0;
    for (int e = t.layer_ptr[li]; e < t.layer_ptr[li + 1]; ++e) {
      int c = row + t.ent_shift[e];
      if (c >= Z) c -= Z;
      x ^= sign(t.ent_col[e] * Z + c);
    }
    unsat |= x < 0;
  }
  return unsat;
}

template <bool RESIDENT, bool ET>
__global__ void minsum_stream_kernel(StreamParams sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = sp.p;
  const int Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const int n = nb * Z;
  const int T = ldpc::table_words(nb, mb, E);
  constexpr bool HARD = !RESIDENT && ET;   // the hard-bit bytes exist

  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  unsigned char* cursor = smem + align16(4 * size_t(T));
  // Fixed form: the final syndrome's unsatisfied flag. ET: the flag stamp.
  int32_t* s_flag = reinterpret_cast<int32_t*>(cursor);
  cursor += align16(4);
  int16_t* post_s = reinterpret_cast<int16_t*>(cursor);
  uint8_t* hs = cursor;   // the hard-bit bytes, where HARD

  const int row = threadIdx.x;   // blockDim.x == Z
  const size_t b = blockIdx.x;   // gridDim.x == B

  for (int i = row; i < T; i += Z) tab[i] = p.tables[i];
  if (row == 0) *s_flag = ET ? -1 : 0;
  const ldpc::Tables t = ldpc::tables_at(tab, nb, mb, E);

  int16_t* post = RESIDENT ? post_s : sp.post + b * n;
  int8_t* c2v = sp.c2v + b * E * Z;
  const int8_t* chan = static_cast<const int8_t*>(p.chan) + b * n;
  const int qmax = p.qmax;

  // Channel in: this thread owns row `row` of every base column.
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    const int q = chan[v];
    post[v] = int16_t(q);
    if (HARD) hs[v] = uint8_t(q < 0);
  }
  __syncthreads();

  auto sign = [&](int v) { return HARD ? -int(hs[v]) : int(post[v]); };

  // done and iters are the same in every thread of the block.
  bool done = false;
  int iters = 0;
  if (ET) {
    // State 0, the channel: done with iters = 0 if it is a codeword.
    if (rows_unsat(t, mb, Z, row, sign)) *s_flag = 0;
    __syncthreads();
    done = *s_flag != 0;
  }
  for (int it = 0; it < p.max_iter && !done; ++it) {
    const bool first = it == 0;   // every message is still 0: not loaded
    for (int li = 0; li < mb; ++li) {
      const int e0 = t.layer_ptr[li], e1 = t.layer_ptr[li + 1];
      ldpc::CnRow cn;
      for (int e = e0; e < e1; ++e) {
        int c = row + t.ent_shift[e];
        if (c >= Z) c -= Z;
        const int old = first ? 0 : int(c2v[size_t(e) * Z + row]);
        cn.add(int(post[t.ent_col[e] * Z + c]) - old, qmax);
      }
      cn.finish(p);
      for (int e = e0; e < e1; ++e) {
        int c = row + t.ent_shift[e];
        if (c >= Z) c -= Z;
        const size_t idx = size_t(e) * Z + row;
        const int pidx = t.ent_col[e] * Z + c;
        const int old = first ? 0 : int(c2v[idx]);
        const int pv = post[pidx];
        const int nw = cn.emit(pv - old, qmax);
        const int npv = pv + nw - old;
        c2v[idx] = int8_t(nw);
        post[pidx] = int16_t(npv);
        if (HARD) hs[pidx] = uint8_t(npv < 0);
      }
      // Orders this layer's writes, to shared and to device memory, before
      // the next layer's reads by the other threads of the block.
      __syncthreads();
    }
    if (ET) {
      // State it + 1: stamp the flag when a row is unsatisfied.
      if (rows_unsat(t, mb, Z, row, sign)) *s_flag = it + 1;
      __syncthreads();
      iters = it + 1;
      done = *s_flag != it + 1;
    }
  }

  // Hard bits from the final (for ET: latched) posteriors; the fixed form
  // takes the syndrome here.
  uint8_t* hard = p.hard + b * n;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    hard[v] = uint8_t(post[v] < 0);
  }
  if (!ET) {
    if (rows_unsat(t, mb, Z, row, sign)) *s_flag = 1;
    __syncthreads();
  }
  if (row == 0) {
    p.iters[b] = ET ? iters : p.max_iter;
    p.conv[b] = ET ? done : *s_flag == 0;
  }
}

// ---------------------------------------------------------------------------
// The pipelined kernel (1. above).

constexpr int kRingAhead = 2;                  // layer steps copied in ahead
constexpr int kRingStages = kRingAhead + 1;    // step t's slot: t mod stages
constexpr int kRingTabWords = 4096;            // uint32 table words (params)
constexpr int kSyndromeChunk = 8;              // layers between block votes

// Entry tables (uint32), by base row: layer_ptr[mb + 1], then base2[E] =
// 2 (col * Z + shift) and thr[E] = Z - shift, so that row `row`'s variable
// of entry e sits at byte 2 row + base2[e] of the posteriors, less 2 Z when
// row >= thr[e]. kernels/minsum_stream.py::pipelined_tables builds them.
struct RingArgs {
  Params p;           // chan int8 (B, n); hard (B, n); iters, conv (B,)
  unsigned char* msg; // scratch (B, mb, Z, row bytes)
  uint32_t tab[kRingTabWords];
};
static_assert(sizeof(RingArgs) <= 32764, "kernel parameters above 32,764 B");

// The register row of the instance a largest base-row degree takes; 0: none.
inline int pipelined_dmax(int max_deg) {
  return max_deg <= 8 ? 8 : max_deg <= 24 ? 24 : max_deg <= 28 ? 28
       : max_deg <= 32 ? 32 : 0;
}

// The threads a block of the register row's instance may have (its
// __launch_bounds__: 64 registers a thread at 1024, 128 at 512, 168 at 384,
// which holds Z = 360 and NR's 384; the 32-entry row spilled there with
// early termination, and keeps 255 registers at 256).
__host__ __device__ constexpr int pipelined_threads(int dmax) {
  return dmax <= 8 ? 1024 : dmax <= 24 ? 512 : dmax <= 28 ? 384 : 256;
}

// The posteriors, the ring (kRingStages layer steps of Z rows of DMAX int8
// messages) and the block's mbarrier.
inline size_t pipelined_smem(int nb, int Z, int dmax) {
  return align16(2 * size_t(nb) * Z)                       // posteriors
       + align16(size_t(kRingStages) * Z * dmax)           // the ring
       + 16;                                               // the mbarrier
}

// Whether a block takes the code: the register row, threads, a ring that
// does not wrap onto the step it feeds, the tables, the shared memory.
inline bool pipelined_fits(int nb, int Z, int mb, int E, int max_deg) {
  const int dmax = pipelined_dmax(max_deg);
  return dmax > 0 && Z > 0 && Z <= pipelined_threads(dmax)
      && mb > kRingAhead && mb + 1 + 2 * E <= kRingTabWords
      && pipelined_smem(nb, Z, dmax) <= size_t(ldpc::kMaxSmem);
}

inline int table_max_degree(const uint32_t* tab, int mb) {
  int d = 0;
  for (int l = 0; l < mb; ++l) {
    const int dl = int(tab[l + 1] - tab[l]);
    if (dl > d) d = dl;
  }
  return d;
}

template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8, 16 B");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The posterior of row `row` of entry e (tables above); `post` is the
// byte address of the posteriors in shared memory.
__device__ __forceinline__ int post_offset(const uint32_t* __restrict__ base2,
                                           const uint32_t* __restrict__ thr,
                                           int e, int row, int row2, int Z2) {
  int a = row2 + int(base2[e]);
  if (row >= int(thr[e])) a -= Z2;
  return a;
}

__device__ __forceinline__ int16_t& post_at(unsigned char* post, int a) {
  return *reinterpret_cast<int16_t*>(post + a);
}

// The block's mbarrier in shared memory (its shared-window address): a
// phase completes when every thread of the block has arrived; arrive has
// release and try_wait acquire semantics for the block.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n"
               " mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile("{\n .reg .pred p;\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}"
               : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Whether some check row of the codeword is unsatisfied by the signs of the
// resident posteriors; the block votes every kSyndromeChunk base rows and
// stops at the first chunk that holds one (every thread returns the same,
// after a barrier).
__device__ __forceinline__ bool block_unsat(const uint32_t* __restrict__ tw,
                                            unsigned char* post, int mb,
                                            int E, int Z, int row) {
  const uint32_t* __restrict__ base2 = tw + mb + 1;
  const uint32_t* __restrict__ thr = base2 + E;
  for (int l0 = 0; l0 < mb; l0 += kSyndromeChunk) {
    const int l1 = min(l0 + kSyndromeChunk, mb);
    int unsat = 0;
    for (int l = l0; l < l1; ++l) {
      int x = 0;
      for (int e = int(tw[l]); e < int(tw[l + 1]); ++e)
        x ^= int(post_at(post, post_offset(base2, thr, e, row, 2 * row,
                                           2 * Z)));
      unsat |= x < 0;
    }
    if (__syncthreads_or(unsat)) return true;
  }
  return false;
}

// PTX prmt.b32 (default mode): byte i of the result is byte (nibble i & 7)
// of b:a, or that byte's sign replicated when the nibble's bit 3 is set.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// The old message k of a row: byte k of the int8 row (prmt with the byte's
// sign replicated).
__device__ __forceinline__ int old_message(const uint32_t* wv, int k) {
  const uint32_t b = k % 4;
  return int(prmt(wv[k / 4], 0u, (8u | b) * 0x1110u | b));
}

// A row degree known to the compiler; `guard`: the register row may hold
// fewer entries, counted at run time.
template <int N, bool G = false>
struct Deg {
  static constexpr int value = N;
  static constexpr bool guard = G;
};

// Four int8 messages (the low bytes of a, b, c, d) as one word.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return prmt(prmt(uint32_t(a), uint32_t(b), 0x0040u),
              prmt(uint32_t(c), uint32_t(d), 0x0040u), 0x5410u);
}

template <int DMAX, bool ET>
__global__ void __launch_bounds__(pipelined_threads(DMAX))
stream_pipelined_kernel(const __grid_constant__ RingArgs a) {
  static_assert(DMAX % 4 == 0, "whole words a row");
  constexpr int W = DMAX;                   // bytes a check row
  // bytes a cp.async and a store (a row of 28 bytes: seven words)
  constexpr int CP = W % 8 == 0 ? 8 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = a.p;
  const uint32_t* __restrict__ tw = a.tab;
  const int Z = p.Z, nb = p.nb, mb = p.mb, E = p.E, qmax = p.qmax;
  const uint32_t* __restrict__ base2 = tw + mb + 1;
  const uint32_t* __restrict__ thr = base2 + E;
  const int n = nb * Z;
  const int row = threadIdx.x;      // blockDim.x == Z
  const int row2 = 2 * row, Z2 = 2 * Z;
  const size_t b = blockIdx.x;      // gridDim.x == B
  const size_t layer_bytes = size_t(Z) * W;

  unsigned char* __restrict__ post = smem;   // int16 [n], by byte offset
  unsigned char* __restrict__ my_ring =
      smem + align16(2 * size_t(n)) + size_t(row) * W;   // + slot * Z * W
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem + align16(2 * size_t(n)) + align16(kRingStages * layer_bytes)));
  if (row == 0) mbar_init(bar, Z);
  unsigned char* __restrict__ my_msg =
      a.msg + b * mb * layer_bytes + size_t(row) * W;     // + l * Z * W
  const int8_t* __restrict__ chan =
      static_cast<const int8_t*>(p.chan) + b * n;

  // Channel in: this thread owns row `row` of every base column.
  for (int j = 0; j < nb; ++j)
    post_at(post, 2 * (j * Z + row)) = int16_t(chan[j * Z + row]);

  // The ring: the next step to copy in (iteration f_it, layer f_l: its
  // rows at f_src) and its slot at f_dst. Every step commits one group,
  // empty in the first iteration.
  unsigned char* const ring0 = my_ring;
  unsigned char* const ring_end = my_ring + kRingStages * layer_bytes;
  unsigned char* const msg_end = my_msg + mb * layer_bytes;
  int f_it = 0;
  const unsigned char* f_src = my_msg;
  unsigned char* f_dst = ring0;
  auto copy_next = [&]() {
    if (f_it >= 1 && f_it < p.max_iter) {
#pragma unroll
      for (int i = 0; i < W; i += CP) cp_async_ca<CP>(f_dst + i, f_src + i);
    }
    cp_async_commit();
    f_src += layer_bytes;
    if (f_src == msg_end) { f_src = my_msg; ++f_it; }
    f_dst += layer_bytes;
    if (f_dst == ring_end) f_dst = ring0;
  };
  for (int i = 0; i < kRingAhead; ++i) copy_next();
  __syncthreads();

  // The block's barrier between layer steps, split: a thread arrives when
  // its step's posterior writes are done and waits for that phase only
  // before its next posterior read, so its next step's ring read, table
  // loads and addresses overlap the wait.
  uint32_t phase = 0;
  bool pending = false;
  auto settle = [&]() {
    if (pending) {
      while (!mbar_test(bar, phase)) {}
      phase ^= 1u;
      pending = false;
    }
  };

  // One layer step on check row `row` of the base row whose entries start
  // at e0, D of them (D known to the compiler; GUARD: only the first d of
  // the D register slots are entries). The row's reduction is CnRow::add's
  // on unclipped magnitudes: min commutes with the clip at qmax, taken once
  // below, and where |v2c| == min1 and CnRow::emit's clipped comparison
  // differ, min1 and min2 both clip to qmax and every entry gets the same
  // magnitude. The emit is CnRow::emit's; the new messages stay in
  // registers until the row's one store.
  auto layer = [&](auto deg, int e0, int d, const uint32_t* wv,
                   unsigned char* dst) {
    constexpr int D = decltype(deg)::value;
    constexpr bool GUARD = decltype(deg)::guard;
    int raw[D], addr[D];
    // the addresses before the wait; for the 24-entry row after it, which
    // keeps the row within its 128 registers
    if constexpr (GUARD && DMAX == 24) settle();
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (!GUARD || k < d)
        addr[k] = post_offset(base2, thr, e0 + k, row, row2, Z2);
    settle();   // the step before has written every posterior
    int min1 = ldpc::kMinSentinel, min2 = ldpc::kMinSentinel, negacc = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (!GUARD || k < d) {
        raw[k] = int(post_at(post, addr[k])) - old_message(wv, k);
        const int m = abs(raw[k]);
        min2 = min(min2, max(min1, m));
        min1 = min(min1, m);
        negacc ^= raw[k];
      }
    }
    ldpc::CnRow cn;
    cn.min1 = min(min1, qmax);
    cn.min2 = min(min2, qmax);
    cn.finish(p);
    const int o1 = cn.min1o, o2 = cn.min2o;
    int nwv[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      nwv[k] = 0;
      if (k < D && (!GUARD || k < d)) {
        const bool at_min1 = abs(raw[k]) == min1;
        const int mag = at_min1 ? o2 : o1;
        const int neg = (negacc ^ raw[k]) >> 31;   // 0 or -1
        nwv[k] = (mag ^ neg) - neg;
        post_at(post, addr[k]) = int16_t(raw[k] + nwv[k]);
      }
    }
    uint32_t nw4[W / 4];
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      nw4[i] = pack4(nwv[4 * i], nwv[4 * i + 1], nwv[4 * i + 2],
                     nwv[4 * i + 3]);
#pragma unroll
    for (int i = 0; i < W / CP; ++i) {
      if constexpr (CP == 8)
        reinterpret_cast<uint2*>(dst)[i] = make_uint2(nw4[2 * i],
                                                      nw4[2 * i + 1]);
      else
        reinterpret_cast<uint32_t*>(dst)[i] = nw4[i];
    }
  };

  // done and iters are the same in every thread of the block.
  bool done = false;
  int iters = 0;
  if (ET) done = !block_unsat(tw, post, mb, E, Z, row);   // state 0
  const unsigned char* mine = ring0;   // this step's slot
  for (int it = 0; it < p.max_iter && !done; ++it) {
    const bool first = it == 0;   // every message is still 0: not read
    unsigned char* dst = my_msg;
    int e1 = int(tw[0]);
    for (int l = 0; l < mb; ++l) {
      cp_async_wait<kRingAhead - 1>();   // this step's copy has landed
      copy_next();                       // step + kRingAhead, into the slot
                                         // the step before read
      uint32_t wv[W / 4];
#pragma unroll
      for (int i = 0; i < W / 4; ++i)
        wv[i] = first ? 0u : reinterpret_cast<const uint32_t*>(mine)[i];
      mine += layer_bytes;
      if (mine == ring_end) mine = ring0;
      const int e0 = e1;
      e1 = int(tw[l + 1]);
      const int d = e1 - e0;
      if constexpr (DMAX == 8) {
        // a body for each degree: straight-line code, no guard an entry
        switch (d) {
          case 2: layer(Deg<2>{}, e0, d, wv, dst); break;
          case 3: layer(Deg<3>{}, e0, d, wv, dst); break;
          case 4: layer(Deg<4>{}, e0, d, wv, dst); break;
          case 5: layer(Deg<5>{}, e0, d, wv, dst); break;
          case 6: layer(Deg<6>{}, e0, d, wv, dst); break;
          case 7: layer(Deg<7>{}, e0, d, wv, dst); break;
          default: layer(Deg<8>{}, e0, d, wv, dst); break;
        }
      } else if constexpr (DMAX == 28) {
        // DVB-S2 rate 8/9's rows of 27 and 28: straight-line bodies (the
        // guarded body took 1.6-1.8x as long on them); other rows guarded
        switch (d) {
          case 27: layer(Deg<27>{}, e0, d, wv, dst); break;
          case 28: layer(Deg<28>{}, e0, d, wv, dst); break;
          default: layer(Deg<DMAX, true>{}, e0, d, wv, dst); break;
        }
      } else {
        layer(Deg<DMAX, true>{}, e0, d, wv, dst);
      }
      dst += layer_bytes;
      // Orders this layer's posterior reads and writes before the next
      // layer's by the other threads of the block.
      mbar_arrive(bar);
      pending = true;
    }
    if (ET) {
      iters = it + 1;
      settle();
      done = !block_unsat(tw, post, mb, E, Z, row);   // state it + 1
    }
  }
  cp_async_wait<0>();
  settle();

  // Hard bits from the final (for ET: latched) posteriors; the fixed form
  // takes the syndrome here.
  const bool conv = ET ? done : !block_unsat(tw, post, mb, E, Z, row);
  uint8_t* __restrict__ hard = p.hard + b * n;
  for (int j = 0; j < nb; ++j)
    hard[j * Z + row] = uint8_t(post_at(post, 2 * (j * Z + row)) < 0);
  if (row == 0) {
    p.iters[b] = ET ? iters : p.max_iter;
    p.conv[b] = conv;
  }
}

using PipelinedKernel = void (*)(RingArgs);

inline PipelinedKernel pipelined_kernel(int dmax, bool et) {
  switch (dmax) {
    case 8:
      return et ? stream_pipelined_kernel<8, true>
                : stream_pipelined_kernel<8, false>;
    case 24:
      return et ? stream_pipelined_kernel<24, true>
                : stream_pipelined_kernel<24, false>;
    case 28:
      return et ? stream_pipelined_kernel<28, true>
                : stream_pipelined_kernel<28, false>;
    default:
      return et ? stream_pipelined_kernel<32, true>
                : stream_pipelined_kernel<32, false>;
  }
}

// ---------------------------------------------------------------------------
// The packed resident kernel (3. above).

constexpr int kResidentRow = 8;           // entries a row keeps in registers
constexpr int kResidentAhead = 1;         // layer steps copied in ahead
constexpr int kResidentStages = kResidentAhead + 1;
constexpr int kResidentMaxThreads = 512;  // Z: the launch bound
constexpr int kResidentVote = 8;          // base rows between the block's
                                          // syndrome votes

// Table words (uint32), by base row: layer_ptr[mb + 1]; wptr[mb + 1], the
// message words before each base row (a row of d entries has
// resident_words(d, LPT) words of four bytes, LPT lanes an entry); off[E] =
// (2 LPT (col Z + shift)) << 11 | (Z - shift), the posterior byte offset
// of entry e for row 0 (row y adds 2 LPT y, less 2 LPT Z where y >= Z -
// shift). kernels/minsum_stream.py::resident_tables builds them.
struct ResidentArgs {
  Params p;           // chan int8 (B, n); hard (B, n); iters, conv (B,)
  unsigned char* msg; // scratch (ceil(B / LPT), wptr[mb], Z, 4 bytes)
  int wmax;           // the most message words of a base row
  uint32_t tab[ldpc::kTabWords];
};
static_assert(sizeof(ResidentArgs) <= 32764, "kernel parameters above 32,764 B");

inline int resident_words(int d, int lpt) {
  return (d * lpt + 3) / 4;
}

// The syndrome vote's word, the posteriors, the ring (kResidentStages layer
// steps of wmax words of every row) and the block's mbarrier.
inline size_t resident_smem(int nb, int Z, int lpt, int wmax) {
  return align16(4)
       + align16(2 * size_t(nb) * Z * lpt)
       + align16(size_t(kResidentStages) * wmax * Z * 4)
       + 16;
}

// Whether a block of LPT lanes takes the code: Z threads within the launch
// bound, more base rows than the ring looks ahead, the tables in the
// parameters, posterior offsets within an entry word's 21 bits, the block
// in shared memory.
inline bool resident_fits(int nb, int Z, int mb, int E, int lpt, int wmax) {
  return (lpt == 2 || lpt == 4) && Z > 0 && Z <= kResidentMaxThreads
      && mb > kResidentAhead && 2 * (mb + 1) + E <= ldpc::kTabWords
      && 2 * size_t(lpt) * (size_t(nb) + 1) * Z < (size_t(1) << 21)
      && resident_smem(nb, Z, lpt, wmax) <= size_t(ldpc::kMaxSmem);
}

// The most message words of a base row, or -1 when the tables are not
// resident_tables' layout for LPT lanes.
inline int resident_wmax(const uint32_t* tab, int words, int mb, int E,
                         int lpt) {
  if (!tab || words != 2 * (mb + 1) + E || tab[0] != 0 || tab[mb] != uint32_t(E)
      || tab[mb + 1] != 0)
    return -1;
  int wmax = 0;
  for (int l = 0; l < mb; ++l) {
    const int d = int(tab[l + 1]) - int(tab[l]);
    const int w = int(tab[mb + 2 + l]) - int(tab[mb + 1 + l]);
    if (d < 2 || w != resident_words(d, lpt)) return -1;
    wmax = std::max(wmax, w);
  }
  return wmax;
}

// Hard bits of the block's lanes whose byte of `mask` is set, from the
// posteriors [n][LPT], to hard (B, n): the thread's own rows of every base
// column.
template <int LPT>
__device__ void resident_outputs(const Params& p, const int16_t* post,
                                 long long b0, int row, uint32_t mask) {
  const int Z = p.Z;
  const size_t n = size_t(p.nb) * Z;
  for (int j = 0; j < p.nb; ++j) {
    const int v = j * Z + row;
    uint32_t lo, hi;
    ldpc::ld16<LPT>(post + v * LPT, lo, hi);
    const uint32_t h = (ldpc::bytes_of(lo, hi, 0x7531) >> 7) & 0x01010101u;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if ((mask >> (8 * k)) & 1) p.hard[(b0 + k) * n + v] = uint8_t(h >> (8 * k));
  }
}

template <int LPT, bool ET>
__global__ void __launch_bounds__(kResidentMaxThreads, LPT == 2 ? 2 : 1)
resident_packed_kernel(const __grid_constant__ ResidentArgs a) {
  static_assert(LPT == 2 || LPT == 4, "lanes a thread: 2 or 4");
  constexpr int EPW = 4 / LPT;              // entries a message word
  constexpr int D = kResidentRow;
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = a.p;
  const uint32_t* __restrict__ tw = a.tab;
  const int Z = p.Z, nb = p.nb, mb = p.mb, wmax = a.wmax;
  const int n = nb * Z;
  const uint32_t* __restrict__ wptr = tw + mb + 1;
  const uint32_t* __restrict__ off = wptr + mb + 1;
  const uint32_t q2 = uint32_t(p.qmax) * 0x00010001u;
  const int row = threadIdx.x;                       // blockDim.x == Z
  const long long b0 = (long long)blockIdx.x * LPT;  // the block's lanes
  const int nvalid = int(min((long long)LPT, (long long)p.B - b0));
  const size_t ZW = size_t(Z) * 4;                   // a word of every row

  // the lanes with an unsatisfied row found by the vote in progress (bit 7
  // of each lane's byte); 0 between votes
  uint32_t* s_un = reinterpret_cast<uint32_t*>(smem);
  int16_t* post = reinterpret_cast<int16_t*>(smem + align16(4));
  unsigned char* const ring =
      smem + align16(4) + align16(2 * size_t(n) * LPT);
  unsigned char* const my_ring = ring + 4 * row;     // + (s wmax + w) ZW
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(
      ring + align16(size_t(kResidentStages) * wmax * ZW)));
  unsigned char* const my_msg =
      a.msg + size_t(blockIdx.x) * wptr[mb] * ZW + 4 * row;   // + w ZW

  if (row == 0) {
    *s_un = 0u;
    mbar_init(bar, Z);
  }

  // Channel in: this thread owns row `row` of every base column.
  const int8_t* __restrict__ chan = static_cast<const int8_t*>(p.chan);
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (k < nvalid) w |= uint32_t(uint8_t(chan[(b0 + k) * n + v])) << (8 * k);
    ldpc::put_lanes<LPT>(post + v * LPT, w);
  }

  // The ring: the next step to copy in (iteration f_it, base row f_l) and
  // its stage. Every step commits one group, empty in the first iteration
  // (every message is still 0) and past the last.
  int f_it = 0, f_l = 0, f_stage = 0;
  auto copy_next = [&]() {
    if (f_it >= 1 && f_it < p.max_iter) {
      const unsigned char* src = my_msg + size_t(wptr[f_l]) * ZW;
      unsigned char* dst = my_ring + size_t(f_stage) * wmax * ZW;
      const int nw = int(wptr[f_l + 1] - wptr[f_l]);
      for (int w = 0; w < nw; ++w) cp_async_ca<4>(dst + w * ZW, src + w * ZW);
    }
    cp_async_commit();
    if (++f_l == mb) { f_l = 0; ++f_it; }
    if (++f_stage == kResidentStages) f_stage = 0;
  };
  for (int i = 0; i < kResidentAhead; ++i) copy_next();
  __syncthreads();

  // The block's barrier between layer steps, split (the pipelined
  // kernel's): a thread arrives when its posterior writes are done and
  // waits for that phase only before its next posterior read.
  uint32_t phase = 0;
  bool pending = false;
  auto settle = [&]() {
    if (pending) {
      while (!mbar_test(bar, phase)) {}
      phase ^= 1u;
      pending = false;
    }
  };

  // The posterior pair of entry e of this thread's check row.
  unsigned char* const post_row =
      reinterpret_cast<unsigned char*>(post) + 2 * LPT * row;
  const int ZL2 = 2 * LPT * Z;
  auto post_of = [&](int e) {
    const uint32_t w = off[e];
    return reinterpret_cast<int16_t*>(
        post_row + (w >> 11) - (row >= int(w & 0x7ffu) ? ZL2 : 0));
  };

  // ET: byte k of act is 0xff while lane k runs (lanes past the batch never
  // do); iters[k], the iterations lane k ran. Every thread holds the same
  // lanes, so act is the same in every thread of the block.
  uint32_t act = 0;
  int iters[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    iters[k] = ET ? 0 : p.max_iter;
    if (k < nvalid) act |= 0xffu << (8 * k);
  }

  // Which lanes of `need` (bit 7 of each lane's byte) have an unsatisfied
  // check row in the block, by vote: in each round every thread XORs the
  // posteriors of its rows of kResidentVote base rows (the parity of a
  // lane's signs lands in bit 15 of its half) and ORs what it found into
  // s_un; after the barrier every thread reads the same lanes, and a second
  // barrier keeps the next round's ORs behind every thread's read, so every
  // thread leaves after the same round, once every lane of `need` has one.
  // Every thread returns the same word.
  auto unsat_lanes = [&](uint32_t need) {
    uint32_t found = 0;
    for (int l0 = 0; l0 < mb && (found & need) != need; l0 += kResidentVote) {
      uint32_t un = 0;
      for (int l = l0; l < min(l0 + kResidentVote, mb); ++l) {
        uint32_t x[2] = {0u, 0u};
#pragma unroll 4
        for (int e = int(tw[l]); e < int(tw[l + 1]); ++e) {
          uint32_t t[2];
          ldpc::ld16<LPT>(post_of(e), t[0], t[1]);
          x[0] ^= t[0];
          x[1] ^= t[1];
        }
        un |= ldpc::bytes_of(x[0], x[1], 0x7531);
      }
      un &= need & ~found;
      if (un) atomicOr(s_un, un);
      __syncthreads();
      found = *s_un;
      __syncthreads();   // every thread has read s_un
    }
    // the next vote's ORs follow a block barrier (__syncthreads_or)
    if (row == 0) *s_un = 0u;
    return found & need;
  };

  // State k: a running lane with no unsatisfied row is done, with iters =
  // k, and its hard bits are written from this state. A done lane goes on
  // through the layers with the others of its word, but nothing reads its
  // state again.
  auto check = [&](int k) {
    const uint32_t un = unsat_lanes(act & 0x80808080u);
    uint32_t fin = 0;
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      if ((act >> (8 * q)) & 1) {
        iters[q] = k;
        if (!((un >> (8 * q + 7)) & 1)) fin |= 0xffu << (8 * q);
      }
    }
    if (fin) {
      act &= ~fin;
      resident_outputs<LPT>(p, post, b0, row, fin);
    }
  };

  if constexpr (ET) check(0);
  int stage = 0;   // this step's stage of the ring
  for (int it = 0; it < p.max_iter; ++it) {
    if constexpr (ET) {
      // every thread has written its outputs before the layers write again
      if (!__syncthreads_or(act != 0)) break;
    }
    for (int l = 0; l < mb; ++l) {
      cp_async_wait<kResidentAhead - 1>();   // this step's copy has landed
      copy_next();                           // step + ahead, into the stage
                                             // the step before read
      const unsigned char* const slot = my_ring + size_t(stage) * wmax * ZW;
      if (++stage == kResidentStages) stage = 0;
      const int e0 = int(tw[l]), d = int(tw[l + 1]) - e0;
      unsigned char* const dst = my_msg + size_t(wptr[l]) * ZW;
      // entry i's negated old message: LPT bytes of its word in the slot
      auto old_of = [&](int i) -> uint32_t {
        return it ? ldpc::ld8<LPT>(reinterpret_cast<const int8_t*>(
                        slot + (i / EPW) * ZW + (i % EPW) * LPT))
                  : 0u;
      };
      if (d <= D) {
        // The row in registers, in groups of four slots: a group past the
        // row's degree is skipped (one uniform branch), and within a group
        // entries past d repeat the last one's loads and take no part in
        // the row or the stores.
        uint32_t old[D], raw[D][2], rb[D];
        int16_t* pa[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          if ((i & ~3) >= d) break;
          const int ei = min(i, d - 1);
          old[i] = old_of(ei);
          pa[i] = post_of(e0 + ei);
        }
        settle();   // the step before has written every posterior
        ldpc::PackedRow<LPT> cn;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          if ((i & ~3) >= d) break;
          uint32_t t[2];
          ldpc::ld16<LPT>(pa[i], t[0], t[1]);
          rb[i] = cn.template entry<true>(t, old[i], q2, i < d, raw[i]);
        }
        const ldpc::PackedEmit em(cn, p);
        uint32_t word[D / EPW];
#pragma unroll
        for (int w = 0; w < D / EPW; ++w) word[w] = 0u;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          if (i < d) {
            uint32_t msg, nv;
            em.emit(rb[i], msg, nv);
            ldpc::st16<LPT>(pa[i], __vadd2(raw[i][0], ldpc::widen_lo(nv)),
                            __vadd2(raw[i][1], ldpc::widen_hi(nv)));
            word[i / EPW] |= LPT == 4 ? msg : (msg & 0xffffu) << (16 * (i % EPW));
          }
        }
#pragma unroll
        for (int w = 0; w < D / EPW; ++w)
          if (w * EPW < d) *reinterpret_cast<uint32_t*>(dst + w * ZW) = word[w];
      } else {
        // Rows longer than the register row: a reduce pass, then an emit
        // pass that reads the posterior and the ring slot again (shared
        // memory only).
        settle();
        ldpc::PackedRow<LPT> cn;
        for (int i = 0; i < d; ++i) {
          uint32_t t[2];
          ldpc::ld16<LPT>(post_of(e0 + i), t[0], t[1]);
          cn.template entry<true>(t, old_of(i), q2);
        }
        const ldpc::PackedEmit em(cn, p);
        for (int w = 0; w * EPW < d; ++w) {
          uint32_t word = 0u;
#pragma unroll
          for (int k = 0; k < EPW; ++k) {
            const int i = w * EPW + k;
            if (i < d) {
              int16_t* const pa = post_of(e0 + i);
              uint32_t t[2], raw[2], msg, nv;
              ldpc::ld16<LPT>(pa, t[0], t[1]);
              em.emit(cn.template entry<false>(t, old_of(i), q2, true, raw),
                      msg, nv);
              ldpc::st16<LPT>(pa, __vadd2(raw[0], ldpc::widen_lo(nv)),
                              __vadd2(raw[1], ldpc::widen_hi(nv)));
              word |= LPT == 4 ? msg : (msg & 0xffffu) << (16 * k);
            }
          }
          *reinterpret_cast<uint32_t*>(dst + w * ZW) = word;
        }
      }
      // Orders this step's posterior reads and writes before the next
      // step's by the other threads of the block.
      mbar_arrive(bar);
      pending = true;
    }
    if constexpr (ET) {
      settle();
      check(it + 1);
    }
  }
  cp_async_wait<0>();
  settle();

  // Outputs of the lanes not yet written, from the final posteriors; the
  // fixed form takes the syndrome here (every lane's unsatisfied rows in
  // `un`; with ET the lanes still running are the unconverged ones).
  const uint32_t un = ET ? act : unsat_lanes(act & 0x80808080u);
  if (act) resident_outputs<LPT>(p, post, b0, row, act);
  if (row == 0) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      if (k >= nvalid) break;
      p.iters[b0 + k] = iters[k];
      p.conv[b0 + k] = ((un >> (8 * k + 7)) & 1) == 0;
    }
  }
}

using ResidentKernel = void (*)(ResidentArgs);

inline ResidentKernel resident_kernel(int lpt, bool et) {
  if (lpt == 2)
    return et ? resident_packed_kernel<2, true> : resident_packed_kernel<2, false>;
  return et ? resident_packed_kernel<4, true> : resident_packed_kernel<4, false>;
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one instance's block for one code; an
// error when the block does not fit.
int minsum_stream_config(int nb, int Z, int mb, int E, int resident, int et,
                         int* smem) {
  *smem = int(smem_bytes(nb, Z, mb, E, resident != 0, et != 0));
  return block_fits(nb, Z, mb, E, resident != 0, et != 0)
             ? 0 : int(cudaErrorInvalidConfiguration);
}

const char* minsum_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers: chan int8 (B, n), hard uint8 (B, n), iters
// int32 (B,), conv uint8 (B,), tables as kernels/minsum.py::kernel_tables,
// post int16 (B, n) (may be null when resident) and c2v int8 (B, E * Z),
// both scratch that the kernel overwrites.
int minsum_stream_launch(const void* chan, void* hard, void* iters, void* conv,
                         const void* tables, void* post, void* c2v, int B,
                         int nb, int Z, int mb, int E, int max_iter,
                         int early_term, int resident, int qmax,
                         int beta, int alpha_num, int alpha_shift,
                         void* stream) {
  using Kernel = void (*)(StreamParams);
  const Kernel kernels[2][2] = {
      {minsum_stream_kernel<false, false>, minsum_stream_kernel<false, true>},
      {minsum_stream_kernel<true, false>, minsum_stream_kernel<true, true>}};
  const bool res = resident != 0, et = early_term != 0;
  StreamParams sp;
  sp.p = ldpc::make_params(chan, 0, 0.f, nullptr, 0, hard, nullptr, nullptr,
                           iters, conv, tables, B, nb, Z, mb, E, max_iter,
                           qmax, beta, alpha_num, alpha_shift, 0, nullptr, 0);
  sp.post = static_cast<int16_t*>(post);
  sp.c2v = static_cast<int8_t*>(c2v);
  if (!block_fits(nb, Z, mb, E, res, et)) return int(cudaErrorInvalidConfiguration);
  if (B <= 0) return 0;
  const Kernel kern = kernels[res][et];
  const int smem = int(smem_bytes(nb, Z, mb, E, res, et));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kern<<<unsigned(B), Z, smem, static_cast<cudaStream_t>(stream)>>>(sp);
  return int(cudaGetLastError());
}

// The pipelined kernel's block for one code: dynamic shared-memory bytes,
// its register row and the blocks an SM keeps resident; an error when the
// block does not take the code.
int minsum_stream_pipelined_config(int nb, int Z, int mb, int E, int max_deg,
                                   int early_term, int* smem, int* dmax,
                                   int* blocks) {
  *dmax = pipelined_dmax(max_deg);
  *smem = *dmax ? int(pipelined_smem(nb, Z, *dmax)) : 0;
  *blocks = 0;
  if (!pipelined_fits(nb, Z, mb, E, max_deg))
    return int(cudaErrorInvalidConfiguration);
  return ldpc::occupancy(pipelined_kernel(*dmax, early_term != 0), Z, *smem,
                         blocks);
}

// Launches the pipelined kernel on `stream` and returns cudaGetLastError()
// (0 on success). chan int8 (B, n), hard uint8 (B, n), iters int32 (B,),
// conv uint8 (B,) and msg (B, mb, Z, the register row's bytes), scratch the
// kernel overwrites, are device pointers; the tables
// `ptab` (host memory, ptab_words = mb + 1 + 2 E uint32 words,
// pipelined_tables' layout) are copied into the kernel's parameters.
int minsum_stream_pipelined_launch(const void* chan, void* hard, void* iters,
                                   void* conv, const uint32_t* ptab,
                                   int ptab_words, void* msg, int B, int nb,
                                   int Z, int mb, int E, int max_iter,
                                   int early_term, int qmax, int beta,
                                   int alpha_num, int alpha_shift,
                                   void* stream) {
  if (!ptab || ptab_words != mb + 1 + 2 * E || ptab_words > kRingTabWords)
    return int(cudaErrorInvalidValue);
  const int max_deg = table_max_degree(ptab, mb);
  if (!pipelined_fits(nb, Z, mb, E, max_deg))
    return int(cudaErrorInvalidConfiguration);
  static thread_local RingArgs a;   // 16 KB, off the stack; copied at launch
  a.p = ldpc::make_params(chan, 0, 0.f, nullptr, 0, hard, nullptr, nullptr,
                          iters, conv, nullptr, B, nb, Z, mb, E, max_iter,
                          qmax, beta, alpha_num, alpha_shift, 0, nullptr, 0);
  a.msg = static_cast<unsigned char*>(msg);
  memcpy(a.tab, ptab, 4 * size_t(ptab_words));
  const int dmax = pipelined_dmax(max_deg);
  const PipelinedKernel kern = pipelined_kernel(dmax, early_term != 0);
  const int smem = int(pipelined_smem(nb, Z, dmax));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (B <= 0) return 0;
  kern<<<unsigned(B), Z, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// The packed resident kernel's block for one code at LPT lanes a thread
// (`ptab`: resident_tables' words for those lanes, host memory): dynamic
// shared-memory bytes and the blocks an SM keeps resident; an error when
// the tables are not that layout or the block does not take the code.
int minsum_stream_resident_config(int nb, int Z, int mb, int E,
                                  const uint32_t* ptab, int ptab_words,
                                  int lanes, int early_term, int* smem,
                                  int* blocks) {
  *smem = 0;
  *blocks = 0;
  const int wmax = resident_wmax(ptab, ptab_words, mb, E, lanes);
  if (wmax < 0) return int(cudaErrorInvalidValue);
  if (!resident_fits(nb, Z, mb, E, lanes, wmax))
    return int(cudaErrorInvalidConfiguration);
  *smem = int(resident_smem(nb, Z, lanes, wmax));
  const ResidentKernel k = resident_kernel(lanes, early_term != 0);
  const cudaError_t err = ldpc::prepare(k, *smem);
  if (err != cudaSuccess) return int(err);
  return ldpc::occupancy(k, Z, *smem, blocks);
}

// Launches the packed resident kernel (`lanes` codewords a block, one
// thread a check row) on `stream` and returns cudaGetLastError() (0 on
// success). chan int8 (B, n), hard uint8 (B, n), iters int32 (B,), conv
// uint8 (B,) and msg (ceil(B / lanes), wptr[mb], Z, 4 bytes), scratch the
// kernel overwrites, are device pointers; the tables `ptab` (host memory,
// resident_tables' layout for `lanes`) are copied into the parameters.
// qmax above 127 is refused (the messages are bytes).
int minsum_stream_resident_launch(const void* chan, void* hard, void* iters,
                                  void* conv, const uint32_t* ptab,
                                  int ptab_words, void* msg, int B, int nb,
                                  int Z, int mb, int E, int max_iter,
                                  int early_term, int lanes, int qmax,
                                  int beta, int alpha_num, int alpha_shift,
                                  void* stream) {
  const int wmax = resident_wmax(ptab, ptab_words, mb, E, lanes);
  if (wmax < 0 || qmax > 127) return int(cudaErrorInvalidValue);
  if (!resident_fits(nb, Z, mb, E, lanes, wmax))
    return int(cudaErrorInvalidConfiguration);
  static thread_local ResidentArgs a;   // 32 KB, off the stack; copied at launch
  a.p = ldpc::make_params(chan, 0, 0.f, nullptr, 0, hard, nullptr, nullptr,
                          iters, conv, nullptr, B, nb, Z, mb, E, max_iter,
                          qmax, beta, alpha_num, alpha_shift, 0, nullptr, 0);
  a.msg = static_cast<unsigned char*>(msg);
  a.wmax = wmax;
  memcpy(a.tab, ptab, 4 * size_t(ptab_words));
  const ResidentKernel kern = resident_kernel(lanes, early_term != 0);
  const int smem = int(resident_smem(nb, Z, lanes, wmax));
  const cudaError_t err = ldpc::prepare(kern, smem);
  if (err != cudaSuccess) return int(err);
  if (B <= 0) return 0;
  kern<<<unsigned((B + lanes - 1) / lanes), Z, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
