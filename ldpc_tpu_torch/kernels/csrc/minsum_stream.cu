// Fixed-point layered min-sum decoder for codewords too long for one SM's
// shared memory, for NVIDIA Hopper (sm_90a): the state streams through
// device memory.
//
// Replaces the five kernels of ldpc_tpu/kernels/minsum_stream.py::
// make_stream_decoder: `kernel` (run-time layer tables) and `kernel_static`
// (K6b, K6c: fixed iterations, posteriors and messages in device memory),
// `kernel_resident` (K6d: posteriors on chip), `kernel_resident_et` (K6e:
// K6d with per-lane early termination) and `kernel_stream_et` (K6f: K6b/c
// with early termination and only the hard bits on chip). They are one
// computation, the layer update `_layer_cn`, in five memory schedules; here
// they are one template in four instances, <RESIDENT, ET>. Bit-exact with
// golden.decoder.decode_fixed(schedule="layered") and with the plain torch
// version beside the wrapper (ldpc_tpu_torch/ops/decode_qc.py).
//
// What bounds it on the H100: bytes. Per codeword and iteration every edge
// reads and writes its int8 message (2 E Z bytes) and, unless the
// posteriors are resident, reads and writes an int16 posterior (4 E Z
// bytes): 1.36 MB for the DVB-S2 n=64,800 rate 1/2 code (E = 631, Z = 360),
// against some 12 integer operations per edge. The state of a batch of
// 1,024 such codewords is 365 MB, seven times the L2, so it does stream.
//
// Design. One block owns one whole codeword (block b decodes codeword b of
// the batch, so any batch size is whole blocks): layer l + 1 reads
// posteriors that layer l wrote, and the block's barrier after every layer
// is what orders them. Thread y owns check row y of every base row. Two
// codewords a block were measured (H100, B = 1,024, 20 iterations) and
// were slower or tied in every instance that a route selects: more blocks
// an SM hide more of each block's barrier and memory waits. The state is
// codeword major with the row index innermost,
//   post int16 [B][nb * Z]   (device memory; shared memory when RESIDENT)
//   c2v  int8  [B][E * Z]    (device memory)
// so thread y's accesses post[b][j * Z + (y + s) mod Z] and c2v[b][e * Z +
// y] are contiguous across a warp except at the wrap of the circulant, the
// channel (B, n) is read and the hard bits (B, n) are written as they lie,
// and a circulant shift is index arithmetic. No slots, no forward table, no
// double buffer: the hardware's caches and the other blocks of the SM hide
// the latency. One layer: the thread reads its row twice (reduce with
// CnRow::add, then emit; the second read hits the L1), writes c2v = new and
// post += new - old, and all threads meet at __syncthreads(). A base row
// has at most one circulant per base column, so within a layer every
// address is read and written by one thread only: no atomics. The first
// iteration takes old = 0 without loading, so the message scratch needs no
// zeroing. Indices into the batch's state are size_t: B * E * Z passes 2^31
// at B >= 9,455 for the n = 64,800 code.
//
// Early termination (ET), as minsum_layered.cu: state 0 (the channel) is
// checked, a codeword whose hard bits satisfy every check is done (which
// latches its hard bits at the first success), iters counts the iterations
// it ran until then, and the block leaves the loop. The syndrome reads only
// shared memory: the resident posteriors, or, when the posteriors stream,
// one hard-bit byte per variable that the emit step keeps up to date (the
// int8 hard-bit state of K6f).

#include "cn_minsum.cuh"

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

}  // extern "C"
