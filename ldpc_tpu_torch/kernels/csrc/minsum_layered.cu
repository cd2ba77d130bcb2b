// Fixed-point min-sum layered decoder for NVIDIA Hopper (sm_90a).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::make_pallas_decoder.kernel in
// its layered forms (K3): fixed iterations (layered_iter over cn_sweep,
// then the hard decision and syndrome_ok) and per-lane early termination
// (run_et with latch_hard and syndrome_ok, entered with the channel
// state's syndrome), both with the fused-IO stages (quant32 in,
// emit_counts out). Bit-exact with golden.decoder.decode_fixed(schedule=
// "layered") and with the plain torch version beside the wrapper
// (ldpc_tpu_torch/ops/decode_ref.py::make_layered_decoder).
//
// What bounds it on the H100: shared-memory traffic, integer ALU work and
// block barriers. A codeword brings about 4n bytes of float LLRs in and a
// few bytes of counters out, against up to max_iter * E * Z check-node
// edge updates (20 * 79 * 81 = 127,980 for the 802.11n n=1944 rate 5/6
// code), each a few shared-memory accesses, and one barrier per layer.
// Device memory is touched once per codeword.
//
// Design. One block decodes `lanes` codewords; thread (x, y) = (codeword
// lane, row y in [0, Z)) owns check row y of every layer (base row). The
// state lives in shared memory with the lane index innermost:
//   post  int16 [n][lanes]        posteriors, initialised from the
//                                 quantized channel (no separate channel
//                                 buffer); int16 is lossless since
//                                 |post| <= 128 + dv_max * qmax, which the
//                                 wrapper checks is < 2^15
//   c2v   int8  [E * Z][lanes]    check-to-variable messages, entry-major
// One layer: thread y reads post[j][(y + s) mod Z] - c2v[e][y] for every
// entry (j, s) of the base row, runs the CN update of cn_minsum.cuh (the
// row read twice: reduce, then emit), writes c2v[e][y] = new and
// post[j][(y + s) mod Z] += new - old, then all threads meet at
// __syncthreads() before the next layer reads what this one wrote.
// No atomics: a base row holds at most one circulant per base column, so
// within a layer the Z rows of column j touch the permutation
// (y + s) mod Z of post[j][.], and each address is read and written by one
// thread only. The lane axis is masked at the ragged edge, so any batch
// size works.
//
// Early termination (template ET, a compile-time branch). Before the
// first iteration every lane checks the channel state: a lane whose hard
// bits already satisfy every check is done with iters = 0. After each
// iteration k (1-based), every thread of a lane that is not done checks
// its rows of every base row and marks the lane's flag with k when one is
// unsatisfied (all writers store the same value, so no atomics); after a
// barrier a lane whose flag is not k is done. iters counts the iterations
// a lane ran while not done. A done lane skips its layer updates from
// then on, which freezes its posteriors, and so its hard bits, at its
// first success (latch_hard's effect). At the top of each iteration the
// block leaves the loop once no lane is active: __syncthreads_or gives
// every thread the same answer, so no thread waits at a barrier that the
// others skipped (the whole-tile skip of the TPU kernel). The flag stamps
// increase with k, so no reset is needed between iterations.

#include "cn_minsum.cuh"

namespace {

using ldpc::align16;
using ldpc::Params;

inline size_t smem_bytes(int nb, int Z, int mb, int E, int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(4 * size_t(ldpc::table_words(nb, mb, E)))
       + align16(8 * size_t(lanes))          // per-lane flag, bit errors
       + align16(2 * n * lanes)               // post
       + align16(size_t(E) * Z * lanes);      // c2v
}

template <bool ET>
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
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    const int q = valid ? ldpc::load_chan(p, size_t(v) * p.B + b) : 0;
    post[v * L + lane] = int16_t(q);
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
        ldpc::CnRow cn;
        for (int e = e0; e < e1; ++e) {
          int c = row + t.ent_shift[e];
          if (c >= Z) c -= Z;
          cn.add(int(post[(t.ent_col[e] * Z + c) * L + lane])
                 - int(c2v[(e * Z + row) * L + lane]), qmax);
        }
        cn.finish(p);
        for (int e = e0; e < e1; ++e) {
          int c = row + t.ent_shift[e];
          if (c >= Z) c -= Z;
          const int idx = (e * Z + row) * L + lane;
          const int pidx = (t.ent_col[e] * Z + c) * L + lane;
          const int old = c2v[idx];
          const int pv = post[pidx];
          const int nw = cn.emit(pv - old, qmax);
          c2v[idx] = int8_t(nw);
          post[pidx] = int16_t(pv + nw - old);
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
      if (p.info && j < p.kb) nerr += h ^ int(p.info[g]);
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

}  // namespace

extern "C" {

// Lanes per block and dynamic shared-memory bytes for one code; 0 lanes
// when no block shape fits (Z > 1024 or state above 227 KB per codeword).
int minsum_layered_config(int nb, int Z, int mb, int E, int* lanes, int* smem) {
  return ldpc::decoder_config(
      Z, [=](int l) { return smem_bytes(nb, Z, mb, E, l); }, lanes, smem);
}

const char* minsum_layered_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers; info/hard/bits/frame may be null.
int minsum_layered_launch(const void* chan, int chan_is_f32, float scale,
                          const void* info, int kb, void* hard, void* bits,
                          void* frame, void* iters, void* conv,
                          const void* tables, int B, int nb, int Z, int mb,
                          int E, int max_iter, int early_term, int qmax,
                          int beta, int alpha_num, int alpha_shift,
                          void* stream) {
  const Params p = ldpc::make_params(
      chan, chan_is_f32, scale, info, kb, hard, bits, frame, iters, conv,
      tables, B, nb, Z, mb, E, max_iter, qmax, beta, alpha_num, alpha_shift);
  return ldpc::decoder_launch(
      early_term ? minsum_layered_kernel<true> : minsum_layered_kernel<false>,
      [=](int l) { return smem_bytes(nb, Z, mb, E, l); }, p, stream);
}

}  // extern "C"
