// Fixed-point min-sum flooding decoder for NVIDIA Hopper (sm_90a).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::make_pallas_decoder.kernel in
// its flooding forms: fixed iterations (flood_first, flood_iter/flood_pair,
// _cn_minsum, syndrome_ok; K1) and per-lane early termination (run_et with
// latch_hard; K2), both with the fused-IO stages (quant32 in, emit_counts
// out; K1-IO). Bit-exact with golden.decoder.decode_fixed(schedule=
// "flooding") and with the plain torch version beside the wrapper
// (ldpc_tpu_torch/ops/decode_ref.py).
//
// What bounds it on the H100: integer ALU work and shared-memory traffic.
// A codeword brings about 4n bytes of float LLRs (n bytes as int8) in and
// a few bytes of counters (or n bytes of hard bits) out, against
// max_iter * E * Z check-node edge updates (20 * 88 * 27 = 47,520 for the
// 802.11n n=648 code), each a handful of shared-memory accesses and
// integer ops. Device memory is touched once per codeword.
//
// Design. One block decodes `lanes` codewords; thread (x, y) = (codeword
// lane, row y in [0, Z)). All decoder state lives in shared memory with
// the lane index innermost, so a warp's accesses are contiguous bytes:
//   chan  int8  [n][lanes]        quantized channel LLRs
//   tot   int16 [n][lanes]        totals chan + sum(c2v); int16 is lossless
//                                 since |tot| <= (dv_max + 1) * qmax, which
//                                 the wrapper checks is < 2^15
//   c2v   int8  [E * Z][lanes]    check-to-variable messages, entry-major
// Each iteration has two phases separated by __syncthreads():
//   V: thread y recomputes tot[j][y] = chan + sum over the base column's
//      entries (e, s) of c2v[e][(y - s) mod Z]  (a gather: no atomics, no
//      write conflicts, and only one totals buffer);
//   C: thread y updates check row y of every base row: v2c = tot[j][(y +
//      s) mod Z] - c2v[e][y], min-sum over the row (cn_minsum.cuh),
//      c2v[e][y] = new. Only thread y touches c2v[.][y] in this phase, and
//      tot is read-only.
// The row is read twice (once to reduce, once to emit) instead of holding
// up to 32 messages in registers. With the min* update (template STAR, K5;
// cn_minstar.cuh) the two reads are the suffix pass, backwards into an int8
// scratch of star_deg slots per row, and the prefix pass that emits. Iteration 1 starts from c2v = 0, which
// is flood_first's meaning. The lane axis is masked at the ragged edge,
// so any batch size works.
//
// Early termination (template ET, a compile-time branch: the fixed form
// compiles as it did without it). The TPU kernel defers each state's
// syndrome into the next sweep; here each new state is checked directly.
// After the V phase of iteration k the totals are state k; every thread
// of a lane that is not done checks its check rows of every base row and
// marks the lane's flag with k when one is unsatisfied (all writers store
// the same value, so no atomics), and after a barrier a lane whose flag
// is not k is done, with iters = k. A done lane skips both phases from
// then on, which freezes its totals, and so its hard bits, at its first
// success (latch_hard's effect); a lane whose channel bits are a codeword
// is done at k = 0 with iters = 0. The block leaves the loop once no lane
// is active: __syncthreads_or gives every thread the same answer, so no
// thread waits at a barrier that the others skipped. The flag stamps
// increase with k, so no reset is needed between iterations.
//
// Monte-Carlo megakernel (template MC, K1-MC; mc_stage.cuh): the channel
// comes from the in-kernel prologue (Philox or injected words -> info bits
// -> structured encode -> BPSK/AWGN/demap/quantize) instead of device
// memory, the codeword bits borrow the c2v buffer before it is zeroed, and
// the error count draws each info bit again. Per codeword, device memory
// then sees only the four per-lane counters.

#include "cn_minsum.cuh"
#include "cn_minstar.cuh"
#include "mc_stage.cuh"

namespace {

using ldpc::align16;
using ldpc::Params;

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

}  // namespace

extern "C" {

// Lanes per block and dynamic shared-memory bytes for one code; 0 lanes
// when no block shape fits (Z > 1024 or state above 227 KB per codeword).
int minsum_flood_config(int nb, int Z, int mb, int E, int star_deg,
                        int* lanes, int* smem) {
  return ldpc::decoder_config(
      Z, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); }, lanes,
      smem);
}

const char* minsum_flood_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers but `mc` are device pointers; chan/info/hard/bits/frame may be
// null. With `mc` (host memory) not null it runs the Monte-Carlo megakernel
// (K1-MC): the channel comes from the seed (key0, key1) or the injected
// words, and chan/info are not read. star_deg > 0 (the largest base-row
// degree) selects the min* update with the nthr thresholds at `thr` (host
// memory; beta and alpha are then not read).
int minsum_flood_launch(const void* chan, int chan_is_f32, float scale,
                        const void* info, int kb, void* hard, void* bits,
                        void* frame, void* iters, void* conv,
                        const void* tables, int B, int nb, int Z, int mb,
                        int E, int max_iter, int early_term, int qmax,
                        int beta, int alpha_num, int alpha_shift,
                        int star_deg, const int* thr, int nthr,
                        const ldpc::Mc* mc, void* stream) {
  const ldpc::Kernel kernels[2][2][2] = {
      {{minsum_flood_kernel<false, false, false>,
        minsum_flood_kernel<true, false, false>},
       {minsum_flood_kernel<false, true, false>,
        minsum_flood_kernel<true, true, false>}},
      {{minsum_flood_kernel<false, false, true>,
        minsum_flood_kernel<true, false, true>},
       {minsum_flood_kernel<false, true, true>,
        minsum_flood_kernel<true, true, true>}}};
  return ldpc::launch_instance(
      kernels, [=](int l) { return smem_bytes(nb, Z, mb, E, star_deg, l); },
      ldpc::make_params(chan, chan_is_f32, scale, info, kb, hard, bits,
                        frame, iters, conv, tables, B, nb, Z, mb, E,
                        max_iter, qmax, beta, alpha_num, alpha_shift,
                        star_deg, thr, nthr),
      early_term, mc, stream);
}

}  // extern "C"
