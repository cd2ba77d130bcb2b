// Fixed-point min-sum flooding decoder for NVIDIA Hopper (sm_90a).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::make_pallas_decoder.kernel in
// its fixed-iteration flooding form (flood_first, flood_iter/flood_pair,
// _cn_minsum, syndrome_ok), including the fused-IO form (quant32 in,
// emit_counts out). Bit-exact with golden.decoder.decode_fixed(schedule=
// "flooding", early_term=False) and with the plain torch version beside
// the wrapper (ldpc_tpu_torch/ops/decode_ref.py).
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
//      s) mod Z] - c2v[e][y], min-sum over the row, c2v[e][y] = new. Only
//      thread y touches c2v[.][y] in this phase, and tot is read-only.
// The CN update follows _cn_minsum: magnitudes min(|v|, qmax) (the v2c
// clip folded in; the sign comes from the raw difference, which the clip
// preserves), min1/min2 by the merge min2 = min(min2, max(min1, m)) with a
// 1 << 14 sentinel, exclusion by value (ties all get min1, as golden's
// stable argmin), the sign product as the XOR of the raw int32 values
// (bit 31; sign(0) = +1), then alpha as (m * num) >> shift and beta as
// max(m - beta, 0) on min1/min2. The row is read twice (once to reduce,
// once to emit) instead of holding up to 32 messages in registers.
// Iteration 1 starts from c2v = 0, which is flood_first's meaning. The
// lane axis is masked at the ragged edge, so any batch size works.
//
// Float input is quantized as quant32 does, round half away from zero:
// __fmul_rn/__fadd_rn keep nvcc from contracting x * scale + 0.5 into an
// FMA, and floorf/ceilf (not roundf/rintf) give the reference's rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinSentinel = 1 << 14;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;      // 227 KB opt-in per block on sm_90
constexpr int kPreferredSmem = 113 * 1024;  // two blocks per SM

struct Params {
  const void* chan;
  int chan_is_f32;
  float scale;
  const uint8_t* info;   // (kb, Z, B) or null
  int kb;
  uint8_t* hard;         // (nb, Z, B) or null
  int32_t* bits;         // (B,) or null
  int32_t* frame;        // (B,) or null
  int32_t* iters;        // (B,)
  uint8_t* conv;         // (B,)
  const int32_t* tables;
  int B, nb, Z, mb, E;
  int max_iter, qmax, beta, alpha_num, alpha_shift;
  int lanes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Table layout (int32): layer_ptr[mb + 1], ent_col[E], ent_shift[E],
// col_ptr[nb + 1], col_ent[E] (entry ids grouped by base column).
__host__ __device__ inline int table_words(int nb, int mb, int E) {
  return (mb + 1) + 3 * E + (nb + 1);
}

__host__ __device__ inline size_t smem_bytes(int nb, int Z, int mb, int E, int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(4 * size_t(table_words(nb, mb, E)))
       + align16(8 * size_t(lanes))          // per-lane unsat flag, bit errors
       + align16(2 * n * lanes)               // tot
       + align16(n * lanes)                   // chan
       + align16(size_t(E) * Z * lanes);      // c2v
}

int pick_lanes(int nb, int Z, int mb, int E) {
  const int limits[2] = {kPreferredSmem, kMaxSmem};
  for (int k = 0; k < 2; ++k) {
    for (int lanes = 32; lanes >= 1; lanes /= 2) {
      if (lanes * Z <= kMaxThreads && smem_bytes(nb, Z, mb, E, lanes) <= size_t(limits[k]))
        return lanes;
    }
  }
  return 0;
}

__global__ void minsum_flood_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.lanes, Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const int n = nb * Z;
  const int T = table_words(nb, mb, E);

  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  unsigned char* cursor = smem + align16(4 * size_t(T));
  int32_t* s_unsat = reinterpret_cast<int32_t*>(cursor);
  int32_t* s_bits = s_unsat + L;
  cursor += align16(8 * size_t(L));
  int16_t* tot = reinterpret_cast<int16_t*>(cursor);
  cursor += align16(2 * size_t(n) * L);
  int8_t* chan = reinterpret_cast<int8_t*>(cursor);
  cursor += align16(size_t(n) * L);
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
    s_unsat[tid] = 0;
    s_bits[tid] = 0;
  }
  const int32_t* layer_ptr = tab;
  const int32_t* ent_col = layer_ptr + mb + 1;
  const int32_t* ent_shift = ent_col + E;
  const int32_t* col_ptr = ent_shift + E;
  const int32_t* col_ent = col_ptr + nb + 1;

  // Channel in: this thread owns row `row` of every base column.
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    int q = 0;
    if (valid) {
      const size_t g = size_t(v) * p.B + b;
      if (p.chan_is_f32) {
        const float xs = __fmul_rn(static_cast<const float*>(p.chan)[g], p.scale);
        float r = xs >= 0.f ? floorf(__fadd_rn(xs, 0.5f)) : ceilf(__fadd_rn(xs, -0.5f));
        r = fminf(fmaxf(r, -float(qmax)), float(qmax));
        q = int(r);
      } else {
        q = static_cast<const int8_t*>(p.chan)[g];
      }
    }
    chan[v * L + lane] = int8_t(q);
  }
  for (int i = tid; i < E * Z * L; i += nthreads) c2v[i] = 0;
  __syncthreads();

  const bool has_alpha = p.alpha_num != 1 || p.alpha_shift != 0;
  for (int it = 0;; ++it) {
    // V phase: totals of the current messages.
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      int acc = chan[v * L + lane];
      for (int q = col_ptr[j]; q < col_ptr[j + 1]; ++q) {
        const int e = col_ent[q];
        int r = row - ent_shift[e];
        if (r < 0) r += Z;
        acc += c2v[(e * Z + r) * L + lane];
      }
      tot[v * L + lane] = int16_t(acc);
    }
    __syncthreads();
    if (it == p.max_iter) break;

    // C phase: check row `row` of every base row.
    for (int li = 0; li < mb; ++li) {
      const int e0 = layer_ptr[li], e1 = layer_ptr[li + 1];
      int min1 = kMinSentinel, min2 = kMinSentinel, negacc = 0;
      for (int e = e0; e < e1; ++e) {
        int c = row + ent_shift[e];
        if (c >= Z) c -= Z;
        const int raw = int(tot[(ent_col[e] * Z + c) * L + lane])
                      - int(c2v[(e * Z + row) * L + lane]);
        const int m = min(abs(raw), qmax);
        min2 = min(min2, max(min1, m));
        min1 = min(min1, m);
        negacc ^= raw;
      }
      int min1o = min1, min2o = min2;
      if (has_alpha) {
        min1o = (min1o * p.alpha_num) >> p.alpha_shift;
        min2o = (min2o * p.alpha_num) >> p.alpha_shift;
      }
      if (p.beta) {
        min1o = max(min1o - p.beta, 0);
        min2o = max(min2o - p.beta, 0);
      }
      for (int e = e0; e < e1; ++e) {
        int c = row + ent_shift[e];
        if (c >= Z) c -= Z;
        const int idx = (e * Z + row) * L + lane;
        const int raw = int(tot[(ent_col[e] * Z + c) * L + lane]) - int(c2v[idx]);
        const int m = min(abs(raw), qmax);
        const int mag = m == min1 ? min2o : min1o;
        c2v[idx] = int8_t((negacc ^ raw) < 0 ? -mag : mag);
      }
    }
    __syncthreads();
  }

  // Outputs from the final totals: hard bits or info-bit errors, syndrome.
  int nerr = 0;
  for (int j = 0; j < nb; ++j) {
    const int v = j * Z + row;
    const int h = tot[v * L + lane] < 0;
    if (valid) {
      const size_t g = size_t(v) * p.B + b;
      if (p.hard) p.hard[g] = uint8_t(h);
      if (p.info && j < p.kb) nerr += h ^ int(p.info[g]);
    }
  }
  int unsat = 0;
  for (int li = 0; li < mb; ++li) {
    int x = 0;
    for (int e = layer_ptr[li]; e < layer_ptr[li + 1]; ++e) {
      int c = row + ent_shift[e];
      if (c >= Z) c -= Z;
      x ^= int(tot[(ent_col[e] * Z + c) * L + lane]);  // bit 31: sign parity
    }
    unsat |= x < 0;
  }
  if (unsat) atomicOr(&s_unsat[lane], 1);
  if (nerr) atomicAdd(&s_bits[lane], nerr);
  __syncthreads();
  if (row == 0 && valid) {
    p.iters[b] = p.max_iter;
    p.conv[b] = s_unsat[lane] == 0;
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
int minsum_flood_config(int nb, int Z, int mb, int E, int* lanes, int* smem) {
  const int l = pick_lanes(nb, Z, mb, E);
  *lanes = l;
  *smem = l ? int(smem_bytes(nb, Z, mb, E, l)) : 0;
  return l ? 0 : int(cudaErrorInvalidConfiguration);
}

const char* minsum_flood_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers; info/hard/bits/frame may be null.
int minsum_flood_launch(const void* chan, int chan_is_f32, float scale,
                        const void* info, int kb, void* hard, void* bits,
                        void* frame, void* iters, void* conv,
                        const void* tables, int B, int nb, int Z, int mb,
                        int E, int max_iter, int qmax, int beta,
                        int alpha_num, int alpha_shift, void* stream) {
  int lanes = 0, smem = 0;
  const int cfg = minsum_flood_config(nb, Z, mb, E, &lanes, &smem);
  if (cfg) return cfg;
  if (B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      minsum_flood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  Params p;
  p.chan = chan;
  p.chan_is_f32 = chan_is_f32;
  p.scale = scale;
  p.info = static_cast<const uint8_t*>(info);
  p.kb = kb;
  p.hard = static_cast<uint8_t*>(hard);
  p.bits = static_cast<int32_t*>(bits);
  p.frame = static_cast<int32_t*>(frame);
  p.iters = static_cast<int32_t*>(iters);
  p.conv = static_cast<uint8_t*>(conv);
  p.tables = static_cast<const int32_t*>(tables);
  p.B = B;
  p.nb = nb;
  p.Z = Z;
  p.mb = mb;
  p.E = E;
  p.max_iter = max_iter;
  p.qmax = qmax;
  p.beta = beta;
  p.alpha_num = alpha_num;
  p.alpha_shift = alpha_shift;
  p.lanes = lanes;
  const dim3 block(lanes, Z);
  const dim3 grid((B + lanes - 1) / lanes);
  minsum_flood_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
