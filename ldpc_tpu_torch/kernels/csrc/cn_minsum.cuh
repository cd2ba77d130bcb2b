// Parts shared by the min-sum decoder kernels (minsum_flood.cu,
// minsum_layered.cu): launch parameters, the entry tables, the in-kernel
// quantizer and the check-node update. One copy, so the two schedules
// cannot drift apart in the arithmetic that makes them bit-exact.
//
// The CN update follows ldpc_tpu/kernels/minsum_pallas.py::_cn_minsum:
// magnitudes min(|v|, qmax) (the v2c clip folded in; the sign comes from
// the raw difference, which the clip preserves), min1/min2 by the merge
// min2 = min(min2, max(min1, m)) with a 1 << 14 sentinel, exclusion by
// value (ties all get min1, as golden's stable argmin), the sign product
// as the XOR of the raw int32 values (bit 31; sign(0) = +1), then alpha as
// (m * num) >> shift and beta as max(m - beta, 0) on min1/min2.
//
// Float input is quantized as quant32 (minsum_pallas.py:566) does, round
// half away from zero: __fmul_rn/__fadd_rn keep nvcc from contracting
// x * scale + 0.5 into an FMA, and floorf/ceilf (not roundf/rintf) give
// the reference's rounding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ldpc {

constexpr int kMinSentinel = 1 << 14;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;            // 227 KB opt-in per block on sm_90
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

struct Tables {
  const int32_t* layer_ptr;
  const int32_t* ent_col;
  const int32_t* ent_shift;
  const int32_t* col_ptr;
  const int32_t* col_ent;
};

__device__ inline Tables tables_at(const int32_t* tab, int nb, int mb, int E) {
  Tables t;
  t.layer_ptr = tab;
  t.ent_col = t.layer_ptr + mb + 1;
  t.ent_shift = t.ent_col + E;
  t.col_ptr = t.ent_shift + E;
  t.col_ent = t.col_ptr + nb + 1;
  return t;
}

// The most codewords per block (a power of two <= 32, lanes * Z <= 1024
// threads) whose state fits 113 KB, so two blocks share an SM; else the
// most that fit the 227 KB opt-in; 0 when none does.
template <typename SmemFn>
int pick_lanes(int Z, SmemFn smem_bytes) {
  const int limits[2] = {kPreferredSmem, kMaxSmem};
  for (int k = 0; k < 2; ++k) {
    for (int lanes = 32; lanes >= 1; lanes /= 2) {
      if (lanes * Z <= kMaxThreads && smem_bytes(lanes) <= size_t(limits[k]))
        return lanes;
    }
  }
  return 0;
}

__device__ inline int quant32(float x, float scale, int qmax) {
  const float xs = __fmul_rn(x, scale);
  float r = xs >= 0.f ? floorf(__fadd_rn(xs, 0.5f)) : ceilf(__fadd_rn(xs, -0.5f));
  r = fminf(fmaxf(r, -float(qmax)), float(qmax));
  return int(r);
}

// The channel value of variable g = v * B + b, quantized when it is float.
__device__ inline int load_chan(const Params& p, size_t g) {
  if (p.chan_is_f32)
    return quant32(static_cast<const float*>(p.chan)[g], p.scale, p.qmax);
  return static_cast<const int8_t*>(p.chan)[g];
}

// One check row's reduction: feed every raw v2c value with add(), then
// finish() applies alpha and beta; emit() gives the new c2v of a slot
// from its raw value.
struct CnRow {
  int min1 = kMinSentinel, min2 = kMinSentinel, negacc = 0;
  int min1o = 0, min2o = 0;

  __device__ inline void add(int raw, int qmax) {
    const int m = min(abs(raw), qmax);
    min2 = min(min2, max(min1, m));
    min1 = min(min1, m);
    negacc ^= raw;
  }

  __device__ inline void finish(const Params& p) {
    min1o = min1;
    min2o = min2;
    if (p.alpha_num != 1 || p.alpha_shift != 0) {
      min1o = (min1o * p.alpha_num) >> p.alpha_shift;
      min2o = (min2o * p.alpha_num) >> p.alpha_shift;
    }
    if (p.beta) {
      min1o = max(min1o - p.beta, 0);
      min2o = max(min2o - p.beta, 0);
    }
  }

  __device__ inline int emit(int raw, int qmax) const {
    const int m = min(abs(raw), qmax);
    const int mag = m == min1 ? min2o : min1o;
    return (negacc ^ raw) < 0 ? -mag : mag;
  }
};

// 1 when check row `row` of some base row is unsatisfied by the hard bits
// of `vals` (int16 [n][lanes], sign = hard bit): bit 31 of the XOR of the
// values is the parity of their signs.
__device__ inline int rows_unsat(const Tables& t, const int16_t* vals, int mb,
                                 int Z, int L, int row, int lane) {
  int unsat = 0;
  for (int li = 0; li < mb; ++li) {
    int x = 0;
    for (int e = t.layer_ptr[li]; e < t.layer_ptr[li + 1]; ++e) {
      int c = row + t.ent_shift[e];
      if (c >= Z) c -= Z;
      x ^= int(vals[(t.ent_col[e] * Z + c) * L + lane]);
    }
    unsat |= x < 0;
  }
  return unsat;
}

// Host side of each library's C interface (<name>_config, <name>_launch).
// smem_bytes(lanes) is the kernel's dynamic shared memory for one block.
template <typename SmemFn>
int decoder_config(int Z, SmemFn smem_bytes, int* lanes, int* smem) {
  const int l = pick_lanes(Z, smem_bytes);
  *lanes = l;
  *smem = l ? int(smem_bytes(l)) : 0;
  return l ? 0 : int(cudaErrorInvalidConfiguration);
}

inline Params make_params(const void* chan, int chan_is_f32, float scale,
                          const void* info, int kb, void* hard, void* bits,
                          void* frame, void* iters, void* conv,
                          const void* tables, int B, int nb, int Z, int mb,
                          int E, int max_iter, int qmax, int beta,
                          int alpha_num, int alpha_shift) {
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
  p.lanes = 0;
  return p;
}

// Launches kern over ceil(B / lanes) blocks of (lanes, Z) threads on
// `stream` and returns cudaGetLastError() (0 on success).
template <typename SmemFn>
int decoder_launch(void (*kern)(Params), SmemFn smem_bytes, Params p,
                   void* stream) {
  int smem = 0;
  const int cfg = decoder_config(p.Z, smem_bytes, &p.lanes, &smem);
  if (cfg) return cfg;
  if (p.B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 block(p.lanes, p.Z);
  const dim3 grid((p.B + p.lanes - 1) / p.lanes);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // namespace ldpc
