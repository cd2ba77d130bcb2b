// The Monte-Carlo megakernel's prologue for the min-sum decoder kernels
// (minsum_flood.cu, minsum_layered.cu; compile-time branch MC): random
// words -> info bits -> structured QC encode -> BPSK + Box-Muller AWGN +
// demap + quantize, all in shared memory, in place of loading channel
// LLRs from device memory.
//
// Replaces the mc branch of ldpc_tpu/kernels/minsum_pallas.py::kernel
// (:432-558): the TPU hardware PRNG becomes Philox4x32-10 (philox.cuh)
// keyed by the batch seed and counted by (global lane, word / 4), so a
// lane's draws depend neither on the block shape nor on the rank of a
// process mesh that launches it (Mc::lane0 is the rank's first lane);
// inject mode reads the launch's words from a (W, B) int32 tensor instead
// (the reference's inject_random test hook). Word layout per lane (ops/rng.py::word_layout): kb*Z info
// words, then nph*Z words n1 and nph*Z words n2 of the Box-Muller pairs,
// nph = ceil(nb / 2). The plain torch version is ops/mc.py.
//
// Thread (lane, y) owns row y of every base column. The codeword bits live
// in `cw`, uint8 [n][lanes] (the c2v buffer, free until the decode starts;
// E * Z >= n). The encode (codes/qcstruct.qc_encode_numpy) needs three
// barriers, each reached by every thread (lanes past the batch included:
// their data is masked, not their barriers):
//   info bits -> barrier -> p0[y] = XOR of the core rows' lambda[y]
//   -> barrier -> the zero-shift staircase par[t+1][y] = lambda_t[y] ^
//   p0[(y + s0_t) mod Z] ^ par[t][y], local to the thread (row t reads
//   columns <= kb only) -> barrier -> extension rows (they read columns
//   < kb + cb only, and write their own identity column).
// The float stage then reads only the thread's own rows, so it needs no
// barrier before it; the caller puts one after it, before c2v is zeroed.
//
// Float stage, bit-exact with ops/mc.py on the card: one rounding per op
// in the reference's order (__fmul_rn/__fadd_rn keep nvcc from forming
// FMAs) and the IEEE logf/sqrtf/cosf/sinf that torch's CUDA kernels call:
//   to_unit(w) = float(w >> 8) * 2^-24 + 2^-25                 in (0, 1]
//   r = sqrt(-2 log to_unit(n1)), theta = float(2 pi) * to_unit(n2)
//   block 2p takes r cos(theta), block 2p + 1 takes r sin(theta)
//   xs = ((1 - 2c) + sigma * nrm) * gain, q = round half away, clip qmax.
#pragma once

#include "cn_minsum.cuh"
#include "philox.cuh"

namespace ldpc {

// Word w of lane b: Philox at global lane lane0 + b, or the injected
// tensor (the launch's own lanes).
__device__ inline uint32_t mc_word(const Params& p, long long b, int w) {
  if (p.mc.words) return uint32_t(p.mc.words[size_t(w) * p.B + b]);
  return philox_word(p.mc.key0, p.mc.key1, p.mc.lane0 + b, w);
}

// The info bit of (base column j < kb, row) of lane b, drawn again.
__device__ inline int mc_info_bit(const Params& p, long long b, int j,
                                  int row) {
  return int(mc_word(p, b, j * p.Z + row) & 1u);
}

// XOR over base row li's entries (col, s) with lo <= col < hi of
// cw[col][(row + s) mod Z] (columns ascend within a row).
__device__ inline int lam_range(const Tables& t, const uint8_t* cw, int li,
                                int lo, int hi, int Z, int L, int row,
                                int lane) {
  int x = 0;
  for (int e = t.layer_ptr[li]; e < t.layer_ptr[li + 1]; ++e) {
    const int col = t.ent_col[e];
    if (col < lo) continue;
    if (col >= hi) break;
    int c = row + t.ent_shift[e];
    if (c >= Z) c -= Z;
    x ^= cw[(col * Z + c) * L + lane];
  }
  return x;
}

__device__ inline float mc_unit(uint32_t w) {
  return __fadd_rn(__fmul_rn(float(w >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

__device__ inline int mc_quant(int c, float nrm, float sigma, float gain,
                               int qmax) {
  const float x = c ? -1.f : 1.f;
  const float xs = __fmul_rn(__fadd_rn(x, __fmul_rn(sigma, nrm)), gain);
  float r = xs >= 0.f ? floorf(__fadd_rn(xs, 0.5f)) : ceilf(__fadd_rn(xs, -0.5f));
  r = fminf(fmaxf(r, -float(qmax)), float(qmax));
  return int(r);
}

// Writes lane `lane`'s quantized channel LLR of row `row` of every base
// column into out[(j * Z + row) * L + lane] (0 on lanes past the batch).
// Every thread of the block must call it.
template <typename T>
__device__ void mc_prologue(const Params& p, const Tables& t, uint8_t* cw,
                            T* out, bool valid, long long b, int row,
                            int lane) {
  const int Z = p.Z, L = p.lanes, nb = p.nb, mb = p.mb;
  const int kb = p.kb, cb = p.mc.cb;
  const int nph = (nb + 1) / 2;
  const int k = kb * Z;

  // 1. info bits: one word per bit, its least significant bit
  for (int j = 0; j < kb; ++j)
    cw[(j * Z + row) * L + lane] = valid ? uint8_t(mc_info_bit(p, b, j, row)) : 0;
  __syncthreads();

  // 2. p0 = XOR of the core rows' syndromes of the info part (the two
  //    C(sigma) terms of the weight-3 column cancel)
  int p0 = 0;
  for (int i = 0; i < cb; ++i) p0 ^= lam_range(t, cw, i, 0, kb, Z, L, row, lane);
  cw[(kb * Z + row) * L + lane] = uint8_t(p0);
  __syncthreads();

  // 3. staircase over the core rows: row tt reads the info part and
  //    C(s0) p0 (columns <= kb), and par[tt] for tt > 0
  int par = 0;
  for (int tt = 0; tt < cb - 1; ++tt) {
    par ^= lam_range(t, cw, tt, 0, kb + 1, Z, L, row, lane);
    cw[((kb + tt + 1) * Z + row) * L + lane] = uint8_t(par);
  }
  __syncthreads();

  // 4. extension rows: their own identity column from columns < kb + cb
  for (int e = cb; e < mb; ++e)
    cw[((kb + e) * Z + row) * L + lane] =
        uint8_t(lam_range(t, cw, e, 0, kb + cb, Z, L, row, lane));

  // 5. BPSK + AWGN + demap + quantize on the thread's own rows
  float sigma = p.mc.sigma, gain = p.mc.gain;
  if (p.mc.sigma_lane && valid) {
    sigma = p.mc.sigma_lane[b];
    gain = p.mc.gain_lane[b];
  }
  for (int q = 0; q < nph; ++q) {
    float nrm[2] = {0.f, 0.f};
    if (valid) {
      const float f1 = mc_unit(mc_word(p, b, k + q * Z + row));
      const float f2 = mc_unit(mc_word(p, b, k + (nph + q) * Z + row));
      const float r = sqrtf(__fmul_rn(-2.f, logf(f1)));
      const float th = __fmul_rn(float(2.0 * 3.14159265358979323846), f2);
      nrm[0] = __fmul_rn(r, cosf(th));
      nrm[1] = __fmul_rn(r, sinf(th));
    }
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * q + h;
      if (j >= nb) break;
      const int v = (j * Z + row) * L + lane;
      out[v] = T(valid ? mc_quant(cw[v], nrm[h], sigma, gain, p.qmax) : 0);
    }
  }
}

}  // namespace ldpc
