// The min* check-node update (K5) of the decoder kernels (minsum_flood.cu,
// minsum_layered.cu, every instance: fixed, early-terminating, Monte-Carlo).
//
// Replaces ldpc_tpu/kernels/minsum_pallas.py::_cn_minstar (reached through
// cn_upd by every form of the Pallas decoder), with the pinned semantics of
// golden.decoder._cn_update_minstar:
//   leaf(v)   = sign(v) * min(|v|, qmax)            (v the raw post - c2v)
//   bp2(x, y) = sign(x ^ y) * clip(min(|x|, |y|) + corr(|x| + |y|)
//                                  - corr(||x| - |y||), 0, qmax)
//   corr(u)   = #{i : u <= thr[i]}                  (config.minstar_thresholds)
// and, over a row's entries in base-column order,
//   pre[0] = leaf[0], pre[i] = bp2(pre[i-1], leaf[i]),
//   suf[d-1] = leaf[d-1], suf[j] = bp2(leaf[j], suf[j+1]),
//   out[0] = suf[1], out[i] = bp2(pre[i-1], suf[i+1]), out[d-1] = pre[d-2]:
// 3d - 6 combines. bp2 with its clip is not associative, so the grouping is
// part of the result; a combine of magnitude 0 forgets its sign (-0 == 0).
// Rows of degree 1 are refused by the wrapper.
//
// What bounds it on the H100: integer ALU work. Against the min-sum row
// (about 6 integer ops per entry to reduce and 5 to emit) a row costs 3d - 6
// combines of about 12 + 4 * nthr ops; memory traffic is the min-sum
// kernel's plus one int8 scratch store and load per entry.
//
// Design. The row is read twice, as the min-sum row is: back() walks the
// entries d-1 .. 1 and leaves suf[j] in the thread's own column of an int8
// scratch in shared memory ([star_deg][Z][lanes], lane innermost, so a
// warp's accesses are contiguous bytes and free of bank conflicts; |suf| <=
// qmax <= 127); emit() walks 0 .. d-1 with pre in a register. Nothing is
// indexed per thread at run time, so nothing goes to local memory, and no
// barrier is needed: a thread reads only what it wrote.
#pragma once

#include "cn_minsum.cuh"

namespace ldpc {

__device__ inline int star_corr(const Params& p, int u) {
  int c = 0;
  for (int i = 0; i < p.nthr; ++i) c += u <= p.thr[i];
  return c;
}

__device__ inline int star_leaf(int raw, int qmax) {
  const int m = min(abs(raw), qmax);
  return raw < 0 ? -m : m;
}

__device__ inline int star_bp2(const Params& p, int x, int y) {
  const int ax = abs(x), ay = abs(y);
  int mag = min(ax, ay);
  if (p.nthr) mag += star_corr(p, ax + ay) - star_corr(p, abs(ax - ay));
  mag = min(max(mag, 0), p.qmax);
  return (x ^ y) < 0 ? -mag : mag;
}

// Bytes of the scratch for one block.
__host__ __device__ inline size_t star_scratch_bytes(int star_deg, int Z, int lanes) {
  return size_t(star_deg) * Z * lanes;
}

// One check row of degree d >= 2. scr points at this thread's slot 0 and
// slot j lies at scr[j * stride]. Call back(j, raw) for j = d-1 .. 1, then
// emit(i, raw) for i = 0 .. d-1, which returns entry i's new c2v.
struct StarRow {
  int8_t* scr;
  int stride, d;
  int acc = 0;   // suf[j] during back(), pre[i - 1] during emit()

  __device__ inline StarRow(int8_t* scr_, int stride_, int d_)
      : scr(scr_), stride(stride_), d(d_) {}

  __device__ inline void back(const Params& p, int j, int raw) {
    const int leaf = star_leaf(raw, p.qmax);
    acc = j == d - 1 ? leaf : star_bp2(p, leaf, acc);
    scr[j * stride] = int8_t(acc);
  }

  __device__ inline int emit(const Params& p, int i, int raw) {
    const int leaf = star_leaf(raw, p.qmax);
    if (i == 0) {
      acc = leaf;
      return scr[stride];
    }
    if (i == d - 1) return acc;
    const int out = star_bp2(p, acc, int(scr[(i + 1) * stride]));
    acc = star_bp2(p, acc, leaf);
    return out;
  }
};

}  // namespace ldpc
