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
// sublane question; here there is one layout and no rotation. One block
// owns `lanes` codewords; thread (x, y) = (lane, row y of every base
// column), as in minsum_flood.cu. The state lives in shared memory with the
// lane innermost, so a warp touches contiguous words:
//   a, b   int32 [n][lanes]         the ping-pong totals
//   chan   int8  [n][lanes]         the channel values, added every sweep
//   c2v    int32 or int16 [E * Z][lanes]   messages (minsum only)
// and a circulant shift is the index (y + s) mod Z.
//   sweep:  dst[j][y] = chan[j][y] + sum over the entries (j, s) of column
//     j of src[j][(y + s) mod Z], gathered by the thread that owns
//     dst[j][y]: no write is shared, one barrier a sweep. The variant without
//     the rotation runs the same kernel on tables whose shifts are zero, so
//     the two differ in addresses only (a flag in the kernel would let the
//     compiler hoist the then constant load out of the column's loop). The totals grow
//     by about the column degree a sweep and wrap int32 after a few dozen
//     sweeps, as they do in XLA: all sums are uint32_t.
//   minsum: the reference accumulates rot(new, Z - s) into the next totals
//     base row by base row, which on threads would make the writer of
//     dst[j][y] change with the base row (a barrier a row, 13 a sweep). The
//     same sums are taken here as minsum_flood.cu takes them: a C phase in
//     which thread y updates check row y of every base row (only it touches
//     c2v[.][y], src is read-only), a barrier, and a V phase in which the
//     owner of dst[j][y] gathers chan + sum c2v[e][(y - s) mod Z]: two
//     barriers a sweep, no atomics. Integer addition commutes, so the
//     totals are the reference's. The script keys its message slots by
//     (column, shift), so entries of different base rows that share both
//     share a slot (17 pairs in wifi-648): the later row reads as its old
//     message what the earlier row wrote in the same sweep. That is what
//     the body computes, so it is kept: an entry reads and writes slot
//     ent_slot[e], and also writes its own c2v[e], which only the V phase
//     reads. Thread y alone touches c2v[.][y] in the C phase, base rows in
//     order, so the sharing needs no barrier. The check-node rule is the script's, not
//     the decoders': min2 starts at 1 << 14, the sign is bit 31 of the XOR
//     of the clipped values (a zero counts as positive), and the excluded
//     minimum is chosen by value (m == min1), not by position.
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
// grid32 / grid1 (S5, S6): one __device__ work() (400 dependent steps), run
// once with a block group a tile (grid.y = 32) and once with one block group
// that loops over the 32 tiles. On the TPU the grid runs in order, so the
// difference is a per-step overhead; here blocks run in parallel, so it is
// the price of serialising tiles inside a block against scheduling more
// blocks.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;   // the 227 KB opt-in of sm_90

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// int32 words of the entry tables (kernels/microbench.py::graph_tables):
// layer_ptr[mb + 1], ent_col[E], ent_shift[E], col_ptr[nb + 1], col_ent[E],
// ent_slot[E].
__host__ __device__ inline int table_words(int nb, int mb, int E) {
  return (mb + 1) + 4 * E + (nb + 1);
}

struct Tables {
  const int32_t* layer_ptr;
  const int32_t* ent_col;
  const int32_t* ent_shift;
  const int32_t* col_ptr;
  const int32_t* col_ent;
  const int32_t* ent_slot;
};

__device__ inline Tables tables_at(const int32_t* tab, int nb, int mb, int E) {
  Tables t;
  t.layer_ptr = tab;
  t.ent_col = t.layer_ptr + (mb + 1);
  t.ent_shift = t.ent_col + E;
  t.col_ptr = t.ent_shift + E;
  t.col_ent = t.col_ptr + (nb + 1);
  t.ent_slot = t.col_ent + E;
  return t;
}

// Dynamic shared memory of a block of `lanes` codewords; c2v_bytes is 0 for
// sweep, 2 or 4 for minsum.
inline size_t state_bytes(int nb, int Z, int mb, int E, int c2v_bytes,
                          int lanes) {
  const size_t n = size_t(nb) * Z;
  return align16(4 * size_t(table_words(nb, mb, E)))
       + 2 * align16(4 * n * lanes)                        // a, b
       + align16(n * lanes)                                // chan
       + align16(size_t(c2v_bytes) * E * Z * lanes);       // c2v
}

struct State {
  int32_t* tab;
  uint32_t* a;
  uint32_t* b;
  int8_t* chan;
  unsigned char* c2v;
};

__device__ inline State carve(unsigned char* smem, int nb, int Z, int mb,
                              int E, int L) {
  const size_t n = size_t(nb) * Z;
  State s;
  s.tab = reinterpret_cast<int32_t*>(smem);
  smem += align16(4 * size_t(table_words(nb, mb, E)));
  s.a = reinterpret_cast<uint32_t*>(smem);
  smem += align16(4 * n * L);
  s.b = reinterpret_cast<uint32_t*>(smem);
  smem += align16(4 * n * L);
  s.chan = reinterpret_cast<int8_t*>(smem);
  smem += align16(n * L);
  s.c2v = smem;
  return s;
}

struct SweepArgs {
  const int8_t* chan;      // (nb, Z, B), B innermost
  int8_t* out;             // (nb, Z, B)
  const int32_t* tables;
  int B, nb, Z, mb, E, lanes, iters, qmax;
};

// Tables and channel in; a = chan; returns whether this lane is in the batch.
__device__ inline bool load_state(const SweepArgs& p, const State& s,
                                  long long b, int lane, int row) {
  const int L = p.lanes, Z = p.Z;
  const int tid = row * L + lane, nthreads = L * Z;
  const int T = table_words(p.nb, p.mb, p.E);
  for (int i = tid; i < T; i += nthreads) s.tab[i] = p.tables[i];
  const bool valid = b < p.B;
  for (int j = 0; j < p.nb; ++j) {
    const int v = j * Z + row;
    const int q = valid ? int(p.chan[size_t(v) * p.B + b]) : 0;
    s.chan[v * L + lane] = int8_t(q);
    s.a[v * L + lane] = uint32_t(q);
  }
  return valid;
}

// The int32 totals out as int8: the low byte, not a saturation.
__device__ inline void store_state(const SweepArgs& p, const uint32_t* tot,
                                   bool valid, long long b, int lane,
                                   int row) {
  if (!valid) return;
  for (int j = 0; j < p.nb; ++j) {
    const int v = j * p.Z + row;
    p.out[size_t(v) * p.B + b] =
        static_cast<int8_t>(static_cast<uint8_t>(tot[v * p.lanes + lane]));
  }
}

__global__ void sweep_kernel(SweepArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.lanes, Z = p.Z, nb = p.nb;
  const State s = carve(smem, nb, Z, p.mb, p.E, L);
  const int lane = threadIdx.x, row = threadIdx.y;
  const long long b = (long long)blockIdx.x * L + lane;
  const bool valid = load_state(p, s, b, lane, row);
  const Tables t = tables_at(s.tab, nb, p.mb, p.E);
  __syncthreads();

  uint32_t* src = s.a;
  uint32_t* dst = s.b;
  const int sweeps = 2 * (p.iters / 2);
  for (int it = 0; it < sweeps; ++it) {
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      uint32_t acc = uint32_t(int(s.chan[v * L + lane]));
      for (int q = t.col_ptr[j]; q < t.col_ptr[j + 1]; ++q) {
        int c = row + t.ent_shift[t.col_ent[q]];
        if (c >= Z) c -= Z;
        acc += src[(j * Z + c) * L + lane];
      }
      dst[v * L + lane] = acc;
    }
    __syncthreads();
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  store_state(p, src, valid, b, lane, row);
}

__device__ inline int clip(int x, int q) { return max(-q, min(q, x)); }

template <typename C2V>
__global__ void minsum_kernel(SweepArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.lanes, Z = p.Z, nb = p.nb, mb = p.mb, E = p.E;
  const State s = carve(smem, nb, Z, mb, E, L);
  C2V* c2v = reinterpret_cast<C2V*>(s.c2v);
  const int lane = threadIdx.x, row = threadIdx.y;
  const int tid = row * L + lane, nthreads = L * Z;
  const long long b = (long long)blockIdx.x * L + lane;
  const bool valid = load_state(p, s, b, lane, row);
  const Tables t = tables_at(s.tab, nb, mb, E);
  for (int i = tid; i < E * Z * L; i += nthreads) c2v[i] = 0;
  __syncthreads();

  const int qmax = p.qmax;
  int32_t* src = reinterpret_cast<int32_t*>(s.a);
  int32_t* dst = reinterpret_cast<int32_t*>(s.b);
  const int sweeps = 2 * (p.iters / 2);
  for (int it = 0; it < sweeps; ++it) {
    // C phase: check row `row` of every base row. The row is read twice,
    // once to reduce and once to emit, as minsum_flood.cu does.
    for (int li = 0; li < mb; ++li) {
      const int e0 = t.layer_ptr[li], e1 = t.layer_ptr[li + 1];
      auto v2c = [&](int e) {
        int c = row + t.ent_shift[e];
        if (c >= Z) c -= Z;
        return clip(src[(t.ent_col[e] * Z + c) * L + lane]
                        - int(c2v[(t.ent_slot[e] * Z + row) * L + lane]),
                    qmax);
      };
      int min1 = 0, min2 = 1 << 14, negacc = 0;
      for (int e = e0; e < e1; ++e) {
        const int v = v2c(e);
        const int m = abs(v);
        if (e == e0) {
          min1 = m;
          negacc = v;
        } else {
          min2 = min(min2, max(min1, m));
          min1 = min(min1, m);
          negacc ^= v;                  // bit 31: the row's sign parity
        }
      }
      for (int e = e0; e < e1; ++e) {
        const int v = v2c(e);
        const int mag = abs(v) == min1 ? min2 : min1;
        const C2V nw = C2V((negacc ^ v) < 0 ? -mag : mag);
        c2v[(e * Z + row) * L + lane] = nw;
        const int slot = t.ent_slot[e];
        if (slot != e) c2v[(slot * Z + row) * L + lane] = nw;
      }
    }
    __syncthreads();
    // V phase: the next totals, gathered by their owner.
    for (int j = 0; j < nb; ++j) {
      const int v = j * Z + row;
      int acc = s.chan[v * L + lane];
      for (int q = t.col_ptr[j]; q < t.col_ptr[j + 1]; ++q) {
        const int e = t.col_ent[q];
        int r = row - t.ent_shift[e];
        if (r < 0) r += Z;
        acc += int(c2v[(e * Z + r) * L + lane]);
      }
      dst[v * L + lane] = acc;
    }
    __syncthreads();
    int32_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  store_state(p, reinterpret_cast<uint32_t*>(src), valid, b, lane, row);
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

// a = x; b = a ^ 11; iters x n_pairs x (a = |b - a|; b = min(b, max(a, b ^
// a))) on ILP independent elements a thread; element k of thread i is
// x[i + k * n_threads].
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
      for (int k = 0; k < ILP; ++k) {
        const uint32_t d = b[k] - a[k];            // wraps, as XLA
        a[k] = int32_t(d) < 0 ? 0u - d : d;        // |INT_MIN| = INT_MIN
        b[k] = uint32_t(min(int32_t(b[k]),
                            max(int32_t(a[k]), int32_t(b[k] ^ a[k]))));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ILP; ++k)
    out[size_t(i) + size_t(k) * n_threads] =
        static_cast<int8_t>(static_cast<uint8_t>(a[k]));
}

// `inner` dependent v = max(v ^ (v + 1), v - 3) in wrapping int32.
__device__ inline uint32_t work(uint32_t v, int inner) {
  for (int i = 0; i < inner; ++i) {
    const uint32_t p = v ^ (v + 1u);
    const uint32_t m = v - 3u;
    v = int32_t(p) > int32_t(m) ? p : m;
  }
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

// grid = ceil(rows * tile_w / threads): one block group loops over the tiles.
__global__ void grid1_kernel(const int8_t* x, int8_t* out, int rows,
                             int tile_w, int n_tiles, int inner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * tile_w) return;
  for (int tile = 0; tile < n_tiles; ++tile)
    work_tile(x, out, i, tile, tile_w, n_tiles, inner);
}

constexpr int kThreads = 128;   // block size of the register kernels

template <typename Kernel>
int launch_sweep(Kernel kernel, const SweepArgs& p, int c2v_bytes,
                 void* stream) {
  if (p.lanes < 1 || p.Z < 1 || p.lanes * p.Z > kMaxThreads || p.B < 1)
    return int(cudaErrorInvalidConfiguration);
  const size_t smem = state_bytes(p.nb, p.Z, p.mb, p.E, c2v_bytes, p.lanes);
  if (smem > kMaxSmem) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 block(p.lanes, p.Z);
  const unsigned grid = unsigned((p.B + p.lanes - 1) / p.lanes);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* microbench_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared-memory bytes of a sweep (c2v_bytes 0) or minsum (2, 4)
// block of `lanes` codewords, as the launches compute them.
int microbench_config(int nb, int Z, int mb, int E, int c2v_bytes, int lanes,
                      long long* smem) {
  *smem = (long long)state_bytes(nb, Z, mb, E, c2v_bytes, lanes);
  return 0;
}

// Every launch runs on `stream` and returns cudaGetLastError() (0 on
// success); all pointers are device pointers.

int microbench_sweep_launch(const void* chan, void* out, const void* tables,
                            int B, int nb, int Z, int mb, int E, int lanes,
                            int iters, void* stream) {
  const SweepArgs p{static_cast<const int8_t*>(chan),
                    static_cast<int8_t*>(out),
                    static_cast<const int32_t*>(tables),
                    B, nb, Z, mb, E, lanes, iters, 0};
  return launch_sweep(sweep_kernel, p, 0, stream);
}

int microbench_minsum_launch(const void* chan, void* out, const void* tables,
                             int B, int nb, int Z, int mb, int E, int lanes,
                             int iters, int qmax, int c2v_bytes,
                             void* stream) {
  const SweepArgs p{static_cast<const int8_t*>(chan),
                    static_cast<int8_t*>(out),
                    static_cast<const int32_t*>(tables),
                    B, nb, Z, mb, E, lanes, iters, qmax};
  if (c2v_bytes == 4) return launch_sweep(minsum_kernel<int32_t>, p, 4, stream);
  if (c2v_bytes == 2) return launch_sweep(minsum_kernel<int16_t>, p, 2, stream);
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
  if (rows < 1 || tile_w < 1 || n_tiles < 1)
    return int(cudaErrorInvalidValue);
  grid1_kernel<<<(rows * tile_w + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), rows, tile_w,
      n_tiles, inner);
  return int(cudaGetLastError());
}

}  // extern "C"
