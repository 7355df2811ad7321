// T1: the direction bytes of full-mode traceback, for a padded batch of
// (query, target) pairs.
//
// Replaces: pyopal_tpu/ops/traceback.py::_dir_matrix_batch (l.53), a jitted
// lax.scan over target columns (XLA in the reference, not Pallas).  Same
// bytes: for pair b and DP cell (i, j), the byte of row i - 1 and column
// j - 1 holds the source of H in bits 0-1 (diagonal, then E, then F; in sw
// DIR_STOP where H == 0), E_OPEN in bit 2 (H[i][j-1] - go >= E[i][j-1] -
// ge) and F_OPEN in bit 3 (H[i-1][j] - go >= F[i-1][j] - ge, row 1 against
// NEG).  F is the sequential max(H[i-1] - go, F[i-1] - ge), which gives
// the reference's prefix-max F, H and bits at every gap pair (at ge > go a
// reopening always beats an extension).  Every byte of the output is
// written: columns at or beyond a pair's length (all of a padding pair's)
// and the rows between Q and Qs are 0, so the wrapper allocates it with
// torch.empty and the bytes cross device memory once.
//
// Layout: (B, T_pad, Qs) bytes, Qs = Q rounded up to 16: a column's rows
// are contiguous, so a thread's R rows at one column are R contiguous
// bytes (one 8-byte word) and a group's G * R rows one coalesced run.  The
// wrapper presents the (B, Q, T_pad) values as a transposed view, and T2
// walks this layout as it is.  In the reference's (B, Q, T_pad) layout a
// thread's rows lie T_pad bytes apart: a byte store a cell, or words of
// four columns a row stored by a quarter of the lanes at each step.
//
// What bounds it on an H100: its int32 instructions.  A cell needs 16
// int32 operations (sw: G, E, F, the diagonal, the clamp and the maxes of
// H, the code's and the open bits' compares, the byte's packing); the
// card issues 64 int32 lanes an SM a clock, half a warp instruction a
// scheduler a clock, so one warp a scheduler is enough to reach that rate
// and a batch of fewer warps than the 528 schedulers leaves the rest idle.
// It writes one byte a cell (1.2 GB for a 256-aa query against a
// 12,071-sequence database, 0.36 ms at 3.35 TB/s).  A pair's cells depend
// on each other along rows and columns, and the batches of long targets
// hold few pairs (the longest batch of that query: 42 pairs of up to 1,920
// columns), so a pair's walk has to be spread over threads.
//
// Design: csrc/wave.cuh's shape, with a walk of its own.  A group of G
// threads walks one pair, thread t owning R = 8 consecutive query rows in
// registers (H - go and E of the previous column), along anti-diagonals:
// at step s thread t works on column s - t.  G is the least power of two,
// at least 2, with G * R >= min(Q, 256) (the wrapper's dirs_group): one
// warp a pair for the 256-aa query, so even its B = 512 batches fill the
// schedulers about once.  Longer queries take passes of 256 rows through a
// per-pair buffer of the pass's last row (H and F at every column),
// written by thread G - 1 at step j + G - 1 and read by the next pass's
// thread 0 at step j.  The row above is handed down by shuffle once per R
// cells (H and F of the thread's last row), with the symbol of the
// thread's next column, so that its profile entries are loaded a step
// ahead; thread 0 takes the symbols from a tile of G columns loaded G
// steps ahead, and the pass buffer the same way.  The pass's profile rows
// are staged in shared memory once per block as [symbol][row / 4][thread]
// int4 (wave.cuh's interleave: conflict-free whatever symbol each thread
// holds).  A thread keeps each column's 8 bytes in a ring of G slots in
// shared memory, and at step s the group stores column s - G + 1, every
// thread's bytes of it at once: a coalesced run of G * R bytes instead of
// 32 scattered 8-byte pieces, which cost the card's L2 four times the
// transactions on the batches of many pairs.  The cell is Hopper's DPX
// where it fits: __viaddmax_s32 gives F = max(H_up - go, F_up - ge), sw's
// __vimax_s32_relu gives H, so that F's chain through the rows is two
// instructions a row; __vibmax_s32 (a compare and a select on sm_90: its
// predicate is a >= b, so a tie opens) gives E with its open bit, the
// diagonal's max with E with the predicate that picks the code (diagonal,
// then E), and the other algorithms' H.  Arithmetic wraps in int32, as the
// reference's does.
#include "dp.cuh"

namespace pyopal {

constexpr int TD_R = 8;           // query rows per thread
constexpr int TD_MAX_G = 32;      // threads per pair, at most: 256-row passes
constexpr int TD_THREADS = 128;   // threads per block
constexpr unsigned TD_FULL = 0xffffffffu;
// a pass's profile, [symbol][row / 4][thread] int4
constexpr int TD_SMEM_INT4 = ALPHA * TD_R * TD_MAX_G / 4;
constexpr int TD_SMEM_BYTES = TD_SMEM_INT4 * 16 + TD_MAX_G * TD_THREADS * 8;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// -(go + k * ge) in int32: the gap boundary of row or column k + 1
__device__ __forceinline__ int gap_run(int k, int go, int ge) {
  return (int)(0u - ((unsigned)go + (unsigned)k * (unsigned)ge));
}

// One pass of rows [q0, q0 + R) of thread t over the pair's n columns.
// TOP: the pass starts at row 0 (thread 0 takes row 0's closed form, else
// the pass buffer bh/bf); WBUF: thread G - 1 writes the pass buffer.
template <int ALG, bool TOP, bool WBUF>
__device__ __forceinline__ void dirs_pass(
    const int4* __restrict__ ps, uint2* ring, const int* __restrict__ tg,
    uint8_t* out, int* bh, int* bf, int n, int nsteps, int t, int G, int q0,
    int Q, bool stores, int T_pad, int Qs, int go, int ge) {
  constexpr int R = TD_R;
  constexpr bool FIRST_ROW = ALG == NW;  // penalized first DP row
  constexpr bool FIRST_COL = ALG == NW || ALG == HW;
  constexpr bool CLAMP = ALG == SW;
  const int ngo = wrap_sub(0, go);
  const int nv = min(max(Q - q0, 0), R);  // rows of the query
  unsigned mask[R / 4];  // bytes of rows past Q are 0
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    const int v = nv - 4 * k;
    mask[k] = v >= 4 ? 0xffffffffu : (v <= 0 ? 0u : (1u << (8 * v)) - 1u);
  }
  int Gr[R], E[R];  // H - go and E of the previous column
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Gr[r] = wrap_sub(FIRST_COL ? gap_run(q0 + r, go, ge) : 0, go);
    E[r] = NEG;
  }
  // H - go of the row above at the previous column (its column 0 first)
  int gdiag = wrap_sub(q0 > 0 && FIRST_COL ? gap_run(q0 - 1, go, ge) : 0, go);
  int out_h = 0, out_f = NEG;  // H and F of the last row, handed down
  // target symbols: lane t holds column kG + t of the current tile
  int tcur = t < T_pad ? tg[t] : 0;
  int tnext = G + t < T_pad ? tg[G + t] : 0;
  int hcur = 0, hnext = 0, fcur = 0, fnext = 0;  // the pass buffer's tiles
  if (!TOP) {
    hcur = t < T_pad ? bh[t] : 0;
    fcur = t < T_pad ? bf[t] : 0;
    hnext = G + t < T_pad ? bh[G + t] : 0;
    fnext = G + t < T_pad ? bf[G + t] : 0;
  }
  int use_sym = __shfl_sync(TD_FULL, tcur, 0, G);  // thread 0: column 0
  int4 pq[R / 4];  // the profile entries of use_sym
#pragma unroll
  for (int k = 0; k < R / 4; ++k) pq[k] = ps[(use_sym * (R / 4) + k) * G];
  uint8_t* op = out + q0;  // column 0 of this thread's rows

  for (int s = 0; s < nsteps; ++s) {
    // the symbol of the next step's column: thread 0 from the tile, the
    // others the one their upper thread uses now
    const int c = s + 1;
    if ((c & (G - 1)) == 0) {
      tcur = tnext;
      tnext = c + G + t < T_pad ? tg[c + G + t] : 0;
    }
    int nsym = __shfl_sync(TD_FULL, tcur, c & (G - 1), G);
    const int up_sym = __shfl_up_sync(TD_FULL, use_sym, 1, G);
    if (t != 0) nsym = up_sym;
    // the row above at column s - t
    int hu = __shfl_up_sync(TD_FULL, out_h, 1, G);
    int fu = __shfl_up_sync(TD_FULL, out_f, 1, G);
    if (TOP) {
      if (t == 0) {
        hu = FIRST_ROW ? gap_run(s, go, ge) : 0;
        fu = NEG;
      }
    } else {
      if ((s & (G - 1)) == 0 && s > 0) {
        hcur = hnext;
        fcur = fnext;
        hnext = s + G + t < T_pad ? bh[s + G + t] : 0;
        fnext = s + G + t < T_pad ? bf[s + G + t] : 0;
      }
      const int hb = __shfl_sync(TD_FULL, hcur, s & (G - 1), G);
      const int fb = __shfl_sync(TD_FULL, fcur, s & (G - 1), G);
      if (t == 0) {
        hu = hb;
        fu = fb;
      }
    }
    const int j = s - t;
    if ((unsigned)j < (unsigned)n) {
      int gd = gdiag;  // H - go of the row above at column j - 1
      int gu = wrap_sub(hu, go);
      gdiag = gu;
      int f = fu;
      unsigned w[R / 4];
#pragma unroll
      for (int k = 0; k < R / 4; ++k) w[k] = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ee = wrap_sub(E[r], ge);
        bool eo;
        const int e = __vibmax_s32(Gr[r], ee, &eo);  // eo: Gr >= ee
        const int4 p4 = pq[r / 4];  // this step's profile entries
        const int pv = (r & 3) == 0 ? p4.x : (r & 3) == 1 ? p4.y
                     : (r & 3) == 2 ? p4.z : p4.w;
        const int dg = wrap_add(wrap_add(gd, go), pv);
        bool p1;
        const int m1 = __vibmax_s32(dg, e, &p1);  // p1: the diagonal wins
        const int ffe = wrap_sub(f, ge);
        const bool fo = gu >= ffe;
        f = __viaddmax_s32(hu, ngo, ffe);
        int h;
        bool p2;  // H comes from max(diagonal, E)
        if (CLAMP) {
          h = __vimax_s32_relu(m1, f);
          p2 = m1 >= f;
        } else {
          h = __vibmax_s32(m1, f, &p2);
        }
        unsigned code = p2 ? (p1 ? 0u : 1u) : 2u;
        if (CLAMP && h == 0) code = 3u;
        code += (eo ? 4u : 0u) + (fo ? 8u : 0u);
        w[r / 4] += code << (8 * (r & 3));
        gd = Gr[r];
        hu = h;
        gu = wrap_sub(h, go);
        Gr[r] = gu;
        E[r] = e;
      }
      // the column's bytes wait in this thread's ring slot until the
      // group stores the column together
      ring[(j & (G - 1)) * TD_THREADS] =
          make_uint2(w[0] & mask[0], w[1] & mask[1]);
      out_h = hu;
      out_f = f;
      if (WBUF && t == G - 1) {  // j is the column stored this step
        bh[j] = hu;
        bf[j] = f;
      }
    }
    // the next step's profile entries, once this step's are used
#pragma unroll
    for (int k = 0; k < R / 4; ++k) pq[k] = ps[(nsym * (R / 4) + k) * G];
    use_sym = nsym;
    // the group's column s - G + 1, complete: R bytes a thread, coalesced
    const int col = s - (G - 1);
    if ((unsigned)col < (unsigned)n) {
      if (stores)
        *reinterpret_cast<uint2*>(op) = ring[(col & (G - 1)) * TD_THREADS];
      op += Qs;
    }
  }
}

template <int ALG>
__global__ void __launch_bounds__(TD_THREADS) traceback_dirs_kernel(
    const int* __restrict__ prof, const int* __restrict__ targets,
    const int* __restrict__ tlen, uint8_t* __restrict__ dirs, int* rowbuf,
    int B, int Q, int Qs, int A, int T_pad, int G, int go, int ge) {
  constexpr int R = TD_R;
  static_assert(R == 8, "a thread's bytes of a column are one uint2");
  // the pass's profile, then per thread the bytes of its last G columns,
  // [column % G][thread]
  extern __shared__ int4 sp[];
  uint2* ring_all = reinterpret_cast<uint2*>(sp + TD_SMEM_INT4);
  const int t = threadIdx.x & (G - 1);
  const int bg = (blockIdx.x * TD_THREADS + threadIdx.x) / G;
  const bool valid = bg < B;
  const int b = valid ? bg : 0;
  const int n = valid ? min(max(tlen[b], 0), T_pad) : 0;
  const int* tg = targets + (size_t)b * T_pad;
  uint8_t* out = dirs + (size_t)b * T_pad * Qs;
  int* bh = rowbuf == nullptr ? nullptr : rowbuf + (size_t)b * 2 * T_pad;
  int* bf = bh == nullptr ? nullptr : bh + T_pad;

  // columns [n, T_pad): one contiguous run of zeros
  if (valid) {
    const size_t z1 = (size_t)T_pad * Qs;
    for (size_t o = (size_t)n * Qs + (size_t)t * 16; o < z1; o += (size_t)G * 16)
      *reinterpret_cast<uint4*>(out + o) = make_uint4(0, 0, 0, 0);
  }

  const int GR = G * R;
  const int n_pass = (Q + GR - 1) / GR;
  const int wmax = __reduce_max_sync(TD_FULL, n);
  const int nsteps = wmax > 0 ? wmax + G - 1 : 0;
  for (int p = 0; p < n_pass; ++p) {
    const int base = p * GR;
    __syncthreads();  // every group is done with the previous profile
    {
      int* s = reinterpret_cast<int*>(sp);
      for (int idx = threadIdx.x; idx < GR * A; idx += TD_THREADS) {
        const int row = idx / A;  // within the pass
        const int sym = idx - row * A;
        const int v = base + row < Q ? __ldg(prof + (size_t)(base + row) * A + sym) : 0;
        const int tt = row / R, rr = row - tt * R;
        s[((sym * (R / 4) + (rr >> 2)) * G + tt) * 4 + (rr & 3)] = v;
      }
    }
    __syncthreads();  // also orders the previous pass's buffer writes
    const int q0 = base + t * R;  // first row (0-based) of this thread
    const bool stores = q0 < Qs;
    const bool last = p == n_pass - 1;
    const int4* ps = sp + t;
    uint2* ring = ring_all + threadIdx.x;
    if (p == 0 && last)
      dirs_pass<ALG, true, false>(ps, ring, tg, out, bh, bf, n, nsteps, t, G, q0, Q, stores, T_pad, Qs, go, ge);
    else if (p == 0)
      dirs_pass<ALG, true, true>(ps, ring, tg, out, bh, bf, n, nsteps, t, G, q0, Q, stores, T_pad, Qs, go, ge);
    else if (last)
      dirs_pass<ALG, false, false>(ps, ring, tg, out, bh, bf, n, nsteps, t, G, q0, Q, stores, T_pad, Qs, go, ge);
    else
      dirs_pass<ALG, false, true>(ps, ring, tg, out, bh, bf, n, nsteps, t, G, q0, Q, stores, T_pad, Qs, go, ge);
  }
}

}  // namespace pyopal

using namespace pyopal;

// prof (Q, A) int32, targets (B, T_pad) int32, tlen (B,) int32, dirs
// (B, T_pad, Qs) uint8 (every byte written), rowbuf (B, 2, T_pad) int32
// (null when Q <= G * 8); Qs a multiple of 16 and at least Q, A <= 32,
// G a power of two in [2, 32] with G * 8 >= min(Q, 256).
extern "C" int pyopal_traceback_dirs_launch(
    const int* prof, const int* targets, const int* tlen, uint8_t* dirs,
    int* rowbuf, int B, int Q, int Qs, int A, int T_pad, int G, int go,
    int ge, int algorithm, void* stream) {
  if (B <= 0 || Q <= 0 || T_pad <= 0) return 0;
  if (Qs % 16 || Qs < Q || A <= 0 || A > ALPHA || G < 2 || G > TD_MAX_G ||
      (G & (G - 1)) || G * TD_R < min(Q, TD_MAX_G * TD_R) ||
      (Q > G * TD_R && rowbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * G;
  const dim3 grid((unsigned)((threads + TD_THREADS - 1) / TD_THREADS));
  const dim3 block(TD_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const int*, const int*, const int*, uint8_t*, int*, int, int,
                 int, int, int, int, int, int);
  switch (algorithm) {
    case SW: kernel = traceback_dirs_kernel<SW>; break;
    case NW: kernel = traceback_dirs_kernel<NW>; break;
    case HW: kernel = traceback_dirs_kernel<HW>; break;
    case OV: kernel = traceback_dirs_kernel<OV>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  // 64 KB of shared memory a block: above the 48 KB of a static allocation
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, TD_SMEM_BYTES, s>>>(prof, targets, tlen, dirs, rowbuf,
                                           B, Q, Qs, A, T_pad, G, go, ge);
  return (int)cudaGetLastError();
}
