// T1: the direction bytes of full-mode traceback, for a padded batch of
// (query, target) pairs.
//
// Replaces: pyopal_tpu/ops/traceback.py::_dir_matrix_batch (l.53), a jitted
// lax.scan over target columns (XLA in the reference, not Pallas).  Same
// bytes on every column it computes: for pair b and DP cell (i, j), byte
// dirs[b][i - 1][j - 1] holds the source of H in bits 0-1 (diagonal, then
// E, then F; in sw DIR_STOP where H == 0), E_OPEN in bit 2 (H[i][j-1] - go
// >= E[i][j-1] - ge) and F_OPEN in bit 3 (H[i-1][j] - go >= F[i-1][j] -
// ge, row 1 against NEG).  F is the sequential max(H[i-1] - go, F[i-1] -
// ge), which gives the reference's prefix-max F, H and bits at every gap
// pair (at ge > go a reopening always beats an extension).  Columns at or
// beyond a pair's length are not computed; the wrapper zero-fills the
// output, so they read 0.
//
// What bounds it on an H100: its instructions.  A cell needs 16 int32
// operations (sw: G, E, F, the diagonal, the clamp and the maxes of H, the
// code's and the open bits' compares, the byte's packing), and a lane's
// step runs several times as many: the two shuffles, the symbol and
// profile loads, lane 0's boundary row and the stores' branches beside the
// cell.  It writes one byte a cell (1.2 GB for a 256-aa query against a
// 12,071-sequence database, 0.36 ms at 3.35 TB/s).  A pair's
// cells depend on each other along rows and columns, so the work inside a
// pair has to be spread along anti-diagonals.
//
// Design (simple first): one warp per pair, walking strips of 32 query
// rows, one row a lane.  At step t lane r computes column t - r + 1 of its
// row: the H and F of the row above come from lane r - 1 by a shuffle
// (lane 0 reads the strip above's bottom row from a per-pair buffer in
// device memory, written by lane 31 in place: lane 0 reads a column 31
// steps before lane 31 rewrites it, and the write depends on the read
// through the shuffles), the diagonal is the value received the step
// before, H and E of the row's own last column stay in registers.  A lane
// packs four columns' bytes into one 32-bit store.  The profile is read
// through the read-only cache.  Arithmetic wraps in int32, as the
// reference's does.  Tuning (several rows a lane, as wave.cuh walks) is
// later work.
#include "dp.cuh"

namespace pyopal {

constexpr int TB_DIRS_WARPS = 4;  // pairs per block
constexpr unsigned TB_FULL_MASK = 0xffffffffu;

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

template <int ALG>
__global__ void __launch_bounds__(TB_DIRS_WARPS * 32) traceback_dirs_kernel(
    const int* __restrict__ prof, const int* __restrict__ targets,
    const int* __restrict__ tlen, uint8_t* __restrict__ dirs, int* rowbuf,
    int B, int Q, int A, int T_pad, int go, int ge) {
  constexpr bool FIRST_ROW = ALG == NW;  // penalized first DP row
  constexpr bool FIRST_COL = ALG == NW || ALG == HW;
  constexpr bool CLAMP = ALG == SW;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * TB_DIRS_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform over the warp
  const int n = min(max(tlen[b], 0), T_pad);
  if (n == 0) return;
  const int* tgt = targets + (size_t)b * T_pad;
  int* bh = rowbuf == nullptr ? nullptr : rowbuf + (size_t)b * 2 * T_pad;
  int* bf = bh == nullptr ? nullptr : bh + T_pad;
  const int n_strips = (Q + 31) / 32;
  for (int s = 0; s < n_strips; ++s) {
    const int i = s * 32 + lane + 1;  // this lane's DP row
    const bool row_ok = i <= Q;
    const bool last_strip = s == n_strips - 1;
    const int* prow = prof + (size_t)(row_ok ? i - 1 : 0) * A;
    uint32_t* out = reinterpret_cast<uint32_t*>(
        dirs + ((size_t)b * Q + (row_ok ? i - 1 : 0)) * T_pad);
    int hl = FIRST_COL ? gap_run(i - 1, go, ge) : 0;  // H[i][j - 1]
    int el = NEG;                                     // E[i][j - 1]
    int hc = hl, fc = NEG;  // H and F of this lane's last cell, handed down
    // H[i - 1][j - 1]: lane 0 starts at the boundary row's first column,
    // the others at the value their upper lane holds before its first cell
    int saved = (FIRST_COL && s > 0) ? gap_run(s * 32 - 1, go, ge) : 0;
    uint32_t word = 0;
    for (int t = 0; t < n + 31; ++t) {
      const int j = t - lane + 1;
      int up_h = __shfl_up_sync(TB_FULL_MASK, hc, 1);
      int up_f = __shfl_up_sync(TB_FULL_MASK, fc, 1);
      const bool active = j >= 1 && j <= n;
      if (lane == 0 && active) {
        if (s == 0) {
          up_h = FIRST_ROW ? gap_run(j - 1, go, ge) : 0;
          up_f = NEG;
        } else {
          up_h = bh[j - 1];
          up_f = bf[j - 1];
        }
      }
      const int diag_h = saved;
      saved = up_h;
      if (!(active && row_ok)) continue;
      const int hg = wrap_sub(hl, go);
      const int eg = wrap_sub(el, ge);
      const int e = max(hg, eg);
      const int fg = wrap_sub(up_h, go);
      const int ff = wrap_sub(up_f, ge);
      const int f = max(fg, ff);
      const int dg = wrap_add(diag_h, __ldg(prow + __ldg(tgt + j - 1)));
      int tmp = max(dg, e);
      if (CLAMP) tmp = max(tmp, 0);
      const int h = max(tmp, f);
      int code = h == dg ? 0 : (h == e ? 1 : 2);
      if (CLAMP && h == 0) code = 3;
      const uint32_t byte = (uint32_t)code | (hg >= eg ? 4u : 0u) |
                            (fg >= ff ? 8u : 0u);
      const int c = j - 1;
      word |= byte << (8 * (c & 3));
      if ((c & 3) == 3 || j == n) {
        out[c >> 2] = word;
        word = 0;
      }
      hl = h;
      el = e;
      hc = h;
      fc = f;
      if (lane == 31 && !last_strip) {
        bh[c] = h;
        bf[c] = f;
      }
    }
    __syncwarp();
  }
}

}  // namespace pyopal

using namespace pyopal;

// prof (Q, A) int32, targets (B, T_pad) int32, tlen (B,) int32,
// dirs (B, Q, T_pad) uint8 zero-filled, rowbuf (B, 2, T_pad) int32 (null
// when Q <= 32); T_pad a multiple of 4.
extern "C" int pyopal_traceback_dirs_launch(
    const int* prof, const int* targets, const int* tlen, uint8_t* dirs,
    int* rowbuf, int B, int Q, int A, int T_pad, int go, int ge,
    int algorithm, void* stream) {
  if (B <= 0 || Q <= 0 || T_pad <= 0) return 0;
  if (T_pad % 4 || (Q > 32 && rowbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TB_DIRS_WARPS - 1) / TB_DIRS_WARPS);
  const dim3 block(TB_DIRS_WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (algorithm) {
    case SW: traceback_dirs_kernel<SW><<<grid, block, 0, s>>>(prof, targets, tlen, dirs, rowbuf, B, Q, A, T_pad, go, ge); break;
    case NW: traceback_dirs_kernel<NW><<<grid, block, 0, s>>>(prof, targets, tlen, dirs, rowbuf, B, Q, A, T_pad, go, ge); break;
    case HW: traceback_dirs_kernel<HW><<<grid, block, 0, s>>>(prof, targets, tlen, dirs, rowbuf, B, Q, A, T_pad, go, ge); break;
    case OV: traceback_dirs_kernel<OV><<<grid, block, 0, s>>>(prof, targets, tlen, dirs, rowbuf, B, Q, A, T_pad, go, ge); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
