// K4: every query of a cohort x every target lane of the flat database,
// for matrices whose 32nd column is a real letter.
//
// Replaces: pyopal_tpu/ops/pallas_ragged.py::_ragged_kernel (l.169), the
// full-scan ("v1") kernel that search_flat (l.1049) launches without
// safe_pad for queries up to the 2048 tier, in both modes.  Same outputs
// as K1 (ragged.cu): (n_q, n_blocks, lanes) int32 scores, query ends and
// target ends for sw/nw/hw/ov.
//
// Semantics kept from the TPU kernel, which differ from K1's:
// - its result is defined over all Q_pad rows of the profile, rows past
//   the query scoring PAD_SCORE: sw's best cell and ov's last-column
//   maximum range over them as the TPU kernel's per-column reductions do;
//   hw, ov and nw read the query's last row at Q - 1;
// - in score mode the end planes hold what the TPU kernel's finalize
//   writes from untracked positions (dp.cuh: dp_finish, SCORE_PLANES).
// The TPU kernel masks the columns past each target (its pad symbol 31
// may be a real letter here); each group stops at its target's length,
// so it never reads them.  Its state was f32, exact below 2^24; here it
// is int32.
//
// What bounds it on an H100: operations, six DPX-fused instructions a
// cell in the walk below (ragged.cu), against one byte of target per
// column of each lane per query: thousands of instructions per byte at
// 256 rows.  A cohort of many queries (67 x 12,160 lanes of the
// 12,071-sequence database) fills the card; one query does not, so the
// work is spread inside each (query, target), as for K1.
//
// Design: the wavefront walk of wave.cuh, as in K1 and K5: a group of
// G threads per (query, target lane), G = 4/8/16 by tier (ops/ragged.py:
// wave_group), 16 query rows a thread in registers, no per-cell state in
// device memory.  A CUDA block is 256 threads, 256 / G lanes of one
// query.  A tier of several passes (512-2048 rows) carries H and F of a
// pass's last row through a buffer per (query, target column) laid out
// like the flat targets, which the wrapper allocates and splits into
// launches over query and lane ranges within a fixed budget
// (ops/ragged.py: wave_buffer, SCRATCH_BYTES); a tier of one pass needs
// none and is one launch.
//
// Which rows the walk covers is derived from the gaps, in both modes:
// - go >= 0 and ge >= 0: rows [0, Q), K1's walk.  Exact, ends included:
//   rows above a pad row never depend on it, so only what the pad rows
//   add to sw's best cell and ov's last column can differ.  Let M(j) be
//   the largest H of row Q - 1 at columns <= j.  Every pad-row value is
//   at most M(j), by induction over (row, column): F entering a pad row
//   from row Q - 1 is max(H - go, F - ge) <= H(Q - 1, j) (F <= H there);
//   a horizontal or vertical gap move within the pad rows subtracts go or
//   ge >= 0; a diagonal move into a pad row adds PAD_SCORE < 0; and the
//   boundary column gives pad rows what it gives row Q - 1 (sw and ov: 0,
//   so E(pad, 0) = -go <= H(Q - 1, 0)), while sw's 0 never moves a
//   tracker that starts at 0 and takes only strictly better cells.  So
//   for sw a pad cell (i, j) scoring the best score ties with a cell
//   (Q - 1, c), c <= j, which comes first in (column, row) order and
//   keeps the end.  For ov every pad value in the last column is <= the
//   last-row maximum, to which ties go, so neither the choice of the last
//   column nor its row changes.  nw and hw never read pad rows.
// - a negative gap: every Q_pad row, with the walk's PAD_ROWS variant
//   (sw and ov track the pad rows, ends included; row Q - 1 is read in
//   whichever pass and thread hold it), PAD_TAIL for a Q_pad that is not
//   a multiple of 16.
//
// ptxas (CUDA 12.8, sm_90a, -O3) for the sixteen instantiations (four
// algorithms x two modes x two row rules): see PERF.md (chip_smoke.py's
// build phase prints them).
#include "wave.cuh"

namespace pyopal {

#define PYOPAL_V1_PARAMS                                                   \
  const int *__restrict__ profs, const int *__restrict__ qlens,           \
      const uint8_t *__restrict__ flat, const int *__restrict__ lengths,  \
      const int *__restrict__ row_off, int *__restrict__ scores,          \
      int *__restrict__ qends, int *__restrict__ tends, int *pbuf,        \
      int q_pad, int n_lanes, int lanes, int lane0, int lane_count,       \
      int total_rows, int G, int go, int ge
#define PYOPAL_V1_ARGS                                                     \
  profs, qlens, flat, lengths, row_off, scores, qends, tends, pbuf, q_pad, \
      n_lanes, lanes, lane0, lane_count, total_rows, G, go, ge

template <int ALG, bool ENDS, bool PAD_ROWS>
__device__ __forceinline__ void ragged_v1_walk(int4* sp, PYOPAL_V1_PARAMS) {
  const int k = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const int n = lane0 + k;  // global lane
  const int q = blockIdx.y;
  const bool valid = k < lane_count && n < n_lanes;
  const int b = valid ? n / lanes : 0;
  const int lane = valid ? n - b * lanes : 0;
  const int len = valid ? lengths[n] : 0;
  const int Q = qlens[q];  // 1..q_pad (checked by the wrapper)
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  // this (query, lane)'s pass buffer: [query][H, F][row][lane], laid out
  // like the flat targets
  const size_t cells = (size_t)total_rows * lanes;
  int* pb_h = pbuf == nullptr ? nullptr : pbuf + 2 * cells * q + col0;
  int* pb_f = pb_h == nullptr ? nullptr : pb_h + cells;
  Track t = track_start<ALG>(Q, go, ge);
  wave_walk<ALG, ENDS, false, ALPHA, PAD_ROWS, PAD_ROWS>(
      sp, profs + (size_t)q * q_pad * ALPHA, q_pad, 0, PAD_ROWS ? q_pad : Q,
      Q, flat + col0, lanes, len, nullptr, nullptr, pb_h, pb_f, G, go, ge,
      t);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    const size_t out = (size_t)q * n_lanes + n;
    dp_finish<ALG, ENDS, true>(t, Q, len, scores + out, qends + out,
                               tends + out);
  }
}

// rows [0, Q) (both gaps >= 0)
template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS)
    ragged_v1_kernel(PYOPAL_V1_PARAMS) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  ragged_v1_walk<ALG, ENDS, false>(sp, PYOPAL_V1_ARGS);
}

// every profile row (a negative gap)
template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS)
    ragged_v1_pad_kernel(PYOPAL_V1_PARAMS) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  ragged_v1_walk<ALG, ENDS, true>(sp, PYOPAL_V1_ARGS);
}

}  // namespace pyopal

using namespace pyopal;

// K1's arguments: the pass buffer (nullptr when the tier fits one pass),
// then the flat layout's total rows and the group size.
extern "C" int pyopal_ragged_v1_launch(
    const int* profs, const int* qlens, const uint8_t* flat,
    const int* lengths, const int* row_off, int* scores, int* qends,
    int* tends, int* pbuf, int n_q, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    int total_rows, int group, void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (n_q == 0 || lane_count <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  if (q_pad > group * WAVE_R && pbuf == nullptr)
    return (int)cudaErrorInvalidValue;  // several passes need the buffer
  const int G = group;
  const dim3 grid((lane_count + WAVE_THREADS / G - 1) / (WAVE_THREADS / G),
                  n_q);
  const dim3 block(WAVE_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the pad rows matter only where a gap is negative (see above)
  if (go < 0 || ge < 0) {
    PYOPAL_DISPATCH(ragged_v1_pad_kernel, algorithm, with_ends, grid, block,
                    s, PYOPAL_V1_ARGS);
  } else {
    PYOPAL_DISPATCH(ragged_v1_kernel, algorithm, with_ends, grid, block, s,
                    PYOPAL_V1_ARGS);
  }
  return (int)cudaGetLastError();
}
