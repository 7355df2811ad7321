// K3: one segment of query rows of one long query x every target lane of
// the flat database.
//
// Replaces: pyopal_tpu/ops/pallas_ragged_long.py::_seg_kernel (l.49),
// launched once per segment by _segment_call (l.336) from
// search_flat_long (l.445).  A query whose fine-tier K1 launch is over
// budget is searched in segments of QSEG (2048) rows, one launch each, in
// order.  Between launches the state lives in device memory:
// - hb/fb: H and F of the segment's last row at every target column, in
//   the flat layout of the targets ((total_rows, lanes) int32); the next
//   segment reads them as the row above its first row;
// - trk: the trackers (best, cap, bi, bj, ci), (5, n_blocks, lanes) int32.
// The first segment starts from the closed-form row 0 and trackers, as
// K1 does.  Every launch writes (score, query end, target end) from its
// trackers; those of the last segment are the answer.  The TPU kernel
// kept this state in f32; here it is int32, exact like the rest.
//
// What bounds it on an H100: operations, at 10 int32 operations per cell
// (ragged.cu), against 1 byte of target and 16 bytes of hb/fb read and
// written per column of each segment, i.e. thousands of operations per
// byte at 2048 rows.  As with K1 on one query, the launch has one thread
// per target (~12K threads for the 12,071-sequence database), under a
// tenth of the card's thread slots, so this simple kernel is latency-
// bound on each thread's serial chain, and its [row][lane] H/E scratch
// (2048 x lanes x 8 bytes, 200 MB at that database) does not stay in the
// 50 MB L2.
//
// Design: the same thread-per-lane walk as K1 (dp.cuh: columns outer,
// the segment's rows inner, F in a register), with the top row and the
// trackers taken from the previous launch.  At column j the row above is
// hb[j], its left neighbour hb[j - 1] (at j = 0 the first-column boundary
// of row seg_off - 1), and F enters as max(hb[j] - go, fb[j] - ge).  The
// sw tracker takes an equal score at a smaller column, so the oracle's
// (column, row) order survives the split into row segments; hw/ov/nw
// read the query's last row only in the segment that holds it.  Each
// thread stops at its own target length and at min(QSEG, Q - seg_off)
// rows; columns past the target keep the hb/fb values the wrapper passed
// in.  The wrapper splits a launch over lane ranges when its scratch
// would exceed the budget (ops/ragged.py: SCRATCH_BYTES).
#include "dp.cuh"

namespace pyopal {

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(128) seg_kernel(
    const int* __restrict__ prof, const uint8_t* __restrict__ flat,
    const int* __restrict__ lengths, const int* __restrict__ row_off,
    const int* __restrict__ hb_in, const int* __restrict__ fb_in,
    int* __restrict__ hb_out, int* __restrict__ fb_out,
    const int* __restrict__ trk_in, int* __restrict__ trk_out,
    int* __restrict__ scores, int* __restrict__ qends,
    int* __restrict__ tends, int2* __restrict__ scratch, int Q, int seg_off,
    int rows, int n_lanes, int lanes, int lane0, int lane_count, int go,
    int ge) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // global lane
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int len = lengths[n];
  Track t;
  if (seg_off == 0) {
    t = track_start<ALG>(Q, go, ge);
  } else {
    t = Track{trk_in[n], trk_in[n_lanes + n], trk_in[2 * n_lanes + n],
              trk_in[3 * n_lanes + n], trk_in[4 * n_lanes + n]};
  }
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  dp_walk<ALG, ENDS, true>(prof, ALPHA, seg_off, rows, Q, flat + col0,
                           lanes, len, scratch + k, (size_t)lane_count, go,
                           ge, hb_in + col0, fb_in + col0, hb_out + col0,
                           fb_out + col0, t);
  trk_out[n] = t.best;
  trk_out[n_lanes + n] = t.cap;
  trk_out[2 * n_lanes + n] = t.bi;
  trk_out[3 * n_lanes + n] = t.bj;
  trk_out[4 * n_lanes + n] = t.ci;
  dp_finish<ALG, ENDS, true>(t, Q, len, scores + n, qends + n, tends + n);
}

}  // namespace pyopal

using namespace pyopal;

extern "C" int pyopal_ragged_long_launch(
    const int* prof, const uint8_t* flat, const int* lengths,
    const int* row_off, const int* hb_in, const int* fb_in, int* hb_out,
    int* fb_out, const int* trk_in, int* trk_out, int* scores, int* qends,
    int* tends, int2* scratch, int Q, int seg_off, int rows, int n_blocks,
    int lanes, int lane0, int lane_count, int go, int ge, int algorithm,
    int with_ends, void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (rows <= 0 || lane_count <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(seg_kernel, algorithm, with_ends, grid, block, s, prof,
                  flat, lengths, row_off, hb_in, fb_in, hb_out, fb_out,
                  trk_in, trk_out, scores, qends, tends, scratch, Q, seg_off,
                  rows, n_lanes, lanes, lane0, lane_count, go, ge);
  return (int)cudaGetLastError();
}
