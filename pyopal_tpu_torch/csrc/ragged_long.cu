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
// What bounds it on an H100: operations, six DPX-fused instructions per
// cell (ragged.cu; 10 in plain int32), against 1 byte of target and 16
// bytes of hb/fb read and written per column of each segment, i.e.
// thousands of instructions per byte at 2048 rows.  As with K1 on one
// query, the launch has one target per lane (~12K for the
// 12,071-sequence database), so the work has to be spread inside each
// target.
//
// Design: the wavefront walk of wave.cuh, as in K1: a group of G threads
// per target lane, 16 rows per thread in registers, G = 16 at 2048 rows
// (ops/ragged.py: wave_group), so a segment is 8 passes of 256 rows.  No
// scratch: the first pass reads hb_in/fb_in (or the closed-form row 0),
// every pass writes H and F of its last row to hb_out/fb_out, and the
// next pass reads them there, in place (column j is read at step j and
// written at step j + G - 1); the launch leaves the segment's last row in
// hb_out/fb_out as before, and columns past a target keep the values the
// wrapper copied in.  The sw tracker joins the previous launch's by (score
// desc, column asc, row asc), so the oracle's order survives the split
// into row segments; hw/ov/nw read the query's last row only in the
// segment, pass and thread that hold it.  Each group stops at its own
// target's length and at min(QSEG, Q - seg_off) rows.
//
// ptxas (CUDA 12.8, sm_90a, -O3) for the eight instantiations: 104-115
// registers, 32 KB shared memory, no stack frame, no spills; at 256
// threads a block, two blocks an SM.  chip_smoke.py prints them.
#include "wave.cuh"

namespace pyopal {

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS) seg_kernel(
    const int* __restrict__ prof, const uint8_t* __restrict__ flat,
    const int* __restrict__ lengths, const int* __restrict__ row_off,
    const int* hb_in, const int* fb_in, int* hb_out, int* fb_out,
    const int* __restrict__ trk_in, int* __restrict__ trk_out,
    int* __restrict__ scores, int* __restrict__ qends,
    int* __restrict__ tends, int Q, int seg_off, int rows, int prof_rows,
    int n_lanes, int lanes, int G, int go, int ge) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  const int n = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const bool valid = n < n_lanes;
  const int b = valid ? n / lanes : 0;
  const int lane = valid ? n - b * lanes : 0;
  const int len = valid ? lengths[n] : 0;
  Track t;
  if (seg_off == 0 || !valid) {
    t = track_start<ALG>(Q, go, ge);
  } else {
    t = Track{trk_in[n], trk_in[n_lanes + n], trk_in[2 * n_lanes + n],
              trk_in[3 * n_lanes + n], trk_in[4 * n_lanes + n]};
  }
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  wave_walk<ALG, ENDS, true>(sp, prof, prof_rows, seg_off, rows, Q,
                             flat + col0, lanes, len, hb_in + col0,
                             fb_in + col0, hb_out + col0, fb_out + col0, G,
                             go, ge, t);
  if (!valid || (threadIdx.x & (G - 1)) != 0) return;
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
    int* tends, int Q, int seg_off, int rows, int prof_rows, int n_blocks,
    int lanes, int group, int go, int ge, int algorithm, int with_ends,
    void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (rows <= 0 || n_lanes <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int per_block = WAVE_THREADS / group;
  const dim3 grid((n_lanes + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(seg_kernel, algorithm, with_ends, grid, dim3(WAVE_THREADS),
                  s, prof, flat, lengths, row_off, hb_in, fb_in, hb_out,
                  fb_out, trk_in, trk_out, scores, qends, tends, Q, seg_off,
                  rows, prof_rows, n_lanes, lanes, group, go, ge);
  return (int)cudaGetLastError();
}
