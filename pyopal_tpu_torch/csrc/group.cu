// K6: one query x a stacked group of length-bucketed target blocks.
//
// Replaces: pyopal_tpu/ops/pallas_kernel.py::_dp_kernel (l.119), launched
// by _search_group_impl (l.305) / search_group (l.366), whose only path is
// the sharded group search (pyopal_tpu/parallel/sharded.py, use_pallas).
// The group is (n_blocks, t_pad, lanes) target symbols, one target per
// lane, every block padded to the group's t_pad columns; lengths is
// (n_blocks, lanes), 0 on padding lanes.  Outputs (score, query end,
// target end) are (n_blocks, lanes) int32, every lane written, padding
// lanes included (they hold the empty-target values).
//
// Semantics kept from the TPU kernel: the walk covers all Q_pad rows of
// the profile, the rows past the query scoring PAD_SCORE, so sw's best
// cell and ov's last-column maximum range over them as the TPU kernel's
// column reductions do; hw/ov/nw read the query's last row at Q - 1; ties
// go to the larger score, then the lower column, then the lower row.  In
// score mode the end planes hold what the TPU kernel's finalize writes
// from untracked positions (dp.cuh: dp_finish, SCORE_PLANES).  The TPU
// kernel's state was f32, exact below 2^24; here it is int32, exact.
//
// What bounds it on an H100: operations, at 10 int32 operations per cell
// (ragged.cu), against one byte of target per column of each lane; a
// 256-row query makes thousands of operations per byte.  Like K1 on one
// query, a launch has one thread per target lane (12,160 for the
// 12,071-sequence database in one group, fewer per length bucket), far
// below the card's thread slots, so this simple kernel is latency-bound on
// each thread's serial chain.  Its [row][lane] H/E scratch (Q_pad x lanes x
// 8 bytes, 25 MB at 256 rows over every lane of that database) stays in
// the 50 MB L2 at that size.
//
// Design: dp.cuh's thread-per-lane walk (columns outer, rows inner, F in a
// register, the previous column's H/E in the int2 scratch), with the
// target of block b, lane l at targets + (b * t_pad + j) * lanes + l.
// Each thread stops at its own target length.  The wrapper splits a call
// over lane ranges when the scratch would exceed the budget
// (ops/ragged.py: SCRATCH_BYTES).
#include "dp.cuh"

namespace pyopal {

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(128) group_kernel(
    const int* __restrict__ prof, const uint8_t* __restrict__ targets,
    const int* __restrict__ lengths, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends,
    int2* __restrict__ scratch, int Q, int q_pad, int t_pad, int n_lanes,
    int lanes, int lane0, int lane_count, int go, int ge) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // lane of the group
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int len = lengths[n];
  Track t = track_start<ALG>(Q, go, ge);
  dp_walk<ALG, ENDS>(prof, ALPHA, q_pad, Q,
                     targets + (size_t)b * t_pad * lanes + lane, lanes, len,
                     scratch + k, (size_t)lane_count, go, ge, t);
  dp_finish<ALG, ENDS, true>(t, Q, len, scores + n, qends + n, tends + n);
}

}  // namespace pyopal

using namespace pyopal;

extern "C" int pyopal_group_launch(
    const int* prof, const uint8_t* targets, const int* lengths, int* scores,
    int* qends, int* tends, int2* scratch, int Q, int q_pad, int t_pad,
    int n_blocks, int lanes, int lane0, int lane_count, int go, int ge,
    int algorithm, int with_ends, void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (lane_count <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(group_kernel, algorithm, with_ends, grid, block, s, prof,
                  targets, lengths, scores, qends, tends, scratch, Q, q_pad,
                  t_pad, n_lanes, lanes, lane0, lane_count, go, ge);
  return (int)cudaGetLastError();
}
