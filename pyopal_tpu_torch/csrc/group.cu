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
// Semantics kept from the TPU kernel, those of K4 (ragged_v1.cu): the
// result is defined over all Q_pad rows of the profile (Q_pad = the query
// length rounded up to 8, at least 8), the rows past the query scoring
// PAD_SCORE, so sw's best cell and ov's last-column maximum range over
// them as the TPU kernel's column reductions do; hw/ov/nw read the
// query's last row at Q - 1; ties go to the larger score, then the lower
// column, then the lower row.  In score mode the end planes hold what the
// TPU kernel's finalize writes from untracked positions (dp.cuh:
// dp_finish, SCORE_PLANES).  The TPU kernel's state was f32, exact below
// 2^24; here it is int32, exact.
//
// What bounds it on an H100: operations, six DPX-fused instructions a
// cell in the walk below, against one byte of target per column of each
// lane.  A launch is one query over one shard's part of one length bucket
// (~300 lanes on the sharded path), so the work has to be spread inside
// each target; what is left is the walk's steps, one after the other.
//
// Design: K4's walk (wave.cuh, a group of G = ops.ragged.wave_group(Q_pad)
// threads per lane, 16 query rows a thread in registers, no per-cell state
// in device memory), with the target of block b, lane l at targets +
// (b * t_pad + j) * lanes + l.  Each group stops at its own target length.
// The rows it walks follow K4's rule and proof (ragged_v1.cu): rows
// [0, Q) when both gaps are >= 0, else every Q_pad row with PAD_ROWS, and
// PAD_TAIL, as Q_pad is a multiple of 8 only: the masked final pass then
// also holds row Q - 1 (the profile is not padded to 16 rows, which would
// add PAD_SCORE rows that move sw's and ov's answers at a negative gap).
// A query of more than 256 rows takes several passes through a buffer of
// H and F per (block, column, lane), [block][H, F][t_pad][lanes] from the
// launch's first block; the wrapper splits a call over lane ranges to
// keep it within a fixed budget (ops/ragged.py: SCRATCH_BYTES).
//
// ptxas (CUDA 12.8, sm_90a, -O3) for the sixteen instantiations: see
// PERF.md (chip_smoke.py's build phase prints them).
#include "wave.cuh"

namespace pyopal {

#define PYOPAL_GROUP_PARAMS                                                \
  const int *__restrict__ prof, const uint8_t *__restrict__ targets,      \
      const int *__restrict__ lengths, int *__restrict__ scores,          \
      int *__restrict__ qends, int *__restrict__ tends, int *pbuf, int Q, \
      int q_pad, int t_pad, int n_lanes, int lanes, int lane0,            \
      int lane_count, int G, int go, int ge
#define PYOPAL_GROUP_ARGS                                                  \
  prof, targets, lengths, scores, qends, tends, pbuf, Q, q_pad, t_pad,     \
      n_lanes, lanes, lane0, lane_count, G, go, ge

template <int ALG, bool ENDS, bool PAD_ROWS>
__device__ __forceinline__ void group_walk(int4* sp, PYOPAL_GROUP_PARAMS) {
  const int k = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const int n = lane0 + k;  // lane of the group
  const bool valid = k < lane_count && n < n_lanes;
  const int b0 = lane0 / lanes;  // the launch's first block
  const int b = valid ? n / lanes : b0;
  const int lane = valid ? n - b * lanes : 0;
  const int len = valid ? lengths[n] : 0;
  const size_t cells = (size_t)t_pad * lanes;  // one block's columns
  int* pb_h =
      pbuf == nullptr ? nullptr : pbuf + 2 * cells * (b - b0) + lane;
  int* pb_f = pb_h == nullptr ? nullptr : pb_h + cells;
  Track t = track_start<ALG>(Q, go, ge);
  wave_walk<ALG, ENDS, false, ALPHA, PAD_ROWS, PAD_ROWS>(
      sp, prof, q_pad, 0, PAD_ROWS ? q_pad : Q, Q,
      targets + (size_t)b * cells + lane, lanes, len, nullptr, nullptr, pb_h,
      pb_f, G, go, ge, t);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    dp_finish<ALG, ENDS, true>(t, Q, len, scores + n, qends + n, tends + n);
  }
}

// rows [0, Q) (both gaps >= 0)
template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS)
    group_kernel(PYOPAL_GROUP_PARAMS) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  group_walk<ALG, ENDS, false>(sp, PYOPAL_GROUP_ARGS);
}

// every profile row (a negative gap)
template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS)
    group_pad_kernel(PYOPAL_GROUP_PARAMS) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  group_walk<ALG, ENDS, true>(sp, PYOPAL_GROUP_ARGS);
}

}  // namespace pyopal

using namespace pyopal;

// pbuf: the pass buffer from the block of lane0 on (nullptr when q_pad
// fits one pass of the group size).
extern "C" int pyopal_group_launch(
    const int* prof, const uint8_t* targets, const int* lengths, int* scores,
    int* qends, int* tends, int* pbuf, int Q, int q_pad, int t_pad,
    int n_blocks, int lanes, int lane0, int lane_count, int go, int ge,
    int algorithm, int with_ends, int group, void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (lane_count <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  if (q_pad > group * WAVE_R && pbuf == nullptr)
    return (int)cudaErrorInvalidValue;  // several passes need the buffer
  const int G = group;
  const dim3 grid((lane_count + WAVE_THREADS / G - 1) / (WAVE_THREADS / G));
  const dim3 block(WAVE_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the pad rows matter only where a gap is negative (ragged_v1.cu)
  if (go < 0 || ge < 0) {
    PYOPAL_DISPATCH(group_pad_kernel, algorithm, with_ends, grid, block, s,
                    PYOPAL_GROUP_ARGS);
  } else {
    PYOPAL_DISPATCH(group_kernel, algorithm, with_ends, grid, block, s,
                    PYOPAL_GROUP_ARGS);
  }
  return (int)cudaGetLastError();
}
