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
// - the walk covers all Q_pad rows of the profile, rows past the query
//   scoring PAD_SCORE, so sw's best cell and ov's last-column maximum
//   range over them as the TPU kernel's per-column reductions do; hw, ov
//   and nw read the query's last row at Q - 1;
// - in score mode the end planes hold what the TPU kernel's finalize
//   writes from untracked positions (dp.cuh: dp_finish, SCORE_PLANES).
// The TPU kernel masks the columns past each target (its pad symbol 31
// may be a real letter here); this thread stops at its target's length,
// so it never reads them.  Its state was f32, exact below 2^24; here it is
// int32.
//
// What bounds it on an H100: operations, at 10 int32 operations per cell
// (ragged.cu), against one byte of target per column of each lane; at
// 256 rows that is thousands of operations per byte.  Like K2 (q8.cu),
// a cohort of many queries fills the card (67 queries x 12,160 lanes of
// the 12,071-sequence database), and its [query][row][lane] int2 H/E
// scratch (1.7 GB at 256 rows) lies in device memory, so each cell's
// 8-byte load and store are what this simple design pays; with one query
// the launch is latency-bound on each thread's serial chain, as K1 is.
//
// Design: one thread per (query, target lane), 128 threads per block,
// columns outer and rows inner (dp.cuh), with PAD_ROWS; the wrapper splits
// a call into launches over query and lane ranges within a fixed scratch
// budget (ops/ragged.py: SCRATCH_BYTES, launch_plan).
#include "dp.cuh"

namespace pyopal {

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(128) ragged_v1_kernel(
    const int* __restrict__ profs, const int* __restrict__ qlens,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends,
    int2* __restrict__ scratch, int q_pad, int n_lanes, int lanes,
    int lane0, int lane_count, int go, int ge) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // global lane
  const int q = blockIdx.y;
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int Q = qlens[q];  // 1..q_pad (checked by the wrapper)
  const int len = lengths[n];
  const size_t out = (size_t)q * n_lanes + n;
  Track t = track_start<ALG>(Q, go, ge);
  dp_walk<ALG, ENDS>(profs + (size_t)q * q_pad * ALPHA, ALPHA, q_pad, Q,
                     flat + (size_t)row_off[b] * lanes + lane, lanes, len,
                     scratch + (size_t)q * q_pad * lane_count + k,
                     (size_t)lane_count, go, ge, t);
  dp_finish<ALG, ENDS, true>(t, Q, len, scores + out, qends + out,
                             tends + out);
}

}  // namespace pyopal

using namespace pyopal;

extern "C" int pyopal_ragged_v1_launch(
    const int* profs, const int* qlens, const uint8_t* flat,
    const int* lengths, const int* row_off, int* scores, int* qends,
    int* tends, int2* scratch, int n_q, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (n_q == 0 || lane_count <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128, n_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(ragged_v1_kernel, algorithm, with_ends, grid, block, s,
                  profs, qlens, flat, lengths, row_off, scores, qends, tends,
                  scratch, q_pad, n_lanes, lanes, lane0, lane_count, go, ge);
  return (int)cudaGetLastError();
}
