// K5: every query of a cohort x every target lane of the flat database,
// score only, for matrices whose 32nd column is a real letter.
//
// Replaces: pyopal_tpu/ops/pallas_ragged.py::_ragged_kernel_strip (l.732),
// the strip-blocked score-only kernel that search_flat (l.1049) launches
// without safe_pad at query tiers of 512 rows and more.  Outputs: (n_q,
// n_blocks, lanes) int32 scores for sw/nw/hw/ov, and -1 in both end
// planes, as the TPU kernel's finalize (l.989-990) writes.  Like K4
// (ragged_v1.cu) its result is defined over all Q_pad profile rows: sw's
// best cell and ov's last-column maximum range over the pad rows past the
// query (which score PAD_SCORE), and hw/nw/ov read the query's last row
// at Q - 1.  The TPU kernel kept its state in f32, exact below 2^24; here
// it is int32.
//
// What bounds it on an H100: operations, six DPX-fused instructions a
// cell in the walk below (ragged.cu; 10 in plain int32), against one byte
// of target per column of each lane per query; a 3,000-residue query at
// the 4096 tier over the 12,071-sequence database needs 14.1 G cells.
// One query gives ~12K target lanes, so the work has to be spread inside
// each target, as for K1 on one query.
//
// Design: the wavefront walk of wave.cuh, as in K1: a group of G = 16
// threads per (query, target lane) (ops/ragged.py: wave_group at tiers of
// 512 rows and more), 16 query rows per thread in registers, no per-cell
// state in device memory.  A pass is 256 rows, the TPU kernel's strip;
// between passes H and F of the pass's last row go through a buffer per
// (query, target column) laid out like the flat targets, updated in place
// (the strip boundary of the old one-thread kernel; K1's pass buffer).
// Which rows the walk covers is derived from the gaps, not chosen:
// - go >= 0 and ge >= 0: rows [0, Q), K1's walk in score mode.  Exact:
//   a path into a pad row either enters from row Q - 1 and then pays only
//   gaps >= 0 or PAD_SCORE < 0, so it scores at most a cell of row Q - 1
//   at a column no later, which sw and ov (whose last-row maximum the
//   score takes) already count; or it starts at the boundary (sw's 0,
//   ov's free first column), where the same path in row Q - 1 scores at
//   least as much.  nw and hw never read pad rows, and only scores are
//   written, so ties do not matter.  At 3,000 aa this walks 12 passes of
//   the 4096 tier's 16.
// - a negative gap: every Q_pad row, with the walk's PAD_ROWS variant
//   (sw and ov track the pad rows; row Q - 1 is read in whichever pass and
//   thread hold it).
// The wrapper splits a call into launches over query and lane ranges
// within a fixed budget for the buffer (ops/ragged.py: SCRATCH_BYTES).
//
// ptxas (CUDA 12.8, sm_90a, -O3) for the eight instantiations: see
// PERF.md (chip_smoke.py's build phase prints them).
#include "wave.cuh"

namespace pyopal {

template <int ALG, bool PAD_ROWS>
__global__ void __launch_bounds__(WAVE_THREADS) ragged_strip_kernel(
    const int* __restrict__ profs, const int* __restrict__ qlens,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends, int* pbuf, int q_pad,
    int n_lanes, int lanes, int lane0, int lane_count, int total_rows, int G,
    int go, int ge) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  const int k = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const int n = lane0 + k;  // global lane
  const int q = blockIdx.y;
  const bool valid = k < lane_count && n < n_lanes;
  const int b = valid ? n / lanes : 0;
  const int lane = valid ? n - b * lanes : 0;
  const int len = valid ? lengths[n] : 0;
  const int Q = qlens[q];  // 1..q_pad (checked by the wrapper)
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  // this (query, lane)'s pass buffer: [query][H, F][row][lane]
  const size_t cells = (size_t)total_rows * lanes;
  int* pb_h = pbuf + 2 * cells * q + col0;
  Track t = track_start<ALG>(Q, go, ge);
  wave_walk<ALG, false, false, ALPHA, PAD_ROWS>(
      sp, profs + (size_t)q * q_pad * ALPHA, q_pad, 0, PAD_ROWS ? q_pad : Q,
      Q, flat + col0, lanes, len, nullptr, nullptr, pb_h, pb_h + cells, G,
      go, ge, t);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    const size_t out = (size_t)q * n_lanes + n;
    dp_finish<ALG, false>(t, Q, len, scores + out, qends + out, tends + out);
  }
}

}  // namespace pyopal

using namespace pyopal;

// K1's arguments (score only: with_ends must be 0; the pass buffer is
// required, as every tier K5 takes is several passes).
extern "C" int pyopal_ragged_strip_launch(
    const int* profs, const int* qlens, const uint8_t* flat,
    const int* lengths, const int* row_off, int* scores, int* qends,
    int* tends, int* pbuf, int n_q, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    int total_rows, int group, void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (with_ends) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || lane_count <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)) ||
      q_pad % WAVE_R != 0 || pbuf == nullptr)
    return (int)cudaErrorInvalidValue;
  const int per_block = WAVE_THREADS / group;
  const dim3 grid((lane_count + per_block - 1) / per_block, n_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the pad rows matter only where a gap is negative; else rows [0, Q)
  // suffice (the template flag PYOPAL_DISPATCH sets is PAD_ROWS here)
  const bool pad_rows = go < 0 || ge < 0;
  PYOPAL_DISPATCH(ragged_strip_kernel, algorithm, pad_rows, grid,
                  dim3(WAVE_THREADS), s, profs, qlens, flat, lengths,
                  row_off, scores, qends, tends, pbuf, q_pad, n_lanes, lanes,
                  lane0, lane_count, total_rows, group, go, ge);
  return (int)cudaGetLastError();
}
