// K1: every query of a cohort x every target lane of the flat database.
//
// Replaces: pyopal_tpu/ops/pallas_ragged.py::_ragged_kernel_v2 (l.400),
// launched by search_flat (l.1049) when safe_pad holds.  Same outputs,
// bit for bit: (n_q, n_blocks, lanes) int32 scores, query ends and target
// ends for sw/nw/hw/ov, with -1 end planes in score-only mode.
//
// What bounds it on an H100: operations.  The sw score recurrence needs
// 10 int32 operations per cell at its least in plain int32 (G = H - go
// once, E and F a subtraction and a max each, the diagonal an add and a
// max, the clamp at 0, H, the running best); with Hopper's DPX add-max
// it is six instructions (E, F and the diagonal one add-max each, H =
// max(H, F, 0), G, the best), which chip_smoke.py's bound counts at the
// DPX rate it measures (tools/dpx_rate.cu).  It reads the database once
// per query (1 byte per cell column): at the main path's 256-row tier
// that is thousands of instructions per byte moved.  A single query
// (Aligner.align) has one target per lane, ~12K lanes for the
// 12,071-sequence database, so the work has to be spread inside each
// (query, target) to fill the card.
//
// Design: the wavefront walk of wave.cuh.  A group of G threads walks
// one (query, target lane): 16 query rows per thread in registers, the
// pass's profile in shared memory, the row above handed down the group
// with shuffles, no per-cell state in device memory.  G is the wrapper's
// choice per tier (ops/ragged.py: wave_group): 4 at the 64-row tier, 8 at
// 128, 16 from 256 rows up, so that one pass covers the tier up to 256
// rows; a query of 4,096 rows (or a fine tier of 5,120) takes 16 (20)
// passes through a buffer of H and F per (query, target column) that the
// wrapper allocates (torch.empty, laid out like the flat targets, as K2's
// and K5's are).  A CUDA block is 256 threads, 256 / G lanes of one
// query; its first flat row comes from row_off (the wrapper computes it
// from the step map).  A launch covers a range of queries and a range of
// lanes, and the wrapper splits a call into as many launches as keep the
// buffer within a fixed budget (ops/ragged.py: SCRATCH_BYTES); a call
// whose tier fits one pass needs no buffer and is one launch.  Each group
// stops at its own target's length, and every walk at the query's length.
//
// ptxas (CUDA 12.8, sm_90a, -O3) for the eight instantiations: 98-102
// registers, 32 KB shared memory, no stack frame, no spills; at 256
// threads a block, two blocks an SM.  chip_smoke.py prints them.
#include "wave.cuh"

namespace pyopal {

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS) ragged_kernel(
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
  const int Q = min(qlens[q], q_pad);
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  // this (query, lane)'s pass buffer: [query][H, F][row][lane], laid out
  // like the flat targets
  const size_t cells = (size_t)total_rows * lanes;
  int* pb_h = pbuf == nullptr ? nullptr : pbuf + 2 * cells * q + col0;
  int* pb_f = pb_h == nullptr ? nullptr : pb_h + cells;
  Track t = track_start<ALG>(Q, go, ge);
  wave_walk<ALG, ENDS, false>(sp, profs + (size_t)q * q_pad * ALPHA, q_pad,
                              0, Q, Q, flat + col0, lanes, len, nullptr,
                              nullptr, pb_h, pb_f, G, go, ge, t);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    const size_t out = (size_t)q * n_lanes + n;
    dp_finish<ALG, ENDS>(t, Q, len, scores + out, qends + out, tends + out);
  }
}

}  // namespace pyopal

using namespace pyopal;

// K4's arguments with the pass buffer in the scratch's place (nullptr
// when the tier fits one pass), then the flat layout's total rows and the
// group size.
extern "C" int pyopal_ragged_launch(
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
  const int per_block = WAVE_THREADS / group;
  const dim3 grid((lane_count + per_block - 1) / per_block, n_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(ragged_kernel, algorithm, with_ends, grid,
                  dim3(WAVE_THREADS), s, profs, qlens, flat, lengths,
                  row_off, scores, qends, tends, pbuf, q_pad, n_lanes, lanes,
                  lane0, lane_count, total_rows, group, go, ge);
  return (int)cudaGetLastError();
}
