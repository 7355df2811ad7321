// K2: groups of 8 same-tier queries x every target lane of the flat
// database.
//
// Replaces: pyopal_tpu/ops/pallas_q8.py::_q8_kernel (l.138, narrow=False),
// launched by search_flat_q8 (l.467).  Same interface and outputs: row-
// interleaved profiles (n_groups, 8 * Q_pad, 32), per-slot lengths qv
// (n_groups, 8, lanes), 256- or 512-lane packs, and (n_groups, n_blocks,
// 8, lanes) int32 scores, query ends and target ends.  Empty slots
// (qv = 0) write the reference's deterministic empty-slot values.
//
// What bounds it on an H100: operations.  It is K1's DP (ragged.cu) over
// 64 (group, slot) queries at once: six DPX-fused instructions a cell in
// the walk below (10 in plain int32), against one byte of target per
// column of each lane per query.  One launch of the main path's 8 groups
// at 512 lanes is 64 x 12,160 target lanes, so the card is full.
//
// Design: the wavefront walk of wave.cuh, as in K1.  Each (group, slot)
// is one query of K1's walk: a group of G threads per (group, slot,
// target lane), 16 query rows per thread in registers, no per-cell state
// in device memory.  The TPU kernel put the 8 queries on the sublanes;
// here they only share a launch.  The grid is (lane blocks, 8 slots,
// groups); a CUDA block is 256 threads, 256 / G lanes of one (group,
// slot), so its groups of threads share that slot's staged profile and
// its __syncthreads stay uniform, also for an empty slot (Q = 0: no
// pass, the trackers as track_start leaves them, as the old one-thread
// walk wrote them).  Row i of slot s sits at row 8 i + s of the group's
// profile, so the walk stages rows at a stride of 8 x 32 ints
// (wave_stage<PSTRIDE>), one 128-byte row per query row as in K1.  G
// comes from the tier (ops/ragged.py: wave_group): 4, 8 and 16 at 64,
// 128 and 256 rows, one pass each; the 512 and 1024 tiers take 2 and 4
// passes through a buffer of H and F per (group, slot, target column),
// laid out like the flat targets, which the wrapper allocates only then
// and splits within a fixed budget (ops/ragged.py: SCRATCH_BYTES,
// launch_plan), as K1's.  Each group of threads stops at its own target's
// length, and every walk at its slot's length (lane 0 of qv).
//
// ptxas (CUDA 12.8, sm_90a, -O3) for the eight instantiations: see
// PERF.md (chip_smoke.py's build phase prints them).
#include "wave.cuh"

namespace pyopal {

constexpr int QB = 8;

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(WAVE_THREADS) q8_kernel(
    const int* __restrict__ profs, const int* __restrict__ qv,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends, int* pbuf, int q_pad,
    int n_blocks, int lanes, int lane0, int lane_count, int total_rows,
    int G, int go, int ge) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  const int n_lanes = n_blocks * lanes;
  const int k = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const int n = lane0 + k;  // global lane
  const int slot = blockIdx.y;
  const int g = blockIdx.z;
  const int gs = g * QB + slot;
  const bool valid = k < lane_count && n < n_lanes;
  const int b = valid ? n / lanes : 0;
  const int lane = valid ? n - b * lanes : 0;
  const int len = valid ? lengths[n] : 0;
  const int Q = min(qv[(size_t)gs * lanes], q_pad);  // lane 0 of the slot
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  // this (group, slot, lane)'s pass buffer: [group][slot][H, F][row][lane]
  const size_t cells = (size_t)total_rows * lanes;
  int* pb_h = pbuf == nullptr ? nullptr : pbuf + 2 * cells * gs + col0;
  int* pb_f = pb_h == nullptr ? nullptr : pb_h + cells;
  Track t = track_start<ALG>(Q, go, ge);
  wave_walk<ALG, ENDS, false, QB * ALPHA>(
      sp, profs + (size_t)g * QB * q_pad * ALPHA + slot * ALPHA, q_pad, 0, Q,
      Q, flat + col0, lanes, len, nullptr, nullptr, pb_h, pb_f, G, go, ge, t);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    const size_t out =
        (((size_t)g * n_blocks + b) * QB + slot) * lanes + lane;
    dp_finish<ALG, ENDS>(t, Q, len, scores + out, qends + out, tends + out);
  }
}

}  // namespace pyopal

using namespace pyopal;

// The launch's groups, then the pass buffer (nullptr when the tier fits
// one pass), the flat layout's total rows and the group size: K1's shape
// of arguments (pyopal_ragged_launch).
extern "C" int pyopal_q8_launch(
    const int* profs, const int* qv, const uint8_t* flat, const int* lengths,
    const int* row_off, int* scores, int* qends, int* tends, int* pbuf,
    int n_groups, int q_pad, int n_blocks, int lanes, int lane0,
    int lane_count, int go, int ge, int algorithm, int with_ends,
    int total_rows, int group, void* stream) {
  if (n_groups == 0 || lane_count <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  if (q_pad > group * WAVE_R && pbuf == nullptr)
    return (int)cudaErrorInvalidValue;  // several passes need the buffer
  const int per_block = WAVE_THREADS / group;
  const dim3 grid((lane_count + per_block - 1) / per_block, QB, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(q8_kernel, algorithm, with_ends, grid, dim3(WAVE_THREADS),
                  s, profs, qv, flat, lengths, row_off, scores, qends, tends,
                  pbuf, q_pad, n_blocks, lanes, lane0, lane_count, total_rows,
                  group, go, ge);
  return (int)cudaGetLastError();
}
