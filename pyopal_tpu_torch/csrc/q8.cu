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
// What bounds it on an H100: operations.  Like K1 (ragged.cu) it needs
// 10 int32 operations per cell (and issues 11) and reads each database
// byte once per query.  Unlike K1 it fills the card: one launch of 8 groups
// over the 12,071-sequence database at 512 lanes is 64 x 12,288 threads.
// Its scratch then exceeds the 50 MB L2 (1.6 GB at the 256 tier),
// so each cell's 8-byte H/E load and store go to device memory; that
// traffic, not the bound's operations, is what this simple design pays.
//
// Design: the TPU kernel put 8 queries on the sublanes and walked rows
// serially; on a GPU the group of 8 means nothing to the hardware, so
// each (group, slot, lane) is one thread running the shared column-outer,
// row-inner DP (dp.cuh) with its row loop bounded by its own slot's qv
// (maxq is not needed).  The profile row stride is 8 x 32 ints because of
// the interleaving; a warp still reads one 128-byte profile row per query
// row, through the read-only data cache (__ldg).  Scratch is [group *
// 8 + slot][row][lane] int2 over the launch's groups and its lane range
// (lane0, lane_count); the wrapper splits a call into launches that keep
// it within a fixed budget (ops/ragged.py: SCRATCH_BYTES).
#include "dp.cuh"

namespace pyopal {

constexpr int QB = 8;

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(128) q8_kernel(
    const int* __restrict__ profs, const int* __restrict__ qv,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends,
    int2* __restrict__ scratch, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge) {
  const int n_lanes = n_blocks * lanes;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // global lane
  const int slot = blockIdx.y;
  const int g = blockIdx.z;
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int gs = g * QB + slot;
  const int Q = min(qv[(size_t)gs * lanes], q_pad);  // lane 0 of the slot
  const size_t out = (((size_t)g * n_blocks + b) * QB + slot) * lanes + lane;
  align_pair<ALG, ENDS>(
      profs + (size_t)g * QB * q_pad * ALPHA + slot * ALPHA, QB * ALPHA, Q,
      flat + (size_t)row_off[b] * lanes + lane, lanes, lengths[n],
      scratch + (size_t)gs * q_pad * lane_count + k, (size_t)lane_count, go,
      ge, scores + out, qends + out, tends + out);
}

}  // namespace pyopal

using namespace pyopal;

extern "C" int pyopal_q8_launch(
    const int* profs, const int* qv, const uint8_t* flat, const int* lengths,
    const int* row_off, int* scores, int* qends, int* tends, int2* scratch,
    int n_groups, int q_pad, int n_blocks, int lanes, int lane0,
    int lane_count, int go, int ge, int algorithm, int with_ends,
    void* stream) {
  if (n_groups == 0 || lane_count <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128, QB, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(q8_kernel, algorithm, with_ends, grid, block, s, profs, qv,
                  flat, lengths, row_off, scores, qends, tends, scratch, q_pad,
                  n_blocks, lanes, lane0, lane_count, go, ge);
  return (int)cudaGetLastError();
}
