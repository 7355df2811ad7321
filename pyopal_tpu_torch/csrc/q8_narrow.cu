// K7: the saturating sw score-only pass of the q8 kernel: groups of 8
// queries x every target lane of the flat database, with H held at most
// NARROW_CAP = 255.
//
// Replaces: pyopal_tpu/ops/pallas_q8.py::_q8_kernel with narrow=True
// (l.180-202, 310-313), launched by search_flat_q8(narrow=True) (l.467).
// K2's (q8.cu) inputs and outputs: row-interleaved int32 profiles (n_groups,
// 8 * Q_pad, 32), per-slot lengths qv (n_groups, 8, lanes), and (n_groups,
// n_blocks, 8, lanes) int32 outputs: the score, and -1 in both end planes.
// The TPU kernel keeps its DP state in bf16, exact on the integers of
// [-256, 256], and clamps H at the cap; a lane whose true score reaches
// the cap reads exactly 255 and is flagged (score >= NARROW_CAP), every
// other lane is exact.  The same function: score = min(sw score, 255).
// Below the cap nothing clamps, and the first cell whose true H reaches
// it has exact predecessors, so it stores 255.
//
// Arithmetic, int32 in registers and int16 in the scratch:
// - H in [0, 255] (sw clamps at 0, the cap above);
// - E and F start from FLOOR = -512 instead of -infinity, which int16
//   cannot hold; any floor at or below -(go + ge) gives the same result,
//   because H >= 0 makes H - go win every max with the floor (gaps in
//   [0, 255], checked by the wrapper), so stored E lies in [-255, 255];
// - profile entries are clamped into [-1024, 1024] as they are loaded:
//   an entry beyond +1024 takes the diagonal past the cap, one below
//   -1024 takes it below 0, either way as the entry itself would.
//
// What bounds it on an H100: operations (10 int32 operations per cell),
// against one byte of target per column of each lane per query.  The
// one-thread walk's int2 H/E scratch (8 bytes a cell, loaded and stored,
// in device memory at the main path's 1.6 GB) set the time of K2 before
// K2 moved to wave.cuh; here the scratch is short2, 4 bytes a cell, so
// its traffic halves.
//
// Design: one thread per (group, slot, lane), 128 threads per block,
// columns outer and rows inner, the row loop bounded by the slot's own
// length; scratch [group * 8 + slot][row][lane] short2 over the launch's
// groups and lane range, split within a fixed budget by the wrapper
// (ops/ragged.py: SCRATCH_BYTES, launch_plan).
#include "dp.cuh"

namespace pyopal {

constexpr int QB_NARROW = 8;
constexpr int NARROW_CAP = 255;
constexpr int FLOOR = -512;
constexpr int PROF_CLAMP = 1024;

__global__ void __launch_bounds__(128) q8_narrow_kernel(
    const int* __restrict__ profs, const int* __restrict__ qv,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends,
    short2* __restrict__ scratch, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge) {
  const int n_lanes = n_blocks * lanes;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // global lane
  const int slot = blockIdx.y;
  const int g = blockIdx.z;
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int gs = g * QB_NARROW + slot;
  const int Q = min(qv[(size_t)gs * lanes], q_pad);  // lane 0 of the slot
  const int len = lengths[n];
  const int prof_stride = QB_NARROW * ALPHA;
  const int* __restrict__ prof =
      profs + (size_t)g * QB_NARROW * q_pad * ALPHA + slot * ALPHA;
  const uint8_t* __restrict__ tgt = flat + (size_t)row_off[b] * lanes + lane;
  short2* __restrict__ scr = scratch + (size_t)gs * q_pad * lane_count + k;
  const size_t stride = (size_t)lane_count;

  for (int i = 0; i < Q; ++i) scr[i * stride] = make_short2(0, FLOOR);
  int best = 0;
  for (int j = 0; j < len; ++j) {
    const int* __restrict__ p = prof + tgt[(size_t)j * lanes];
    int hdiag = 0, hup = 0, f = FLOOR;  // sw: row 0 is 0
    for (int i = 0; i < Q; ++i) {
      const short2 he = scr[i * stride];
      const int e = max(he.x - go, he.y - ge);
      const int s = min(max(__ldg(p + i * prof_stride), -PROF_CLAMP),
                        PROF_CLAMP);
      f = max(hup - go, f - ge);
      const int h = min(max(max(hdiag + s, e), max(f, 0)), NARROW_CAP);
      hdiag = he.x;
      hup = h;
      scr[i * stride] = make_short2((short)h, (short)e);
      best = max(best, h);
    }
  }
  const size_t out = (((size_t)g * n_blocks + b) * QB_NARROW + slot) * lanes
                     + lane;
  scores[out] = best;
  qends[out] = -1;
  tends[out] = -1;
}

}  // namespace pyopal

using namespace pyopal;

// The launch's groups and lane range with their short2 scratch; the pass
// exists for sw score only (algorithm SW, with_ends 0).
extern "C" int pyopal_q8_narrow_launch(
    const int* profs, const int* qv, const uint8_t* flat, const int* lengths,
    const int* row_off, int* scores, int* qends, int* tends,
    short2* scratch, int n_groups, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    void* stream) {
  if (algorithm != SW || with_ends) return (int)cudaErrorInvalidValue;
  if (n_groups == 0 || lane_count <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128, QB_NARROW, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  q8_narrow_kernel<<<grid, block, 0, s>>>(
      profs, qv, flat, lengths, row_off, scores, qends, tends, scratch,
      q_pad, n_blocks, lanes, lane0, lane_count, go, ge);
  return (int)cudaGetLastError();
}
