// K5: every query of a cohort x every target lane of the flat database,
// score only, in strips of query rows, for matrices whose 32nd column is a
// real letter.
//
// Replaces: pyopal_tpu/ops/pallas_ragged.py::_ragged_kernel_strip (l.732),
// the strip-blocked score-only kernel that search_flat (l.1049) launches
// without safe_pad at query tiers of 512 rows and more.  Outputs: (n_q,
// n_blocks, lanes) int32 scores for sw/nw/hw/ov, and -1 in both end
// planes, as the TPU kernel's finalize (l.989-990) writes.  Like K4
// (ragged_v1.cu) the walk covers all Q_pad profile rows: sw's best cell
// and ov's last-column maximum range over the pad rows past the query,
// and hw/nw/ov read the query's last row at Q - 1, in whichever strip
// holds it.  The TPU kernel kept its state in f32, exact below 2^24; here
// it is int32.
//
// What bounds it on an H100: operations, at 10 int32 operations per cell
// (ragged.cu), against one byte of target per column of each lane per
// query; a 3,000-residue query at the 4096 tier over the 12,071-sequence
// database needs 14.1 G cells and walks 19.2 G (its pad rows score
// PAD_SCORE and cannot raise a score; this simple kernel walks them as
// the TPU kernel does).  One query gives one thread per target (12,160
// lanes), under a tenth of the card's thread slots, so this simple kernel
// is latency-bound on each thread's serial chain, like K1 on one query.
//
// Design: the TPU kernel cut Q_pad into strips of STRIP = 256 rows to
// shorten its per-column max-scan.  Here the strips bound the scratch: one
// thread per (query, target lane) walks its target once per strip, in
// order, with dp.cuh's segmented walk (SEG, as K3's segments):
// - the strip's H/E scratch is STRIP rows x int2 per thread, 2 KB, 25 MB
//   for the database's 12,160 lanes, which fits the 50 MB L2 where K1's
//   and K3's 2048-5,120-row scratch does not;
// - the row above a strip is the previous strip's bottom row, H and F at
//   every column of the lane, in a boundary buffer laid out like the flat
//   targets ((total_rows, lanes) int32 each for H and F, per query), read
//   and written in place: column j is read before it is overwritten;
// - the trackers stay in registers across strips (score only: every
//   tracker merges by max, and nw's terminal cell lies in one strip).
// The wrapper splits a call into launches over query and lane ranges
// within a fixed scratch budget (ops/ragged.py: SCRATCH_BYTES).
#include "dp.cuh"

namespace pyopal {

constexpr int STRIP = 256;

template <int ALG>
__global__ void __launch_bounds__(128) ragged_strip_kernel(
    const int* __restrict__ profs, const int* __restrict__ qlens,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends,
    int2* __restrict__ scratch, int* bound, size_t cells, int q_pad,
    int n_lanes, int lanes, int lane0, int lane_count, int go, int ge) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // global lane
  const int q = blockIdx.y;
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int Q = qlens[q];  // 1..q_pad (checked by the wrapper)
  const int len = lengths[n];
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  int* hb = bound + 2 * cells * q + col0;  // [query][H, F][row][lane]
  int* fb = hb + cells;
  const int* prof = profs + (size_t)q * q_pad * ALPHA;
  int2* scr = scratch + (size_t)q * STRIP * lane_count + k;
  Track t = track_start<ALG>(Q, go, ge);
  for (int row0 = 0; row0 < q_pad; row0 += STRIP) {
    dp_walk<ALG, false, true, true>(
        prof + (size_t)row0 * ALPHA, ALPHA, row0, min(STRIP, q_pad - row0),
        Q, flat + col0, lanes, len, scr, (size_t)lane_count, go, ge, hb, fb,
        hb, fb, t);
  }
  const size_t out = (size_t)q * n_lanes + n;
  dp_finish<ALG, false>(t, Q, len, scores + out, qends + out, tends + out);
}

}  // namespace pyopal

using namespace pyopal;

// K1's and K4's arguments (score only: with_ends must be 0), then the
// strip boundary buffer and the flat layout's total rows.
extern "C" int pyopal_ragged_strip_launch(
    const int* profs, const int* qlens, const uint8_t* flat,
    const int* lengths, const int* row_off, int* scores, int* qends,
    int* tends, int2* scratch, int n_q, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    int* bound, int total_rows, void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (with_ends) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || lane_count <= 0) return 0;
  const size_t cells = (size_t)total_rows * lanes;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128, n_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PYOPAL_STRIP(A)                                                      \
  ragged_strip_kernel<A><<<grid, block, 0, s>>>(                             \
      profs, qlens, flat, lengths, row_off, scores, qends, tends, scratch,   \
      bound, cells, q_pad, n_lanes, lanes, lane0, lane_count, go, ge)
  switch (algorithm) {
    case SW: PYOPAL_STRIP(SW); break;
    case NW: PYOPAL_STRIP(NW); break;
    case HW: PYOPAL_STRIP(HW); break;
    case OV: PYOPAL_STRIP(OV); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PYOPAL_STRIP
  return (int)cudaGetLastError();
}
