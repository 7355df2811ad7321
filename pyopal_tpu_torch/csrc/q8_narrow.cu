// The packed sw score-only walk of the q8 groups: groups of 8 queries x
// every target lane of the flat database, two queries a walk, with H held
// at most a cap C given at launch.  Two routes launch it:
//
// - K7, C = NARROW_CAP = 255: the saturating pass.
//   Replaces: pyopal_tpu/ops/pallas_q8.py::_q8_kernel with narrow=True
//   (l.180-202, 310-313), launched by search_flat_q8(narrow=True) (l.467).
//   The TPU kernel keeps its DP state in bf16, exact on the integers of
//   [-256, 256], and clamps H at the cap; a lane whose true score reaches
//   the cap reads exactly 255 and is flagged (score >= NARROW_CAP), every
//   other lane is exact.  The same function: score = min(sw score, 255).
//   Below the cap nothing clamps, and the first cell whose true H reaches
//   it has exact predecessors, so it stores 255.
// - K2's exact route, C = Q_pad x max |S| (ops/engine.py:
//   _packed_exact_domain): no sw cell of these profiles exceeds C (below),
//   so the add-min never binds and the scores are K2's (q8.cu) in sw score
//   mode, bit for bit.
//
// K2's inputs and outputs: row-interleaved int32 profiles (n_groups, 8 *
// Q_pad, 32), per-slot lengths qv (n_groups, 8, lanes), and (n_groups,
// n_blocks, 8, lanes) int32 outputs: the score, and -1 in both end planes.
//
// What bounds it on an H100: operations.  It is K2's DP with two cells in
// each instruction: six packed DPX instructions for a pair of cells, 5.5
// where ptxas takes two rows' G into the running best with one
// three-input max (under three a cell, K2's six), against one byte of
// target per column of each lane per pair of queries.
//
// Design: the wavefront walk of wave.cuh in its packed form (NARROW), as
// K2 walks it otherwise.  Each pair of slots (2p, 2p + 1) of a group is
// one walk of two queries: a group of G threads per (group, pair, target
// lane), 16 query rows per thread in registers, each int two int16
// halves (low: slot 2p, high: slot 2p + 1), no per-cell state in device
// memory.  The grid is (lane blocks, 4 pairs, groups); a CUDA block is
// 256 threads, 256 / G lanes of one (group, pair).  G comes from the tier
// (ops/ragged.py: wave_group): 4, 8 and 16 at 64, 128 and 256 rows, one
// pass and no buffer; the 512 and 1024 tiers take 2 and 4 passes through
// a buffer of packed G and F per (group, pair, target column), laid out
// like the flat targets, which the wrapper allocates only then and splits
// within a fixed budget (ops/ragged.py: SCRATCH_BYTES, wave_buffer), as
// K2's.  The finish unpacks the tracker's halves, sign-extended, and adds
// go back.
//
// Rows walked: a pair walks rows [0, max(Q_2p, Q_2p+1)), and the rows
// past the walk are masked.  The shorter slot's rows past its own length
// are its profile's PAD_SCORE rows (empty slots: every row), clamped to
// -1024 below.  They cannot move its score: at gaps >= 0, which are all
// this walk takes, every cell of a pad row is at most the best cell of
// the query's last row at a column no later (the induction in
// ragged_v1.cu, "Which rows the walk covers": a diagonal move into a pad
// row adds the clamped -1024 < 0, a gap move subtracts go or ge >= 0),
// and no cell of a query row depends on a pad row.  The cap keeps that
// induction: min(., C) is monotone, so a capped pad-row cell is still at
// most the capped best of the query's rows.  So both halves are tracked
// over every walked row.  An empty slot (Q = 0) has pad rows only, where
// every cell is 0 by the same induction: it reads 0, the score
// track_start<SW> gives it and K2 writes, as does a pair with no rows.
//
// Why C = Q_pad x max |S| is never reached: an sw cell's H is the score
// of a local alignment ending there, at most one diagonal move per query
// row above it, each adding at most max S, every gap move subtracting go
// or ge >= 0; so H <= Q_pad x max(max S, 0) on the query's rows, and a
// pad-row cell is at most the best of those (above).
//
// Arithmetic, in int16 halves, at gaps go, ge >= 0 with go + ge <= 512
// and a cap C in [0, WAVE_CAP_MAX = 31743] (checked here and by the
// wrapper; ops/ragged.py: packed_ranges lists the same ranges, and the
// CPU emulation asserts each; no intermediate leaves [-32768, 32767], so
// whether an s16x2 add wraps or saturates never matters):
// - profile entries are clamped into [-1024, 1024] as they are staged:
//   an entry beyond +1024 takes the diagonal past the cap of K7, one
//   below -1024 takes it below 0, either way as the entry itself would
//   (K2's exact route admits no matrix entry beyond +-1024, so only pad
//   entries clamp there); s + go lies in [go - 1024, go + 1024];
// - G = min(H, C) - go lies in [-go, C - go] (H >= 0: sw clamps at 0);
//   the tracker holds G, from -go;
// - E and F start from the floor -512 instead of -infinity; any floor at
//   or below -(go + ge) gives the same result, because G >= -go wins
//   every max with floor - ge; E - ge, F - ge, E and F lie in
//   [-512 - ge, C - go];
// - G_diag + s + go lies in [-1024, C + 1024], H = max(that, E, F, 0) in
//   [0, C + 1024], H - go in [-go, C + 1024 - go] before the add-min caps
//   it; C + 1024 <= 32767 is what bounds the cap.
// At K7's C = 255 and gaps in [0, 255] every range lies within [-1279,
// 1279].
//
// ptxas (CUDA 12.8, sm_90a, -O3): see PERF.md (chip_smoke.py's build
// phase prints it).
#include "wave.cuh"

namespace pyopal {

constexpr int QB_NARROW = 8;
constexpr int PAIRS = QB_NARROW / 2;

__global__ void __launch_bounds__(WAVE_THREADS) q8_packed_kernel(
    const int* __restrict__ profs, const int* __restrict__ qv,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends, int* pbuf, int q_pad,
    int n_blocks, int lanes, int lane0, int lane_count, int total_rows,
    int G, int go, int ge, int cap) {
  __shared__ int4 sp[WAVE_SMEM_INT4];
  const int n_lanes = n_blocks * lanes;
  const int k = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const int n = lane0 + k;  // global lane
  const int pair = blockIdx.y;
  const int g = blockIdx.z;
  const int gs = g * QB_NARROW + 2 * pair;  // the pair's low slot
  const bool valid = k < lane_count && n < n_lanes;
  const int b = valid ? n / lanes : 0;
  const int lane = valid ? n - b * lanes : 0;
  const int len = valid ? lengths[n] : 0;
  // lane 0 of each slot: the pair walks its longer query's rows
  const int Q = min(max(qv[(size_t)gs * lanes], qv[(size_t)(gs + 1) * lanes]),
                    q_pad);
  const size_t col0 = (size_t)row_off[b] * lanes + lane;
  // this (group, pair, lane)'s pass buffer: [group][pair][G, F][row][lane]
  const size_t cells = (size_t)total_rows * lanes;
  int* pb_h = pbuf == nullptr
                  ? nullptr
                  : pbuf + 2 * cells * (g * PAIRS + pair) + col0;
  int* pb_f = pb_h == nullptr ? nullptr : pb_h + cells;
  Track t{wave_splat(-go), 0, -1, -1, -1};
  wave_walk<SW, false, false, QB_NARROW * ALPHA, false, false, true>(
      sp, profs + ((size_t)g * QB_NARROW * q_pad + 2 * pair) * ALPHA, q_pad,
      0, Q, Q, flat + col0, lanes, len, nullptr, nullptr, pb_h, pb_f, G, go,
      ge, t, cap);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    const size_t out =
        (((size_t)g * n_blocks + b) * QB_NARROW + 2 * pair) * lanes + lane;
    scores[out] = wave_lo(t.best) + go;
    scores[out + lanes] = wave_hi(t.best) + go;
    qends[out] = qends[out + lanes] = -1;
    tends[out] = tends[out + lanes] = -1;
  }
}

}  // namespace pyopal

using namespace pyopal;

// K2's shape of arguments (pyopal_q8_launch): the launch's groups, the
// pass buffer (nullptr when the tier fits one pass), the flat layout's
// total rows and the group size, then H's cap; the walk exists for sw
// score only (algorithm SW, with_ends 0) at gaps >= 0 with go + ge <=
// -WAVE_FLOOR and a cap in [0, WAVE_CAP_MAX].
extern "C" int pyopal_q8_narrow_launch(
    const int* profs, const int* qv, const uint8_t* flat, const int* lengths,
    const int* row_off, int* scores, int* qends, int* tends, int* pbuf,
    int n_groups, int q_pad, int n_blocks, int lanes, int lane0,
    int lane_count, int go, int ge, int algorithm, int with_ends,
    int total_rows, int group, int cap, void* stream) {
  if (algorithm != SW || with_ends || go < 0 || ge < 0 ||
      go + ge > -WAVE_FLOOR || cap < 0 || cap > WAVE_CAP_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0 || lane_count <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  if (q_pad > group * WAVE_R && pbuf == nullptr)
    return (int)cudaErrorInvalidValue;  // several passes need the buffer
  const int per_block = WAVE_THREADS / group;
  const dim3 grid((lane_count + per_block - 1) / per_block, PAIRS, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  q8_packed_kernel<<<grid, dim3(WAVE_THREADS), 0, s>>>(
      profs, qv, flat, lengths, row_off, scores, qends, tends, pbuf, q_pad,
      n_blocks, lanes, lane0, lane_count, total_rows, group, go, ge, cap);
  return (int)cudaGetLastError();
}
