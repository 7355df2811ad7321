// K1's packed route: every query of a cohort x every target lane of the
// flat database in sw score mode, two target lanes a walk, with H held at
// most a cap C given at launch.
//
// Replaces: nothing of its own.  It computes K1's function (ragged.cu,
// itself the port of pyopal_tpu/ops/pallas_ragged.py::_ragged_kernel_v2)
// in sw score mode, bit for bit, where ops/engine.py (_ragged_packed_cap)
// proves that no intermediate leaves int16: K1's int32 walk takes every
// other call.  Same inputs as K1 and the same (n_q, n_blocks, lanes) int32
// outputs: the score, and -1 in both end planes.
//
// What bounds it on an H100: operations.  K1 spends six DPX instructions
// on each cell.  Here one instruction serves two cells (s16x2): K7's 5.5
// packed instructions (q8_narrow.cu: ptxas takes two rows' G into the
// running best with one three-input max) and one __byte_perm that builds
// the row's pair of profile entries, 6.5 for a pair of cells.  It reads
// one byte of target a lane per column, as K1 does.
//
// Design: the wavefront walk of wave.cuh in its packed form (NARROW) over
// a pair of lanes (PAIR).  Lanes 2k and 2k + 1 of the length-sorted flat
// layout are one walk of one query: a group of G threads per (query, lane
// pair), 16 query rows per thread in registers, each int two int16 halves
// (low: lane 2k, high: lane 2k + 1).  The pass's profile is staged in
// shared memory as int16 entries (16 KB, half of K1's); a column reads
// both lanes' symbols, two int4 loads each per 16 rows, and interleaves
// them row by row with __byte_perm.  One 16-bit load brings a column of
// both lanes (lanes is even and the pair starts at an even lane).  G comes
// from the tier (ops/ragged.py: wave_group) as in K1: 4, 8 and 16 threads
// at 64, 128 and 256 rows; longer queries (512-4096 and the fine tiers)
// take passes through a buffer of packed G and F per (query, lane pair,
// column), laid out like the flat targets at half their width, which the
// wrapper allocates only then and splits within a fixed budget
// (ops/ragged.py: SCRATCH_BYTES, wave_buffer with pairs): half of K1's
// bytes a lane.  A CUDA block is 256 threads, 256 / G pairs of one query.
// The finish unpacks the tracker's halves, sign-extended, and adds go back.
//
// Columns walked: a pair walks to its longer lane's length.  The shorter
// lane's columns past its own length read the pad symbol (wave.cuh:
// WAVE_PAD_SYM, PAD_SCORE in every profile row under safe_pad), whose
// staged entry is clamped to -1024.  They cannot move its score, by the
// column-wise twin of q8_narrow.cu's pad-row argument: let M >= 0 be the
// best cell of the lane's own columns.  By induction over (column, row),
// every cell of a pad column is at most M: its diagonal move adds -1024 <
// 0 to a cell that is at most M (own or pad, or 0 on row 0), its
// horizontal gap subtracts go or ge >= 0 from cells of its row to the left
// (at most M), its vertical gap subtracts them from cells above it in the
// same pad column (at most M), and sw's clamp gives 0 <= M.  No cell of an
// own column depends on a pad column, which lies to its right.  The cap
// keeps the induction: min(., C) is monotone, so a capped pad-column cell
// is at most the capped M.  So both halves are tracked over every walked
// column.  An empty lane (length 0) has pad columns only, where every
// cell is 0 by the same induction: it reads 0, as K1 writes.
//
// Why C = min(Q_pad, T_max) x max |S| is never reached (T_max: the
// longest target of the launch's slice): an sw cell's H is the score of a
// local alignment ending there, at most one diagonal move per query row
// and per target column, each adding at most max S, every gap move
// subtracting go or ge >= 0; so H <= min(Q, len) x max(max S, 0) on a
// lane's own columns, and a pad-column cell is at most the best of those
// (above).  The arithmetic is q8_narrow.cu's, in int16 halves, at gaps
// go, ge >= 0 with go + ge <= 512 and C in [0, WAVE_CAP_MAX = 31743]
// (checked here and by the wrapper; ops/ragged.py: packed_ranges lists
// each intermediate's range, and its CPU emulation asserts each).
//
// ptxas (CUDA 12.8, sm_90a, -O3): 97 registers, 16 KB shared memory, no
// stack frame, no spills; at 256 threads a block, two blocks an SM, as
// K1.  Each pair of rows of a step compiles to K7's cell (s16x2 add-max,
// add-min, max with 0, a three-input max a second row) and one PRMT.
#include "wave.cuh"

namespace pyopal {

__global__ void __launch_bounds__(WAVE_THREADS) ragged_packed_kernel(
    const int* __restrict__ profs, const int* __restrict__ qlens,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends, int* pbuf, int q_pad,
    int n_lanes, int lanes, int lane0, int lane_count, int total_rows, int G,
    int go, int ge, int cap) {
  __shared__ int4 sp[WAVE_SMEM_INT4 / 2];  // int16 entries
  const int k = blockIdx.x * (WAVE_THREADS / G) + threadIdx.x / G;
  const int n = lane0 + 2 * k;  // the pair's low lane (lane0 is even)
  const int q = blockIdx.y;
  const bool valid = 2 * k < lane_count && n < n_lanes;
  const bool valid_b = valid && 2 * k + 1 < lane_count;
  const int b = valid ? n / lanes : 0;
  const int lane = valid ? n - b * lanes : 0;
  const int len_a = valid ? lengths[n] : 0;
  const int len_b = valid_b ? lengths[n + 1] : 0;
  const int Q = min(qlens[q], q_pad);
  const int half = lanes / 2;  // pairs a row of the flat layout
  const size_t col0 = (size_t)row_off[b] * half + lane / 2;
  // this (query, pair)'s pass buffer: [query][G, F][row][pair]
  const size_t cells = (size_t)total_rows * half;
  int* pb_h = pbuf == nullptr ? nullptr : pbuf + 2 * cells * q + col0;
  int* pb_f = pb_h == nullptr ? nullptr : pb_h + cells;
  Track t{wave_splat(-go), 0, -1, -1, -1};
  wave_walk<SW, false, false, ALPHA, false, false, true, true>(
      sp, profs + (size_t)q * q_pad * ALPHA, q_pad, 0, Q, Q, flat + 2 * col0,
      half, max(len_a, len_b), nullptr, nullptr, pb_h, pb_f, G, go, ge, t,
      cap, len_a, len_b);
  if (valid && (threadIdx.x & (G - 1)) == 0) {
    const size_t out = (size_t)q * n_lanes + n;
    scores[out] = wave_lo(t.best) + go;
    qends[out] = tends[out] = -1;
    if (valid_b) {
      scores[out + 1] = wave_hi(t.best) + go;
      qends[out + 1] = tends[out + 1] = -1;
    }
  }
}

}  // namespace pyopal

using namespace pyopal;

// K1's arguments (pyopal_ragged_launch), then H's cap; the walk exists
// for sw score only (algorithm SW, with_ends 0) at gaps >= 0 with go + ge
// <= -WAVE_FLOOR and a cap in [0, WAVE_CAP_MAX], over an even number of
// lanes from an even lane0, the flat targets 2-byte aligned.
extern "C" int pyopal_ragged_packed_launch(
    const int* profs, const int* qlens, const uint8_t* flat,
    const int* lengths, const int* row_off, int* scores, int* qends,
    int* tends, int* pbuf, int n_q, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    int total_rows, int group, int cap, void* stream) {
  if (algorithm != SW || with_ends || go < 0 || ge < 0 ||
      go + ge > -WAVE_FLOOR || cap < 0 || cap > WAVE_CAP_MAX ||
      (lanes & 1) || (lane0 & 1) || ((uintptr_t)flat & 1))
    return (int)cudaErrorInvalidValue;
  const int n_lanes = n_blocks * lanes;
  if (n_q == 0 || lane_count <= 0) return 0;
  if (group < 2 || group > WAVE_MAX_G || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  if (q_pad > group * WAVE_R && pbuf == nullptr)
    return (int)cudaErrorInvalidValue;  // several passes need the buffer
  const int per_block = WAVE_THREADS / group;
  const int pairs = (lane_count + 1) / 2;
  const dim3 grid((pairs + per_block - 1) / per_block, n_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ragged_packed_kernel<<<grid, dim3(WAVE_THREADS), 0, s>>>(
      profs, qlens, flat, lengths, row_off, scores, qends, tends, pbuf, q_pad,
      n_lanes, lanes, lane0, lane_count, total_rows, group, go, ge, cap);
  return (int)cudaGetLastError();
}
