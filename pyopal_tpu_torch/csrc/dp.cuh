// The trackers and the finish that every int32 kernel shares (Track,
// track_start, dp_finish: K1-K6 on wave.cuh), the dispatch of a kernel
// template over (algorithm, mode), and the constants, which K7
// (q8_narrow.cu, wave.cuh's packed walk) takes too.
//
// Tie-breaking: max score, then min target column, then min query row,
// the rule of the reference oracle (pyopal_tpu/ops/naive.py).  The
// trackers update only on strictly greater values as the walk visits the
// cells in (column, row) order, and wave.cuh joins trackers by that rule;
// hw/ov read the last query row, ov the last target column with ties to
// the lowest row, losing ties to the last row; nw reads the terminal
// cell.
//
// All arithmetic is int32; NEG = -2^30 stays clear of wraparound because
// every recurrence takes a max with a finite term before subtracting a
// gap penalty again.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace pyopal {

constexpr int NEG = -(1 << 30);
constexpr int ALPHA = 32;  // profile columns per row

enum Algorithm { SW = 0, NW = 1, HW = 2, OV = 3 };

// Running optimum of one pair: best (sw: any cell, hw/ov: last row), cap
// (nw: terminal cell, ov: last column) and their end rows/columns.
struct Track {
  int best, cap, bi, bj, ci;
};

// The trackers before the first column of a query of Q rows.
template <int ALG>
__device__ __forceinline__ Track track_start(int Q, int go, int ge) {
  // H[Q][0]: the whole query as one first-column gap (also for Q == 0,
  // an empty slot of the q8 kernel, as the reference computes it)
  const int empty = -(go + (Q - 1) * ge);
  return Track{ALG == HW ? empty : 0, ALG == NW ? empty : NEG, -1, -1, -1};
}

// Writes (score, query end, target end) of a pair from its trackers.
// Without ENDS no position was tracked.  K1, K2 and K5 then write -1 in
// both end planes, as their TPU kernels do; with SCORE_PLANES (K3, K4,
// K6) the planes hold what those kernels' finalize writes from untracked
// (-1) positions: nw Q - 1 and len - 1, hw Q - 1 and -1, ov Q - 1 and -1
// or, when the last column wins, -1 and len - 1, sw -1 and -1.
template <int ALG, bool ENDS, bool SCORE_PLANES = false>
__device__ __forceinline__ void dp_finish(const Track& t, int Q, int len,
                                          int* out_score, int* out_qe,
                                          int* out_te) {
  const int bi = ENDS ? t.bi : -1;
  const int bj = ENDS ? t.bj : -1;
  const int ci = ENDS ? t.ci : -1;
  int score, qe, te;
  if (ALG == SW) {
    score = t.best;
    qe = bi;
    te = bj;
  } else if (ALG == NW) {
    score = t.cap;
    qe = Q - 1;
    te = len - 1;
  } else if (ALG == HW) {
    score = t.best;
    qe = Q - 1;
    te = bj;
  } else {  // OV: ties go to the last-row end
    const bool use_col = t.cap > t.best;
    score = use_col ? t.cap : t.best;
    qe = use_col ? ci : Q - 1;
    te = use_col ? len - 1 : bj;
  }
  constexpr bool kPlanes = ENDS || SCORE_PLANES;
  *out_score = score;
  *out_qe = kPlanes ? qe : -1;
  *out_te = kPlanes ? te : -1;
}

// Instantiates KERNEL<ALG, ENDS> for the runtime (algorithm, with_ends)
// pair and launches it with the given configuration and arguments.
#define PYOPAL_DISPATCH(KERNEL, algorithm, with_ends, grid, block, stream, \
                        ...)                                               \
  do {                                                                     \
    switch ((algorithm) * 2 + ((with_ends) ? 1 : 0)) {                     \
      case 0: KERNEL<SW, false><<<grid, block, 0, stream>>>(__VA_ARGS__); break; \
      case 1: KERNEL<SW, true><<<grid, block, 0, stream>>>(__VA_ARGS__); break;  \
      case 2: KERNEL<NW, false><<<grid, block, 0, stream>>>(__VA_ARGS__); break; \
      case 3: KERNEL<NW, true><<<grid, block, 0, stream>>>(__VA_ARGS__); break;  \
      case 4: KERNEL<HW, false><<<grid, block, 0, stream>>>(__VA_ARGS__); break; \
      case 5: KERNEL<HW, true><<<grid, block, 0, stream>>>(__VA_ARGS__); break;  \
      case 6: KERNEL<OV, false><<<grid, block, 0, stream>>>(__VA_ARGS__); break; \
      case 7: KERNEL<OV, true><<<grid, block, 0, stream>>>(__VA_ARGS__); break;  \
      default: return (int)cudaErrorInvalidValue;                          \
    }                                                                      \
  } while (0)

}  // namespace pyopal
