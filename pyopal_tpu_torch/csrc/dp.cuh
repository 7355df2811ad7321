// The one-thread affine-gap DP of K4 (ragged_v1.cu) and K6 (group.cu),
// and the trackers and finish that every int32 kernel shares (Track,
// track_start, dp_finish: also K1, K2, K3 and K5 on wave.cuh).  K7
// (q8_narrow.cu) takes its constants.
//
// dp_walk: one thread owns one (query, target) pair and walks the DP
// matrix column by column (target positions, outer loop) and row by row
// inside a column (query positions, inner loop).  F, the vertical gap,
// and the H values above and up-left of the current cell live in
// registers; the previous column's H/E per query row live in a
// per-launch scratch laid out [query][row][lane] as int2, so the 32
// threads of a warp (neighbouring lanes) load and store one contiguous
// 256-byte run per row.  The walk covers the profile's pad rows past the
// query, as the TPU kernels of K4 and K6 do (PAD_ROWS): they count for
// sw's best cell and ov's last column, while hw, ov and nw read the
// query's last row at Q - 1.
//
// Tie-breaking falls out of the visiting order: trackers update only on
// strictly greater values, so the first optimum in (column, row) order
// wins — max score, then min target column, then min query row, the
// rule of the reference oracle (pyopal_tpu/ops/naive.py).  hw/ov read
// the last query row after each column; ov reads the last target column
// with the same strictly-greater rule and loses ties to the last row; nw
// reads the terminal cell.  Each thread stops at its own target length,
// so pad symbols are never read.
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

// Walks rows [0, rows) of a query of Q <= rows rows (rows past Q are the
// profile's pad rows) against one target.
//
// prof: profile row 0 of this query; row i at prof + i * prof_stride
// tgt: target position 0 of this lane; position j at tgt + j * tgt_stride
// scr: scratch row 0 of this (query, lane); row i at scr + i * scr_stride
template <int ALG, bool ENDS>
__device__ __forceinline__ void dp_walk(
    const int* __restrict__ prof, int prof_stride, int rows, int Q,
    const uint8_t* __restrict__ tgt, int tgt_stride, int len,
    int2* __restrict__ scr, size_t scr_stride, int go, int ge, Track& t) {
  constexpr bool kPenRow = ALG == NW;
  constexpr bool kPenCol = ALG == NW || ALG == HW;
  const int last = Q - 1;  // the query's last row
  const bool has_last = rows > 0;

  // column 0 of the DP matrix: the first-column boundary, E = -inf
  for (int i = 0; i < rows; ++i) {
    scr[i * scr_stride] = make_int2(kPenCol ? -(go + i * ge) : 0, NEG);
  }

  for (int j = 0; j < len; ++j) {
    const size_t jt = (size_t)j * tgt_stride;
    const int* __restrict__ p = prof + tgt[jt];
    const bool last_col = j == len - 1;
    // the closed-form row 0 above at columns j and j + 1, and F entering
    int hdiag = (kPenRow && j > 0) ? -(go + (j - 1) * ge) : 0;
    int hup = kPenRow ? -(go + j * ge) : 0;
    int f = NEG;
    int hq = 0;  // H at the query's last row
    for (int i = 0; i < rows; ++i) {
      const int2 he = scr[i * scr_stride];
      const int e = max(he.x - go, he.y - ge);
      int h = max(hdiag + __ldg(p + i * prof_stride), e);
      if (ALG == SW) h = max(h, 0);
      f = max(hup - go, f - ge);
      h = max(h, f);
      hdiag = he.x;
      hup = h;
      scr[i * scr_stride] = make_int2(h, e);
      if (ALG == SW) {
        if (ENDS) {
          if (h > t.best) {
            t.best = h;
            t.bi = i;
            t.bj = j;
          }
        } else {
          t.best = max(t.best, h);
        }
      }
      if (ALG == OV && last_col && h > t.cap) {
        t.cap = h;
        t.ci = i;
      }
      if (i == last) hq = h;
    }
    if (has_last) {
      if ((ALG == HW || ALG == OV) && hq > t.best) {
        t.best = hq;
        t.bj = j;
      }
      if (ALG == NW && last_col) t.cap = hq;
    }
  }
}

// Writes (score, query end, target end) of a pair from its trackers.
// Without ENDS no position was tracked.  K1, K2 and K5 then write -1 in
// both end planes, as their TPU kernels do; with SCORE_PLANES (K3, K4, K6) the
// planes hold what those kernels' finalize writes from untracked (-1)
// positions: nw Q - 1 and len - 1, hw Q - 1 and -1, ov Q - 1 and -1 or,
// when the last column wins, -1 and len - 1, sw -1 and -1.
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
