// Affine-gap DP of one (query, target) pair, shared by the two kernels
// (ragged.cu, q8.cu).
//
// One thread owns one pair and walks the DP matrix column by column
// (target positions, outer loop) and row by row inside a column (query
// positions, inner loop).  F, the vertical gap, and the H values above
// and up-left of the current cell live in registers; the previous
// column's H/E per query row live in a per-launch scratch laid out
// [query][row][lane] as int2, so the 32 threads of a warp (neighbouring
// lanes) load and store one contiguous 256-byte run per row.
//
// Tie-breaking falls out of the visiting order: trackers update only on
// strictly greater values, so the first optimum in (column, row) order
// wins — max score, then min target column, then min query row, the
// rule of the reference oracle (pyopal_tpu/ops/naive.py).  hw/ov read
// the last query row after each column; ov reads the last target column
// with the same strictly-greater rule and loses ties to the last row;
// nw reads the terminal cell.  Each thread stops at its own target and
// query length, so pad symbols and pad profile rows are never read.
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

// Scores one pair and writes (score, query end, target end).
//
// prof: profile row 0 of this query; row i starts at prof + i * prof_stride
// tgt: target position 0 of this lane; position j at tgt + j * tgt_stride
// scr: scratch row 0 of this (query, lane); row i at scr + i * scr_stride
template <int ALG, bool ENDS>
__device__ __forceinline__ void align_pair(
    const int* __restrict__ prof, int prof_stride, int Q,
    const uint8_t* __restrict__ tgt, int tgt_stride, int len,
    int2* __restrict__ scr, size_t scr_stride, int go, int ge,
    int* out_score, int* out_qe, int* out_te) {
  constexpr bool kPenRow = ALG == NW;
  constexpr bool kPenCol = ALG == NW || ALG == HW;
  // H[Q][0]: the whole query as one first-column gap (also for Q == 0,
  // an empty slot of the q8 kernel, as the reference computes it)
  const int empty = -(go + (Q - 1) * ge);

  // column 0 of the DP matrix: the first-column boundary, E = -inf
  for (int i = 0; i < Q; ++i) {
    scr[i * scr_stride] = make_int2(kPenCol ? -(go + i * ge) : 0, NEG);
  }
  int best = ALG == HW ? empty : 0;  // sw/hw/ov running optimum
  int cap = ALG == NW ? empty : NEG;  // nw terminal / ov last column
  int bi = -1, bj = -1, ci = -1;

  for (int j = 0; j < len; ++j) {
    const int* __restrict__ p = prof + tgt[(size_t)j * tgt_stride];
    const bool last_col = j == len - 1;
    // row 0 of the DP matrix at columns j and j + 1
    int hdiag = (kPenRow && j > 0) ? -(go + (j - 1) * ge) : 0;
    int hup = kPenRow ? -(go + j * ge) : 0;
    int f = NEG;
    for (int i = 0; i < Q; ++i) {
      const int2 he = scr[i * scr_stride];
      const int e = max(he.x - go, he.y - ge);
      int t = max(hdiag + __ldg(p + i * prof_stride), e);
      if (ALG == SW) t = max(t, 0);
      f = max(hup - go, f - ge);
      const int h = max(t, f);
      hdiag = he.x;
      hup = h;
      scr[i * scr_stride] = make_int2(h, e);
      if (ALG == SW) {
        if (ENDS) {
          if (h > best) {
            best = h;
            bi = i;
            bj = j;
          }
        } else {
          best = max(best, h);
        }
      }
      if (ALG == OV && last_col && h > cap) {
        cap = h;
        ci = i;
      }
    }
    if (Q > 0) {  // hup is now H at the last query row
      if ((ALG == HW || ALG == OV) && hup > best) {
        best = hup;
        bj = j;
      }
      if (ALG == NW && last_col) cap = hup;
    }
  }

  int score, qe, te;
  if (ALG == SW) {
    score = best;
    qe = bi;
    te = bj;
  } else if (ALG == NW) {
    score = cap;
    qe = Q - 1;
    te = len - 1;
  } else if (ALG == HW) {
    score = best;
    qe = Q - 1;
    te = bj;
  } else {  // OV: ties go to the last-row end
    const bool use_col = cap > best;
    score = use_col ? cap : best;
    qe = use_col ? ci : Q - 1;
    te = use_col ? len - 1 : bj;
  }
  *out_score = score;
  *out_qe = ENDS ? qe : -1;
  *out_te = ENDS ? te : -1;
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
