// The wavefront walk of K1 (ragged.cu), K2 (q8.cu), K3 (ragged_long.cu),
// K4 (ragged_v1.cu), K5 (ragged_strip.cu), K6 (group.cu) and, in its
// packed 16-bit form, K7 and K2's exact route (q8_narrow.cu): a group of
// G threads per (query, target) with the query rows in registers.  K2's
// queries are the (group, slot) pairs of its row-interleaved profiles (a
// profile row stride of 8 x 32 ints); the packed walk's are pairs of
// slots, two queries in each register.
//
// Why: one thread per target (the kernels' first design) gives a
// single-query launch ~12K threads for a 12,071-sequence database, under
// a tenth of the H100's thread slots, and each thread walked the previous
// column's H/E through a [row][lane] scratch in device memory (16 bytes a
// cell, 200-500 MB at 2048-5,120 rows).  The walk was latency-bound on
// that serial chain.  Here:
//
// - A group of G threads (a power of two, 2..16, lanes of one warp)
//   walks one (query, target).  Thread t owns R = WAVE_R consecutive
//   query rows; one pass covers G * R rows, and a longer walk takes
//   several passes, in order.
// - Within a pass the group walks the target's columns as an
//   anti-diagonal wavefront: at step s thread t works on column s - t.
//   Thread t hands G = H - go and F of its last row at that column to
//   thread t + 1 with __shfl_up_sync, with the column's target symbol;
//   thread t + 1 keeps the value of the step before as its diagonal.
//   Thread 0 takes the row above the pass: the closed-form row 0, or a
//   buffer of H and F at every column laid out like the flat targets.
// - Each thread keeps its R rows' G = H - go of the previous column and
//   their E in registers (two arrays of G that swap roles every step,
//   so a step moves no registers).  No per-cell state goes to device
//   memory.
// - Between passes the last thread writes H and F of the pass's last
//   row at every column to that buffer (column j at step j + G - 1), and
//   the next pass's thread 0 reads it (column j at step j): K3 updates
//   its hb_out/fb_out in place this way; K1, K2, K4, K5 and K6 keep a
//   buffer of their own, and need none when the query fits one pass.
// - The pass's G * R profile rows are staged in shared memory once per
//   block (all groups of a block share the query) as [symbol][row] with
//   go added, interleaved so that a thread reads its R entries for one
//   symbol as R / 4 int4 loads, neighbouring threads on neighbouring
//   16-byte words (32 KB at G * R = 256).
// - Target symbols: the group loads a tile of G columns (one byte per
//   thread, the next tile G steps ahead of use); thread 0 takes column
//   s from the tile with a shuffle and passes it down the wavefront.
// - Arithmetic: Hopper's DPX add-max and max-with-0 (__viaddmax_s32,
//   __vimax_s32_relu), int32 throughout, NEG = -2^30 as in dp.cuh.  A
//   cell is E = max(E - ge, G_left), F = max(F - ge, G_up), H =
//   max(G_diag + (s + go), E), H = max(H, F[, 0]), G = H - go, and sw's
//   running best: six instructions.
//
// NARROW (q8_narrow.cu: K7 and K2's exact route, sw score only, H capped
// at a cap C, 255 for K7): every int of the row arrays, of the values
// handed down and of the tracker holds two int16 halves, the low one of
// slot 2p of a q8 group and the high one of slot 2p + 1 (wave_stage packs
// their profile rows), walked over the same target column.  The shuffles
// move both halves unchanged; the arithmetic is Hopper's packed DPX
// (__viaddmax_s16x2, __vimax_s16x2_relu, __viaddmin_s16x2) and a packed
// max, with the floor WAVE_FLOOR for -infinity and G = min(H, C) - go
// folded into one add-min.  A cell is E = max(E - ge, G_left), F = max(F
// - ge, G_up), H = max(G_diag + (s + go), E), H = max(H, F, 0), G = min(H
// - go, C - go) and best = max(best, G): six instructions for two cells.
// The tracker holds G (its start, -go, is the score 0), the buffer
// between passes holds G and F of the pass's last row, and no value
// leaves int16 (the ranges are in q8_narrow.cu).
//
// PAIR (ragged_packed.cu: K1's packed route): the packed walk of one
// query against two target lanes, the low half lane 2k's and the high
// half lane 2k + 1's.  The pass's profile is staged as int16 entries
// [symbol][k][thread][8 rows] (16 KB at G * R = 256), so a thread reads
// its 16 rows of one symbol as two int4 loads; a column reads both lanes'
// symbols and builds each row's packed entry with one __byte_perm.  One
// 16-bit load brings both lanes' bytes of a column (the lanes are
// adjacent in the flat layout), and the pair of symbols travels down the
// group as one int.  A pair walks to its longer lane's length; the
// shorter lane's columns past its own read the pad symbol WAVE_PAD_SYM,
// whose staged entry is clamped to -WAVE_CLAMP (ragged_packed.cu: why
// that leaves its score).  The stride between columns counts pairs: the
// target is read as uint16 and the pass buffer holds one packed G and F
// per (pair, column).
//
// Trackers keep dp.cuh's rule: max score, then the lowest target column,
// then the lowest query row.  Each thread tracks its own rows over its
// columns (sw: a running max per cell, and on a new maximum the first of
// its rows that holds it); a pass's tracker joins the thread's by the
// rule, the G threads' trackers join with shuffles by the rule, and the
// walk's with the incoming one (the closed-form start, or K3's previous
// launch) by the rule, which takes an equal score at a smaller column.
// hw/ov read the query's last row, and nw its terminal cell, only in the
// thread and pass that hold row Q - 1; ov's last column joins by (score
// desc, row asc) and still loses ties to the last row (dp_finish).  Rows
// past the walk are neither walked (threads wholly past it skip the
// cell work) nor tracked (the pass that holds the walk's last row masks
// them when it ends inside a thread).  The PAD_ROWS variant (K4, K5 and
// K6 at negative gaps) walks the profile's pad rows past the query too:
// sw and ov track them, in end mode too (the first row of a new maximum
// may be a pad row, ov's last-column row likewise), and row Q - 1,
// wherever it lies, is read for hw/ov/nw.  Where the pad rows end inside
// a thread (PAD_TAIL: K6's profiles have a multiple of 8 rows) the pass
// that holds row Q - 1 is also the final one, and it masks the rows past
// the walk as well.
#pragma once

#include <climits>

#include "dp.cuh"

namespace pyopal {

constexpr int WAVE_R = 16;            // query rows per thread
constexpr int WAVE_MAX_G = 16;        // threads per group, at most
constexpr int WAVE_THREADS = 256;     // threads per CUDA block
constexpr int WAVE_PAD = -4000000;    // profile rows past the query
constexpr unsigned WAVE_FULL = 0xffffffffu;
// shared memory of one block: a pass's profile, [symbol][k][thread] int4
constexpr int WAVE_SMEM_INT4 = ALPHA * WAVE_R * WAVE_MAX_G / 4;

// max(a + b, c) and max(a, b, 0): one DPX instruction each on sm_90
__device__ __forceinline__ int wave_addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}
__device__ __forceinline__ int wave_max_relu(int a, int b) {
  return __vimax_s32_relu(a, b);
}

// NARROW: two int16 halves in one int (low: slot 2p, high: slot 2p + 1)
constexpr int WAVE_FLOOR = -512;  // E and F's -infinity: any <= -(go + ge)
constexpr int WAVE_CLAMP = 1024;  // profile entries are clamped into +-this
constexpr int WAVE_CAP = 255;     // K7 holds H at most this (NARROW_CAP)
// the largest cap: H + s + go stays within int16 (q8_narrow.cu)
constexpr int WAVE_CAP_MAX = 32767 - WAVE_CLAMP;
// PAIR: the symbol a lane reads past its length (the flat packing's pad
// symbol, which scores PAD_SCORE in every profile row under safe_pad)
constexpr int WAVE_PAD_SYM = 31;
__device__ __forceinline__ int wave_pack(int lo, int hi) {
  return (int)(((unsigned)lo & 0xffffu) | ((unsigned)hi << 16));
}
__device__ __forceinline__ int wave_splat(int v) { return wave_pack(v, v); }
// the halves, sign-extended
__device__ __forceinline__ int wave_lo(int v) { return (v << 16) >> 16; }
__device__ __forceinline__ int wave_hi(int v) { return v >> 16; }
// max(a + b, c), max(a, b, 0), min(a + b, c) and max(a, b) on each half
__device__ __forceinline__ int wave_addmax2(int a, int b, int c) {
  return (int)__viaddmax_s16x2((unsigned)a, (unsigned)b, (unsigned)c);
}
__device__ __forceinline__ int wave_max_relu2(int a, int b) {
  return (int)__vimax_s16x2_relu((unsigned)a, (unsigned)b);
}
__device__ __forceinline__ int wave_addmin2(int a, int b, int c) {
  return (int)__viaddmin_s16x2((unsigned)a, (unsigned)b, (unsigned)c);
}
__device__ __forceinline__ int wave_max2(int a, int b) {
  int r;
  asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// (score desc, column asc, row asc): whether a comes before b
__device__ __forceinline__ bool wave_first(int as, int aj, int ai, int bs,
                                           int bj, int bi) {
  return as > bs || (as == bs && (aj < bj || (aj == bj && ai < bi)));
}

// Stages profile rows [base, base + G * R) of the walk (rows past
// prof_rows score WAVE_PAD) with go added, for every symbol.  Profile row
// i starts at prof + i * PSTRIDE: ALPHA for K1, K3-K6, 8 * ALPHA for K2's
// and K7's row-interleaved groups.  NARROW: each entry holds two, of row i
// (low half) and of the row ALPHA ints after it (high half: the next slot
// of a q8 group), each clamped into [-WAVE_CLAMP, WAVE_CLAMP] before go.
// PAIR: one int16 entry of row i, clamped so, as [symbol][k][thread][8].
template <int PSTRIDE = ALPHA, bool NARROW = false, bool PAIR = false>
__device__ __forceinline__ void wave_stage(int4* sp,
                                           const int* __restrict__ prof,
                                           int prof_rows, int base, int G,
                                           int go) {
  constexpr int R = WAVE_R;
  int* s = reinterpret_cast<int*>(sp);
  const int n = G * R * ALPHA;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int row = idx / ALPHA;  // within the pass
    const int sym = idx - row * ALPHA;
    if (PAIR) {
      int v = base + row < prof_rows
                  ? __ldg(prof + (size_t)(base + row) * PSTRIDE + sym)
                  : WAVE_PAD;
      v = min(max(v, -WAVE_CLAMP), WAVE_CLAMP) + go;
      const int t = row / R, rr = row - t * R;
      reinterpret_cast<short*>(sp)[((sym * (R / 8) + (rr >> 3)) * G + t) * 8 +
                                   (rr & 7)] = (short)v;
      continue;
    }
    if (NARROW) {
      int lo = WAVE_PAD, hi = WAVE_PAD;
      if (base + row < prof_rows) {
        const int* p = prof + (size_t)(base + row) * PSTRIDE + sym;
        lo = __ldg(p);
        hi = __ldg(p + ALPHA);
      }
      lo = min(max(lo, -WAVE_CLAMP), WAVE_CLAMP);
      hi = min(max(hi, -WAVE_CLAMP), WAVE_CLAMP);
      const int t = row / R, rr = row - t * R;
      s[((sym * (R / 4) + (rr >> 2)) * G + t) * 4 + (rr & 3)] =
          wave_pack(lo + go, hi + go);
      continue;
    }
    const int v = base + row < prof_rows
                      ? __ldg(prof + (size_t)(base + row) * PSTRIDE + sym)
                      : WAVE_PAD;
    const int t = row / R, rr = row - t * R;
    s[((sym * (R / 4) + (rr >> 2)) * G + t) * 4 + (rr & 3)] = v + go;
  }
}

// One walk's state in one thread (everything but the row arrays).
struct WaveThread {
  const int4* sp;                 // the pass's staged profile
  const uint8_t* __restrict__ tgt;  // this lane's (PAIR: pair's) column 0
  const int* bh;                  // buffer above the pass (H, F)
  const int* bf;
  int* wh;                        // buffer written by this pass
  int* wf;
  int stride, len, G, t, go, ge;
  int q0, nv, rl;                 // first global row, rows walked, last row
  bool top, owner, write_rows, track_last;
  int gdiag, out_g, out_f, out_sym;
  int ts_cur, ts_next, th_cur, th_next, tf_cur, tf_next;  // column tiles
  int pb, pbi, pbj;               // sw: this pass's tracker
  int lb, lbj, cap;               // hw/ov last row, nw terminal (owner)
  int oc, oci;                    // ov last column
  int rq;                         // PAD_ROWS: row Q - 1 in its thread
  int ngo2, gcap2, nge2, floor2;  // NARROW: -go, cap - go, -ge, the floor
  int len_a, len_b;               // PAIR: each lane's length (len: longer)

  // PAIR: both lanes' symbols (low byte lane 2k's), a lane past its length
  // reading WAVE_PAD_SYM
  template <bool PAIR = false>
  __device__ __forceinline__ void load_tiles(int col) {
    const bool in = col < len;
    if (PAIR) {
      const int v =
          in ? reinterpret_cast<const uint16_t*>(tgt)[(size_t)col * stride]
             : 0;
      ts_next = (col < len_a ? v & 0xff : WAVE_PAD_SYM) |
                (col < len_b ? v >> 8 : WAVE_PAD_SYM) << 8;
    } else {
      ts_next = in ? tgt[(size_t)col * stride] : 0;
    }
    if (!top) {
      th_next = in ? bh[(size_t)col * stride] : 0;
      tf_next = in ? bf[(size_t)col * stride] : 0;
    }
  }
};

// One packed cell (NARROW) of row r, its profile entry pv: E, F, H, G =
// min(H, cap) - go, and the running best over the walk's rows.
template <bool MASK>
__device__ __forceinline__ void wave_cell2(WaveThread& w, int r, int pv,
                                           int nge, const int (&Gi)[WAVE_R],
                                           int (&Go)[WAVE_R],
                                           int (&E)[WAVE_R], int& f, int& gup,
                                           int& gd) {
  const int e = wave_addmax2(E[r], nge, Gi[r]);
  E[r] = e;
  f = wave_addmax2(f, nge, gup);
  const int h = wave_max_relu2(wave_addmax2(gd, pv, e), f);
  gd = Gi[r];
  Go[r] = wave_addmin2(h, w.ngo2, w.gcap2);
  gup = Go[r];
  if (!MASK || r < w.nv) w.pb = wave_max2(w.pb, gup);
}

// Step s of a pass: receive the row above, walk column s - t.  QROW
// (PAD_ROWS, the pass that holds row Q - 1): the thread that holds it
// tracks that row, and the pass's owner writes the buffer.  MASK: rows
// past the walk's last row, in the pass's owner and past it, are not
// tracked; with QROW (PAD_TAIL) both hold.  NARROW: the packed form;
// PAIR: its two target lanes.
template <int ALG, bool ENDS, bool MASK, bool QROW = false,
          bool NARROW = false, bool PAIR = false>
__device__ __forceinline__ void wave_step(WaveThread& w, int s,
                                          const int (&Gi)[WAVE_R],
                                          int (&Go)[WAVE_R],
                                          int (&E)[WAVE_R]) {
  constexpr int R = WAVE_R;
  constexpr bool kPenRow = ALG == NW;
  const int G = w.G;
  const int src = s & (G - 1);
  if (src == 0 && s > 0) {
    w.ts_cur = w.ts_next;
    w.th_cur = w.th_next;
    w.tf_cur = w.tf_next;
    w.load_tiles<PAIR>(s + G + w.t);
  }
  const int sym0 = __shfl_sync(WAVE_FULL, w.ts_cur, src, G);
  int gtop, ftop;
  if (NARROW && w.top) {  // sw's row 0: H = 0
    gtop = w.ngo2;
    ftop = w.floor2;
  } else if (NARROW) {  // the buffer holds G
    gtop = __shfl_sync(WAVE_FULL, w.th_cur, src, G);
    ftop = __shfl_sync(WAVE_FULL, w.tf_cur, src, G);
  } else if (w.top) {
    gtop = (kPenRow ? -(w.go + s * w.ge) : 0) - w.go;
    ftop = NEG;
  } else {
    gtop = __shfl_sync(WAVE_FULL, w.th_cur, src, G) - w.go;
    ftop = __shfl_sync(WAVE_FULL, w.tf_cur, src, G);
  }
  int gup = __shfl_up_sync(WAVE_FULL, w.out_g, 1, G);
  int f = __shfl_up_sync(WAVE_FULL, w.out_f, 1, G);
  int sym = __shfl_up_sync(WAVE_FULL, w.out_sym, 1, G);
  if (w.t == 0) {
    gup = gtop;
    f = ftop;
    sym = sym0;
  }
  w.out_sym = sym;
  const int j = s - w.t;
  if (w.nv <= 0 || j < 0 || j >= w.len) {
#pragma unroll
    for (int r = 0; r < R; ++r) Go[r] = Gi[r];  // idle: the column stays
    return;
  }

  const int go = w.go, nge = NARROW ? w.nge2 : -w.ge;
  int gd = w.gdiag;
  w.gdiag = gup;
  const int best0 = w.pb;
  int fq = 0;
  if (PAIR) {
    // each lane's 16 rows of its symbol: two int4 of eight int16 entries
    const int4* pa = w.sp + (sym & 0xff) * (R / 8) * G + w.t;
    const int4* pz = w.sp + (sym >> 8) * (R / 8) * G + w.t;
#pragma unroll
    for (int k = 0; k < R / 8; ++k) {
      const int4 a4 = pa[k * G], z4 = pz[k * G];
      const int av[4] = {a4.x, a4.y, a4.z, a4.w};
      const int zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // row 8k + c: lane 2k's entry low
        const int pv =
            __byte_perm(av[c >> 1], zv[c >> 1], c & 1 ? 0x7632 : 0x5410);
        wave_cell2<MASK>(w, 8 * k + c, pv, nge, Gi, Go, E, f, gup, gd);
      }
    }
  } else {
    const int4* ps = w.sp + sym * (R / 4) * G + w.t;
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const int4 p4 = ps[k * G];
      const int pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 4 * k + c;
        if (NARROW) {
          wave_cell2<MASK>(w, r, pv[c], nge, Gi, Go, E, f, gup, gd);
          continue;
        }
        const int e = wave_addmax(E[r], nge, Gi[r]);
        E[r] = e;
        f = wave_addmax(f, nge, gup);
        int h = wave_addmax(gd, pv[c], e);
        h = ALG == SW ? wave_max_relu(h, f) : max(h, f);
        gd = Gi[r];
        Go[r] = h - go;
        gup = Go[r];
        if (ALG == SW && (!MASK || r < w.nv)) w.pb = max(w.pb, h);
        if (MASK && r == w.rl) fq = f;
      }
    }
  }
  w.out_g = gup;
  w.out_f = f;

  if (ALG == SW && ENDS && w.pb > best0) {
    // a new maximum in this column: its first row among this thread's
    int ri = 0;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      if ((!MASK || r < w.nv) && Go[r] == w.pb - go) ri = r;
    }
    w.pbi = w.q0 + ri;
    w.pbj = j;
  }
  if (ALG == OV && j == w.len - 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int h = Go[r] + go;
      if ((!MASK || r < w.nv) && h > w.oc) {
        w.oc = h;
        w.oci = w.q0 + r;
      }
    }
  }
  if (QROW) {
    if (w.track_last) {
      int gq = Go[0];
#pragma unroll
      for (int r = 1; r < R; ++r) gq = r == w.rq ? Go[r] : gq;
      const int hq = gq + go;
      if ((ALG == HW || ALG == OV) && hq > w.lb) {
        w.lb = hq;
        w.lbj = j;
      }
      if (ALG == NW && j == w.len - 1) w.cap = hq;
    }
    if (w.owner && w.write_rows) {
      if (MASK) {  // the pass's last row ends inside the owner: row rl
        int gq = Go[R - 1];
#pragma unroll
        for (int r = 0; r < R - 1; ++r) gq = r == w.rl ? Go[r] : gq;
        w.wh[(size_t)j * w.stride] = gq + go;
        w.wf[(size_t)j * w.stride] = fq;
      } else {
        w.wh[(size_t)j * w.stride] = Go[R - 1] + go;
        w.wf[(size_t)j * w.stride] = f;
      }
    }
  } else if (w.owner) {
    // H and F of the pass's (the walk's) last row held by this thread
    int gq = Go[R - 1];
    if (MASK) {
#pragma unroll
      for (int r = 0; r < R - 1; ++r) gq = r == w.rl ? Go[r] : gq;
    } else {
      fq = f;
    }
    const int hq = NARROW ? gq : gq + go;  // NARROW: the buffer holds G
    if (w.track_last) {
      if ((ALG == HW || ALG == OV) && hq > w.lb) {
        w.lb = hq;
        w.lbj = j;
      }
      if (ALG == NW && j == w.len - 1) w.cap = hq;
    }
    if (w.write_rows) {
      w.wh[(size_t)j * w.stride] = hq;
      w.wf[(size_t)j * w.stride] = fq;
    }
  }
}

template <int ALG, bool ENDS, bool MASK, bool QROW = false,
          bool NARROW = false, bool PAIR = false>
__device__ __forceinline__ void wave_pass(WaveThread& w, int nsteps,
                                          int (&GA)[WAVE_R],
                                          int (&GB)[WAVE_R],
                                          int (&E)[WAVE_R]) {
  for (int s = 0; s < nsteps; s += 2) {  // nsteps is even
    wave_step<ALG, ENDS, MASK, QROW, NARROW, PAIR>(w, s, GA, GB, E);
    wave_step<ALG, ENDS, MASK, QROW, NARROW, PAIR>(w, s + 1, GB, GA, E);
  }
}

// Walks rows [row0, row0 + rows) of a query of Q rows against one target
// (len columns; column j at tgt + j * stride), in passes of G * WAVE_R
// rows, and joins the trackers into trk (the incoming tracker on entry).
// Every thread of the block calls it (it synchronises the block); a
// thread without a target passes len = 0.
//
// prof: profile row row0 of the query; prof_rows rows from there.
// hb_in/fb_in: H and F of row row0 - 1 at every column (read when
//   row0 > 0), laid out like tgt.
// pb_h/pb_f: the buffer between passes, laid out like tgt and updated in
//   place (column j read at step j, written at step j + G - 1; no
//   __restrict__, so no load moves past a store).  With SEG_OUT (K3) it
//   also receives H and F of the walk's last row; without it (K1, K2,
//   K4-K6) the last pass writes nothing.
// PSTRIDE: ints from one profile row to the next (wave_stage).
// PAD_ROWS (K4, K5 and K6 at negative gaps): the walk's rows go past the
//   query's Q rows (profile rows that score PAD_SCORE) and count for sw's
//   best cell and ov's last column, while hw, ov and nw read the last
//   row at row Q - 1, in whichever pass and thread hold it; rows must
//   then be a multiple of WAVE_R unless PAD_TAIL.
// PAD_TAIL (K4, K6): with PAD_ROWS, rows may end inside a thread (K6's
//   profiles have a multiple of 8 rows): the pass that holds row Q - 1
//   may then also be the final pass, which masks the rows past the walk.
// NARROW (q8_narrow.cu): the packed walk of two queries, profile rows
//   prof and prof + ALPHA ints (sw score only, gaps >= 0 with go + ge <=
//   -WAVE_FLOOR, cap in [0, WAVE_CAP_MAX]); trk.best is the packed
//   tracker of G = min(H, cap) - go, -go in both halves on entry.
// PAIR (ragged_packed.cu, with NARROW): the packed walk of one query
//   (profile rows prof) against two target lanes, lengths len_a (low
//   half) and len_b (high half); len is the longer, tgt the pair's bytes
//   of column 0, read as uint16, and stride counts pairs, in the target
//   and in the buffer.
// All G threads of a group return the same tracker.
template <int ALG, bool ENDS, bool SEG_OUT, int PSTRIDE = ALPHA,
          bool PAD_ROWS = false, bool PAD_TAIL = false, bool NARROW = false,
          bool PAIR = false>
__device__ __forceinline__ void wave_walk(
    int4* sp, const int* __restrict__ prof, int prof_rows, int row0,
    int rows, int Q, const uint8_t* __restrict__ tgt, int stride, int len,
    const int* hb_in, const int* fb_in, int* pb_h, int* pb_f, int G, int go,
    int ge, Track& trk, int cap = WAVE_CAP, int len_a = 0, int len_b = 0) {
  constexpr int R = WAVE_R;
  constexpr bool kPenCol = ALG == NW || ALG == HW;
  static_assert(!NARROW || (ALG == SW && !ENDS && !SEG_OUT && !PAD_ROWS),
                "the packed walk is sw score-only");
  static_assert(!PAIR || (NARROW && PSTRIDE == ALPHA),
                "a pair of lanes takes the packed walk of one query");
  const int t = threadIdx.x & (G - 1);
  const int GR = G * R;
  const int n_pass = rows > 0 ? (rows + GR - 1) / GR : 0;
  const int last_base = n_pass > 0 ? (n_pass - 1) * GR : 0;
  const int own_last = rows > 0 ? (rows - 1 - last_base) / R : 0;
  const bool has_last = rows > 0 && row0 + rows == Q;
  // PAD_ROWS: row Q - 1 (qlast of the walk) lies in pass pass_q, thread
  // own_q
  const int qlast = Q - 1 - row0;
  const bool has_q = PAD_ROWS && 0 <= qlast && qlast < rows;
  const int pass_q = has_q ? qlast / GR : -1;
  const int own_q = has_q ? qlast % GR / R : 0;
  const int wlen = __reduce_max_sync(WAVE_FULL, len);
  int nsteps = wlen > 0 ? wlen + G - 1 : 0;
  nsteps += nsteps & 1;

  WaveThread w;
  w.sp = sp;
  w.tgt = tgt;
  w.stride = stride;
  w.len = len;
  w.len_a = len_a;
  w.len_b = len_b;
  w.G = G;
  w.t = t;
  w.go = go;
  w.ge = ge;
  w.lb = trk.best;
  w.lbj = trk.bj;
  w.cap = trk.cap;
  w.oc = NEG;
  w.oci = INT_MAX;
  if (NARROW) {
    w.ngo2 = wave_splat(-go);
    w.gcap2 = wave_splat(cap - go);
    w.nge2 = wave_splat(-ge);
    w.floor2 = wave_splat(WAVE_FLOOR);
  }
  int sb = 0, sbi = -1, sbj = -1;  // sw: this thread's, over its passes
  if (NARROW) sb = w.ngo2;

  int GA[R], GB[R], E[R];
  for (int p = 0; p < n_pass; ++p) {
    const int base = p * GR;
    const bool final_pass = p == n_pass - 1;
    __syncthreads();  // every group is done with the previous profile
    wave_stage<PSTRIDE, NARROW, PAIR>(sp, prof, prof_rows, base, G, go);
    __syncthreads();
    w.q0 = row0 + base + t * R;
    w.nv = min(max(row0 + rows - w.q0, 0), R);
    w.rl = final_pass ? (rows - 1 - base) % R : R - 1;
    w.owner = final_pass ? t == own_last : t == G - 1;
    w.write_rows = final_pass ? SEG_OUT : true;
    w.track_last =
        PAD_ROWS ? p == pass_q && t == own_q : final_pass && has_last;
    w.rq = qlast % R;
    w.top = base == 0 && row0 == 0;
    w.bh = base == 0 ? hb_in : pb_h;
    w.bf = base == 0 ? fb_in : pb_f;
    w.wh = pb_h;
    w.wf = pb_f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = w.q0 + r;
      GA[r] = NARROW ? w.ngo2 : (kPenCol ? -(go + q * ge) : 0) - go;
      E[r] = NARROW ? w.floor2 : NEG;
    }
    w.gdiag = NARROW ? w.ngo2
                     : (w.q0 == 0 ? 0 : (kPenCol ? -(go + (w.q0 - 1) * ge)
                                                 : 0)) - go;
    w.out_g = 0;
    w.out_f = NARROW ? w.floor2 : NEG;
    w.out_sym = 0;
    w.pb = ALG == SW && !ENDS ? sb : 0;
    w.pbi = -1;
    w.pbj = -1;
    w.th_next = w.tf_next = 0;
    w.load_tiles<PAIR>(t);
    w.ts_cur = w.ts_next;
    w.th_cur = w.th_next;
    w.tf_cur = w.tf_next;
    w.load_tiles<PAIR>(G + t);
    if (PAD_ROWS && PAD_TAIL && p == pass_q && final_pass &&
        rows % R != 0) {
      wave_pass<ALG, ENDS, true, true>(w, nsteps, GA, GB, E);
    } else if (PAD_ROWS && p == pass_q) {
      wave_pass<ALG, ENDS, false, true>(w, nsteps, GA, GB, E);
    } else if (final_pass && rows % R != 0) {
      wave_pass<ALG, ENDS, true, false, NARROW, PAIR>(w, nsteps, GA, GB, E);
    } else {
      wave_pass<ALG, ENDS, false, false, NARROW, PAIR>(w, nsteps, GA, GB,
                                                       E);
    }
    if (ALG == SW) {
      if (!ENDS) {
        sb = w.pb;
      } else if (wave_first(w.pb, w.pbj, w.pbi, sb, sbj, sbi)) {
        sb = w.pb;
        sbi = w.pbi;
        sbj = w.pbj;
      }
    }
    __syncwarp();  // this pass's buffer writes before the next one reads
  }

  // join the G threads' trackers, then the incoming one
  if (ALG == SW) {
    for (int m = 1; m < G; m <<= 1) {
      const int os = __shfl_xor_sync(WAVE_FULL, sb, m, G);
      const int oi = __shfl_xor_sync(WAVE_FULL, sbi, m, G);
      const int oj = __shfl_xor_sync(WAVE_FULL, sbj, m, G);
      if (NARROW) {
        sb = wave_max2(sb, os);
      } else if (ENDS ? wave_first(os, oj, oi, sb, sbj, sbi) : os > sb) {
        sb = os;
        sbi = oi;
        sbj = oj;
      }
    }
    if (NARROW) {
      trk.best = wave_max2(trk.best, sb);
    } else if (!ENDS) {
      trk.best = max(trk.best, sb);
    } else if (wave_first(sb, sbj, sbi, trk.best, trk.bj, trk.bi)) {
      trk.best = sb;
      trk.bi = sbi;
      trk.bj = sbj;
    }
  }
  if (ALG == OV) {
    for (int m = 1; m < G; m <<= 1) {
      const int oc = __shfl_xor_sync(WAVE_FULL, w.oc, m, G);
      const int oi = __shfl_xor_sync(WAVE_FULL, w.oci, m, G);
      if (oc > w.oc || (oc == w.oc && oi < w.oci)) {
        w.oc = oc;
        w.oci = oi;
      }
    }
    if (w.oc > trk.cap || (w.oc == trk.cap && w.oci < trk.ci)) {
      trk.cap = w.oc;
      trk.ci = w.oci;
    }
  }
  const int own = PAD_ROWS ? own_q : own_last;  // holds row Q - 1
  if (ALG == HW || ALG == OV) {
    trk.best = __shfl_sync(WAVE_FULL, w.lb, own, G);
    trk.bj = __shfl_sync(WAVE_FULL, w.lbj, own, G);
  }
  if (ALG == NW) trk.cap = __shfl_sync(WAVE_FULL, w.cap, own, G);
}

}  // namespace pyopal
