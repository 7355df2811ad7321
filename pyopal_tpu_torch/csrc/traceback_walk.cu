// T2: the traceback walk of full mode over resident direction bytes.
//
// Replaces: pyopal_tpu/ops/traceback.py::_walk_batch_device (l.197), a
// lax.while_loop over lock-stepped pairs (XLA in the reference, not
// Pallas).  Same outputs: pair b's op at step s, end to start (255 =
// none), and (i, j) its 1-based start cell.  Each pair runs the state
// machine H/E/F from its end cell (qe + 1, te + 1): the boundary rules per
// algorithm (nw walks the first row and column as gaps, hw the first
// column, ov and sw stop there; sw stops at DIR_STOP), the open bits
// defaulting to true off the matrix, the byte read at the reference's
// clipped flat index (i - 1) * T_pad + (j - 1) where a gap state stands on
// row or column 0, and the stop at LMAX steps.  A pair that the
// reference's loop keeps stepping after it is done emits 255 and keeps its
// cell, so each walk stops at its own end and fills the rest with 255.
//
// Layouts: the direction bytes as T1 writes them, (B, T_pad, Qs) with Qs a
// multiple of 16 (the wrapper transposes a (B, Qd, T_pad) tensor into it
// first), and the ops as (B, LMAX_s), LMAX_s = LMAX rounded up to 16: a
// pair's ops are contiguous, stored 16 at a time; the wrapper presents
// them as the (LMAX, B) view.
//
// What bounds it on an H100: the walk's steps, one after the other.  A
// step needs one direction byte (a 32-byte sector of device memory: the
// byte bound) and a handful of dependent integer instructions; reading the
// byte from device memory costs a round trip to L2 or HBM a step, so a
// launch takes as long as its longest walk's chain of steps.
//
// Design: one warp per pair, 4 pairs a block.  The warp loads a tile of
// TR = 64 rows x TC = 64 columns of the direction bytes up and to the left
// of the current cell into shared memory, 16 bytes a lane, all of a lane's
// loads in flight at once (rows from a multiple of 16, so the cell has
// 48-63 rows and 63 columns of room).  The walk then runs in every lane
// alike (the same state, broadcast reads of one shared byte) until the
// path leaves the tile by its top row or left column, and the next tile
// is loaded at the cell where it left: a diagonal path takes one round
// trip to memory per 48 steps or more instead of one a step.  Inside a
// tile every cell has i, j >= 1, so the step there is short: the byte's
// code in H, its open bit in E and F, a move up, left or both; the
// boundary rows and the clipped reads take the general step outside.  The
// ops are shifted into four registers (3 for none, widened to 255 as they
// are stored) and stored 16 at a time, and the tail of 255s in 16-byte
// stores, so the buffer needs no fill beforehand.
#include <climits>

#include "dp.cuh"

namespace pyopal {

constexpr int TW_WARPS = 4;   // pairs per block
constexpr int TW_ROWS = 64;   // tile rows (a multiple of 16)
constexpr int TW_COLS = 64;   // tile columns
constexpr int TW_CHUNKS = TW_ROWS / 16;  // 16-byte chunks a tile column
constexpr unsigned TB_OP_MATCH = 0, TB_OP_DEL = 1, TB_OP_INS = 2;
constexpr unsigned TB_OP_NONE = 3;  // no op this step: 255 in the output
constexpr int TB_E_OPEN = 4, TB_F_OPEN = 8;

// four ops a word, TB_OP_NONE (both low bits set) widened to 255
__device__ __forceinline__ unsigned tw_widen(unsigned x) {
  return x | (((x & (x >> 1)) & 0x01010101u) * 0xfcu);
}

template <int ALG>
__global__ void __launch_bounds__(TW_WARPS * 32) traceback_walk_kernel(
    const uint8_t* __restrict__ dirs, const int* __restrict__ qes,
    const int* __restrict__ tes, uint8_t* __restrict__ buf,
    int* __restrict__ i_out, int* __restrict__ j_out, int B, int Qd, int Qs,
    int T_pad, int lmax, int lmax_s) {
  constexpr bool FIRST_ROW = ALG == NW;
  constexpr bool FIRST_COL = ALG == NW || ALG == HW;
  constexpr bool CLAMP = ALG == SW;
  __shared__ uint4 tiles[TW_WARPS][TW_COLS * TW_CHUNKS];
  // read once: the compiler may not re-read the thread index in the loop
  unsigned tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int lane = tid & 31;
  const int b = blockIdx.x * TW_WARPS + (tid >> 5);
  if (b >= B) return;  // uniform over the warp
  uint4* tile4 = tiles[tid >> 5];
  const uint8_t* tile = reinterpret_cast<const uint8_t*>(tile4);
  const uint8_t* pd = dirs + (size_t)b * T_pad * Qs;
  uint8_t* out = buf + (size_t)b * lmax_s;
  const long long cells = (long long)Qd * T_pad;
  int i = qes[b] + 1, j = tes[b] + 1;
  int st = 0;  // 0 = H, 1 = E, 2 = F
  bool done = i == 0 && j == 0;
  int r0 = INT_MAX, c0 = INT_MAX;  // the tile's first row and column
  unsigned o0 = ~0u, o1 = ~0u, o2 = ~0u, o3 = ~0u;  // the last 16 ops
  int s = 0;
  // op s enters at the top byte; after 16 steps o0..o3 hold ops s-15..s,
  // stored with TB_OP_NONE widened to 255
  auto push = [&](unsigned op) {
    o0 = __funnelshift_r(o0, o1, 8);
    o1 = __funnelshift_r(o1, o2, 8);
    o2 = __funnelshift_r(o2, o3, 8);
    o3 = __funnelshift_r(o3, op, 8);
    if ((s & 15) == 15)  // every lane stores the same 16 bytes
      *reinterpret_cast<uint4*>(out + s - 15) =
          make_uint4(tw_widen(o0), tw_widen(o1), tw_widen(o2), tw_widen(o3));
  };
  while (s < lmax && !done) {
    if ((unsigned)(i - 1) < (unsigned)Qd && (unsigned)(j - 1) < (unsigned)T_pad) {
      const int r = i - 1, c = j - 1;
      if (r < r0 || c < c0) {  // left the tile: load the next one
        r0 = max(0, (r & ~15) + 16 - TW_ROWS);
        c0 = max(0, c - TW_COLS + 1);
        constexpr int PER_LANE = TW_COLS * TW_CHUNKS / 32;
        uint4 v[PER_LANE];  // every load in flight before the first store
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          const int q = lane + 32 * k;
          const int col = c0 + q / TW_CHUNKS;
          const int row = r0 + 16 * (q % TW_CHUNKS);
          v[k] = col < T_pad && row < Qs
                     ? *reinterpret_cast<const uint4*>(pd + (size_t)col * Qs + row)
                     : make_uint4(0, 0, 0, 0);
        }
        __syncwarp();  // every lane is done with the tile before
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) tile4[lane + 32 * k] = v[k];
        __syncwarp();
      }
      // the run inside the tile: every cell has i, j >= 1, so a step is
      // the byte's code (H), or its open bit (E, F)
      int lr = r - r0, lc = c - c0;
      do {
        const int d = tile[lc * TW_ROWS + lr];
        const int code = d & 3;
        const bool diag = st == 0 && code == 0;
        const bool up = diag || st == 2;
        const bool left = diag || st == 1;
        done = CLAMP && st == 0 && code == 3;
        push(st == 0 ? (diag ? TB_OP_MATCH : TB_OP_NONE)
                     : (st == 1 ? TB_OP_INS : TB_OP_DEL));
        st = st == 0 ? (code == 1 || code == 2 ? code : 0)
                     : (d & (st == 1 ? TB_E_OPEN : TB_F_OPEN)) ? 0 : st;
        lr -= up;
        lc -= left;
        i -= up;
        j -= left;
        ++s;
        done = done || (i == 0 && j == 0);
      } while (!done && s < lmax && lr >= 0 && lc >= 0);
      continue;
    }
    // row or column 0 (or a cell past the matrix): the reference's rules
    int d = 0;
    if ((st != 0 || (i != 0 && j != 0)) && cells > 0) {
      // a gap state on row or column 0: the reference's clipped index
      long long idx = (long long)(i - 1) * T_pad + (j - 1);
      idx = idx < 0 ? 0 : (idx > cells - 1 ? cells - 1 : idx);
      const int rr = (int)(idx / T_pad), cc = (int)(idx - (long long)rr * T_pad);
      d = pd[(size_t)cc * Qs + rr];
    }
    const int code = d & 3;
    const bool in_h = st == 0, in_e = st == 1, in_f = st == 2;
    const bool i0 = i == 0, j0 = j == 0;
    const bool h_ins = FIRST_ROW && in_h && i0;
    const bool h_stop_i0 = !FIRST_ROW && in_h && i0;
    const bool h_del = FIRST_COL && in_h && !i0 && j0;
    const bool h_stop_j0 = !FIRST_COL && in_h && !i0 && j0;
    const bool h_inner = in_h && !i0 && !j0;
    const bool h_stop_clamp = CLAMP && h_inner && code == 3;
    const bool h_diag = h_inner && code == 0;
    const bool h_to_e = h_inner && code == 1;
    const bool h_to_f = h_inner && code == 2 && !h_stop_clamp;
    const bool e_open = i > 0 ? (d & TB_E_OPEN) != 0 : true;
    const bool f_open = j > 0 ? (d & TB_F_OPEN) != 0 : true;
    unsigned emit = TB_OP_NONE;
    if (h_ins || in_e) emit = TB_OP_INS;
    if (h_del || in_f) emit = TB_OP_DEL;
    if (h_diag) emit = TB_OP_MATCH;
    const int i2 = i - ((h_del || h_diag || in_f) ? 1 : 0);
    const int j2 = j - ((h_ins || h_diag || in_e) ? 1 : 0);
    done = h_stop_i0 || h_stop_j0 || h_stop_clamp || (i2 == 0 && j2 == 0);
    st = h_to_e ? 1
                : h_to_f ? 2
                         : in_e ? (e_open ? 0 : 1)
                                : in_f ? (f_open ? 0 : 2) : st;
    i = i2;
    j = j2;
    push(emit);
    ++s;
  }
  // the last partial 16 ops, completed with 255, then 255 to the end
  int k = s & 15;
  if (k) {
    for (; k < 16; ++k) {
      o0 = __funnelshift_r(o0, o1, 8);
      o1 = __funnelshift_r(o1, o2, 8);
      o2 = __funnelshift_r(o2, o3, 8);
      o3 = __funnelshift_r(o3, 255u, 8);
    }
    *reinterpret_cast<uint4*>(out + (s & ~15)) =
        make_uint4(tw_widen(o0), tw_widen(o1), tw_widen(o2), tw_widen(o3));
    s = (s & ~15) + 16;
  }
  const uint4 fill = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int o = s + 16 * lane; o < lmax_s; o += 16 * 32)
    *reinterpret_cast<uint4*>(out + o) = fill;
  if (lane == 0) {
    i_out[b] = i;
    j_out[b] = j;
  }
}

}  // namespace pyopal

using namespace pyopal;

// dirs (B, T_pad, Qs) uint8 (Qs a multiple of 16, at least Qd), qes/tes
// (B,) int32, buf (B, lmax_s) uint8 (lmax_s a multiple of 16, at least
// lmax; every byte written), i_out/j_out (B,) int32.
extern "C" int pyopal_traceback_walk_launch(
    const uint8_t* dirs, const int* qes, const int* tes, uint8_t* buf,
    int* i_out, int* j_out, int B, int Qd, int Qs, int T_pad, int lmax,
    int lmax_s, int algorithm, void* stream) {
  if (B <= 0) return 0;
  if (Qs % 16 || Qs < Qd || lmax_s % 16 || lmax_s < lmax)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TW_WARPS - 1) / TW_WARPS);
  const dim3 block(TW_WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (algorithm) {
    case SW: traceback_walk_kernel<SW><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, Qs, T_pad, lmax, lmax_s); break;
    case NW: traceback_walk_kernel<NW><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, Qs, T_pad, lmax, lmax_s); break;
    case HW: traceback_walk_kernel<HW><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, Qs, T_pad, lmax, lmax_s); break;
    case OV: traceback_walk_kernel<OV><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, Qs, T_pad, lmax, lmax_s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
