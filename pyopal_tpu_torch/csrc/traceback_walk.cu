// T2: the traceback walk of full mode over resident direction bytes.
//
// Replaces: pyopal_tpu/ops/traceback.py::_walk_batch_device (l.197), a
// lax.while_loop over lock-stepped pairs (XLA in the reference, not
// Pallas).  Same outputs: buf[s][b] is pair b's op at step s, end to
// start (255 = none), and (i, j) its 1-based start cell.  Each pair runs
// the state machine H/E/F from its end cell (qe + 1, te + 1): the clipped
// index at i == 0 or j == 0, the open bits defaulting to true off the
// matrix, the boundary rules per algorithm (nw walks the first row and
// column as gaps, hw the first column, ov and sw stop there; sw stops at
// DIR_STOP), and the stop at LMAX steps.  A pair that the reference's
// loop keeps stepping after it is done emits 255 and keeps its cell, so
// each thread stops at its own end and the wrapper pre-fills buf with 255.
//
// What bounds it on an H100: one dependent byte load a step, from a
// direction matrix that is too large to stay in L2 (a 64 M-cell batch), so
// the walk is latency-bound; in bytes, one 32-byte sector a step.
//
// Design: one thread per pair, a branch-free step (the reference's
// masks as booleans), 128 threads a block.  The loads of neighbouring
// pairs are unrelated, so nothing is gained from sharing them.
#include "dp.cuh"

namespace pyopal {

constexpr int TB_WALK_THREADS = 128;
constexpr int TB_OP_MATCH = 0, TB_OP_DEL = 1, TB_OP_INS = 2;
constexpr int TB_E_OPEN = 4, TB_F_OPEN = 8;

template <int ALG>
__global__ void __launch_bounds__(TB_WALK_THREADS) traceback_walk_kernel(
    const uint8_t* __restrict__ dirs, const int* __restrict__ qes,
    const int* __restrict__ tes, uint8_t* __restrict__ buf,
    int* __restrict__ i_out, int* __restrict__ j_out, int B, int Qd,
    int T_pad, int lmax) {
  constexpr bool FIRST_ROW = ALG == NW;
  constexpr bool FIRST_COL = ALG == NW || ALG == HW;
  constexpr bool CLAMP = ALG == SW;
  const int b = blockIdx.x * TB_WALK_THREADS + threadIdx.x;
  if (b >= B) return;
  const long long cells = (long long)Qd * T_pad;
  const uint8_t* flat = dirs + (size_t)b * cells;
  int i = qes[b] + 1, j = tes[b] + 1;
  int st = 0;  // 0 = H, 1 = E, 2 = F
  bool done = i == 0 && j == 0;
  for (int s = 0; s < lmax && !done; ++s) {
    long long idx = (long long)(i - 1) * T_pad + (j - 1);
    idx = idx < 0 ? 0 : (idx > cells - 1 ? cells - 1 : idx);
    const int d = cells > 0 ? flat[idx] : 0;
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
    int emit = 255;
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
    buf[(size_t)s * B + b] = (uint8_t)emit;
    i = i2;
    j = j2;
  }
  i_out[b] = i;
  j_out[b] = j;
}

}  // namespace pyopal

using namespace pyopal;

// dirs (B, Qd, T_pad) uint8, qes/tes (B,) int32, buf (lmax, B) uint8
// pre-filled with 255, i_out/j_out (B,) int32.
extern "C" int pyopal_traceback_walk_launch(
    const uint8_t* dirs, const int* qes, const int* tes, uint8_t* buf,
    int* i_out, int* j_out, int B, int Qd, int T_pad, int lmax,
    int algorithm, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + TB_WALK_THREADS - 1) / TB_WALK_THREADS);
  const dim3 block(TB_WALK_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (algorithm) {
    case SW: traceback_walk_kernel<SW><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, T_pad, lmax); break;
    case NW: traceback_walk_kernel<NW><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, T_pad, lmax); break;
    case HW: traceback_walk_kernel<HW><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, T_pad, lmax); break;
    case OV: traceback_walk_kernel<OV><<<grid, block, 0, s>>>(dirs, qes, tes, buf, i_out, j_out, B, Qd, T_pad, lmax); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
