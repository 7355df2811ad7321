// K1: every query of a cohort x every target lane of the flat database.
//
// Replaces: pyopal_tpu/ops/pallas_ragged.py::_ragged_kernel_v2 (l.400),
// launched by search_flat (l.1049) when safe_pad holds.  Same outputs,
// bit for bit: (n_q, n_blocks, lanes) int32 scores, query ends and target
// ends for sw/nw/hw/ov, with -1 end planes in score-only mode.
//
// What bounds it on an H100: operations.  The sw score recurrence needs
// 10 int32 operations per cell (G = H - go once, E and F a subtraction
// and a max each, the diagonal an add and a max, the clamp at 0, H, the
// running best); this simple kernel issues 11, as it subtracts go for E
// and for F apart.  It reads the database once per query (1 byte per cell
// column); at the main path's 256-row tier that is thousands of integer
// operations per byte moved.  With a single query (Aligner.align) the launch has one
// thread per target (~12K threads for the 12,071-sequence database),
// under a tenth of the card's 132 x 2048 thread slots, so the kernel is
// latency-bound on each thread's serial chain, not at the issue rate.
//
// Design:
// - one thread per (query, target lane), 128 threads per CUDA block; a
//   block covers 128 lanes of one flat block, whose targets are sorted by
//   length, so a warp's lanes finish at similar columns;
// - nothing carries between CUDA blocks: a thread walks its lane's whole
//   target (all of the flat block's chunks), starting at the block's
//   first flat row (row_off, computed from the step map by the wrapper);
// - columns outer, query rows inner (dp.cuh): F in a register, the
//   previous column's H/E in a scratch [query][row][lane] of int2 that
//   the wrapper allocates with torch.empty; a launch covers a range of
//   queries and a range of lanes (lane0, lane_count), and the wrapper
//   splits a call into as many launches as keep that scratch within a
//   fixed budget (ops/ragged.py: SCRATCH_BYTES), reusing one buffer;
// - the query profile (Q_pad x 32 int32: 32 KB at the 256 tier, 512 KB at
//   4096) is read through the read-only data cache (__ldg) rather than
//   staged in shared memory, which could not hold the large tiers; a
//   warp reads one 128-byte profile row per query row;
// - each thread stops at its own target and query length.
#include "dp.cuh"

namespace pyopal {

template <int ALG, bool ENDS>
__global__ void __launch_bounds__(128) ragged_kernel(
    const int* __restrict__ profs, const int* __restrict__ qlens,
    const uint8_t* __restrict__ flat, const int* __restrict__ lengths,
    const int* __restrict__ row_off, int* __restrict__ scores,
    int* __restrict__ qends, int* __restrict__ tends,
    int2* __restrict__ scratch, int q_pad, int n_lanes, int lanes,
    int lane0, int lane_count, int go, int ge) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // lane of the launch
  const int n = lane0 + k;                              // global lane
  const int q = blockIdx.y;
  if (k >= lane_count || n >= n_lanes) return;
  const int b = n / lanes;
  const int lane = n - b * lanes;
  const int Q = min(qlens[q], q_pad);
  const size_t out = (size_t)q * n_lanes + n;
  align_pair<ALG, ENDS>(
      profs + (size_t)q * q_pad * ALPHA, ALPHA, Q,
      flat + (size_t)row_off[b] * lanes + lane, lanes, lengths[n],
      scratch + (size_t)q * q_pad * lane_count + k, (size_t)lane_count, go,
      ge, scores + out, qends + out, tends + out);
}

}  // namespace pyopal

using namespace pyopal;

extern "C" int pyopal_ragged_launch(
    const int* profs, const int* qlens, const uint8_t* flat,
    const int* lengths, const int* row_off, int* scores, int* qends,
    int* tends, int2* scratch, int n_q, int q_pad, int n_blocks, int lanes,
    int lane0, int lane_count, int go, int ge, int algorithm, int with_ends,
    void* stream) {
  const int n_lanes = n_blocks * lanes;
  if (n_q == 0 || lane_count <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((lane_count + 127) / 128, n_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PYOPAL_DISPATCH(ragged_kernel, algorithm, with_ends, grid, block, s,
                  profs, qlens, flat, lengths, row_off, scores, qends, tends,
                  scratch, q_pad, n_lanes, lanes, lane0, lane_count, go, ge);
  return (int)cudaGetLastError();
}
