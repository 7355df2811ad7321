// Throughput, on one SM in results per clock, of the instructions of the
// wavefront walk's cell (pyopal_tpu_torch/csrc/wave.cuh): mode 0 Hopper's
// DPX __viaddmax_s32 (max(a + b, c)) alone, mode 1 __vimax_s32_relu
// (max(a, b, 0)) alone, mode 2 the sw cell itself, six instructions (E, F
// and the diagonal one add-max each, H = max(H, F, 0), G = H - go, the
// running best), counted as six results.  chip_smoke.py builds it beside
// the kernels and counts the walk's six instructions a cell at the
// highest of these rates and the int32 one for the bound of K1 and K3: if
// the cell's mix ran faster than either instruction alone, mode 2
// shows it.  Not part of the package.
//
// Each block of 1024 threads runs CHAINS independent chains (the cell:
// CELL_CHAINS, to stay within 32 registers) for `iters` steps between
// two clock64() reads taken after a block barrier, and records its SM
// (%smid) and both clocks; the host sums each SM's results over the span
// of its blocks' clocks.  chip_smoke.py launches two blocks
// per SM, which the SMs hold at once where the registers allow.
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;
constexpr int CELL_CHAINS = 4;
constexpr int THREADS = 1024;

template <int MODE>
__global__ void __launch_bounds__(THREADS) dpx_rate_kernel(
    const int* __restrict__ in, int* __restrict__ out,
    long long* __restrict__ clocks, int iters) {
  constexpr int C = MODE == 2 ? CELL_CHAINS : CHAINS;
  const int b = in[0], c = in[1];
  int a[C], e[C], f[C], gl[C], gd[C], p[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    a[k] = in[2] + 7 * k + threadIdx.x;
    e[k] = f[k] = in[3];
    gl[k] = gd[k] = a[k];
    p[k] = in[4 + k];
  }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (MODE == 0) {
        a[k] = __viaddmax_s32(a[k], b, c);
      } else if (MODE == 1) {  // each chain takes its neighbour's value
        a[k] = __vimax_s32_relu(a[k], a[(k + 1) % C]);
      } else {  // b = -ge, c = go; the row above from the next chain
        const int ek = __viaddmax_s32(e[k], b, gl[k]);
        f[k] = __viaddmax_s32(f[k], b, gl[(k + 1) % C]);
        int h = __viaddmax_s32(gd[k], p[k], ek);
        h = __vimax_s32_relu(h, f[k]);
        e[k] = ek;
        gd[k] = gl[k];
        gl[k] = h - c;
        a[k] = max(a[k], h);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) s += a[k] + (MODE == 2 ? gl[k] : 0);
  out[blockIdx.x * THREADS + threadIdx.x] = s;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    clocks[3 * blockIdx.x] = sm;
    clocks[3 * blockIdx.x + 1] = t0;
    clocks[3 * blockIdx.x + 2] = t1;
  }
}

}  // namespace

// mode 0: __viaddmax_s32, 1: __vimax_s32_relu, 2: the sw cell.  in: 12
// ints; out: blocks * 1024 ints; clocks: blocks * 3 (SM, first clock,
// last clock).
extern "C" int pyopal_dpx_rate_launch(const int* in, int* out,
                                      long long* clocks, int mode,
                                      int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      dpx_rate_kernel<0><<<blocks, THREADS, 0, s>>>(in, out, clocks, iters);
      break;
    case 1:
      dpx_rate_kernel<1><<<blocks, THREADS, 0, s>>>(in, out, clocks, iters);
      break;
    case 2:
      dpx_rate_kernel<2><<<blocks, THREADS, 0, s>>>(in, out, clocks, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
