// Throughput, on one SM in instructions per clock, of the instructions of
// the wavefront walk's cell (pyopal_tpu_torch/csrc/wave.cuh): mode 0
// Hopper's DPX __viaddmax_s32 (max(a + b, c)) alone, mode 1
// __vimax_s32_relu (max(a, b, 0)) alone, mode 2 the sw cell itself, six
// instructions (E, F and the diagonal one add-max each, H = max(H, F, 0),
// G = H - go, the running best), counted as six.  The packed form of the
// walk (K7, two int16 cells in each instruction): mode 3
// __viaddmax_s16x2 alone, mode 4 __viaddmin_s16x2 alone, mode 5 two rows
// of the packed cell of two cells, eleven instructions (per row three
// add-max, __vimax_s16x2_relu and the add-min G = min(H - go, 255 - go);
// one three-input packed max takes both rows' G into the running best, as
// ptxas merges the unmasked walk's pairs of rows), counted as eleven.
// chip_smoke.py builds it beside the kernels and counts the walk's six
// instructions a cell at the highest of modes 0-2 and the int32 rate for
// the bound of K1-K6, and 5.5 packed instructions for two cells at the
// highest of modes 3-5 and the int32 rate for K7: if a cell's mix ran
// faster than its instructions alone, modes 2 and 5 show it.  Not part of
// the package.
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

__device__ __forceinline__ unsigned splat(int v) {
  return ((unsigned)v & 0xffffu) * 0x10001u;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) dpx_rate_kernel(
    const int* __restrict__ in, int* __restrict__ out,
    long long* __restrict__ clocks, int iters) {
  constexpr bool kCell = MODE == 2 || MODE == 5;
  constexpr int C = kCell ? CELL_CHAINS : CHAINS;
  // modes 3-5: every value in both halves
  const auto v = [](int x) { return MODE >= 3 ? (int)splat(x) : x; };
  const int b = v(in[0]), c = v(in[1]);
  const int ngo = v(-in[1]), cap = v(255 - in[1]);  // mode 5: -go, 255 - go
  int a[C], e[C], f[C], gl[C], gd[C], p[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    a[k] = v(in[2] + 7 * k + (int)threadIdx.x);
    e[k] = f[k] = v(in[3]);
    gl[k] = gd[k] = a[k];
    p[k] = v(in[4 + k]);
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
      } else if (MODE == 3) {
        a[k] = (int)__viaddmax_s16x2(a[k], b, c);
      } else if (MODE == 4) {
        a[k] = (int)__viaddmin_s16x2(a[k], b, c);
      } else if (MODE == 5) {  // b = -ge, both halves; two rows
        int g[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ek = (int)__viaddmax_s16x2(e[k], b, gl[k]);
          f[k] = (int)__viaddmax_s16x2(f[k], b, gl[(k + 1) % C]);
          int h = (int)__viaddmax_s16x2(gd[k], p[k], ek);
          h = (int)__vimax_s16x2_relu(h, f[k]);
          e[k] = ek;
          gd[k] = gl[k];
          gl[k] = g[r] = (int)__viaddmin_s16x2(h, ngo, cap);
        }
        a[k] = (int)__vimax3_s16x2(a[k], g[0], g[1]);
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
  for (int k = 0; k < C; ++k) s += a[k] + (kCell ? gl[k] : 0);
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

// mode 0: __viaddmax_s32, 1: __vimax_s32_relu, 2: the sw cell, 3:
// __viaddmax_s16x2, 4: __viaddmin_s16x2, 5: two rows of the packed cell.
// in: 12 ints; out: blocks * 1024 ints; clocks: blocks * 3 (SM, first
// clock, last clock).
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
    case 3:
      dpx_rate_kernel<3><<<blocks, THREADS, 0, s>>>(in, out, clocks, iters);
      break;
    case 4:
      dpx_rate_kernel<4><<<blocks, THREADS, 0, s>>>(in, out, clocks, iters);
      break;
    case 5:
      dpx_rate_kernel<5><<<blocks, THREADS, 0, s>>>(in, out, clocks, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
