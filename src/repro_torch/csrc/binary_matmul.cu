// Multi-level binary matmul for Hopper (sm_90a), fp32 FFMA.
//
//   y[t, n] = sum_{m < m_active} sum_g alpha[m, g, n] * sum_{k in group g} x[t, k] * B_m[k, n]
//
// B_m is read bit-packed, LSB-first: bit j of B_packed[m, k8, n] is +1 iff
// B_m[8*k8 + j, n] == +1 (the layout of core/binarize.py pack_bits).
// Groups are consecutive runs of group_size reduction rows; group_size need
// not be a multiple of 8.
//
// Replaces: src/repro/kernels/binary_matmul.py, _kernel, launched by
// binary_matmul_pallas (one MXU dot per level over unpacked +-1 tiles).
//
// What bounds it on the H100: at the deployment shapes (T = 16..64 rows,
// K <= 1350, N <= 1000) one call does 2*T*K*N <= 60 MFLOP (< 1 us at the
// 67 TFLOP/s fp32 peak) and moves < 1 MB (< 0.3 us at 3.35 TB/s), so launch
// latency and the serial reduction over K, not bytes or FLOPs, set its time.
//
// Design: one thread per output element, threads along N first, so a warp
// reads 32 neighbouring packed bytes (one coalesced load) per 8 reduction
// rows, and the 8 x values of those rows as broadcasts from L1, all 8 in
// flight at once unless a group ends inside the byte.  Nothing is staged
// in shared memory and there is no barrier: at these small T the card is
// filled by T*N independent threads, not by reuse.  Each output's sum runs in one
// fixed order (level, then k; per group an fp32 partial sum scaled by its
// alpha at the group's end), with no split-K and no atomics, so every tile
// plan gives bit-identical results.  Masks cover ragged T, N below the tile,
// K not a multiple of 8 and m_active < M without padding any buffer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void binary_matmul_kernel(const float* __restrict__ x,
                                     const uint8_t* __restrict__ bp,
                                     const float* __restrict__ alpha,
                                     float* __restrict__ out, int T, int K,
                                     int N, int G, int gs, int m_active) {
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= T || n >= N) return;
  const int K8 = (K + 7) / 8;
  const float* xr = x + t * K;
  float acc = 0.f;
  for (int m = 0; m < m_active; ++m) {
    const uint8_t* col = bp + (int64_t)m * K8 * N + n;
    const float* al = alpha + (int64_t)m * G * N + n;
    float s = 0.f;
    int g = 0, rem = gs;
    for (int k8 = 0; k8 < K8; ++k8) {
      const unsigned byte = __ldg(col + (int64_t)k8 * N);
      const float* xk = xr + 8 * k8;
      const int kn = min(8, K - 8 * k8);
      if (kn == 8 && rem > 8) {  // a whole byte inside one group: 8 loads in flight
        float xv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] = __ldg(xk + j);
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(xv[j], ((byte >> j) & 1u) ? 1.f : -1.f, s);
        rem -= 8;
        continue;
      }
      for (int j = 0; j < kn; ++j) {
        s = fmaf(__ldg(xk + j), ((byte >> j) & 1u) ? 1.f : -1.f, s);
        if (--rem == 0) {  // end of group g: scale its partial sum by alpha
          acc = fmaf(__ldg(al + (int64_t)g * N), s, acc);
          s = 0.f;
          ++g;
          rem = gs;
        }
      }
    }
  }
  out[t * N + n] = acc;
}

}  // namespace

// x [T, K] f32, bp [M, ceil(K/8), N] u8, alpha [M, G, N] f32, out [T, N] f32,
// all contiguous on the current device.  Tile plan: rows x cols outputs per
// block, one thread each (rows * cols <= 1024).  Returns cudaGetLastError()
// after the launch.
extern "C" int binary_matmul_launch(const void* x, const void* bp,
                                    const void* alpha, void* out, int T, int K,
                                    int N, int G, int group_size, int m_active,
                                    int rows, int cols, void* stream) {
  const dim3 block(cols, rows);
  const dim3 grid((T + rows - 1) / rows, (N + cols - 1) / cols);
  binary_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)bp, (const float*)alpha, (float*)out, T,
      K, N, G, group_size, m_active);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
