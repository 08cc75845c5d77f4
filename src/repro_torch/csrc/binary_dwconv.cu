// Fused binary depth-wise convolution for Hopper (sm_90a), fp32 FFMA, NHWC.
//
//   eff[t, c]        = sum_{m < m_active} alpha[m, c] * B_m[t, c]     (paper Eq. 1)
//   out[b, u, v, c]  = relu?(sum_{i, j} x[b, u*s + i, v*s + j, c] * eff[i*kw + j, c]
//                            + bias[c])
//
// x is the pre-padded input [B, Hp, Wp, C] (SAME is resolved by the caller).
// Weights are channel-packed B_tap_packed [M, kh*kw, ceil(C/8)]: bit j of
// byte (m, t, c8) is +1 iff channel 8*c8 + j of tap t is +1.
//
// Replaces: src/repro/kernels/binary_dwconv.py, _dw_kernel, launched by
// binary_dwconv2d_pallas (level fold into effective taps, channel-wise
// strided tap accumulation on the VPU, bias + ReLU epilogue).
//
// What bounds it on the H100: bytes.  A depth-wise layer does 9 FMAs per
// output element and reads one input channel per output channel, so moving
// the activations (MobileNetV1-224, batch 16: ~0.2 GB over dw0-dw12, 60 us at
// 3.35 TB/s) costs far more than its ~0.1 GFLOP.
//
// Design: one thread per (pixel, channel), channels on the fast thread axis,
// so a warp reads 32 consecutive floats (128 bytes) of one pixel per tap; the
// nine taps of neighbouring pixels hit L1/L2 rather than device memory.  The
// levels are folded once per block into eff[t, c] in shared memory (m_active
// < M just shortens the fold), and each output is one fixed-order chain of
// kh*kw FMAs in (i, j) order, so every tile plan gives bit-identical results.
// Masks cover C not a multiple of 8 or of the block width and ragged pixel
// counts.  Pixel indices are 32-bit (a 64-bit division per output would
// cost more than its nine FMAs); offsets into x and out are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void binary_dwconv_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ wp,
    const float* __restrict__ alpha, const float* __restrict__ bias,
    float* __restrict__ out, int Hp, int Wp, int C, int kh, int kw,
    int stride, int U, int V, int P, int m_active, int relu,
    int rows) {
  extern __shared__ float eff[];  // [kh*kw][blockDim.x]
  const int cb = blockDim.x;
  const int c0 = blockIdx.y * cb;
  const int c = c0 + threadIdx.x;
  const int T = kh * kw;
  const int C8 = (C + 7) / 8;
  const int tid = threadIdx.y * cb + threadIdx.x;
  const int nthr = cb * blockDim.y;

  for (int e = tid; e < T * cb; e += nthr) {
    const int t = e / cb, cc = c0 + e % cb;
    float v = 0.f;
    if (cc < C) {
      for (int m = 0; m < m_active; ++m) {
        const unsigned byte = wp[((int64_t)m * T + t) * C8 + cc / 8];
        v = fmaf(alpha[(int64_t)m * C + cc], ((byte >> (cc % 8)) & 1u) ? 1.f : -1.f, v);
      }
    }
    eff[e] = v;
  }
  __syncthreads();
  if (c >= C) return;

  const float bc = bias[c];
  const int p_begin = blockIdx.x * rows;
  const int p_end = min(P, p_begin + rows);
  for (int p = p_begin + threadIdx.y; p < p_end; p += blockDim.y) {
    const int b = p / (U * V), r = p - b * (U * V), u = r / V, v = r - u * V;
    const int64_t base =
        (((int64_t)b * Hp + u * stride) * Wp + v * stride) * C + c;
    float acc = 0.f;
    for (int i = 0; i < kh; ++i)
      for (int j = 0; j < kw; ++j)
        acc = fmaf(x[base + ((int64_t)i * Wp + j) * C],
                   eff[(i * kw + j) * cb + threadIdx.x], acc);
    const float y = __fadd_rn(acc, bc);
    out[(int64_t)p * C + c] = relu ? fmaxf(y, 0.f) : y;
  }
}

}  // namespace

// x [B, Hp, Wp, C] f32 (pre-padded), wp [M, kh*kw, ceil(C/8)] u8,
// alpha [M, C] f32, bias [C] f32, out [B, U, V, C] f32, all contiguous on the
// current device.  Tile plan: cols channels x rows pixels per block, with
// 256 / cols thread rows (cols a power of two, 32..256).  Returns
// cudaGetLastError() after the launch.
extern "C" int binary_dwconv_launch(const void* x, const void* wp,
                                    const void* alpha, const void* bias,
                                    void* out, int B, int Hp, int Wp, int C,
                                    int kh, int kw, int stride, int U, int V,
                                    int m_active, int relu, int rows, int cols,
                                    void* stream) {
  const int P = B * U * V;  // < 2^31 (checked by the caller)
  const dim3 block(cols, 256 / cols);
  const dim3 grid((P + rows - 1) / rows, (C + cols - 1) / cols);
  const size_t shmem = sizeof(float) * kh * kw * cols;
  binary_dwconv_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)wp, (const float*)alpha,
      (const float*)bias, (float*)out, Hp, Wp, C, kh, kw, stride, U, V, P,
      m_active, relu, rows);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
