// Fused implicit-GEMM binary convolution for Hopper (sm_90a), fp32 FFMA, NHWC.
//
//   conv[b, u, v, d] = sum_{m < m_active} sum_g alpha[m, g, d]
//                        * sum_{k in group g} x[b, u*s + i, v*s + j, c] * B_m[k, d],
//   k = (i*kw + j)*C + c,
//   out[b, uo, vo, d] = relu?(max_{pool x pool window} (conv + bias[d]))
//
// x is the pre-padded input [B, Hp, Wp, C] (SAME is resolved by the caller).
// Weights are the per-tap layout B_tap_packed [M, kh*kw, ceil(C/8), D]: bit j
// of byte (m, t, c8, d) is +1 iff channel 8*c8 + j of tap t is +1; each tap's
// channel slice is padded to a byte, and channels >= C are never read.
//
// Replaces: src/repro/kernels/binary_conv.py, _kernel, launched by
// binary_conv2d_pallas (VMEM patch extraction, level-concatenated MXU dot,
// bias + max-pool + ReLU epilogue before the only write).
//
// What bounds it on the H100: fp32 operations.  MobileNetV1-224 at batch 16
// runs 2 * 9.1 G fp-equivalent MACs through this kernel per forward (0.27 ms
// at 67 TFLOP/s), against ~0.3 GB of activations (0.09 ms at 3.35 TB/s).
// Without tensor cores (the reference tolerance, rtol 1e-5, rules out TF32)
// the FFMA pipe is the ceiling, and this kernel does m_active FMAs per
// fp-equivalent MAC because it keeps the per-level sums of paper Eq. 8.
//
// Design: the im2col tensor never exists in device memory.  One block per
// (pooled pixels x output channels) tile, each thread a 4 x 4 register tile.
// For every (pool offset, level) the block walks the reduction axis
// k = (tap, channel) in chunks of 32: it stages the patch values of its
// pixels and the chunk's bits, unpacked once into shared +-1 floats, then
// runs 16 FFMAs per staged k per thread.  Chunking k rather than taps keeps
// the barriers few when C is small (C = 3 or 5 fills a chunk with 6-10
// taps).  Each output's sum runs in one fixed order (level, then tap, then
// channel; per group an fp32 partial sum scaled by its alpha at the group's
// end), with no split-K and no atomics, so every tile plan gives
// bit-identical results.  The epilogue adds the bias, takes the max over the
// pool window, applies ReLU and writes once.  Masks cover ragged batches and
// rows (pixels past the end), D below the tile, C not a multiple of 8 and
// m_active < M.  Offsets into x and out are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;  // reduction rows k = (tap, channel) staged per step
constexpr int RP = 4;   // pooled pixels per thread
constexpr int RD = 4;   // output channels per thread

__global__ void binary_conv_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ wp,
    const float* __restrict__ alpha, const float* __restrict__ bias,
    float* __restrict__ out, int Hp, int Wp, int C, int D, int kh, int kw,
    int stride, int pool, int Uo, int Vo, int64_t P, int G, int gs,
    int m_active, int relu) {
  extern __shared__ int64_t smem64[];
  const int BD = blockDim.x * RD;
  const int BP = blockDim.y * RP;
  int64_t* pix = smem64;                           // [BP] pixel base offsets
  int64_t* koff = pix + BP;                        // [KC] x offset of each k
  float* xs = reinterpret_cast<float*>(koff + KC);  // [BP][KC + 1]
  float* ws = xs + BP * (KC + 1);                  // [KC][BD]
  int* krow = reinterpret_cast<int*>(ws + KC * BD);  // [KC] packed byte row
  int* kbit = krow + KC;                           // [KC] bit in that byte
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int64_t q0 = (int64_t)blockIdx.x * BP;
  const int d0 = blockIdx.y * BD;
  const int T = kh * kw;
  const int C8 = (C + 7) / 8;
  const int K = T * C;

  for (int p = tid; p < BP; p += nthr) {
    const int64_t q = q0 + p;
    int64_t base = -1;
    if (q < P) {
      const int64_t b = q / ((int64_t)Uo * Vo);
      const int64_t r = q - b * Uo * Vo;
      const int64_t uo = r / Vo, vo = r - (r / Vo) * Vo;
      base = ((b * Hp + uo * pool * stride) * Wp + vo * pool * stride) * C;
    }
    pix[p] = base;
  }

  float bs[RD];
#pragma unroll
  for (int j = 0; j < RD; ++j) {
    const int d = d0 + threadIdx.x * RD + j;
    bs[j] = d < D ? bias[d] : 0.f;
  }
  float best[RP][RD], acc[RP][RD], s[RP][RD];

  for (int pw = 0; pw < pool * pool; ++pw) {
    const int pi = pw / pool, pj = pw % pool;
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
    for (int m = 0; m < m_active; ++m) {
      int g = 0, rem = gs;
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) s[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        const int cnt = min(KC, K - k0);
        if (tid < KC) {  // where each k of the chunk lives in x and in wp
          const int k = k0 + tid;
          int64_t off = -1;
          int row = 0, bit = 0;
          if (k < K) {
            const int t = k / C, c = k - t * C, ti = t / kw, tj = t - ti * kw;
            off = ((int64_t)(pi * stride + ti) * Wp + (pj * stride + tj)) * C + c;
            row = t * C8 + (c >> 3);
            bit = c & 7;
          }
          koff[tid] = off;
          krow[tid] = row;
          kbit[tid] = bit;
        }
        __syncthreads();
        for (int e = tid; e < BP * KC; e += nthr) {
          const int p = e / KC, kk = e % KC;
          const int64_t base = pix[p], off = koff[kk];
          xs[p * (KC + 1) + kk] = (base >= 0 && off >= 0) ? x[base + off] : 0.f;
        }
        const uint8_t* wm = wp + (int64_t)m * T * C8 * D;
        if ((C & 7) == 0) {  // 8 consecutive k share one byte: unpack bytes
          for (int e = tid; e < (KC / 8) * BD; e += nthr) {
            const int kb = e / BD, dd = e % BD, d = d0 + dd;
            const unsigned byte = (d < D && kb * 8 < cnt)
                                      ? wm[(int64_t)krow[kb * 8] * D + d] : 0u;
#pragma unroll
            for (int b = 0; b < 8; ++b)
              ws[(kb * 8 + b) * BD + dd] = ((byte >> b) & 1u) ? 1.f : -1.f;
          }
        } else {  // a tap's channels end mid-byte: one bit per k
          for (int e = tid; e < KC * BD; e += nthr) {
            const int kk = e / BD, dd = e % BD, d = d0 + dd;
            const unsigned byte = (d < D && kk < cnt)
                                      ? wm[(int64_t)krow[kk] * D + d] : 0u;
            ws[kk * BD + dd] = ((byte >> kbit[kk]) & 1u) ? 1.f : -1.f;
          }
        }
        __syncthreads();
        int c = 0;
        while (c < cnt) {
          const int seg = min(cnt - c, rem);
          for (int q = 0; q < seg; ++q, ++c) {
            float a[RP];
#pragma unroll
            for (int i = 0; i < RP; ++i)
              a[i] = xs[(threadIdx.y * RP + i) * (KC + 1) + c];
            const float4 w4 =
                *reinterpret_cast<const float4*>(&ws[c * BD + threadIdx.x * RD]);
            const float w[RD] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < RP; ++i)
#pragma unroll
              for (int j = 0; j < RD; ++j) s[i][j] = fmaf(a[i], w[j], s[i][j]);
          }
          rem -= seg;
          if (rem == 0) {  // end of group g: scale its partial sum by alpha
#pragma unroll
            for (int j = 0; j < RD; ++j) {
              const int d = d0 + threadIdx.x * RD + j;
              const float al = d < D ? alpha[((int64_t)m * G + g) * D + d] : 0.f;
#pragma unroll
              for (int i = 0; i < RP; ++i) {
                acc[i][j] = fmaf(al, s[i][j], acc[i][j]);
                s[i][j] = 0.f;
              }
            }
            ++g;
            rem = gs;
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const float v = __fadd_rn(acc[i][j], bs[j]);
        best[i][j] = pw == 0 ? v : fmaxf(best[i][j], v);
      }
  }

#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int64_t q = q0 + threadIdx.y * RP + i;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = d0 + threadIdx.x * RD + j;
      if (q < P && d < D)
        out[q * D + d] = relu ? fmaxf(best[i][j], 0.f) : best[i][j];
    }
  }
}

}  // namespace

// x [B, Hp, Wp, C] f32 (pre-padded), wp [M, kh*kw, ceil(C/8), D] u8,
// alpha [M, G, D] f32, bias [D] f32, out [B, Uo, Vo, D] f32, all contiguous
// on the current device; Uo = U / pool, Vo = V / pool.  Tile plan: rows
// pooled pixels x cols channels per block, both multiples of 4, with
// 32..1024 threads.  Returns cudaGetLastError() after the launch.
extern "C" int binary_conv_launch(const void* x, const void* wp,
                                  const void* alpha, const void* bias,
                                  void* out, int B, int Hp, int Wp, int C,
                                  int D, int kh, int kw, int stride, int pool,
                                  int Uo, int Vo, int G, int group_size,
                                  int m_active, int relu, int rows, int cols,
                                  void* stream) {
  const int64_t P = (int64_t)B * Uo * Vo;
  const dim3 block(cols / RD, rows / RP);
  const dim3 grid((unsigned)((P + rows - 1) / rows), (D + cols - 1) / cols);
  const size_t shmem = sizeof(int64_t) * (rows + KC) +
                       sizeof(float) * (rows * (KC + 1) + KC * cols) +
                       sizeof(int) * 2 * KC;
  binary_conv_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)wp, (const float*)alpha,
      (const float*)bias, (float*)out, Hp, Wp, C, D, kh, kw, stride, pool, Uo,
      Vo, P, G, group_size, m_active, relu);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
