// Fused binary depth-wise convolution for Hopper (sm_90a), fp32 FFMA, NHWC.
//
//   eff[t, c]        = sum_{m < m_active} alpha[m, c] * B_m[t, c]     (paper Eq. 1)
//   out[b, u, v, c]  = relu?(sum_{i, j} x[b, u*s - pt + i, v*s - pl + j, c] * eff[i*3 + j, c]
//                            + bias[c])
//
// x is the unpadded input [B, H, W, C]; taps that fall outside it (the
// SAME border, offsets pt/pl on the low side, bounds H/W on the high side)
// read a zero, as from a padded copy.  Weights are channel-packed B_tap_packed
// [M, 9, ceil(C/8)]: bit j of byte (m, t, c8) is +1 iff channel 8*c8 + j of
// tap t is +1.  Filters are 3x3, stride 1 or 2 (every depth-wise layer of
// the repo's networks).
//
// Replaces: src/repro/kernels/binary_dwconv.py, _dw_kernel, launched by
// binary_dwconv2d_pallas (level fold into effective taps, channel-wise
// strided tap accumulation on the VPU, bias + ReLU epilogue).  The TPU
// kernel reads a pre-padded input through its BlockSpecs; here the border
// is a predicate on each tap, so no padded copy of x is ever made.
//
// What bounds it on the H100: bytes.  A depth-wise layer does 9 FMAs per
// output element and reads one input channel per output channel, so moving
// the activations (MobileNetV1-224, batch 16: ~0.3 GB over dw0-dw12, ~0.1 ms
// at 3.35 TB/s) costs far more than its ~0.1 GFLOP.
//
// Design: a thread owns a group of VEC channels (4 with 16-byte loads and
// stores where C % 4 == 0 and the pointers allow it, else 1) and a tile of
// UT x VT outputs (rows x columns).  It folds its 9 x VEC effective taps
// into registers once, then streams the (UT-1)*S + 3 input rows and, in
// each, the (VT-1)*S + 3 input columns through registers, each loaded
// vector feeding every output of the tile that covers it: a 2x4 tile at
// stride 1 loads 24 vectors for 8 outputs where one output alone loads 9.
// Channel groups run on the fast thread axis (a warp reads whole 16-byte
// runs of neighbouring channels), column strips and row tiles on the slower
// ones; the grid is (image x row block, strip block, channel slice), so
// every index comes from blockIdx and threadIdx, with no division per
// pixel.  Each output is one chain of fmaf in (i, j) order over all 9
// taps, border zeros included, then __fadd_rn(bias), then ReLU, so every
// plan, and the pre-padded kernel this one replaced, give bit-identical
// outputs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KH = 3, KW = 3, TAPS = KH * KW;
constexpr int THREADS = 256;

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r.v[e] = __ldg(p + e);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = r.v[e];
  }
}

// blockDim = (channel groups, strips, row tiles); grid = (B * row_blocks,
// strip blocks, channel slices).
template <int VEC, int S, int UT, int VT>
__global__ void __launch_bounds__(THREADS) binary_dwconv_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ wp,
    const float* __restrict__ alpha, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int C, int U, int V, int pt,
    int pl, int row_blocks, int m_active, int relu) {
  constexpr int NROW = (UT - 1) * S + KH, NCOL = (VT - 1) * S + KW;
  const int c = (blockIdx.z * blockDim.x + threadIdx.x) * VEC;
  const int b = blockIdx.x / row_blocks;
  const int u0 = ((blockIdx.x - b * row_blocks) * blockDim.z + threadIdx.z) * UT;
  const int v0 = (blockIdx.y * blockDim.y + threadIdx.y) * VT;
  if (c >= C || u0 >= U || v0 >= V) return;

  // fold the levels once: eff[t] = sum_m alpha[m, c] * (+-1), m in order
  const int C8 = (C + 7) / 8;
  Vec<VEC> eff[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) eff[t].v[e] = 0.f;
  for (int m = 0; m < m_active; ++m) {
    const Vec<VEC> a = load<VEC>(alpha + (int64_t)m * C + c);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const unsigned byte = __ldg(wp + ((int64_t)m * TAPS + t) * C8 + c / 8) >> (c % 8);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        eff[t].v[e] = fmaf(a.v[e], ((byte >> e) & 1u) ? 1.f : -1.f, eff[t].v[e]);
    }
  }

  Vec<VEC> acc[UT][VT];
#pragma unroll
  for (int q = 0; q < UT; ++q)
#pragma unroll
    for (int o = 0; o < VT; ++o)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][o].v[e] = 0.f;
  // Taps outside the image read a zero: every load is issued from a clamped
  // address inside x and its value then selected, so no branch keeps the
  // loads of one input row waiting on the FMAs of the row before.
  const int h0 = u0 * S - pt, w0 = v0 * S - pl;
#pragma unroll
  for (int ir = 0; ir < NROW; ++ir) {
    const int hi = h0 + ir;
    const bool row_in = hi >= 0 && hi < H;
    const float* row = x + ((int64_t)b * H + min(max(hi, 0), H - 1)) * W * C + c;
#pragma unroll
    for (int col = 0; col < NCOL; ++col) {
      const int wi = w0 + col;
      Vec<VEC> xv = load<VEC>(row + (int64_t)min(max(wi, 0), W - 1) * C);
      if (!(row_in && wi >= 0 && wi < W))
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv.v[e] = 0.f;
#pragma unroll
      for (int q = 0; q < UT; ++q) {
        const int i = ir - q * S;
        if (i < 0 || i >= KH) continue;
#pragma unroll
        for (int o = 0; o < VT; ++o) {
          const int j = col - o * S;
          if (j < 0 || j >= KW) continue;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[q][o].v[e] = fmaf(xv.v[e], eff[i * KW + j].v[e], acc[q][o].v[e]);
        }
      }
    }
  }

  const Vec<VEC> bc = load<VEC>(bias + c);
#pragma unroll
  for (int q = 0; q < UT; ++q) {
    if (u0 + q >= U) break;
    float* dst = out + (((int64_t)b * U + u0 + q) * V + v0) * C + c;
#pragma unroll
    for (int o = 0; o < VT; ++o) {
      if (v0 + o >= V) break;
      Vec<VEC> y;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float s = __fadd_rn(acc[q][o].v[e], bc.v[e]);
        y.v[e] = relu ? fmaxf(s, 0.f) : s;
      }
      store<VEC>(dst + (int64_t)o * C, y);
    }
  }
}

// The output tile of each plan: 1, 2, 4 or 8 outputs per thread as 1x1,
// 1x2, 2x2 or 2x4 (rows x columns).
constexpr int tile_rows(int outputs) { return outputs >= 4 ? 2 : 1; }

template <int VEC, int S>
cudaError_t launch_tile(int tile, int B, int H, int W, int C, int U, int V,
                        int pt, int pl, int cols, cudaStream_t stream,
                        const float* x, const uint8_t* wp, const float* alpha,
                        const float* bias, float* out, int m_active, int relu) {
  if (tile != 1 && tile != 2 && tile != 4 && tile != 8) return cudaErrorInvalidValue;
  const int ut = tile_rows(tile), vt = tile / ut;
  const int groups = cols / VEC;                  // channel groups per block
  const int strips = (V + vt - 1) / vt, row_tiles = (U + ut - 1) / ut;
  const int ty = strips < THREADS / groups ? strips : THREADS / groups;
  const int tz_max = THREADS / groups / ty;
  const int tz = row_tiles < tz_max ? row_tiles : tz_max;
  const int row_blocks = (row_tiles + tz - 1) / tz;
  const dim3 block(groups, ty, tz);
  const dim3 grid(B * row_blocks, (strips + ty - 1) / ty, (C + cols - 1) / cols);
#define DW_LAUNCH(UT_, VT_)                                                  \
  binary_dwconv_kernel<VEC, S, UT_, VT_><<<grid, block, 0, stream>>>(        \
      x, wp, alpha, bias, out, H, W, C, U, V, pt, pl, row_blocks, m_active, \
      relu)
  switch (tile) {
    case 1: DW_LAUNCH(1, 1); break;
    case 2: DW_LAUNCH(1, 2); break;
    case 4: DW_LAUNCH(2, 2); break;
    case 8: DW_LAUNCH(2, 4); break;
    default: return cudaErrorInvalidValue;
  }
#undef DW_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] f32 (unpadded), wp [M, 9, ceil(C/8)] u8, alpha [M, C] f32,
// bias [C] f32, out [B, U, V, C] f32, all contiguous on the current device;
// (pt, pl) the low-side SAME pads, U x V the output size.  Tile plan: tile
// outputs per thread (1, 2, 4 or 8), cols channels per block (32, 64, 128
// or 256).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a filter, stride or plan it was not built for).
extern "C" int binary_dwconv_launch(const void* x, const void* wp,
                                    const void* alpha, const void* bias,
                                    void* out, int B, int H, int W, int C,
                                    int kh, int kw, int stride, int U, int V,
                                    int pt, int pl, int m_active, int relu,
                                    int tile, int cols, void* stream) {
  if (kh != KH || kw != KW || (stride != 1 && stride != 2) || cols < 32 ||
      cols > THREADS || cols % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec4 =
      C % 4 == 0 &&
      (((uintptr_t)x | (uintptr_t)alpha | (uintptr_t)bias | (uintptr_t)out) %
       16) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint8_t* w8 = (const uint8_t*)wp;
  const float* af = (const float*)alpha;
  const float* bf = (const float*)bias;
  float* of = (float*)out;
  cudaError_t rc;
  if (vec4)
    rc = stride == 1
             ? launch_tile<4, 1>(tile, B, H, W, C, U, V, pt, pl, cols, s, xf, w8, af, bf, of, m_active, relu)
             : launch_tile<4, 2>(tile, B, H, W, C, U, V, pt, pl, cols, s, xf, w8, af, bf, of, m_active, relu);
  else
    rc = stride == 1
             ? launch_tile<1, 1>(tile, B, H, W, C, U, V, pt, pl, cols, s, xf, w8, af, bf, of, m_active, relu)
             : launch_tile<1, 2>(tile, B, H, W, C, U, V, pt, pl, cols, s, xf, w8, af, bf, of, m_active, relu);
  return (int)rc;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
