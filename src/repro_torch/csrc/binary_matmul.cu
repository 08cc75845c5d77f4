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
// 67 TFLOP/s fp32 peak) and moves < 1 MB (< 0.3 us at 3.35 TB/s), so
// latency sets its time: the serial reduction over K, and the loads that
// feed it.
//
// Design: the reduction is split into KSPLIT chunks of byte rows whose
// bounds depend on K alone (never on the tile plan).  A block is cols
// lanes along N by KSPLIT rows of threads, one chunk per row, so the
// chains are KSPLIT times shorter and KSPLIT times more warps are in flight.
// The levels are folded into one weight per k before the rows see it,
//   w[k, n] = sum_{m < m_active} alpha[m, g(k), n] * B_m[k, n]   (m in order),
// so each k costs m_active FMAs per column plus one FMA per row, not
// m_active per row, and x is read once for all levels.  Each thread keeps
// a register tile of R output rows for one column; the packed bytes of its
// column (one coalesced load across the warp's 32 neighbouring columns per
// level) and its group's alphas (the next group's fetched ahead) sit in
// registers.  x is staged per warp through shared memory 32 k at a time
// (one coalesced load per row, the next tile's loads issued before the
// current tile's FMAs) and read back as 16-byte broadcasts.  Each output's
// sum runs over its chunk's k in order; the KSPLIT partial sums then meet
// in shared memory and are added in chunk order by one thread per output.
// No atomics: every plan gives bit-identical outputs.  Masks cover ragged
// T, N below the block, K not a multiple of 8, group_size not a multiple of
// 8 (a byte that straddles two groups takes each k's own alphas), chunks
// with no rows (K < 8*KSPLIT) and m_active < M without padding any buffer.
// m_active is a template argument (1..4) so the per-level registers stay
// registers.  x is read in the caller's dtype, fp32 or bf16 (XT, a template
// argument, as the TPU kernel reads x_ref in the caller's dtype and casts
// it in its body): a bf16 element is widened to fp32 as it is staged (its
// 16 bits become the high half of the fp32 word, which is exact), so a bf16
// x gives the bits an fp32 copy of it would, and moves half the x bytes.
// Where K is even and x 4-byte aligned, bf16 x is read two elements per
// 32-bit load (half the loads of one element per lane, which were 1-15 %
// slower than fp32 x at the LM shapes) and staged as a float2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSPLIT = 8;      // reduction chunks; part of the arithmetic, not of the plan
constexpr int TILE_K = 32;     // k staged per warp at a time
constexpr int NB = TILE_K / 8; // packed bytes per staged tile

// How x is read (XT): float, fp32 x, one element per lane; uint16_t, bf16
// x, one element per lane; uint32_t, bf16 x read two elements per 32-bit
// load (K even and x 4-byte aligned), so half the lanes' loads cover a row.
template <typename XT> constexpr bool kPairs = false;
template <> constexpr bool kPairs<uint32_t> = true;

// one element of x as fp32: fp32 as it is, bf16 (its bits, uint16_t) widened
__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

// blockDim = (cols, KSPLIT); grid = (ceil(T / R), ceil(N / cols));
// dynamic shared memory: R * cols * KSPLIT floats.
template <typename XT, int R, int MA>
__global__ void __launch_bounds__(512) binary_matmul_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ bp,
    const float* __restrict__ alpha, float* __restrict__ out, int T, int K,
    int N, int G, int gs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cols = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.y * cols + threadIdx.x) >> 5;
  float* xs = smem + warp * (R * TILE_K);  // this warp's [R][TILE_K] tile
  const int n = blockIdx.y * cols + threadIdx.x;
  const int nn = n < N ? n : 0;  // lanes past N read column 0, write nothing
  const int t0 = blockIdx.x * R;
  const int chunk = threadIdx.y;
  const int K8 = (K + 7) / 8;
  const int k0 = 8 * ((chunk * K8) / KSPLIT);
  const int k1 = min(K, 8 * (((chunk + 1) * K8) / KSPLIT));

  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  if (k0 < k1) {
    int g = k0 / gs;
    int rem = gs - (k0 - g * gs);  // rows left in group g
    float a[MA], an[MA];           // alphas of groups g and g + 1
#pragma unroll
    for (int m = 0; m < MA; ++m) {
      a[m] = __ldg(alpha + ((int64_t)m * G + g) * N + nn);
      an[m] = g + 1 < G ? __ldg(alpha + ((int64_t)m * G + g + 1) * N + nn) : 0.f;
    }
    auto next_group = [&]() {
      ++g;
      rem = gs;
#pragma unroll
      for (int m = 0; m < MA; ++m) {
        a[m] = an[m];
        an[m] = g + 1 < G ? __ldg(alpha + ((int64_t)m * G + g + 1) * N + nn) : 0.f;
      }
    };
    // the next tile of x in registers: element r of nx is row r's at
    // k = kt + lane; with pairs, word j of nw is row (32 j + lane) / 16's
    // two elements at k = kt + 2 ((32 j + lane) % 16)
    constexpr int P = (R + 1) / 2;
    float nx[kPairs<XT> ? 1 : R];
    unsigned nw[P];
    unsigned nb[NB][MA];
    auto fetch = [&](int kt) {
      if constexpr (kPairs<XT>) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int row = (32 * j + lane) >> 4, kp = 2 * (lane & 15);
          nw[j] = (row < R && t0 + row < T && kt + kp < k1)
                      ? __ldg(x + ((int64_t)(t0 + row) * K + kt + kp) / 2) : 0u;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          nx[r] = (t0 + r < T && kt + lane < k1)
                      ? load_x(x + (int64_t)(t0 + r) * K + kt + lane) : 0.f;
      }
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int m = 0; m < MA; ++m)
          nb[jb][m] = kt + 8 * jb < k1
                          ? __ldg(bp + ((int64_t)m * K8 + kt / 8 + jb) * N + nn) : 0u;
    };
    fetch(k0);
    for (int kt = k0; kt < k1; kt += TILE_K) {
      __syncwarp();
      if constexpr (kPairs<XT>) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int row = (32 * j + lane) >> 4, kp = 2 * (lane & 15);
          if (row < R)
            *reinterpret_cast<float2*>(xs + row * TILE_K + kp) =
                make_float2(__uint_as_float(nw[j] << 16), __uint_as_float(nw[j] & 0xffff0000u));
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) xs[r * TILE_K + lane] = nx[r];
      }
      __syncwarp();
      unsigned bytes[NB][MA];
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int m = 0; m < MA; ++m) bytes[jb][m] = nb[jb][m];
      if (kt + TILE_K < k1) fetch(kt + TILE_K);
      const int kend = min(TILE_K, k1 - kt);
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const int kb = 8 * jb;
        if (kb >= kend) break;
        const int kn = min(8, kend - kb);
        if (kn == 8 && rem >= 8) {  // a whole byte inside one group
          float w[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            w[j] = 0.f;
#pragma unroll
            for (int m = 0; m < MA; ++m)
              w[j] = fmaf(a[m], ((bytes[jb][m] >> j) & 1u) ? 1.f : -1.f, w[j]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 lo = *reinterpret_cast<const float4*>(xs + r * TILE_K + kb);
            const float4 hi = *reinterpret_cast<const float4*>(xs + r * TILE_K + kb + 4);
            float v = s[r];
            v = fmaf(lo.x, w[0], v);
            v = fmaf(lo.y, w[1], v);
            v = fmaf(lo.z, w[2], v);
            v = fmaf(lo.w, w[3], v);
            v = fmaf(hi.x, w[4], v);
            v = fmaf(hi.y, w[5], v);
            v = fmaf(hi.z, w[6], v);
            v = fmaf(hi.w, w[7], v);
            s[r] = v;
          }
          rem -= 8;
          if (rem == 0) next_group();
        } else {
          for (int j = 0; j < kn; ++j) {
            float w = 0.f;
#pragma unroll
            for (int m = 0; m < MA; ++m)
              w = fmaf(a[m], ((bytes[jb][m] >> j) & 1u) ? 1.f : -1.f, w);
#pragma unroll
            for (int r = 0; r < R; ++r) s[r] = fmaf(xs[r * TILE_K + kb + j], w, s[r]);
            if (--rem == 0) next_group();
          }
        }
      }
    }
  }

  // the KSPLIT partial sums of each output, added in chunk order
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) smem[(chunk * R + r) * cols + threadIdx.x] = s[r];
  __syncthreads();
  const int tid = threadIdx.y * cols + threadIdx.x;
  for (int o = tid; o < R * cols; o += KSPLIT * cols) {
    const int r = o / cols, cx = o - r * cols;
    const int t = t0 + r, no = blockIdx.y * cols + cx;
    if (t >= T || no >= N) continue;
    float y = smem[r * cols + cx];
    for (int c = 1; c < KSPLIT; ++c) y = __fadd_rn(y, smem[(c * R + r) * cols + cx]);
    out[(int64_t)t * N + no] = y;
  }
}

template <typename XT, int R, int MA>
cudaError_t launch_plan(int cols, int T, int K, int N, int G, int gs, const XT* x,
                        const uint8_t* bp, const float* alpha, float* out,
                        cudaStream_t stream) {
  const dim3 block(cols, KSPLIT);
  const dim3 grid((T + R - 1) / R, (N + cols - 1) / cols);
  const size_t shmem = sizeof(float) * R * cols * KSPLIT;
  binary_matmul_kernel<XT, R, MA><<<grid, block, shmem, stream>>>(x, bp, alpha, out, T, K,
                                                                  N, G, gs);
  return cudaGetLastError();
}

template <typename XT, int R>
cudaError_t launch_levels(int m_active, int cols, int T, int K, int N, int G, int gs,
                          const XT* x, const uint8_t* bp, const float* alpha,
                          float* out, cudaStream_t stream) {
  switch (m_active) {
    case 1: return launch_plan<XT, R, 1>(cols, T, K, N, G, gs, x, bp, alpha, out, stream);
    case 2: return launch_plan<XT, R, 2>(cols, T, K, N, G, gs, x, bp, alpha, out, stream);
    case 3: return launch_plan<XT, R, 3>(cols, T, K, N, G, gs, x, bp, alpha, out, stream);
    case 4: return launch_plan<XT, R, 4>(cols, T, K, N, G, gs, x, bp, alpha, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_rows(int rows, int m_active, int cols, int T, int K, int N, int G,
                        int gs, const void* x, const uint8_t* bp, const float* alpha,
                        float* out, cudaStream_t stream) {
  const XT* xt = static_cast<const XT*>(x);
  switch (rows) {
    case 1: return launch_levels<XT, 1>(m_active, cols, T, K, N, G, gs, xt, bp, alpha, out, stream);
    case 2: return launch_levels<XT, 2>(m_active, cols, T, K, N, G, gs, xt, bp, alpha, out, stream);
    case 4: return launch_levels<XT, 4>(m_active, cols, T, K, N, G, gs, xt, bp, alpha, out, stream);
    case 8: return launch_levels<XT, 8>(m_active, cols, T, K, N, G, gs, xt, bp, alpha, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [T, K] f32 (x_bf16 0) or bf16 (x_bf16 1), bp [M, ceil(K/8), N] u8, alpha
// [M, G, N] f32, out [T, N] f32, all contiguous on the current device;
// m_active 1..4.  Tile plan: rows output rows per thread (1, 2, 4 or 8) and
// cols output columns per block (32 or 64).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a plan, level count or x
// dtype it was not built for).
extern "C" int binary_matmul_launch(const void* x, const void* bp,
                                    const void* alpha, void* out, int T, int K,
                                    int N, int G, int group_size, int m_active,
                                    int rows, int cols, int x_bf16, void* stream) {
  if (cols != 32 && cols != 64) return (int)cudaErrorInvalidValue;
  const uint8_t* b8 = (const uint8_t*)bp;
  const float* af = (const float*)alpha;
  float* of = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc;
  switch (x_bf16) {
    case 0: rc = launch_rows<float>(rows, m_active, cols, T, K, N, G, group_size, x, b8, af, of, s); break;
    case 1:
      rc = (K % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0)
               ? launch_rows<uint32_t>(rows, m_active, cols, T, K, N, G, group_size, x, b8, af, of, s)
               : launch_rows<uint16_t>(rows, m_active, cols, T, K, N, G, group_size, x, b8, af, of, s);
      break;
    default: rc = cudaErrorInvalidValue;
  }
  return (int)rc;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
