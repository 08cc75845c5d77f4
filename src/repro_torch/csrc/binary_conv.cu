// Fused implicit-GEMM binary convolution for Hopper (sm_90a), fp32 FFMA, NHWC.
//
//   w[k, d]           = sum_{m < m_active} alpha[m, k / gs, d] * B_m[k, d]     (m in order)
//   conv[b, u, v, d]  = sum_k x[b, u*s - pt + i, v*s - pl + j, c] * w[k, d],
//                       k = (i*kw + j)*C + c, taps outside x read zero (SAME)
//   out[b, uo, vo, d] = relu?(max_{pool x pool window} (conv + bias[d]))
//
// x is the unpadded input [B, H, W, C]; (pt, pl) are the low-side SAME pads
// (core/binconv.py conv_geometry), and a tap outside the map reads a zero,
// as from a padded copy, so no padded copy of x is ever made.  Weights are
// the per-tap layout B_tap_packed [M, kh*kw, ceil(C/8), D]: bit j of byte
// (m, t, c8, d) is +1 iff channel 8*c8 + j of tap t is +1; each tap's
// channel slice is padded to a byte, and channels >= C are never read.
//
// Replaces: src/repro/kernels/binary_conv.py, _kernel, launched by
// binary_conv2d_pallas (VMEM patch extraction, alpha folded into the +-1
// rows before one MXU dot, bias + max-pool + ReLU epilogue before the only
// write).
//
// What bounds it on the H100: fp32 operations.  One FFMA per folded weight
// per output, so the floor is 2 * MACs / 67 TFLOP/s (fp32 outside the
// tensor cores); MobileNetV1-224 at batch 16 runs 9.1 G MACs through this
// kernel per forward (0.27 ms), against ~0.3 GB of activations (0.09 ms at
// 3.35 TB/s).  The tensor cores are not used: single-pass TF32 breaks the
// reference's rtol 1e-5, and the exact route (+-1 in bf16, x split into
// three bf16 parts) costs 3 * m_active MMAs per MAC and a tolerance study
// of its own.
//
// Design: a GEMM of rows = unpooled conv outputs by columns = output
// channels, one BM x BN tile per block of 256 threads (16 x 16), each
// thread a (BM/16) x (BN/16) register tile split into two halves per axis
// so that shared loads do not collide (6 neighbouring rows on the 96-row
// tile, which gives the 14 x 14 layers at batch 16 one block per SM).  The reduction k = (tap, channel)
// runs in chunks of BK = 32 through a ring of STAGES stages in dynamic
// shared memory, filled by cp.async: the x tile, k-major (4-byte copies
// that transpose as they land; a warp reads 8 neighbouring k of 4 rows, so
// the reads are 32-byte runs and the writes hit 32 banks; taps outside the
// map and rows past the end copy nothing and read zero), and the packed
// weight bytes of every active level (4-byte copies of each packed row's
// column range).  Chunk c+1's copies land while chunk c computes, chunk
// c+2's are issued then.  Once per chunk the block folds the levels: each
// (k, d) becomes one fp32 weight w[k, d] (the sum above in level order,
// each term alpha with its sign bit set from B, added with the rounding of
// fmaf(alpha, +-1, w); alpha of k's group kept in registers until the
// group ends; a byte at a time where C and the group size are multiples of
// 8), into the second of two weight buffers, just before the FFMAs of the
// chunk before, so a chunk costs one barrier and each staged k one FFMA
// per output whatever m_active is.  A
// k costs a thread two 16-byte loads of x and two of w for 64 FFMAs on the
// 128 x 128 tile.  The point-wise layers (1x1, stride 1, VALID, no pool)
// address x as a plain [P, C] matrix; the general path gathers each k of
// each row from its tap, with the border masked.  Rows are ordered pooled
// pixel major, window offset minor, and a block holds whole pool windows
// (BM / pool^2 of them), so the weights are staged once for all offsets;
// the epilogue adds the bias, goes through shared memory, takes the max
// over each window's rows, applies ReLU and writes once, coalesced along
// d.  Each output's sum is one fmaf chain in k order over its K terms,
// independent of the tile plan and of the path that loaded x, so every
// plan and both paths give bit-identical outputs; no split-K, no atomics.
// Masks cover ragged batches and rows, D below the tile, C not a multiple
// of 8 (a chunk then spans taps and rows of the packed layout), groups that
// span taps, and m_active < M; offsets into x, the weights and out are
// 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of register tiles
constexpr int BK = 32;        // reduction rows k staged per chunk
constexpr int STAGES = 3;
constexpr int MAX_LEVELS = 4;

struct Args {
  const float* x;
  const uint8_t* wp;
  const float* alpha;
  const float* bias;
  float* out;
  int64_t Q;       // pooled output pixels, B * Uo * Vo
  int64_t nbytes;  // bytes of wp
  int H, W, C, D, kw, stride, pt, pl, pool, Uo, Vo, K, C8, T, G, gs, m_active, relu;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Packed row (t * C8 + c / 8) holding reduction row k; k / 8 when C % 8 == 0.
__device__ __forceinline__ int packed_row(int k, int C, int C8) {
  if ((C & 7) == 0) return k >> 3;
  const int t = k / C;
  return t * C8 + (k - t * C) / 8;
}

__host__ __device__ constexpr int wp_pitch(int BN) { return BN + 4; }  // bytes per staged packed row

__host__ __device__ constexpr int xs_pitch(int BM) { return BM + 4; }  // floats per staged k

__host__ __device__ inline size_t stage_bytes(int BM, int BN, int levels) {
  const size_t xs = sizeof(float) * BK * xs_pitch(BM);
  const size_t wb = ((size_t)levels * BK * wp_pitch(BN) + 15) / 16 * 16;
  return xs + wb;
}

__host__ __device__ inline size_t main_bytes(int BM, int BN, int levels) {
  const size_t ring = STAGES * stage_bytes(BM, BN, levels) + 2 * sizeof(float) * BK * (BN + 4);
  const size_t epi = sizeof(float) * BM * (BN + 4);
  return ring > epi ? ring : epi;
}

__host__ __device__ inline size_t shared_bytes(int BM, int BN, int levels) {
  return main_bytes(BM, BN, levels) + (sizeof(int64_t) + 2 * sizeof(int)) * BM;
}

// DENSE: 1x1, stride 1, no pad, no pool, so GEMM row r of the block is
// pixel q0 + r and its k-th value sits at x[(q0 + r) * C + k].
template <int BM, int BN, bool DENSE>
__global__ void __launch_bounds__(THREADS, 2) binary_conv_kernel(const Args a) {
  constexpr int TM = BM / 16, TN = BN / 16, HM = TM / 2, HN = TN / 2;
  constexpr int XSP = xs_pitch(BM);  // x tile pitch in floats, k-major
  constexpr int WFP = BN + 4;        // folded-weight pitch in floats
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const size_t sbytes = stage_bytes(BM, BN, a.m_active);
  float* wf_ring = reinterpret_cast<float*>(smem + STAGES * sbytes);  // 2 x [BK][WFP]
  int64_t* rbase = reinterpret_cast<int64_t*>(smem + main_bytes(BM, BN, a.m_active));
  int* rh0 = reinterpret_cast<int*>(rbase + BM);
  int* rw0 = rh0 + BM;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // row of register-tile row r: two halves of HM rows (TM 4 or 8) or TM
  // neighbouring rows (TM 6); column of cc: two halves of HN columns
  auto row_of = [&](int r) {
    return TM == 6 ? ty * 6 + r : (r < HM ? 0 : BM / 2) + ty * HM + (r % HM);
  };
  auto col_of = [&](int cc) { return (cc < HN ? 0 : BN / 2) + tx * HN + (cc % HN); };
  const int PP = a.pool * a.pool;
  const int nwin = BM / PP;  // whole pool windows per block
  const int64_t q0 = (int64_t)blockIdx.x * nwin;
  const int d0 = blockIdx.y * BN;
  const int nch = (a.K + BK - 1) / BK;

  if (!DENSE) {  // where each GEMM row's receptive field starts in x
    for (int r = tid; r < BM; r += THREADS) {
      const int wq = r / PP, w = r - wq * PP;
      const int64_t q = q0 + wq;
      int64_t base = 0;
      int h0 = -(1 << 30), w0 = -(1 << 30);  // unused rows: every tap masked
      if (wq < nwin && q < a.Q) {
        const int64_t per = (int64_t)a.Uo * a.Vo;
        const int64_t b = q / per;
        const int rem = (int)(q - b * per);
        const int uo = rem / a.Vo, vo = rem - uo * a.Vo;
        const int pi = w / a.pool, pj = w - pi * a.pool;
        h0 = (uo * a.pool + pi) * a.stride - a.pt;
        w0 = (vo * a.pool + pj) * a.stride - a.pl;
        base = ((b * a.H + h0) * a.W + w0) * a.C;
      }
      rbase[r] = base;
      rh0[r] = h0;
      rw0[r] = w0;
    }
    __syncthreads();
  }

  // This thread copies reduction row kk of rows r0, r0 + 8, ... of each
  // chunk: a warp takes 8 neighbouring k of 4 neighbouring rows, so its
  // global reads are 32-byte runs and its shared writes hit 32 banks.
  const int warp = tid >> 5, ln = tid & 31;
  const int ck = (warp & 3) * 8 + (ln & 7);
  const int r0 = (warp >> 2) * 4 + (ln >> 3);
  const int nrows = (int)min((int64_t)BM, a.Q - q0);  // rows of the block in x (DENSE)
  const float* xrow = a.x + (q0 + r0) * a.C + ck;     // row r0, k = ck (DENSE)

  // Issue the copies of chunk c into stage c % STAGES (always one group).
  auto issue = [&](int c) {
    if (c < nch) {
      unsigned char* st = smem + (c % STAGES) * sbytes;
      float* xs = reinterpret_cast<float*>(st);
      const int k0 = c * BK;
      const int k = k0 + ck;
      const bool kin = k < a.K;
      float* dst = xs + ck * XSP;
      if (DENSE) {
        const float* src = xrow + k0;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const bool ok = kin && r0 + 8 * j < nrows;
          cp_async4(dst + r0 + 8 * j, ok ? src + (int64_t)8 * j * a.C : a.x, ok ? 4 : 0);
        }
      } else {
        int i = 0, j = 0;
        int64_t koff = 0;
        if (kin) {
          const int t = k / a.C, ch = k - t * a.C;
          i = t / a.kw;
          j = t - i * a.kw;
          koff = ((int64_t)i * a.W + j) * a.C + ch;
        }
#pragma unroll 4
        for (int r = r0; r < BM; r += 8) {
          const int h = rh0[r] + i, w = rw0[r] + j;
          const bool ok = kin && (unsigned)h < (unsigned)a.H && (unsigned)w < (unsigned)a.W;
          cp_async4(dst + r, ok ? a.x + rbase[r] + koff : a.x, ok ? 4 : 0);
        }
      }
      // packed rows [row(k0), row(k_last)] of every active level, columns
      // d0 .. d0 + BN - 1, as aligned 4-byte words (a partial word at the
      // end of the tensor copies only its bytes that exist)
      unsigned char* wst = st + sizeof(float) * BK * XSP;
      const int kl = min(k0 + BK, a.K) - 1;
      const int row0 = packed_row(k0, a.C, a.C8);
      const int nr = packed_row(kl, a.C, a.C8) - row0 + 1;
      constexpr int NW = BN / 4 + 1;
      for (int m = 0; m < a.m_active; ++m) {
        const int64_t mrow = (int64_t)m * a.T * a.C8 + row0;
        for (int e = tid; e < nr * NW; e += THREADS) {
          const int rr = e / NW, wi = e - rr * NW;
          const int64_t start = (mrow + rr) * a.D + d0;
          const int64_t word = (start & ~(int64_t)3) + 4 * wi;
          const int64_t left = a.nbytes - word;
          const int n = left >= 4 ? 4 : left > 0 ? (int)left : 0;
          cp_async4(wst + (m * BK + rr) * wp_pitch(BN) + 4 * wi, n ? a.wp + word : a.wp, n);
        }
      }
    }
    cp_async_commit();
  };

  // Fold chunk c's levels into wf: wf[kk][d] = sum_m alpha[m, g(k), d] *
  // (+-1), m in order, each term added as alpha with its sign bit flipped
  // for -1 (the same rounding as fmaf(alpha, +-1, w)).  This thread's
  // slice: column fd, k = k0 + fk0 .. + KPT - 1.
  constexpr int KPT = BK * BN / THREADS;
  const int fd = tid % BN, fk0 = (tid / BN) * KPT;
  const bool dcol = d0 + fd < a.D;
  const int D4 = a.D & 3;
  // C % 8 == 0 and gs % 8 == 0: k's packed row is k / 8 and its bit k % 8,
  // and a group never ends inside a byte
  const bool bytewise = (a.C & 7) == 0 && (a.gs & 7) == 0;
  int gcur = -1;           // group whose alphas sit in nal
  unsigned nal[MAX_LEVELS];  // -alpha[m, gcur, d] as bits (0 for levels past m_active)
  auto load_alpha = [&](int g) {
    gcur = g;
#pragma unroll
    for (int m = 0; m < MAX_LEVELS; ++m)
      nal[m] = m < a.m_active
                   ? __float_as_uint(-__ldg(a.alpha + ((int64_t)m * a.G + g) * a.D + d0 + fd))
                   : 0u;
  };
  // alpha[m] times +1 if bit 31 of b is set, else -1, exactly
  auto term = [&](int m, unsigned b) { return __uint_as_float(nal[m] ^ (b & 0x80000000u)); };
  auto fold = [&](int c, float* wf) {
    const unsigned char* wst = smem + (c % STAGES) * sbytes + sizeof(float) * BK * XSP;
    const int k0 = c * BK;
    const int row0 = packed_row(k0, a.C, a.C8);
    int k = k0 + fk0;
    int shift[MAX_LEVELS];  // byte offset of column d0 in each level's first staged word
#pragma unroll
    for (int m = 0; m < MAX_LEVELS; ++m)
      shift[m] = ((m * a.T * a.C8 + row0) * D4 + d0) & 3;
    if (!dcol || k >= a.K) {
#pragma unroll
      for (int q = 0; q < KPT; ++q) wf[(fk0 + q) * WFP + fd] = 0.f;
      return;
    }
    if (bytewise) {
      constexpr int L = KPT < 8 ? KPT : 8;  // k per byte run
#pragma unroll
      for (int run = 0; run < KPT / L; ++run) {
        const int kr = k + run * L;
        float w[L];
#pragma unroll
        for (int j = 0; j < L; ++j) w[j] = 0.f;
        if (kr < a.K) {
          const int g = a.G == 1 ? 0 : kr / a.gs;
          if (g != gcur) load_alpha(g);
          const int rr = (kr - k0) >> 3, b0 = kr & 7;
#pragma unroll
          for (int m = 0; m < MAX_LEVELS; ++m) {
            if (m < a.m_active) {
              const unsigned by =
                  wst[(m * BK + rr) * wp_pitch(BN) + ((shift[m] + rr * D4) & 3) + fd] >> b0;
#pragma unroll
              for (int j = 0; j < L; ++j) w[j] = __fadd_rn(w[j], term(m, by << (31 - j)));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < L; ++j) wf[(fk0 + run * L + j) * WFP + fd] = w[j];
      }
      return;
    }
    int t = k / a.C, ch = k - t * a.C;
    int g = k / a.gs, rem = a.gs - (k - g * a.gs);
    if (g != gcur) load_alpha(g);
    for (int q = 0; q < KPT; ++q, ++k) {
      float w = 0.f;
      if (k < a.K) {
        const int rr = t * a.C8 + (ch >> 3) - row0, bit = ch & 7;
#pragma unroll
        for (int m = 0; m < MAX_LEVELS; ++m) {
          if (m < a.m_active) {
            const unsigned byte =
                wst[(m * BK + rr) * wp_pitch(BN) + ((shift[m] + rr * D4) & 3) + fd];
            w = __fadd_rn(w, term(m, byte << (31 - bit)));
          }
        }
        if (--rem == 0 && k + 1 < a.K) {  // next group's alphas
          rem = a.gs;
          load_alpha(++g);
        }
        if (++ch == a.C) {
          ch = 0;
          ++t;
        }
      }
      wf[(fk0 + q) * WFP + fd] = w;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  // reduction row kk of the chunk's x tile xs and folded weights wf into
  // the register tile: two 16-byte loads of x, two of w, TM x TN FFMAs
  auto step = [&](const float* xs, const float* wf, int kk) {
    float x[TM], w[TN];
    if constexpr (TM == 6) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(xs + kk * XSP + ty * 6 + 2 * i);
        x[2 * i] = v.x; x[2 * i + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* px = xs + kk * XSP + h * (BM / 2) + ty * HM;
        if constexpr (HM == 4) {
          const float4 v = *reinterpret_cast<const float4*>(px);
          x[h * HM + 0] = v.x; x[h * HM + 1] = v.y; x[h * HM + 2] = v.z; x[h * HM + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(px);
          x[h * HM + 0] = v.x; x[h * HM + 1] = v.y;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* pw = wf + kk * WFP + h * (BN / 2) + tx * HN;
      if constexpr (HN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(pw);
        w[h * HN + 0] = v.x; w[h * HN + 1] = v.y; w[h * HN + 2] = v.z; w[h * HN + 3] = v.w;
      } else if constexpr (HN == 2) {
        const float2 v = *reinterpret_cast<const float2*>(pw);
        w[h * HN + 0] = v.x; w[h * HN + 1] = v.y;
      } else {
        w[h * HN] = pw[0];
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) acc[r][cc] = fmaf(x[r], w[cc], acc[r][cc]);
  };

  // Ring: chunk c+1's copies land while chunk c computes; chunk c+1 is
  // folded right before chunk c's FFMAs, so one barrier per chunk.
  issue(0);
  issue(1);
  cp_async_wait<1>();
  __syncthreads();
  fold(0, wf_ring);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c+1 landed, wf[c % 2] complete, chunk c-1's stage and wf free
    issue(c + 2);
    if (c + 1 < nch) fold(c + 1, wf_ring + ((c + 1) & 1) * BK * WFP);
    const float* xs = reinterpret_cast<const float*>(smem + (c % STAGES) * sbytes);
    const float* wf = wf_ring + (c & 1) * BK * WFP;
    const int kn = min(BK, a.K - c * BK);
    if (kn == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(xs, wf, kk);
    } else {
      for (int kk = 0; kk < kn; ++kk) step(xs, wf, kk);
    }
  }

  // epilogue: bias, then the max over each pool window, ReLU, one write
  cp_async_wait<0>();
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);  // [BM][BN + 4]
#pragma unroll
  for (int cc = 0; cc < TN; ++cc) {
    const int col = col_of(cc);
    const float bs = d0 + col < a.D ? __ldg(a.bias + d0 + col) : 0.f;
#pragma unroll
    for (int r = 0; r < TM; ++r) cs[row_of(r) * (BN + 4) + col] = __fadd_rn(acc[r][cc], bs);
  }
  __syncthreads();
  for (int e = tid; e < nwin * BN; e += THREADS) {
    const int wq = e / BN, col = e - wq * BN;
    const int64_t q = q0 + wq;
    const int d = d0 + col;
    if (q >= a.Q || d >= a.D) continue;
    const float* p = cs + wq * PP * (BN + 4) + col;
    float best = p[0];
    for (int w = 1; w < PP; ++w) best = fmaxf(best, p[w * (BN + 4)]);
    a.out[q * a.D + d] = a.relu ? fmaxf(best, 0.f) : best;
  }
}

template <int BM, int BN, bool DENSE>
cudaError_t launch_plan(const Args& a, int64_t blocks, cudaStream_t stream) {
  const auto kernel = binary_conv_kernel<BM, BN, DENSE>;
  const size_t shmem = shared_bytes(BM, BN, a.m_active);
  static unsigned raised = 0;  // devices whose shared-memory limit was raised
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shared_bytes(BM, BN, MAX_LEVELS));
    if (rc != cudaSuccess) return rc;
    if (dev < 32) raised |= 1u << dev;
  }
  const dim3 grid((unsigned)blocks, (a.D + BN - 1) / BN);
  kernel<<<grid, THREADS, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM, bool DENSE>
cudaError_t launch_cols(int cols, const Args& a, int64_t blocks, cudaStream_t s) {
  switch (cols) {
    case 32: return launch_plan<BM, 32, DENSE>(a, blocks, s);
    case 64: return launch_plan<BM, 64, DENSE>(a, blocks, s);
    case 128: return launch_plan<BM, 128, DENSE>(a, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DENSE>
cudaError_t launch_rows(int rows, int cols, const Args& a, int64_t blocks, cudaStream_t s) {
  switch (rows) {
    case 64: return launch_cols<64, DENSE>(cols, a, blocks, s);
    case 96: return launch_cols<96, DENSE>(cols, a, blocks, s);
    case 128: return launch_cols<128, DENSE>(cols, a, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, H, W, C] f32 (unpadded), wp [M, kh*kw, ceil(C/8), D] u8,
// alpha [M, G, D] f32, bias [D] f32, out [B, Uo, Vo, D] f32, all contiguous
// on the current device; (pt, pl) the low-side pads, Uo * pool and
// Vo * pool the conv output size, m_active 1..4.  Tile plan: rows 64, 96
// or 128 GEMM rows (unpooled outputs, pool^2 <= rows) by cols 32, 64 or 128
// channels per block.  gather != 0 takes the general x path even where the
// point-wise one applies.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a plan or level count it was not built for).
extern "C" int binary_conv_launch(const void* x, const void* wp, const void* alpha,
                                  const void* bias, void* out, int B, int H, int W,
                                  int C, int D, int M, int kh, int kw, int stride,
                                  int pt, int pl, int pool, int Uo, int Vo, int G,
                                  int group_size, int m_active, int relu, int rows,
                                  int cols, int gather, void* stream) {
  if (m_active < 1 || m_active > MAX_LEVELS || pool < 1 || pool * pool > rows)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.wp = (const uint8_t*)wp;
  a.alpha = (const float*)alpha;
  a.bias = (const float*)bias;
  a.out = (float*)out;
  a.Q = (int64_t)B * Uo * Vo;
  a.C8 = (C + 7) / 8;
  a.T = kh * kw;
  a.nbytes = (int64_t)M * a.T * a.C8 * D;
  a.H = H; a.W = W; a.C = C; a.D = D; a.kw = kw; a.stride = stride;
  a.pt = pt; a.pl = pl; a.pool = pool; a.Uo = Uo; a.Vo = Vo;
  a.K = a.T * C; a.G = G; a.gs = group_size; a.m_active = m_active; a.relu = relu;
  const int64_t nwin = rows / (pool * pool);
  const int64_t blocks = (a.Q + nwin - 1) / nwin;
  const bool dense = !gather && kh == 1 && kw == 1 && stride == 1 && pool == 1 &&
                     pt == 0 && pl == 0 && Uo == H && Vo == W;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dense ? launch_rows<true>(rows, cols, a, blocks, s)
                     : launch_rows<false>(rows, cols, a, blocks, s));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
