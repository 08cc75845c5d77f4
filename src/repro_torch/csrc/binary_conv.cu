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
// Two paths.  Layers whose C fills packed bytes (C >= 8: MobileNet's
// point-wise layers) run the GEMM below, bound by its FFMAs.  A layer with
// C < 8 (CNN-A's conv1 and conv2, the stem) bounds differently: conv1
// (1.33 G MACs at batch 1024) and conv2 (3.98 G) by operations, 39.6 and
// 118.8 us; the stem at batch 128 by bytes, 77 MB in and 205 MB out, 84 us.
// The GEMM wastes most of that on them: its column tile pads D = 5 to 32,
// every block re-gathers its im2col tile 4 bytes at a time and refolds
// the weights per 32-k chunk, one element at a time.  Those layers take
// the direct path (binary_conv_kernel_direct, below), which stages each
// input pixel once per block, folds once per block, and issues the useful
// FFMAs plus a ragged edge: no padded columns, and at stride 1 one pixel
// load per tap column from a ring of registers.
//
// Design of the GEMM: rows = unpooled conv outputs by columns = output
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

// ---------------------------------------------------------------------------
// Direct path, for C < 8 (binary_conv_direct_launch).
//
// A block owns ni images by bu item rows (all column tiles) by ndg channel
// groups of TD channels.  It stages the input its outputs read, with the
// halo, once: sh rows of sw columns per image, each pixel padded to CP
// floats so a pixel is one or two 16-byte loads (cells outside x staged as
// zero: the SAME border).  It folds the levels of its groups' weights once,
// for all of K, into wf[k][g][8] (TD <= 8 floats used), with the GEMM
// path's rule: w = 0, then w = __fadd_rn(w, +-alpha[m, k / gs, d]) for m in
// order.  A thread's item is a pool window's rows by DCOLS neighbouring
// columns (nw whole windows) by TD channels, computed a row at a time.  At
// stride 1 the row's pixels sit in a ring of DCOLS registers, so a tap
// column costs one pixel load for DCOLS * C * TD FFMAs; at other strides
// the DCOLS pixels are loaded per tap.  Items run channel group fastest,
// so a group of ndg lanes reads the same pixels (a broadcast) and
// neighbouring weights.  Each output is one fmaf chain from 0 in
// k = (i*kw + j)*C + c order, then __fadd_rn(acc, bias): the GEMM path's
// bits.  The pool's max runs over rows, then over each window's columns;
// an output is never -0 (acc starts at +0 and rounds to nearest) and fmaxf
// drops NaN, so that order gives the GEMM path's max.  ReLU, one write.
// ---------------------------------------------------------------------------

constexpr int DCOLS = 6;       // unpooled outputs per thread along a row
constexpr int DTHREADS = 256;  // most threads of a block
constexpr int SHMEM_LIMIT = 232448;

struct DArgs {
  const float* x;
  const uint8_t* wp;
  const float* alpha;
  const float* bias;
  float* out;
  int B, H, W, C, D, kh, kw, stride, pt, pl, pool, Uo, Vo, T, G, gs, m_active, relu;
  int rows, nw, nt, item_rows, ndg, bu, nbands, ni, sh, sw;
};

__host__ __device__ inline size_t direct_bytes(int ni, int sh, int sw, int cp, int K, int ndg) {
  return sizeof(float) * ((size_t)ni * sh * sw * cp + (size_t)K * ndg * 8);
}

// the first C floats of a staged pixel (the rest are never read)
template <int CP>
__device__ __forceinline__ void load_px(const float* p, int C, float (&v)[CP]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  if constexpr (CP == 8) {
    if (C == 5) {
      v[4] = p[4];
    } else if (C == 6) {
      const float2 hi = *reinterpret_cast<const float2*>(p + 4);
      v[4] = hi.x; v[5] = hi.y;
    } else {
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    }
  }
}

template <int TD>
__device__ __forceinline__ void load_w(const float* p, float (&w)[TD]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  if constexpr (TD == 8) {
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
  } else {
    w[4] = p[4];
  }
}

// One staged row i of a thread's DCOLS outputs, taps j = 0 .. kw - 1 and
// channels c < C in that order, at stride 1: a ring of DCOLS pixels in
// registers, output p reading pixel p + j from slot (p + j) % DCOLS, so a
// tap column costs one pixel load (the next tap's last pixel, into the
// slot tap j's first pixel left).  The j loop runs in steps of DCOLS so
// every slot index is known at compile time.
template <int CP, int TD>
__device__ __forceinline__ void conv_row_ring(float (&acc)[DCOLS][TD], const float* xr,
                                              const float* wi, int kw, int C, int ldw) {
  float ring[DCOLS][CP];
#pragma unroll
  for (int q = 0; q < DCOLS; ++q) load_px<CP>(xr + q * CP, C, ring[q]);
  for (int j0 = 0; j0 < kw; j0 += DCOLS) {
#pragma unroll
    for (int jj = 0; jj < DCOLS; ++jj) {
      const int j = j0 + jj;
      if (j >= kw) break;
      const float* wk = wi + j * C * ldw;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c >= C) break;
        float w[TD];
        load_w<TD>(wk + c * ldw, w);
#pragma unroll
        for (int p = 0; p < DCOLS; ++p)
#pragma unroll
          for (int d = 0; d < TD; ++d)
            acc[p][d] = fmaf(ring[(p + jj) % DCOLS][c], w[d], acc[p][d]);
      }
      if (j + 1 < kw) load_px<CP>(xr + (DCOLS + j) * CP, C, ring[jj]);
    }
  }
}

// The same at any stride: output p reads pixel p * stride + j, loaded per tap.
template <int CP, int TD>
__device__ __forceinline__ void conv_row_load(float (&acc)[DCOLS][TD], const float* xr,
                                              const float* wi, int kw, int C, int stride,
                                              int ldw) {
  for (int j = 0; j < kw; ++j) {
    float xv[DCOLS][CP];
#pragma unroll
    for (int p = 0; p < DCOLS; ++p) load_px<CP>(xr + (p * stride + j) * CP, C, xv[p]);
    const float* wk = wi + j * C * ldw;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (c >= C) break;
      float w[TD];
      load_w<TD>(wk + c * ldw, w);
#pragma unroll
      for (int p = 0; p < DCOLS; ++p)
#pragma unroll
        for (int d = 0; d < TD; ++d) acc[p][d] = fmaf(xv[p][c], w[d], acc[p][d]);
    }
  }
}

// pool 1: bias, ReLU and the write of row u's columns v0 .. v0 + DCOLS - 1
template <int TD>
__device__ __forceinline__ void write_row(const DArgs& a, const float (&acc)[DCOLS][TD],
                                          const float (&bs)[TD], int b, int u, int v0,
                                          int d0) {
  float* o = a.out + (((int64_t)b * a.Uo + u) * a.Vo + v0) * a.D + d0;
  const bool vec = TD == 8 && (a.D & 3) == 0 && d0 + 8 <= a.D;
#pragma unroll
  for (int p = 0; p < DCOLS; ++p) {
    if (v0 + p >= a.Vo) break;
    float v[TD];
#pragma unroll
    for (int d = 0; d < TD; ++d) {
      v[d] = __fadd_rn(acc[p][d], bs[d]);
      if (a.relu) v[d] = fmaxf(v[d], 0.f);
    }
    if constexpr (TD == 8) {
      if (vec) {
        float4* o4 = reinterpret_cast<float4*>(o + (int64_t)p * a.D);
        o4[0] = make_float4(v[0], v[1], v[2], v[3]);
        o4[1] = make_float4(v[4], v[5], v[6], v[7]);
        continue;
      }
    }
#pragma unroll
    for (int d = 0; d < TD; ++d)
      if (d0 + d < a.D) o[(int64_t)p * a.D + d] = v[d];
  }
}

// At most 128 registers a thread (two blocks of DTHREADS an SM): conv1 ran
// 3.7x faster on the H100 with this cap than with the compiler's own choice.
template <int CP, int TD, bool POOL>
__global__ void __launch_bounds__(DTHREADS, 2) binary_conv_kernel_direct(const DArgs a) {
  extern __shared__ float4 dsmem4[];
  float* xs = reinterpret_cast<float*>(dsmem4);               // [ni][sh][sw][CP]
  float* wf = xs + (size_t)a.ni * a.sh * a.sw * CP;           // [K][ndg][8]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int band = blockIdx.x % a.nbands;
  const int b0 = (blockIdx.x / a.nbands) * a.ni;
  const int r0 = band * a.bu * a.rows;  // the band's first unpooled row
  const int h0 = r0 * a.stride - a.pt;  // input row of staged row 0; staged column sc is sc - pl
  const int dg0 = blockIdx.y * a.ndg;
  const int ldw = a.ndg * 8;            // floats from one k to the next in wf

  // Stage: one warp a staged row, its lanes along the row's pixels, each
  // channel a 4-byte copy (a warp reads one contiguous run of x per
  // channel; a cell outside x copies nothing and reads zero).
  {
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
    for (int r = warp; r < a.ni * a.sh; r += nwarps) {
      const int im = r / a.sh, sr = r - im * a.sh;
      const int b = b0 + im, h = h0 + sr;
      const bool rin = b < a.B && (unsigned)h < (unsigned)a.H;
      const int64_t row = ((int64_t)b * a.H + h) * a.W;
      float* dst = xs + (size_t)r * a.sw * CP;
      for (int sc = lane; sc < a.sw; sc += 32) {
        const int w = sc - a.pl;
        const bool in = rin && (unsigned)w < (unsigned)a.W;
        for (int c = 0; c < a.C; ++c)
          cp_async4(dst + sc * CP + c, in ? a.x + (row + w) * a.C + c : a.x, in ? 4 : 0);
      }
    }
    cp_async_commit();
  }

  // Fold, while the copies land: byte (m, t, d) of the packed taps holds
  // channel c of tap t in bit c.
  for (int e = tid; e < a.T * a.ndg * TD; e += nthr) {
    const int dd = e % TD, rest = e / TD;
    const int g = rest % a.ndg, t = rest / a.ndg;
    const int d = (dg0 + g) * TD + dd;
    float* dst = wf + ((size_t)t * a.C * a.ndg + g) * 8 + dd;
    unsigned bits[MAX_LEVELS];
    float al[MAX_LEVELS];  // alpha[m, g, d] of the group g of k = t*C + c, loaded once a group
    int g_al = (t * a.C) / a.gs;
    const bool dok = d < a.D;
#pragma unroll
    for (int m = 0; m < MAX_LEVELS; ++m) {
      const bool mok = m < a.m_active && dok;
      bits[m] = mok ? a.wp[((int64_t)m * a.T + t) * a.D + d] : 0u;
      al[m] = mok ? __ldg(a.alpha + ((int64_t)m * a.G + g_al) * a.D + d) : 0.f;
    }
    for (int c = 0; c < a.C; ++c) {
      if (dok && (t * a.C + c) / a.gs != g_al) {
        ++g_al;
#pragma unroll
        for (int m = 0; m < MAX_LEVELS; ++m)
          if (m < a.m_active) al[m] = __ldg(a.alpha + ((int64_t)m * a.G + g_al) * a.D + d);
      }
      float w = 0.f;
#pragma unroll
      for (int m = 0; m < MAX_LEVELS; ++m)
        if (m < a.m_active) w = __fadd_rn(w, (bits[m] >> c) & 1u ? al[m] : -al[m]);
      dst[(size_t)c * ldw] = dok ? w : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int nitems = a.ni * a.bu * a.nt * a.ndg;
  // items: channel group fastest, then column tile, item row, image, so the
  // threads of a group of ndg lanes read the same pixels and neighbouring
  // weights
  for (int it = tid; it < nitems; it += nthr) {
    const int g = it % a.ndg;
    int rest = it / a.ndg;
    const int ct = rest % a.nt;
    rest /= a.nt;
    const int ir = rest % a.bu, im = rest / a.bu;
    const int b = b0 + im;
    if (b >= a.B || band * a.bu + ir >= a.item_rows) continue;
    const int d0 = (dg0 + g) * TD;
    const int u0 = r0 + ir * a.rows;       // the item's first unpooled row
    const int v0 = ct * a.nw * a.pool;     // and column
    const float* xim = xs + ((size_t)im * a.sh + (size_t)ir * a.rows * a.stride) * a.sw * CP +
                       (size_t)v0 * a.stride * CP;
    const float* wg = wf + g * 8;
    float bs[TD];
#pragma unroll
    for (int d = 0; d < TD; ++d) bs[d] = d0 + d < a.D ? __ldg(a.bias + d0 + d) : 0.f;
    float cmax[POOL ? DCOLS : 1][TD];
    for (int r = 0; r < a.rows; ++r) {
      float acc[DCOLS][TD];
#pragma unroll
      for (int p = 0; p < DCOLS; ++p)
#pragma unroll
        for (int d = 0; d < TD; ++d) acc[p][d] = 0.f;
      for (int i = 0; i < a.kh; ++i) {
        const float* xr = xim + (size_t)(r * a.stride + i) * a.sw * CP;
        const float* wi = wg + (size_t)i * a.kw * a.C * ldw;
        if (a.stride == 1)
          conv_row_ring<CP, TD>(acc, xr, wi, a.kw, a.C, ldw);
        else
          conv_row_load<CP, TD>(acc, xr, wi, a.kw, a.C, a.stride, ldw);
      }
      if constexpr (POOL) {  // bias, then the running max over the window's rows
#pragma unroll
        for (int p = 0; p < DCOLS; ++p)
#pragma unroll
          for (int d = 0; d < TD; ++d) {
            const float v = __fadd_rn(acc[p][d], bs[d]);
            cmax[p][d] = r == 0 ? v : fmaxf(cmax[p][d], v);
          }
      } else {
        write_row<TD>(a, acc, bs, b, u0 + r, v0, d0);
      }
    }
    if constexpr (POOL) {  // the max over each window's columns, ReLU, one write
      float* o = a.out + (((int64_t)b * a.Uo + u0 / a.pool) * a.Vo) * a.D + d0;
#pragma unroll
      for (int q = 0; q < DCOLS; ++q) {
        const int vo = ct * a.nw + q;
        if (q < a.nw && vo < a.Vo) {
          float best[TD];
#pragma unroll
          for (int d = 0; d < TD; ++d) best[d] = cmax[0][d];
#pragma unroll
          for (int p = 0; p < DCOLS; ++p) {
            const bool first = p == q * a.pool;
            const bool in = p >= q * a.pool && p < (q + 1) * a.pool;
#pragma unroll
            for (int d = 0; d < TD; ++d)
              best[d] = first ? cmax[p][d] : in ? fmaxf(best[d], cmax[p][d]) : best[d];
          }
#pragma unroll
          for (int d = 0; d < TD; ++d)
            if (d0 + d < a.D) o[(int64_t)vo * a.D + d] = a.relu ? fmaxf(best[d], 0.f) : best[d];
        }
      }
    }
  }
}

template <int CP, int TD, bool POOL>
cudaError_t launch_direct(const DArgs& a, dim3 grid, int threads, size_t shmem,
                          cudaStream_t stream) {
  const auto kernel = binary_conv_kernel_direct<CP, TD, POOL>;
  static unsigned raised = 0;  // devices whose shared-memory limit was raised
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SHMEM_LIMIT);
    if (rc != cudaSuccess) return rc;
    if (dev < 32) raised |= 1u << dev;
  }
  kernel<<<grid, threads, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <int CP, int TD>
cudaError_t launch_direct_pool(const DArgs& a, dim3 grid, int threads, size_t shmem,
                               cudaStream_t s) {
  return a.pool > 1 ? launch_direct<CP, TD, true>(a, grid, threads, shmem, s)
                    : launch_direct<CP, TD, false>(a, grid, threads, shmem, s);
}

}  // namespace

// The direct path (C < 8), with the tile of kernels/binary_conv.py
// direct_plan: td channels per thread (5 or 8), nt column tiles, bu item
// rows and ni images per block, ndg channel groups per block in nds
// slices, nbands bands of item rows; the other arguments as in
// binary_conv_launch.  Returns cudaErrorInvalidValue for a tile that does
// not cover the output or does not fit shared memory.
extern "C" int binary_conv_direct_launch(const void* x, const void* wp, const void* alpha,
                                         const void* bias, void* out, int B, int H, int W,
                                         int C, int D, int M, int kh, int kw, int stride,
                                         int pt, int pl, int pool, int Uo, int Vo, int G,
                                         int group_size, int m_active, int relu, int td,
                                         int nt, int bu, int ni, int ndg, int nds,
                                         int nbands, void* stream) {
  if (C < 1 || C >= 8 || m_active < 1 || m_active > MAX_LEVELS || m_active > M ||
      pool < 1 || pool > DCOLS || (td != 5 && td != 8) || nt < 1 || bu < 1 || ni < 1 ||
      ndg < 1 || nds < 1 || nbands < 1)
    return (int)cudaErrorInvalidValue;
  DArgs a;
  a.x = (const float*)x;
  a.wp = (const uint8_t*)wp;
  a.alpha = (const float*)alpha;
  a.bias = (const float*)bias;
  a.out = (float*)out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.D = D; a.kh = kh; a.kw = kw; a.stride = stride;
  a.pt = pt; a.pl = pl; a.pool = pool; a.Uo = Uo; a.Vo = Vo; a.T = kh * kw; a.G = G;
  a.gs = group_size; a.m_active = m_active; a.relu = relu;
  a.rows = pool > 1 ? pool : 1;
  a.nw = DCOLS / pool;
  a.nt = nt;
  a.item_rows = Uo;
  a.ndg = ndg; a.bu = bu; a.nbands = nbands; a.ni = ni;
  a.sh = (bu * a.rows - 1) * stride + kh;
  a.sw = ((nt - 1) * a.nw * pool + DCOLS - 1) * stride + kw;
  const int cp = C <= 4 ? 4 : 8;
  const size_t shmem = direct_bytes(ni, a.sh, a.sw, cp, a.T * C, ndg);
  if (shmem > (size_t)SHMEM_LIMIT || (int64_t)nt * a.nw < Vo || (int64_t)nbands * bu < a.item_rows ||
      (int64_t)nds * ndg * td < D)
    return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t)ni * bu * nt * ndg;
  const int threads = (int)(items >= DTHREADS ? DTHREADS : (items + 31) / 32 * 32);
  const dim3 grid((unsigned)(((int64_t)B + ni - 1) / ni * nbands), (unsigned)nds);
  const cudaStream_t s = (cudaStream_t)stream;
  if (cp == 4)
    return (int)(td == 8 ? launch_direct_pool<4, 8>(a, grid, threads, shmem, s)
                         : launch_direct_pool<4, 5>(a, grid, threads, shmem, s));
  return (int)(td == 8 ? launch_direct_pool<8, 8>(a, grid, threads, shmem, s)
                       : launch_direct_pool<8, 5>(a, grid, threads, shmem, s));
}

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
