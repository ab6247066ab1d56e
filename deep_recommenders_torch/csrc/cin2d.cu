// K4: one CIN layer over flattened rows, forward and backward,
//   out[r, m] = sum_{f,g} x0[r, f] * x[r, g] * W[f, g, m].
//
// Replaces deep_recommenders_tpu/ops/cin_kernels.py:cin2d (forward
// _cin2d_fwd_impl :81 with its pallas_call :107, backward _cin2d_bwd :125),
// the layer of xDeepFM's layered CIN (every configuration but two relu
// layers).
//
// Forward, at the TPU kernel's precision on the tensor cores. The TPU kernel
// rounds x0 and x to bf16, forms each pair product x0[r, f] * x[r, g] in
// bf16 and multiplies it by bf16 W[f] on the MXU with fp32 accumulation.
// This kernel computes the same terms with mma.sync m16n8k16 (bf16 operands,
// fp32 accumulators), one pass per tile.
//
// What bounds it on the H100: bytes. At R = 131072 rows, F0 = 6,
// H = M = 128 it does 2 R F0 H M = 25.8 GFLOP over about 138 MB of fp32
// input and output, 188 operations a byte, below the 295 at which the bf16
// tensor cores become the limit: 0.041 ms at 3.35 TB/s. So mma.sync, below
// wgmma's rate, is enough, and the design spends its care on bytes:
// - one block of 8 warps per 128 rows and 128 output columns reads its rows
//   of x and x0 once, in fp32, and keeps them in shared memory as bf16: x
//   zero-padded to a multiple of 16 columns, its rows 16 bytes longer than
//   that so that ldmatrix meets no bank conflict; x0 as pairs of one value.
// - W comes from the wrapper as bf16, transposed to (F0, M, H) and
//   zero-padded to the tiles (0.2 MB, read from L2). The block walks it in
//   16-deep chunks of g; each chunk of up to 8 f-slices is copied into
//   shared memory with cp.async, double-buffered, while the one before is
//   multiplied.
// - each warp keeps a 32 x 64 output tile in fp32 registers. Per chunk it
//   loads its A fragments of x once (ldmatrix); per f it scales them in
//   registers by its rows' bf16 x0[r, f] (__hmul2, the rounded pair
//   product) and feeds them to mma against W[f]'s fragments. The pair
//   tensor is never stored, and x is read from shared memory once per
//   chunk, not once per f.
// - the output, the largest transfer, goes from the registers to device
//   memory once, rows past R and columns past M masked.
//
// Backward, at the TPU kernel's precision on the tensor cores (tiles in
// cin_tile.cuh). The TPU kernel rounds g and W[f] to bf16 and forms
// t_f = g W[f]^T on the MXU with fp32 accumulation; it folds t_f into dx
// and dx0 with the fp32 x0 and x, and sums dW[f] = bf16(bf16(x0[:, f]) x)^T
// bf16(g) on the MXU. This backward computes the same terms with
// mma.sync m16n8k16.
//
// What bounds it on the H100: bytes. At R = 131072, F0 = 6, H = M = 128
// it does 4 R F0 H M = 51.5 GFLOP on the tensor cores (0.052 ms at 989
// TFLOP/s) over about 208 MB of fp32 inputs and outputs: x0, x, g and W
// read, dx0, dx and dW written (0.062 ms at 3.35 TB/s). The design:
// - data: one block of 8 warps per 128 rows keeps bf16 g in shared memory
//   (with the fp32 x of its column tile and x0), walks bf16 W[f] (F0, Hp,
//   Mp) from L2 in 128-deep chunks (cp.async, double-buffered) and, per f,
//   folds t_f from its registers into dx (registers, across f) and into
//   dx0 (a quad shuffle, then a fixed-order sum across the warps that
//   share a row, in shared memory, double-buffered over f: no atomics).
//   H <= 16 (layer 0, H = F0) takes 16-column tiles, wider H 128-column
//   tiles. It also writes bf16 copies of x and g, the weight pass's
//   operands. A block holds all of bf16 g, so M and F0 are bounded by
//   shared memory: F0 <= 55 at M = 128, M <= 320 at F0 = 6 (H > 16; see
//   cin2d_bwd_bf16_smem); the wrapper refuses larger shapes.
// - weights: each block stages 64 rows of bf16 x, g and x0 at a time
//   (cp.async, double-buffered), forms the rounded pair product in
//   registers (__hmul2 on ldmatrix.trans fragments of x, by their rows'
//   x0), multiplies it by g over a chunk of rows (2048 at H = 128, 512 at
//   H = 6, so that each pass has some 200-400 blocks; the wrapper picks
//   tile and chunk) and writes a partial dW; a second kernel adds the
//   chunks in a fixed order, so dW is the same from run to run.

#include "cin_tile.cuh"

namespace {

using namespace cin;

// -- forward: bf16 mma.sync ---------------------------------------------------

constexpr int kFwdRows = 128;          // rows of a block: 4 warps of 32
constexpr int kFwdCols = 128;          // output columns of a block: 2 of 64
constexpr int kFwdThreads = 256;
constexpr int kChunk = 16;             // depth of g per step: one mma k
constexpr int kWStride = kChunk + 8;   // bf16 per staged row of W: 48 bytes
constexpr int kMaxFGroup = 8;          // f-slices per staged chunk

// x0: (rows, f0) and x: (rows, h) fp32; wt: (f0, mp, hp) bf16, W[f, g, c] at
// wt[(f * mp + c) * hp + g], zero past h and m; out: (rows, m) fp32. fg
// f-slices share one staged chunk of W.
__global__ void __launch_bounds__(kFwdThreads, 2)
    cin2d_fwd_bf16_kernel(const float* __restrict__ x0,
                          const float* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wt,
                          float* __restrict__ out, int64_t rows, int f0, int h,
                          int m, int fg) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int hp = (h + kChunk - 1) / kChunk * kChunk, ldx = hp + 8;
  const int mp = (m + kFwdCols - 1) / kFwdCols * kFwdCols;
  const int stage = fg * kFwdCols * kWStride;  // bf16 of one staged chunk
  // Two stages of W, then x (kFwdRows x ldx), then x0s.
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  __nv_bfloat16* xs = ws + 2 * stage;
  uint32_t* x0s = reinterpret_cast<uint32_t*>(xs + kFwdRows * ldx);
  // x0s[f * kFwdRows + rr]: bf16(x0[r0 + rr, f]) twice.

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * kFwdRows;
  const int c0 = blockIdx.y * kFwdCols;
  const int nfg = (f0 + fg - 1) / fg;
  const int steps = hp / kChunk * nfg;  // step s: chunk s / nfg, group s % nfg

  auto stage_w = [&](int s) {
    const int kc = s / nfg, g0 = (s - kc * nfg) * fg;
    const int nf = min(fg, f0 - g0);
    __nv_bfloat16* dst = ws + (s & 1) * stage;
    for (int e = tid; e < nf * kFwdCols * 2; e += kFwdThreads) {
      const int half = e & 1, n = (e >> 1) % kFwdCols, fi = (e >> 1) / kFwdCols;
      cp_async16(dst + (fi * kFwdCols + n) * kWStride + half * 8,
                 wt + ((int64_t)(g0 + fi) * mp + c0 + n) * hp + kc * kChunk +
                     half * 8);
    }
    cp_async_commit();
  };
  stage_w(0);

  const int64_t valid = cin::min64(rows - r0, kFwdRows);
  const int hp2 = hp / 2;
  for (int e = tid; e < kFwdRows * hp2; e += kFwdThreads) {
    const int rr = e / hp2, c = 2 * (e - rr * hp2);
    float lo = 0.f, hi = 0.f;
    if (rr < valid) {
      const float* src = x + (r0 + rr) * h;
      if (c < h) lo = src[c];
      if (c + 1 < h) hi = src[c + 1];
    }
    *reinterpret_cast<uint32_t*>(xs + rr * ldx + c) = pack_bf16x2(lo, hi);
  }
  for (int e = tid; e < kFwdRows * f0; e += kFwdThreads) {
    const int rr = e / f0, f = e - rr * f0;
    const float v = rr < valid ? x0[(r0 + rr) * f0 + f] : 0.f;
    x0s[f * kFwdRows + rr] = pack_bf16x2(v, v);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;  // warp's tile
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int lq = lane >> 3, li = lane & 7;    // ldmatrix: matrix, row
  float acc[2][8][4] = {};                    // [m16 tile][n8 tile][.]
  uint32_t a[2][4];                           // x's A fragments
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage_w(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kc = s / nfg, g0 = (s - kc * nfg) * fg;
    if (g0 == 0) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[t], xs + (wr + 16 * t + li + (lq & 1) * 8) * ldx +
                              kc * kChunk + (lq >> 1) * 8);
    }
    const __nv_bfloat16* wstage = ws + (s & 1) * stage;
    const int nf = min(fg, f0 - g0);
    for (int fi = 0; fi < nf; ++fi) {
      // Rows grp and grp + 8 of each m16 tile: a[t][0], a[t][2] and
      // a[t][1], a[t][3] respectively.
      const uint32_t* x0f = x0s + (g0 + fi) * kFwdRows + wr + grp;
      uint32_t p[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t lo = x0f[16 * t], hi = x0f[16 * t + 8];
        p[t][0] = mul_bf16x2(a[t][0], lo);
        p[t][1] = mul_bf16x2(a[t][1], hi);
        p[t][2] = mul_bf16x2(a[t][2], lo);
        p[t][3] = mul_bf16x2(a[t][3], hi);
      }
      const __nv_bfloat16* wf = wstage + fi * kFwdCols * kWStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n8 tiles 2 j and 2 j + 1
        uint32_t b[4];
        ldmatrix_x4(b, wf + (wc + 16 * j + li + (lq >> 1) * 8) * kWStride +
                           (lq & 1) * 8);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc[t][2 * j], p[t], b[0], b[1]);
          mma_bf16(acc[t][2 * j + 1], p[t], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const bool pairs = (m & 1) == 0;  // then (r * m + even col) is 8-byte aligned
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + wc + 8 * j + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t r = r0 + wr + 16 * t + grp + 8 * half;
        if (r >= rows) continue;
        float* o = out + r * m + col;
        const float v0 = acc[t][j][2 * half], v1 = acc[t][j][2 * half + 1];
        if (pairs && col + 1 < m) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < m) o[0] = v0;
          if (col + 1 < m) o[1] = v1;
        }
      }
    }
  }
}

// -- backward: bf16 mma.sync --------------------------------------------------

// Rows [r0, r0 + RB) of the backward's data product: dx (rows, h) and dx0
// (rows, f0), fp32. wb: W as bf16 (f0, hp, mp), W[f, c, k] at
// wb[(f * hp + c) * mp + k], zero past h and m. Also writes the weight
// pass's operands: bf16(x) as xb (rows, xsd) and bf16(g) as gb (rows, mp),
// zero-padded.
template <int WR, int WC, int MT, int NT>
__global__ void __launch_bounds__(WR* WC * 32, 1)
    cin2d_bwd_data_kernel(const float* __restrict__ x0,
                          const float* __restrict__ x,
                          const bf16* __restrict__ wb,
                          const float* __restrict__ g,
                          float* __restrict__ dx0, float* __restrict__ dx,
                          bf16* __restrict__ xb, bf16* __restrict__ gb,
                          int64_t rows, int f0, int h, int m, int hp, int mp,
                          int xsd) {
  using T = Tile<WR, WC, MT, NT>;
  constexpr int RB = T::kRowsB, COLS = T::kCols, LDX = COLS + 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int ldg = mp + 8;
  bf16* ws = reinterpret_cast<bf16*>(bwd_smem);         // 2 kStage
  bf16* gs = ws + 2 * T::kStage;                        // RB x ldg: bf16(g)
  float* xs = reinterpret_cast<float*>(gs + RB * ldg);  // RB x LDX: x tile
  float* x0s = xs + RB * LDX;                           // RB x f0
  float* dx0s = x0s + RB * f0;                          // RB x f0
  // dx0 of each warp column for one f, double-buffered over f: 2 x WC x RB.
  float* part = dx0s + RB * f0;

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * RB;
  const int64_t valid = min64(rows - r0, RB);
  const int mp2 = mp / 2;
  // Unrolled, so that each thread has several loads in flight: one block
  // fills an SM, and nothing else hides these loads' latency.
#pragma unroll 8
  for (int e = tid; e < RB * mp2; e += T::kThreads) {
    const int rr = e / mp2, c = 2 * (e - rr * mp2);
    float lo = 0.f, hi = 0.f;
    if (rr < valid) {
      const float* src = g + (r0 + rr) * m;
      if (c < m) lo = src[c];
      if (c + 1 < m) hi = src[c + 1];
    }
    *reinterpret_cast<uint32_t*>(gs + rr * ldg + c) = pack_bf16x2(lo, hi);
  }
  for (int e = tid; e < RB * f0; e += T::kThreads) {
    x0s[e] = e / f0 < valid ? x0[r0 * f0 + e] : 0.f;
    dx0s[e] = 0.f;
  }
  const Frag fr;
  const int wr = T::warp_row(), wc = T::warp_col(), wcol = (tid >> 5) / WR;
  const bool pairs = (h & 1) == 0;  // then (r * h + even col) is 8-byte aligned
  for (int n0 = 0; n0 < hp; n0 += COLS) {
#pragma unroll 8
    for (int e = tid; e < RB * COLS; e += T::kThreads) {
      const int rr = e / COLS, c = e - rr * COLS;
      xs[rr * LDX + c] =
          (rr < valid && n0 + c < h) ? x[(r0 + rr) * h + n0 + c] : 0.f;
    }
    float dxa[MT][NT][4] = {};
    data_tile<WR, WC, MT, NT>(
        gs, ldg, wb, hp, mp, f0, n0, ws,
        [&](int f, float (&acc)[MT][NT][4]) {
          // The warp columns' sums for f - 1, in a fixed order: data_tile
          // synchronised since they were written.
          if (f > 0) fold_part<WC, RB>(part, dx0s, f0, f - 1);
#pragma unroll
          for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = wr + fr.row(t, hh);
              const float x0f = x0s[row * f0 + f];
              float s = 0.f;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const float v0 = acc[t][j][2 * hh], v1 = acc[t][j][2 * hh + 1];
                dxa[t][j][2 * hh] = fmaf(x0f, v0, dxa[t][j][2 * hh]);
                dxa[t][j][2 * hh + 1] = fmaf(x0f, v1, dxa[t][j][2 * hh + 1]);
                const float2 xv = *reinterpret_cast<const float2*>(
                    xs + row * LDX + wc + fr.col(j));
                s = fmaf(xv.x, v0, s);
                s = fmaf(xv.y, v1, s);
              }
              s = quad_sum(s);
              if (fr.tig == 0) part[((f & 1) * WC + wcol) * RB + row] = s;
            }
        });
    // data_tile ended on __syncthreads: the last f's sums are visible.
    fold_part<WC, RB>(part, dx0s, f0, f0 - 1);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wr + fr.row(t, hh);
        if (row >= valid) continue;
        float* o = dx + (r0 + row) * h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + wc + fr.col(j);
          const float v0 = dxa[t][j][2 * hh], v1 = dxa[t][j][2 * hh + 1];
          if (pairs && c + 1 < h) {
            *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
          } else {
            if (c < h) o[c] = v0;
            if (c + 1 < h) o[c + 1] = v1;
          }
        }
      }
    // bf16(x) for the weight pass, from the tile (data_tile synchronised).
    for (int e = tid; e < RB * (COLS / 2); e += T::kThreads) {
      const int rr = e / (COLS / 2), c = 2 * (e - rr * (COLS / 2));
      if (rr < valid && n0 + c < xsd)
        *reinterpret_cast<uint32_t*>(xb + (r0 + rr) * xsd + n0 + c) =
            pack_bf16x2(xs[rr * LDX + c], xs[rr * LDX + c + 1]);
    }
    __syncthreads();
  }
  for (int e = tid; e < valid * f0; e += T::kThreads) {
    dx0[r0 * f0 + e] = dx0s[e];
  }
  for (int e = tid; e < valid * (mp / 8); e += T::kThreads) {
    const int rr = e / (mp / 8), k = e - rr * (mp / 8);
    *reinterpret_cast<uint4*>(gb + (r0 + rr) * mp + 8 * k) =
        *reinterpret_cast<const uint4*>(gs + rr * ldg + 8 * k);
  }
}

// Dynamic shared memory of one block of cin2d_bwd_data_kernel.
template <int WR, int WC, int MT, int NT>
size_t bwd_data_smem(int f0, int mp) {
  using T = Tile<WR, WC, MT, NT>;
  return sizeof(bf16) * (2 * (size_t)T::kStage + (size_t)T::kRowsB * (mp + 8)) +
         sizeof(float) * (size_t)T::kRowsB * (T::kCols + 8 + 2 * f0 + 2 * WC);
}

template <int WR, int WC, int MT, int NT>
int launch_bwd_data(const float* x0, const float* x, const bf16* wb,
                    const float* g, float* dx0, float* dx, bf16* xb,
                    bf16* gb, int64_t rows, int f0, int h, int m, int hp,
                    int mp, int xsd, cudaStream_t stream) {
  using T = Tile<WR, WC, MT, NT>;
  if (hp % T::kCols || mp % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_data_smem<WR, WC, MT, NT>(f0, mp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(cin2d_bwd_data_kernel<WR, WC, MT, NT>, smem);
  if (err) return err;
  const int64_t blocks = (rows + T::kRowsB - 1) / T::kRowsB;
  cin2d_bwd_data_kernel<WR, WC, MT, NT>
      <<<(unsigned)blocks, T::kThreads, smem, stream>>>(
          x0, x, wb, g, dx0, dx, xb, gb, rows, f0, h, m, hp, mp, xsd);
  return (int)cudaGetLastError();
}
}  // namespace

// x0: (rows, f0) and x: (rows, h) fp32, row-major; wt: W (f0, h, m) as
// bf16 (f0, mp, hp), transposed and zero-padded, with hp = h rounded up to
// a multiple of 16 and mp = m rounded up to a multiple of 128; out:
// (rows, m) fp32. Launches on `stream` and returns a CUDA error code (0:
// none; cudaErrorInvalidValue where a row tile of x does not fit in shared
// memory, h above about 800).
extern "C" int cin2d_fwd_bf16(const float* x0, const float* x,
                              const __nv_bfloat16* wt, float* out,
                              int64_t rows, int32_t f0, int32_t h, int32_t m,
                              cudaStream_t stream) {
  const int hp = (h + kChunk - 1) / kChunk * kChunk;
  const size_t fixed = sizeof(__nv_bfloat16) * kFwdRows * (size_t)(hp + 8) +
                       sizeof(uint32_t) * kFwdRows * (size_t)f0;
  const size_t per_f = 2 * sizeof(__nv_bfloat16) * kFwdCols * kWStride;
  int fg = f0 < kMaxFGroup ? f0 : kMaxFGroup;
  while (fg > 1 && fixed + fg * per_f > cin::kMaxSmem) --fg;
  const size_t smem = fixed + fg * per_f;
  if (smem > cin::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = cin::allow_smem(cin2d_fwd_bf16_kernel, smem);
  if (err) return err;
  const dim3 grid((unsigned)((rows + kFwdRows - 1) / kFwdRows),
                  (unsigned)((m + kFwdCols - 1) / kFwdCols));
  cin2d_fwd_bf16_kernel<<<grid, kFwdThreads, smem, stream>>>(
      x0, x, wt, out, rows, f0, h, m, fg);
  return (int)cudaGetLastError();
}

// Bytes of shared memory one block of the backward's data kernel needs for
// (f0, h, mp): at most cin::kMaxSmem (232448) launch. With mp = m rounded up
// to 16 that is 256 mp + 1024 f0 <= 89088 for h > 16 (f0 <= 55 at m = 128,
// m <= 320 at f0 = 6) and 256 mp + 1024 f0 <= 208384 for h <= 16.
extern "C" int64_t cin2d_bwd_bf16_smem(int32_t f0, int32_t h, int32_t mp) {
  return (int64_t)(h <= 16 ? bwd_data_smem<8, 1, 1, 2>(f0, mp)
                           : bwd_data_smem<4, 2, 2, 8>(f0, mp));
}

// The gradients of the layer at (x0, x, w) for the output gradient g
// (rows, m), at the TPU kernel's precision: x0 (rows, f0), x (rows, h) and
// g fp32, row-major; wb: W as bf16 (f0, hp, mp), zero-padded, with hp = h
// rounded up to 16 (h <= 16) or to 128, and mp = m rounded up to 16. dx0
// (rows, f0), dx (rows, h) and dw (f0, h, m) fp32 are written; dw by the
// weight pass in tiles of `tile_rows` pair columns, summed over chunks of
// `chunk` rows (a multiple of 64). Scratch: xb (rows, xsd) and gb (rows,
// mp) bf16, xsd = h rounded up to 8, and part, ceil(rows / chunk) * f0 *
// xsd * m floats. Launches on `stream` and returns a CUDA error code
// (cudaErrorInvalidValue where the data kernel's block would need more
// shared memory than cin::kMaxSmem: see cin2d_bwd_bf16_smem).
extern "C" int cin2d_bwd_bf16(const float* x0, const float* x, const bf16* wb,
                              const float* g, float* dx0, float* dx,
                              float* dw, float* part, bf16* xb, bf16* gb,
                              int64_t rows, int32_t f0, int32_t h, int32_t m,
                              int32_t hp, int32_t mp, int32_t xsd,
                              int32_t tile_rows, int32_t chunk,
                              cudaStream_t stream) {
  if (xsd % 8 || xsd < h || xsd > hp) return (int)cudaErrorInvalidValue;
  const int err =
      h <= 16 ? launch_bwd_data<8, 1, 1, 2>(x0, x, wb, g, dx0, dx, xb, gb,
                                            rows, f0, h, m, hp, mp, xsd,
                                            stream)
              : launch_bwd_data<4, 2, 2, 8>(x0, x, wb, g, dx0, dx, xb, gb,
                                            rows, f0, h, m, hp, mp, xsd,
                                            stream);
  if (err) return err;
  return cin::launch_weight_pass(x0, xb, gb, part, dw, rows, f0, h, xsd, mp,
                                 m, tile_rows, chunk, stream);
}
