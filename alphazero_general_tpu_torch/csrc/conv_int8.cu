// The int8 tower's 3x3 'SAME' convolution as one implicit GEMM, with the
// elementwise chain that follows it in the same kernel: one launch a tower
// conv, two a residual block (conv3x3_int8_gemm_kernel, entry point
// azg_conv3x3_int8).
//
// Stands beside: the JAX package's _conv_int8 (alphazero_general_tpu/
//   models/quant.py:108, inside quant_apply :222), an XLA convolution into
//   int32 and not a Pallas kernel, with the quantize and residual ops of
//   quant_apply around it. The port ran it as a padded copy, a 9-tap patch
//   matrix [B*H*W, 9C], torch._int_mm and about 21 elementwise launches a
//   block (models/quant.py: conv3x3_int8, _quantize; the plain versions).
//
// What it computes, for int8 NHWC rows q [B*H*W, Cin] and a weight laid out
// by int8_weight_matrix, wt [Cout, 9*Cin] (K-contiguous, tap-major):
//   acc[r, n] = sum over taps (di, dj) in {-1,0,1}^2 and channels c of
//               q[r + di*W + dj, c] * wt[n, tap*Cin + c], a tap counting
//               as zero where (h + di, w + dj) leaves the board;
// then, without residual stream x (the first conv of a block):
//   out_q = clip(rint(fma(float(acc), s, b)), 0, 127)            int8
// and with it (the second):
//   xf    = float(x) + float(bf16(float(acc) * d))              float32
//   out_x = bf16(xf)                                             bf16
//   out_q = clip(rint(fma(xf, s, b)), 0, 127) where asked        int8
// s, b are the next conv's quantizer (conv2's with d1 folded in, or the
// next block's conv1's), d the block's dequantization scale.
//
// What bounds it on an H100, at connect4's self-play shape (B = 2048,
// 6x7, C = 128: 86,016 rows, K = 1,152): 25.37 G int8 operations, 12.82 us
// at 1,979 TOP/s. The first conv moves 22.17 MB (q in, weight, out_q),
// 6.62 us at 3.35 TB/s, so operations bound it: 12.82 us. The second moves
// 66.21 MB (q, weight, x in; out_x, out_q), 19.76 us (16.48 us in the last
// block, without out_q): bytes bound it. The library route it replaces
// wrote and read a 99 MB patch matrix and 44 MB int32 and float32
// intermediates per conv.
//
// What this design does about it:
// - No patch matrix. A block is persistent (one per SM) and walks tiles of
//   128 output rows. For each tile it copies those rows once into shared
//   memory, with a halo of W + 1 rows on each side (cp.async, double
//   buffered: the next tile's rows arrive while this one multiplies). Tap
//   (di, dj) reads the tile shifted by di*W + dj rows. Where (h + di,
//   w + dj) leaves the board the lane's ldmatrix address points at a row
//   of zeros instead; that also keeps taps from crossing into a
//   neighbouring image, so one rule serves every board from 3x3 to 15x15.
// - The weight resident in shared memory: copied once a block, rows of
//   9 * Cin32 + 16 bytes (Cin32: Cin rounded up to 32, the tail zero), the
//   K-major B operand. At C = 128 that is 149,504 B beside two A buffers
//   of 20,736 B and a 34,816 B staging tile (225,920 B of the 232,448 a
//   block may have). Rows 16 bytes past a multiple of 128 keep every
//   ldmatrix of 8 rows free of bank conflicts.
// - Int8 tensor cores into int32 registers: mma.sync m16n8k32 s8.s8.s32,
//   8 warps of 32 rows x Cout/2 channels, fragments by ldmatrix.x4, each
//   loaded one product ahead of its use. Sums of int8 products in int32
//   are exact, in any order. mma.sync is not the card's fastest int8 path
//   (wgmma is): cuBLASLt's own int8 kernel on an H100, an sm80 mma.sync
//   design, reaches about 440 TOP/s, 57 us for this product alone.
//   Measured at connect4's shape (PERF.md section 6): 0.075 ms for the
//   first conv, 0.092 ms for the second, 5.8x and 4.6x their bounds,
//   against 0.338 and 0.500 ms for the plain chain.
// - The epilogue in registers, then coalesced stores. The second conv's
//   residual rows arrive in the staging tile (cp.async) while the product
//   runs; each warp reads x there at its accumulators, writes out_x in its
//   place and the int8 codes into the tile's A buffer, which the product
//   no longer needs (the first conv writes its codes to the staging tile).
//   The block then stores whole rows, 16 bytes a thread. Nothing of the
//   chain goes to device memory but its outputs.
//
// Bit-equal with the plain chain (conv3x3_int8, _quantize and the residual
// ops in models/quant.py) run on the card: the library is compiled with
// --fmad=false, so each affine is the one explicit __fmaf_rn that
// torch.addcmul computes and every other multiply, add and rounding stays
// separate, in the plain chain's order; rintf rounds half to even, as
// torch.round; int32 to float and float to bf16 round to nearest even, as
// PyTorch's casts.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

// 8 warps: 4 along the rows of a tile x 2 along its channels, each 32 rows
// (two 16-row blocks) by Cout/2 channels. Measured on an H100 at the
// connect4 and hnefatafl shapes against 2x2 warps of 64 rows, 2x4 of 64,
// and tiles of 64 or 256 rows: the fastest that fits.
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kMB = 2;  // 16-row blocks of a warp
constexpr int kTileRows = kWarpsM * kMB * 16;  // output rows of a tile
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kPad = 16;        // bytes after each shared row (see above)
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

struct Params {
  const int8_t* q;           // [rows, cin]
  const int8_t* w;           // [cout, 9 * cin]
  const __nv_bfloat16* x;    // [rows, cout], null in the first conv
  const float* s;            // [cout]: the next quantizer's scale
  const float* b;            // [cout]: its bias
  const float* d;            // [cout]: dequantization (second conv only)
  int8_t* out_q;             // [rows, cout], may be null in the second
  __nv_bfloat16* out_x;      // [rows, cout], second conv only
  int rows, height, width, cin, cout;
};

// Byte offsets of the shared memory of one block, the same on host and
// device (and in quant.conv_smem_bytes).
struct Layout {
  int cin32, sa, sb, halo, ra, st;
  int off_a0, off_a1, off_z, off_st, total;
};

__host__ __device__ inline Layout layout(int width, int cin, int ncta,
                                         bool residual) {
  Layout l;
  l.cin32 = (cin + 31) / 32 * 32;
  l.sa = l.cin32 + kPad;          // an A row: one input row's channels
  l.sb = 9 * l.cin32 + kPad;      // a B row: one output channel's taps
  l.halo = width + 1;
  l.ra = kTileRows + 2 * l.halo;  // rows of an A buffer
  l.st = (residual ? 2 : 1) * ncta + kPad;  // a staging row
  l.off_a0 = ncta * l.sb;
  l.off_a1 = l.off_a0 + l.ra * l.sa;
  l.off_z = l.off_a1 + l.ra * l.sa;
  l.off_st = l.off_z + l.cin32;
  l.total = l.off_st + kTileRows * l.st;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies ``bytes`` (16 or 8) from global to shared memory, or writes zeros
// there when ``valid`` is false (no byte is read then).
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src,
                                           int bytes, bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// clip(rint(v), 0, 127): torch's round_ (half to even), then clamp_.
__device__ __forceinline__ int code(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), 0.0f), 127.0f));
}

// The rows of one tile with their halo, [r0 - halo, r0 + 128 + halo), into
// an A buffer; rows outside [0, rows) are zeros.
__device__ __forceinline__ void load_rows(const Params& p, const Layout& L,
                                          uint32_t dst, int r0, int chunk) {
  const int per_row = p.cin / chunk;
  const int first = r0 - L.halo;
  for (int i = threadIdx.x; i < L.ra * per_row; i += kThreads) {
    const int s = i / per_row;
    const int c = (i - s * per_row) * chunk;
    const int g = first + s;
    const bool valid = g >= 0 && g < p.rows;
    const int8_t* src =
        valid ? p.q + static_cast<size_t>(g) * p.cin + c : p.q;
    copy_async(dst + s * L.sa + c, src, chunk, valid);
  }
}

// The residual stream's rows of one tile, [r0, r0 + 128), into the staging
// tile (bf16 rows); rows past ``rows`` are zeros.
__device__ __forceinline__ void load_stream(const Params& p, const Layout& L,
                                            uint32_t dst, int r0) {
  const int per_row = p.cout / 8;  // 16 bytes: 8 bf16
  for (int i = threadIdx.x; i < kTileRows * per_row; i += kThreads) {
    const int row = i / per_row;
    const int c = (i - row * per_row) * 8;
    const int g = r0 + row;
    const bool valid = g < p.rows;
    const __nv_bfloat16* src =
        valid ? p.x + static_cast<size_t>(g) * p.cout + c : p.x;
    copy_async(dst + row * L.st + 2 * c, src, 16, valid);
  }
}

// Rows of ``bytes`` bytes a row from a shared tile (row stride ``stride``)
// to device memory (row stride ``cols``), 16 or 8 bytes a thread.
__device__ __forceinline__ void store_rows(unsigned char* dst,
                                           const unsigned char* src,
                                           int stride, int cols, int bytes,
                                           int rows) {
  const int unit = bytes % 16 == 0 ? 16 : 8;
  const int per_row = bytes / unit;
  for (int i = threadIdx.x; i < kTileRows * per_row; i += kThreads) {
    const int row = i / per_row;
    if (row >= rows) break;
    const int c = (i - row * per_row) * unit;
    unsigned char* out = dst + static_cast<size_t>(row) * cols + c;
    if (unit == 16) {
      *reinterpret_cast<uint4*>(out) =
          *reinterpret_cast<const uint4*>(src + row * stride + c);
    } else {
      *reinterpret_cast<uint2*>(out) =
          *reinterpret_cast<const uint2*>(src + row * stride + c);
    }
  }
}

template <int NB, bool kResidual>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_int8_gemm_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kNcta = kWarpsN * 8 * NB;  // output channels, padded
  const Layout L = layout(p.width, p.cin, kNcta, kResidual);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % kWarpsM;  // rows wm*16*kMB .. +16*kMB of the tile
  const int wn = warp / kWarpsM;  // channels wn*8*NB .. +8*NB
  const int hw = p.height * p.width;
  const int tiles = (p.rows + kTileRows - 1) / kTileRows;
  const uint32_t base = smem_u32(smem);
  // The int8 codes of the second conv's out_q are staged in the tile's A
  // buffer once its product is done (rows of qst bytes).
  const int qst = (p.cout + 15) / 16 * 16 + kPad;

  // Zeros first: the channel tails of every A and B row, the B rows past
  // cout and the zero row are never copied over.
  for (int i = tid * 16; i < L.off_st; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int chunk = p.cin % 16 == 0 ? 16 : 8;
  {
    const int per_tap = p.cin / chunk;
    const int per_n = 9 * per_tap;
    for (int i = tid; i < p.cout * per_n; i += kThreads) {
      const int n = i / per_n;
      const int t = (i - n * per_n) / per_tap;
      const int c = (i - n * per_n - t * per_tap) * chunk;
      copy_async(base + n * L.sb + t * L.cin32 + c,
                 p.w + static_cast<size_t>(n) * 9 * p.cin + t * p.cin + c,
                 chunk, true);
    }
  }
  int tile = blockIdx.x;
  load_rows(p, L, base + L.off_a0, tile * kTileRows, chunk);
  commit_async();

  const int g = lane >> 2;   // the accumulator's row within 8
  const int tig = lane & 3;  // its column pair within 8
  // ldmatrix addresses: A rows (lane & 7) + 8 * ((lane >> 3) & 1) at byte
  // 16 * (lane >> 4); B rows n = (lane >> 4) * 8 + (lane & 7) of a pair of
  // 8-channel blocks, at byte 16 * ((lane >> 3) & 1).
  const uint32_t a_col = 16 * (lane >> 4);
  const uint32_t zero_row = base + L.off_z + a_col;
  const uint32_t b_lane =
      base + (wn * 8 * NB + (lane >> 4) * 8 + (lane & 7)) * L.sb +
      16 * ((lane >> 3) & 1);
  unsigned char* stage = smem + L.off_st;
  const int steps = 9 * (L.cin32 / 32);  // k steps of 32 over all taps

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int off_a = (it & 1) ? L.off_a1 : L.off_a0;
    const uint32_t a_buf = base + off_a;
    const int r0 = tile * kTileRows;
    if constexpr (kResidual) {
      // The last tile's stores have read the staging tile and A buffer.
      __syncthreads();
    }
    if (next < tiles) {
      load_rows(p, L, base + ((it & 1) ? L.off_a0 : L.off_a1),
                next * kTileRows, chunk);
      commit_async();
    }
    if constexpr (kResidual) {
      load_stream(p, L, base + L.off_st, r0);
      commit_async();
      if (next < tiles) {
        wait_async<2>();
      } else {
        wait_async<1>();
      }
    } else {
      if (next < tiles) {
        wait_async<1>();
      } else {
        wait_async<0>();
      }
    }
    __syncthreads();

    // Each lane's A row in each of its four 16-row blocks, and the taps
    // that stay on the board there (bit t for tap t = 3 * (di + 1) + dj + 1).
    int a_row[kMB];
    unsigned taps[kMB];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      const int la =
          (wm * kMB + mb) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int r = r0 + la;
      a_row[mb] = la + L.halo;
      taps[mb] = 0;
      if (r < p.rows) {
        const int pos = r % hw;
        const int h = pos / p.width;
        const int w = pos - h * p.width;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int hh = h + t / 3 - 1;
          const int ww = w + t % 3 - 1;
          if (hh >= 0 && hh < p.height && ww >= 0 && ww < p.width) {
            taps[mb] |= 1u << t;
          }
        }
      }
    }

    int acc[kMB][NB][4];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0;

    // Software pipelined: each fragment is loaded one product ahead of its
    // use (ldmatrix and mma keep their source order).
    auto a_at = [&](int t, int k, int mb) -> uint32_t {
      const int shift = (t / 3 - 1) * p.width + (t % 3 - 1);
      return ((taps[mb] >> t) & 1u)
                 ? a_buf + (a_row[mb] + shift) * L.sa + a_col + k
                 : zero_row + k;
    };
    auto load_b = [&](uint32_t(&bf)[NB][2], int t, int k) {
      const uint32_t at = b_lane + t * L.cin32 + k;
      if constexpr (NB == 1) {
        ldsm_x2(bf[0], at);
      } else {
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {
          uint32_t r[4];
          ldsm_x4(r, at + j * 16 * L.sb);
          bf[2 * j][0] = r[0];
          bf[2 * j][1] = r[1];
          bf[2 * j + 1][0] = r[2];
          bf[2 * j + 1][1] = r[3];
        }
      }
    };
    auto mma_row = [&](int mb, const uint32_t(&af)[4],
                       const uint32_t(&bf)[NB][2]) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_s8(acc[mb][nb], af, bf[nb]);
    };
    uint32_t af[2][4], bf0[NB][2], bf1[NB][2];
    int t = 0, k = 0;
    auto step = [&](const uint32_t(&bc)[NB][2], uint32_t(&bn)[NB][2],
                    bool more) {
      int nt = t, nk = k + 32;
      if (nk == L.cin32) {
        nk = 0;
        ++nt;
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        if (mb + 1 < kMB) {
          ldsm_x4(af[(mb + 1) & 1], a_at(t, k, mb + 1));
        } else if (more) {
          load_b(bn, nt, nk);
          ldsm_x4(af[0], a_at(nt, nk, 0));
        }
        mma_row(mb, af[mb & 1], bc);
      }
      t = nt;
      k = nk;
    };
    load_b(bf0, 0, 0);
    ldsm_x4(af[0], a_at(0, 0, 0));
    for (int s = 0; s < steps; s += 2) {
      step(bf0, bf1, s + 1 < steps);
      if (s + 1 < steps) step(bf1, bf0, s + 2 < steps);
    }

    if constexpr (kResidual) {
      // The stream's rows have arrived; every warp is done with a_buf.
      wait_async<0>();
      __syncthreads();
    }

    // Epilogue in registers, into the staging tile: accumulator i of block
    // (mb, nb) is row (wm*kMB + mb)*16 + g + 8*(i >> 1), channel
    // wn*8*NB + nb*8 + 2*tig + (i & 1).
    unsigned char* qstage = kResidual ? smem + off_a : stage;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = wn * 8 * NB + nb * 8 + 2 * tig;
      if (n >= p.cout) continue;
      const bool codes = !kResidual || p.out_q != nullptr;
      float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      if (codes) {
        s0 = __ldg(p.s + n);
        s1 = __ldg(p.s + n + 1);
        b0 = __ldg(p.b + n);
        b1 = __ldg(p.b + n + 1);
      }
      const float d0 = kResidual ? __ldg(p.d + n) : 0.0f;
      const float d1 = kResidual ? __ldg(p.d + n + 1) : 0.0f;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (wm * kMB + mb) * 16 + g + 8 * half;
          const int a0 = acc[mb][nb][2 * half];
          const int a1 = acc[mb][nb][2 * half + 1];
          float v0, v1;
          if constexpr (kResidual) {
            __nv_bfloat162* xp =
                reinterpret_cast<__nv_bfloat162*>(stage + row * L.st + 2 * n);
            const __nv_bfloat162 xv = *xp;
            v0 = __fadd_rn(__bfloat162float(xv.x),
                           __bfloat162float(__float2bfloat16_rn(
                               __fmul_rn(__int2float_rn(a0), d0))));
            v1 = __fadd_rn(__bfloat162float(xv.y),
                           __bfloat162float(__float2bfloat16_rn(
                               __fmul_rn(__int2float_rn(a1), d1))));
            __nv_bfloat162 xo;
            xo.x = __float2bfloat16_rn(v0);
            xo.y = __float2bfloat16_rn(v1);
            *xp = xo;
          } else {
            v0 = __int2float_rn(a0);
            v1 = __int2float_rn(a1);
          }
          if (codes) {
            const int q0 = code(__fmaf_rn(v0, s0, b0));
            const int q1 = code(__fmaf_rn(v1, s1, b1));
            *reinterpret_cast<uint16_t*>(
                qstage + row * (kResidual ? qst : L.st) + n) =
                static_cast<uint16_t>(q0 | (q1 << 8));
          }
        }
    }
    __syncthreads();

    // Whole rows out, coalesced.
    const int valid = p.rows - r0 < kTileRows ? p.rows - r0 : kTileRows;
    if constexpr (kResidual) {
      store_rows(reinterpret_cast<unsigned char*>(
                     p.out_x + static_cast<size_t>(r0) * p.cout),
                 stage, L.st, 2 * p.cout, 2 * p.cout, valid);
      if (p.out_q != nullptr) {
        store_rows(reinterpret_cast<unsigned char*>(
                       p.out_q + static_cast<size_t>(r0) * p.cout),
                   qstage, qst, p.cout, p.cout, valid);
      }
    } else {
      store_rows(reinterpret_cast<unsigned char*>(
                     p.out_q + static_cast<size_t>(r0) * p.cout),
                 stage, L.st, p.cout, p.cout, valid);
    }
  }
}

template <int NB, bool kResidual>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  const Layout L = layout(p.width, p.cin, kWarpsN * 8 * NB, kResidual);
  if (L.total > kMaxSmem ||
      kTileRows * ((p.cout + 15) / 16 * 16 + kPad) > L.ra * L.sa) {
    return cudaErrorInvalidValue;
  }
  // Per device: the dynamic shared memory limit raised so far, and the SMs.
  static int raised[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  auto kernel = conv3x3_int8_gemm_kernel<NB, kResidual>;
  if (raised[device] < L.total) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    raised[device] = L.total;
  }
  if (sms[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (p.rows + kTileRows - 1) / kTileRows;
  const int blocks = tiles < sms[device] ? tiles : sms[device];
  kernel<<<blocks, kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <bool kResidual>
cudaError_t launch_for_width(const Params& p, int device,
                             cudaStream_t stream) {
  if (p.cout <= kWarpsN * 8) return launch<1, kResidual>(p, device, stream);
  if (p.cout <= kWarpsN * 16) return launch<2, kResidual>(p, device, stream);
  if (p.cout <= kWarpsN * 32) return launch<4, kResidual>(p, device, stream);
  if (p.cout <= kWarpsN * 64) return launch<8, kResidual>(p, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``q`` int8 [rows, cin] and
// ``w`` int8 [cout, 9 * cin] as int8_weight_matrix lays it out; ``s``,
// ``b`` (and ``d``) float32 [cout]; all contiguous device memory, rows =
// B * height * width, cin and cout multiples of 8, cout at most 128. With
// ``x`` null it is the first conv of a block (out_q int8 [rows, cout]);
// with ``x`` bf16 [rows, cout] the second (out_x bf16 [rows, cout], and
// out_q unless null). ``device`` is the tensors' CUDA device and ``stream``
// a cudaStream_t on it. Returns the cudaError_t of switching the device,
// raising the shared memory limit or the launch; cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int azg_conv3x3_int8(const void* q, const void* w, const void* x,
                                const void* s, const void* b, const void* d,
                                void* out_q, void* out_x, int rows,
                                int height, int width, int cin, int cout,
                                int device, void* stream) {
  if (rows <= 0 || height <= 0 || width <= 0 || cin <= 0 || cin % 8 != 0 ||
      cout <= 0 || cout % 8 != 0 || cout > 128 || device < 0 ||
      device >= kMaxDevices || (x != nullptr) != (out_x != nullptr) ||
      (x == nullptr && out_q == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  azg::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.w = static_cast<const int8_t*>(w);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.s = static_cast<const float*>(s);
  p.b = static_cast<const float*>(b);
  p.d = static_cast<const float*>(d);
  p.out_q = static_cast<int8_t*>(out_q);
  p.out_x = static_cast<__nv_bfloat16*>(out_x);
  p.rows = rows;
  p.height = height;
  p.width = width;
  p.cin = cin;
  p.cout = cout;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x == nullptr
                              ? launch_for_width<false>(p, device, st)
                              : launch_for_width<true>(p, device, st);
  return static_cast<int>(err);
}
