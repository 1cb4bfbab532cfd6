// Fused int8 ResidualConvUnit for Hopper (sm_90a), kernel B18.
//
// Replaces: lseg_tpu/ops/pallas_qconv.py · fused_rcu (Pallas TPU; body
// _rcu_kernel).
//
// Input: x (N, H, W, C) bf16; the int8 3x3 kernels w1, w2 as (C, 9C), K
// ordered (row, column, input channel) (ops/qconv.py · rcu_weight); the
// folded per-channel affines d1, e1, d2, e2 (C,) fp32 (ops/qconv.py ·
// fold_bn_affine); the fp32 scalar inverse activation scales s1_inv and
// s2_inv. Output (N, H, W, C) bf16:
//   q1  = clip(rint(max(x, 0) * s1_inv), +-127)     (0 outside the image)
//   h   = float(conv3x3(q1, w1)) * d1 + e1          (exact int32; no FMA)
//   q2  = clip(rint(max(h, 0) * s2_inv), +-127), and 0 outside the image:
//         conv2's own zero padding, NOT conv1 of the zero-padded border
//   out = bf16(float(conv3x3(q2, w2)) * d2 + e2 + x)
// Both int32 sums are exact, so the result is the plain twin's bit for bit
// whatever the tiling.
//
// What bounds it on the card: at refinenet1 ((8, 120, 120, 256)) the two
// convolutions are 2 x 9 x 256 x 256 x 2 x 115,200 = 272 GOP (0.137 ms at
// 1979 TOP/s), against 118 MB of x read and out written (0.035 ms at
// 3.35 TB/s): the operations bound it.
//
// Design: the TPU kernel keeps a full-width row band in VMEM; a band of
// (8 + 4) x (120 + 2) x 256 int8 is 375 KB, beyond the 227 KB of shared
// memory a block can use. So one block takes an 8 x 16 output tile and
// keeps, in shared memory, the relu-quantized q1 of its 12 x 20 halo
// (2 pixels on every side, 60 KB at C = 256) and the requantized q2 of the
// 10 x 18 pixels that conv2 reads (45 KB): conv1 runs over that 10 x 18
// halo (1.41x its work, recomputed by the neighbouring tiles) so that h
// never leaves the SM. Each convolution is an implicit GEMM: nine shifted
// views of the staged tile are the A operand (no im2col buffer), a
// (64 output channels) x (one tap, C bytes) slice of the weight is the B
// operand, streamed from L2 with cp.async into a double buffer (the 576 KB
// kernels cannot stay resident), and mma.sync m16n8k32 s8 accumulates in
// int32. Output channels run in chunks of 64, so the int32 tile stays in
// registers (conv1: 192 rows x 64, conv2: 128 x 64); each conv1 chunk's
// epilogue requantizes into q2, and conv2's writes bf16 with the residual
// read from x. One block per SM (149 KB of shared memory at C = 256).

#include "lseg_common.cuh"

namespace {

constexpr int THREADS = 256;             // 8 warps: 4 (rows) x 2 (columns)
constexpr int TR = 8, TC = 16;           // output tile
constexpr int Q1R = TR + 4, Q1C = TC + 4;  // q1 halo tile, 12 x 20
constexpr int Q2R = TR + 2, Q2C = TC + 2;  // q2 tile, 10 x 18
constexpr int M1 = Q2R * Q2C;            // 180 conv1 output pixels
constexpr int NCH = 64;                  // output channels per chunk

__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return static_cast<uint32_t>(static_cast<int>(
             fminf(fmaxf(r, -127.0f), 127.0f))) & 0xffu;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

struct Args {
  const __nv_bfloat16* x;
  const int8_t* w1;
  const float* d1;
  const float* e1;
  const int8_t* w2;
  const float* d2;
  const float* e2;
  __nv_bfloat16* out;
  int H, W, C;
};

// Start the copy of step s's weight slice into buffer s & 1: conv s / per,
// output channels chunk * 64 .. + 63, bytes tap * C .. + C of each row.
__device__ __forceinline__ void load_b(const Args& a, int8_t* bs, int ld,
                                       int s, int per) {
  const int8_t* w = s < per ? a.w1 : a.w2;
  const int t = s % per;
  const int chunk = t / 9, tap = t % 9;
  int8_t* dst = bs + (s & 1) * NCH * ld;
  const int vec = a.C / 16;
  const long long row = 9LL * a.C;
  for (int i = threadIdx.x; i < NCH * vec; i += THREADS) {
    const int r = i / vec, c = (i % vec) * 16;
    cp_async16(dst + r * ld + c,
               w + (chunk * NCH + r) * row + tap * a.C + c);
  }
  cp_async_commit();
}

// One convolution over `per` steps (chunks x 9 taps), starting at global
// step s0: MT row tiles of 16 per warp, A rows at `rowoff` in `src` (a
// tile `src_cols` pixels wide), the epilogue called after each chunk's
// ninth tap. The next step's slice (possibly the next conv's first) is in
// flight while this one computes.
template <int MT, typename Epilogue>
__device__ __forceinline__ void conv(const Args& a, int8_t* bs, int ld,
                                     const int8_t* src, int src_cols,
                                     const int (&rowoff)[MT][2], int s0,
                                     int per, int total, int wn,
                                     Epilogue epilogue) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int s = s0; s < s0 + per; ++s) {
    if (s + 1 < total) {
      load_b(a, bs, ld, s + 1, per);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = (s - s0) % 9;
    const int tapoff = ((tap / 3) * src_cols + tap % 3) * ld;
    const int8_t* b = bs + (s & 1) * NCH * ld;
    for (int kk = 0; kk < a.C; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* p0 = src + rowoff[mt][0] + tapoff + kk + t4 * 4;
        const int8_t* p1 = src + rowoff[mt][1] + tapoff + kk + t4 * 4;
        af[mt][0] = lseg::ld_u32(p0);
        af[mt][1] = lseg::ld_u32(p1);
        af[mt][2] = lseg::ld_u32(p0 + 16);
        af[mt][3] = lseg::ld_u32(p1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* pb = b + (wn + nt * 8 + g) * ld + kk + t4 * 4;
        const uint32_t b0 = lseg::ld_u32(pb);
        const uint32_t b1 = lseg::ld_u32(pb + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          lseg::mma_s8_16832(acc[mt][nt], af[mt], b0, b1);
      }
    }
    if (tap == 8) {
      epilogue((s - s0) / 9 * NCH, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
    __syncthreads();  // the next step refills buffer s & 1
  }
}

__global__ void __launch_bounds__(THREADS, 1) fused_rcu_kernel(
    Args a, const float* __restrict__ s1_inv_p,
    const float* __restrict__ s2_inv_p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int C = a.C, H = a.H, W = a.W;
  const int ld = C + 16;  // bytes per staged pixel (conflict-free reads)
  int8_t* q1s = smem;                     // Q1R x Q1C pixels
  int8_t* q2s = q1s + Q1R * Q1C * ld;     // Q2R x Q2C pixels
  int8_t* bs = q2s + M1 * ld;             // 2 x NCH rows

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wn = (warp / 4) * 32;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int per = (C / NCH) * 9;
  const long long img = static_cast<long long>(n) * H * W;
  const float s1_inv = *s1_inv_p, s2_inv = *s2_inv_p;

  load_b(a, bs, ld, 0, per);

  // q1: relu + quantize of the 12 x 20 halo tile, zero outside the image
  const int groups = C / 8;
  for (int i = tid; i < Q1R * Q1C * groups; i += THREADS) {
    const int pix = i / groups, cg = (i % groups) * 8;
    const int rr = r0 - 2 + pix / Q1C, cc = c0 - 2 + pix % Q1C;
    uint2 codes = make_uint2(0u, 0u);
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      float v[8];
      lseg::unpack8(*reinterpret_cast<const uint4*>(
                        a.x + (img + rr * W + cc) * C + cg), v);
      uint32_t q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = code(fmaxf(v[k], 0.0f), s1_inv);
      codes.x = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
      codes.y = q[4] | (q[5] << 8) | (q[6] << 16) | (q[7] << 24);
    }
    *reinterpret_cast<uint2*>(q1s + pix * ld + cg) = codes;
  }

  // conv1 over the 10 x 18 q2 pixels (180 rows, padded to 192 with
  // copies of the last pixel, whose results are dropped)
  {
    const int wm = (warp % 4) * 48;
    int rowoff[3][2];
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(wm + mt * 16 + g + 8 * h, M1 - 1);
        rowoff[mt][h] = ((m / Q2C) * Q1C + m % Q2C) * ld;
      }
    conv<3>(a, bs, ld, q1s, Q1C, rowoff, 0, per, 2 * per, wn,
            [&](int ch, int (&acc)[3][4][4]) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int col = ch + wn + nt * 8 + 2 * t4;
                const float da = a.d1[col], db = a.d1[col + 1];
                const float ea = a.e1[col], eb = a.e1[col + 1];
#pragma unroll
                for (int mt = 0; mt < 3; ++mt)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int m = wm + mt * 16 + g + 8 * h;
                    if (m >= M1) continue;
                    const int rr = r0 - 1 + m / Q2C, cc = c0 - 1 + m % Q2C;
                    uint32_t q = 0u;
                    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
                      const float h0 = __fadd_rn(__fmul_rn(__int2float_rn(
                          acc[mt][nt][2 * h]), da), ea);
                      const float h1 = __fadd_rn(__fmul_rn(__int2float_rn(
                          acc[mt][nt][2 * h + 1]), db), eb);
                      q = code(fmaxf(h0, 0.0f), s2_inv) |
                          (code(fmaxf(h1, 0.0f), s2_inv) << 8);
                    }
                    *reinterpret_cast<uint16_t*>(q2s + m * ld + col) =
                        static_cast<uint16_t>(q);
                  }
              }
            });
  }

  // conv2 over the 8 x 16 output pixels, + the residual
  {
    const int wm = (warp % 4) * 32;
    int rowoff[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 16 + g + 8 * h;
        rowoff[mt][h] = ((m / TC) * Q2C + m % TC) * ld;
      }
    conv<2>(a, bs, ld, q2s, Q2C, rowoff, per, per, 2 * per, wn,
            [&](int ch, int (&acc)[2][4][4]) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int col = ch + wn + nt * 8 + 2 * t4;
                const float da = a.d2[col], db = a.d2[col + 1];
                const float ea = a.e2[col], eb = a.e2[col + 1];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int m = wm + mt * 16 + g + 8 * h;
                    const int rr = r0 + m / TC, cc = c0 + m % TC;
                    if (rr >= H || cc >= W) continue;
                    const long long off = (img + rr * W + cc) * C + col;
                    const float2 res = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(a.x + off));
                    const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(
                        acc[mt][nt][2 * h]), da), ea);
                    const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(
                        acc[mt][nt][2 * h + 1]), db), eb);
                    *reinterpret_cast<__nv_bfloat162*>(a.out + off) =
                        __floats2bfloat162_rn(__fadd_rn(y0, res.x),
                                              __fadd_rn(y1, res.y));
                  }
              }
            });
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Requires
// C % 64 == 0, C <= 256 and 16-byte aligned tensors (checked by the
// wrapper).
extern "C" int lseg_fused_rcu(const void* x, const void* w1, const void* d1,
                              const void* e1, const void* s1_inv,
                              const void* w2, const void* d2, const void* e2,
                              const void* s2_inv, void* out, int n, int h,
                              int w, int c, void* stream) {
  const int smem = (Q1R * Q1C + M1 + 2 * NCH) * (c + 16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_rcu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const int8_t*>(w1), static_cast<const float*>(d1),
         static_cast<const float*>(e1), static_cast<const int8_t*>(w2),
         static_cast<const float*>(d2), static_cast<const float*>(e2),
         static_cast<__nv_bfloat16*>(out), h, w, c};
  const dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, n);
  fused_rcu_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(s1_inv), static_cast<const float*>(s2_inv));
  return static_cast<int>(cudaGetLastError());
}
