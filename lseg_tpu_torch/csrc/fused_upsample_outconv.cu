// Fused decoder tail for Hopper (sm_90a), kernel B19: x2 align-corners
// bilinear upsample, activation quantize and the int8 1x1 out_conv, with a
// bf16 or an int8 result.
//
// Replaces: lseg_tpu/ops/pallas_decoder.py · fused_upsample_outconv
// (Pallas TPU; body _tail_kernel).
//
// Input: x (N, H, W, C) bf16; the H and W tap tables th (3, 2H) and
// tw (3, 2W) fp32 (first source index, its bf16-rounded tap, the next
// bf16-rounded tap; ops/decoder.py · interp_taps); the int8 kernel
// wq (Co, C); sc = s_in * sw and the bias b (Co,) fp32; the fp32 scalars
// 1 / s_in and 1 / out_scale. Output (N, 2H, 2W, Co), bf16, or int8 codes
// on the grid out_scale (the fused head's input, at refinenet1).
//
// Per output pixel (jo, io), as the TPU kernel and the plain twin:
//   hb = bf16(x[ho] * w0 + x[ho + 1] * w1)   at the source columns wo and
//                                            wo + 1 (each one fp32 sum of
//                                            two exact products)
//   ub = bf16(hb[wo] * v0 + hb[wo + 1] * v1)
//   q  = clip(rint(ub * (1 / s_in)), +-127)
//   y  = float(q . wq) * sc + b             (exact int32 sum; no FMA)
//   out = bf16(y)  or  clip(rint(y * (1 / out_scale)), +-127)
// A second tap that would leave the image is 0 and reads the last row or
// column. The result is the plain twin's bit for bit.
//
// What bounds it on the card: at refinenet1's hand-off ((8, 120, 120, 256)
// -> (8, 240, 240, 256) int8) the 1x1 product is 2 x 460,800 x 256 x 256
// = 60.4 GOP (0.031 ms at 1979 TOP/s), against 59 MB of x read and 118 MB
// of codes written (0.053 ms at 3.35 TB/s): the bytes bound it; at
// refinenet2 ((8, 60, 60, 256) -> bf16 (8, 120, 120, 256)) 74 MB, 0.022 ms.
//
// Design: the upsampled (N, 2H, 2W, C) tensor never reaches device memory.
// A persistent block stages the whole (Co, C) weight in shared memory once
// (64 KB at 256 x 256) and walks tiles of 128 consecutive output pixels:
// it blends and quantizes the tile's (128, C) codes straight into shared
// memory (a warp reads 512 contiguous bytes of each of the four source
// pixels; neighbouring pixels share source rows, which stay in L1/L2),
// then runs the (128, C) x (C, Co) product with mma.sync m16n8k32 s8 in
// two passes of 128 output channels and writes the epilogue. Two blocks fit
// on an SM.

#include "lseg_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int BM = 128;       // output pixels per tile
constexpr int BN = 128;       // output channels per pass

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one fp32 sum of two products, rounded once to bf16
__device__ __forceinline__ float blend(float a, float wa, float b, float wb) {
  return bf16_round(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)));
}

__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return static_cast<uint32_t>(static_cast<int>(
             fminf(fmaxf(r, -127.0f), 127.0f))) & 0xffu;
}

__global__ void __launch_bounds__(THREADS) upsample_outconv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ th,
    const float* __restrict__ tw, const int8_t* __restrict__ wq,
    const float* __restrict__ sc, const float* __restrict__ bias,
    const float* __restrict__ inv_in_p, const float* __restrict__ inv_out_p,
    void* __restrict__ out, int N, int H, int W, int C, int Co,
    int out_int8) {
  extern __shared__ __align__(16) int8_t smem[];
  const int ld = C + 16;  // bytes per staged row (conflict-free fragments)
  int8_t* Ws = smem;                  // (Co, C) weight
  int8_t* As = smem + Co * ld;        // (BM, C) codes of one tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wm = (warp % 2) * 64;
  const int wn = (warp / 2) * 32;
  const int H2 = 2 * H, W2 = 2 * W;
  const int P = N * H2 * W2;
  const int tiles = (P + BM - 1) / BM;
  const float inv_in = *inv_in_p;
  const float inv_out = *inv_out_p;
  const int vec = C / 16;

  for (int i = tid; i < Co * vec; i += THREADS) {
    const int r = i / vec, c = (i % vec) * 16;
    *reinterpret_cast<uint4*>(Ws + r * ld + c) =
        *reinterpret_cast<const uint4*>(wq + static_cast<long long>(r) * C +
                                        c);
  }

  const int groups = C / 8;  // 8 channels (16 bytes of bf16) per item
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * BM;
    for (int i = tid; i < BM * groups; i += THREADS) {
      const int pl = i / groups, cg = (i % groups) * 8;
      const int p = p0 + pl;
      uint2 codes = make_uint2(0u, 0u);
      if (p < P) {
        const int io = p % W2;
        const int jo = (p / W2) % H2;
        const int n = p / (W2 * H2);
        const int ho = static_cast<int>(th[jo]);
        const float w0 = th[H2 + jo], w1 = th[2 * H2 + jo];
        const int hi = min(ho + 1, H - 1);
        const int wo = static_cast<int>(tw[io]);
        const float v0 = tw[W2 + io], v1 = tw[2 * W2 + io];
        const int wi = min(wo + 1, W - 1);
        const __nv_bfloat16* base =
            x + static_cast<long long>(n) * H * W * C + cg;
        float a[8], b[8], c[8], d[8];
        lseg::unpack8(*reinterpret_cast<const uint4*>(
                          base + static_cast<long long>(ho * W + wo) * C), a);
        lseg::unpack8(*reinterpret_cast<const uint4*>(
                          base + static_cast<long long>(ho * W + wi) * C), b);
        lseg::unpack8(*reinterpret_cast<const uint4*>(
                          base + static_cast<long long>(hi * W + wo) * C), c);
        lseg::unpack8(*reinterpret_cast<const uint4*>(
                          base + static_cast<long long>(hi * W + wi) * C), d);
        uint32_t q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float hb0 = blend(a[k], w0, c[k], w1);  // column wo
          const float hb1 = blend(b[k], w0, d[k], w1);  // column wo + 1
          q[k] = code(blend(hb0, v0, hb1, v1), inv_in);
        }
        codes.x = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
        codes.y = q[4] | (q[5] << 8) | (q[6] << 16) | (q[7] << 24);
      }
      *reinterpret_cast<uint2*>(As + pl * ld + cg) = codes;
    }
    __syncthreads();

    for (int n0 = 0; n0 < Co; n0 += BN) {
      int acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
      for (int kk = 0; kk < C; kk += 32) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int8_t* pa = As + (wm + mt * 16 + g) * ld + kk + t4 * 4;
          af[mt][0] = lseg::ld_u32(pa);
          af[mt][1] = lseg::ld_u32(pa + 8 * ld);
          af[mt][2] = lseg::ld_u32(pa + 16);
          af[mt][3] = lseg::ld_u32(pa + 8 * ld + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* pb = Ws + (n0 + wn + nt * 8 + g) * ld + kk + t4 * 4;
          const uint32_t b0 = lseg::ld_u32(pb);
          const uint32_t b1 = lseg::ld_u32(pb + 16);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            lseg::mma_s8_16832(acc[mt][nt], af[mt], b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t4;
        const float s0 = sc[col], s1 = sc[col + 1];
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = p0 + wm + mt * 16 + g + 8 * half;
            if (p >= P) continue;
            const float y0 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), s0), b0);
            const float y1 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), s1), b1);
            const long long off = static_cast<long long>(p) * Co + col;
            if (out_int8) {
              *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + off) =
                  static_cast<uint16_t>(code(y0, inv_out) |
                                        (code(y1, inv_out) << 8));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(out) + off) =
                  __floats2bfloat162_rn(y0, y1);
            }
          }
        }
      }
    }
    __syncthreads();  // the next tile rewrites As
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Requires
// C % 32 == 0, C <= 256, Co % 128 == 0, H, W >= 2 and 16-byte aligned
// tensors (checked by the wrapper).
extern "C" int lseg_fused_upsample_outconv(
    const void* x, const void* th, const void* tw, const void* wq,
    const void* sc, const void* bias, const void* inv_in,
    const void* inv_out, void* out, int n, int h, int w, int c, int co,
    int out_int8, void* stream) {
  const int smem = (co + BM) * (c + 16);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_outconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, upsample_outconv_kernel, THREADS, smem);
  const int tiles = (n * 4 * h * w + BM - 1) / BM;
  const int grid = min(tiles, max(per_sm, 1) * max(sms, 1));
  upsample_outconv_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(th),
      static_cast<const float*>(tw), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sc), static_cast<const float*>(bias),
      static_cast<const float*>(inv_in), static_cast<const float*>(inv_out),
      out, n, h, w, c, co, out_int8);
  return static_cast<int>(cudaGetLastError());
}
