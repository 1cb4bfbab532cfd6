// Fused int8 head1 projection + image-text correlation for Hopper
// (sm_90a), kernel B4.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · head1_correlate_fused
// (Pallas TPU; body _head1_kernel).
//
// Input: the int8 path1 codes xq (M, C) (M = N*H*W pixels), head1's int8
// 1x1 kernel w (E, C) (the port's (out, in) storage, the column-major B
// operand), sc (E,) = sx * s1 (activation scale times the per-channel
// weight scales, one fp32 product taken by the wrapper), the fp32 bias
// (E,), and the text matrix tn (K, E) bf16, already L2-normalised and
// multiplied by the temperature. Output: (M, K) bf16 logits, K unpadded.
//
// Rounding points, as in the TPU kernel:
//   e = acc * sc + b      (int32 acc, exact; fp32, no FMA contraction)
//   inv = rsqrt(max(sum(e^2), 1e-24))            (only when `normalize`)
//   out = bf16((bf16(e) . tn^T) [* inv])         (fp32 accumulation)
// The e^2 sum and the dot products are taken in another order than the
// plain version's.
//
// What bounds it on the card: at the lowres flagship shape (8, 120, 120,
// 256) -> K = 150 the head1 product is 15.1 G int8 MAC and the text
// product 8.8 G bf16 MAC, against 29.5 MB of codes in and 34.6 MB of
// logits out. Design: the (M, 512) embedding map never reaches device
// memory, which is the TPU kernel's reason to exist (it would cost a
// 118 MB write and two reads at H/4, 472 MB at H/2). One 256-thread block
// per 64-pixel tile: the tile's codes sit in shared memory; head1's
// weight is staged 128 output channels at a time and multiplied on
// mma.sync m16n8k32 s8 into int32; the dequant epilogue writes bf16(e)
// into a (64, E) shared tile (66 KB at E = 512) and keeps the fp32 row
// sums of e^2; the text matrix is then staged 32 labels at a time (rows
// past K zero-filled) and multiplied on mma.sync m16n8k16 bf16 into fp32;
// only columns k < K are written. 1800 blocks at the flagship.

#include "lseg_common.cuh"

namespace {

using lseg::ld_u32;

constexpr int BM = 64;         // pixels per block
constexpr int THREADS = 256;   // 8 warps: 4 (rows) x 2 (columns)
constexpr int ECH = 128;       // head1 output channels per staged chunk
constexpr int KCH = 32;        // labels per staged chunk

struct Layout {
  int ldx;       // bytes per int8 row (codes and weight chunk)
  int lde;       // bf16 elements per e / text row
  size_t stage;  // bytes of the staging buffer
  size_t total;  // bytes of dynamic shared memory
};

__host__ __device__ inline Layout layout(int c, int e) {
  Layout l;
  l.ldx = c + 16;
  l.lde = e + 8;
  const size_t w_bytes = static_cast<size_t>(ECH) * l.ldx;
  const size_t t_bytes = static_cast<size_t>(KCH) * l.lde * 2;
  l.stage = w_bytes > t_bytes ? w_bytes : t_bytes;
  l.total = static_cast<size_t>(BM) * l.ldx +
            static_cast<size_t>(BM) * l.lde * 2 + l.stage + 2 * BM * 4;
  return l;
}

__global__ void __launch_bounds__(THREADS) head1_correlate_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
    const float* __restrict__ sc, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ tn, __nv_bfloat16* __restrict__ out,
    int M, int C, int E, int K, int normalize) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(C, E);
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);                  // BM x ldx
  __nv_bfloat16* Es =
      reinterpret_cast<__nv_bfloat16*>(smem + BM * L.ldx);        // BM x lde
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(Es + BM * L.lde);
  float* ssq = reinterpret_cast<float*>(stage + L.stage);        // 2 x BM

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int wr = (warp % 4) * 16;  // this warp's 16 rows
  const int wc = warp / 4;         // and its column half

  // the tile's codes, rows past M zero-filled
  const int xchunks = C / 16;
  for (int i = tid; i < BM * xchunks; i += THREADS) {
    const int r = i / xchunks;
    const int c = (i % xchunks) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) {
      v = *reinterpret_cast<const uint4*>(
          xq + static_cast<long long>(m0 + r) * C + c);
    }
    *reinterpret_cast<uint4*>(Xs + r * L.ldx + c) = v;
  }

  // head1: e = (xq . w^T) * sc + b, chunk by chunk of 128 channels
  const int8_t* Ws = reinterpret_cast<const int8_t*>(stage);
  float ss[2] = {0.0f, 0.0f};
  for (int e0 = 0; e0 < E; e0 += ECH) {
    __syncthreads();  // previous chunk's readers are done
    for (int i = tid; i < ECH * xchunks; i += THREADS) {
      const int r = i / xchunks;
      const int c = (i % xchunks) * 16;
      *reinterpret_cast<uint4*>(stage + r * L.ldx + c) =
          *reinterpret_cast<const uint4*>(
              w + static_cast<long long>(e0 + r) * C + c);
    }
    __syncthreads();
    int acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    for (int kk = 0; kk < C; kk += 32) {
      const int8_t* p = Xs + (wr + g) * L.ldx + kk + t4 * 4;
      const uint32_t af[4] = {ld_u32(p), ld_u32(p + 8 * L.ldx),
                              ld_u32(p + 16), ld_u32(p + 8 * L.ldx + 16)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* q = Ws + (wc * 64 + nt * 8 + g) * L.ldx + kk + t4 * 4;
        lseg::mma_s8_16832(acc[nt], af, ld_u32(q), ld_u32(q + 16));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = e0 + wc * 64 + nt * 8 + 2 * t4;
      const float s0 = sc[col], s1 = sc[col + 1];
      const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[nt][2 * half]), s0), c0);
        const float v1 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[nt][2 * half + 1]), s1), c1);
        ss[half] += v0 * v0 + v1 * v1;
        *reinterpret_cast<__nv_bfloat162*>(
            Es + (wr + g + 8 * half) * L.lde + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    ss[half] += __shfl_xor_sync(0xffffffffu, ss[half], 1);
    ss[half] += __shfl_xor_sync(0xffffffffu, ss[half], 2);
    if (t4 == 0) ssq[wc * BM + wr + g + 8 * half] = ss[half];
  }

  // correlation: out = bf16(e) . tn^T, 32 labels at a time
  const __nv_bfloat16* Ts = reinterpret_cast<const __nv_bfloat16*>(stage);
  const int tchunks = E / 8;
  for (int k0 = 0; k0 < K; k0 += KCH) {
    __syncthreads();  // Es / ssq complete; previous text chunk consumed
    for (int i = tid; i < KCH * tchunks; i += THREADS) {
      const int r = i / tchunks;
      const int c = (i % tchunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < K) {
        v = *reinterpret_cast<const uint4*>(
            tn + static_cast<long long>(k0 + r) * E + c);
      }
      *reinterpret_cast<uint4*>(stage + (r * L.lde + c) * 2) = v;
    }
    __syncthreads();
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int kk = 0; kk < E; kk += 16) {
      const __nv_bfloat16* p = Es + (wr + g) * L.lde + kk + 2 * t4;
      const uint32_t af[4] = {ld_u32(p), ld_u32(p + 8 * L.lde), ld_u32(p + 8),
                              ld_u32(p + 8 * L.lde + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* q =
            Ts + (wc * 16 + j * 8 + g) * L.lde + kk + 2 * t4;
        lseg::mma_bf16_16816(acc[j], af, ld_u32(q), ld_u32(q + 8));
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wr + g + 8 * half;
      const int row = m0 + lr;
      if (row >= M) continue;
      const float inv =
          normalize ? rsqrtf(fmaxf(ssq[lr] + ssq[BM + lr], 1e-24f)) : 1.0f;
      __nv_bfloat16* op = out + static_cast<long long>(row) * K;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + wc * 16 + j * 8 + 2 * t4;
        float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
        if (normalize) {
          v0 = __fmul_rn(v0, inv);
          v1 = __fmul_rn(v1, inv);
        }
        if (k < K) op[k] = __float2bfloat16_rn(v0);
        if (k + 1 < K) op[k + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires c % 32 == 0, e % 128 == 0, k >= 1, 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_head1_correlate(const void* xq, const void* w,
                                    const void* sc, const void* b1,
                                    const void* tn, void* out, int m, int c,
                                    int e, int k, int normalize,
                                    void* stream) {
  const size_t smem = layout(c, e).total;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      head1_correlate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  const dim3 grid((m + BM - 1) / BM);
  head1_correlate_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sc), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(tn), static_cast<__nv_bfloat16*>(out),
      m, c, e, k, normalize);
  return static_cast<int>(cudaGetLastError());
}
