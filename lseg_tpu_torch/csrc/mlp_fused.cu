// Fused int8 transformer MLP for Hopper (sm_90a), kernel B16.
//
// Replaces: lseg_tpu/ops/pallas_mlp.py · mlp_fused (Pallas TPU; body
// _kernel).
//
// Input: the per-row int8 codes xq (M, D) of the LayerNorm-2 output and
// their fp32 row scales sx (M,), the bf16 residual stream (M, D), the int8
// fc1 weight (H, D) and fc2 weight (D, H) (the port's (out, in) storage),
// their fp32 per-output-channel scales and biases. Output: resid + mlp(x),
// (M, D) bf16. M = N * T rows; any M.
//
// Rounding points, in order, as in the TPU kernel:
//   1. acc1 = xq . w1^T exact in int32; h = ((acc1 * sx) * s1) + b1 in fp32
//      (no FMA contraction);
//   2. the tanh GELU of h in fp32 (tanhf, not tanh.approx), with no bf16
//      rounding before it;
//   3. per row, sh = max(max|gelu(h)| over all H, 1e-8) / 127 and codes
//      round-half-even(g / sh) clipped to +-127, a true IEEE division;
//   4. acc2 = hq . w2^T exact in int32; y = ((acc2 * sh) * s2) + b2;
//   5. out = bf16(y + resid) in fp32.
//
// What bounds it on the card: at the flagship (8 x 901 rows, D = 1024,
// H = 4096) the two int8 products are 2 x 30.2 G MAC (121 GOP, ~0.061 ms
// at 1979 TOP/s) against ~45 MB of codes, weights, residual and output
// (~0.013 ms at 3.35 TB/s): the operations bound it.
//
// Design: the per-row requantize needs each row's amax over all 4096
// hidden values before fc2 can start. The TPU kernel keeps a (256, 4096)
// fp32 hidden tile in VMEM; on an SM a 64-row fp32 tile is 1 MB and even a
// 16-row one 256 KB, beyond the 227 KB of shared memory a block can use,
// and holding it in bf16 would change the rounding. So the op is a chain
// of three launches on one stream, exact to the TPU kernel:
//   (a) fc1 on the shared int8 GEMM tile (qkv_int8_gemm.cuh) with the
//       dequant + bias + GELU epilogue, which reduces each row's amax over
//       the block's 128 columns into pm (M, H / 128) fp32;
//   (b) fc1 again with the same epilogue, giving the same fp32 values,
//       which takes sh from pm and writes the int8 hidden codes hq (M, H)
//       and sh (M,);
//   (c) fc2 over the codes with the (acc * sh) * s2 + b2 + resid epilogue.
// Unlike the TPU kernel, the int8 hidden codes pass through device memory
// (29.5 MB written and read at the flagship; the fp32 hidden never does),
// and fc1 is computed twice (a second 60.5 GOP product): keeping the
// hidden on chip needs <= 8-row tiles or a cluster-wide amax, later work.

#include "qkv_int8_gemm.cuh"

namespace {

namespace gemm = lseg::qkv_gemm;

// tanh GELU as PyTorch writes it, each step rounded on its own
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// (a) with kQuantize false, (b) with it true. pm (M, H / 128) holds the
// per-tile row maxima; in (b) the x == 0 column of blocks also writes sh.
template <bool kQuantize>
__global__ void __launch_bounds__(gemm::THREADS) fc1_gelu_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const int8_t* __restrict__ w1, const float* __restrict__ s1,
    const float* __restrict__ b1, float* __restrict__ pm,
    int8_t* __restrict__ hq, float* __restrict__ sh_out, int M, int H,
    int D) {
  __shared__ __align__(16) int8_t As[gemm::BM * gemm::LD];
  __shared__ __align__(16) int8_t Bs[gemm::BN * gemm::LD];
  __shared__ float red[4][gemm::BM];  // (column warp, row) maxima
  __shared__ float sh_s[gemm::BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.y * gemm::BM;
  const int n0 = blockIdx.x * gemm::BN;
  const int wm = (warp % 2) * 64;
  const int wn = (warp / 2) * 32;
  const int tiles = H / gemm::BN;

  if (kQuantize && tid < gemm::BM && m0 + tid < M) {
    const float* p = pm + static_cast<long long>(m0 + tid) * tiles;
    float mx = 0.0f;
    for (int j = 0; j < tiles; ++j) mx = fmaxf(mx, p[j]);
    const float sh = __fdiv_rn(fmaxf(mx, 1e-8f), 127.0f);
    sh_s[tid] = sh;
    if (blockIdx.x == 0) sh_out[m0 + tid] = sh;
  }  // the mainloop's barriers publish sh_s

  gemm::Acc acc;
  gemm::zero(acc);
  gemm::mainloop(xq, w1, M, D, m0, n0, 0, D, As, Bs, acc);

  float rmax[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) rmax[mt][0] = rmax[mt][1] = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * t4;
    const float sc0 = s1[c], sc1 = s1[c + 1];
    const float bb0 = b1[c], bb1 = b1[c + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = wm + mt * 16 + g + 8 * half;
        const int r = m0 + lr;
        const float sr = r < M ? sx[r] : 0.0f;
        const float v0 = gelu_tanh(__fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sr),
                      sc0), bb0));
        const float v1 = gelu_tanh(__fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]),
                                sr), sc1), bb1));
        if (kQuantize) {
          if (r < M) {
            const float s = sh_s[lr];
            const uint16_t codes = static_cast<uint16_t>(
                (static_cast<uint32_t>(lseg::quantize_code(v0, s)) & 0xffu) |
                ((static_cast<uint32_t>(lseg::quantize_code(v1, s)) & 0xffu)
                 << 8));
            *reinterpret_cast<uint16_t*>(
                hq + static_cast<long long>(r) * H + c) = codes;
          }
        } else {
          rmax[mt][half] = fmaxf(rmax[mt][half],
                                 fmaxf(fabsf(v0), fabsf(v1)));
        }
      }
    }
  }
  if (kQuantize) return;

  // row maxima over the block's 128 columns: the 4 lanes of a row, then
  // the 4 column warps
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = rmax[mt][half];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t4 == 0) red[warp / 2][wm + mt * 16 + g + 8 * half] = v;
    }
  }
  __syncthreads();
  if (tid < gemm::BM && m0 + tid < M) {
    const float v = fmaxf(fmaxf(red[0][tid], red[1][tid]),
                          fmaxf(red[2][tid], red[3][tid]));
    pm[static_cast<long long>(m0 + tid) * tiles + blockIdx.x] = v;
  }
}

// (c) out = bf16(((acc2 * sh) * s2 + b2) + resid)
__global__ void __launch_bounds__(gemm::THREADS) fc2_residual_kernel(
    const int8_t* __restrict__ hq, const float* __restrict__ sh,
    const int8_t* __restrict__ w2, const float* __restrict__ s2,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ resid,
    __nv_bfloat16* __restrict__ out, int M, int D, int H) {
  __shared__ __align__(16) int8_t As[gemm::BM * gemm::LD];
  __shared__ __align__(16) int8_t Bs[gemm::BN * gemm::LD];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.y * gemm::BM;
  const int n0 = blockIdx.x * gemm::BN;
  const int wm = (warp % 2) * 64;
  const int wn = (warp / 2) * 32;

  gemm::Acc acc;
  gemm::zero(acc);
  gemm::mainloop(hq, w2, M, H, m0, n0, 0, H, As, Bs, acc);

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * t4;
    const float sc0 = s2[c], sc1 = s2[c + 1];
    const float bb0 = b2[c], bb1 = b2[c + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + 8 * half;
        if (r >= M) continue;
        const float sr = sh[r];
        const long long off = static_cast<long long>(r) * D + c;
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(resid + off));
        const float y0 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sr),
                      sc0), bb0);
        const float y1 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]),
                                sr), sc1), bb1);
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(__fadd_rn(y0, res.x), __fadd_rn(y1, res.y));
      }
    }
  }
}

}  // namespace

// Launch the three-step chain on `stream`; returns the first non-zero
// cudaGetLastError() (0 on success). pm (M, H / 128) fp32, hq (M, H) int8
// and sh (M,) fp32 are scratch buffers allocated by the wrapper. Requires
// D % 128 == 0, H % 128 == 0, 16-byte aligned tensors (checked by the
// wrapper).
extern "C" int lseg_mlp_fused(const void* xq, const void* sx,
                              const void* resid, const void* w1,
                              const void* s1, const void* b1, const void* w2,
                              const void* s2, const void* b2, void* pm,
                              void* hq, void* sh, void* out, int m, int dim,
                              int hidden, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1(hidden / gemm::BN, (m + gemm::BM - 1) / gemm::BM);
  const auto* xq8 = static_cast<const int8_t*>(xq);
  const auto* sxf = static_cast<const float*>(sx);
  const auto* w18 = static_cast<const int8_t*>(w1);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* b1f = static_cast<const float*>(b1);
  auto* pmf = static_cast<float*>(pm);
  auto* hq8 = static_cast<int8_t*>(hq);
  auto* shf = static_cast<float*>(sh);
  fc1_gelu_kernel<false><<<grid1, gemm::THREADS, 0, st>>>(
      xq8, sxf, w18, s1f, b1f, pmf, hq8, shf, m, hidden, dim);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  fc1_gelu_kernel<true><<<grid1, gemm::THREADS, 0, st>>>(
      xq8, sxf, w18, s1f, b1f, pmf, hq8, shf, m, hidden, dim);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid2(dim / gemm::BN, (m + gemm::BM - 1) / gemm::BM);
  fc2_residual_kernel<<<grid2, gemm::THREADS, 0, st>>>(
      hq8, shf, static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), m, dim, hidden);
  return static_cast<int>(cudaGetLastError());
}
