// LayerNorm + int8 qkv projection + flash attention + int8 output for
// Hopper (sm_90a), kernel B2.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_ln_qkv_fused_q8
// (Pallas TPU; arithmetic in _kernel_ln_qkv_q8, _dequant_qkv_parts and
// _pair_softmax_attention).
//
// Input: the raw bf16 residual stream x (N, T, D), the fp32 LayerNorm
// scale and bias (D,), the int8 qkv weight (3D, D) (the port's (out, in)
// storage, which is the column-major B operand of the product), its fp32
// per-output-channel scales and bias (3D,). Output: the attention output
// per-row int8 quantized, codes (N, T, D) and fp32 scales (N, T), the
// operands of the int8 output projection. Keys at or past `valid_len` are
// masked out of the softmax.
//
// Rounding points, in order, as in the TPU kernel:
//   1. LN1 in fp32 (eps) and a per-row int8 quantize (ln_quantize.cuh);
//   2. the int8 qkv product accumulated exactly in int32, then
//      ((acc * sx) * sw) + b in fp32 (no FMA contraction), cast to bf16;
//   3. per head, fp32 scores times `scale`, exp(s - m) in fp32, P cast to
//      bf16 for P.V with fp32 accumulation, divided by the fp32 row sum,
//      cast to bf16;
//   4. the bf16 (T, D) output quantized per row: s = max(max|o|, 1e-8) /
//      127, codes round-half-even(o / s) clipped to +-127.
// Two differences, as in B6: the online softmax rounds P relative to the
// running row maximum (rescaling when it grows), where the TPU kernel uses
// the maximum of the whole row; and the exponent is ex2.approx of one FMA.
//
// qk_int8 (the TPU kernel's `qk_int8` branch of _pair_softmax_attention,
// attn_variant 'i8qk'): in step 3 each head's bf16 q and k rows are
// re-quantized per row, s = max(max|x|, 1e-8) / 127 (an IEEE division),
// codes round-half-even(x / s) clipped to +-127; Q.K^T is an exact int32
// sum of int8 products, and each score is float(acc) * ((sq * scale) *
// sk_j), rounded in that order, before the key mask. The rest of step 3
// and step 4 are unchanged, with the same two differences. Its third
// launch is `flash_q8_i8qk_cluster_kernel`: the same cluster block, whose
// warpgroups quantize the Q tile once and each K tile as it lands from
// TMA, in place in shared memory (the 128-byte swizzle kept; a row's 64
// codes in two 32-byte k-steps), and run Q.K^T as two s8 wgmma m64n64k32
// (IGMMA) a key tile; P.V stays a bf16 wgmma. Its bound at the flagship:
// the qkv product as above, Q.K^T's 13.3 G int8 operations (0.0067 ms at
// 1979 TOP/s) and P.V's 13.3 GFLOP (0.0134 ms at 989 TFLOP/s).
//
// What bounds it on the card: at the flagship (8, 901, 1024) with 16
// heads, the 8 * 901 * 1024 * 3072 = 22.7 G int8 MAC of the qkv product
// (0.023 ms at 1979 TOP/s) and the 2 * 2 * 901^2 * 64 FLOP per head and
// image of the attention (26.6 GFLOP, 0.027 ms at 989 TFLOP/s), plus one
// exp per score. Design: a Hopper SM cannot hold the TPU kernel's whole
// (T, D) int8 block per image beside (T, T) scores, so the op is a chain
// of three launches on one stream:
//   (a) LN + row quantize (B3's routine, ln_quantize.cuh) -> xq (N*T, D)
//       int8, sx (N*T,);
//   (b) the s8 wgmma + TMA qkv GEMM with its dequant epilogue
//       (qkv_wgmma.cuh, shared with B8, B9 and B15) -> bf16 qkv (N, T, 3D);
//   (c) the head-pair attention of pair_attention.cuh in its row mode: a
//       block per (64 query rows, head pair, image), two warpgroups on the
//       wgmma + TMA interior of B6, launched as a thread-block cluster of
//       the D / 128 pairs of a row tile, which exchange their slices' row
//       maxima through distributed shared memory so that each CTA writes
//       its own 128 code columns with the row's exact scale. 8 x 15 x 8 =
//       960 blocks at the flagship.
// Unlike the TPU kernel, xq and the bf16 qkv tensor travel through device
// memory between the launches (7.4 MB and 44 MB at the flagship): the
// lead for a fused redesign.

#include "ln_quantize.cuh"
#include "pair_attention.cuh"
#include "qkv_wgmma.cuh"

namespace {

namespace pa = lseg::pair_attn;

__global__ void __launch_bounds__(pa::THREADS, 2) flash_q8_cluster_kernel(
    const __grid_constant__ CUtensorMap map, int8_t* __restrict__ oq,
    float* __restrict__ os, int T, int D, int valid_len, float scale) {
  pa::run<true>(map, oq, os, T, D, valid_len, scale);
}

// the int8 Q.K^T mode (qk_int8)
__global__ void __launch_bounds__(pa::THREADS, 2)
    flash_q8_i8qk_cluster_kernel(const __grid_constant__ CUtensorMap map,
                                 int8_t* __restrict__ oq,
                                 float* __restrict__ os, int T, int D,
                                 int valid_len, float scale) {
  pa::run<true, true>(map, oq, os, T, D, valid_len, scale);
}

// The cluster launch of the third step (QK8: the int8 Q.K^T mode) over
// the bf16 qkv.
template <bool QK8>
int launch_attention(const void* qkv, void* oq, void* os, int n, int t,
                     int dim, int valid_len, float scale, cudaStream_t st) {
  const auto kernel =
      QK8 ? flash_q8_i8qk_cluster_kernel : flash_q8_cluster_kernel;
  const int pairs = dim / pa::PW;
  static const int attr = lseg::wg::allow_smem(kernel, pa::SMEM);
  if (attr != 0) return attr;
  CUtensorMap map;
  const int rc = lseg::wg::make_map(&map, qkv, 3 * dim, t, n);
  if (rc != 0) return rc;
  lseg::cluster::Launch l(dim3(pairs, (t + pa::BQ - 1) / pa::BQ, n),
                          pa::THREADS, pa::SMEM, pairs, st);
  const cudaError_t e =
      cudaLaunchKernelEx(&l.cfg, kernel, map, static_cast<int8_t*>(oq),
                         static_cast<float*>(os), t, dim, valid_len, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the three-step chain on `stream`; returns the first non-zero
// CUDA error code (0 on success): a cluster launch the card refuses
// returns it, with no other route. xq (N*T, D) int8, sx (N*T,) fp32 and
// qkv (N*T, 3D) bf16 are scratch buffers allocated by the wrapper.
// Requires dim % 128 == 0, 128 <= dim <= 1024, 1 <= valid_len <= t,
// 16-byte aligned tensors (checked by the wrapper). qk_int8 != 0 takes
// the int8 Q.K^T mode.
extern "C" int lseg_flash_attention_ln_qkv_q8(
    const void* x, const void* ln_g, const void* ln_b, const void* wq,
    const void* sw, const void* bias, void* xq, void* sx, void* qkv,
    void* oq, void* os, int n, int t, int dim, int valid_len, int qk_int8,
    float scale, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n * t;
  const int pairs = dim / pa::PW;
  if (dim % pa::PW != 0 || pairs > pa::MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = lseg::launch_ln_quantize_rows(x, ln_g, ln_b, xq, sx, rows, dim,
                                         eps, st);
  if (rc != 0) return rc;
  rc = lseg::qkv_wg::launch(xq, sx, wq, sw, bias, qkv, rows, 3 * dim, dim,
                            st);
  if (rc != 0) return rc;

  return qk_int8
             ? launch_attention<true>(qkv, oq, os, n, t, dim, valid_len,
                                      scale, st)
             : launch_attention<false>(qkv, oq, os, n, t, dim, valid_len,
                                       scale, st);
}
