// LayerNorm + int8 qkv projection + flash attention, bf16 out, for Hopper
// (sm_90a), kernel B9.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_ln_qkv_fused
// (Pallas TPU; body _kernel_ln_qkv, arithmetic in _dequant_qkv_parts and
// _pair_softmax_attention). It is kernel B2 without the int8 quantize of
// its output.
//
// Input: the raw bf16 residual stream x (N, T, D), the fp32 LayerNorm
// scale and bias (D,), the int8 qkv weight (3D, D) (the port's (out, in)
// storage), its fp32 per-output-channel scales and bias (3D,). Output: the
// attention output (N, T, D) bf16. Keys at or past `valid_len` are masked
// out of the softmax.
//
// Rounding points, in order, as in the TPU kernel:
//   1. LN in fp32 (eps) and a per-row int8 quantize (ln_quantize.cuh);
//   2. acc = xq . w^T exact in int32, ((acc * sx) * sw) + b in fp32 (no FMA
//      contraction), cast to bf16;
//   3. per head, fp32 scores times `scale`, exp(s - m) in fp32, P cast to
//      bf16 for P.V with fp32 accumulation, divided by the fp32 row sum,
//      cast to bf16.
// One difference, as in B6: the online softmax rounds P relative to the
// running row maximum, where the TPU kernel uses the maximum of the row.
//
// What bounds it on the card: at the flagship (8, 901, 1024) with 16
// heads, the 22.7 G int8 MAC of the qkv product (~0.023 ms at 1979 TOP/s)
// and the 26.6 GFLOP of the attention products (~0.027 ms at 989 TFLOP/s),
// against 14.8 MB of input, 3 MB of weight and 14.8 MB of output: the
// operations bound it (~0.05 ms). Design: the simple form, a chain of three
// launches on one stream built from device code the port already has: B3's
// LN + quantize routine (ln_quantize.cuh), the s8 wgmma + TMA qkv GEMM
// with its dequant epilogue (qkv_wgmma.cuh) and B6's flash interior
// (flash_flat.cuh).
// Unlike the TPU kernel, the codes with their row scales and the bf16 qkv
// tensor travel through device memory between the launches (7.4 MB and
// 44 MB at the flagship), as in B2.

#include "flash_flat.cuh"
#include "ln_quantize.cuh"
#include "qkv_wgmma.cuh"

// Launch the three-step chain on `stream`; returns the first non-zero
// CUDA error code (0 on success). xq (N*T, D) int8, sx (N*T,) fp32 and
// qkv (N*T, 3D) bf16 are scratch buffers allocated by the wrapper.
// Requires dim % 256 == 0, dim <= 2048, 1 <= valid_len <= t, 16-byte
// aligned tensors (checked by the wrapper).
extern "C" int lseg_flash_attention_ln_qkv_fused(
    const void* x, const void* ln_g, const void* ln_b, const void* wq,
    const void* sw, const void* bias, void* xq, void* sx, void* qkv,
    void* out, int n, int t, int dim, int valid_len, float scale, float eps,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n * t;
  int rc = lseg::launch_ln_quantize_rows(x, ln_g, ln_b, xq, sx, rows, dim,
                                         eps, st);
  if (rc != 0) return rc;
  rc = lseg::qkv_wg::launch(xq, sx, wq, sw, bias, qkv, rows, 3 * dim, dim,
                            st);
  if (rc != 0) return rc;
  return lseg::flash_flat::launch(qkv, out, nullptr, n, t, dim, valid_len,
                                  scale, st);
}
