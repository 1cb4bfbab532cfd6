// Int8 qkv projection of pre-quantized rows + flash attention for Hopper
// (sm_90a), kernel B8.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_qkv_fused
// (Pallas TPU; body _kernel_qkv, arithmetic in _dequant_qkv_parts and
// _pair_softmax_attention).
//
// Input: the per-row int8 codes xq (N, T, D) of the LayerNorm-1 output and
// their fp32 row scales sx (N, T), the int8 qkv weight (3D, D) (the port's
// (out, in) storage), its fp32 per-output-channel scales and bias (3D,).
// Output: the attention output (N, T, D) bf16, the input of the output
// projection. Keys at or past `valid_len` are masked out of the softmax.
//
// Rounding points, in order, as in the TPU kernel:
//   1. acc = xq . w^T exact in int32, then ((acc * sx) * sw) + b in fp32
//      (no FMA contraction), cast to bf16;
//   2. per head, fp32 scores times `scale`, exp(s - m) in fp32, P cast to
//      bf16 for P.V with fp32 accumulation, divided by the fp32 row sum,
//      cast to bf16.
// One difference, as in B6: the online softmax rounds P relative to the
// running row maximum, where the TPU kernel uses the maximum of the row.
//
// What bounds it on the card: at the flagship (8, 901, 1024) with 16
// heads, the 22.7 G int8 MAC of the qkv product (45.3 GOP, ~0.023 ms at
// 1979 TOP/s) and the 26.6 GFLOP of the attention products (~0.027 ms at
// 989 TFLOP/s), against 7.4 MB of codes, 3 MB of weight and 14.8 MB of
// output: the operations bound it (~0.05 ms). Design: the simple form,
// a chain of two launches on one stream that reuses device code of the
// port: the s8 wgmma + TMA qkv GEMM with its dequant epilogue
// (qkv_wgmma.cuh, shared with B2, B9 and B15), then B6's flash interior
// (flash_flat.cuh), which writes bf16. Unlike the TPU
// kernel, the bf16 qkv tensor (N, T, 3D) travels through device memory
// between the two (44 MB written and read at the flagship), as in B2:
// keeping it on chip is the lead for a fused redesign.

#include "flash_flat.cuh"
#include "qkv_wgmma.cuh"

// Launch the two-step chain on `stream`; returns the first non-zero
// CUDA error code (0 on success). qkv (N*T, 3D) bf16 is a scratch
// buffer allocated by the wrapper. Requires dim % 128 == 0,
// 1 <= valid_len <= t, 16-byte aligned tensors (checked by the wrapper).
extern "C" int lseg_flash_attention_qkv_fused(
    const void* xq, const void* sx, const void* wq, const void* sw,
    const void* bias, void* qkv, void* out, int n, int t, int dim,
    int valid_len, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = lseg::qkv_wg::launch(xq, sx, wq, sw, bias, qkv, n * t,
                                      3 * dim, dim, st);
  if (rc != 0) return rc;
  return lseg::flash_flat::launch(qkv, out, nullptr, n, t, dim, valid_len,
                                  scale, st);
}
