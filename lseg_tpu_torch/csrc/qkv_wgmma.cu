// The int8 qkv projection with its dequant epilogue alone, for checks:
// the first stage of kernels B2, B8, B9 and B15, whose device code is
// qkv_wgmma.cuh (its header says what bounds it and how it is built).
// It replaces no TPU kernel of its own: the TPU kernels compute it inside
// their bodies (`_dequant_qkv_parts`), and this entry point lets a check
// hold the stage alone against the plain version bit for bit.

#include "qkv_wgmma.cuh"

// xq (M, K) int8, sx (M,) fp32, wq (N, K) int8, sw and bias (N,) fp32 ->
// qkv (M, N) bf16 on `stream`; returns 0 or a CUDA error code. Requires
// N % 192 == 0, K % 128 == 0 and 16-byte aligned tensors (checked by the
// wrapper).
extern "C" int lseg_qkv_int8_gemm(const void* xq, const void* sx,
                                  const void* wq, const void* sw,
                                  const void* bias, void* qkv, int m, int n,
                                  int k, void* stream) {
  return lseg::qkv_wg::launch(xq, sx, wq, sw, bias, qkv, m, n, k,
                              static_cast<cudaStream_t>(stream));
}
