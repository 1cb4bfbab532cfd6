// Fused LayerNorm + per-row int8 quantize for Hopper (sm_90a), kernel B3.
//
// Replaces: lseg_tpu/ops/pallas_ln.py · ln_quantize_rows (Pallas TPU).
//
// Input: the raw bf16 residual stream x (rows, D) and the fp32 LayerNorm
// scale and bias (D,). Output: int8 codes (rows, D) and fp32 row scales
// (rows,), the operands of the int8 fc1 product. The normalised bf16
// tensor never exists in device memory, which is the TPU kernel's reason
// to exist. The arithmetic and the design are
// `lseg::lnq::ln_quantize_ring_kernel` (ln_quantize.cuh), which B2 and B9
// launch as their first step too.
//
// What bounds it on the card: bytes. At the flagship (8 x 901, 1024) it
// reads 14.8 MB of bf16 and writes 7.4 MB of int8 plus 29 KB of scales;
// at 3.35 TB/s that is ~6.6 us, against ~15 operations a value. The
// persistent warps keep their next rows' loads in flight by bulk copies
// while they reduce, and take the IEEE division only near a rounding
// boundary. Any row count works (the port does not pad T to a multiple
// of 8).

#include "ln_quantize.cuh"

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires dim % 256 == 0 and dim <= 2048, or dim an odd multiple of 128
// up to 896, and 16-byte aligned x, g and b (checked by the wrapper).
extern "C" int lseg_ln_quantize_rows(const void* x, const void* g,
                                     const void* b, void* q, void* s, int rows,
                                     int dim, float eps, void* stream) {
  return lseg::launch_ln_quantize_rows(x, g, b, q, s, rows, dim, eps,
                                       static_cast<cudaStream_t>(stream));
}
