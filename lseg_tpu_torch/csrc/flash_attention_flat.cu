// Flash attention over the flat fused-qkv layout for Hopper (sm_90a),
// kernel B6.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_flat
// (Pallas TPU; reached through flash_attention_flat_vjp).
//
// Input: qkv (N, T, 3D) bf16, the fused qkv projection's own output.
// Output: flat (N, T, D) bf16 and, where `lse` is not null, the per-row
// log-sum-exp of the scaled scores, fp32 (N, H, T), the statistics the
// backward (B7) reads. Keys at or past `valid_len` are masked out of the
// softmax. The kernel, its rounding points and its design (wgmma from
// TMA-fed shared memory, one warpgroup of 64 query rows a block, a
// two-stage K/V ring, four blocks an SM) are in flash_flat.cuh, shared
// with kernels B8 and B9.
//
// What bounds it on the card: the tensor cores. The 2*T*T*64 FLOP of
// each of q.k^T and P.V per head are 26.6 GFLOP at the flagship
// (8, 901, 3072) with 16 heads (0.027 ms at 989 TFLOP/s), beside 104 M
// exponentials; the input is only 44 MB.

#include "flash_flat.cuh"

// Launch on `stream`; returns 0 or a CUDA error code. `lse` may be null.
// Requires D % 64 == 0, 1 <= valid_len <= T, 16-byte aligned qkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat(const void* qkv, void* out,
                                         void* lse, int n, int t, int dim,
                                         int valid_len, float scale,
                                         void* stream) {
  return lseg::flash_flat::launch(qkv, out, lse, n, t, dim, valid_len, scale,
                                  static_cast<cudaStream_t>(stream));
}
