// Flash attention over the flat fused-qkv layout for Hopper (sm_90a),
// kernel B6.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_flat
// (Pallas TPU; reached through flash_attention_flat_vjp).
//
// Input: qkv (N, T, 3D) bf16, the fused qkv projection's own output.
// Output: flat (N, T, D) bf16. Keys at or past `valid_len` are masked out
// of the softmax. The kernel, its rounding points and its design are in
// flash_flat.cuh, shared with kernel B8.
//
// What bounds it on the card: the 2*T*T*64 FLOP of each of q.k^T and P.V
// per head and, beside them, the softmax (one exp per score). At the
// flagship (8, 901, 3072) with 16 heads that is 26.6 GFLOP of tensor-core
// work and 104 M exps; the input is only 44 MB.

#include "flash_flat.cuh"

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires D % 64 == 0, 1 <= valid_len <= T, 16-byte aligned qkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat(const void* qkv, void* out, int n,
                                         int t, int dim, int valid_len,
                                         float scale, void* stream) {
  return lseg::flash_flat::launch(qkv, out, n, t, dim, valid_len, scale,
                                  static_cast<cudaStream_t>(stream));
}
