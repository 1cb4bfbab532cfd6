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
// One difference, as in B6: the online softmax rounds P relative to the
// running row maximum (rescaling when it grows), where the TPU kernel uses
// the maximum of the whole row.
//
// What bounds it on the card: at the flagship (8, 901, 1024) with 16
// heads, the 8 * 901 * 1024 * 3072 = 22.7 G int8 MAC of the qkv product
// and the 2 * 2 * 901^2 * 64 FLOP per head and image of the attention
// (26.6 GFLOP per call), plus one exp per score. Design: a Hopper SM cannot hold the TPU
// kernel's whole (T, D) int8 block per image beside (T, T) scores, so the
// op is a chain of three launches on one stream:
//   (a) LN + row quantize (B3's routine) -> xq (N*T, D) int8, sx (N*T,);
//   (b) a tiled int8 GEMM on mma.sync m16n8k32 (128 x 128 block tile,
//       k slices of 64 bytes staged in shared memory) with the fp32
//       dequant + bias epilogue -> bf16 qkv (N, T, 3D) (qkv_int8_gemm.cuh,
//       shared with kernel B8);
//   (c) flash attention with B6's online-softmax core: one block owns a
//       64-query tile of one image across all heads, two groups of four
//       warps walking the heads in turn, and keeps the bf16 (64, D) output
//       tile in shared memory (132 KB at D = 1024), so the per-row int8
//       quantize of the output happens in the kernel and only codes and
//       scales reach device memory. 15 x 8 = 120 blocks at the flagship.
// Unlike the TPU kernel, xq and the bf16 qkv tensor travel through device
// memory between the launches (7.4 MB and 44 MB at the flagship): the
// first lead for a fused redesign.

#include "ln_quantize.cuh"
#include "qkv_int8_gemm.cuh"

namespace {

using lseg::ld_u32;

// ---- (c) flash attention over all heads + per-row int8 output ----
constexpr int HD = 64;            // head_dim (the kernel is specialised)
constexpr int BQ = 64;            // query rows per block (4 warps x 16)
constexpr int BKV = 64;           // keys per tile
constexpr int LDS = HD + 8;       // K/V smem row stride in bf16
constexpr int HG = 2;             // head groups of 4 warps
constexpr int ATHREADS = 128 * HG;

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(128) : "memory");
}

size_t attention_smem_bytes(int dim) {
  return static_cast<size_t>(BQ) * (dim + 8) * 2 +
         static_cast<size_t>(HG) * 2 * BKV * LDS * 2;
}

__global__ void __launch_bounds__(ATHREADS) flash_q8_kernel(
    const __nv_bfloat16* __restrict__ qkv, int8_t* __restrict__ oq,
    float* __restrict__ os, int T, int D, int valid_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDO = D + 8;
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x LDO

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = warp / 4;   // head group
  const int wig = warp % 4;   // warp in group: query rows wig*16 ..
  const int gtid = tid % 128;
  const int g = lane / 4;
  const int t4 = lane % 4;
  __nv_bfloat16* Ks = Os + BQ * LDO + grp * 2 * BKV * LDS;
  __nv_bfloat16* Vs = Ks + BKV * LDS;

  const int img = blockIdx.y;
  const long long row_stride = 3LL * D;
  const __nv_bfloat16* base =
      qkv + static_cast<long long>(img) * T * row_stride;
  const int lrow = wig * 16 + g;  // local rows lrow and lrow + 8
  const int q0 = blockIdx.x * BQ + lrow;
  const int rows[2] = {q0, q0 + 8};
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int head = grp; head < D / HD; head += HG) {
    const int q_col = head * HD;
    const int k_col = D + head * HD;
    const int v_col = 2 * D + head * HD;
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = q_col + kk * 16 + 2 * t4 + 8 * half;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qa[kk][2 * half + r] =
              rows[r] < T ? ld_u32(base + rows[r] * row_stride + c) : 0u;
        }
      }
    }

    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
    float m_run[2] = {neg_inf, neg_inf};
    float l_run[2] = {0.0f, 0.0f};

    for (int k0 = 0; k0 < valid_len; k0 += BKV) {
      for (int i = gtid; i < BKV * (HD / 8); i += 128) {
        const int r = i / (HD / 8);
        const int cv = (i % (HD / 8)) * 8;
        const int key = k0 + r;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u);
        uint4 vv = kv;
        if (key < valid_len) {
          const __nv_bfloat16* rp = base + key * row_stride;
          kv = *reinterpret_cast<const uint4*>(rp + k_col + cv);
          vv = *reinterpret_cast<const uint4*>(rp + v_col + cv);
        }
        *reinterpret_cast<uint4*>(Ks + r * LDS + cv) = kv;
        *reinterpret_cast<uint4*>(Vs + r * LDS + cv) = vv;
      }
      group_sync(grp);

      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDS + kk * 16 + 2 * t4;
          lseg::mma_bf16_16816(s[nt], qa[kk], ld_u32(kp), ld_u32(kp + 8));
        }
      }

      float mx[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          const float v = key < valid_len ? s[nt][e] * scale : neg_inf;
          s[nt][e] = v;
          mx[e / 2] = fmaxf(mx[e / 2], v);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = expf(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m_run[e / 2]);
          s[nt][e] = p;
          rs[e / 2] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            lseg::pack_f32(s[2 * kk][0], s[2 * kk][1]),
            lseg::pack_f32(s[2 * kk][2], s[2 * kk][3]),
            lseg::pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            lseg::pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t4) * LDS + dt * 8 + g;
          const uint32_t b0 = lseg::pack_bf16(vp[0], vp[LDS]);
          const uint32_t b1 = lseg::pack_bf16(vp[8 * LDS], vp[9 * LDS]);
          lseg::mma_bf16_16816(o[dt], pa, b0, b1);
        }
      }
      group_sync(grp);
    }

    // l over the 4 threads of each row, divide, cast, keep in smem
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      __nv_bfloat16* op = Os + (lrow + 8 * r) * LDO + head * HD + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(op + dt * 8) =
            __floats2bfloat162_rn(__fdiv_rn(o[dt][2 * r], l_run[r]),
                                  __fdiv_rn(o[dt][2 * r + 1], l_run[r]));
      }
    }
  }
  __syncthreads();

  // per-row int8 quantize of the bf16 tile: one warp per row
  for (int lr = warp; lr < BQ; lr += ATHREADS / 32) {
    const int row = blockIdx.x * BQ + lr;
    if (row >= T) break;  // rows grow with lr: the rest are past T too
    const __nv_bfloat16* orow = Os + lr * LDO;
    float amax = 0.0f;
    for (int c = lane * 8; c < D; c += 256) {
      float v[8];
      lseg::unpack8(*reinterpret_cast<const uint4*>(orow + c), v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    const float sc = __fdiv_rn(fmaxf(lseg::warp_max(amax), 1e-8f), 127.0f);
    int8_t* qr = oq + (static_cast<long long>(img) * T + row) * D;
    for (int c = lane * 8; c < D; c += 256) {
      float v[8];
      lseg::unpack8(*reinterpret_cast<const uint4*>(orow + c), v);
      uint2 out;
      out.x = lseg::pack_codes(v[0], v[1], v[2], v[3], sc);
      out.y = lseg::pack_codes(v[4], v[5], v[6], v[7], sc);
      *reinterpret_cast<uint2*>(qr + c) = out;
    }
    if (lane == 0) os[static_cast<long long>(img) * T + row] = sc;
  }
}

}  // namespace

// Launch the three-step chain on `stream`; returns the first non-zero
// cudaGetLastError() (0 on success). xq (N*T, D) int8, sx (N*T,) fp32 and
// qkv (N*T, 3D) bf16 are scratch buffers allocated by the wrapper.
// Requires dim % 256 == 0, 1 <= valid_len <= t, 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_flash_attention_ln_qkv_q8(
    const void* x, const void* ln_g, const void* ln_b, const void* wq,
    const void* sw, const void* bias, void* xq, void* sx, void* qkv,
    void* oq, void* os, int n, int t, int dim, int valid_len, float scale,
    float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n * t;
  int rc = lseg::launch_ln_quantize_rows(x, ln_g, ln_b, xq, sx, rows, dim,
                                         eps, st);
  if (rc != 0) return rc;

  rc = lseg::qkv_gemm::launch(xq, sx, wq, sw, bias, qkv, rows, 3 * dim, dim,
                              st);
  if (rc != 0) return rc;

  const size_t smem = attention_smem_bytes(dim);
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  const dim3 agrid((t + BQ - 1) / BQ, n);
  flash_q8_kernel<<<agrid, ATHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<int8_t*>(oq),
      static_cast<float*>(os), t, dim, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}
