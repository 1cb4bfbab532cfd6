// The fp32 mode of flash attention over the flat fused-qkv layout for
// Hopper (sm_90a), the route of an fp32 model (`train --dtype float32`):
// kernel B7 (the backward); the forward, B6's fp32 mode, is
// flash_attention_flat_fp32.cu.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_flat and
// _flash_flat_bwd_impl (Pallas TPU) for fp32 inputs. The TPU kernels take
// any qkv dtype; in fp32 `p.astype(v.dtype)` and the casts of pn and ds
// are no-ops, so every step below is fp32 and no operand is rounded to
// bf16 or TF32:
//   forward:  s = (q . k^T) * scale; P = exp(s - m); l = sum P;
//             O = (P . V) / l; lse = m + log(l)            (all fp32)
//   backward: pn = exp(s - lse); dv = pn^T . dO; dp = dO . v^T;
//             Dr = rowsum(dO * O); ds = pn * (dp - Dr);
//             dq = (ds . k) * scale; dk = (ds^T . q) * scale (all fp32)
// Keys at or past `valid_len` are masked. The forward's online softmax
// rescales by the running row maximum (the TPU kernel takes the maximum of
// the whole row), and the backward reads the forward's lse instead of
// recomputing the row statistics: both differ from the reference at fp32
// rounding. Exponentials are expf (full precision).
//
// What bounds it on the card: the fp32 FMA units (67 TFLOP/s without
// tensor cores; TF32 would round the operands to 10 mantissa bits). At
// the flagship (8, 901, 3072) with 16 heads the forward is 2 * 2*T*T*64
// FLOP per head, 26.6 GFLOP (0.40 ms), the backward's least work five
// such products, 66.5 GFLOP (0.99 ms); inputs are 89 MB (0.03 ms).
//
// Design, a simple SIMT kernel: one 256-thread block per (64-row tile,
// head, image); tiles are staged from device memory into shared memory
// and each thread of a 16 x 16 grid holds a 4 x 4 tile of every product
// (flash_fp32.cuh).
//   forward: per key tile, S = Q.K^T into shared memory, the row
//     statistics by 4 threads a row, O = O * alpha + P.V in registers;
//   backward pass 1 (one block per query tile): Dr, then per key tile S
//     and dP, ds into shared memory, dQ += ds.K;
//   backward pass 2 (one block per key tile): per query tile S^T and
//     dP^T, pn^T and ds^T into shared memory, dV += pn^T.dO and
//     dK += ds^T.Q.
// Nothing is summed with atomics, so the result is deterministic. Not
// yet: asynchronous staging, register-blocked products above 4 x 4.

#include "flash_fp32.cuh"

namespace {

using namespace lseg::flash_fp32;

// ---- backward ---------------------------------------------------------------

struct Args {
  const float* qkv;
  const float* out;
  const float* dout;
  const float* lse;
  float* dqkv;
  float* dr;  // (N, H, T): rowsum(dO * O), written by pass 1
  int T, D, valid_len;
  float scale;
};

struct DqSmem {
  float q[TILE_FLOATS];
  float dout[TILE_FLOATS];
  float k[TILE_FLOATS];
  float v[TILE_FLOATS];
  float ds[TILE_FLOATS];
  float lse[BT];
  float dr[BT];
};

// pass 1: Dr and dQ, one block per 64 queries
__global__ void __launch_bounds__(THREADS) bwd_dq_fp32_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const int q0 = blockIdx.x * BT;
  const long long ld = 3LL * D;
  const float* base = a.qkv + static_cast<long long>(img) * T * ld;
  const float* dob = a.dout + static_cast<long long>(img) * T * D;
  const float* ob = a.out + static_cast<long long>(img) * T * D;
  const long long plane = (static_cast<long long>(img) * H + head) * T;

  stage(sm.q, base, ld, head * HD, q0, T);
  stage(sm.dout, dob, D, head * HD, q0, T);
  {
    // Dr = rowsum(dO * O): 4 threads a row, 16 columns each
    const int row = tid / 4, part = tid % 4, grow = q0 + row;
    float acc = 0.0f;
    if (grow < T) {
      const long long off = static_cast<long long>(grow) * D + head * HD +
                            part * 16;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc = fmaf(dob[off + c], ob[off + c], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sm.dr[row] = acc;
      sm.lse[row] = grow < T ? a.lse[plane + grow] : pos_inf();
      if (grow < T) a.dr[plane + grow] = acc;
    }
  }
  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.0f;

  const int n_kt = (vl + BT - 1) / BT;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BT;
    stage(sm.k, base, ld, D + head * HD, k0, T);
    stage(sm.v, base, ld, 2 * D + head * HD, k0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_abt(s, sm.q, sm.k, ty, tx);
    dot_abt(dp, sm.dout, sm.v, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = sm.lse[r], d = sm.dr[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float pn = key < vl ? expf(s[i][j] * a.scale - l) : 0.0f;
        sm.ds[r * LD + tx + 16 * j] = pn * (dp[i][j] - d);
      }
    }
    __syncthreads();
    acc_pb(dq, sm.ds, sm.k, ty, tx);
    __syncthreads();  // k, v and ds are restaged next tile
  }
  store_tile(a.dqkv + static_cast<long long>(img) * T * ld, ld, head * HD,
             q0, T, dq, a.scale, ty, tx);
}

struct DkvSmem {
  float k[TILE_FLOATS];
  float v[TILE_FLOATS];
  float q[TILE_FLOATS];
  float dout[TILE_FLOATS];
  float pn[TILE_FLOATS];
  float ds[TILE_FLOATS];
  float lse[BT];
  float dr[BT];
};

// pass 2: dK and dV, one block per 64 keys
__global__ void __launch_bounds__(THREADS) bwd_dkdv_fp32_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const int k0 = blockIdx.x * BT;
  const long long ld = 3LL * D;
  const float* base = a.qkv + static_cast<long long>(img) * T * ld;
  const float* dob = a.dout + static_cast<long long>(img) * T * D;
  const long long plane = (static_cast<long long>(img) * H + head) * T;

  stage(sm.k, base, ld, D + head * HD, k0, T);
  stage(sm.v, base, ld, 2 * D + head * HD, k0, T);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.0f;
  bool key_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_in[i] = k0 + ty + 16 * i < vl;

  const int n_qt = (T + BT - 1) / BT;
  for (int t = 0; t < n_qt; ++t) {
    const int q0 = t * BT;
    stage(sm.q, base, ld, head * HD, q0, T);
    stage(sm.dout, dob, D, head * HD, q0, T);
    if (tid < BT) {
      const bool in = q0 + tid < T;
      sm.lse[tid] = in ? a.lse[plane + q0 + tid] : pos_inf();
      sm.dr[tid] = in ? a.dr[plane + q0 + tid] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_abt(s, sm.k, sm.q, ty, tx);     // S^T: keys x queries
    dot_abt(dp, sm.v, sm.dout, ty, tx);  // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pn =
            key_in[i] ? expf(s[i][j] * a.scale - sm.lse[c]) : 0.0f;
        sm.pn[r * LD + c] = pn;
        sm.ds[r * LD + c] = pn * (dp[i][j] - sm.dr[c]);
      }
    }
    __syncthreads();
    acc_pb(dv, sm.pn, sm.dout, ty, tx);
    acc_pb(dk, sm.ds, sm.q, ty, tx);
    __syncthreads();  // q, dout, pn and ds are restaged next tile
  }
  float* ob = a.dqkv + static_cast<long long>(img) * T * ld;
  store_tile(ob, ld, D + head * HD, k0, T, dk, a.scale, ty, tx);
  store_tile(ob, ld, 2 * D + head * HD, k0, T, dv, 1.0f, ty, tx);
}

}  // namespace

// Launch the two passes on `stream`; returns the first error code that is
// not 0. `dr` is fp32 scratch of n * (dim / 64) * t floats; `lse` is the
// fp32 forward's statistics output for the same qkv. Requires dim % 64 ==
// 0, 1 <= valid_len <= t and 16-byte aligned fp32 qkv, out, dout and dqkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat_bwd_fp32(
    const void* qkv, const void* out, const void* dout, const void* lse,
    void* dqkv, void* dr, int n, int t, int dim, int valid_len, float scale,
    void* stream) {
  static const int attr_dq =
      lseg::wg::allow_smem(bwd_dq_fp32_kernel, sizeof(DqSmem));
  static const int attr_kv =
      lseg::wg::allow_smem(bwd_dkdv_fp32_kernel, sizeof(DkvSmem));
  if (attr_dq != 0) return attr_dq;
  if (attr_kv != 0) return attr_kv;
  Args a{static_cast<const float*>(qkv), static_cast<const float*>(out),
         static_cast<const float*>(dout), static_cast<const float*>(lse),
         static_cast<float*>(dqkv), static_cast<float*>(dr),
         t, dim, valid_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + BT - 1) / BT, dim / HD, n);
  bwd_dq_fp32_kernel<<<grid, THREADS, sizeof(DqSmem), s>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_fp32_kernel<<<grid, THREADS, sizeof(DkvSmem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
