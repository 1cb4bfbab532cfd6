// Backward of flash attention over the flat fused-qkv layout for Hopper
// (sm_90a): kernel B7.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · _flash_flat_bwd_impl
// (kernel body _bwd_kernel; the custom VJP of flash_attention_flat_vjp).
//
// Inputs: the forward's qkv (N, T, 3D) bf16, its output O (N, T, D) bf16,
// its per-row log-sum-exp lse (N, H, T) fp32 (kernel B6's statistics
// output) and the cotangent dO (N, T, D) bf16. Output: dqkv (N, T, 3D)
// bf16 in the same flat layout, dq in the q columns, dk in the k columns
// and dv in the v columns of each head, so the qkv projection's backward
// takes it as it is. Keys at or past `valid_len` are masked.
//
// Rounding points follow the TPU kernel (pallas_attention.py:557-609):
//   s  = (q . k^T) * scale in fp32;
//   pn = exp(s - lse) in fp32, normalized BEFORE any cast;
//   dv = bf16(pn)^T . dO, fp32 accumulation;
//   dp = dO . v^T in fp32;
//   Dr = rowsum(dO * O) in fp32 from the bf16 values;
//   ds = bf16(pn * (dp - Dr));
//   dq = (ds . k) * scale, dk = (ds^T . q) * scale, fp32 accumulation,
//   cast to bf16.
// One difference: pn comes from the forward's lse (as exp2 of
// s * scale * log2 e - lse * log2 e, one FMA, by the ex2.approx.ftz
// instruction), where the TPU kernel recomputes the row maximum and sum;
// the two differ at fp32 rounding.
//
// What bounds it on the card: the products. Each (image, head) needs
// five T x T x 64 products (s, dv, dp, dq, dk); the two passes below
// recompute s and dp once each, seven in all: 2*T*T*64*7 FLOP per head,
// 93 GFLOP at the flagship (8, 901, 3072) with 16 heads. Inputs and
// outputs are 132 MB, so it is compute-bound at any sensible rate.
//
// Design, on the wgmma + TMA engine of wgmma.cuh. The TPU kernel holds a
// whole (T, T) fp32 block per head pair in VMEM (3.3 MB at T = 904); a
// Hopper block cannot, and the row statistics are not recomputed: B6
// hands its lse over. No (T, T) tensor touches device memory and nothing
// is summed with atomics, so the result is deterministic. Two passes, one
// warpgroup of 64 rows per block:
//   1. dQ, one block per (64-query tile, head, image): Dr of its rows from
//      O and dO (written to an fp32 (N, H, T) scratch for pass 2); Q and
//      dO loaded once by TMA; K and V tiles through a three-stage TMA ring
//      on mbarriers; S = Q.K^T and dP = dO.V^T as SS wgmma, ds in
//      registers, dQ += ds.K as RS wgmma with K through the B-transpose
//      flag (3 products a tile);
//   2. dK/dV, one block per (64-key tile, head, image): K and V loaded
//      once by TMA; Q and dO tiles through the ring, each query tile's
//      lse and Dr staged in shared memory; S^T = K.Q^T and dP^T = V.dO^T
//      as SS wgmma issued together, so pn^T and ds^T come out of the
//      accumulators in the A-operand layout; dV += bf16(pn^T).dO and
//      dK += ds^T.Q as RS wgmma, also issued together (4 products a
//      tile, two waits).
// Any T works: TMA zero-fills rows past T, and those rows' lse is staged
// as +inf, so their pn is 0.

#include "lseg_common.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = lseg::wg;
using wg::TILE;
using wg::TILE_BYTES;

constexpr int HD = 64;  // head_dim (the kernel is specialised)
constexpr int BT = 64;  // rows per block tile and per inner tile
constexpr int STAGES = 3;  // ring depth
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* out;
  const __nv_bfloat16* dout;
  const float* lse;
  __nv_bfloat16* dqkv;
  float* dr;  // (N, H, T): rowsum(dO * O), written by pass 1
  int T, D, valid_len;
  float scale;
};

// A block's two resident tiles, the ring of two tiles a stage, each
// query tile's lse * log2 e and Dr (pass 2, double-buffered), barriers.
struct Smem {
  __nv_bfloat16 a[TILE * TILE];
  __nv_bfloat16 b[TILE * TILE];
  __nv_bfloat16 ra[STAGES][TILE * TILE];
  __nv_bfloat16 rb[STAGES][TILE * TILE];
  float lse2[2][BT];
  float dr[2][BT];
  uint64_t own_bar;
  uint64_t full[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment slack

__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  return *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// Barriers, the two resident tiles (from maps ma, mb at columns ca, cb,
// rows row0) and the first ring stages (columns cra, crb).
__device__ __forceinline__ void prologue(Smem& sm, const CUtensorMap* ma,
                                         int ca, const CUtensorMap* mb,
                                         int cb, int row0,
                                         const CUtensorMap* mra, int cra,
                                         const CUtensorMap* mrb, int crb,
                                         int n_tiles, int img) {
  if (threadIdx.x == 0) {
    wg::bar_init(&sm.own_bar, 1);
    for (int s = 0; s < STAGES; ++s) wg::bar_init(&sm.full[s], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect_tx(&sm.own_bar, 2 * TILE_BYTES);
    wg::tma_load(sm.a, ma, &sm.own_bar, ca, row0, img);
    wg::tma_load(sm.b, mb, &sm.own_bar, cb, row0, img);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) {
      wg::bar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
      wg::tma_load(sm.ra[s], mra, &sm.full[s], cra, s * BT, img);
      wg::tma_load(sm.rb[s], mrb, &sm.full[s], crb, s * BT, img);
    }
  }
}

// Every thread is done with ring stage s of tile j: refill it with tile
// j + STAGES.
__device__ __forceinline__ void refill(Smem& sm, int j, int n_tiles,
                                       const CUtensorMap* mra, int cra,
                                       const CUtensorMap* mrb, int crb,
                                       int img) {
  wg::named_sync(1, THREADS);
  if (threadIdx.x == 0 && j + STAGES < n_tiles) {
    const int s = j % STAGES;
    const int r = (j + STAGES) * BT;
    wg::bar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
    wg::tma_load(sm.ra[s], mra, &sm.full[s], cra, r, img);
    wg::tma_load(sm.rb[s], mrb, &sm.full[s], crb, r, img);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
}

// Store a warpgroup's 64 rows x 64 columns of fp32 accumulators * mult as
// bf16 at column `col` of the (T, 3D) rows of one image; rows >= T skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld,
                                           int col, int row0, int T,
                                           const float (&c)[8][4], float mult,
                                           int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* p = base + row * ld + col + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p + dt * 8) = __floats2bfloat162_rn(
          c[dt][2 * r] * mult, c[dt][2 * r + 1] * mult);
    }
  }
}

// ---- pass 1: Dr and dQ, one block per 64 queries -----------------------
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(
    const __grid_constant__ CUtensorMap mqkv,
    const __grid_constant__ CUtensorMap mdo, Args a) {
  Smem& sm = smem();
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const int q0 = blockIdx.x * BT;
  const int n_kt = (vl + BT - 1) / BT;
  const int k_col = D + head * HD, v_col = 2 * D + head * HD;
  // sm.a = Q, sm.b = dO; ring: ra = K, rb = V
  prologue(sm, &mqkv, head * HD, &mdo, head * HD, q0, &mqkv, k_col, &mqkv,
           v_col, n_kt, img);

  // Dr = rowsum(dO * O) of this block's rows: two threads a row
  const long long plane = (static_cast<long long>(img) * H + head) * T;
  {
    const int row = tid / 2, half = tid % 2, grow = q0 + row;
    float acc = 0.0f;
    if (grow < T) {
      const long long off =
          (static_cast<long long>(img) * T + grow) * D + head * HD + half * 32;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float o[8], d[8];
        lseg::unpack8(*reinterpret_cast<const uint4*>(a.out + off + 8 * i), o);
        lseg::unpack8(*reinterpret_cast<const uint4*>(a.dout + off + 8 * i), d);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += d[e] * o[e];
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sm.dr[0][row] = acc;
      if (grow < T) a.dr[plane + grow] = acc;
    }
  }
  wg::named_sync(1, THREADS);
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    lse2[r] = q0 + row < T ? a.lse[plane + q0 + row] * LOG2E : pos_inf();
    dr[r] = sm.dr[0][row];
  }

  const float c = a.scale * LOG2E;
  float sc[8][4], dp[8][4], dq[8][4];
  zero(sc);
  zero(dp);
  zero(dq);
  wg::bar_wait(&sm.own_bar, 0);
  const uint64_t d_q = wg::desc(sm.a), d_do = wg::desc(sm.b);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    wg::bar_wait(&sm.full[s], (j / STAGES) & 1);
    const uint64_t d_k = wg::desc(sm.ra[s]);
    wg::product_abt(sc, d_q, d_k);  // S = Q . K^T
    wg::product_abt(dp, d_do, wg::desc(sm.rb[s]));  // dP = dO . V^T
    wg::wait<0>();
    wg::fence_acc(sc);
    wg::fence_acc(dp);
    const int k0 = j * BT;
    const bool edge = k0 + BT > vl;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float pn = lseg::exp2_approx(fmaf(sc[nt][e], c, -lse2[r]));
        if (edge && k0 + nt * 8 + 2 * t4 + (e & 1) >= vl) pn = 0.0f;
        dp[nt][e] = pn * (dp[nt][e] - dr[r]);
      }
    uint32_t da[4][4];
    wg::pack_a(da, dp);  // ds = bf16(pn * (dP - Dr))
    wg::product_pb(dq, da, d_k);  // dQ += ds . K
    wg::wait<0>();
    wg::fence_acc(dq);
    refill(sm, j, n_kt, &mqkv, k_col, &mqkv, v_col, img);
  }
  __nv_bfloat16* ob = a.dqkv + static_cast<long long>(img) * T * 3 * D;
  store_rows(ob, 3LL * D, head * HD, q0 + warp * 16, T, dq, a.scale, g, t4);
}

// ---- pass 2: dK and dV, one block per 64 keys -----------------------------
// Capped at 168 registers so that three blocks share an SM; uncapped it
// takes 172 registers, two blocks an SM, and ran slower on an H100.
__global__ void __launch_bounds__(THREADS, 3) bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap mqkv,
    const __grid_constant__ CUtensorMap mdo, Args a) {
  Smem& sm = smem();
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const int k0 = blockIdx.x * BT;
  const int n_qt = (T + BT - 1) / BT;
  const int q_col = head * HD;
  // sm.a = K, sm.b = V; ring: ra = Q, rb = dO
  prologue(sm, &mqkv, D + head * HD, &mqkv, 2 * D + head * HD, k0, &mqkv,
           q_col, &mdo, head * HD, n_qt, img);

  // lse * log2 e and Dr of one query tile into staging buffer `buf`
  const long long plane = (static_cast<long long>(img) * H + head) * T;
  float st_l = 0.0f, st_d = 0.0f;
  auto fetch = [&](int qt) {
    const int q = qt * BT + tid;
    const bool in = q < T;
    st_l = in ? a.lse[plane + q] * LOG2E : pos_inf();
    st_d = in ? a.dr[plane + q] : 0.0f;
  };
  if (tid < BT) {
    fetch(0);
    sm.lse2[0][tid] = st_l;
    sm.dr[0][tid] = st_d;
  }
  wg::named_sync(1, THREADS);

  const float c = a.scale * LOG2E;
  float sc[8][4], dp[8][4], dk[8][4], dv[8][4];
  zero(sc);
  zero(dp);
  zero(dk);
  zero(dv);
  wg::bar_wait(&sm.own_bar, 0);
  const uint64_t d_k = wg::desc(sm.a), d_v = wg::desc(sm.b);
  // this thread's keys: rows g and g + 8 of its warp's 16
  const bool key_edge = k0 + BT > vl;
  const bool key_in[2] = {k0 + warp * 16 + g < vl, k0 + warp * 16 + g + 8 < vl};

  for (int j = 0; j < n_qt; ++j) {
    const int s = j % STAGES, buf = j & 1;
    wg::bar_wait(&sm.full[s], (j / STAGES) & 1);
    const uint64_t d_q = wg::desc(sm.ra[s]), d_do = wg::desc(sm.rb[s]);
    wg::product_abt(sc, d_k, d_q);  // S^T = K . Q^T
    wg::product_abt(dp, d_v, d_do);  // dP^T = V . dO^T
    wg::wait<0>();
    wg::fence_acc(sc);
    wg::fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t4 + (e & 1);
        float pn =
            lseg::exp2_approx(fmaf(sc[nt][e], c, -sm.lse2[buf][qi]));
        if (key_edge && !key_in[e / 2]) pn = 0.0f;
        sc[nt][e] = pn;
        dp[nt][e] = pn * (dp[nt][e] - sm.dr[buf][qi]);
      }
    uint32_t pa[4][4], pb[4][4];
    wg::pack_a(pa, sc);  // bf16(pn^T)
    wg::pack_a(pb, dp);  // ds^T = bf16(pn^T (dP^T - Dr))
    wg::product_pb(dv, pa, d_do);  // dV += bf16(pn^T) . dO
    wg::product_pb(dk, pb, d_q);  // dK += ds^T . Q
    // the next query tile's lse and Dr load under these two products
    if (tid < BT && j + 1 < n_qt) fetch(j + 1);
    wg::wait<0>();
    wg::fence_acc(dv);
    wg::fence_acc(dk);
    if (tid < BT && j + 1 < n_qt) {
      sm.lse2[buf ^ 1][tid] = st_l;
      sm.dr[buf ^ 1][tid] = st_d;
    }
    refill(sm, j, n_qt, &mqkv, q_col, &mdo, head * HD, img);
  }
  __nv_bfloat16* ob = a.dqkv + static_cast<long long>(img) * T * 3 * D;
  const int row0 = k0 + warp * 16;
  store_rows(ob, 3LL * D, D + head * HD, row0, T, dk, a.scale, g, t4);
  store_rows(ob, 3LL * D, 2 * D + head * HD, row0, T, dv, 1.0f, g, t4);
}

}  // namespace

// Launch the two passes on `stream`; returns the first error code that is
// not 0 (0 on success). `dr` is fp32 scratch of n * (dim / 64) * t floats;
// `lse` is B6's statistics output for the same qkv. Requires dim % 64 ==
// 0, 1 <= valid_len <= t and 16-byte aligned qkv, out, dout and dqkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat_bwd(
    const void* qkv, const void* out, const void* dout, const void* lse,
    void* dqkv, void* dr, int n, int t, int dim, int valid_len, float scale,
    void* stream) {
  static const int attr_dq = wg::allow_smem(bwd_dq_kernel, SMEM_BYTES);
  static const int attr_kv = wg::allow_smem(bwd_dkdv_kernel, SMEM_BYTES);
  if (attr_dq != 0) return attr_dq;
  if (attr_kv != 0) return attr_kv;
  CUtensorMap mqkv, mdo;
  int rc = wg::make_map(&mqkv, qkv, 3 * dim, t, n);
  if (rc != 0) return rc;
  rc = wg::make_map(&mdo, dout, dim, t, n);
  if (rc != 0) return rc;
  Args a{static_cast<const __nv_bfloat16*>(out),
         static_cast<const __nv_bfloat16*>(dout),
         static_cast<const float*>(lse),
         static_cast<__nv_bfloat16*>(dqkv),
         static_cast<float*>(dr),
         t, dim, valid_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + BT - 1) / BT, dim / HD, n);
  bwd_dq_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(mqkv, mdo, a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(mqkv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}
