// Fused patchify + patch-embedding matmul for Hopper (sm_90a), kernel B1.
//
// Replaces: lseg_tpu/ops/pallas_patch.py · patch_embed_fused (Pallas TPU).
//
// Computes, for an NHWC fp32 image x (N, H, W, C) and a bf16 weight
// matrix w (P*P*C, D) whose rows are ordered (patch row, patch column,
// channel) — the HWIO flattening of the reference's (P, P, C, D) kernel:
//
//   out[n, r*gw + c, :] = bf16( sum_k bf16(A[tok, k]) * w[k, :] + bias )
//
// where row tok of A is the P x P x C patch at grid cell (r, c), read
// straight from the NHWC image. Operands are rounded to bf16, products
// accumulate in fp32 and the fp32 bias is added before the final cast,
// the rounding points of the TPU kernel (pallas_patch.py:40-46).
//
// Input layout: the NHWC image that DenseViT receives (the port keeps the
// reference's NHWC boundary). Output: (N, gh*gw, D) bf16, row-major.
//
// What bounds it on the card: at the flagship shape (8, 480, 480, 3) ->
// (8, 900, 1024) it reads 22.1 MB of image and 1.6 MB of weights and
// writes 14.7 MB, against 11.3 GFLOP of bf16 products: at 3.35 TB/s and
// 989 TFLOP/s both floors are ~11.5 us, so the kernel must keep the
// tensor cores fed without adding device-memory traffic.
//
// Design: the bf16 GEMM of wgmma_gemm.cuh (B17's), its A operand made on
// the way from the image. A CTA computes the output of R whole grid rows
// (R = 128 / gw: 4 rows, 120 tokens, at the flagship's gw = 30) against
// 256 channels, in a 128-row wgmma tile whose rows past the R grid rows
// are never stored (64 x 4 tiles at the flagship; the column tiles of a
// row of tiles run next to each other, so the image rows they read come
// from device memory once and from L2 after). K is walked in k-chunks of
// L floats of one patch row (L = 48 at P = 16: a whole patch row; at P =
// 32 half of one):
//   - one producer thread loads each chunk's fp32 patch-row segments of
//     the tile's tokens into a three-slot ring, by ONE TMA box of a 5-D
//     map over the image (L floats x gw patch columns x 1 patch row x R
//     grid rows x 1 image: the tokens in order, L floats each; grid rows
//     past the image zero-filled): threads gathering a token's k-chunk
//     themselves, 16 loads of 16 bytes in flight each, waited on L2 for
//     ~1.3 us a chunk (PERF.md, section 6);
//   - another loads the chunk's L weight rows (four 64-column boxes,
//     128-byte swizzle, read MN-major by wgmma) into a three-stage ring;
//   - three converter warps round a slot's segments to bf16 and write
//     them into the stage's A in the 128-byte swizzled K-major layout TMA
//     would have written (each thread's 15 float4s at offsets it computes
//     once), then fence.proxy.async (the generic-proxy writes before the
//     wgmma that reads them), arrive on the stage's full barrier and free
//     the slot. The slots are a ring of their own so that the segments'
//     loads run ahead of the stages the products hold;
//   - two consumer warpgroups run m64n256k16 wgmma on 64 rows each (L / 16
//     k-steps a chunk) and hand a stage back once the products that read
//     it are done.
// The epilogue adds the fp32 bias, rounds once, stages the tile in the
// two stages after the last chunk's and stores it by TMA through a 4-D map
// over the output (64 channels x gw x R grid rows x 1 image): grid rows
// past the image and channels past D are clipped, and the wgmma rows past
// R grid rows are not in the box. So tokens past the image are neither
// read nor written, and no patchified or bf16 copy of the image reaches
// device memory. Shapes this kernel does not take (P*C not cut into equal
// chunks of 16, 32 or 48 floats, gw > 128) take patch_embed_wide.cu
// (`ops.patch_embed.b1_plan`).

#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;

constexpr int BM = 128;            // rows of the wgmma tile: 2 warpgroups
constexpr int BN = 256;            // output channels a tile
constexpr int MAX_L = 48;          // floats of a k-chunk, at most
constexpr int STAGES = 3;          // the products' ring: A and weight
constexpr int SLOTS = 3;           // the fp32 segments' ring
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int CONVERTERS = WG_THREADS - 32;  // warps 1-3 of the producer
constexpr int CONVERTER_WARPS = CONVERTERS / 32;
// A stage of the products' ring: the bf16 A (BM rows of 128 bytes, the
// swizzle atom's width, of which L / 16 k-steps are read) and the
// weight's four boxes of 64 columns x L rows; 40 KB. In the epilogue the
// two stages after the last chunk's hold the output tile's four boxes of
// BM rows, two a stage. A slot: a chunk's fp32 segments, up to BM tokens
// x L floats.
constexpr int A_BYTES = BM * 128;
constexpr int B_OFF = A_BYTES;
constexpr int STAGE_BYTES = B_OFF + (BN / 64) * MAX_L * 128;
constexpr int SLOT_BYTES = BM * MAX_L * 4;
constexpr int OUT_BOX = BM * 128;  // an output box of the epilogue

struct Smem {
  uint8_t stage[STAGES][STAGE_BYTES];
  uint8_t slot[SLOTS][SLOT_BYTES];
  float bias[BN];
  gm::Ring<SLOTS> raw;  // the slots: filled by TMA, freed by converters
  gm::Ring<STAGES> ring;
  uint64_t c_bar;
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack
static_assert(STAGE_BYTES % 1024 == 0 && SLOT_BYTES % 1024 == 0,
              "stages and slots keep the swizzle atoms aligned");
static_assert(STAGE_BYTES >= 2 * OUT_BOX, "two output boxes fit a stage");

struct Args {
  int gw, rows;          // patch columns; R, grid rows a tile
  int tiles_per_image;   // ceil(gh / R)
  int n_tiles;           // column tiles: ceil(D / 256)
  int chunks_per_row;    // k-chunks a patch row: P*C / L
  int n_k;               // k-chunks: P * chunks_per_row
  int pc;                // P*C: floats of a patch row
  int D;
};

// A box of a 5-D map at coordinates c0 .. c4 into `dst`, counted on `bar`
// (elements past the map's ends zero-filled, and counted).
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
          wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A box of shared memory at `src` into a 4-D map at c0 .. c3, as one bulk
// group of this thread (elements past the map's ends are not written).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A converter's share of a chunk: float4 ct + CONVERTERS * u of the
// slot's `tokens` x L / 4 (u < ITEMS), and the byte offset of its bf16
// values in a stage's A: token r's L values at k 0 .. L - 1 of the
// 128-byte swizzled row r; -1 past the tokens. The same for every chunk.
template <int L>
struct Share {
  static constexpr int Q = L / 4;  // float4s a token
  static constexpr int ITEMS = (BM * Q + CONVERTERS - 1) / CONVERTERS;
  int at[ITEMS];
};

template <int L>
__device__ __forceinline__ Share<L> share_of(int tokens, int ct) {
  using S = Share<L>;
  S sh;
#pragma unroll
  for (int u = 0; u < S::ITEMS; ++u) {
    const int i = ct + CONVERTERS * u;
    const int r = i / S::Q, q = i % S::Q;
    sh.at[u] = i < tokens * S::Q
                   ? r * 128 + (((q >> 1) ^ (r & 7)) << 4) + (q & 1) * 8
                   : -1;
  }
  return sh;
}

// A slot's fp32 segments rounded to bf16 into a stage's A, all of this
// converter's shared-memory loads in flight before its stores.
template <int L>
__device__ __forceinline__ void convert(uint8_t* st, const uint8_t* slot,
                                        const Share<L>& sh, int ct) {
  using S = Share<L>;
  const float4* raw = reinterpret_cast<const float4*>(slot);
  float4 v[S::ITEMS];
#pragma unroll
  for (int u = 0; u < S::ITEMS; ++u)
    if (sh.at[u] >= 0) v[u] = raw[ct + CONVERTERS * u];
#pragma unroll
  for (int u = 0; u < S::ITEMS; ++u)
    if (sh.at[u] >= 0)
      *reinterpret_cast<uint2*>(st + sh.at[u]) =
          make_uint2(lseg::pack_f32(v[u].x, v[u].y),
                     lseg::pack_f32(v[u].z, v[u].w));
}

template <int L>
__global__ void __launch_bounds__(THREADS, 1) patch_embed_tma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_o, const float* __restrict__ b,
    Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int wg_id = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  const int mt = blockIdx.x / a.n_tiles;
  const int n0 = blockIdx.x % a.n_tiles * BN;
  const int img = mt / a.tiles_per_image;
  const int pr0 = mt % a.tiles_per_image * a.rows;
  const int tokens = a.rows * a.gw;  // rows of the tile's boxes

  if (threadIdx.x == 0) {
    sm.raw.init(CONVERTER_WARPS);
    sm.ring.init(2, 1 + CONVERTER_WARPS);
    wg::bar_init(&sm.c_bar, 1);
    wg::bar_init_fence();
  }
  if (wg_id > 0) {
    for (int i = threadIdx.x - WG_THREADS; i < BN; i += 2 * WG_THREADS)
      sm.bias[i] = n0 + i < a.D ? b[n0 + i] : 0.0f;
  }
  __syncthreads();

  if (wg_id == 0) {
    if (threadIdx.x == 0) {
      // the fp32 segments, as far ahead as the slots allow: patch row i,
      // chunk j of it
      for (int kc = 0; kc < a.n_k; ++kc) {
        const int i = kc / a.chunks_per_row, j = kc % a.chunks_per_row;
        const int r = sm.raw.acquire(kc, tokens * L * 4);
        tma_load_5d(sm.slot[r], &map_x, &sm.raw.full[r], j * L, 0, i, pr0,
                    img);
      }
    } else if (threadIdx.x == 1) {
      // the chunks' weight rows i * P*C + j * L ..
      for (int kc = 0; kc < a.n_k; ++kc) {
        const int i = kc / a.chunks_per_row, j = kc % a.chunks_per_row;
        const int s = sm.ring.acquire(kc, (BN / 64) * L * 128);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          gm::tma_load_2d(sm.stage[s] + B_OFF + q * L * 128, &map_w,
                          &sm.ring.full[s], n0 + 64 * q, i * a.pc + j * L);
      }
      // the two stages after the last chunk's hold the output tile, once
      // both warpgroups are done with them
      for (int h = 0; h < 2; ++h) sm.ring.wait_free(a.n_k + h);
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       wg::smem_addr(&sm.c_bar))
                   : "memory");
    } else if (threadIdx.x >= 32) {
      const int ct = threadIdx.x - 32;
      const Share<L> sh = share_of<L>(tokens, ct);
      for (int kc = 0; kc < a.n_k; ++kc) {
        const int r = sm.raw.wait(kc);
        const int s = sm.ring.wait_free(kc);
        convert<L>(sm.stage[s], sm.slot[r], sh, ct);
        gm::fence_proxy_async();  // before the wgmma that reads them
        __syncwarp();
        if (threadIdx.x % 32 == 0) {
          sm.ring.fill(kc);
          sm.raw.release(kc);
        }
      }
    }
    return;
  }

  const int c = wg_id - 1;  // this warpgroup's 64 rows
  float acc[BN / 8][4];
  gm::zero(acc);
  for (int kc = 0; kc < a.n_k; ++kc) {
    const int s = sm.ring.wait(kc);
    const uint64_t da = wg::desc(sm.stage[s] + c * 64 * 128);
    const uint64_t db = gm::desc_mn(sm.stage[s] + B_OFF, L * 128);
    gm::fence_acc(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
      gm::Mma<BN>::template ss<1>(acc, wg::desc_kstep(da, kk),
                                  wg::desc_rowstep(db, kk), 1);
    wg::commit();
    wg::wait<1>();  // the previous chunk's products are complete
    gm::fence_acc(acc);
    if (kc > 0 && tid == 0) sm.ring.release(kc - 1);
  }
  wg::wait<0>();
  gm::fence_acc(acc);

  // acc + bias in fp32, one rounding to bf16, staged in the swizzled
  // boxes of the free stage, stored by TMA
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  wg::bar_wait(&sm.c_bar, 0);  // the output stages are free
  // box q of the tile in stage n_k + q / 2, at q % 2 boxes in
  uint8_t* box[BN / 64];
#pragma unroll
  for (int q = 0; q < BN / 64; ++q)
    box[q] = sm.stage[(a.n_k + q / 2) % STAGES] + (q % 2) * OUT_BOX;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = 64 * c + warp * 16 + g + 8 * half;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(
          box[col / 64] + gm::swizzled_offset(row, col % 64)) =
          __floats2bfloat162_rn(__fadd_rn(acc[nt][2 * half], sm.bias[col]),
                                __fadd_rn(acc[nt][2 * half + 1],
                                          sm.bias[col + 1]));
    }
  }
  gm::fence_proxy_async();  // the tile's writes before the TMA store
  wg::named_sync(2, 2 * WG_THREADS);  // both warpgroups' rows are staged
  if (threadIdx.x == WG_THREADS) {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      if (n0 + 64 * q < a.D)
        tma_store_4d(&map_o, box[q], n0 + 64 * q, 0, pr0, img);
    gm::tma_store_drain();
  }
}

// A tiled map of `rank` dims (innermost first) over fp32 or bf16 data,
// with the strides (bytes) of dims 1 .. rank - 1 and the box given, the
// 128-byte swizzle or none, zero fill past the edges; 0 or a CUDA error
// code. Binds the data's device's primary context where the calling
// thread has none (as wg::make_map).
int make_map(CUtensorMap* map, const void* base, bool fp32, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box, bool swizzle) {
  const wg::EncodeTiled enc = wg::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  auto encode = [&] {
    return enc(map,
               fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               rank, const_cast<void*>(base), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    cudaPointerAttributes at;
    if (cudaPointerGetAttributes(&at, base) == cudaSuccess &&
        cudaSetDevice(at.device) == cudaSuccess)
      r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int L>
int launch(const void* x, const void* w, const void* bias, void* out, int n,
           int h, int w_img, int c, int patch, int dim, cudaStream_t st) {
  static const int attr = wg::allow_smem(patch_embed_tma_kernel<L>, SMEM);
  if (attr != 0) return attr;
  const int gw = w_img / patch, gh = h / patch, pc = patch * c;
  Args a;
  a.gw = gw;
  a.rows = BM / gw;
  a.tiles_per_image = (gh + a.rows - 1) / a.rows;
  a.n_tiles = (dim + BN - 1) / BN;
  a.chunks_per_row = pc / L;
  a.n_k = patch * a.chunks_per_row;
  a.pc = pc;
  a.D = dim;
  // x as (P*C floats, gw patch columns, P patch rows, gh grid rows, N)
  const cuuint64_t row = static_cast<cuuint64_t>(w_img) * c * 4;
  const cuuint64_t xd[5] = {static_cast<cuuint64_t>(pc),
                            static_cast<cuuint64_t>(gw),
                            static_cast<cuuint64_t>(patch),
                            static_cast<cuuint64_t>(gh),
                            static_cast<cuuint64_t>(n)};
  const cuuint64_t xs[4] = {static_cast<cuuint64_t>(pc) * 4, row,
                            row * patch, row * h};
  const cuuint32_t xb[5] = {static_cast<cuuint32_t>(L),
                            static_cast<cuuint32_t>(gw), 1,
                            static_cast<cuuint32_t>(a.rows), 1};
  // w as (D, K); out as (D, gw, gh, N)
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(dim),
                            static_cast<cuuint64_t>(pc) * patch};
  const cuuint64_t ws[1] = {static_cast<cuuint64_t>(dim) * 2};
  const cuuint32_t wb[2] = {64, static_cast<cuuint32_t>(L)};
  const cuuint64_t od[4] = {static_cast<cuuint64_t>(dim),
                            static_cast<cuuint64_t>(gw),
                            static_cast<cuuint64_t>(gh),
                            static_cast<cuuint64_t>(n)};
  const cuuint64_t os[3] = {static_cast<cuuint64_t>(dim) * 2,
                            static_cast<cuuint64_t>(dim) * 2 * gw,
                            static_cast<cuuint64_t>(dim) * 2 * gw * gh};
  const cuuint32_t ob[4] = {64, static_cast<cuuint32_t>(gw),
                            static_cast<cuuint32_t>(a.rows), 1};
  CUtensorMap map_x, map_w, map_o;
  int rc = make_map(&map_x, x, true, 5, xd, xs, xb, false);
  if (rc == 0) rc = make_map(&map_w, w, false, 2, wd, ws, wb, true);
  if (rc == 0) rc = make_map(&map_o, out, false, 4, od, os, ob, true);
  if (rc != 0) return rc;
  const int grid = n * a.tiles_per_image * a.n_tiles;
  patch_embed_tma_kernel<L><<<grid, THREADS, SMEM, st>>>(
      map_x, map_w, map_o, static_cast<const float*>(bias), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// Takes dim % 64 == 0, H and W multiples of the patch, gw = W / P <= 128,
// and P*C cut into k-chunks of L = P*C / ceil(P*C / 48) floats, a
// multiple of 16 (16, 32 or 48); 16-byte aligned tensors (checked by the
// wrapper, whose `ops.patch_embed.b1_plan` routes the other shapes to
// patch_embed_wide.cu).
extern "C" int lseg_patch_embed(const void* x, const void* w,
                                const void* bias, void* out, int n, int h,
                                int w_img, int c, int patch, int dim,
                                void* stream) {
  if (dim % 64 || patch < 1 || c < 1 || n < 1 || h < patch ||
      w_img < patch || h % patch || w_img % patch || w_img / patch > BM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pc = patch * c;
  const int split = (pc + MAX_L - 1) / MAX_L;
  const int L = pc / split;
  if (pc % split || L % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 16:
      return launch<16>(x, w, bias, out, n, h, w_img, c, patch, dim, st);
    case 32:
      return launch<32>(x, w, bias, out, n, h, w_img, c, patch, dim, st);
    default:
      return launch<48>(x, w, bias, out, n, h, w_img, c, patch, dim, st);
  }
}

extern "C" const char* lseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
