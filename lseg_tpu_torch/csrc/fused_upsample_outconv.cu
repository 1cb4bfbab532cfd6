// Fused decoder tail for Hopper (sm_90a), kernel B19: x2 align-corners
// bilinear upsample, activation quantize and the int8 1x1 out_conv, with a
// bf16 or an int8 result.
//
// Replaces: lseg_tpu/ops/pallas_decoder.py · fused_upsample_outconv
// (Pallas TPU; body _tail_kernel).
//
// Input: x (N, H, W, C) bf16; the H and W tap tables th (3, 2H) and
// tw (3, 2W) fp32 (first source index, its bf16-rounded tap, the next
// bf16-rounded tap; ops/decoder.py · interp_taps); the int8 kernel
// wq (Co, C); the fp32 weight scales sw and bias b (Co,); the fp32 scalar
// input scale s_in and, for int8 output, out_scale. Output (N, 2H, 2W, Co),
// bf16, or int8 codes on the grid out_scale (the fused head's input, at
// refinenet1). C = Co = 256, the decoder's `features` (other widths:
// fused_upsample_outconv_wide.cu), H, W >= 2.
//
// Per output pixel (jo, io), as the TPU kernel and the plain twin:
//   hb = bf16(x[ho] * w0 + x[ho + 1] * w1)   at the source columns wo and
//                                            wo + 1 (each one fp32 sum of
//                                            two exact products)
//   ub = bf16(hb[wo] * v0 + hb[wo + 1] * v1)
//   q  = clip(rint(ub * (1 / s_in)), +-127)
//   y  = float(q . wq) * (s_in * sw) + b    (exact int32 sum; no FMA)
//   out = bf16(y)  or  clip(rint(y * (1 / out_scale)), +-127)
// A second tap that would leave the image is 0 and reads the last row or
// column. 1 / s_in, 1 / out_scale and s_in * sw are formed here, each by
// the one correctly rounded operation the plain twin's `_scales` takes
// (__frcp_rn, __fmul_rn). float(acc) is exact by the 1.5 * 2^23 bias
// (|acc| <= 127 * 128 * 256 < 2^22), and rint + clip of a value is the
// same bias added to the clipped value; so the result is the plain twin's
// bit for bit.
//
// What bounds it on the card: at refinenet1's hand-off ((8, 120, 120, 256)
// -> (8, 240, 240, 256) int8) the 1x1 product is 2 x 460,800 x 256 x 256
// = 60.4 GOP (0.031 ms at 1979 TOP/s), against 59 MB of x read and 118 MB
// of codes written (0.053 ms at 3.35 TB/s): the bytes bound it; at
// refinenet2 ((8, 60, 60, 256) -> bf16 (8, 120, 120, 256)) 74 MB, 0.022 ms.
// Between the two sit ~20 SIMT instructions an upsampled value (the
// blends, the quantize, the epilogue), which take most of the time: the
// design spreads them over 16 warps an SM in straight-line phases.
//
// Design: a persistent grid, one CTA an SM, of four consumer warpgroups in
// two pairs.
//   - A tile is 64 consecutive output pixels of one output row; the output
//     columns fall in strips of 64, and the tiles run image by image,
//     strip by strip, row by row. A CTA takes a contiguous range of tiles
//     (so it walks down a strip), and its two pairs take every other tile
//     of it.
//   - Thread 0 loads, once, the (Co, C) weight by TMA (128-byte swizzle,
//     K-major) and, in order, each source row
//     the range needs, as the strip's source columns (at most 34 = 32 +
//     the halo column, contiguous in x) by one cp.async.bulk into a
//     RING-slot ring on mbarriers: the first RING at once, each later one
//     by the pair whose release frees its slot second (a shared-memory
//     count per slot). With x2 align-corners a source row serves about
//     four output rows, so x is read from device memory once (the halo
//     column of two strips twice).
//   - A pair, for its tile: waits for the two source rows; tables each
//     pixel's two hb offsets and W taps; blends every source column of the
//     strip once along H into its hb buffer (bf16, a lane's 8 channels of
//     a column each); releases the rows its later tiles do not read;
//     blends along W from hb (a lane's 8 channels of 8 pixels, four at a
//     time), quantizes, and writes the tile's codes into its codes buffer in
//     the 128-byte swizzled K-major layout s8 wgmma reads
//     (fence.proxy.async before the product reads them). Then each
//     warpgroup of the pair runs its half of the output channels: wgmma
//     m64n128k32 s8 SS over two 128-byte k-chunks (exact int32), then the
//     epilogue, y and the bf16 or int8 codes staged swizzled in its own
//     staging box and stored by TMA (3-D map over (Co, 2W, N 2H): a tile
//     past the row's end is clipped), 8 KB a pass.
// Shared memory (1024-byte aligned base): weight 64 KB | ring 3 x 17 KB |
// hb 2 x 17 KB | codes 2 x 16 KB | staging 4 x 8 KB | pixel tables 2 KB |
// scales and bias 2 KB | barriers: 218 KB, one CTA an SM. The attribute and SM-count queries
// run once a process.

#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;

constexpr int TP = 64;                  // output pixels a tile
constexpr int WG_THREADS = 128;
constexpr int PAIR_THREADS = 2 * WG_THREADS;
constexpr int THREADS = 2 * PAIR_THREADS;  // two pairs of warpgroups
constexpr int C = 256;                  // input channels
constexpr int CO = 256;                 // output channels
constexpr int NH = CO / 2;              // a warpgroup's half
constexpr int G = C / 8;                // 8-channel groups: a warp's lanes
constexpr int KCH = C / 128;            // 128-byte k-chunks
constexpr int CHUNK = TP * 128;         // a k-chunk of a tile's codes: 8 KB
constexpr int SCOLS = TP / 2 + 2;       // source columns a strip holds
constexpr int SLOT = SCOLS * C * 2;     // 17,408 bytes
constexpr int RING = 3;

struct Smem {
  int8_t w[KCH * CO * 128];             // k-chunk kc at kc * CO * 128
  int8_t codes[2][KCH * CHUNK];         // a pair's tile of codes
  uint8_t stage[4][CHUNK];              // a warpgroup's output box
  uint8_t ring[RING][SLOT];
  uint8_t hb[2][SLOT];                  // a pair's H-blended strip
  int4 taps[2][TP];  // a pair's tile: each pixel's hb offsets and W taps
  float sc[CO], bias[CO];
  uint64_t full[RING], wbar;
  int freed[RING];                      // releases of the slot's load
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "one CTA an SM");

struct Args {
  const __nv_bfloat16* x;
  const float* th;  // (3, 2H)
  const float* tw;  // (3, 2W)
  const float* sw;
  const float* bias;
  const float* s_in;
  const float* out_scale;  // int8 output only
  int N, H, W;
};

// The CTA's tiles [t0, t1); a column is one (image, strip), whose tiles
// are its 2H output rows, and its part of the range loads its source rows
// first_row .. first_row + loads - 1.
struct Walk {
  const float* th;
  const float* tw;
  int H, W, H2, W2, S, t0, t1;
  __device__ __forceinline__ int lo(int jo) const {
    return static_cast<int>(__ldg(th + jo));
  }
  __device__ __forceinline__ int hi(int jo) const {
    return min(lo(jo) + 1, H - 1);
  }
  __device__ __forceinline__ int first_row(int col) const {
    return lo(max(t0, col * H2) - col * H2);
  }
  __device__ __forceinline__ int loads(int col) const {
    return hi(min(t1, (col + 1) * H2) - 1 - col * H2) - first_row(col) + 1;
  }
  // the strip's first source column and its count (with the halo column)
  __device__ __forceinline__ int s0(int col) const {
    return static_cast<int>(__ldg(tw + (col % S) * TP));
  }
  __device__ __forceinline__ int ncols(int col) const {
    const int i0 = (col % S) * TP;
    return min(static_cast<int>(__ldg(tw + min(i0 + TP, W2) - 1)) + 1,
               W - 1) - s0(col) + 1;
  }
};

// Load `ld` of the CTA's walk (counted from 0 over its columns in order)
// into its ring slot: one bulk copy of the strip's source columns.
__device__ __forceinline__ void issue_load(Smem& sm, const Walk& wk,
                                           const Args& a, uint32_t ld) {
  int col = wk.t0 / wk.H2;
  uint32_t base = 0;
  for (;;) {
    const int n = wk.loads(col);
    if (ld < base + n) break;
    base += n;
    ++col;
  }
  const int r = wk.first_row(col) + static_cast<int>(ld - base);
  const int bytes = wk.ncols(col) * C * 2;
  const int s = ld % RING;
  wg::bar_expect_tx(&sm.full[s], bytes);
  wg::bulk_load(sm.ring[s],
            a.x + (static_cast<long long>(col / wk.S * a.H + r) * a.W +
                   wk.s0(col)) * C,
            bytes, &sm.full[s]);
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c, int r,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_addr(src)), "r"(c), "r"(r), "r"(z)
      : "memory");
}

// one fp32 sum of two exact products, rounded once to bf16, for the two
// bf16 values of each word
__device__ __forceinline__ uint32_t blend2(uint32_t a, uint32_t b, float wa,
                                           float wb) {
  const float s0 = __fadd_rn(__fmul_rn(__uint_as_float(a << 16), wa),
                             __fmul_rn(__uint_as_float(b << 16), wb));
  const float s1 =
      __fadd_rn(__fmul_rn(__uint_as_float(a & 0xffff0000u), wa),
                __fmul_rn(__uint_as_float(b & 0xffff0000u), wb));
  return lseg::pack_f32(s0, s1);
}

__device__ __forceinline__ uint4 blend8(const uint4& a, const uint4& b,
                                        float wa, float wb) {
  return make_uint4(blend2(a.x, b.x, wa, wb), blend2(a.y, b.y, wa, wb),
                    blend2(a.z, b.z, wa, wb), blend2(a.w, b.w, wa, wb));
}

// the bits of 1.5 * 2^23 + clip(rint(v * inv), +-127): the code in the
// low byte
__device__ __forceinline__ int code_bits(float v, float inv) {
  const float t = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_int(__fadd_rn(t, 12582912.0f));
}

// the codes of two words' four bf16 values, first in the low byte
__device__ __forceinline__ uint32_t codes4(uint32_t u, uint32_t v,
                                           float inv) {
  return __byte_perm(
      __byte_perm(code_bits(__uint_as_float(u << 16), inv),
                  code_bits(__uint_as_float(u & 0xffff0000u), inv), 0x0040),
      __byte_perm(code_bits(__uint_as_float(v << 16), inv),
                  code_bits(__uint_as_float(v & 0xffff0000u), inv), 0x0040),
      0x5410);
}

// The H-blend of the strip's ncols source columns (rows top and bot of the
// ring) into hb: lane l of warp w of the pair takes channel group l of
// columns w, w + 8, ... (items t, t + 256, ... of (column, group)).
__device__ __forceinline__ void hblend_strip(uint8_t* hb, const uint8_t* top,
                                             const uint8_t* bot, float w0,
                                             float w1, int ncols, int t) {
  for (int i = t; i < ncols * G; i += PAIR_THREADS) {
    const int off = i * 16;  // (column i / G, group i % G), rows of C
    *reinterpret_cast<uint4*>(hb + off) =
        blend8(*reinterpret_cast<const uint4*>(top + off),
               *reinterpret_cast<const uint4*>(bot + off), w0, w1);
  }
}

// Pixel p of the tile (output column i0 + p): the hb offsets of its two
// source columns and its two W taps; offset -1 past the row's end.
__device__ __forceinline__ int4 pixel_taps(const float* __restrict__ tw,
                                           int i0, int p, int s0, int W,
                                           int W2) {
  const int io = i0 + p;
  if (io >= W2) return make_int4(-1, -1, 0, 0);
  const int wo = static_cast<int>(__ldg(tw + io));
  return make_int4((wo - s0) * C * 2, (min(wo + 1, W - 1) - s0) * C * 2,
                   __float_as_int(__ldg(tw + W2 + io)),
                   __float_as_int(__ldg(tw + 2 * W2 + io)));
}

// The W-blend, the quantize and the tile's codes into `codes` (zeros past
// the row's end): lane l of warp w of the pair takes channel group l of
// pixels w, w + 8, ..., w + 56, four at a time (loads, then codes, then
// stores).
__device__ __forceinline__ void wblend_tile(uint8_t* __restrict__ codes,
                                            const uint8_t* __restrict__ hb,
                                            const int4* __restrict__ taps,
                                            float inv_in, int t) {
  const int w = t / 32, lane = t % 32;  // w < 8: pixel p & 7 == w
  const uint8_t* src = hb + lane * 16;
  uint8_t* dst = codes + (lane >> 4) * CHUNK + (lane & 1) * 8 + w * 128 +
                 ((((lane & 15) >> 1) ^ w) << 4);
#pragma unroll
  for (int b = 0; b < TP / 8; b += 4) {
    uint4 ha[4], hc[4];
    int4 tp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      tp[k] = taps[w + 8 * (b + k)];
      ha[k] = *reinterpret_cast<const uint4*>(src + max(tp[k].x, 0));
      hc[k] = *reinterpret_cast<const uint4*>(src + max(tp[k].y, 0));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 u = blend8(ha[k], hc[k], __int_as_float(tp[k].z),
                             __int_as_float(tp[k].w));
      uint2 q = make_uint2(codes4(u.x, u.y, inv_in), codes4(u.z, u.w, inv_in));
      if (tp[k].x < 0) q = make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(dst + 8 * (b + k) * 128) = q;
    }
  }
}

// acc = codes (64 x 256) . w_half^T (256 x 128): 8 k-steps of s8 wgmma
// m64n128k32 SS, waited for.
__device__ __forceinline__ void product(int (&acc)[NH / 8][4],
                                        const int8_t* codes,
                                        const int8_t* w) {
  gm::fence_acc(acc);
  wg::fence();
#pragma unroll
  for (int kc = 0; kc < KCH; ++kc) {
    const uint64_t da = wg::desc(codes + kc * CHUNK);
    const uint64_t db = wg::desc(w + kc * CO * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      gm::MmaS8<NH>::ss(acc, wg::desc_kstep(da, kk), wg::desc_kstep(db, kk),
                        (kc | kk) != 0);
  }
  wg::commit();
  wg::wait<0>();
  gm::fence_acc(acc);
}

// y = float(acc) * sc + b for output channels c0 .. c0 + 127, then bf16 or
// int8 codes, staged in `st` (one 128-byte swizzled box of the output map
// a pass) and stored by TMA.
template <bool INT8>
__device__ __forceinline__ void epilogue(const int (&acc)[NH / 8][4],
                                         uint8_t* st, const Smem& sm,
                                         float inv_out,
                                         const CUtensorMap* map, int c0,
                                         int i0, int z, int t, int bar_id) {
  constexpr int ES = INT8 ? 1 : 2;
  constexpr int PASSES = NH * ES / 128;
  constexpr int NT_PASS = NH / 8 / PASSES;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  // rows warp 16 + g (+ 8): row & 7 == g
  uint8_t* rows = st + (warp * 16 + g) * 128 + t4 * 2 * ES;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    // the box's previous store has read it
    if (t == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg::named_sync(bar_id, WG_THREADS);
#pragma unroll
    for (int j = 0; j < NT_PASS; ++j) {
      const int nt = pass * NT_PASS + j;
      const int col = nt * 8 + 2 * t4;  // in the half
      const float2 s = *reinterpret_cast<const float2*>(sm.sc + c0 + col);
      const float2 b = *reinterpret_cast<const float2*>(sm.bias + c0 + col);
      const int cx = (nt * 8 * ES) & 127;  // the group's byte in the row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = __fadd_rn(
            __fmul_rn(__fsub_rn(__int_as_float(acc[nt][2 * h] + 0x4B400000),
                                12582912.0f),
                      s.x),
            b.x);
        const float y1 = __fadd_rn(
            __fmul_rn(
                __fsub_rn(__int_as_float(acc[nt][2 * h + 1] + 0x4B400000),
                          12582912.0f),
                s.y),
            b.y);
        uint8_t* dst = rows + h * 8 * 128 + (((cx >> 4) ^ g) << 4) + (cx & 15);
        if constexpr (INT8) {
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
              __byte_perm(code_bits(y0, inv_out), code_bits(y1, inv_out),
                          0x0040));
        } else {
          *reinterpret_cast<uint32_t*>(dst) = lseg::pack_f32(y0, y1);
        }
      }
    }
    gm::fence_proxy_async();
    wg::named_sync(bar_id, WG_THREADS);
    if (t == 0) {
      tma_store_3d(map, st, c0 + pass * (128 / ES), i0, z);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1) upsample_outconv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_o, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // rounded up to 1024 bytes by offsetting the shared array itself (not
  // through an integer), so every access stays a shared-memory one
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024u - wg::smem_addr(smem_raw) % 1024u) % 1024u));
  const int tid = threadIdx.x;
  Walk wk;
  wk.th = a.th;
  wk.tw = a.tw;
  wk.H = a.H;
  wk.W = a.W;
  wk.H2 = 2 * a.H;
  wk.W2 = 2 * a.W;
  wk.S = (wk.W2 + TP - 1) / TP;  // strips a row
  const int T = a.N * wk.S * wk.H2;
  wk.t0 = static_cast<int>(static_cast<long long>(T) * blockIdx.x /
                           gridDim.x);
  wk.t1 = static_cast<int>(static_cast<long long>(T) * (blockIdx.x + 1) /
                           gridDim.x);
  const int col0 = wk.t0 / wk.H2, col1 = (wk.t1 - 1) / wk.H2;
  uint32_t total = 0;  // the range's loads
  for (int c = col0; c <= col1; ++c) total += wk.loads(c);
  const float s_in = *a.s_in;
  for (int c = tid; c < CO; c += THREADS) {
    sm.sc[c] = __fmul_rn(s_in, __ldg(a.sw + c));
    sm.bias[c] = __ldg(a.bias + c);
  }
  if (tid < RING) sm.freed[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) wg::bar_init(&sm.full[s], 1);
    wg::bar_init(&sm.wbar, 1);
    wg::bar_init_fence();
    wg::bar_expect_tx(&sm.wbar, KCH * CO * 128);
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc)
      gm::tma_load_2d(sm.w + kc * CO * 128, &map_w, &sm.wbar, kc * 128, 0);
    for (uint32_t ld = 0; ld < RING && ld < total; ++ld)
      issue_load(sm, wk, a, ld);
  }
  __syncthreads();

  const int pair = tid / PAIR_THREADS, tp = tid % PAIR_THREADS;
  const int half = tp / WG_THREADS, t = tp % WG_THREADS;
  const int pair_bar = 1 + pair, wg_bar = 3 + 2 * pair + half;
  const float inv_in = __frcp_rn(s_in);
  const float inv_out = INT8 ? __frcp_rn(*a.out_scale) : 1.0f;
  uint8_t* hb = sm.hb[pair];
  int8_t* codes = sm.codes[pair];
  uint8_t* st = sm.stage[2 * pair + half];
  wg::bar_wait(&sm.wbar, 0);

  uint32_t seen = 0, rel = 0;  // next load to wait for, to release
  int cur_col = col0, cur_base = 0, cur_rf = wk.first_row(col0);
  // the pair's first load of tile tau (its row lo)
  auto first_load = [&](int tau) -> uint32_t {
    const int col = tau / wk.H2;
    while (cur_col < col) {
      cur_base += wk.loads(cur_col);
      ++cur_col;
      cur_rf = wk.first_row(cur_col);
    }
    return cur_base + wk.lo(tau % wk.H2) - cur_rf;
  };
  // The pair is done with every load before `upto` (<= seen: each was
  // waited for); its leader counts the release, and the second release of
  // a load refills its slot with the load RING later. A pair releases
  // what it no longer reads before it waits for a later load, so the
  // least load any pair waits for can always be issued.
  auto release = [&](uint32_t upto) {
    if (tp == 0)
      for (; rel < upto; ++rel) {
        const int s = rel % RING;
        __threadfence_block();  // the pair's reads of the slot come first
        if (atomicAdd(&sm.freed[s], 1) == 1) {
          sm.freed[s] = 0;
          __threadfence_block();
          gm::fence_proxy_async();  // before the copy overwrites the slot
          if (rel + RING < total) issue_load(sm, wk, a, rel + RING);
        }
      }
    rel = max(rel, upto);
  };
  // wait for every load up to g in order, releasing those before f
  auto wait_upto = [&](uint32_t f, uint32_t g) {
    for (; seen <= g; ++seen) {
      release(min(seen, f));
      wg::bar_wait(&sm.full[seen % RING], (seen / RING) & 1);
    }
    release(min(seen, f));
  };

  for (int tau = wk.t0 + pair; tau < wk.t1; tau += 2) {
    const int col = tau / wk.H2, jo = tau % wk.H2;
    const uint32_t f = first_load(tau);
    const uint32_t g = f + (wk.hi(jo) - wk.lo(jo));
    wait_upto(f, g);
    const int i0 = (col % wk.S) * TP;
    if (tp < TP)
      sm.taps[pair][tp] = pixel_taps(a.tw, i0, tp, wk.s0(col), a.W, wk.W2);
    hblend_strip(hb, sm.ring[f % RING], sm.ring[g % RING],
                 __ldg(a.th + wk.H2 + jo), __ldg(a.th + 2 * wk.H2 + jo),
                 wk.ncols(col), tp);
    wg::named_sync(pair_bar, PAIR_THREADS);  // hb whole; rows read
    release(min(seen, tau + 2 < wk.t1 ? first_load(tau + 2) : total));
    wblend_tile(reinterpret_cast<uint8_t*>(codes), hb, sm.taps[pair], inv_in,
                tp);
    gm::fence_proxy_async();
    wg::named_sync(pair_bar, PAIR_THREADS);  // the codes are whole
    int acc[NH / 8][4];
    product(acc, codes, sm.w + half * NH * 128);
    epilogue<INT8>(acc, st, sm, inv_out, &map_o, half * NH, i0,
                   col / wk.S * wk.H2 + jo, t, wg_bar);
    // the pair's next hb and codes wait for both products (its next
    // pair barrier)
  }
  wait_upto(total, total - 1);  // the loads it never read, then all
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 3-D map over the output (N 2H, 2W, Co) of 1- or 2-byte elements, with
// boxes of 128 bytes x 64 pixels x 1 row and the 128-byte swizzle.
int make_out_map(CUtensorMap* map, void* base, int es, int co, int w2,
                 long long rows) {
  const wg::EncodeTiled enc = wg::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(co),
                              static_cast<cuuint64_t>(w2),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(co) * es,
      static_cast<cuuint64_t>(co) * es * static_cast<cuuint64_t>(w2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / es), TP, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  auto encode = [&] {
    return enc(map,
               es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               3, base, dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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

template <bool INT8>
int launch(const CUtensorMap& map_w, const CUtensorMap& map_o, const Args& a,
           int grid, cudaStream_t stream) {
  static const int attr =
      wg::allow_smem(upsample_outconv_wgmma_kernel<INT8>, SMEM);
  if (attr != 0) return attr;
  upsample_outconv_wgmma_kernel<INT8>
      <<<grid, THREADS, SMEM, stream>>>(map_w, map_o, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Requires
// C = Co = 256, H, W >= 2, 16-byte aligned tensors (checked by the
// wrapper); out_scale null for bf16 output.
extern "C" int lseg_fused_upsample_outconv(
    const void* x, const void* th, const void* tw, const void* wq,
    const void* sw, const void* bias, const void* s_in,
    const void* out_scale, void* out, int n, int h, int w, int c, int co,
    void* stream) {
  if (c != C || co != CO || h < 2 || w < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int sms = [] {
    int dev = 0, s = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    return s;
  }();
  const bool int8 = out_scale != nullptr;
  CUtensorMap map_w, map_o;
  int rc = gm::make_map_2d(&map_w, wq, 1, c, co, 128, co, true);
  if (rc == 0)
    rc = make_out_map(&map_o, out, int8 ? 1 : 2, co, 2 * w, 2LL * n * h);
  if (rc != 0) return rc;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.th = static_cast<const float*>(th);
  a.tw = static_cast<const float*>(tw);
  a.sw = static_cast<const float*>(sw);
  a.bias = static_cast<const float*>(bias);
  a.s_in = static_cast<const float*>(s_in);
  a.out_scale = static_cast<const float*>(out_scale);
  a.N = n;
  a.H = h;
  a.W = w;
  const int tiles = n * ((2 * w + TP - 1) / TP) * 2 * h;
  const int grid = min(tiles, max(sms, 1));
  const auto st = static_cast<cudaStream_t>(stream);
  return int8 ? launch<true>(map_w, map_o, a, grid, st)
              : launch<false>(map_w, map_o, a, grid, st);
}
