// The int8 head1 tile of kernels B13 (head1_correlate_upsample_argmax.cu),
// B14 (head1_correlate_wup.cu) and B5 (head1_correlate_argmax.cu) on the
// Hopper engines: a step takes 128 pixels, 64 a consumer warpgroup, and
// gives each pixel's correlate sums (or normalized logits) against a chunk
// of up to KG = 152 labels in registers, with the bits of B4's tile
// (head1_tile.cuh) for the same inputs. More labels take more chunks.
//
//   embed      e = (codes . w^T) * sc + b in fp32, one quarter of 128 head1
//              channels at a time: s8 wgmma m64n128k32 (IGMMA, exact
//              int32), codes and weight both by TMA, K-major with the
//              128-byte swizzle (two 128-byte k-chunks: C <= 256, columns
//              past C zero-filled by TMA, so their products add 0);
//   dequant    e per element as B4 rounds it, the row sums of e^2 in B4's
//              order, and bf16(e) packed straight into mma.sync A
//              fragments (which are wgmma's register A operand): the wgmma
//              accumulator of a warp's 16 rows is mma.sync's m16n8 C
//              layout, so e never goes to shared memory;
//   correlate  bf16(e) . tn^T -> fp32 on wgmma m64n152k16 in the RS form
//              (A those fragments, B the swizzled text stage of the
//              quarter: 152 labels x 128 channels, two TMA boxes of 64
//              channels, rows past K zero-filled), eight k16 products a
//              quarter, 19 label tiles of 8 in registers;
//   logits     bf16(acc * rsqrt(max(sum e^2, 1e-24))).
//
// Why the bits are B4's: the int32 sums are exact in any order; e is the
// same `_rn` steps; a thread (g, t4) of warp w holds, in each quarter e0,
// the columns e0 + 64 wc + 8 nt + 2 t4 + {0, 1} (wc = nt' / 8 of the
// wgmma layout's nt' = 0..15), the columns B4's warp (w, wc) lane (g, t4)
// holds, so its partial sums of e^2 per column half run over the same
// values in the same order (`add_sq2`, no contraction in either), and are
// joined as B4 joins them: lanes t4 ^ 1, then t4 ^ 2, then half 0 + half
// 1; the correlate accumulates each logit over the k16 steps of E in
// ascending order into one fp32 accumulator, and wgmma sums a k16 step to
// the bits of B4's mma.sync m16n8k16 (the probe of head1_sum_probe.cu:
// all 69,120,000 sums of the flagship's operands equal); the norm and the
// last product round as B4's.
//
// `Pipe` is the shared memory of a walk of steps (the step's codes and the
// ring of quarters), `load_step` the producer thread's part of a step and
// `step_sums` the consumers'.

#pragma once

#include "head1_tile.cuh"
#include "wgmma_gemm.cuh"

namespace lseg {
namespace {
namespace head1w {

constexpr int ROWS = 128;                // pixels a step: 2 x 64
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int EQ = 128;                  // head1 channels a quarter
constexpr int KT = 19;                   // label tiles of 8 a thread holds
constexpr int KG = 8 * KT;               // 152 labels at most
constexpr int MAX_C = 256;
constexpr int KCH = MAX_C / 128;         // 128-byte k-chunks of the codes
constexpr int CODES_BOX = 64 * 128;      // a warpgroup's 64 pixels, 128 B
constexpr int CODES_BYTES = KCH * 2 * CODES_BOX;  // 32 KB
constexpr int W_BOX = EQ * 128;          // 128 channels x 128 code bytes
constexpr int W_BYTES = KCH * W_BOX;     // 32 KB
constexpr int T_BOX = KG * 128;          // 152 labels x 64 bf16: 19 KB
constexpr int STAGE = W_BYTES + 2 * T_BOX;  // a quarter's weight and text

// acc = this warpgroup's 64 pixels (codes box cw of each k-chunk) . the
// quarter's 128 weight rows^T, waited for.
__device__ __forceinline__ void embed(int (&acc)[16][4], const uint8_t* codes,
                                      const uint8_t* wst, int cw) {
  gemm::zero(acc);
  gemm::fence_acc(acc);
  wg::fence();
#pragma unroll
  for (int kc = 0; kc < KCH; ++kc) {
    const uint64_t da = wg::desc(codes + (kc * 2 + cw) * CODES_BOX);
    const uint64_t db = wg::desc(wst + kc * W_BOX);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      gemm::MmaS8<EQ>::ss(acc, wg::desc_kstep(da, kk), wg::desc_kstep(db, kk),
                          1);
  }
  wg::commit();
  wg::wait<0>();
  gemm::fence_acc(acc);
}

// e = acc * sc + b for the quarter's channels e0 .. e0 + 127: the row sums
// of e^2 per column half ss[wc][h] (h: rows g, g + 8), and bf16(e) as the
// A fragments of the quarter's eight k16 steps.
__device__ __forceinline__ void dequant(const int (&acc)[16][4],
                                        const float* __restrict__ sc,
                                        const float* __restrict__ b1, int e0,
                                        float (&ss)[2][2],
                                        uint32_t (&af)[8][4]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int nt = 2 * kk + p;
      const int col = e0 + nt * 8 + 2 * t4;
      const float s0 = __ldg(sc + col), s1 = __ldg(sc + col + 1);
      const float c0 = __ldg(b1 + col), c1 = __ldg(b1 + col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h]), s0), c0);
        const float v1 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h + 1]), s1), c1);
        ss[nt / 8][h] = head1::add_sq2(ss[nt / 8][h], v0, v1);
        af[kk][2 * p + h] = pack_f32(v0, v1);
      }
    }
}

// d += A . B on wgmma m64n152k16 bf16 -> fp32, RS form: A (64 x 16 bf16)
// the mma.sync A fragment of each warp's 16 rows in registers, B the
// K-major 128-byte-swizzled text stage of 152 labels at `db`. The
// accumulator is mma.sync's m16n8 C layout over 19 label tiles.
__device__ __forceinline__ void mma_rs152(float (&d)[KT][4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75"
      "}, {%76, %77, %78, %79}, %80, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[lt] += bf16(e) . tn^T over the quarter's eight k16 steps in
// ascending order, labels 8 lt .. 8 lt + 7, each step one m64n152k16
// product reading the text from its two swizzled boxes at `tst`, waited
// for. The probe of head1_sum_probe.cu found wgmma's k16 sums bit-equal to
// mma.sync's (B4's) on the flagship's operands, 69,120,000 of them, so
// the logits keep B4's bits.
__device__ __forceinline__ void correlate(float (&acc)[KT][4],
                                          const uint32_t (&af)[8][4],
                                          const uint8_t* tst) {
  gemm::fence_acc(acc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_rs152(acc, af[kk],
              wg::desc_kstep(wg::desc(tst + (kk / 4) * T_BOX), kk % 4));
  wg::commit();
  wg::wait<0>();
  gemm::fence_acc(acc);
}

// The normalized logits of rows g (h = 0) and g + 8 (h = 1), labels
// 8 lt + 2 t4 + {0, 1}, packed as bf16 pairs: ss joined as B4 joins it.
__device__ __forceinline__ void logits(const float (&acc)[KT][4],
                                       float (&ss)[2][2],
                                       uint32_t (&out)[2][KT]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int wc = 0; wc < 2; ++wc) {
      ss[wc][h] += __shfl_xor_sync(0xffffffffu, ss[wc][h], 1);
      ss[wc][h] += __shfl_xor_sync(0xffffffffu, ss[wc][h], 2);
    }
    const float inv = rsqrtf(fmaxf(ss[0][h] + ss[1][h], 1e-24f));
#pragma unroll
    for (int lt = 0; lt < KT; ++lt)
      out[h][lt] = pack_f32(__fmul_rn(acc[lt][2 * h], inv),
                            __fmul_rn(acc[lt][2 * h + 1], inv));
  }
}

// The shared memory of a walk: NB buffers of a step's codes (two 64-pixel
// boxes a 128-byte k-chunk; step ls takes buffer ls % NB, so with NB = 2
// the next step's codes land while this step's are read), the two-stage
// ring of quarters (weight rows, text columns), each codes buffer's full
// and empty barriers and the ring's. Its base must be 1024-byte aligned.
template <int NB>
struct Pipe {
  uint8_t codes[NB][CODES_BYTES];
  uint8_t ring[2][STAGE];
  uint64_t cfull[NB], cempty[NB];
  gemm::Ring<2> r;
};

// One thread, before the block's first sync: a codes buffer's full barrier
// takes `fillers` arrivals (1: the producer's TMA; else the warps that
// write the codes), its empty one a lane of each consumer warp, as the
// ring's stages.
template <int NB>
__device__ __forceinline__ void init_pipe(Pipe<NB>& p, int fillers) {
  for (int b = 0; b < NB; ++b) {
    wg::bar_init(&p.cfull[b], fillers);
    wg::bar_init(&p.cempty[b], 8);
  }
  p.r.init(8);
}

// At C <= 128 the second k-chunk of the codes and of the weight stages is
// never loaded: zeros, whose products add nothing. All threads, then a
// block sync.
template <int NB>
__device__ __forceinline__ void zero_unloaded(Pipe<NB>& p, int kcl,
                                              int threads) {
  for (int i = threadIdx.x; kcl < KCH && i < CODES_BOX * 2 / 16;
       i += threads) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int b = 0; b < NB; ++b)
      reinterpret_cast<uint4*>(p.codes[b] + 2 * CODES_BOX)[i] = z;
    reinterpret_cast<uint4*>(p.ring[0] + W_BOX)[i] = z;
    reinterpret_cast<uint4*>(p.ring[1] + W_BOX)[i] = z;
  }
  gemm::fence_proxy_async();  // before wgmma reads them
}

// Wait until the codes buffer of the `ls`-th step is free to fill (its
// previous step's consumers have read it); returns the buffer.
template <int NB>
__device__ __forceinline__ uint8_t* codes_free(Pipe<NB>& p, int ls) {
  wg::bar_wait(&p.cempty[ls % NB], ((ls / NB) & 1) ^ 1);
  return p.codes[ls % NB];
}

// Wait until the codes of the `ls`-th step have landed.
template <int NB>
__device__ __forceinline__ void codes_full(Pipe<NB>& p, int ls) {
  wg::bar_wait(&p.cfull[ls % NB], (ls / NB) & 1);
}

// The producer thread's part of the `ls`-th step of its CTA: with `codes`,
// the 128 code rows from m0 by TMA once the buffer is free; then for each
// of `chunks` label chunks from kt0 (KG labels apart) the nq quarters of
// weight rows and text columns into the ring (`it` counts the ring's
// iterations).
template <int NB>
__device__ __forceinline__ void load_step(Pipe<NB>& p, const CUtensorMap* mx,
                                          const CUtensorMap* mw,
                                          const CUtensorMap* mt, int ls,
                                          int m0, int kcl, int nq, int kt0,
                                          int chunks, bool codes,
                                          uint32_t& it) {
  if (codes) {
    uint8_t* const dst = codes_free(p, ls);
    uint64_t* const full = &p.cfull[ls % NB];
    wg::bar_expect_tx(full, kcl * 2 * CODES_BOX);
    for (int kc = 0; kc < kcl; ++kc)
      for (int cw = 0; cw < 2; ++cw)
        gemm::tma_load_2d(dst + (kc * 2 + cw) * CODES_BOX, mx, full,
                          kc * 128, m0 + 64 * cw);
  }
  for (int ch = 0; ch < chunks; ++ch)
    for (int q = 0; q < nq; ++q, ++it) {
      const int s = p.r.acquire(it, kcl * W_BOX + 2 * T_BOX);
      for (int kc = 0; kc < kcl; ++kc)
        gemm::tma_load_2d(p.ring[s] + kc * W_BOX, mw, &p.r.full[s], kc * 128,
                          q * EQ);
      for (int b = 0; b < 2; ++b)
        gemm::tma_load_2d(p.ring[s] + W_BYTES + b * T_BOX, mt, &p.r.full[s],
                          q * EQ + 64 * b, kt0 + ch * KG);
    }
}

// A consumer thread's part of one label chunk of the `ls`-th step, whose
// codes have landed (`codes_full`): the fp32 correlate sums cacc of its
// two pixels against the chunk's labels and the row sums ss of e^2
// (`logits` joins them). `last` frees the codes once its last embed has
// read them.
template <int NB>
__device__ __forceinline__ void step_sums(Pipe<NB>& p, const float* sc,
                                          const float* b1, int nq, int ls,
                                          bool last, int cw, uint32_t& it,
                                          float (&ss)[2][2],
                                          float (&cacc)[KT][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) ss[0][h] = ss[1][h] = 0.0f;
#pragma unroll
  for (int lt = 0; lt < KT; ++lt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[lt][e] = 0.0f;
  for (int q = 0; q < nq; ++q, ++it) {
    const int s = p.r.wait(it);
    uint32_t af[8][4];
    {
      int acc[16][4];
      embed(acc, p.codes[ls % NB], p.ring[s], cw);
      if (last && q == nq - 1) {  // the codes are read
        __syncwarp();
        if (threadIdx.x % 32 == 0)
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                           wg::smem_addr(&p.cempty[ls % NB]))
                       : "memory");
      }
      dequant(acc, sc, b1, q * EQ, ss, af);
    }
    correlate(cacc, af, p.ring[s] + W_BYTES);
    __syncwarp();
    if (threadIdx.x % 32 == 0) p.r.release(it);
  }
}

// The x2 align-corners interp operator of `in` source points (lseg_tpu's
// resize._interp_matrix: float64 source position, fp32 weights) for
// output o: the lower source index and its weights (1 - frac, frac).
__device__ __forceinline__ void taps(int o, int in, int& lo, float& a0,
                                     float& a1) {
  if (in == 1) {
    lo = 0;
    a0 = 1.0f;
    a1 = 0.0f;
    return;
  }
  const double src = static_cast<double>(o) * (in - 1) / (2 * in - 1);
  lo = min(max(static_cast<int>(floor(src)), 0), in - 2);
  const double frac = src - lo;
  a0 = static_cast<float>(1.0 - frac);
  a1 = static_cast<float>(frac);
}

}  // namespace head1w
}  // namespace
}  // namespace lseg
