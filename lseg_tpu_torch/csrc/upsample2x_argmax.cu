// Fused x2 bilinear (align_corners=True) upsample + argmax over K for
// Hopper (sm_90a), kernel B11.
//
// Replaces: lseg_tpu/ops/pallas_upsample_argmax.py · upsample2x_argmax
// (Pallas TPU; body _kernel) and its transpose-free twin
// upsample2x_argmax_v2 (_kernel_v2), which compute the same function.
//
// Input: logits (N, H, W, K) in fp32 or bf16 (the template's T) and the
// wrapper's tap tables (ops/upsample_argmax.py · b11_taps): int32
// (3, 2H + 2W), per output row and then per output column the lower source
// index and the bits of its two fp32 weights, each rounded to T. Output:
// (N, 2H, 2W) int32 labels. Rounding points, as in the TPU kernel:
//   H taps:  src = o * ((H-1)/(2H-1))  in fp32; row i weighs
//            max(0, 1 - |src - i|) (two rows at most);
//   hb     = T(w0 * x[i0] + w1 * x[i1])           (fp32 sum, rounded to T)
//   W taps:  the host operator of lseg_tpu/ops/resize.py · _interp_matrix
//            (float64 source position, weights 1 - frac and frac rounded
//            to fp32);
//   up     = a0 * hb[lo] + a1 * hb[lo + 1]        (fp32, not rounded)
//   label  = the first k of the largest up (jnp.argmax: ties to the
//            smallest index, NaN above every number), k < K only.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction), as the plain version computes it, and the taps are the
// plain version's by construction (the tables are built from its
// functions), so the two agree bit for bit.
//
// What bounds it on the card: the bytes. At the flagship (8, 240, 240,
// 150) fp32 the kernel must read 276 MB and write 7.4 MB (0.085 ms at
// 3.35 TB/s); bf16 half of that. Close behind: ~7 SIMT instructions an
// upsampled value in fp32 (two taps from shared memory, two products and
// a sum, a compare, a select and a max; bf16 adds the two taps' unpacking)
// over 276 M values, plus ~2 an H-blended value; and the shared-memory
// wavefronts of the taps (two a warp's 8-byte load) and of the H-blend.
//
// Design: each source element is read from device memory once (and the
// row at a segment's start, and a strip's two edge columns, twice). A
// persistent grid (at most the card's CTAs at once): the tiles (image,
// strip of CW output columns, output row) run image by image, strip by
// strip, row by row, and each CTA takes a contiguous range of them, so it
// walks down a strip and its range's source rows are loaded in order.
//   - A producer warp loads each source row of the range once, as the
//     strip's source columns (contiguous in x: ncols * K values), into a
//     RING-slot ring on mbarriers: one cp.async.bulk where the strip
//     starts and ends on 16 bytes (the wrapper rounds the strip's columns
//     out to the 16-byte quantum q of a column: every strip of a row of a
//     width W with W % q == 0), else by the warp's ordinary loads. A slot
//     is refilled once both consumer groups have released it.
//   - Two consumer groups take every other tile of the range. For its
//     output row a group waits for its two source rows, blends them along
//     H once per (source column, label) into its hb buffer (T, the pitch
//     below; 16-byte vectors where pitch == K) and releases the rows its
//     next tile does not read. Then each output column takes one thread
//     in bf16, two in fp32 (each a contiguous half of the label pairs, so
//     that the one fp32 CTA an SM runs as many warps as two bf16 CTAs):
//     a thread walks its labels in ascending order, two a step (one
//     8-byte, or for bf16 4-byte, shared load per tap), keeps an even-k
//     and an odd-k running best (value, label) that only a strictly larger
//     value replaces, with the values' NaN-propagating max beside it, and
//     joins the two under jnp.argmax's order; a NaN (the max is NaN) sends
//     it through its labels once more for the first NaN. The second half's
//     best goes through shared memory to the first half's thread, which
//     joins it (smaller label on ties) after the group's barrier. The
//     labels go out as one coalesced row of int32 a warp.
//   - hb's row pitch P is the least P >= K with P = 2 (mod 4) elements:
//     a label pair (k, k+1) is one aligned word (8 bytes fp32, 4 bf16),
//     and consecutive source columns lie an odd number of words apart,
//     so the ~17 distinct columns a warp's 32 output columns read fall in
//     distinct banks (fp32: 16 distinct 8-byte banks a wavefront). At K =
//     150, P = K.
// The full-resolution (N, 2H, 2W, K) logits (1.1 GB in fp32) never exist.
// Shared memory: RING slots + 2 hb buffers + barriers + the second
// halves' bests; the wrapper narrows CW (from 128) until they fit: 206 KB
// at the flagship fp32 (one CTA an SM), 110 KB in bf16 (two).

#include "wgmma.cuh"

namespace {

namespace wg = lseg::wg;

constexpr int PIXELS = 128;                // output columns a group at most
constexpr int GROUPS = 2;
constexpr int RING = 3;
constexpr int UNROLL = 8;                  // label pairs a block of the walk

// fp32 (T of 4 bytes) takes two threads a pixel, each walking half of the
// labels, so that a CTA of fp32 buffers (one an SM) holds as many warps as
// the two bf16 CTAs an SM; bf16 one thread a pixel
template <typename T>
struct Shape {
  static constexpr int SPLIT = sizeof(T) / 2;
  static constexpr int GROUP = PIXELS * SPLIT;           // a group's threads
  static constexpr int THREADS = 32 + GROUPS * GROUP;    // + the producer
  static constexpr int CTAS = 3 - SPLIT;                 // an SM at most
};

struct Args {
  const void* x;
  const int* taps;  // (3, L): index, then the bits of the two weights
  int* out;
  int H, W, K;
  int cw;      // output columns a strip
  int strips;
  int q;       // columns a strip's edges are rounded to
  int pitch;   // hb row pitch, elements
  int slot;    // bytes of a ring slot
  int hbb;     // bytes of an hb buffer
  int bulk;    // 1: source strips by cp.async.bulk
  long long tiles;  // N * strips * 2H
};

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float blend(float a, float b, float wa,
                                       float wb) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// the CTA's tiles [t0, t1); a column is one (image, strip), whose tiles
// are its 2H output rows; its part of the range loads source rows
// first(col) .. last(col)
struct Walk {
  const int* th;  // the lower source row of each output row
  int H, H2;
  long long t0, t1;
  __device__ __forceinline__ int first(long long col) const {
    return __ldg(th + (max(t0, col * H2) - col * H2));
  }
  __device__ __forceinline__ int last(long long col) const {
    return min(__ldg(th + (min(t1, (col + 1) * H2) - 1 - col * H2)) + 1,
               H - 1);
  }
  __device__ __forceinline__ int loads(long long col) const {
    return last(col) - first(col) + 1;
  }
};

// a strip's first source column and its count of columns in the slot
struct Strip {
  int c0, nc;
};

__device__ __forceinline__ Strip strip_cols(const Args& a, const int* tw,
                                            int s) {
  const int W2 = 2 * a.W;
  const int j1 = min(s * a.cw + a.cw, W2) - 1;
  const int c0 = __ldg(tw + s * a.cw) / a.q * a.q;
  const int chi = min(__ldg(tw + j1) + 1, a.W - 1);
  const int c1 = min((chi + 1 + a.q - 1) / a.q * a.q, a.W);
  return {c0, c1 - c0};
}

// hb = T(w0 * top + w1 * bot) over the strip's nc source columns, by the
// group's thread t of `threads`: 16-byte vectors where the pitch is K
// (the rows are then one contiguous run, laid out as in the ring), else
// element by element into rows of `pitch`.
__device__ __forceinline__ void hblend(float* hb, const float* top,
                                       const float* bot, float w0, float w1,
                                       int nc, int K, int pitch, int t,
                                       int threads) {
  const int n = nc * K;
  if (pitch == K) {
    const int nv = n / 4;
#pragma unroll 4
    for (int i = t; i < nv; i += threads) {
      const float4 u = reinterpret_cast<const float4*>(top)[i];
      const float4 v = reinterpret_cast<const float4*>(bot)[i];
      reinterpret_cast<float4*>(hb)[i] =
          make_float4(blend(u.x, v.x, w0, w1), blend(u.y, v.y, w0, w1),
                      blend(u.z, v.z, w0, w1), blend(u.w, v.w, w0, w1));
    }
    for (int i = 4 * nv + t; i < n; i += threads)
      hb[i] = blend(top[i], bot[i], w0, w1);
    return;
  }
  for (int i = t; i < n; i += threads) {
    const int c = i / K;
    hb[c * pitch + (i - c * K)] = blend(top[i], bot[i], w0, w1);
  }
}

__device__ __forceinline__ uint32_t blend2(uint32_t a, uint32_t b, float wa,
                                           float wb) {
  return lseg::pack_f32(
      blend(__uint_as_float(a << 16), __uint_as_float(b << 16), wa, wb),
      blend(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u),
            wa, wb));
}

__device__ __forceinline__ void hblend(__nv_bfloat16* hb,
                                       const __nv_bfloat16* top,
                                       const __nv_bfloat16* bot, float w0,
                                       float w1, int nc, int K, int pitch,
                                       int t, int threads) {
  const int n = nc * K;
  if (pitch == K) {
    const int nv = n / 8;
#pragma unroll 4
    for (int i = t; i < nv; i += threads) {
      const uint4 u = reinterpret_cast<const uint4*>(top)[i];
      const uint4 v = reinterpret_cast<const uint4*>(bot)[i];
      reinterpret_cast<uint4*>(hb)[i] =
          make_uint4(blend2(u.x, v.x, w0, w1), blend2(u.y, v.y, w0, w1),
                     blend2(u.z, v.z, w0, w1), blend2(u.w, v.w, w0, w1));
    }
    for (int i = 8 * nv + t; i < n; i += threads)
      hb[i] = __float2bfloat16_rn(blend(__bfloat162float(top[i]),
                                        __bfloat162float(bot[i]), w0, w1));
    return;
  }
  for (int i = t; i < n; i += threads) {
    const int c = i / K;
    hb[c * pitch + (i - c * K)] = __float2bfloat16_rn(
        blend(__bfloat162float(top[i]), __bfloat162float(bot[i]), w0, w1));
  }
}

// labels k and k + 1 of the two taps: (h0[k], h0[k+1]), (h1[k], h1[k+1])
__device__ __forceinline__ void pair(const float* h, int k, float& v0,
                                     float& v1) {
  const float2 p = *reinterpret_cast<const float2*>(h + k);
  v0 = p.x;
  v1 = p.y;
}
__device__ __forceinline__ void pair(const __nv_bfloat16* h, int k,
                                     float& v0, float& v1) {
  const uint32_t p = *reinterpret_cast<const uint32_t*>(h + k);
  v0 = __uint_as_float(p << 16);
  v1 = __uint_as_float(p & 0xffff0000u);
}
__device__ __forceinline__ float one(const float* h, int k) { return h[k]; }
__device__ __forceinline__ float one(const __nv_bfloat16* h, int k) {
  return __bfloat162float(h[k]);
}

// The best (value, label) of one output pixel over the label pairs
// [pb, pe) and, with `tail`, the last label K - 1 (K odd): its taps h0
// (column lo) and h1 (lo + 1) of the blended row, weights a0 and a1.
// Labels run in ascending order in two chains (even and odd labels); a
// chain's label moves only on a strictly larger value, beside the values'
// NaN-propagating max; the chains join in jnp.argmax's order. A NaN (the
// max is NaN) sends the walk through the exact ordered one: its first NaN.
template <typename T>
__device__ __forceinline__ int best_of(const T* h0, const T* h1, float a0,
                                       float a1, int K, int pb, int pe,
                                       bool tail, float& best) {
  float bA = -INFINITY, bB = -INFINITY;  // even and odd labels
  int iA = pe > pb ? 2 * pb : tail ? K - 1 : 0x7fffffff;
  int iB = pe > pb ? 2 * pb + 1 : 0x7fffffff;
  int p0 = pb;
  for (; p0 + UNROLL <= pe; p0 += UNROLL) {
    int jA = -1, jB = -1;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float x0, x1, y0, y1;
      pair(h0, 2 * (p0 + u), x0, x1);
      pair(h1, 2 * (p0 + u), y0, y1);
      const float v0 = blend(x0, y0, a0, a1), v1 = blend(x1, y1, a0, a1);
      if (v0 > bA) jA = u;
      bA = fmax_nan(bA, v0);
      if (v1 > bB) jB = u;
      bB = fmax_nan(bB, v1);
    }
    if (jA >= 0) iA = 2 * (p0 + jA);
    if (jB >= 0) iB = 2 * (p0 + jB) + 1;
  }
  for (; p0 < pe; ++p0) {
    float x0, x1, y0, y1;
    pair(h0, 2 * p0, x0, x1);
    pair(h1, 2 * p0, y0, y1);
    const float v0 = blend(x0, y0, a0, a1), v1 = blend(x1, y1, a0, a1);
    if (v0 > bA) iA = 2 * p0;
    bA = fmax_nan(bA, v0);
    if (v1 > bB) iB = 2 * p0 + 1;
    bB = fmax_nan(bB, v1);
  }
  if (tail) {
    const float v = blend(one(h0, K - 1), one(h1, K - 1), a0, a1);
    if (v > bA) iA = K - 1;
    bA = fmax_nan(bA, v);
  }
  if (__builtin_expect(isnan(bA) || isnan(bB), 0)) {
    best = NAN;
    const int k1 = tail ? K : 2 * pe;
    for (int k = 2 * pb; k < k1; ++k)
      if (isnan(blend(one(h0, k), one(h1, k), a0, a1))) return k;
  }
  const bool odd = lseg::argmax_better(bB, iB, bA, iA);
  best = odd ? bB : bA;
  return odd ? iB : iA;
}

template <typename T>
__global__ void __launch_bounds__(Shape<T>::THREADS, Shape<T>::CTAS)
    upsample2x_argmax_ring_kernel(Args a) {
  constexpr int SPLIT = Shape<T>::SPLIT, GROUP = Shape<T>::GROUP;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ring = smem;
  uint8_t* const hbuf = smem + RING * a.slot;
  uint64_t* const full = reinterpret_cast<uint64_t*>(hbuf + 2 * a.hbb);
  uint64_t* const empty = full + RING;
  // each group's pixels' best (value, label) over the labels of half 1
  float* const part_v = reinterpret_cast<float*>(empty + RING);
  int* const part_i = reinterpret_cast<int*>(part_v + GROUPS * PIXELS);
  const T* const x = static_cast<const T*>(a.x);
  const int L = 2 * a.H + 2 * a.W;
  const int* const th = a.taps;                // rows: lower source row
  const int* const tw = a.taps + 2 * a.H;      // columns: lower column
  const int H2 = 2 * a.H, W2 = 2 * a.W;

  Walk wk;
  wk.th = th;
  wk.H = a.H;
  wk.H2 = H2;
  wk.t0 = a.tiles * blockIdx.x / gridDim.x;
  wk.t1 = a.tiles * (blockIdx.x + 1) / gridDim.x;
  if (wk.t0 >= wk.t1) return;
  const long long col0 = wk.t0 / H2, col1 = (wk.t1 - 1) / H2;
  uint32_t total = 0;  // the range's loads
  for (long long c = col0; c <= col1; ++c) total += wk.loads(c);

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], GROUPS);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    // the producer: every source row of the range, in order
    const int es = static_cast<int>(sizeof(T));
    uint32_t ld = 0;
    for (long long c = col0; c <= col1; ++c) {
      const long long n = c / a.strips;
      const Strip st = strip_cols(a, tw, static_cast<int>(c - n * a.strips));
      const int count = st.nc * a.K;
      for (int r = wk.first(c); r <= wk.last(c); ++r, ++ld) {
        const int s = ld % RING;
        wg::bar_wait(&empty[s], ((ld / RING) & 1) ^ 1);
        const T* src =
            x + ((n * a.H + r) * a.W + st.c0) * static_cast<long long>(a.K);
        T* dst = reinterpret_cast<T*>(ring + s * a.slot);
        if (a.bulk) {
          if (lane == 0) {
            wg::bar_expect_tx(&full[s], count * es);
            wg::bulk_load(dst, src, count * es, &full[s]);
          }
        } else {
          for (int i = lane; i < count; i += 32) dst[i] = src[i];
          __threadfence_block();
          __syncwarp();
          if (lane == 0)
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                             wg::smem_addr(&full[s]))
                         : "memory");
        }
      }
    }
    return;
  }

  const int grp = (warp - 1) / (GROUP / 32);
  const int t = threadIdx.x - 32 - grp * GROUP;
  const int px = t % PIXELS, half = t / PIXELS;  // pixel, half of the labels
  const int kp = a.K / 2, hp = (kp + SPLIT - 1) / SPLIT;
  const int pb = min(half * hp, kp), pe = min(pb + hp, kp);  // label pairs
  const bool tail = (a.K & 1) && half == SPLIT - 1;  // the last label
  T* const hb = reinterpret_cast<T*>(hbuf + grp * a.hbb);
  uint32_t waited = 0, released = 0;  // this group's loads so far
  // the walk's column (image, strip) and what depends on it alone: its
  // first load, first source row, count of loads, image, strip, and this
  // thread's output column of the strip with its taps (64-bit divisions
  // once a column, not once a tile)
  long long col = col0;
  uint32_t base = 0;
  int first = wk.first(col0), loads = wk.loads(col0);
  long long img = 0;
  Strip st{0, 0};
  int j = -1, off0 = 0, off1 = 0;
  float a0 = 0.0f, a1 = 0.0f;
  auto column = [&]() {
    img = col / a.strips;
    const int s = static_cast<int>(col - img * a.strips);
    st = strip_cols(a, tw, s);
    j = s * a.cw + px;
    if (px >= a.cw || j >= W2) {
      j = -1;
      return;
    }
    const int lo = __ldg(tw + j);
    off0 = (lo - st.c0) * a.pitch;
    off1 = off0 + (a.W > 1 ? a.pitch : 0);
    a0 = __int_as_float(__ldg(a.taps + L + 2 * a.H + j));
    a1 = __int_as_float(__ldg(a.taps + 2 * L + 2 * a.H + j));
  };
  column();

  // the group's tiles: output row o of the walk's column, GROUPS apart
  int o = static_cast<int>(wk.t0 - col0 * H2) + grp;
  for (long long tau = wk.t0 + grp; tau < wk.t1; tau += GROUPS, o += GROUPS) {
    while (o >= H2) {  // the next column of the range
      o -= H2;
      base += loads;
      ++col;
      first = wk.first(col);
      loads = wk.loads(col);
      column();
    }
    const int i0 = __ldg(th + o), i1 = min(i0 + 1, a.H - 1);
    const float w0 = __int_as_float(__ldg(a.taps + L + o));
    const float w1 = __int_as_float(__ldg(a.taps + 2 * L + o));
    const uint32_t l0 = base + (i0 - first), l1 = base + (i1 - first);
    for (; waited <= l1; ++waited)
      wg::bar_wait(&full[waited % RING], (waited / RING) & 1);
    hblend(hb, reinterpret_cast<const T*>(ring + (l0 % RING) * a.slot),
           reinterpret_cast<const T*>(ring + (l1 % RING) * a.slot), w0, w1,
           st.nc, a.K, a.pitch, t, GROUP);
    wg::named_sync(1 + grp, GROUP);
    // release the rows this group's next tile does not read
    uint32_t keep = waited;
    if (tau + GROUPS < wk.t1)  // its top row: this column's or the next's
      keep = min(keep, o + GROUPS < H2
                           ? base + (__ldg(th + o + GROUPS) - first)
                           : base + loads +
                                 (__ldg(th + o + GROUPS - H2) -
                                  wk.first(col + 1)));
    if (t == 0)
      for (; released < keep; ++released)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         wg::smem_addr(&empty[released % RING]))
                     : "memory");
    float best = 0.0f;
    int lab = 0;
    if (j >= 0)
      lab = best_of(hb + off0, hb + off1, a0, a1, a.K, pb, pe, tail, best);
    if (SPLIT > 1 && half == 1 && j >= 0) {
      part_v[grp * PIXELS + px] = best;
      part_i[grp * PIXELS + px] = lab;
    }
    wg::named_sync(1 + grp, GROUP);  // before the next H-blend
    if (j >= 0 && half == 0) {
      if (SPLIT > 1 && lseg::argmax_better(part_v[grp * PIXELS + px],
                                           part_i[grp * PIXELS + px], best,
                                           lab))
        lab = part_i[grp * PIXELS + px];
      a.out[(img * H2 + o) * W2 + j] = lab;
    }
  }
  // the rows this group never read: waited for in order, then released,
  // so that the producer can refill every slot the other group needs
  if (t == 0) {
    for (; waited < total; ++waited)
      wg::bar_wait(&full[waited % RING], (waited / RING) & 1);
    for (; released < total; ++released)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       wg::smem_addr(&empty[released % RING]))
                   : "memory");
  }
}

template <typename T>
int launch(const Args& a, int sms, cudaStream_t stream) {
  const int smem = RING * a.slot + 2 * a.hbb + 2 * RING * 8 +
                   GROUPS * PIXELS * 8;
  const auto kernel = upsample2x_argmax_ring_kernel<T>;
  int rc = wg::allow_smem(kernel, smem);
  if (rc != 0) return rc;
  int per_sm = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, Shape<T>::THREADS, smem));
  if (rc != 0) return rc;
  const long long ctas =
      static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  const long long grid = a.tiles < ctas ? a.tiles : ctas;
  kernel<<<static_cast<int>(grid), Shape<T>::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects the logits' dtype (1 bf16, 0 fp32); taps is the int32
// (3, 2h + 2w) table of `b11_taps`; cw, q, pitch, slot, hbb and bulk are
// the geometry of `ops/upsample_argmax.py · b11_geometry` (a strip's
// output columns, its edge quantum, hb's pitch, the bytes of a ring slot
// and of an hb buffer, whether strips go by bulk copy: the strips' bytes
// are then 16-byte aligned); `sms` the card's SMs.
extern "C" int lseg_upsample2x_argmax(const void* x, const void* taps,
                                      void* out, int n, int h, int w, int k,
                                      int x_bf16, int cw, int q, int pitch,
                                      int slot, int hbb, int bulk, int sms,
                                      void* stream) {
  if (n < 1 || h < 1 || w < 1 || k < 1 || cw < 1 || cw > PIXELS || q < 1 ||
      pitch < k || pitch % 4 != 2 || slot % 16 || hbb % 16 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (2 * w + cw - 1) / cw;
  const Args a{x,     static_cast<const int*>(taps), static_cast<int*>(out),
               h,     w,     k,     cw,    strips, q,
               pitch, slot,  hbb,   bulk,
               static_cast<long long>(n) * strips * 2 * h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(a, sms, s) : launch<float>(a, sms, s);
}
