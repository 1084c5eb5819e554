// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan (the Pallas TPU kernel, body
// _ssd_kernel) together with the elementwise prep of its wrapper
// repro/kernels/ops.py::ssd_scan. For each (batch, head) it runs the chunked
// SSD algorithm over the sequence with the (P, N) state carried from chunk to
// chunk:
//
//   a = -exp(a_log), dta = dt a, xdt = x dt
//   cum     = inclusive cumsum of dta over the chunk's rows
//   y       = ((C B^T) . L) xdt + exp(cum) . (C state^T),  L[i,j] = exp(cum_i - cum_j), i >= j
//   state  <- state * exp(cum_last) + (xdt . exp(cum_last - cum))^T B
//
// with B and C shared by the heads of a group (head h reads group h / (H/G)).
// The state starts at zero, or at init (b, H, P, N) when one is given; the
// final state comes back in fp32.
//
// The TPU kernel runs a (batch, head, chunk) grid whose chunk axis executes in
// order and keeps the state in VMEM scratch across it. CUDA blocks run in no
// order, so here a block (or a warpgroup) owns a (batch, head) and loops over
// the chunks itself. Chunks are Q = 64 rows on both routes: chunked SSD is
// exact, so only rounding depends on Q; shorter chunks also keep cum small, so
// exp(cum_i - cum_j) loses fewer bits. The exponent is taken only where
// i >= j (above the diagonal it is positive and could overflow, and inf * 0
// is NaN). A ragged last chunk is masked with zeros: zero dt and x are inert.
//
// Two routes, chosen by the wrapper from the inputs' dtypes, shapes and
// layout before any launch:
//
// * bfloat16 x whose layout ssd_scan.wgmma_layout_error accepts (B and C
//   bf16, P <= 64, N <= 128, multiples of 8, 16 B aligned) ->
//   ssd_wgmma_kernel, on the tensor cores. It reads x (b, S, H, P)
//   and B, C (b, S, G, N) in bf16 as the model hands them over (strided views
//   of one conv output, through TMA tensor maps built from their strides),
//   dt (b, S, H) and a_log (H,) in fp32, and writes y in bf16 or fp32 and the
//   fp32 final state: the wrapper's x.float(), x * dt, dt * a and y casts are
//   folded in. Bound on an H100 at the serving shape (b 10, S 1024, H 80,
//   P 64, N 128): the whole call moves ~244 MB (x and y in bf16 105 MB each,
//   the state 26 MB, dt 3.3 MB, B and C 5.2 MB), 0.0730 ms at 3.35 TB/s
//   (0.0529 ms for one 8192-token prompt). The algorithm's products are
//   ~37 GFLOP (0.037 ms at 989 TFLOP/s), so the call is bound by its bytes;
//   the split products below issue ~80 GFLOP, ~0.08 ms.
//
//   Arithmetic. Factors rounded to bf16 miss the reference's 2e-3 tolerance
//   against the sequential fp32 recurrence (TF32 keeps only three more bits).
//   So x, B and C stay the exact bf16 values they are, dt goes into the
//   factors that multiply them, and every factor computed in fp32 is split
//   into bf16 hi = bf16(v) and lo = bf16(v - hi): ~16 bits of mantissa. The
//   CPU model of this arithmetic in tests/test_torch_ssd_scan.py holds both
//   sides of the tolerance at mamba2-2.7b's head and state sizes. Per 64-row
//   chunk and head, seven m64 products with fp32 accumulators:
//
//     CB    = C B^T                      (smem x smem, both K-major)
//     Y     = C (S_hi + S_lo)^T          (two products; S_hi/lo are bf16
//                                         copies of the fp32 state in smem)
//     Y     = Y . exp(cum_i) + (G_hi + G_lo) x,  G = CB . L . dt_j built in
//                                         registers from CB's accumulator and
//                                         fed as the register A operand; x is
//                                         read MN-major (transposed B)
//     S     = S exp(cum_last) + (W_hi + W_lo)^T B,  W = x . dt_j exp(cum_last
//                                         - cum_j) in registers (x read
//                                         transposed from the TMA tile), B
//                                         read MN-major; S is the fp32
//                                         m64n128 accumulator itself
//
//   Layout. One block per SM (persistent grid) has two consumer warpgroups,
//   each walking its own (batch, head) items, and one producer warpgroup,
//   which gives its registers to the consumers (setmaxnreg 56 / 224) and
//   keeps one thread per consumer issuing TMA loads of each chunk's C, B
//   (64 rows x 128 state columns) and x (64 rows x 64 head columns) into
//   that consumer's two-stage ring (128 B swizzle, rows past S and columns
//   past N or P read as zeros), with "full" and "empty" mbarriers. bf16 y
//   is staged in the chunk's x tile once its products are done and leaves
//   by one TMA store of the 64 x 64 tile. Shared memory per consumer: 2 x
//   40 KB of ring and 32 KB of state hi/lo, 230,464 B per block with the
//   barriers and alignment slack. The state hi/lo is written with ordinary
//   stores and read by wgmma: fence.proxy.async and a warpgroup barrier
//   stand between the two. P up to 64 and N up to 128,
//   each a multiple of 8 (TMA's 16 B strides); smaller P and N are padded
//   with zeros in the tiles.
// * everything else (float32 x, or bf16 x the tensor-core route cannot
//   take) -> ssd_scan_kernel, on the CUDA cores (bf16 splits of fp32 x
//   would need x split too). It takes xdt and dta prepared by the wrapper,
//   one block per (batch*head, P-slice) with the slice's state in shared
//   memory. Rows p of the state and columns p of y depend only on column p
//   of xdt, so a block takes PS = 64, 32 or 16 columns of P: the slice
//   narrows when there are too few (batch, head) pairs to fill the card.
//   fp32 FMAs on 4 x 4 register tiles, each chunk's B, C and xdt staged once
//   in shared memory; bound by the bytes of xdt and y in fp32 (~454 MB,
//   0.1356 ms at the serving shape). N up to 256: at 256 a 64-wide slice
//   takes 231,172 B of shared memory, one block per SM.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // rows per chunk
constexpr int NT = 256;        // threads per block: a 16 x 16 grid
constexpr int MAX_STATE = 256; // N
constexpr int GS = Q + 1;      // padded row of the C B^T tile
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* xdt;
  const float* dta;
  const void* b;
  const void* c;
  const float* init;   // null: the state starts at zero
  float* y;
  float* fin;
  int seq, heads, groups, p, n;
  long long b_bs, b_ss, c_bs, c_ss;  // batch and seq element strides of B and C
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Floats of dynamic shared memory for a P-slice of PS and a padded state of NP.
constexpr int smem_floats(int ps, int np) {
  return 2 * Q * (np + 1)   // B and C chunk tiles
         + Q * ps           // xdt tile
         + Q * GS           // masked, decayed C B^T
         + ps * (np + 1)    // the block's slice of the state
         + 3 * Q + 1;       // cum, exp(cum), exp(cum_last - cum), exp(cum_last)
}

// Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j of each tile it computes. Row strides of NP + 1 and Q + 1 floats
// put the 16 rows a half-warp reads in one column on 16 different banks.
// <= 128 registers up to N 128, where two narrow blocks fit an SM; at N 256
// the tiles take most of an SM's shared memory, so one block
template <typename T, int PS, int NP>
__global__ void __launch_bounds__(NT, (NP > 128 ? 1 : 2))
ssd_scan_kernel(Args a) {
  constexpr int NS = NP + 1;
  constexpr int PB = PS / 16;
  constexpr int NB = NP / 16;
  extern __shared__ float smem[];
  float* s_b = smem;                  // [Q][NS]
  float* s_c = s_b + Q * NS;          // [Q][NS]
  float* s_x = s_c + Q * NS;          // [Q][PS]
  float* s_g = s_x + Q * PS;          // [Q][GS]
  float* s_st = s_g + Q * GS;         // [PS][NS]
  float* s_cum = s_st + PS * NS;      // [Q]
  float* s_ein = s_cum + Q;           // [Q] exp(cum_i)
  float* s_eout = s_ein + Q;          // [Q] exp(cum_last - cum_i)
  float* s_edec = s_eout + Q;         // [1] exp(cum_last)

  const int H = a.heads, P = a.p, N = a.n, S = a.seq;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / a.groups);
  const int p0 = blockIdx.y * PS;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long row = (long long)H * P;  // element stride of a row s in xdt and y

  const T* bp = static_cast<const T*>(a.b) + bi * a.b_bs + (long long)g * N;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_bs + (long long)g * N;
  const float* xp = a.xdt + (long long)bi * S * row + (long long)h * P + p0;
  float* yp = a.y + (long long)bi * S * row + (long long)h * P + p0;
  const float* dp = a.dta + (long long)bi * S * H + h;
  const long long st_off = ((long long)bi * H + h) * P * N + (long long)p0 * N;

  for (int i = tid; i < PS * NP; i += NT) {
    const int r = i / NP, c = i % NP;
    float v = 0.f;
    if (a.init != nullptr && p0 + r < P && c < N) v = a.init[st_off + (long long)r * N + c];
    s_st[r * NS + c] = v;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk no longer reads any tile

    // cum by a warp scan, two rows a lane; rows past S add zero
    if (tid < 32) {
      const int r = c0 + 2 * tid;
      const float d0 = r < S ? dp[(long long)r * H] : 0.f;
      const float d1 = r + 1 < S ? dp[(long long)(r + 1) * H] : 0.f;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
      const float cum0 = excl + d0;
      const float cum1 = cum0 + d1;
      const float last = __shfl_sync(FULL, cum1, 31);
      s_cum[2 * tid] = cum0;
      s_cum[2 * tid + 1] = cum1;
      s_ein[2 * tid] = expf(cum0);
      s_ein[2 * tid + 1] = expf(cum1);
      s_eout[2 * tid] = expf(last - cum0);
      s_eout[2 * tid + 1] = expf(last - cum1);
      if (tid == 0) *s_edec = expf(last);
    }
    for (int i = tid; i < Q * NP; i += NT) {
      const int r = i / NP, c = i % NP;
      const int s = c0 + r;
      float bv = 0.f, cv = 0.f;
      if (s < S && c < N) {
        bv = to_f32(bp[s * a.b_ss + c]);
        cv = to_f32(cp[s * a.c_ss + c]);
      }
      s_b[r * NS + c] = bv;
      s_c[r * NS + c] = cv;
    }
    for (int i = tid; i < Q * PS; i += NT) {
      const int r = i / PS, c = i % PS;
      const int s = c0 + r;
      s_x[i] = (s < S && p0 + c < P) ? xp[s * row + c] : 0.f;
    }
    __syncthreads();

    // G = (C B^T) . L, zero above the diagonal
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < NP; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = s_c[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_b[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          s_g[r * GS + c] = r >= c ? acc[i][j] * expf(s_cum[r] - s_cum[c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(cum) . (C state^T) + G xdt
    {
      float acc[4][PB];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < NP; ++n) {
        float cv[4], sv[PB];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = s_c[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < PB; ++j) sv[j] = s_st[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PB; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = s_ein[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[i][j] *= e;
      }
#pragma unroll 8
      for (int k = 0; k < Q; ++k) {
        float gv[4], xv[PB];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = s_g[(ty + 16 * i) * GS + k];
#pragma unroll
        for (int j = 0; j < PB; ++j) xv[j] = s_x[k * PS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PB; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = c0 + ty + 16 * i;
        if (s >= S) continue;
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const int c = tx + 16 * j;
          if (p0 + c < P) yp[s * row + c] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // state <- state * exp(cum_last) + (xdt . exp(cum_last - cum))^T B
    {
      float acc[PB][NB];
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < Q; ++k) {
        const float e = s_eout[k];
        float xv[PB], bv[NB];
#pragma unroll
        for (int i = 0; i < PB; ++i) xv[i] = s_x[k * PS + ty + 16 * i] * e;
#pragma unroll
        for (int j = 0; j < NB; ++j) bv[j] = s_b[k * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PB; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float dec = *s_edec;
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float* st = &s_st[(ty + 16 * i) * NS + tx + 16 * j];
          *st = *st * dec + acc[i][j];
        }
    }
  }
  __syncthreads();

  for (int i = tid; i < PS * NP; i += NT) {
    const int r = i / NP, c = i % NP;
    if (p0 + r < P && c < N) a.fin[st_off + (long long)r * N + c] = s_st[r * NS + c];
  }
}

// P-slice width: the widest of 64, 32, 16 that covers P, narrowed while the
// grid would give fewer than two blocks per SM.
int slice_width(int batch, int heads, int p) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int ps = p > 32 ? 64 : (p > 16 ? 32 : 16);
  while (ps > 16 && (long long)batch * heads * ((p + ps - 1) / ps) < 2LL * sms) ps /= 2;
  return ps;
}

int state_width(int n) { return n <= 32 ? 32 : (n <= 64 ? 64 : (n <= 128 ? 128 : 256)); }

template <typename T, int PS, int NP>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_floats(PS, NP) * sizeof(float);
  auto kernel = ssd_scan_kernel<T, PS, NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.p + PS - 1) / PS);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int PS>
cudaError_t dispatch_state(const Args& a, int batch, cudaStream_t stream) {
  switch (state_width(a.n)) {
    case 32: return launch<T, PS, 32>(a, batch, stream);
    case 64: return launch<T, PS, 64>(a, batch, stream);
    case 128: return launch<T, PS, 128>(a, batch, stream);
    default: return launch<T, PS, 256>(a, batch, stream);
  }
}

template <typename T>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
  switch (slice_width(batch, a.heads, a.p)) {
    case 16: return dispatch_state<T, 16>(a, batch, stream);
    case 32: return dispatch_state<T, 32>(a, batch, stream);
    default: return dispatch_state<T, 64>(a, batch, stream);
  }
}


// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores, TMA chunk loads into two-stage rings

namespace wg {

constexpr int Q = 64;                 // rows per chunk: wgmma's M
constexpr int PP = 64;                // head dim P, padded
constexpr int NP = 128;               // state dim N, padded
constexpr int STAGES = 2;             // ring depth per consumer
constexpr int CONSUMERS = 2;          // warpgroups, each on its own (batch, head)
constexpr int THREADS = CONSUMERS * 128 + 128;  // and one producer warpgroup
constexpr int PRODUCER_REGS = 56;     // setmaxnreg: the producer gives registers
constexpr int CONSUMER_REGS = 224;    // to the consumers (2 x 128 x 224 + 128 x 56 <= 64 K)
constexpr int COLS = 64;              // bf16 per 128 B swizzled row
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROW_BYTES = COLS * 2;
constexpr int CB_BYTES = Q * ROW_BYTES;            // one 64-column block of 64 rows
constexpr int BC_BYTES = (NP / COLS) * CB_BYTES;   // a B or C tile, 64 rows x 128
constexpr int X_BYTES = (PP / COLS) * CB_BYTES;    // an x tile, 64 rows x 64
constexpr int STAGE_BYTES = 2 * BC_BYTES + X_BYTES;
constexpr int STATE_BYTES = 2 * BC_BYTES;          // state hi and lo, 64 rows p x 128 n each
constexpr int WG_BYTES = STAGES * STAGE_BYTES + STATE_BYTES;
constexpr int BAR_BYTES = CONSUMERS * STAGES * 2 * 8;
constexpr int SMEM_BYTES = 1024 + CONSUMERS * WG_BYTES + BAR_BYTES;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");

struct Args {
  const float* dt;      // (b, S, H) fp32, element strides dt_bs, dt_ss, dt_hs
  const float* a_log;   // (H,) fp32
  const float* init;    // null, or contiguous (b, H, P, N) fp32
  void* y;              // contiguous (b, S, H, P), bf16 or fp32 (y_f32)
  float* fin;           // contiguous (b, H, P, N) fp32
  long long dt_bs, dt_ss, dt_hs;
  int seq, heads, groups, p, n, n_items, y_f32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// y tile from shared memory to global memory; rows and columns past the
// tensor's bounds are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// returns once the committed bulk stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// returns once the committed bulk stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128 B swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t desc = 0;
  desc |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  desc |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  desc |= static_cast<uint64_t>(1) << 62;  // SWIZZLE_128B
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Tells the compiler that the registers may change here, so that no read or
// write of an accumulator moves across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// ordinary shared-memory stores made visible to wgmma's async proxy, then a
// barrier over this consumer warpgroup's 128 threads only
__device__ __forceinline__ void publish_to_wgmma(int warpgroup) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + warpgroup) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v ~ hi + lo with hi = bf16(v) and lo = bf16(v - hi), for a pair of values:
// the packed hi pair and lo pair
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l / 8, row l % 8; register m gets, of matrix m, the
// pair (row 2 (l % 4), column l / 4), (row 2 (l % 4) + 1, column l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 64, fp32) = A (64 x 16, smem, K-major) * B (64 x 16, smem, K-major) [+ D]
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}


// Byte offset of element (row, col) of a 64-row tile stored as 64-column
// blocks in TMA's 128 B swizzle: the 16 B chunk index is XORed with the
// row's index in its 8-row atom (tiles are 1024 B aligned)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (col / COLS) * CB_BYTES + row * ROW_BYTES + ((((col % COLS) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// The fp32 state accumulator as bf16 hi and lo copies in shared memory, in
// the K-major layout of the B operand of C state^T (rows p, columns n)
__device__ __forceinline__ void store_state(const float (&st)[64], unsigned char* hi,
                                            unsigned char* lo, int r0, int quad) {
#pragma unroll
  for (int jb = 0; jb < NP / 8; ++jb) {
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
      uint32_t h, l;
      split_pair(st[4 * jb + 2 * ph], st[4 * jb + 2 * ph + 1], &h, &l);
      const uint32_t off = swz(r0 + 8 * ph, 8 * jb + 2 * quad);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  }
}

// Thread t of a consumer warpgroup holds, in every m64 accumulator, rows
// r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8 and, in each 8-column block
// jb, columns 8 jb + 2 (t % 4) (+ 1): element 4 jb + e is row +8 if e >= 2
// and column +1 if e is odd. Packed in bf16 pairs, the same layout is the
// register A fragment: pairs 4 kk .. 4 kk + 3 feed k16 step kk.
//
// Each warp scans the chunk's 64 dta values itself (lane l holds rows 2 l and
// 2 l + 1), and a thread fetches the cum and dt of its rows and columns by
// shuffles: no shared memory and no barrier for the cumsum.
//
// Per chunk a consumer commits four groups of products: (1) C B^T and (2)
// C (S_hi + S_lo)^T together; it builds G from C B^T while (2) runs, then
// W from the x tile; it scales Y's rows and the state and commits (3)
// Y += G x and (4) the state update, and writes y to the x tile while (4)
// runs. The state chain (the update, then the next chunk's C S^T) is the
// only serial dependence between chunks; the producer has the next chunk's
// tiles in flight meanwhile. bf16 y leaves through the stage's x tile by a
// TMA store, and the stage is released once that store has read it, after
// the next chunk's first products are issued.
__global__ void __launch_bounds__(THREADS, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const __grid_constant__ CUtensorMap tm_y, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + CONSUMERS * WG_BYTES;
  auto full_bar = [&](int w, int s) { return bars + 8 * (w * STAGES + s); };
  auto empty_bar = [&](int w, int s) { return bars + 8 * ((CONSUMERS + w) * STAGES + s); };
  const int H = a.heads, S = a.seq;
  const int rep = H / a.groups;
  const int step = CONSUMERS * gridDim.x;   // items of consumer w: blockIdx.x + w grid, + step, ...

  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w)
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full_bar(w, s), 1);
        mbar_init(empty_bar(w, s), 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == CONSUMERS) {
    // producer warpgroup: lane 0 of warp w fills consumer w's ring; a stage
    // is refilled once the consumer has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int w = (threadIdx.x % 128) / 32;
    if (w >= CONSUMERS || threadIdx.x % 32 != 0) return;
    int it = 0;
    for (int item = blockIdx.x + w * gridDim.x; item < a.n_items; item += step) {
      const int b = item / H, h = item % H, g = h / rep;
      for (int c0 = 0; c0 < S; c0 += Q, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty_bar(w, s), ((it / STAGES) - 1) & 1);
        const uint32_t full = full_bar(w, s);
        const uint32_t stage = base + w * WG_BYTES + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
        for (int cb = 0; cb < NP / COLS; ++cb) {
          tma_load_4d(stage + cb * CB_BYTES, &tm_c, full, cb * COLS, c0, g, b);
          tma_load_4d(stage + BC_BYTES + cb * CB_BYTES, &tm_b, full, cb * COLS, c0, g, b);
        }
#pragma unroll
        for (int cb = 0; cb < PP / COLS; ++cb)
          tma_load_4d(stage + 2 * BC_BYTES + cb * CB_BYTES, &tm_x, full, cb * COLS, c0, h, b);
      }
    }
    return;
  }

  // consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int w = warpgroup;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int P = a.p, N = a.n;
  const uint32_t region = base + w * WG_BYTES;
  const uint32_t st_hi = region + STAGES * STAGE_BYTES;
  const uint32_t st_lo = st_hi + BC_BYTES;
  unsigned char* const gregion = smem_raw + (region - raw);      // generic pointers
  unsigned char* const g_hi = gregion + STAGES * STAGE_BYTES;
  unsigned char* const g_lo = g_hi + BC_BYTES;
  const long long row = (long long)H * P;                        // y's element stride per s

  float cb[32], y[32], st[64];
  int pending = -1;                                  // stage whose y tile is being stored
#pragma unroll
  for (int i = 0; i < 32; ++i) cb[i] = y[i] = 0.f;
  int it = 0;
  for (int item = blockIdx.x + w * gridDim.x; item < a.n_items; item += step) {
    const int b = item / H, h = item % H;
    const float A = -expf(a.a_log[h]);
    const float* dtp = a.dt + b * a.dt_bs + h * a.dt_hs;
    const long long st_off = (long long)item * P * N;            // item = b H + h

#pragma unroll
    for (int jb = 0; jb < NP / 8; ++jb) {
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int p = r0 + 8 * ph, n = 8 * jb + 2 * quad;
        float2 v = make_float2(0.f, 0.f);
        if (a.init != nullptr && p < P && n < N)
          v = *reinterpret_cast<const float2*>(a.init + st_off + (long long)p * N + n);
        st[4 * jb + 2 * ph] = v.x;
        st[4 * jb + 2 * ph + 1] = v.y;
      }
    }
    store_state(st, g_hi, g_lo, r0, quad);
    publish_to_wgmma(w);

    // dt of rows 2 lane and 2 lane + 1, loaded one chunk ahead
    float dn0 = 2 * lane < S ? dtp[(long long)(2 * lane) * a.dt_ss] : 0.f;
    float dn1 = 2 * lane + 1 < S ? dtp[(long long)(2 * lane + 1) * a.dt_ss] : 0.f;
    for (int c0 = 0; c0 < S; c0 += Q, ++it) {
      const int s = it % STAGES;
      const float dt0 = dn0, dt1 = dn1;
      {
        const int r = c0 + Q + 2 * lane;
        dn0 = r < S ? dtp[(long long)r * a.dt_ss] : 0.f;
        dn1 = r + 1 < S ? dtp[(long long)(r + 1) * a.dt_ss] : 0.f;
      }
      // cum over the chunk; rows past S add zero
      const float x0 = dt0 * A, x1 = dt1 * A;
      float incl = x0 + x1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float cum0 = excl + x0;
      const float cum1 = cum0 + x1;
      const float last = __shfl_sync(0xffffffffu, cum1, 31);
      float ci[2];                                   // cum of rows r0 and r0 + 8
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const float u0 = __shfl_sync(0xffffffffu, cum0, (r0 >> 1) + 4 * ph);
        const float u1 = __shfl_sync(0xffffffffu, cum1, (r0 >> 1) + 4 * ph);
        ci[ph] = (r0 & 1) ? u1 : u0;
      }

      const uint32_t stage = region + s * STAGE_BYTES;
      const uint32_t c_addr = stage;
      const uint32_t b_addr = stage + BC_BYTES;
      const uint32_t x_addr = stage + 2 * BC_BYTES;
      mbar_wait(full_bar(w, s), (it / STAGES) & 1);

      // group 1: C B^T; group 2: C (S_hi + S_lo)^T
      fence_regs(cb);
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const uint32_t off = (kk / 4) * CB_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(cb, make_desc(c_addr + off, 16, 1024),
                           make_desc(b_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const uint32_t off = (kk / 4) * CB_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(y, make_desc(c_addr + off, 16, 1024),
                           make_desc(st_hi + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const uint32_t off = (kk / 4) * CB_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(y, make_desc(c_addr + off, 16, 1024),
                           make_desc(st_lo + off, 16, 1024), 1);
      }
      wgmma_commit();
      if (pending >= 0) {                            // the last y tile has left its stage
        tma_store_wait_read();
        mbar_arrive(empty_bar(w, pending));
        pending = -1;
      }

      wgmma_wait<1>();                               // C B^T is ready
      fence_regs(cb);
      // G = C B^T . L . dt_j, zero above the diagonal, as register A fragments
      uint32_t gh[16], gl[16];
#pragma unroll
      for (int jb = 0; jb < Q / 8; ++jb) {
        const int src = 4 * jb + quad;
        const float cj0 = __shfl_sync(0xffffffffu, cum0, src);
        const float cj1 = __shfl_sync(0xffffffffu, cum1, src);
        const float dj0 = __shfl_sync(0xffffffffu, dt0, src);
        const float dj1 = __shfl_sync(0xffffffffu, dt1, src);
        const int j = 8 * jb + 2 * quad;
#pragma unroll
        for (int ph = 0; ph < 2; ++ph) {
          const int i = r0 + 8 * ph;
          // the exponent's difference first: cum is large, its difference small
          const float e0 = fast_exp2((ci[ph] - cj0) * LOG2E);
          const float e1 = fast_exp2((ci[ph] - cj1) * LOG2E);
          const float v0 = i >= j ? cb[4 * jb + 2 * ph] * e0 * dj0 : 0.f;
          const float v1 = i >= j + 1 ? cb[4 * jb + 2 * ph + 1] * e1 * dj1 : 0.f;
          split_pair(v0, v1, &gh[2 * jb + ph], &gl[2 * jb + ph]);
        }
      }

      // W^T as the A operand of the update: A[p][j] = x[j][p] dt_j exp(last - cum_j),
      // x read transposed from the swizzled tile: matrix m of k16 step kk is
      // rows j 16 kk + 8 (m / 2) .. + 7, columns p 16 (t / 32) + 8 (m % 2) .. + 7
      uint32_t wh[16], wl[16];
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        uint32_t xr[4];
        const int m = lane / 8;
        ldmatrix_x4_trans(x_addr + swz(16 * kk + 8 * (m / 2) + lane % 8,
                                       16 * (t / 32) + 8 * (m % 2)), xr);
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int src = 4 * (2 * kk + hb) + quad;  // the lane holding rows j, j + 1
          const float w0 = __shfl_sync(0xffffffffu, dt0, src) *
                           fast_exp2((last - __shfl_sync(0xffffffffu, cum0, src)) * LOG2E);
          const float w1 = __shfl_sync(0xffffffffu, dt1, src) *
                           fast_exp2((last - __shfl_sync(0xffffffffu, cum1, src)) * LOG2E);
#pragma unroll
          for (int ph = 0; ph < 2; ++ph) {
            const int k = 4 * kk + 2 * hb + ph;
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[2 * hb + ph]));
            split_pair(xv.x * w0, xv.y * w1, &wh[k], &wl[k]);
          }
        }
      }

      wgmma_wait<0>();                               // C S^T is ready; S is read no more
      fence_regs(y);
      const float ein0 = expf(ci[0]), ein1 = expf(ci[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] *= ((i >> 1) & 1) ? ein1 : ein0;
      const float dec = expf(last);
#pragma unroll
      for (int i = 0; i < 64; ++i) st[i] *= dec;
      fence_regs(y);
      fence_regs(st);
      wgmma_fence();
      // group 3: Y += (G_hi + G_lo) x
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint64_t desc = make_desc(x_addr + kk * 2048, CB_BYTES, 1024);
        wgmma_m64n64k16_rs(y, gh[4 * kk], gh[4 * kk + 1], gh[4 * kk + 2], gh[4 * kk + 3], desc, 1);
        wgmma_m64n64k16_rs(y, gl[4 * kk], gl[4 * kk + 1], gl[4 * kk + 2], gl[4 * kk + 3], desc, 1);
      }
      wgmma_commit();
      // group 4: S <- S exp(cum_last) + (W_hi + W_lo)^T B
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint64_t desc = make_desc(b_addr + kk * 2048, CB_BYTES, 1024);
        wgmma_m64n128k16_rs(st, wh[4 * kk], wh[4 * kk + 1], wh[4 * kk + 2], wh[4 * kk + 3], desc, 1);
        wgmma_m64n128k16_rs(st, wl[4 * kk], wl[4 * kk + 1], wl[4 * kk + 2], wl[4 * kk + 3], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                               // Y is done; the update runs on
      fence_regs(y);
      unsigned char* const yt = gregion + s * STAGE_BYTES + 2 * BC_BYTES;
#pragma unroll
      for (int jb = 0; jb < PP / 8; ++jb) {
        const int p = 8 * jb + 2 * quad;
#pragma unroll
        for (int ph = 0; ph < 2; ++ph) {
          const float v0 = y[4 * jb + 2 * ph], v1 = y[4 * jb + 2 * ph + 1];
          const int i = c0 + r0 + 8 * ph;
          if (!a.y_f32) {
            // bf16 y into the x tile, which the products of this chunk read no more
            *reinterpret_cast<uint32_t*>(yt + swz(r0 + 8 * ph, p)) = pack_bf16(v0, v1);
          } else if (p < P && i < S) {
            const long long off = ((long long)b * S + i) * row + (long long)h * P + p;
            *reinterpret_cast<float2*>(static_cast<float*>(a.y) + off) = make_float2(v0, v1);
          }
        }
      }
      wgmma_wait<0>();                               // the update is done
      fence_regs(st);
      store_state(st, g_hi, g_lo, r0, quad);
      publish_to_wgmma(w);                           // for the y store and the next C S^T
      if (!a.y_f32 && t == 0) {
        // the stage is released once the store has read the tile, after the
        // next chunk's first products are issued
        tma_store_4d(&tm_y, x_addr, 0, c0, h, b);
        pending = s;
      } else {
        mbar_arrive(empty_bar(w, s));                // the stage's tiles are read no more
      }
    }

#pragma unroll
    for (int jb = 0; jb < NP / 8; ++jb) {
      const int n = 8 * jb + 2 * quad;
      if (n >= N) continue;
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int p = r0 + 8 * ph;
        if (p < P)
          *reinterpret_cast<float2*>(a.fin + st_off + (long long)p * N + n) =
              make_float2(st[4 * jb + 2 * ph], st[4 * jb + 2 * ph + 1]);
      }
    }
  }
  if (pending >= 0) tma_store_wait();                // the last y tile is written
}

}  // namespace wg

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint(ByVersion) so
// that the library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_NO_ENCODE = -1;   // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = -2;  // cuTensorMapEncodeTiled refused the layout

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (inner, S, mid, batch) bf16 tensor with element strides (ss, sm, sb) for
// the outer three; box of 64 columns x 64 rows of one head or group;
// out-of-bounds elements read as zero
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int inner, int s, int mid,
              int b, long long ss, long long sm, long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)s, (cuuint64_t)mid, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sm * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::COLS, (cuuint32_t)wg::Q, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one persistent block per SM, two (batch, head) items in flight per block
int wgmma_grid(long long items) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(items < sms ? items : sms);
}

}  // namespace

extern "C" {

// The fp32 route. xdt (batch, seq, heads, p) and dta (batch, seq, heads):
// contiguous fp32. b, c (batch, seq, groups, n): (groups, n) contiguous,
// batch and seq strides given in elements; dtype 0 = float32, 1 = bfloat16
// (both alike). init: null or contiguous fp32 (batch, heads, p, n). y and
// fin: contiguous fp32 outputs of xdt's and init's shapes.
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int ssd_scan_fwd(const float* xdt, const float* dta, const void* b, const void* c,
                 const float* init, float* y, float* fin, int batch, int seq,
                 int heads, int groups, int p, int n, long long b_bs, long long b_ss,
                 long long c_bs, long long c_ss, int dtype, void* stream) {
  if (batch < 1 || seq < 0 || heads < 1 || groups < 1 || heads % groups != 0 || p < 1 ||
      n < 1 || n > MAX_STATE || (dtype != 0 && dtype != 1) ||
      (long long)batch * heads > 2147483647LL || (p + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{xdt, dta, b, c, init, y, fin, seq, heads, groups, p, n,
               b_bs, b_ss, c_bs, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, batch, s);
  return (int)dispatch<__nv_bfloat16>(a, batch, s);
}

// The fp32 route's launch for these sizes: plan[0] chunk rows, plan[1]
// P-slice width, plan[2] padded state width, plan[3] dynamic shared memory
// bytes of one block (ptxas -v does not report dynamic shared memory).
int ssd_scan_plan(int batch, int heads, int p, int n, int* plan) {
  if (batch < 1 || heads < 1 || p < 1 || n < 1 || n > MAX_STATE) return (int)cudaErrorInvalidValue;
  const int ps = slice_width(batch, heads, p);
  const int np = state_width(n);
  plan[0] = Q;
  plan[1] = ps;
  plan[2] = np;
  plan[3] = (int)(smem_floats(ps, np) * sizeof(float));
  return 0;
}

// The bf16 route. x (batch, seq, heads, p), b and c (batch, seq, groups, n):
// bf16 with a contiguous last dim; strides[0..8] are the element strides of
// (batch, seq, head or group) of x, b and c in turn, each a multiple of 8
// (16 B, for TMA), with 16 B aligned base pointers. dt (batch, seq, heads)
// fp32 with element strides strides[9..11]; a_log (heads,) fp32. init: null
// or contiguous fp32 (batch, heads, p, n). y: contiguous (batch, seq, heads,
// p), fp32 if y_f32 else bf16; fin: contiguous fp32 (batch, heads, p, n).
// p and n multiples of 8, p <= 64, n <= 128, seq >= 1.
// Returns a cudaError_t (the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take), ERR_NO_ENCODE or ERR_TENSOR_MAP.
int ssd_scan_fwd_wgmma(const void* x, const float* dt, const float* a_log, const void* b,
                       const void* c, const float* init, void* y, float* fin, int batch,
                       int seq, int heads, int groups, int p, int n, const long long* strides,
                       int y_f32, void* stream) {
  const long long items = (long long)batch * heads;
  if (batch < 1 || seq < 1 || heads < 1 || groups < 1 || heads % groups != 0 || p < 8 ||
      p > wg::PP || p % 8 != 0 || n < 8 || n > wg::NP || n % 8 != 0 || items > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap tx, tb, tc, ty;
  if (!make_map(encode, &tx, x, p, seq, heads, batch, strides[1], strides[2], strides[0]) ||
      !make_map(encode, &tb, b, n, seq, groups, batch, strides[4], strides[5], strides[3]) ||
      !make_map(encode, &tc, c, n, seq, groups, batch, strides[7], strides[8], strides[6]))
    return ERR_TENSOR_MAP;
  // bf16 y goes out by TMA stores of 64-row tiles; fp32 y by the threads
  ty = tx;
  if (!y_f32 && !make_map(encode, &ty, y, p, seq, heads, batch, (long long)heads * p, p,
                          (long long)seq * heads * p))
    return ERR_TENSOR_MAP;
  auto kernel = wg::ssd_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const wg::Args a{dt, a_log, init, y, fin, strides[9], strides[10], strides[11],
                   seq, heads, groups, p, n, (int)items, y_f32};
  kernel<<<wgmma_grid(items), wg::THREADS, wg::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tx, tb, tc, ty, a);
  return (int)cudaGetLastError();
}

// The bf16 route's launch for these sizes: plan[0] chunk rows, plan[1]
// (batch, head) items in flight per block (one per consumer warpgroup),
// plan[2] ring stages per consumer, plan[3] dynamic shared memory bytes of
// one block, plan[4] blocks in the persistent grid.
int ssd_scan_wgmma_plan(int batch, int heads, int* plan) {
  if (batch < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  plan[0] = wg::Q;
  plan[1] = wg::CONSUMERS;
  plan[2] = wg::STAGES;
  plan[3] = wg::SMEM_BYTES;
  plan[4] = wgmma_grid((long long)batch * heads);
  return 0;
}

const char* ssd_scan_error_string(int err) {
  if (err == ERR_NO_ENCODE) return "libcuda offers no cuTensorMapEncodeTiled";
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused an x/B/C/y layout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
