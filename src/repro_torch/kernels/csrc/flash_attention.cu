// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas TPU
// kernel, body _attn_kernel). Computes softmax(q k^T * scale + mask) v with
// GQA (q head h reads kv head h / (Hq/Hkv), nothing replicated), a top-left
// aligned causal mask (key c visible to query r iff r - c >= 0), an optional
// sliding window (r - c < window) and masked out-of-range keys. Masked logits
// take the finite -1e30 of the reference; a row with no live kv tile outputs
// 0. Sums are fp32; the output has the inputs' dtype.
//
// Bound on an H100: causal attention at the serving shape (q (10, 32, 1024,
// 128), k/v (10, 8, 1024, 128), bf16) does ~86 GFLOP of products over ~210 MB
// of inputs and output, ~400 FLOP per byte, so it is bound by operations:
// 0.0869 ms at the 989 TFLOP/s bf16 tensor-core rate (~0.063 ms to move the
// bytes).
//
// Two routes, chosen by the wrapper from the dtype alone:
//
// * bfloat16 -> flash_fwd_wgmma_kernel, on the tensor cores. A persistent
//   grid, one block per SM, walks the (batch*head, 128-query tile) items,
//   heaviest first in the causal case, in a snake order over the blocks.
//   A block has two consumer warpgroups of 64 query rows each and one
//   producer warpgroup, which hands most of its registers to the consumers
//   (setmaxnreg) and keeps one thread issuing TMA loads: Q once per item,
//   K and V tiles of 128 keys (64 at head_dim 256) into a two-stage ring
//   (4-D tensor maps over
//   (D, S, H, B) built from the caller's strides, 128 B swizzle, rows past
//   the sequence and columns past D read as zeros), with mbarriers for
//   "full" and "empty" on every stage and on Q. Both products are
//   wgmma.mma_async with fp32 accumulators in registers: S = Q K^T from
//   shared memory (both K-major), and O += P V with P, the softmax
//   numerators rounded to bf16, taken straight from the S accumulator as
//   the register A operand (the m64 accumulator and A fragments share one
//   layout) and V read MN-major (transposed B). Each warpgroup issues
//   S_i = Q K_i^T and O += P_{i-1} V_{i-1} together and runs the softmax
//   of tile i while the PV product is on the tensor cores. The softmax
//   uses exp2 with scale * log2(e) folded into one FFMA; only tiles that
//   straddle the diagonal, the window edge or Sk evaluate the mask. Head
//   dims up to 64 run one 64-wide column block, up to 128 two, up to 256
//   four; the zeros TMA fills in past D add nothing and are never stored.
//   At head_dim 256 the K/V tiles hold 64 keys, so that Q (64 KB) and the
//   ring (2 x (K + V) x 32 KB) fit one block's shared memory; a consumer
//   thread then holds the 64 x 256 O accumulator in 128 registers and the
//   64 x 64 S tile in 32, and the PV product runs as two m64n128 halves.
// * float32 -> flash_fwd_kernel, on the CUDA cores. Tensor cores would take
//   fp32 as TF32, which misses the reference's float32 tolerance, so this
//   route keeps the first port's design: one block per (batch*head, 64-query
//   tile), each tile staged once in shared memory, fp32 FMAs, the online
//   softmax state in registers. Head dims up to 256 (one block per SM at
//   256: 194 KB of shared memory).
//
// The TPU kernel runs its kv grid axis in order and carries (m, l, acc) in
// VMEM scratch across it. CUDA blocks run in no order, so both routes loop
// over the kv tiles of a query tile inside the block, covering only the
// tiles that the causal and window limits leave live: the same tiles the
// Pallas kernel keeps live at its default 128 x 128 blocks (bf16) or at
// 64 x 64 blocks (fp32).
//
// Layout: every tensor is (batch, heads, seq, head_dim) addressed through
// element strides for batch, head and seq, with a contiguous head_dim, so the
// caller can pass transposed views of (batch, seq, heads, head_dim) tensors.
// The bf16 route needs 16 B aligned base pointers and strides (TMA).

#include <cuda.h>  // CUtensorMap and its enums; libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int KSTRIDE = BK + 1;  // padded row of the transposed K / P tile

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int DP>
constexpr int smem_floats() {
  // Q tile (BQ x DP+4) + transposed K tile / P tile + V tile (BK x DP)
  return BQ * (DP + 4) + (DP > BQ ? DP : BQ) * KSTRIDE + BK * DP;
}

// Thread (ty, tx) owns query rows ty + 16*i (i < 4), score columns
// tx + 16*j (j < 4) and output columns tx + 16*j (j < DP/16). The 16 threads
// that share a row sit in one half-warp, so row reductions are shuffles.
// two blocks per SM (<= 128 registers) up to head_dim 128; at 256 the tiles
// take one SM's shared memory, so one block with up to 255 registers
template <typename T, int DP>
__global__ void __launch_bounds__(NT, (DP > 128 ? 1 : 2))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int group,
                 int sq, int sk, int d, Strides st, float scale, int causal,
                 int window) {
  constexpr int QSTRIDE = DP + 4;
  constexpr int DJ = DP / 16;
  extern __shared__ float smem[];
  float* s_q = smem;                               // [BQ][QSTRIDE]
  float* s_kt = s_q + BQ * QSTRIDE;                // [DP][KSTRIDE], then P [BQ][KSTRIDE]
  float* s_v = s_kt + (DP > BQ ? DP : BQ) * KSTRIDE;  // [BK][DP]

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / group;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  // q * scale in fp32, as the Pallas kernel scales q before the product;
  // rows past sq and columns past d are zero
  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_f32(qp[(long long)(q0 + r) * st.qs + c]) * scale;
    s_q[r * QSTRIDE + c] = x;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // live kv range of this query tile
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(sk, q0 + BQ) : sk;

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's P and V are no longer read
    for (int i = tid; i < BK * DP; i += NT) {
      const int c = i / DP, e = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < sk && e < d) {
        kx = to_f32(kp[(long long)(k0 + c) * st.ks + e]);
        vx = to_f32(vp[(long long)(k0 + c) * st.vs + e]);
      }
      s_kt[e * KSTRIDE + c] = kx;
      s_v[c * DP + e] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < DP; ++e) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty + 16 * i) * QSTRIDE + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_kt[e * KSTRIDE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask and online softmax, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        bool ok = c < sk;
        if (causal) ok = ok && (r - c >= 0);
        if (window > 0) ok = ok && (r - c < window);
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // finite -1e30 on both sides gives exp(0) = 1, never NaN
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done with the K tile
    float* s_p = s_kt;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_p[(ty + 16 * i) * KSTRIDE + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty + 16 * i) * KSTRIDE + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = s_v[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) op[(long long)r * st.os + c] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int hq, int hkv, int sq, int sk, int d, const Strides& st,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DP>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hq / hkv, sq, sk, d, st, scale, causal, window);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores, TMA loads into a two-stage ring

namespace wg {

constexpr int BM = 128;             // query rows per block
constexpr int STAGES = 2;           // K/V ring depth
constexpr int CONSUMERS = 2;        // warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS * 128 + 128;  // and one producer warpgroup
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: the producer gives registers
constexpr int CONSUMER_REGS = 232;  // to the consumers (2 x 128 x 232 + 128 x 40 <= 64 K)
constexpr int COLS = 64;            // bf16 per 128 B swizzled row
constexpr int ROW_BYTES = COLS * 2;
constexpr float LOG2E = 1.4426950408889634f;

// keys per kv tile: 128, or 64 at head_dim 256, where a two-stage ring of
// 128-key tiles would not fit shared memory
template <int DP>
__host__ __device__ constexpr int block_n() { return DP > 128 ? 64 : 128; }

// A tile of R rows is stored as DP / 64 column blocks of R rows x 128 B,
// each in TMA's 128 B swizzle (1024 B atoms of 8 rows), 1024 B aligned.
template <int DP>
__host__ __device__ constexpr int tile_bytes(int rows) { return (DP / COLS) * rows * ROW_BYTES; }
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  // alignment slack + Q + STAGES x (K + V) + 9 mbarriers (padded to 128 B)
  return 1024 + tile_bytes<DP>(BM) + STAGES * 2 * tile_bytes<DP>(block_n<DP>()) + 128;
}

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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) = A (64 x 16, smem, K-major) * B (128 x 16, smem, K-major) [+ D]
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
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


// S (64 x BN keys) = Q (this warpgroup's 64 rows) K^T, both K-major in
// shared memory: each k16 step moves 32 B along the swizzled row, each 64
// columns a column block. Issued, not waited for.
template <int DP>
__device__ __forceinline__ void qk_gemm(float (&sc)[block_n<DP>() / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
  constexpr int BN = block_n<DP>();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t desc_q = make_desc(q_addr + (kk / 4) * BM * ROW_BYTES + off, 16, 1024);
    const uint64_t desc_k = make_desc(k_addr + (kk / 4) * BN * ROW_BYTES + off, 16, 1024);
    if constexpr (BN == 128) {
      wgmma_m64n128k16_ss(sc, desc_q, desc_k, kk > 0);
    } else {
      wgmma_m64n64k16_ss(sc, desc_q, desc_k, kk > 0);
    }
  }
}

// O (64 x DP) += P (64 x BN keys, bf16 pairs in registers) V. V is BN keys
// x DP, MN-major: 8 keys per 1024 B atom (SBO), 64 columns per column block
// (LBO); each k16 step moves two atoms. k16 step kk takes P's 8-column
// blocks 2 kk and 2 kk + 1. At head_dim 256 the product runs as two m64n128
// halves over column blocks 0-1 and 2-3, whose accumulators are O's
// elements 0-63 and 64-127 (the m64n256 fragment's order). Issued, not
// waited for.
template <int DP>
__device__ __forceinline__ void pv_gemm(float (&o)[DP / 2], const uint32_t (&pa)[block_n<DP>() / 4],
                                        uint32_t v_addr) {
  constexpr int BN = block_n<DP>();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t desc = make_desc(v_addr + kk * 2048, BN * ROW_BYTES, 1024);
    if constexpr (DP == 256) {
      const uint64_t desc_hi = make_desc(v_addr + 2 * BN * ROW_BYTES + kk * 2048,
                                         BN * ROW_BYTES, 1024);
      float (&lo)[64] = *reinterpret_cast<float (*)[64]>(&o[0]);
      float (&hi)[64] = *reinterpret_cast<float (*)[64]>(&o[64]);
      wgmma_m64n128k16_rs(lo, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], desc, 1);
      wgmma_m64n128k16_rs(hi, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], desc_hi,
                          1);
    } else if constexpr (DP == 128) {
      wgmma_m64n128k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], desc, 1);
    } else {
      wgmma_m64n64k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], desc, 1);
    }
  }
}

// P's bf16 pairs in the register A layout of the m64 k16 product: the
// accumulator's elements 8 kk .. 8 kk + 7 are the A fragment of step kk
template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NS / 2], const float (&sc)[NS]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// Online softmax over one tile of S, in place: updates the running max m
// (in the exp2 domain) and this thread's partial row sums l, leaves the
// numerators in sc and returns the factor alpha by which the output rows
// must be rescaled. A tile that no row of the warpgroup sees masked takes
// the fast path, with the scale folded into one FFMA per element (the max
// of the raw scores scales to the max of the scaled ones for a positive
// scale); any other tile scales first and masks each element against its
// row's visible key range [lo, hi).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool full, int k0, int row_a,
                                             int quad, int sk, int causal, int window,
                                             float scale_log2) {
  float mx[2];
  if (full && scale_log2 > 0.f) {
    float raw[2] = {sc[0], sc[2]};
#pragma unroll
    for (int i = 0; i < NS; ++i) raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], raw[r] * scale_log2);
  } else {
    // key columns of this thread are k0 + 2 quad + (8 j + (e & 1)); compare
    // the constant part against each row's bounds shifted by the rest
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      const int base = k0 + 2 * quad;
      hi[r] = (causal ? min(sk, row + 1) : sk) - base;
      lo[r] = window > 0 ? row - window + 1 - base : -2147483647;
    }
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + (i & 1);
      const float x = (c >= lo[r] && c < hi[r]) ? sc[i] * scale_log2 : NEG_INF;
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // finite -1e30 on both sides gives exp2(0) = 1, never NaN
    alpha[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
  if (full && scale_log2 > 0.f) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const float p = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
      sc[i] = p;
      l[r] += p;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const float p = fast_exp2(sc[i] - m[r]);
      sc[i] = p;
      l[r] += p;
    }
  }
}

// live kv tiles of BN keys of the query tile starting at q0: the causal and
// window skip
template <int BN>
__device__ __forceinline__ void kv_tiles(int q0, int sk, int causal, int window,
                                         int* first, int* count) {
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(sk, q0 + BM) : sk;
  const int t0 = lo / BN;
  const int t1 = (hi + BN - 1) / BN;
  *first = t0;
  *count = max(0, t1 - t0);
}

// Thread t of consumer warpgroup w holds, for S and O alike, rows
// q0 + 64 w + 16 (t / 32) + (t % 32) / 4 (+ 8) and, in each 8-column block
// j, columns 8 j + 2 (t % 4) (+ 1): element 4 j + e is row +8 if e >= 2 and
// column +1 if e is odd.
//
// Each consumer warpgroup overlaps the softmax of tile i with the PV product
// of tile i - 1 on the tensor cores: it issues S_i = Q K_i^T and
// O += P_{i-1} V_{i-1} together, waits for S_i only, runs the softmax, then
// waits for the PV product before it rescales O and packs P_i. An item's
// first QK and last PV product run alone.
//
// The block is persistent: it takes items r = 0, 1, ... of its snake order
// until they run out; the ring position g and the Q count nq carry across
// items, so the producer fills the next item's stages (and its Q, once
// q_empty says the last QK product of the item before has been issued and
// finished) while the consumers finish the current one.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, long long ob, long long oh,
                       long long os, int hq, int group, int sq, int sk, int d,
                       float scale_log2, int causal, int window, int n_bh, int n_items) {
  constexpr int BN = block_n<DP>();           // keys per kv tile
  constexpr int NCB = DP / COLS;              // 64-wide column blocks
  constexpr int Q_BYTES = tile_bytes<DP>(BM);
  constexpr int KV_BYTES = tile_bytes<DP>(BN);
  constexpr int CB_Q = BM * ROW_BYTES;        // one column block of Q
  constexpr int CB_KV = BN * ROW_BYTES;       // one column block of K or V

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = s_q + Q_BYTES;                    // [STAGES][KV_BYTES]
  const uint32_t s_v = s_k + STAGES * KV_BYTES;          // [STAGES][KV_BYTES]
  const uint32_t bars = s_v + STAGES * KV_BYTES;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                      // [STAGES] each
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;
  const uint32_t q_empty = v_empty + 8 * STAGES;
  const int n_qtiles = n_items / n_bh;

  // work item r of this block, snake order over the heaviest-first list
  auto item_of = [&](int r) {
    const int g = gridDim.x;
    return r * g + ((r & 1) ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  auto decode = [&](int item, int* b, int* h, int* q0) {
    const int rank = item / n_bh;
    const int bh = item % n_bh;
    *b = bh / hq;
    *h = bh % hq;
    // heaviest query tiles first under a causal mask
    *q0 = (causal ? n_qtiles - 1 - rank : rank) * BM;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * 128);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMERS * 128);
      mbar_init(v_empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == CONSUMERS) {
    // producer warpgroup: one thread issues every load; a stage's K (or V) is
    // refilled once both warpgroups have released it, Q once both have
    // finished the previous item's last QK product
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x % 128 != 0) return;
    int g = 0, nq = 0;                 // kv tiles and Q tiles loaded so far
    for (int r = 0; item_of(r) < n_items; ++r) {
      int b, h, q0, t_first, n_tiles;
      decode(item_of(r), &b, &h, &q0);
      kv_tiles<BN>(q0, sk, causal, window, &t_first, &n_tiles);
      if (n_tiles == 0) continue;
      const int hk = h / group;
      if (nq > 0) mbar_wait(q_empty, (nq - 1) & 1);
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_4d(s_q + cb * CB_Q, &tm_q, q_full, cb * COLS, q0, h, b);
      ++nq;
      for (int it = 0; it < n_tiles; ++it, ++g) {
        const int s = g % STAGES;
        const uint32_t parity = ((g / STAGES) - 1) & 1;
        const int k0 = (t_first + it) * BN;
        if (g >= STAGES) mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_4d(s_k + s * KV_BYTES + cb * CB_KV, &tm_k, k_full + 8 * s, cb * COLS, k0, hk, b);
        if (g >= STAGES) mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_4d(s_v + s * KV_BYTES + cb * CB_KV, &tm_v, v_full + 8 * s, cb * COLS, k0, hk, b);
      }
    }
    return;
  }

  // consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int t = threadIdx.x % 128;
  const int quad = t % 4;
  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  int g = 0, nq = 0;
  for (int r = 0; item_of(r) < n_items; ++r) {
    int b, h, q0, t_first, n_tiles;
    decode(item_of(r), &b, &h, &q0);
    kv_tiles<BN>(q0, sk, causal, window, &t_first, &n_tiles);
    const int qw0 = q0 + 64 * warpgroup;                 // this warpgroup's first row
    const int row_a = qw0 + 16 * (t / 32) + (t % 32) / 4;
    const uint32_t q_addr = s_q + 64 * warpgroup * ROW_BYTES;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    uint32_t pa[BN / 4];
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};                             // this thread's columns only
    float alpha[2];

    // whether a tile needs no mask for any row of this warpgroup
    auto full_tile = [&](int k0) {
      return k0 + BN <= sk && (!causal || qw0 >= k0 + BN - 1) &&
             (window <= 0 || qw0 + 63 - k0 < window);
    };

    if (n_tiles > 0) {
      const int s = g % STAGES;
      mbar_wait(q_full, nq & 1);
      mbar_wait(k_full + 8 * s, (g / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
      qk_gemm<DP>(sc, q_addr, s_k + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      if (n_tiles == 1) mbar_arrive(q_empty);
      const int k0 = t_first * BN;
      softmax_tile(sc, m, l, alpha, full_tile(k0), k0, row_a, quad, sk, causal, window,
                   scale_log2);
      pack_p(pa, sc);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int gi = g + it;
      const int s = gi % STAGES;
      const int sp = (gi - 1) % STAGES;
      mbar_wait(k_full + 8 * s, (gi / STAGES) & 1);
      mbar_wait(v_full + 8 * sp, ((gi - 1) / STAGES) & 1);
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      qk_gemm<DP>(sc, q_addr, s_k + s * KV_BYTES);
      wgmma_commit();
      pv_gemm<DP>(acc, pa, s_v + sp * KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();                                   // S_it is ready
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      if (it == n_tiles - 1) mbar_arrive(q_empty);       // Q is read no more
      const int k0 = (t_first + it) * BN;
      softmax_tile(sc, m, l, alpha, full_tile(k0), k0, row_a, quad, sk, causal, window,
                   scale_log2);
      wgmma_wait<0>();                                   // O += P_{it-1} V_{it-1} done
      fence_regs(acc);
      mbar_arrive(v_empty + 8 * sp);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p(pa, sc);
    }
    if (n_tiles > 0) {
      const int gi = g + n_tiles - 1;
      const int s = gi % STAGES;
      mbar_wait(v_full + 8 * s, (gi / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
      pv_gemm<DP>(acc, pa, s_v + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty + 8 * s);
      g += n_tiles;
      ++nq;
    }

    // each row's sum over its four threads; a row with no live tile gives 0
    float inv[2];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 1);
      l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 2);
      inv[r2] = 1.f / (l[r2] == 0.f ? 1.f : l[r2]);
    }
    __nv_bfloat16* op = o + b * ob + h * oh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      if (c >= d) continue;
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int row = row_a + 8 * r2;
        if (row >= sq) continue;
        __nv_bfloat16* dst = op + row * os + c;
        const float x0 = acc[4 * j + 2 * r2] * inv[r2];
        const float x1 = acc[4 * j + 2 * r2 + 1] * inv[r2];
        if (c + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          *dst = __float2bfloat16(x0);
        }
      }
    }
  }
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

// (D, S, H, B) bf16 tensor with element strides (ss, sh, sb); box of 64
// columns x `rows` rows of one head; out-of-bounds elements read as zero
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int d, int s, int h,
              int b, long long ss, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(s > 0 ? s : 1), (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::COLS, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                 int sq, int sk, int d, const Strides& st, float scale, int causal, int window,
                 cudaStream_t stream) {
  constexpr int bn = wg::block_n<DP>();
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, d, sq, hq, b, st.qs, st.qh, st.qb, wg::BM) ||
      !make_map(encode, &tk, k, d, sk, hkv, b, st.ks, st.kh, st.kb, bn) ||
      !make_map(encode, &tv, v, d, sk, hkv, b, st.vs, st.vh, st.vb, bn))
    return ERR_TENSOR_MAP;
  constexpr int smem = wg::smem_bytes<DP>();
  auto kernel = wg::flash_fwd_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)b * hq * ((sq + wg::BM - 1) / wg::BM);
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);    // one persistent block per SM
  kernel<<<grid, wg::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st.ob, st.oh, st.os, hq, hq / hkv, sq, sk, d,
      scale * wg::LOG2E, causal, window, b * hq, (int)items);
  return (int)cudaGetLastError();
}

bool args_ok(int b, int hq, int hkv, int sq, int sk, int d, int window, int q_tile) {
  return b >= 1 && hq >= 1 && hkv >= 1 && hq % hkv == 0 && sq >= 1 && sk >= 0 && d >= 1 &&
         d <= 256 && window >= 0 && (long long)b * hq <= 2147483647LL &&
         (sq + q_tile - 1) / q_tile <= 65535;
}

Strides unpack(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

extern "C" {

// Both entry points: strides are 12 element strides, (batch, head, seq) for
// q, k, v and o in turn. They return a cudaError_t (the launch's own error,
// or cudaErrorInvalidValue for arguments the kernel does not take) or, on the
// bf16 route, ERR_NO_ENCODE / ERR_TENSOR_MAP.

// float32 q, k, v and o: the CUDA-core kernel
int flash_attention_fwd_simt(const void* q, const void* k, const void* v, void* o, int b,
                             int hq, int hkv, int sq, int sk, int d, const long long* strides,
                             float scale, int causal, int window, void* stream) {
  if (!args_ok(b, hq, hkv, sq, sk, d, window, BQ)) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return (int)launch<float, 16>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
  if (d <= 32) return (int)launch<float, 32>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
  if (d <= 64) return (int)launch<float, 64>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
  if (d <= 128) return (int)launch<float, 128>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
  return (int)launch<float, 256>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
}

// bfloat16 q, k, v and o: the wgmma kernel; pointers and the strides of q,
// k and v must be multiples of 16 B
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                              int hq, int hkv, int sq, int sk, int d, const long long* strides,
                              float scale, int causal, int window, void* stream) {
  if (!args_ok(b, hq, hkv, sq, sk, d, window, wg::BM)) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_wgmma<64>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
  if (d <= 128) return launch_wgmma<128>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
  return launch_wgmma<256>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, s);
}

// Dynamic shared memory one block of a route takes at this head_dim
// (ptxas -v does not report dynamic shared memory); route 0 = simt, 1 = wgmma.
int flash_attention_smem_bytes(int route, int d) {
  if (route == 1)
    return d <= 64 ? wg::smem_bytes<64>() : (d <= 128 ? wg::smem_bytes<128>() : wg::smem_bytes<256>());
  if (d <= 16) return (int)(smem_floats<16>() * sizeof(float));
  if (d <= 32) return (int)(smem_floats<32>() * sizeof(float));
  if (d <= 64) return (int)(smem_floats<64>() * sizeof(float));
  if (d <= 128) return (int)(smem_floats<128>() * sizeof(float));
  return (int)(smem_floats<256>() * sizeof(float));
}

const char* flash_attention_error_string(int err) {
  if (err == ERR_NO_ENCODE) return "libcuda offers no cuTensorMapEncodeTiled";
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a q/k/v layout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
