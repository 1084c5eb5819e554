// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas TPU
// kernel, body _attn_kernel). Computes softmax(q k^T * scale + mask) v with
// GQA (q head h reads kv head h / (Hq/Hkv)), a top-left aligned causal mask
// (key c visible to query r iff r - c >= 0), an optional sliding window
// (r - c < window) and masked out-of-range keys. Masked logits take the
// finite -1e30 of the reference; a row with no live key tile outputs 0.
//
// The TPU kernel runs its kv grid axis in order and carries (m, l, acc) in
// VMEM scratch across it. CUDA blocks run in no order, so here one block owns
// a (batch*head, 64-query tile) pair and loops over the kv tiles itself,
// keeping the online-softmax state in registers. The loop covers only the
// tiles that the causal and window limits leave live.
//
// Arithmetic is fp32 on the CUDA cores (inputs are converted to fp32 as they
// are staged in shared memory), as the Pallas kernel casts q, k and v to
// fp32. Tensor cores (wgmma), TMA and pipelining are left for later work.
//
// Layout: every tensor is (batch, heads, seq, head_dim) addressed through
// element strides for batch, head and seq, with a contiguous head_dim, so the
// caller can pass transposed views of (batch, seq, heads, head_dim) tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int KSTRIDE = BK + 1;  // padded row of the transposed K / P tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DP>
constexpr int smem_floats() {
  // Q tile (BQ x DP+4) + transposed K tile / P tile + V tile (BK x DP)
  return BQ * (DP + 4) + (DP > BQ ? DP : BQ) * KSTRIDE + BK * DP;
}

// Thread (ty, tx) owns query rows ty + 16*i (i < 4), score columns
// tx + 16*j (j < 4) and output columns tx + 16*j (j < DP/16). The 16 threads
// that share a row sit in one half-warp, so row reductions are shuffles.
template <typename T, int DP>
__global__ void __launch_bounds__(NT, 2)  // two blocks per SM: <= 128 registers
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

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* o,
                              int b, int hq, int hkv, int sq, int sk, int d,
                              const Strides& st, float scale, int causal,
                              int window, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, stream);
  if (d <= 32) return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, stream);
  return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, d, st, scale, causal, window, stream);
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in turn.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int hq, int hkv, int sq, int sk, int d,
                        const long long* strides, float scale, int causal,
                        int window, int dtype, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 0 ||
      d < 1 || d > 128 || window < 0 || (dtype != 0 && dtype != 1) ||
      (long long)b * hq > 2147483647LL || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, o, b, hq, hkv, sq, sk, d, st,
                                         scale, causal, window, s);
  return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d,
                                               st, scale, causal, window, s);
}

// Dynamic shared memory one block takes at this head_dim (ptxas -v does not
// report dynamic shared memory).
int flash_attention_smem_bytes(int d) {
  if (d <= 16) return (int)(smem_floats<16>() * sizeof(float));
  if (d <= 32) return (int)(smem_floats<32>() * sizeof(float));
  if (d <= 64) return (int)(smem_floats<64>() * sizeof(float));
  return (int)(smem_floats<128>() * sizeof(float));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
