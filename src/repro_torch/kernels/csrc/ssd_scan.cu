// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan (the Pallas TPU kernel, body
// _ssd_kernel). For each (batch, head) it runs the chunked SSD algorithm over
// the sequence with the (P, N) state carried from chunk to chunk:
//
//   cum     = inclusive cumsum of dta over the chunk's rows
//   y       = ((C B^T) . L) xdt + exp(cum) . (C state^T),  L[i,j] = exp(cum_i - cum_j), i >= j
//   state  <- state * exp(cum_last) + (xdt . exp(cum_last - cum))^T B
//
// with B and C shared by the heads of a group (head h reads group h / (H/G)).
// Inputs: xdt (b, S, H, P) and dta (b, S, H) in fp32, B and C (b, S, G, N) in
// fp32 or bf16. Outputs: y (b, S, H, P) and the final state (b, H, P, N) in
// fp32. The state starts at zero, or at init (b, H, P, N) when one is given.
//
// The TPU kernel runs a (batch, head, chunk) grid whose chunk axis executes in
// order and keeps the state in VMEM scratch across it. CUDA blocks run in no
// order, so here one block owns a (batch*head, P-slice) pair and loops over the
// chunks itself, with its slice of the state in shared memory. Rows p of the
// state and columns p of y depend only on column p of xdt, so a block takes
// PS = 64, 32 or 16 columns of P: the slice narrows when there are too few
// (batch, head) pairs to fill the card (a 1 x 8192 prompt has 80 of them).
//
// The kernel picks its own chunk length, Q = 64 rows: at the model's 256 rows
// fp32 tiles of B and C alone would take 256 KB, more than a block may have.
// Chunked SSD is exact, so only rounding depends on Q; shorter chunks also
// keep cum small, so exp(cum_i - cum_j) loses fewer bits. The exponent is
// taken only where i >= j (above the diagonal it is positive and could
// overflow). A ragged last chunk is masked with zeros: zero dta and xdt are
// inert.
//
// Bound on an H100: at the serving shape (b 10, S 1024, H 80, P 64, N 128,
// B/C bf16) the call moves ~454 MB (xdt and y in fp32 dominate), ~0.14 ms at
// 3.35 TB/s, and its products are ~37 GFLOP at Q = 64, below that at the TF32
// tensor-core rate: it is bound by bytes. This first kernel computes in fp32
// on the CUDA cores (67 TFLOP/s, so >= 0.55 ms), staging each chunk's B, C and
// xdt once in shared memory (B and C read once per chunk, converted to fp32)
// and accumulating 4 x 4 register tiles; tensor cores and a pipelined chunk
// loop are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;          // rows per chunk
constexpr int NT = 256;        // threads per block: a 16 x 16 grid
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
template <typename T, int PS, int NP>
__global__ void __launch_bounds__(NT, 2)  // <= 128 registers: two narrow blocks fit an SM
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

int state_width(int n) { return n <= 32 ? 32 : (n <= 64 ? 64 : 128); }

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
    default: return launch<T, PS, 128>(a, batch, stream);
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

}  // namespace

extern "C" {

// xdt (batch, seq, heads, p) and dta (batch, seq, heads): contiguous fp32.
// b, c (batch, seq, groups, n): (groups, n) contiguous, batch and seq strides
// given in elements; dtype 0 = float32, 1 = bfloat16 (both alike).
// init: null or contiguous fp32 (batch, heads, p, n). y and fin: contiguous
// fp32 outputs of xdt's and init's shapes.
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int ssd_scan_fwd(const float* xdt, const float* dta, const void* b, const void* c,
                 const float* init, float* y, float* fin, int batch, int seq,
                 int heads, int groups, int p, int n, long long b_bs, long long b_ss,
                 long long c_bs, long long c_ss, int dtype, void* stream) {
  if (batch < 1 || seq < 0 || heads < 1 || groups < 1 || heads % groups != 0 || p < 1 ||
      n < 1 || n > 128 || (dtype != 0 && dtype != 1) ||
      (long long)batch * heads > 2147483647LL || (p + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{xdt, dta, b, c, init, y, fin, seq, heads, groups, p, n,
               b_bs, b_ss, c_bs, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, batch, s);
  return (int)dispatch<__nv_bfloat16>(a, batch, s);
}

// The launch the kernel makes for these sizes: plan[0] chunk rows, plan[1]
// P-slice width, plan[2] padded state width, plan[3] dynamic shared memory
// bytes of one block (ptxas -v does not report dynamic shared memory).
int ssd_scan_plan(int batch, int heads, int p, int n, int* plan) {
  if (batch < 1 || heads < 1 || p < 1 || n < 1 || n > 128) return (int)cudaErrorInvalidValue;
  const int ps = slice_width(batch, heads, p);
  const int np = state_width(n);
  plan[0] = Q;
  plan[1] = ps;
  plan[2] = np;
  plan[3] = (int)(smem_floats(ps, np) * sizeof(float));
  return 0;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
