// Flash-attention forward for Hopper (sm_90a): softmax(q·kᵀ/√D)·v with an
// online softmax, GQA, an optional tanh logit softcap, and causal and
// sliding-window masks.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_fa_kernel
// (launched by flash_attention_fwd through pl.pallas_call).  It computes
// what that kernel computes, for each batch b, query head h and query row q:
//
//   s_k  = (q · k_k) / √D                 over the keys k of kv head
//                                         h / (H / KV) (GQA, no broadcast)
//   s_k  = c · tanh(s_k / c)              if a softcap c > 0 (before the mask)
//   s_k  = -2^30                          where k > q (causal) or
//                                         k <= q - window (window > 0)
//   o_q  = Σ_k softmax(s)_k · v_k         fp32 running max m, sum l, acc
//
// and a row with no valid key outputs 0 (the oracle's rule; the TPU
// kernel's l == 0 guard).  Inputs are fp32 or bf16; every product and sum is
// an fp32 FMA (no TF32, no tensor cores); the output is in the inputs' type.
//
// What bounds it on this card.  At the serving prefill shape (S = 96) the
// work is tiny and the call is bound by launch latency.  At a long prefill
// (S = 8192, window 4096) it does 4·D FLOPs per valid (q, k) pair, far above
// the card's operations-per-byte balance: it is bound by operations.  The
// card's bound counts bf16 tensor-core rate (989 TFLOP/s); this kernel runs
// on the fp32 pipes (67 TFLOP/s) and feeds them from shared memory, so it
// cannot come near that bound.  wgmma, TMA and warp specialisation are
// what closes that gap, in a later kernel.
//
// Design.  The TPU kernel walks the kv blocks as a sequential grid axis and
// carries m / l / acc in VMEM scratch between grid steps.  Hopper's blocks
// run in no order, so here one block of 256 threads owns one (b, h, 64-row
// query tile) and loops over the 64-key tiles itself, with m / l / acc in
// registers.  The query tile and the current k and v tiles sit in shared
// memory as fp32 (about 109 KB at D = 120: above the 48 KB default, so the
// launch raises the block's dynamic shared-memory limit first).  Thread
// (tr, tc) owns query rows tr + 16i and, for the scores, key columns
// tc + 16j (i, j < 4); for the output, head-dim columns tc + 16j (j < DC).
// The 16 threads of a row are 16 lanes of one warp: the row max and sum are
// shuffles.  Rows of q and k in shared memory have an odd stride, so the 16
// lanes reading 16 key rows at one head-dim column hit 16 banks.  The
// probabilities go through shared memory to the P·V product.
//
// Masking.  Masked logits are the finite -2^30, as in the reference: a tile
// wholly masked for a row before its first valid key gives m = -2^30 and
// p = 1, and the next tile's alpha = exp(-2^30 - m) = 0 erases it (with
// -inf it would give NaN).  Keys at or past Sk do not exist: they get p = 0
// and their v rows are zeros.  Tiles wholly masked for every row of the
// block (above the causal diagonal, or before q0 - window) are skipped,
// which gives the same result.  Sq and Sk are masked by loop bounds: no
// padding.  Any head_dim from 1 to 256 works (DC = head-dim columns per
// thread / 16, picked at launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlockQ = 64;                       // query rows per block
constexpr int kBlockK = 64;                       // keys per tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;                        // threads sharing a row
constexpr int kRows = kBlockQ / (kThreads / kLanes);   // rows per thread: 4
constexpr int kCols = kBlockK / kLanes;           // score columns per thread: 4
constexpr int kLdP = kBlockK + 1;                 // probabilities row stride
constexpr float kMasked = -1073741824.0f;         // -2^30, as the reference

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of the batch, head and sequence dims (head_dim is 1)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, kv_heads, sq, sk, d;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, kLanes));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  // a butterfly: every lane of the row ends with the same bits
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off, kLanes);
  return x;
}

template <int DC>
size_t smem_bytes(int d) {
  const int ldk = d | 1;
  const int ldv = DC * kLanes;
  return sizeof(float) * static_cast<size_t>(
      kBlockQ * ldk + kBlockK * ldk + kBlockK * ldv + kBlockQ * kLdP);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int ldk = d | 1;            // odd: 16 rows at one column, 16 banks
  const int ldv = DC * kLanes;      // head_dim padded to the thread columns
  float* s_q = smem;                          // kBlockQ x ldk
  float* s_k = s_q + kBlockQ * ldk;           // kBlockK x ldk
  float* s_v = s_k + kBlockK * ldk;           // kBlockK x ldv
  float* s_p = s_v + kBlockK * ldv;           // kBlockQ x kLdP

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int tid = threadIdx.x;
  const int tr = tid / kLanes;
  const int tc = tid % kLanes;

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int qi = q0 + r;
    s_q[r * ldk + c] = qi < p.sq ? to_float(q[qi * p.q_ss + c]) : 0.0f;
  }
  // padded head-dim columns of v stay zero (loads below never write them)
  for (int i = tid; i < kBlockK * (ldv - d); i += kThreads) {
    const int r = i / (ldv - d), c = d + i % (ldv - d);
    s_v[r * ldv + c] = 0.0f;
  }

  // keys that can be valid for some row of this tile
  const int q_last = min(q0 + kBlockQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / kBlockK) * kBlockK;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the q tile is in; the last tile's k, v, p are read
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int ki = k0 + r;
      const bool in = ki < p.sk;
      s_k[r * ldk + c] = in ? to_float(k[ki * p.k_ss + c]) : 0.0f;
      s_v[r * ldv + c] = in ? to_float(v[ki * p.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = s_q[(tr + kLanes * i) * ldk + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = s_k[(tc + kLanes * j) * ldk + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + tr + kLanes * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int ki = k0 + tc + kLanes * j;
        float x;
        if (ki >= p.sk) {
          x = -INFINITY;  // no such key: p = 0 below
        } else {
          x = s[i][j] * p.scale;
          if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
          const bool ok = (!p.causal || ki <= qi) &&
                          (p.window <= 0 || ki > qi - p.window);
          if (!ok) x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = expf(s[i][j] - m_new);
        s_p[(tr + kLanes * i) * kLdP + tc + kLanes * j] = pj;
        sum += pj;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBlockK, p.sk - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[kRows], vv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = s_p[(tr + kLanes * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = s_v[c * ldv + tc + kLanes * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + tr + kLanes * i;
    if (qi >= p.sq) continue;
    // no valid key (m never rose above the mask value, or no tile ran): 0
    const bool any = l[i] > 0.0f && m[i] > kMasked;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tc + kLanes * j;
      if (c < d) store(o + qi * p.o_ss + c, any ? acc[i][j] / l[i] : 0.0f);
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<DC>(p.d);
  auto kernel = flash_attention_kernel<T, DC>;
  if (smem > 48 * 1024) {
    // without this the launch is refused (too much shared memory)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 2 * kLanes) return launch<T, 2>(p, batch, stream);
  if (p.d <= 4 * kLanes) return launch<T, 4>(p, batch, stream);
  if (p.d <= 8 * kLanes) return launch<T, 8>(p, batch, stream);
  return launch<T, 16>(p, batch, stream);
}

}  // namespace

// Plain C entry point, called through ctypes.  q (B, H, Sq, D), k and v
// (B, KV, Sk, D) and o (B, H, Sq, D) are device pointers on `device`, each
// with the given element strides for its batch, head and sequence dims and
// a contiguous head_dim; dtype 0 is fp32 and 1 is bf16 (all four alike).
// Launches on `stream` without synchronising and returns the launch's
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int kv_heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float softcap, float scale, int device,
    void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      kv_heads < 1 || heads % kv_heads != 0 || sq < 1 || sk < 1 || d < 1 ||
      d > 16 * kLanes || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{q, k, v, o,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 heads, kv_heads, sq, sk, d, causal, window, softcap, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? dispatch<float>(p, batch, s)
                   : dispatch<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(err);
}
