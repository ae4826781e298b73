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
// kernel's l == 0 guard).  The output is in the inputs' type.
//
// Two kernels compute it; the wrapper (flash_attention.py::kernel_path)
// picks one from the inputs' dtype, head_dim, strides and alignment:
//
//   * the tensor-core kernel (flash_attention_tc_launch): bf16 with
//     head_dim a multiple of 8 up to 128, every stride and the base
//     16-byte aligned (what TMA takes).  That is every dense model of the
//     port (head_dim 120 or 128).
//   * the SIMT kernel (flash_attention_launch): everything else, in
//     particular fp32, which must stay full fp32 (wgmma has only TF32 for
//     it, which would miss the reference's 2e-5).
//
// What bounds it on this card.  At a long prefill (S = 8192, window 4096)
// the call does 4·D FLOPs per valid (q, k) pair, far above the card's
// operations-per-byte balance: its bound is operations, at the bf16
// tensor-core rate (989 TFLOP/s).  The tensor-core kernel reaches a third
// to a half of that.  Each block reads every k and v tile of its window again
// from L2 (64 KB per 8.4 MFLOP of products, 12.6 with the two-part P·V
// below), and one warpgroup's softmax does not overlap its own products.
// With a softcap the softmax takes three special-function-unit operations
// per score (exp and reciprocal for the tanh, exp2), and the tiles take
// longer.  At the serving prefill shape (B = 8, S = 96) the work is tiny:
// one key tile per block, 256 blocks in two waves, each bound by the
// latency of one chain of load, product, softmax, product and store
// (PERF.md, section 6).
//
// ---- The tensor-core kernel -------------------------------------------
//
// Design.  The TPU kernel walks the kv blocks as a sequential grid axis
// and carries m / l / acc in VMEM scratch.  Here one block of 384 threads
// owns one (b, h, 128-row query tile) and loops over 128-key tiles itself:
//
//   * warpgroup 0 is the producer.  It gives up registers (setmaxnreg 40)
//     and one thread issues every load as a TMA copy: the q tile once, then
//     each k and v tile into a 2-stage ring (q 32 KB + 2 x (32 + 32) KB =
//     160 KB of shared memory, above the 48 KB default: the launch raises
//     the limit).  Each stage has a "full" mbarrier for k, one for v (the
//     TMA's byte count completes them) and an "empty" mbarrier that the 8
//     consumer warps arrive on when they are done with the stage.  So the
//     load of tile j+1 runs under the products of tile j.
//   * warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 query rows
//     each.  Per key tile: S = Q·Kᵀ as 8 wgmma m64n128k16 steps over the
//     padded head_dim, both operands from shared memory, fp32 accumulators
//     in registers; the softmax in registers; then O += P·V as 8 wgmma
//     m64n128k16 steps over the keys, with P from registers and V from
//     shared memory.
//
// Layout.  q, k and v go in as the model hands them over: (B, S, H, D)
// tensors seen as (B, H, S, D), uncopied.  The host encodes one 4-d TMA
// tensor map per tensor over dims (D, S, heads, B), innermost first, with
// the tensors' own byte strides (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: the library needs no -lcuda).  A box is 64
// columns (128 bytes) by 128 rows, written with the 128-byte swizzle that
// wgmma reads; a 128-column tile is two boxes (one where head_dim <= 64:
// the kernel's kBoxes).  Out-of-bounds elements are filled with zeros
// (FLOAT_OOB_FILL_NONE), so the hardware pads head_dim 120 to 128 and the
// ragged ends of S: nothing is padded in PyTorch.
//
// Products.  The shared-memory descriptors use the 128-byte swizzle
// (layout type 1); tile bases are 1024-byte aligned, so the base offset is
// 0.  Q and K are K-major (head_dim contiguous): stride byte offset 1024
// (8 rows of 128 bytes), a k16 step advances the start address 32 bytes
// inside a 64-column box and steps 4-7 start in the second box.  V is the
// B operand of P·V with its N (head_dim) contiguous: MN-major, the
// transpose flag set; a k16 step is 16 keys (2048 bytes), the stride byte
// offset 1024 (8 keys) and the leading byte offset 16 KB (from head_dim
// columns 0-63 to 64-127, the second box).  P needs no trip through shared
// memory: the accumulator fragment of S for keys 16i..16i+15, packed
// pairwise to bf16, is the register A fragment of P·V's k16 step i.  P
// goes in as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), each a
// k16 step of its own (16 steps in all), so P·V sees P to about 2^-17
// where one bf16 part would round it to 2^-9 (Numerics).
//
// Softmax.  Thread t of warp w in a consumer warpgroup holds rows
// 16w + t/4 and 16w + t/4 + 8 of its 64, at columns 8j + 2(t%4) + {0, 1}.
// Logits are scaled by log2(e)/√D (exp2 on the special-function unit
// instead of exp), soft-capped, masked; the row max is reduced over the 4
// lanes of a row (shuffle xor 1, 2); each thread keeps its part of the row
// sum, reduced once at the end.  A tile inside every mask of the
// warpgroup's rows, without a softcap, skips the mask test and folds the
// scale into the exponent's FMA.  The masks are selects and the softcap's
// tanh an exp and a reciprocal, with no branch per element: at the serving
// shape every tile takes the masks.
//
// Registers.  A consumer holds 64 fp32 of S, 64 of O and 2 x 32 packed
// words of P.  ptxas reports 168 registers a thread (384 threads, one
// block per SM) and no spills; setmaxnreg then gives the producer 40 and the
// consumers 232 at run time.  The barrier waits spin without a time-out: a
// trap on time-out made ptxas spill consumer registers.
//
// Numerics.  Q·Kᵀ of bf16 inputs with fp32 accumulation is the
// reference's fp32 product up to the order of the sums.  P·V takes P as
// hi + lo (about 2^-17 relative per term, where the reference keeps P in
// fp32) and m and the row sum l use the fp32 P.  One bf16 part alone (2^-9
// per term, as FlashAttention-3 does) passes every attention case within
// bf16's 2e-2, but a bf16 decoder amplifies it end to end: the reduced
// h2o-danube-3-4b's logits then missed the plain attention's by more than
// 2e-2 of max|logit| (tests/test_torch_kernels_cuda.py).  The second part
// costs 8 more wgmma steps per tile (PERF.md, section 6).
//
// ---- The SIMT kernel ---------------------------------------------------
//
// Every product and sum is an fp32 FMA on the fp32 pipes (67 TFLOP/s).  One
// block of 256 threads owns one (b, h, 64-row query tile) and loops over
// the 64-key tiles itself, with m / l / acc in registers.  The query tile
// and the current k and v tiles sit in shared memory as fp32 (about 109 KB
// at D = 120: above the 48 KB default, so the launch raises the block's
// dynamic shared-memory limit first).  Thread (tr, tc) owns query rows
// tr + 16i and, for the scores, key columns tc + 16j (i, j < 4); for the
// output, head-dim columns tc + 16j (j < DC).  The 16 threads of a row are
// 16 lanes of one warp: the row max and sum are shuffles.  Rows of q and k
// in shared memory have an odd stride, so the 16 lanes reading 16 key rows
// at one head-dim column hit 16 banks.  The probabilities go through shared
// memory to the P·V product.  Any head_dim from 1 to 256 works (DC =
// head-dim columns per thread / 16, picked at launch).
//
// Masking (both kernels).  Masked logits are the finite -2^30, as in the
// reference: a tile wholly masked for a row before its first valid key
// gives m = -2^30 and p = 1, and the next tile's alpha = exp(-2^30 - m) = 0
// erases it (with -inf it would give NaN).  Keys at or past Sk do not
// exist: they get p = 0 and their v rows are zeros.  Tiles wholly masked
// for every row of the block (above the causal diagonal, or before
// q0 - window) are skipped, which gives the same result.  Sq and Sk are
// masked by loop bounds (SIMT) or the TMA's zero fill (tensor cores): no
// padding.
#include <cuda.h>   // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

// ---- The SIMT kernel ---------------------------------------------------

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

// ---- The tensor-core kernel -------------------------------------------

namespace {
namespace tc {

constexpr int kRows = 128;                // query rows per block, keys per tile
constexpr int kBox = 64;                  // columns per TMA box (128 bytes)
constexpr int kStages = 2;                // K/V ring depth
constexpr int kThreads = 384;             // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr uint32_t kBoxBytes = kRows * 128;        // 64 columns x 128 rows
constexpr uint32_t kTileBytes = 2 * kBoxBytes;     // 128 columns x 128 rows
constexpr uint32_t kQOff = 0;
constexpr uint32_t kKOff = kTileBytes;             // stage s: + s * kStageBytes
constexpr uint32_t kStageBytes = 2 * kTileBytes;   // a K tile and a V tile
constexpr uint32_t kBarOff = kTileBytes + kStages * kStageBytes;   // 160 KB
constexpr uint32_t kSmemBytes = kBarOff + 64 + 1024;   // barriers, alignment
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;   // element strides of the output
  int heads, kv_heads, sq, sk, d;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier's phase of the given parity has completed.  (A
// time-out that traps here made ptxas spill consumer registers, so the
// wait just spins.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One TMA box (c0 = head-dim column, c1 = row, c2 = head, c3 = batch) into
// shared memory at dst; completes `bytes` on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets in 16-byte units, layout type 1
// in bits 62-63, base offset 0 (tile bases are 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// tanh(x) = 1 - 2 / (e^2x + 1) on the special-function unit (an exp and a
// reciprocal; CUDA's tanhf branches): about 1e-6 relative, 1e-7 absolute
// near 0; e^2x = inf gives 1
__device__ __forceinline__ float tanh_approx(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// 2^x on the special-function unit (2^-22 relative; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo: low half
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// a and b as two packed bf16 parts: hi = bf16(a, b) and lo = bf16 of
// what hi leaves out, so hi + lo is a, b to about 2^-17 relative
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xFFFF0000u));
}

// D (64 x 128, fp32) += A (64 x 16, bf16, shared) * B (16 x 128, bf16,
// shared, K-major); scale_d == 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// shared, MN-major: the transpose flag on B).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// kBoxes: 64-column boxes per 128-column tile row (1 where head_dim <= 64)
template <int kBoxes>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + kBarOff;
  const uint32_t bar_k = bar_q + 8;                   // full: k tile landed
  const uint32_t bar_v = bar_k + 8 * kStages;         // full: v tile landed
  const uint32_t bar_e = bar_v + 8 * kStages;         // empty: stage free

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  // keys that can be valid for some row of this block
  const int q_last = min(q0 + kRows, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kRows - 1) / kRows
                                      : 0;
  constexpr int n_box = kBoxes;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(bar_q, n_box * kBoxBytes);
      for (int c = 0; c < n_box; ++c)
        tma_load(base + kQOff + c * kBoxBytes, &tm_q, bar_q, c * kBox, q0, h,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        // the first pass over the ring finds every stage free
        mbar_wait(bar_e + 8 * s, phase ^ 1);
        const int k0 = k_begin + t * kRows;
        const uint32_t k_tile = base + kKOff + s * kStageBytes;
        const uint32_t v_tile = k_tile + kTileBytes;
        mbar_expect_tx(bar_k + 8 * s, n_box * kBoxBytes);
        for (int c = 0; c < n_box; ++c)
          tma_load(k_tile + c * kBoxBytes, &tm_k, bar_k + 8 * s, c * kBox, k0,
                   kvh, b);
        mbar_expect_tx(bar_v + 8 * s, n_box * kBoxBytes);
        for (int c = 0; c < n_box; ++c)
          tma_load(v_tile + c * kBoxBytes, &tm_v, bar_v + 8 * s, c * kBox, k0,
                   kvh, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int qa = q0 + 64 * cw;                   // the warpgroup's first row
    const int row0 = qa + 16 * warp + lane / 4;    // rows row0 and row0 + 8
    const int col0 = 2 * (lane % 4);               // + 8j (+ 1): columns
    const uint32_t q_tile = base + kQOff + cw * 64 * 128;
    const float scale2 = p.scale * kLog2e;
    const float cap_in = p.softcap > 0.0f ? p.scale / p.softcap : 0.0f;
    const float cap_out = p.softcap * kLog2e;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
    float m0 = kMasked, m1 = kMasked;     // running max (log2 units)
    float l0 = 0.0f, l1 = 0.0f;           // this thread's part of the sum

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const int k0 = k_begin + t * kRows;
      const uint32_t k_tile = base + kKOff + s * kStageBytes;
      const uint32_t v_tile = k_tile + kTileBytes;

      // S = Q Kᵀ: 64 x 128 fp32, 8 k16 steps over the padded head_dim
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
      mbar_wait(bar_k + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < 4 * n_box) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_m64n128k16(sc, sw128_desc(q_tile + off, 16, 1024),
                              sw128_desc(k_tile + off, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(sc);

      // Logits in log2 units are sc * mul.  A tile inside every mask of
      // the warpgroup's rows without a softcap keeps the raw products and
      // folds the scale into the exponent's FMA; any other tile is scaled,
      // soft-capped and masked here.  The row max over the 4 lanes of a row.
      const bool inside = k0 + kRows <= p.sk &&
                          (!p.causal || k0 + kRows - 1 <= qa) &&
                          (p.window <= 0 || k0 > qa + 63 - p.window);
      const bool raw = inside && p.softcap <= 0.0f;
      const float mul = raw ? scale2 : 1.0f;
      if (p.softcap > 0.0f) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          sc[i] = cap_out * tanh_approx(sc[i] * cap_in);
      } else if (!raw) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale2;
      }
      if (!inside) {
        // selects, not branches: key kc against rows qr = row0 (+ 8)
        const bool window = p.window > 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = k0 + 8 * j + col0 + (e & 1);
            const int qr = row0 + 8 * (e >> 1);
            const bool masked = (p.causal & (kc > qr)) |
                                (window & (kc <= qr - p.window));
            const float x = masked ? kMasked : sc[4 * j + e];
            sc[4 * j + e] = kc >= p.sk ? -INFINITY : x;   // no such key: p = 0
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * mul), mn1 = fmaxf(m1, mx1 * mul);
      const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = hi + lo in bf16: pa[4i..4i+3] and pl[4i..4i+3] are the A
      // fragments of keys 16i..16i+15
      uint32_t pa[32], pl[32];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = fast_exp2(fmaf(sc[4 * j], mul, -mn0));
        const float p1 = fast_exp2(fmaf(sc[4 * j + 1], mul, -mn0));
        const float p2 = fast_exp2(fmaf(sc[4 * j + 2], mul, -mn1));
        const float p3 = fast_exp2(fmaf(sc[4 * j + 3], mul, -mn1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        split_bf16(p0, p1, pa[2 * j], pl[2 * j]);
        split_bf16(p2, p3, pa[2 * j + 1], pl[2 * j + 1]);
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }

      // O += P V: 2 x 8 k16 steps over the tile's keys (hi, then lo),
      // N = 128 head-dim columns
      mbar_wait(bar_v + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t desc = sw128_desc(v_tile + kk * 2048, kBoxBytes, 1024);
        wgmma_rs_m64n128k16(o, &pa[4 * kk], desc);
        wgmma_rs_m64n128k16(o, &pl[4 * kk], desc);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

    // the row sums over the 4 lanes of a row; no valid key: 0
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const bool any0 = l0 > 0.0f && m0 > kMasked;
    const bool any1 = l1 > 0.0f && m1 > kMasked;
    const float inv0 = any0 ? 1.0f / l0 : 0.0f;
    const float inv1 = any1 ? 1.0f / l1 : 0.0f;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                         h * p.o_sh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + col0;
      if (c >= p.d) continue;
      if (row0 < p.sq) {
        const uint32_t v = pack_bf16(any0 ? o[4 * j] * inv0 : 0.0f,
                                     any0 ? o[4 * j + 1] * inv0 : 0.0f);
        *reinterpret_cast<uint32_t*>(out + row0 * p.o_ss + c) = v;
      }
      if (row0 + 8 < p.sq) {
        const uint32_t v = pack_bf16(any1 ? o[4 * j + 2] * inv1 : 0.0f,
                                     any1 ? o[4 * j + 3] * inv1 : 0.0f);
        *reinterpret_cast<uint32_t*>(out + (row0 + 8) * p.o_ss + c) = v;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so
// the library links no libcuda); null if the driver lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-d bf16 map over (D, S, heads, B), innermost first, with the given
// element strides of S, heads and B; boxes of 64 columns x 128 rows with
// the 128-byte swizzle, zeros out of bounds
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
                int s, int heads, int batch, long long ss, long long sh,
                long long sb) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool aligned16(const void* ptr, long long s1, long long s2, long long s3) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (s1 * 2) % 16 == 0 &&
         (s2 * 2) % 16 == 0 && (s3 * 2) % 16 == 0 && s1 > 0 && s2 > 0 &&
         s3 > 0;
}

}  // namespace tc
}  // namespace

// Plain C entry point of the tensor-core kernel, called through ctypes.
// bf16 only: q (B, H, Sq, D), k and v (B, KV, Sk, D) and o (B, H, Sq, D)
// are device pointers on `device`, each with the given element strides for
// its batch, head and sequence dims and a contiguous head_dim, with
// D % 8 == 0 and 8 <= D <= 128.  q, k and v must be 16-byte aligned with
// strides of a multiple of 8 elements (what TMA takes; a dim of size 1 may
// carry any such stride), o 4-byte aligned with even strides.  Launches on
// `stream` without synchronising and returns 0 on success, a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take), or
// minus the CUresult of a tensor map that could not be encoded.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int kv_heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float softcap, float scale, int device,
    void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      kv_heads < 1 || heads % kv_heads != 0 || sq < 1 || sk < 1 || d < 8 ||
      d > 128 || d % 8 != 0 || !tc::aligned16(q, q_sb, q_sh, q_ss) ||
      !tc::aligned16(k, k_sb, k_sh, k_ss) ||
      !tc::aligned16(v, v_sb, v_sh, v_ss) ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || o_sb % 2 != 0 ||
      o_sh % 2 != 0 || o_ss % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const tc::EncodeTiled fn = tc::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_q, map_k, map_v;
  CUresult res = tc::encode(fn, &map_q, q, d, sq, heads, batch, q_ss, q_sh,
                            q_sb);
  if (res == CUDA_SUCCESS)
    res = tc::encode(fn, &map_k, k, d, sk, kv_heads, batch, k_ss, k_sh, k_sb);
  if (res == CUDA_SUCCESS)
    res = tc::encode(fn, &map_v, v, d, sk, kv_heads, batch, v_ss, v_sh, v_sb);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  // head_dim <= 64 fills one 64-column box of each tile row, else two
  const auto kernel = d > tc::kBox ? tc::flash_attention_tc_kernel<2>
                                   : tc::flash_attention_tc_kernel<1>;
  // 161 KB of shared memory: without this the launch is refused
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tc::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const tc::Params p{o, o_sb, o_sh, o_ss, heads, kv_heads, sq, sk, d,
                     causal, window, softcap, scale};
  const dim3 grid((sq + tc::kRows - 1) / tc::kRows, heads, batch);
  kernel<<<grid, tc::kThreads, tc::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(map_q, map_k, map_v, p);
  return static_cast<int>(cudaGetLastError());
}
