// Mamba-1 selective scan (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/mamba_scan/mamba_scan.py::_scan_kernel (launched by
// mamba_scan_fwd through pl.pallas_call).  It computes what that kernel
// computes, for each batch b, channel i and state n, walking t = 0..S-1:
//
//   dA    = exp(dt[b,t,i] · A[i,n])
//   dBu   = (dt[b,t,i] · u[b,t,i]) · B[b,t,n]
//   h     = dA · h + dBu                     fp32 state, h0 or zero at t = 0
//   y     = Σ_n h · C[b,t,n] + D[i] · u[b,t,i]
//
// and returns y (B, S, I) and the last state h_last (B, I, N), all fp32.
//
// What bounds it on this card.  Each (t, i, n) costs one exp and four FP32
// operations, and each (t, i) moves 12 bytes (u, dt in, y out).  The exps
// run on the special-function units (16 results per clock per SM, about
// 4.2e12/s on 132 SMs at 1.98 GHz); the bytes at 3.35 TB/s.  At the serving
// shape (B=8, S=96, I=8192, N=16) the two terms are about equal (24 us
// each); at a long prefill (B=1, S=4096) the exps lead (128 us) with the
// bytes close behind (120 us).  So the kernel has to stream u, dt and y at
// near the memory's rate while it keeps the SFUs busy, and neither may wait
// on the other.
//
// Design.  A simpler design -- one thread per channel, 64-thread blocks,
// every thread copying its own u and dt with 4-byte cp.async and the
// whole block meeting at two barriers per chunk -- let loads and exps take
// turns and reached 0.39 of the bound at the serving shape on the H100.
// The TPU kernel tiles I across the parallel grid, walks S as a sequential
// grid axis in chunks and carries h in VMEM scratch; here the loop over t
// lives inside a block, and the block is split by role, as Hopper kernels
// are:
//  - One producer warp copies chunks of kChunk = 16 time steps (u and dt of
//    the block's channels, B and C of its batch row) into a ring of
//    kStages = 3 stages in shared memory with cp.async, 16 bytes a copy
//    where the layout allows (16-byte aligned rows and strides: the
//    model's tensors) and 4 bytes otherwise.  Each stage has a "full"
//    mbarrier that the copies complete (cp.async.mbarrier.arrive) and an
//    "empty" one that the consumer warps arrive on when done; the producer
//    runs up to three chunks ahead and no block-wide barrier is left.
//  - Four consumer warps walk the chunks.  Each (b, i) channel is owned by
//    kL adjacent lanes, each holding kS = kN / kL of its states and the
//    matching A (scaled by log2 e once, at load) in registers.  The
//    wrapper's shape rule (mamba_scan.py::kernel_path) picks kL: "pair"
//    (kL = 2) where B·I fills the card (the serving waves), "quad"
//    (kL = 4) where it does not (a B=1 prefill: 8,192 channels, so four
//    lanes each give every SM about 8 consumer warps).  One thread per
//    channel (kL = 1) was slower at both main shapes.
//  - Per step a thread reads u, dt and its B, C states from shared memory
//    (B and C as float4 where kS allows), computes dA with one FMUL and one
//    ex2.approx (A is pre-scaled, so no range scaling), updates h with an
//    FMA and adds h·C into one running sum.  A chunk's steps are unrolled
//    at compile time (the last, ragged chunk runs them under a guard), and
//    nothing in a step waits on another lane or on global memory, so only
//    h's FMA chains one step to the next and the steps overlap.
//  - After the chunk, the kL lanes of a channel sum their kChunk partial y
//    values with a transposing butterfly (each level trades half the values
//    with the partner lane: 12 shuffles a thread per 16 steps where a sum
//    per step takes 32), and each lane stores kChunk / kL of the y values.
// h_last is written once at the end.  A null h0 means a zero state (the
// forward passes none, and reads nothing for it); the same code runs on
// zeros, so h0 = 0 gives the same bits.  Ragged I and S are masked (no
// padding: the TPU wrapper pads I to block_i and S to its chunk, with
// dt = 0 on padded steps).  B and C come as column slices of the model's
// fp32 projection, so the kernel takes their batch and sequence strides.
//
// The exp: ex2.approx.ftz.f32 of dt·(A·log2 e), relative error about 2^-22
// plus the rounding of the two products (__expf is the same instruction
// after one more FMUL); results below 2^-126 flush to
// zero, which changes h by less than 1e-38 of its size.  The sum over n
// runs in another order than the reference's (per lane, then across
// lanes), within its tolerance.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 4;                 // warps that compute
constexpr int kThreads = 32 * kConsumerWarps;     // computing threads
constexpr int kBlock = kThreads + 32;             // + one producer warp
constexpr int kChunk = 16;        // time steps staged per chunk
constexpr int kStages = 3;        // chunks in shared memory at once
constexpr int kMaxState = 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* u;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  const float* h0;   // may be null: zero initial state
  float* y;
  float* hlast;
  int seq, inner, state;
  // element strides (the last dim of every tensor is contiguous)
  long long u_sb, u_ss, dt_sb, dt_ss, a_si, b_sb, b_ss, c_sb, c_ss;
  long long h0_sb, h0_si, y_sb, y_ss;
  // u and dt rows (and B and C rows) may be copied 16 bytes at a time:
  // 16-byte aligned starts, strides and widths
  int vec_ud, vec_bc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// an arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
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

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kS consecutive floats of shared memory into registers, 16 bytes a load
// where kS allows (the rows and each thread's offset are 16-byte aligned)
template <int kS>
__device__ __forceinline__ void read_states(const float* src, float* dst) {
  if constexpr (kS % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(src)[j];
      dst[4 * j] = v.x;
      dst[4 * j + 1] = v.y;
      dst[4 * j + 2] = v.z;
      dst[4 * j + 3] = v.w;
    }
  } else if constexpr (kS % 2 == 0) {
#pragma unroll
    for (int j = 0; j < kS / 2; ++j) {
      const float2 v = reinterpret_cast<const float2*>(src)[j];
      dst[2 * j] = v.x;
      dst[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kS; ++j) dst[j] = src[j];
  }
}

template <int kN, int kL>
struct alignas(16) Stage {
  static constexpr int kCh = kThreads / kL;   // channels per block
  float u[kChunk][kCh];
  float dt[kChunk][kCh];
  float B[kChunk][kN];
  float C[kChunk][kN];
};

// The producer warp's copies of steps t0..t0+steps-1 into `st`: u and dt
// of the block's channels, B and C of its batch row, shared out over the
// warp's lanes, 16 bytes a copy where the layout allows.
template <int kN, int kL>
__device__ __forceinline__ void copy_chunk(const Params& p, Stage<kN, kL>& st,
                                           int b, int i0, int t0, int lane) {
  constexpr int kCh = Stage<kN, kL>::kCh;
  const int steps = min(kChunk, p.seq - t0);
  const float* u = p.u + b * p.u_sb + t0 * p.u_ss + i0;
  const float* dt = p.dt + b * p.dt_sb + t0 * p.dt_ss + i0;
  if (p.vec_ud) {
    for (int k = lane; k < steps * (kCh / 4); k += 32) {
      const int tt = k / (kCh / 4), ch = (k % (kCh / 4)) * 4;
      if (i0 + ch < p.inner) {
        copy16(smem_u32(&st.u[tt][ch]), u + tt * p.u_ss + ch);
        copy16(smem_u32(&st.dt[tt][ch]), dt + tt * p.dt_ss + ch);
      }
    }
  } else {
    for (int k = lane; k < steps * kCh; k += 32) {
      const int tt = k / kCh, ch = k % kCh;
      if (i0 + ch < p.inner) {
        copy4(smem_u32(&st.u[tt][ch]), u + tt * p.u_ss + ch);
        copy4(smem_u32(&st.dt[tt][ch]), dt + tt * p.dt_ss + ch);
      }
    }
  }
  const float* bm = p.B + b * p.b_sb + t0 * p.b_ss;
  const float* cm = p.C + b * p.c_sb + t0 * p.c_ss;
  if (p.vec_bc) {
    const int quads = p.state / 4;
    for (int k = lane; k < steps * quads; k += 32) {
      const int tt = k / quads, n = (k % quads) * 4;
      copy16(smem_u32(&st.B[tt][n]), bm + tt * p.b_ss + n);
      copy16(smem_u32(&st.C[tt][n]), cm + tt * p.c_ss + n);
    }
  } else {
    for (int k = lane; k < steps * p.state; k += 32) {
      const int tt = k / p.state, n = k % p.state;
      copy4(smem_u32(&st.B[tt][n]), bm + tt * p.b_ss + n);
      copy4(smem_u32(&st.C[tt][n]), cm + tt * p.c_ss + n);
    }
  }
}

// One time step of one thread: its kS states of channel `ch` advance by
// step tt of the staged chunk; returns this thread's share of y's sum
// over states (no u·D, no sum across lanes).  Nothing in it waits on
// another lane or on global memory, so the steps of a chunk overlap, and
// only h's FMA chains one step to the next.
template <int kN, int kL>
__device__ __forceinline__ float scan_step(const Stage<kN, kL>& st, int tt,
                                           int ch, int lane_state,
                                           const float (&a)[kN / kL],
                                           float (&h)[kN / kL]) {
  constexpr int kS = kN / kL;               // states per thread
  const float dt_t = st.dt[tt][ch];
  const float dtu = dt_t * st.u[tt][ch];
  float bv[kS], cv[kS];
  read_states<kS>(&st.B[tt][lane_state], bv);
  read_states<kS>(&st.C[tt][lane_state], cv);
  // one running sum: its chain is off the recurrence's path, and the
  // unrolled steps give the scheduler independent work around it
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const float dA = exp2_approx(dt_t * a[s]);
    h[s] = fmaf(dA, h[s], dtu * bv[s]);
    sum = fmaf(h[s], cv[s], sum);
  }
  return sum;
}

// One level of the sum across a channel's lanes: a lane keeps half of its
// 2·kHalf values, trades the other half with the lane kLvl away, and adds.
// Returns the offset of the kept half.
template <int kLvl, int kHalf>
__device__ __forceinline__ int trade_halves(float (&v)[kChunk], int l) {
  const bool hi = (l & kLvl) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = hi ? v[j] : v[j + kHalf];
    const float keep = hi ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kLvl);
  }
  return hi ? kHalf : 0;
}

// Sum v[0..kChunk) over the kL lanes of a channel with a butterfly that
// also transposes: afterwards v[j], j < kChunk / kL, holds the channel's
// sum for step base + j (the return value).  With kL = 4 that is 12
// shuffles a thread per 16 steps, where one sum per step takes 32.
template <int kL>
__device__ __forceinline__ int sum_across_lanes(float (&v)[kChunk], int l) {
  static_assert(kL == 2 || kL == 4, "2 or 4 lanes a channel");
  int base = 0;
  if constexpr (kL == 4) base += trade_halves<2, kChunk / 2>(v, l);
  base += trade_halves<1, kChunk / kL>(v, l);
  return base;
}

template <int kN, int kL>
constexpr int smem_bytes() {
  return 128 + kStages * static_cast<int>(sizeof(Stage<kN, kL>));
}

template <int kN, int kL>
__global__ void __launch_bounds__(kBlock)
mamba_scan_kernel(const Params p) {
  constexpr int kS = kN / kL;               // states per thread
  constexpr int kCh = Stage<kN, kL>::kCh;
  static_assert(2 * kStages * 8 <= 128, "barriers fit the head of smem");
  extern __shared__ __align__(16) unsigned char smem[];
  // kStages "full" barriers (the producer's copies landed), kStages
  // "empty" ones (every consumer warp is done with the stage), then the
  // ring of stages
  const uint32_t full = smem_u32(smem), empty = full + 8 * kStages;
  auto* stage = reinterpret_cast<Stage<kN, kL>*>(smem + 128);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kCh;
  const int N = p.state;
  const int n_chunks = (p.seq + kChunk - 1) / kChunk;

  // state columns past N stay zero in every stage (the producer copies
  // only n < N): with A = 0 there, they add exp(0)·0 + 0 = 0 to h and
  // nothing to y
  for (int k = tid; k < kStages * kChunk * kN; k += kBlock) {
    const int s = k / (kChunk * kN), r = k % (kChunk * kN);
    const int tt = r / kN, n = r % kN;
    if (n >= N) {
      stage[s].B[tt][n] = 0.0f;
      stage[s].C[tt][n] = 0.0f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);               // each producer lane
      mbar_init(empty + 8 * s, kConsumerWarps);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kThreads) {
    // ---- producer warp: keeps up to kStages chunks in flight ----
    const int lane = tid - kThreads;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStages;
      if (c >= kStages) mbar_wait(empty + 8 * s, ((c / kStages) - 1) & 1);
      copy_chunk<kN, kL>(p, stage[s], b, i0, c * kChunk, lane);
      mbar_arrive_on_copies(full + 8 * s);
    }
    return;
  }

  // ---- consumer warps: kL lanes per (b, i) channel ----
  const int ch = tid / kL, l = tid % kL, lane_state = l * kS;
  const int i = i0 + ch;
  const bool active = i < p.inner;
  float a[kS], h[kS];
  float d = 0.0f;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    a[s] = 0.0f;
    h[s] = 0.0f;
  }
  if (active) {
    d = p.D[i];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = lane_state + s;
      if (n < N) {
        a[s] = p.A[i * p.a_si + n] * kLog2e;
        if (p.h0 != nullptr) h[s] = p.h0[b * p.h0_sb + i * p.h0_si + n];
      }
    }
  }

  float* y = p.y + b * p.y_sb + i;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(full + 8 * s, (c / kStages) & 1);
    const Stage<kN, kL>& st = stage[s];
    const int t0 = c * kChunk;
    const int steps = min(kChunk, p.seq - t0);
    // Every lane runs every step (the sums across lanes need the whole
    // warp); a channel past I computes on stale shared memory and writes
    // nothing.
    float v[kChunk];
    if (steps == kChunk) {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt)
        v[tt] = scan_step<kN, kL>(st, tt, ch, lane_state, a, h);
    } else {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt)
        v[tt] = tt < steps ? scan_step<kN, kL>(st, tt, ch, lane_state, a, h)
                           : 0.0f;
    }
    const int base = sum_across_lanes<kL>(v, l);
#pragma unroll
    for (int j = 0; j < kChunk / kL; ++j) {
      const int tt = base + j;
      if (active && tt < steps)
        y[(t0 + tt) * p.y_ss] = v[j] + st.u[tt][ch] * d;
    }
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty + 8 * s);   // stage s is free
  }

  if (active) {
    float* hl = p.hlast + (static_cast<long long>(b) * p.inner + i) * N;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (lane_state + s < N) hl[lane_state + s] = h[s];
  }
}

template <int kN, int kL>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kCh = Stage<kN, kL>::kCh;
  constexpr int kSmem = smem_bytes<kN, kL>();
  if constexpr (kSmem > 48 * 1024) {
    // once per process (the port runs on one card)
    static const cudaError_t set = cudaFuncSetAttribute(
        mamba_scan_kernel<kN, kL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (set != cudaSuccess) return set;
  }
  const dim3 grid((p.inner + kCh - 1) / kCh, batch);
  mamba_scan_kernel<kN, kL><<<grid, kBlock, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int kL>
cudaError_t launch_lanes(const Params& p, int batch, cudaStream_t stream) {
  if (p.state <= 4) return launch<4, kL>(p, batch, stream);
  if (p.state <= 8) return launch<8, kL>(p, batch, stream);
  if (p.state <= 16) return launch<16, kL>(p, batch, stream);
  return launch<32, kL>(p, batch, stream);
}

}  // namespace

// Plain C entry point, called through ctypes.  u, dt (B, S, I), A (I, N),
// Bm, Cm (B, S, N), D (I,), h0 (B, I, N) or null, y (B, S, I) and hlast
// (B, I, N, contiguous) are fp32 device pointers on `device`, each with the
// given element strides and a contiguous last dim.  `lanes` is the lanes
// per channel: 2 ("pair") or 4 ("quad").  Launches on `stream` without
// synchronising and returns the launch's cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int mamba_scan_launch(
    const float* u, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* D, const float* h0, float* y, float* hlast,
    int batch, int seq, int inner, int state,
    long long u_sb, long long u_ss, long long dt_sb, long long dt_ss,
    long long a_si, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, long long h0_sb, long long h0_si, long long y_sb,
    long long y_ss, int lanes, int device, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || inner < 1 || state < 1 ||
      state > kMaxState || (lanes != 2 && lanes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int vec_ud = aligned(u) && aligned(dt) && inner % 4 == 0 &&
                     u_sb % 4 == 0 && u_ss % 4 == 0 && dt_sb % 4 == 0 &&
                     dt_ss % 4 == 0;
  const int vec_bc = aligned(Bm) && aligned(Cm) && state % 4 == 0 &&
                     b_sb % 4 == 0 && b_ss % 4 == 0 && c_sb % 4 == 0 &&
                     c_ss % 4 == 0;
  const Params p{u, dt, A, Bm, Cm, D, h0, y, hlast, seq, inner, state,
                 u_sb, u_ss, dt_sb, dt_ss, a_si, b_sb, b_ss, c_sb, c_ss,
                 h0_sb, h0_si, y_sb, y_ss, vec_ud, vec_bc};
  const auto s = static_cast<cudaStream_t>(stream);
  err = lanes == 2 ? launch_lanes<2>(p, batch, s)
                   : launch_lanes<4>(p, batch, s);
  return static_cast<int>(err);
}
