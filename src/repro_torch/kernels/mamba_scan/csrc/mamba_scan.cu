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
// What bounds it on this card.  Each (t, i, n) costs one exp and a handful
// of FMAs, and each (t, i) moves 12 bytes (u, dt in, y out).  The exps run
// on the special-function units (16 results per clock per SM, about
// 4.2e12/s on 132 SMs at 1.98 GHz); the bytes at 3.35 TB/s.  At the serving
// shape (B=8, S=96, I=8192, N=16) the two terms are about equal (24 us
// each); at a long prefill (B=1, S=4096) the exps dominate.  So the kernel
// reads every input once, keeps the state and A in registers, and runs
// nothing but the exp and FMAs per (t, i, n) in its inner loop.
//
// Design.  The TPU kernel tiles I across the parallel grid, walks S as a
// sequential grid axis in chunks, and carries h in VMEM scratch between
// chunks.  Hopper's blocks run in no order, so here the loop over t lives
// inside a block: one thread owns one (b, i) channel, holds its N states
// and its row of A in registers, and walks t from 0 to S-1.  A block of 64
// threads owns 64 neighbouring channels of one batch row, so the loads of
// u and dt and the stores of y are coalesced across a warp, while B[b,t,:]
// and C[b,t,:] are the same for every thread of the block (a shared-memory
// broadcast).  The block stages kChunk time steps of u and dt (its
// channels) and of B and C in shared memory with cp.async, double-buffered:
// the next chunk's copies are in flight while the current chunk is walked,
// so the recurrence does not wait on device memory each step.  h_last is
// written once at the end.  A null h0 means a zero state (the forward
// passes none, and reads nothing for it).  Ragged I and S are masked here
// (no padding: the TPU wrapper pads I to block_i and S to its chunk, with
// dt = 0 on padded steps).  B and C come as column slices of the model's
// fp32 projection, so the kernel takes their batch and sequence strides.
//
// Occupancy.  One thread per channel gives B·I threads: 65,536 at the
// serving shape (1,024 blocks, about 8 per SM), but 8,192 at a B=1 prefill
// (128 blocks of 2 warps, one per SM), where each SM has too few warps to
// hide the exp and FMA latencies.  Splitting N across lanes is the remedy,
// in a later kernel.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 16;     // time steps staged per chunk
constexpr int kMaxState = 32;

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
};

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group of copies (the newest) is still in flight
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int kN>
struct Stage {
  float u[kChunk][kThreads];
  float dt[kChunk][kThreads];
  float B[kChunk][kN];
  float C[kChunk][kN];
};

// Start the copies of chunk c (steps t0..t0+steps-1) into `st`.  Each thread
// copies its own channel's u and dt; the block shares out B and C.
template <int kN>
__device__ __forceinline__ void load_chunk(const Params& p, Stage<kN>& st,
                                           int b, int i, bool active,
                                           int t0) {
  const int steps = min(kChunk, p.seq - t0);
  const int tid = threadIdx.x;
  if (active) {
    const float* u = p.u + b * p.u_sb + i;
    const float* dt = p.dt + b * p.dt_sb + i;
    for (int tt = 0; tt < steps; ++tt) {
      const long long t = t0 + tt;
      copy_async(&st.u[tt][tid], u + t * p.u_ss);
      copy_async(&st.dt[tt][tid], dt + t * p.dt_ss);
    }
  }
  const float* bm = p.B + b * p.b_sb;
  const float* cm = p.C + b * p.c_sb;
  for (int k = tid; k < steps * p.state; k += kThreads) {
    const int tt = k / p.state, n = k % p.state;
    const long long t = t0 + tt;
    copy_async(&st.B[tt][n], bm + t * p.b_ss + n);
    copy_async(&st.C[tt][n], cm + t * p.c_ss + n);
  }
}

template <int kN>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const Params p) {
  __shared__ Stage<kN> stage[2];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + tid;
  const bool active = i < p.inner;
  const int N = p.state;

  // state columns past N stay zero in both stages: with A = 0 there, they
  // add exp(0)·0 + 0 = 0 to h and nothing to y
  for (int k = tid; k < 2 * kChunk * kN; k += kThreads) {
    const int s = k / (kChunk * kN), r = k % (kChunk * kN);
    const int tt = r / kN, n = r % kN;
    if (n >= N) {
      stage[s].B[tt][n] = 0.0f;
      stage[s].C[tt][n] = 0.0f;
    }
  }

  float a[kN], h[kN];
  float d = 0.0f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = 0.0f;
    h[n] = 0.0f;
  }
  if (active) {
    d = p.D[i];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n < N) {
        a[n] = p.A[i * p.a_si + n];
        if (p.h0 != nullptr) h[n] = p.h0[b * p.h0_sb + i * p.h0_si + n];
      }
    }
  }

  const int n_chunks = (p.seq + kChunk - 1) / kChunk;
  load_chunk<kN>(p, stage[0], b, i, active, 0);
  commit_copies();
  float* y = p.y + b * p.y_sb + i;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      load_chunk<kN>(p, stage[(c + 1) & 1], b, i, active, (c + 1) * kChunk);
    commit_copies();          // an empty group on the last chunk
    wait_all_but_newest();    // chunk c has landed (this thread's copies)
    __syncthreads();          // ... and every thread's
    const Stage<kN>& st = stage[c & 1];
    const int t0 = c * kChunk;
    const int steps = min(kChunk, p.seq - t0);
    if (active) {
      for (int tt = 0; tt < steps; ++tt) {
        const float u_t = st.u[tt][tid];
        const float dt_t = st.dt[tt][tid];
        const float dtu = dt_t * u_t;
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float dA = __expf(dt_t * a[n]);
          h[n] = dA * h[n] + dtu * st.B[tt][n];
          acc += h[n] * st.C[tt][n];
        }
        y[(t0 + tt) * p.y_ss] = acc + u_t * d;
      }
    }
    __syncthreads();          // stage c & 1 is refilled at c + 1
  }

  if (active) {
    float* hl = p.hlast + (static_cast<long long>(b) * p.inner + i) * N;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      if (n < N) hl[n] = h[n];
  }
}

template <int kN>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.inner + kThreads - 1) / kThreads, batch);
  mamba_scan_kernel<kN><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, called through ctypes.  u, dt (B, S, I), A (I, N),
// Bm, Cm (B, S, N), D (I,), h0 (B, I, N) or null, y (B, S, I) and hlast
// (B, I, N, contiguous) are fp32 device pointers on `device`, each with the
// given element strides and a contiguous last dim.  Launches on `stream`
// without synchronising and returns the launch's cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int mamba_scan_launch(
    const float* u, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* D, const float* h0, float* y, float* hlast,
    int batch, int seq, int inner, int state,
    long long u_sb, long long u_ss, long long dt_sb, long long dt_ss,
    long long a_si, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, long long h0_sb, long long h0_si, long long y_sb,
    long long y_ss, int device, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || inner < 1 || state < 1 ||
      state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{u, dt, A, Bm, Cm, D, h0, y, hlast, seq, inner, state,
                 u_sb, u_ss, dt_sb, dt_ss, a_si, b_sb, b_ss, c_sb, c_ss,
                 h0_sb, h0_si, y_sb, y_ss};
  const auto s = static_cast<cudaStream_t>(stream);
  if (state <= 4) err = launch<4>(p, batch, s);
  else if (state <= 8) err = launch<8>(p, batch, s);
  else if (state <= 16) err = launch<16>(p, batch, s);
  else err = launch<32>(p, batch, s);
  return static_cast<int>(err);
}
