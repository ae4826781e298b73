// Stacking kernel for Hopper (sm_90a): calibrate, bilinearly shift and
// coadd N regions of interest (ROIs) into one (H, W) image.
//
// Replaces the TPU kernel src/repro/kernels/stacking/stacking.py::_stack_kernel
// (launched by stack_rois_fwd through pl.pallas_call).  For every ROI n:
//
//   img   = (roi_n - sky_n) * cal_n
//   out  += w00*img + w01*right + w10*down + w11*downright
//
// with w00 = (1-dy)(1-dx), w01 = (1-dy)dx, w10 = dy(1-dx), w11 = dy*dx, where
// down / right / downright are img shifted by one row and/or column and the
// shifts repeat row 0 and column 0 at the edge.  With mean != 0 the sum is
// divided by N afterwards (a division, as the reference's wrapper does).
//
// What bounds it.  On paper, memory: a call reads 4*N*H*W bytes of ROIs
// (plus 16*N of per-ROI scalars) and writes 4*H*W, with about 16 fp32
// operations per ROI pixel.  On the main path (N = 8 and 32 at 100 x 100,
// 0.1 and 0.4 us of bytes) the inputs were just written and sit in L2, so
// a call costs what its launch costs plus the chain of dependent L2 round
// trips each thread makes.  The design cuts that chain to one round trip.
//
// Design.  A simpler design -- one thread per pixel looping over all N
// ROIs one at a time, on 32 x 8 tiles -- gives 52 blocks at 100 x 100 for
// 132 SMs and N dependent round trips.
//  - One thread per output pixel, pixels numbered flat (p = r*W + c), 64 a
//    block: 157 blocks at 100 x 100, every lane busy (no 32-column tile
//    overhanging a 100-column row), every warp's loads coalesced.
//  - The ROIs are walked in groups of kGroup = 8, the group loop unrolled
//    at compile time with the tail masked (n < N): all of a group's 32
//    pixel loads and 32 scalar loads are issued before any of its
//    arithmetic, so a group costs one round trip, not eight.
//  - Larger N is split across kSplit thread rows of the block (1, 2, 4 or
//    8, chosen by the host from the group count): row k takes groups k,
//    k + kSplit, ...  in order, and row 0 adds the rows' partial sums in
//    order k = 0..kSplit-1 from shared memory.  At N = 32 every thread
//    handles one group: one round trip.  The order is fixed, so a call
//    gives the same bits every time; no atomics, no second launch.  The
//    sum runs over n in another order than the reference's only when
//    N > 8 (rounding-level differences, held at rtol 1e-5, atol 1e-5 *
//    max|out|); with N <= 8 it is the reference's order.
//  - The four neighbour reads of a ROI pixel stay four loads: they are
//    issued together, the three neighbours hit in L1 (neighbouring lanes
//    and the row above read the same lines), and staging a halo tile in
//    shared memory would put a barrier between the one round trip and the
//    arithmetic.  The edge rule is clamped addressing (row 0 / column 0
//    repeat), so no fill value is ever read.
// The per-ROI scalars are read by every thread at the same address (one
// broadcast transaction per warp, cached in L1).
//
// A mean-sky coadd in one call (stack_rois_coadd).  A coadd whose sky is
// a given fraction of each tile's mean, with unit calibration and shifts
// given on the host, is one foreign call that enqueues its kernels on the
// caller's stream and returns:
//  - coadd_prep_kernel, one block per tile: sky[n] = sky_fraction *
//    mean(tile n) (an fp32 block reduction over every pixel), cal[n] = 1,
//    and the tile's dy[n], dx[n], written into a device scratch of 4N
//    floats;
//  - stack_rois_kernel, unchanged, reading that scratch.
// Why one call: the executors are many Python threads; every PyTorch call
// around a launch gives up the interpreter lock and waits to take it back
// behind the others, and a blocking copy of the shifts from pageable
// memory synchronises the stream that every executor shares, so a request
// waited for every kernel and store read queued before it.  This entry is
// called with the interpreter lock held (the library is a PyDLL) and
// makes no synchronising call: the coadd is queued and nothing waits for
// it.
// The shifts travel as kernel parameters: the launch copies them with its
// arguments, so they need no copy of their own.  A prep launch carries
// kParamShifts pairs (2 KB, within the 4 KB of parameters every CUDA
// version takes); more tiles (a join of several files) take one prep
// launch per kParamShifts tiles, each with its own shifts and a base
// offset into the scratch.
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 64;     // output pixels per block (two warps)
constexpr int kGroup = 8;    // ROIs whose loads are issued together

template <int kSplit>
__global__ void __launch_bounds__(kPix * kSplit)
stack_rois_kernel(const float* __restrict__ rois,
                  const float* __restrict__ sky,
                  const float* __restrict__ cal,
                  const float* __restrict__ dy,
                  const float* __restrict__ dx,
                  float* __restrict__ out,
                  int n, int h, int w, int mean) {
  const long long plane = static_cast<long long>(h) * w;
  const long long p = static_cast<long long>(blockIdx.x) * kPix + threadIdx.x;
  const int k = threadIdx.y;   // which share of the groups this row takes
  const bool inside = p < plane;
  const long long q = inside ? p : 0;   // outside threads read pixel 0
  const long long r = q / w;
  const long long c = q - r * w;
  // the one-pixel shifts repeat column 0 / row 0 at the edge
  const long long o00 = q;                         // img
  const long long o01 = c > 0 ? q - 1 : q;         // right
  const long long o10 = r > 0 ? q - w : q;         // down
  const long long o11 = r > 0 ? o01 - w : o01;     // downright

  float acc = 0.0f;
  const int groups = (n + kGroup - 1) / kGroup;
  for (int g = k; g < groups; g += kSplit) {
    const int n0 = g * kGroup;
    float v[kGroup][4], s[kGroup][4];
    // every load of the group first ...
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (n0 + j < n) {
        const float* img = rois + (n0 + j) * plane;
        v[j][0] = __ldg(img + o00);
        v[j][1] = __ldg(img + o01);
        v[j][2] = __ldg(img + o10);
        v[j][3] = __ldg(img + o11);
        s[j][0] = __ldg(sky + n0 + j);
        s[j][1] = __ldg(cal + n0 + j);
        s[j][2] = __ldg(dy + n0 + j);
        s[j][3] = __ldg(dx + n0 + j);
      }
    }
    // ... then the group's arithmetic, in n order
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (n0 + j < n) {
        const float sk = s[j][0], ca = s[j][1], y = s[j][2], x = s[j][3];
        const float w00 = (1.0f - y) * (1.0f - x);
        const float w01 = (1.0f - y) * x;
        const float w10 = y * (1.0f - x);
        const float w11 = y * x;
        acc += w00 * ((v[j][0] - sk) * ca) + w01 * ((v[j][1] - sk) * ca) +
               w10 * ((v[j][2] - sk) * ca) + w11 * ((v[j][3] - sk) * ca);
      }
    }
  }
  if constexpr (kSplit > 1) {
    __shared__ float part[kSplit][kPix];
    part[k][threadIdx.x] = acc;
    __syncthreads();
    if (k != 0) return;
#pragma unroll
    for (int kk = 1; kk < kSplit; ++kk) acc += part[kk][threadIdx.x];
  }
  if (inside) out[p] = mean ? acc / static_cast<float>(n) : acc;
}

template <int kSplit>
cudaError_t launch(const float* rois, const float* sky, const float* cal,
                   const float* dy, const float* dx, float* out, int n,
                   int h, int w, int mean, cudaStream_t stream) {
  const long long plane = static_cast<long long>(h) * w;
  const dim3 grid(static_cast<unsigned>((plane + kPix - 1) / kPix));
  const dim3 block(kPix, kSplit);
  stack_rois_kernel<kSplit><<<grid, block, 0, stream>>>(
      rois, sky, cal, dy, dx, out, n, h, w, mean);
  return cudaGetLastError();
}

// The kernel for N ROIs: kSplit rows for ceil(N / kGroup) groups.
cudaError_t launch_stack(const float* rois, const float* sky, const float* cal,
                         const float* dy, const float* dx, float* out, int n,
                         int h, int w, int mean, cudaStream_t s) {
  const int groups = (n + kGroup - 1) / kGroup;
  if (groups >= 8)
    return launch<8>(rois, sky, cal, dy, dx, out, n, h, w, mean, s);
  if (groups >= 4)
    return launch<4>(rois, sky, cal, dy, dx, out, n, h, w, mean, s);
  if (groups >= 2)
    return launch<2>(rois, sky, cal, dy, dx, out, n, h, w, mean, s);
  return launch<1>(rois, sky, cal, dy, dx, out, n, h, w, mean, s);
}

int set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

// ---- the one-call coadd -------------------------------------------------

constexpr int kPrepThreads = 256;
// shift pairs one prep launch carries: the app's files hold 8 to 150 tiles,
// so a request's coadd takes one prep launch
constexpr int kParamShifts = 256;

// dy and dx of up to kParamShifts tiles, by value in the launch
struct Shifts {
  float dy[kParamShifts];
  float dx[kParamShifts];
};

// Block b, for tile t = base + b: sky[t] = sky_fraction * mean(tile t) in
// fp32, cal[t] = 1, and dy[t], dx[t] from the launch's parameters.
// Scratch layout: sky, cal, dy, dx, N floats each.  The sum's order is
// fixed by the thread layout, so a call gives the same bits every time.
__global__ void __launch_bounds__(kPrepThreads)
coadd_prep_kernel(const float* __restrict__ rois, long long plane, int n,
                  int base, float sky_fraction, float* __restrict__ scratch,
                  const __grid_constant__ Shifts shifts) {
  const int b = blockIdx.x;
  const int t = base + b;
  const float* tile = rois + t * plane;
  float acc = 0.0f;
  if ((plane & 3) == 0 && (reinterpret_cast<size_t>(tile) & 15) == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    const long long n4 = plane >> 2;
#pragma unroll 4
    for (long long i = threadIdx.x; i < n4; i += kPrepThreads) {
      const float4 v = __ldg(t4 + i);
      acc += (v.x + v.y) + (v.z + v.w);
    }
  } else {
#pragma unroll 4
    for (long long i = threadIdx.x; i < plane; i += kPrepThreads)
      acc += __ldg(tile + i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sum[kPrepThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kPrepThreads / 32; ++k) sum += warp_sum[k];
  scratch[t] = sum / static_cast<float>(plane) * sky_fraction;
  scratch[n + t] = 1.0f;
  scratch[2 * n + t] = shifts.dy[b];
  scratch[3 * n + t] = shifts.dx[b];
}

// The prep kernel over all n tiles, kParamShifts tiles a launch.
// host_shifts holds every dy, then every dx.
cudaError_t launch_prep(const float* rois, long long plane, int n,
                        float sky_fraction, float* scratch,
                        const float* host_shifts, cudaStream_t s) {
  for (int base = 0; base < n; base += kParamShifts) {
    const int count = n - base < kParamShifts ? n - base : kParamShifts;
    Shifts p;
    for (int i = 0; i < count; ++i) {
      p.dy[i] = host_shifts[base + i];
      p.dx[i] = host_shifts[n + base + i];
    }
    coadd_prep_kernel<<<count, kPrepThreads, 0, s>>>(
        rois, plane, n, base, sky_fraction, scratch, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, called through ctypes.  Every pointer is a device
// pointer to contiguous fp32 data on `device`: rois (n, h, w), sky/cal/dy/dx
// (n,), out (h, w).  Launches on `stream` without synchronising and returns
// the launch's cudaGetLastError() (0 on success).  The current device is
// set only when it is not `device` already.
extern "C" int stack_rois_launch(const float* rois, const float* sky,
                                 const float* cal, const float* dy,
                                 const float* dx, float* out, int n, int h,
                                 int w, int mean, int device, void* stream) {
  const int err = set_device(device);
  if (err != 0) return err;
  return static_cast<int>(launch_stack(rois, sky, cal, dy, dx, out, n, h,
                                       w, mean,
                                       static_cast<cudaStream_t>(stream)));
}

// A mean-sky coadd in one call (see the head of this file).  rois (n, h,
// w), scratch (4n,) and out (h, w) are device pointers to contiguous fp32
// on `device`; shifts is a host pointer to 2n fp32, every dy then every
// dx.  Enqueues the prep kernel (one launch per kParamShifts tiles) and the
// stacking kernel on `stream`, and returns 0 or the first CUDA error.
// Nothing waits for the card.
extern "C" int stack_rois_coadd(const float* rois, const float* shifts,
                                float sky_fraction, float* scratch,
                                float* out, int n, int h, int w, int mean,
                                int device, void* stream) {
  const int err = set_device(device);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      launch_prep(rois, static_cast<long long>(h) * w, n, sky_fraction,
                  scratch, shifts, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* sky = scratch;
  return static_cast<int>(launch_stack(rois, sky, sky + n, sky + 2 * n,
                                       sky + 3 * n, out, n, h, w, mean, s));
}
