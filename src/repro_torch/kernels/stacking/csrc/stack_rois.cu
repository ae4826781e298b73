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
// What bounds it: memory.  A call reads 4*N*H*W bytes of ROIs (plus 16*N of
// per-ROI scalars) and writes 4*H*W; it does about 16 fp32 operations per
// ROI pixel, far below the card's operations-per-byte balance.
//
// Design.  The TPU kernel walks N as a sequential grid axis and carries the
// (H, W) accumulator in VMEM scratch between grid steps.  Blocks on Hopper
// run in no order, so here the N loop moves inside the thread: one thread
// per output pixel, blocks of 32 x 8 threads tile (H, W), and each thread
// loops n = 0..N-1 in order with its accumulator in a register -- no
// reduction across blocks, no atomics, and every ROI pixel is read from
// device memory once (its three neighbour reads hit L1, since the
// neighbouring threads of the same warp and block read them too).  A warp
// covers 32 consecutive columns of one row, so every load is coalesced.
// The per-ROI scalars are staged through shared memory in chunks of 256.
// The loop bound is N, so no tail padding (and no `valid` mask) exists.
// The sum runs over n in order, as the TPU kernel's does; against it the
// only arithmetic difference left is FMA contraction of the multiply-adds
// (the plain PyTorch version may also sum over n in another order).
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;                 // columns per block: one warp
constexpr int kTileY = 8;                  // rows per block
constexpr int kThreads = kTileX * kTileY;  // 256
constexpr int kChunk = 256;                // per-ROI scalars staged per pass

__global__ void __launch_bounds__(kThreads)
stack_rois_kernel(const float* __restrict__ rois,
                  const float* __restrict__ sky,
                  const float* __restrict__ cal,
                  const float* __restrict__ dy,
                  const float* __restrict__ dx,
                  float* __restrict__ out,
                  int n, int h, int w, int mean) {
  __shared__ float s_sky[kChunk];
  __shared__ float s_cal[kChunk];
  __shared__ float s_dy[kChunk];
  __shared__ float s_dx[kChunk];

  const int c = blockIdx.x * kTileX + threadIdx.x;
  const int r = blockIdx.y * kTileY + threadIdx.y;
  const bool inside = r < h && c < w;
  // the one-pixel shifts repeat column 0 / row 0 at the edge
  const int c_left = c > 0 ? c - 1 : 0;
  const int r_up = r > 0 ? r - 1 : 0;
  const long long plane = static_cast<long long>(h) * w;
  const long long o00 = static_cast<long long>(r) * w + c;          // img
  const long long o01 = static_cast<long long>(r) * w + c_left;     // right
  const long long o10 = static_cast<long long>(r_up) * w + c;       // down
  const long long o11 = static_cast<long long>(r_up) * w + c_left;  // downright
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  float acc = 0.0f;
  for (int n0 = 0; n0 < n; n0 += kChunk) {
    const int m = min(kChunk, n - n0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = tid; j < m; j += kThreads) {
      s_sky[j] = sky[n0 + j];
      s_cal[j] = cal[n0 + j];
      s_dy[j] = dy[n0 + j];
      s_dx[j] = dx[n0 + j];
    }
    __syncthreads();
    if (inside) {
      const float* img = rois + static_cast<long long>(n0) * plane;
      for (int j = 0; j < m; ++j, img += plane) {
        const float s = s_sky[j];
        const float k = s_cal[j];
        const float y = s_dy[j];
        const float x = s_dx[j];
        const float w00 = (1.0f - y) * (1.0f - x);
        const float w01 = (1.0f - y) * x;
        const float w10 = y * (1.0f - x);
        const float w11 = y * x;
        const float v00 = (img[o00] - s) * k;
        const float v01 = (img[o01] - s) * k;
        const float v10 = (img[o10] - s) * k;
        const float v11 = (img[o11] - s) * k;
        acc += w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
      }
    }
  }
  if (inside) out[o00] = mean ? acc / static_cast<float>(n) : acc;
}

}  // namespace

// Plain C entry point, called through ctypes.  Every pointer is a device
// pointer to contiguous fp32 data on `device`: rois (n, h, w), sky/cal/dy/dx
// (n,), out (h, w).  Launches on `stream` without synchronising and returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int stack_rois_launch(const float* rois, const float* sky,
                                 const float* cal, const float* dy,
                                 const float* dx, float* out, int n, int h,
                                 int w, int mean, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  stack_rois_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rois, sky, cal, dy, dx, out, n, h, w, mean);
  return static_cast<int>(cudaGetLastError());
}
