// Fused N-iteration binary dilate + erode (3x3 cross) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dilate_erode_pallas`
// (hairfastgan_tpu/ops/pallas_morphology.py:55). Same semantics: binarize
// (> 0), then `iterations` rounds of a 3x3-cross max (dilate) and a 3x3-cross
// min (erode); neighbours outside the image read as 0 for both ops; both
// outputs, in the input dtype (f32 or bf16), from one launch.
//
// What bounds it: bytes. It is a 5-point stencil with no arithmetic to speak
// of; the plain PyTorch version re-reads and re-writes every plane ~10 times
// per iteration through device memory. This kernel reads each input pixel
// once (plus a halo), keeps every iteration in shared memory as one byte per
// pixel, and writes each output pixel once.
//
// Design: the Pallas kernel holds one whole [H, W] f32 plane per grid step,
// sized for VMEM; a 256^2 f32 plane (256 KB) does not fit in a block's 227 KB
// of shared memory. Here a block owns TILE_H output rows of one mask and
// loads them with a halo of `iterations` rows above and below (rows outside
// the image are held at 0). Each iteration recomputes the whole tile+halo
// from ping-pong buffers; rows at the tile's edge lose one correct row per
// iteration, so after `iterations` rounds exactly the TILE_H centre rows are
// right. Shared memory holds four u8 planes (dilate and erode, ping and
// pong) of (TILE_H + 2*iterations) x W bytes; beyond the device's opt-in
// limit cudaFuncSetAttribute fails and hf_dilate_erode returns its error.
// Grid (ceil(H / TILE_H), B): 8 x B blocks at the 256^2 masks of the swap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dilate_erode_kernel(const T* __restrict__ in, T* __restrict__ dil,
                    T* __restrict__ ero, int H, int W, int iterations) {
  extern __shared__ uint8_t smem[];
  const int halo = iterations;
  const int rows = kTileH + 2 * halo;
  const size_t plane = (size_t)rows * W;
  uint8_t* d_cur = smem;
  uint8_t* d_nxt = smem + plane;
  uint8_t* e_cur = smem + 2 * plane;
  uint8_t* e_nxt = smem + 3 * plane;

  const int y0 = blockIdx.x * kTileH - halo;  // image row of smem row 0
  const size_t base = (size_t)blockIdx.y * H * W;

  for (int r = 0; r < rows; ++r) {
    const int y = y0 + r;
    const bool inside = y >= 0 && y < H;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      uint8_t v = 0;
      if (inside) v = load_f(in + base + (size_t)y * W + c) > 0.0f;
      d_cur[r * W + c] = v;
      e_cur[r * W + c] = v;
    }
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    for (int r = 0; r < rows; ++r) {
      const int y = y0 + r;
      const bool inside = y >= 0 && y < H;
      for (int c = threadIdx.x; c < W; c += blockDim.x) {
        const int i = r * W + c;
        uint8_t dv = 0, ev = 0;
        if (inside) {
          // out of the image -> 0; out of the tile (halo edge) -> 0 as well,
          // which only corrupts halo rows that are never stored
          const uint8_t du = r > 0 ? d_cur[i - W] : 0;
          const uint8_t dd = r + 1 < rows ? d_cur[i + W] : 0;
          const uint8_t dl = c > 0 ? d_cur[i - 1] : 0;
          const uint8_t dr = c + 1 < W ? d_cur[i + 1] : 0;
          dv = d_cur[i] | du | dd | dl | dr;
          const uint8_t eu = r > 0 ? e_cur[i - W] : 0;
          const uint8_t ed = r + 1 < rows ? e_cur[i + W] : 0;
          const uint8_t el = c > 0 ? e_cur[i - 1] : 0;
          const uint8_t er = c + 1 < W ? e_cur[i + 1] : 0;
          ev = e_cur[i] & eu & ed & el & er;
        }
        d_nxt[i] = dv;
        e_nxt[i] = ev;
      }
    }
    __syncthreads();
    uint8_t* t = d_cur; d_cur = d_nxt; d_nxt = t;
    t = e_cur; e_cur = e_nxt; e_nxt = t;
  }

  for (int r = halo; r < halo + kTileH; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const size_t o = base + (size_t)y * W + c;
      store_f(dil + o, (float)d_cur[r * W + c]);
      store_f(ero + o, (float)e_cur[r * W + c]);
    }
  }
}

template <typename T>
int launch(const void* in, void* dil, void* ero, int B, int H, int W,
           int iterations, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)(kTileH + 2 * iterations) * W;
  if (smem > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dilate_erode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  const dim3 grid((H + kTileH - 1) / kTileH, B);
  dilate_erode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(dil), static_cast<T*>(ero),
      H, W, iterations);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in/dil/ero: contiguous [B, H, W] planes of dtype 0 = f32, 1 = bf16.
// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
int hf_dilate_erode(const void* in, void* dil, void* ero, int B, int H, int W,
                    int iterations, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || iterations < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, dil, ero, B, H, W, iterations, s);
  if (dtype == 1) return launch<__nv_bfloat16>(in, dil, ero, B, H, W, iterations, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
