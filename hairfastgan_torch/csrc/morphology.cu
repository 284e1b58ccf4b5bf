// Fused N-iteration binary dilate + erode (3x3 cross) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dilate_erode_pallas`
// (hairfastgan_tpu/ops/pallas_morphology.py:55). Same semantics: binarize
// (> 0), then `iterations` rounds of a 3x3-cross max (dilate) and a 3x3-cross
// min (erode); neighbours outside the image read as 0 for both ops; both
// outputs, in the input dtype (f32 or bf16), from one launch.
//
// What bounds it: bytes and latency. It is a 5-point stencil with no
// arithmetic to speak of; the plain PyTorch version re-reads and re-writes
// every plane ~10 times per iteration through device memory. This kernel
// reads each input pixel once (plus a halo), keeps every iteration in shared
// memory at one bit per pixel, and writes each output pixel once.
//
// Design: the Pallas kernel holds one whole [H, W] f32 plane per grid step,
// sized for VMEM; a block's 227 KB of shared memory holds no 1024^2 plane
// (the final composite dilates 1024^2 masks 30 times). Here a block owns a
// 2-D tile of kTileH rows x kTileWords 32-column words of one mask and loads
// it with a halo of `iterations` rows above and below and
// halo_w = ceil(iterations / 32) words left and right. A warp packs 32
// neighbouring pixels into one word with a ballot (coalesced loads); one
// thread updates one word per iteration with shifts, so 32 pixels move per
// instruction. Each iteration recomputes the whole tile + halo from
// ping-pong buffers; words at the loaded region's edge read 0 beyond it and
// lose one correct row or column per iteration, which the halo absorbs, so
// after `iterations` rounds the tile's own words are exact. Pixels outside
// the image (rows < 0 or >= H, columns < 0 or >= W) are masked to 0 after
// every iteration, which keeps the image border at 0 for both ops.
//
// Shared memory: 4 planes (dilate and erode, ping and pong) of
// (kTileH + 2*iterations) x (kTileWords + 2*halo_w) words of 4 bytes:
//   bytes = 16 * (32 + 2*iterations) * (4 + 2*ceil(iterations / 32)),
// independent of H and W. 6,720 B at the swap's 5 iterations, 8,832 B at the
// composite's 30. Launches take at most kMaxIterations = 256 iterations
// (174,080 B, under the 232,448 B a block may opt into on an H100); beyond
// that hf_dilate_erode refuses the launch and returns cudaErrorInvalidValue.
// Grid (ceil(ceil(W/32) / kTileWords), ceil(H / kTileH), B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;      // output rows of a block
constexpr int kTileWords = 4;   // output columns of a block, in 32-column words
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // loads a warp keeps in flight while packing
constexpr int kMaxIterations = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One word of the next iteration: the cross over word i (row r, word k) of a
// rows x words plane; bit j is column 32*word + j.
template <bool kDilate>
__device__ __forceinline__ uint32_t cross(const uint32_t* p, int i, int r, int k,
                                          int rows, int words) {
  const uint32_t c = p[i];
  const uint32_t up = r > 0 ? p[i - words] : 0u;
  const uint32_t dn = r + 1 < rows ? p[i + words] : 0u;
  const uint32_t lw = k > 0 ? p[i - 1] : 0u;
  const uint32_t rw = k + 1 < words ? p[i + 1] : 0u;
  const uint32_t left = (c << 1) | (lw >> 31);   // bit j <- column j - 1
  const uint32_t right = (c >> 1) | (rw << 31);  // bit j <- column j + 1
  return kDilate ? (c | up | dn | left | right) : (c & up & dn & left & right);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dilate_erode_kernel(const T* __restrict__ in, T* __restrict__ dil,
                    T* __restrict__ ero, int H, int W, int iterations) {
  extern __shared__ uint32_t smem[];
  const int halo_w = (iterations + 31) / 32;
  const int rows = kTileH + 2 * iterations;
  const int words = kTileWords + 2 * halo_w;
  const int n = rows * words;
  uint32_t* d_cur = smem;
  uint32_t* d_nxt = smem + n;
  uint32_t* e_cur = smem + 2 * n;
  uint32_t* e_nxt = smem + 3 * n;

  const int y0 = blockIdx.y * kTileH - iterations;  // image row of tile row 0
  const int g0 = blockIdx.x * kTileWords - halo_w;  // image word of tile word 0
  const int img_words = (W + 31) / 32;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Pack: warp-uniform loop over words; lane j reads column 32*g + j.
  for (int i0 = warp; i0 < n; i0 += kWarps * kUnroll) {
    bool v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps;
      const int y = y0 + i / words;
      const int c = (g0 + i % words) * 32 + lane;
      v[u] = i < n && y >= 0 && y < H && c >= 0 && c < W &&
             load_f(in + base + (size_t)y * W + c) > 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps;
      const uint32_t bits = __ballot_sync(0xffffffffu, v[u]);
      if (lane == 0 && i < n) {
        d_cur[i] = bits;
        e_cur[i] = bits;
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / words;
      const int k = i - r * words;
      const int y = y0 + r;
      const int g = g0 + k;
      uint32_t inside = 0u;  // bits of this word that lie in the image
      if (y >= 0 && y < H && g >= 0 && g < img_words) {
        const int cols = W - g * 32;
        inside = cols >= 32 ? 0xffffffffu : ((1u << cols) - 1u);
      }
      d_nxt[i] = inside & cross<true>(d_cur, i, r, k, rows, words);
      e_nxt[i] = inside & cross<false>(e_cur, i, r, k, rows, words);
    }
    __syncthreads();
    uint32_t* t = d_cur; d_cur = d_nxt; d_nxt = t;
    t = e_cur; e_cur = e_nxt; e_nxt = t;
  }

  // Unpack the tile's own words: lane j writes column 32*g + j.
  for (int i = warp; i < kTileH * kTileWords; i += kWarps) {
    const int r = iterations + i / kTileWords;
    const int k = halo_w + i % kTileWords;
    const int y = y0 + r;
    const int c = (g0 + k) * 32 + lane;
    if (y < H && c < W) {
      const int j = r * words + k;
      const size_t o = base + (size_t)y * W + c;
      store_f(dil + o, (float)((d_cur[j] >> lane) & 1u));
      store_f(ero + o, (float)((e_cur[j] >> lane) & 1u));
    }
  }
}

template <typename T>
int launch(const void* in, void* dil, void* ero, int B, int H, int W,
           int iterations, cudaStream_t stream) {
  const int halo_w = (iterations + 31) / 32;
  const size_t smem = 4 * sizeof(uint32_t) * (size_t)(kTileH + 2 * iterations) *
                      (kTileWords + 2 * halo_w);
  const long long tiles_x = ((W + 31) / 32 + kTileWords - 1) / kTileWords;
  const long long tiles_y = (H + kTileH - 1) / kTileH;
  if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dilate_erode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y, B);
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
  if (B <= 0 || H <= 0 || W <= 0 || iterations < 0 ||
      iterations > kMaxIterations || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, dil, ero, B, H, W, iterations, s);
  if (dtype == 1) return launch<__nv_bfloat16>(in, dil, ero, B, H, W, iterations, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
