// score_blocks: gather + EXPRESS descriptor + Hamming distance for B
// candidate 16x16 blocks of one u8 image, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel movslam_tpu/ops/pallas_kernels.py::
// score_blocks (body _score_kernel). The TPU version DMAs a 64-row band per
// block into VMEM and selects the block with one-hot matmuls, because a TPU
// cannot slice lanes at a dynamic offset. A GPU loads at any address, so the
// design here is one warp per candidate block:
//   - pass w (0..7) of lane l reads pixel row 2w + l/16, column l%16 of the
//     clamped block: 32 consecutive pixels = descriptor bits 32w..32w+31;
//   - the lane classifies its pixel against center +- threshold in f32;
//   - __ballot_sync turns the 32 predicates into descriptor word w, already
//     in pack_bits order (word i/32, bit i%32, ops/bitdesc.py);
//   - __popc(word ^ prev[w]) summed over the 8 passes is the distance.
//
// What bounds it: at B = 8192 (2048 tracks x 4 MV candidates, the main
// path's shape) the kernel reads 2 MB of pixels, mostly L2 hits on a 300 KB
// image, and does ~2M compares: it is bound by latency and launch cost, not
// by bandwidth or arithmetic. Each pass is two 16-byte row segments read
// as single bytes; 8 warps (8 candidates) per 256-thread block. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W: ~41 us per launch at B = 8192, against
// ~550-630 us for the plain PyTorch version (PERF.md).
//
// Semantics (bit-exact with ops/kernels.py::score_blocks_ref): top-left
// clamped to [0, W-16] x [0, H-16]; center = floor(mean of the central 2x2)
// in f32; bit set where px < center - thr or px > center + thr.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kWords = 8;
constexpr int kWarpsPerBlock = 8;

__global__ void score_blocks_kernel(const uint8_t* __restrict__ img, int H,
                                    int W, const int32_t* __restrict__ tl,
                                    const int32_t* __restrict__ prev,
                                    float thr, int B,
                                    int32_t* __restrict__ dist,
                                    int32_t* __restrict__ desc) {
  const int cand = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (cand >= B) return;  // uniform across the warp: ballots stay full

  const int x0 = min(max(tl[2 * cand], 0), W - kBlock);
  const int y0 = min(max(tl[2 * cand + 1], 0), H - kBlock);
  const uint8_t* base = img + static_cast<size_t>(y0) * W + x0;

  const float sum = static_cast<float>(base[7 * W + 7]) +
                    static_cast<float>(base[7 * W + 8]) +
                    static_cast<float>(base[8 * W + 7]) +
                    static_cast<float>(base[8 * W + 8]);
  const float center = floorf(sum * 0.25f);
  const float lo = center - thr;
  const float hi = center + thr;

  const int col = lane & 15;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int row = 2 * w + (lane >> 4);
    const float px = static_cast<float>(base[row * W + col]);
    const unsigned word = __ballot_sync(0xffffffffu, (px < lo) || (px > hi));
    if (lane == w) desc[cand * kWords + w] = static_cast<int32_t>(word);
    total += __popc(word ^ static_cast<unsigned>(prev[cand * kWords + w]));
  }
  if (lane == 0) dist[cand] = total;
}

}  // namespace

// Plain C entry point (bound with ctypes). All tensors are contiguous and on
// the current device; `stream` is a cudaStream_t. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int score_blocks_launch(const void* img, int H, int W,
                                   const void* tl, const void* prev, float thr,
                                   int B, void* dist, void* desc,
                                   void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  score_blocks_kernel<<<grid, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W,
      static_cast<const int32_t*>(tl), static_cast<const int32_t*>(prev), thr,
      B, static_cast<int32_t*>(dist), static_cast<int32_t*>(desc));
  return static_cast<int>(cudaGetLastError());
}
