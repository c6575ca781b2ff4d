// score_blocks and score_candidates: EXPRESS descriptors of 16x16 blocks of
// one u8 image and their Hamming distances, for Hopper (sm_90a).
//
// Both replace the Pallas TPU kernel movslam_tpu/ops/pallas_kernels.py::
// score_blocks (body _score_kernel). The TPU version DMAs a 64-row band per
// block into VMEM and selects the block with one-hot matmuls, because a TPU
// cannot slice lanes at a dynamic offset. A GPU loads at any address.
//
//   score_blocks      B independent candidates (the TPU kernel's contract).
//   score_candidates  the whole per-track scoring step of the MV
//                     propagation (ops/propagate.py): for each track, its 4
//                     MV candidates' positions, bounds tests, descriptors,
//                     distances and the best-of-4 choice, in one launch.
//
// Layout, shared by both: one warp serves 4 candidate blocks. Lane l works
// on candidate l/8 and descriptor word w = l%8, which is pixel rows 2w
// (bits 0-15) and 2w+1 (bits 16-31): the pack_bits order of
// ops/bitdesc.py. A lane reads each of its two 16-pixel rows as 4 or 5
// aligned 32-bit words and funnel-shifts them into place (10 loads a lane,
// against 32 single-byte loads), then classifies 4 pixels at a time with
// byte-SIMD compares. The distance is __popc of the XOR with the previous
// descriptor's word, summed over the candidate's 8 lanes by shuffles.
// In score_candidates the warp is one track: it reads the track's previous
// descriptor once (no repeat_interleave), chooses among its 4 candidates
// with shuffles, and only the chosen candidate's lanes write its 32 bytes.
//
// Streams: score_candidates also scores S streams in one launch (the
// reference's jax.vmap of the propagation over streams,
// movslam_tpu/parallel/multistream.py). The images lie back to back, the
// tracks are S runs of n_per_img and the MV rows S runs of mv_per_img, and
// the candidate indices are global rows. Track n reads image n / n_per_img,
// and a slot without a candidate scores that stream's first MV row. With
// S = 1 (n_per_img >= N) this is the single-image kernel, bit for bit.
//
// What bounds it: at the main path's shapes (score_candidates: 2048 tracks,
// 4096 MVs, 480x640 image; score_blocks: 8192 blocks) the inputs and outputs
// are 0.57 MB and 0.93 MB, 0.17 us and 0.28 us at 3.35 TB/s, and the
// compares and popcounts are a few million integer operations. Each warp's
// work is a chain of dependent loads (candidate index -> MV -> block
// pixels) with little to overlap, so latency and launch cost bound it, not
// bandwidth or arithmetic.
//
// Semantics (bit-exact with ops/kernels.py::score_blocks_ref and
// ::score_candidates_ref): top-left clamped to [0, W-16] x [0, H-16];
// center = floor(mean of the central 2x2); bit set where px < center - thr
// or px > center + thr, with center - thr and center + thr rounded to f32
// (__fsub_rn/__fadd_rn: no contraction) as the plain version does. For an
// integer px, px < lo holds exactly when px <= ceil(lo) - 1, and px > hi
// exactly when px > floor(hi), so the f32 compares become byte compares.
//
// Image reads: the image must start on a 4-byte boundary. A lane reads
// whole aligned words around its 16 pixels; an aligned word that holds a
// byte of the image lies on the same page as that byte, and the bytes it
// holds beyond the block are shifted out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kWords = 8;
constexpr int kCand = 4;  // candidates per warp, 8 lanes each
constexpr int kWarpsPerBlock = 8;
constexpr int kNoScore = 10000;  // score of an unusable candidate
constexpr unsigned kFull = 0xffffffffu;

// 16 consecutive bytes from p (any alignment) as 4 little-endian words.
__device__ __forceinline__ void load_row16(const uint8_t* p, uint32_t out[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned o = static_cast<unsigned>(a & 3u);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a - o);
  const uint32_t u0 = __ldg(w), u1 = __ldg(w + 1), u2 = __ldg(w + 2),
                 u3 = __ldg(w + 3);
  const uint32_t u4 = o ? __ldg(w + 4) : 0u;  // only when the row straddles 5 words
  const unsigned s = 8u * o;
  out[0] = __funnelshift_r(u0, u1, s);
  out[1] = __funnelshift_r(u1, u2, s);
  out[2] = __funnelshift_r(u2, u3, s);
  out[3] = __funnelshift_r(u3, u4, s);
}

// 4 extreme bits of the 4 pixels in x: bit k set where byte k <= le or
// byte k > gt. le in [-1, 255] (-1: none); gt in [-1, 255] (-1: all).
__device__ __forceinline__ uint32_t extreme4(uint32_t x, int le, int gt) {
  const uint32_t lt = le < 0 ? 0u : __vcmpleu4(x, 0x01010101u * static_cast<uint32_t>(le));
  const uint32_t hi = gt < 0 ? kFull : __vcmpgtu4(x, 0x01010101u * static_cast<uint32_t>(gt));
  const uint32_t m = (lt | hi) & 0x01010101u;  // one flag at bit 0 of each byte
  return (m * 0x01020408u) >> 24;              // byte k's flag -> bit k
}

// Descriptor word w (rows 2w, 2w+1) of the 16x16 block whose top-left is
// (tlx, tly) before clamping. The one descriptor routine of this file.
__device__ __forceinline__ uint32_t descriptor_word(const uint8_t* __restrict__ img,
                                                    int H, int W, int tlx, int tly,
                                                    float thr, int w) {
  const int x0 = min(max(tlx, 0), W - kBlock);
  const int y0 = min(max(tly, 0), H - kBlock);
  const uint8_t* base = img + static_cast<size_t>(y0) * W + x0;
  const int sum = base[7 * W + 7] + base[7 * W + 8] + base[8 * W + 7] + base[8 * W + 8];
  const float center = static_cast<float>(sum >> 2);  // floor of the mean
  const float lo = __fsub_rn(center, thr);
  const float hi = __fadd_rn(center, thr);
  const int le = static_cast<int>(fmaxf(fminf(ceilf(lo) - 1.0f, 255.0f), -1.0f));
  const int gt = static_cast<int>(fmaxf(fminf(floorf(hi), 255.0f), -1.0f));

  uint32_t r0[4], r1[4];
  load_row16(base + (2 * w) * W, r0);
  load_row16(base + (2 * w + 1) * W, r1);
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    word |= extreme4(r0[k], le, gt) << (4 * k);
    word |= extreme4(r1[k], le, gt) << (16 + 4 * k);
  }
  return word;
}

// Sum over the 8 lanes of one candidate (lanes 8c..8c+7).
__device__ __forceinline__ int sum8(int v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 4);
  return v;
}

__global__ void score_blocks_kernel(const uint8_t* __restrict__ img, int H, int W,
                                    const int32_t* __restrict__ tl,
                                    const int32_t* __restrict__ prev, float thr, int B,
                                    int32_t* __restrict__ dist,
                                    int32_t* __restrict__ desc) {
  const int first = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kCand;
  if (first >= B) return;  // uniform across the warp: shuffles stay full
  const int lane = threadIdx.x & 31;
  const int w = lane & 7;
  const int c = first + (lane >> 3);
  const bool live = c < B;
  const int cs = live ? c : B - 1;  // tail lanes recompute the last block

  const uint32_t word = descriptor_word(img, H, W, tl[2 * cs], tl[2 * cs + 1], thr, w);
  const int d = sum8(__popc(word ^ static_cast<uint32_t>(prev[cs * kWords + w])));
  if (live) {
    desc[c * kWords + w] = static_cast<int32_t>(word);
    if (w == 0) dist[c] = d;
  }
}

__global__ void score_candidates_kernel(
    const uint8_t* __restrict__ img, int H, int W, const float* __restrict__ prev_pt,
    const int32_t* __restrict__ cand, const float* __restrict__ mv_delta, int mv_stride,
    const float* __restrict__ prev_wh, const int32_t* __restrict__ prev_desc, float thr,
    int N, int n_per_img, int mv_per_img, int32_t* __restrict__ out_desc,
    int32_t* __restrict__ out_dist, int32_t* __restrict__ out_mv, float* __restrict__ out_pt,
    bool* __restrict__ out_inb) {
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int j = lane >> 3;  // candidate slot
  const int w = lane & 7;   // descriptor word
  const int s = n / n_per_img;  // stream
  img += static_cast<size_t>(s) * H * W;

  // Candidate position: one f32 add, as prev_pt + mv_delta[row]. A slot
  // without a candidate (-1) scores its stream's first row, like the plain
  // version.
  const int mv = cand[n * kCand + j];
  const int row = mv >= 0 ? mv : s * mv_per_img;
  const float* delta = mv_delta + static_cast<size_t>(row) * mv_stride;
  const float px = __fadd_rn(prev_pt[2 * n], delta[0]);
  const float py = __fadd_rn(prev_pt[2 * n + 1], delta[1]);

  // The in-bounds test of _block_inbounds: floor(pt) - (int)(wh / 2) >= 0 and
  // that + (int)wh < dim, strict.
  const float ww = prev_wh[2 * n], wh = prev_wh[2 * n + 1];
  const int bx = __float2int_rd(px) - __float2int_rz(__fmul_rn(ww, 0.5f));
  const int by = __float2int_rd(py) - __float2int_rz(__fmul_rn(wh, 0.5f));
  const bool inb = bx >= 0 && by >= 0 && bx + __float2int_rz(ww) < W &&
                   by + __float2int_rz(wh) < H;

  // The block's top-left truncates toward zero, as .to(torch.int32) does.
  const uint32_t word = descriptor_word(img, H, W, __float2int_rz(px) - kBlock / 2,
                                        __float2int_rz(py) - kBlock / 2, thr, w);
  const int d = sum8(__popc(word ^ static_cast<uint32_t>(prev_desc[n * kWords + w])));

  // Best of 4: the first usable minimum; slot 0 unless the track has a
  // second candidate and the best scores strictly below 256.
  const int score = (mv >= 0 && inb) ? d : kNoScore;
  int best = __shfl_sync(kFull, score, 0), best_j = 0;
#pragma unroll
  for (int k = 1; k < kCand; ++k) {
    const int s = __shfl_sync(kFull, score, 8 * k);
    if (s < best) {
      best = s;
      best_j = k;
    }
  }
  const int second = __shfl_sync(kFull, mv, 8);
  const int chosen = (second >= 0 && best < 256) ? best_j : 0;
  if (j != chosen) return;
  out_desc[n * kWords + w] = static_cast<int32_t>(word);
  if (w == 0) {
    out_dist[n] = d;
    out_mv[n] = mv;
    out_pt[2 * n] = px;
    out_pt[2 * n + 1] = py;
    out_inb[n] = inb;
  }
}

int grid_for(int warps) { return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

// Plain C entry points (bound with ctypes). Tensors are on the current
// device, contiguous (mv_delta: rows `mv_stride` floats apart); `stream` is
// a cudaStream_t. score_candidates_launch takes N tracks in runs of
// n_per_img per image (N for one image) and MV rows in runs of mv_per_img.
// Each returns cudaGetLastError() after its launch.
extern "C" int score_blocks_launch(const void* img, int H, int W, const void* tl,
                                   const void* prev, float thr, int B, void* dist,
                                   void* desc, void* stream) {
  if (B <= 0) return 0;
  score_blocks_kernel<<<grid_for((B + kCand - 1) / kCand), kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, static_cast<const int32_t*>(tl),
      static_cast<const int32_t*>(prev), thr, B, static_cast<int32_t*>(dist),
      static_cast<int32_t*>(desc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int score_candidates_launch(const void* img, int H, int W, const void* prev_pt,
                                       const void* cand, const void* mv_delta,
                                       int mv_stride, const void* prev_wh,
                                       const void* prev_desc, float thr, int N,
                                       int n_per_img, int mv_per_img, void* desc,
                                       void* dist, void* mv, void* pt, void* inb,
                                       void* stream) {
  if (N <= 0 || n_per_img <= 0) return 0;
  score_candidates_kernel<<<grid_for(N), kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, static_cast<const float*>(prev_pt),
      static_cast<const int32_t*>(cand), static_cast<const float*>(mv_delta), mv_stride,
      static_cast<const float*>(prev_wh), static_cast<const int32_t*>(prev_desc), thr, N,
      n_per_img, mv_per_img, static_cast<int32_t*>(desc), static_cast<int32_t*>(dist), static_cast<int32_t*>(mv),
      static_cast<float*>(pt), static_cast<bool*>(inb));
  return static_cast<int>(cudaGetLastError());
}
