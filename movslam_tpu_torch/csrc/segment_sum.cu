// segment_sums: ordered, deterministic f32 segment sums for Hopper (sm_90a),
// up to four of them in one launch.
//
// Not the port of a TPU kernel: the JAX package sums bundle-adjustment
// blocks with jax.ops.segment_sum, which XLA lowers on the TPU in a fixed
// order. On the card PyTorch's index_add_ is float atomicAdd, whose order
// changes from run to run, so the port's BA results did too. This kernel
// gives the sums one fixed order: the one CPU index_add_ takes.
//
//   out[s, c] = sum of x[i, c] over the rows i with idx[i] == s, taken in
//               increasing i, as one sequential f32 sum starting from +0.
//
// The plan (ops/kernels.py::segment_plan) lists the rows by segment: perm
// holds the row indices, stable-sorted by segment, and offsets[s] ..
// offsets[s + 1] is segment s's run of perm. A plan may leave rows out
// (they sort past offsets[n]); the BA leaves out padding rows, whose
// contributions are zeros, so its sums still equal index_add_ over every
// row: adding a zero to a running sum that starts at +0 changes no bit.
//
// A group: one launch sums up to kMaxJobs (x, plan) jobs, which may differ
// in plan, segment count and columns C. The job table is a kernel
// parameter passed by value (pointers, C, n, tile sizes, each job's first
// block): no copy to the device per call. Grouping changes no bit: every
// output element is still its own sequential chain.
//
// Layout: a block takes a tile of G consecutive segments of one job,
// [s0, s0 + G). Their rows are one contiguous run of perm, offsets[s0] ..
// offsets[s0 + G]. A job runs in one of two modes:
//
// Staged (segments of many rows on average: by keyframe, the Schur pair
// scatter). The block walks the tile's run in chunks of T rows:
//   1. all its threads copy the chunk's perm entries, then the rows
//      x[perm[r]] (C floats each, 16, 8 or 4 bytes a copy as C and the
//      alignment allow) into shared memory with cp.async, every row of
//      the chunk in flight at once;
//   2. the thread that owns output (g, c) adds its segment's rows of the
//      chunk, in row order, with __fadd_rn, to its accumulator, which
//      lives in shared memory from one chunk to the next and starts at +0;
//   3. after the last chunk the block writes its G x C outputs, empty
//      segments too (as +0), with 16-byte stores: no zero fill is launched.
// Direct (at most kDirectRows rows a segment on average: by point, the
// pose graph). G x C <= kThreads: the thread of output (g, c) reads its
// rows straight from x through perm, kDirectLoads in flight, adds them in
// row order from +0 and writes its output; no shared memory, no barrier.
// Both modes are one kernel, since a group mixes them, so they share its
// register count: the direct loop is sized to keep it at 32, 8 blocks of
// 256 threads an SM, which the many-tile staged jobs need.
//
// What bounds it: bytes, on every plan the BA makes (bound_ms in
// chip_smoke.py), but at the BA's sizes a launch is a few round trips to
// memory. Each kept row of x is read once (C floats) with its perm entry,
// the offsets once, and each output written once; the adds are one per
// element read. A segment's chain is serial: where a job has few long
// segments (by keyframe: 48 segments of ~240 rows) each chunk costs two
// round trips, so the tile is one segment and the chunk large (one chunk
// a segment, mostly); the whole block loads what C threads add. Where it
// has many short or empty segments the tiles hold many segments, so a
// block's round trips serve G x C outputs and its stores are long runs;
// the chunk then shrinks with the job's tiles per SM, for more blocks on
// each SM. Staged tiles take the direct mode's place where segments are
// long, because a thread that walks ~240 rows itself makes ~30 dependent
// trips to memory (a kernel of one thread per output did: 13.5 us at 48
// segments x 6 columns on an H100).
//
// The tile sizes come from shapes alone (n, C, and perm's length R, an
// upper bound on the kept rows): the host never reads offsets[n], which
// lives on the device. The constants were chosen on an H100 SXM by timing
// variants at chip_smoke.py phase 2's shapes (PERF.md, Findings).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 4;
constexpr int kSMs = 132;                 // H100 SXM
constexpr int kMinTiles = 2 * kSMs;       // tiles a job should have, where n allows
constexpr int kFewTiles = 2 * kSMs;       // at most this many tiles: few, large chunks
constexpr int kTileRows = 256;            // rows a tile is sized for, by R / n
constexpr int kAccFloats = 4096;          // accumulators a block, at most (16 KB)
constexpr int kChunkFloats = 4096;        // x floats a chunk, at least (16 KB)
constexpr int kChunkFloatsFew = 16384;    // x floats a chunk, at most (64 KB)
constexpr int kSmFloats = 70000;          // x floats a chunk, times the job's tiles an SM runs
constexpr int kMinRows = 32;              // least rows a chunk, many tiles
constexpr int kFewRows = 512;             // least rows a chunk, few tiles
constexpr int kMaxSmem = 232448;          // bytes of shared memory a block may use
constexpr int kDirectRows = 6;            // at most this many rows a segment (R / n): direct
constexpr int kDirectLoads = 4;           // rows in flight a thread, direct (32 registers)

struct Job {
  const float* x;
  const int32_t* perm;
  const int32_t* offsets;
  float* out;
  int C;      // columns summed
  int n;      // segments
  int G;      // segments a tile
  int T;      // rows a chunk
  int vec;    // floats a cp.async: 4, 2 or 1
  int direct; // 1: one output a thread, rows read straight from x (no T)
  int first;  // the job's first block
};

struct Jobs {
  Job job[kMaxJobs];
  int count;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Shared memory of one job's block, in 4-byte words: the chunk's rows, the
// accumulators, the chunk's perm entries and the tile's offsets.
__host__ __device__ constexpr int smem_words(int C, int G, int T) {
  return round4(T * C) + round4(G * C) + T + G + 1;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (vec == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const __grid_constant__ Jobs jobs) {
  extern __shared__ __align__(16) float smem[];
  int j = 0;
#pragma unroll
  for (int k = 1; k < kMaxJobs; ++k)
    if (k < jobs.count && static_cast<int>(blockIdx.x) >= jobs.job[k].first) j = k;
  const Job& job = jobs.job[j];
  const int C = job.C, G = job.G, T = job.T, vec = job.vec;
  const int t = threadIdx.x;
  const int s0 = (static_cast<int>(blockIdx.x) - job.first) * G;
  const int g_n = min(G, job.n - s0);
  const int m = g_n * C;  // outputs of the tile

  if (job.direct) {
    // Short segments: the thread of output (g, c) reads its rows straight
    // from x, kDirectLoads in flight, and adds them in order; G * C <=
    // kThreads, so the tile is one pass and its stores are coalesced.
    if (t < m) {
      const int g = t / C, c = t - g * C;
      int r = __ldg(job.offsets + s0 + g);
      const int end = __ldg(job.offsets + s0 + g + 1);
      float a = 0.0f, v[kDirectLoads];
      // kDirectLoads rows a pass, all loaded before any is added. A pass
      // past the segment's end loads its last row again (never a row
      // outside it) and adds only its own rows; predicated loads instead
      // cost stack or registers, and the registers every block's occupancy.
      for (; r < end; r += kDirectLoads) {
#pragma unroll
        for (int k = 0; k < kDirectLoads; ++k)
          v[k] = __ldg(job.x + static_cast<int64_t>(__ldg(job.perm + min(r + k, end - 1))) * C + c);
#pragma unroll
        for (int k = 0; k < kDirectLoads; ++k)
          if (r + k < end) a = __fadd_rn(a, v[k]);
      }
      job.out[static_cast<int64_t>(s0) * C + t] = a;
    }
    return;
  }

  float* xs = smem;                                        // T x C
  float* acc = xs + round4(T * C);                         // g_n x C
  int32_t* perm_s = reinterpret_cast<int32_t*>(acc + round4(G * C));  // T
  int32_t* off_s = perm_s + T;                             // g_n + 1

  for (int i = t; i <= g_n; i += kThreads) off_s[i] = __ldg(job.offsets + s0 + i);
  for (int i = t; i < m; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int rb = off_s[0], re = off_s[g_n];
  const int per_row = C / vec;
  for (int r0 = rb; r0 < re; r0 += T) {
    const int rows = min(T, re - r0);
    for (int i = t; i < rows; i += kThreads) perm_s[i] = __ldg(job.perm + r0 + i);
    __syncthreads();
    for (int i = t; i < rows * per_row; i += kThreads) {
      const int row = i / per_row;
      const int col = (i - row * per_row) * vec;
      cp_async(xs + row * C + col, job.x + static_cast<int64_t>(perm_s[row]) * C + col, vec);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int e = t; e < m; e += kThreads) {
      const int g = e / C;
      const int lo = max(off_s[g], r0) - r0;
      const int hi = min(off_s[g + 1], r0 + rows) - r0;
      if (lo < hi) {
        const float* col = xs + (e - g * C);
        float a = acc[e];
#pragma unroll 8
        for (int r = lo; r < hi; ++r) a = __fadd_rn(a, col[r * C]);
        acc[e] = a;
      }
    }
    __syncthreads();
  }

  // The tile's outputs are one contiguous run of out; job.out is 16-byte
  // aligned, so after a head of at most 3 floats the run is float4 stores.
  float* out = job.out + static_cast<int64_t>(s0) * C;
  const int head = min(m, static_cast<int>((4 - ((static_cast<int64_t>(s0) * C) & 3)) & 3));
  if (t < head) out[t] = acc[t];
  const int body = (m - head) >> 2;
  float4* out4 = reinterpret_cast<float4*>(out + head);
  for (int i = t; i < body; i += kThreads) {
    const float* a = acc + head + 4 * i;
    out4[i] = make_float4(a[0], a[1], a[2], a[3]);
  }
  const int tail = head + 4 * body + t;
  if (tail < m) out[tail] = acc[tail];
}

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace

// Sum `count` jobs in one launch on `stream`. table holds 7 int64 per job:
// x, perm, offsets (device pointers), the job's output offset in floats
// from out (a multiple of 4; out is 16-byte aligned), C, n and R (the rows
// of x and perm). Jobs with n * C == 0 must be left out by the caller.
// Returns a cudaError_t (cudaErrorInvalidValue for a table the kernel
// cannot take).
extern "C" int segment_sums_launch(int count, const int64_t* table, void* out, void* stream) {
  if (count < 1 || count > kMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs{};
  jobs.count = count;
  int64_t blocks = 0;
  int smem = 0;
  for (int k = 0; k < count; ++k) {
    const int64_t* row = table + 7 * k;
    Job& job = jobs.job[k];
    job.x = reinterpret_cast<const float*>(row[0]);
    job.perm = reinterpret_cast<const int32_t*>(row[1]);
    job.offsets = reinterpret_cast<const int32_t*>(row[2]);
    job.out = static_cast<float*>(out) + row[3];
    if (row[4] < 1 || row[5] < 1 || row[6] < 0 || row[4] > INT32_MAX || row[5] > INT32_MAX ||
        row[6] > INT32_MAX || reinterpret_cast<uintptr_t>(job.out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int C = static_cast<int>(row[4]), n = static_cast<int>(row[5]), R = static_cast<int>(row[6]);
    const double avg = static_cast<double>(R) / n;  // mean rows a segment, at most
    job.direct = avg <= kDirectRows && C <= kThreads;
    int G = avg > 1.0 ? static_cast<int>(kTileRows / avg) : kTileRows;
    G = min(G, job.direct ? kThreads / C : kAccFloats / C);
    G = min(G, ceil_div(n, kMinTiles));
    G = max(G, 1);
    const int tiles = ceil_div(n, G);
    const bool few = tiles <= kFewTiles;
    const int floats = min(max(kSmFloats / ceil_div(tiles, kSMs), kChunkFloats), kChunkFloatsFew);
    const int cap = max(1, floats / C / 8 * 8);
    const int want = (static_cast<int>(std::min(G * avg, 1e9)) + 7) / 8 * 8;
    job.C = C;
    job.n = n;
    job.G = G;
    job.T = min(cap, max(want, few ? kFewRows : kMinRows));
    const uintptr_t xp = reinterpret_cast<uintptr_t>(job.x);
    job.vec = (C % 4 == 0 && xp % 16 == 0) ? 4 : (C % 2 == 0 && xp % 8 == 0) ? 2 : 1;
    job.first = static_cast<int>(blocks);
    blocks += tiles;
    if (!job.direct) smem = max(smem, 4 * smem_words(C, G, job.T));
  }
  if (smem > kMaxSmem || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // Above 48 KB a kernel must opt in: once per device, to the most a
    // block may use, so host threads that launch at once agree.
    static std::atomic<bool> granted[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!granted[dev].load()) {
      err = cudaFuncSetAttribute(segment_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev].store(true);
    }
  }
  segment_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}
