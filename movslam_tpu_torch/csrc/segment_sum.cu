// segment_sum: an ordered, deterministic f32 segment sum for Hopper (sm_90a).
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
// Layout: one thread per (segment, column). Neighbouring threads take
// neighbouring columns of the same row, so the reads of a row and the
// write of a segment are coalesced, and the C threads of a segment read
// the same perm entry. A thread loads its segment's rows 16 at a time and
// then adds them in order: the loads overlap, the additions stay one
// sequential chain. It writes every segment, empty ones too (as +0), so no
// zero fill is launched before it.
//
// What bounds it: bytes. Each kept row of x is read once (C floats) with
// its perm entry, and each output written once; the adds are one per
// element read. A segment's chain is serial, so a segment with many rows
// makes the kernel latency-bound on that chain; the plans keep padding out
// of the segments for that reason.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // rows loaded before they are added

__global__ void segment_sum_kernel(const float* __restrict__ x, int C,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ offsets, int n,
                                   float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(n) * C) return;
  const int s = static_cast<int>(t / C);
  const int c = static_cast<int>(t - static_cast<int64_t>(s) * C);
  const int end = __ldg(offsets + s + 1);
  int r = __ldg(offsets + s);
  float acc = 0.0f;
  float v[kChunk];
  for (; r + kChunk <= end; r += kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      v[k] = __ldg(x + static_cast<int64_t>(__ldg(perm + r + k)) * C + c);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; r < end; ++r)
    acc = __fadd_rn(acc, __ldg(x + static_cast<int64_t>(__ldg(perm + r)) * C + c));
  out[t] = acc;
}

}  // namespace

extern "C" int segment_sum_launch(const void* x, int C, const void* perm,
                                  const void* offsets, int n, void* out,
                                  void* stream) {
  const int64_t total = static_cast<int64_t>(n) * C;
  if (total <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  segment_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), C, static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(offsets), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
