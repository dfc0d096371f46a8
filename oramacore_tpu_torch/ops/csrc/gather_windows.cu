// Posting-window gather for NVIDIA Hopper (sm_90a).
//
// Replaces oramacore_tpu/ops/pallas_gather.py::gather_windows, the Pallas
// kernel that copies NS windows src[s : s + w] of a 1-D slab into an
// (NS, w) output with double-buffered HBM -> VMEM DMAs (one window in
// flight while the previous one is waited on).
//
// What bounds it: device-memory bytes. A call reads NS * w * 4 bytes and
// writes as many, with no arithmetic (NS=4096, w=1024: 16 MiB each way).
//
// What the design does about it: every thread moves one 16-byte chunk
// (four 4-byte words) with one vector load and one vector store, and
// neighbouring threads take neighbouring chunks, so a warp reads and
// writes 512 contiguous bytes. grid.x walks the windows, grid.y the
// 1024-word slices of a window (blocks of 256 threads). Nothing is staged
// in shared memory: a straight copy gains nothing from it, and the many
// resident blocks keep enough loads in flight to take the place of the
// TPU kernel's explicit double buffering.
//
// A copy does not care about the element type, so int32 and float32
// slabs share the kernel on 32-bit words. Starts that are multiples of
// 1024 (the TPU contract) make every chunk 16-byte aligned once the slab
// is; a chunk whose start is not a multiple of 4 words, or that crosses
// either end of the slab, is copied word by word and reads 0 outside
// [0, n).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kVec = 4;  // 4-byte words per 16-byte chunk
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* src,
                                                 int64_t n, int64_t p) {
  return (p >= 0 && p < n) ? src[p] : 0u;
}

__global__ void gather_windows_kernel(
    const uint32_t* __restrict__ src,     // [n]
    int64_t n,
    const int32_t* __restrict__ starts,   // [ns]
    int64_t w,                            // multiple of 4
    uint32_t* __restrict__ out) {         // [ns, w], 16-byte aligned
  const int64_t row = blockIdx.x;
  const int64_t e = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * kVec;
  if (e >= w) return;
  const int64_t p = (int64_t)starts[row] + e;
  uint4* dst = reinterpret_cast<uint4*>(out + row * w + e);
  if (p >= 0 && p + kVec <= n && (p & (kVec - 1)) == 0) {
    *dst = __ldg(reinterpret_cast<const uint4*>(src + p));
  } else {
    uint4 v;
    v.x = word_or_zero(src, n, p);
    v.y = word_or_zero(src, n, p + 1);
    v.z = word_or_zero(src, n, p + 2);
    v.w = word_or_zero(src, n, p + 3);
    *dst = v;
  }
}

}  // namespace

// Enqueues on `stream` and returns cudaGetLastError() (0 on success); a
// refused launch never runs, so the caller must check it. The caller
// guarantees w % 4 == 0 and 16-byte aligned `src` and `out`.
extern "C" int gather_windows_launch(
    const void* src, int64_t n, const void* starts, int64_t ns, int64_t w,
    void* out, void* stream) {
  if (ns <= 0 || w <= 0) return 0;
  const int64_t per_block = kThreads * kVec;
  const int64_t slices = (w + per_block - 1) / per_block;
  if (ns > kMaxGridX || slices > kMaxGridY) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)ns, (unsigned)slices);
  gather_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, n, (const int32_t*)starts, w, (uint32_t*)out);
  return (int)cudaGetLastError();
}
