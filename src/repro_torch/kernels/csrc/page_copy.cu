// Whole-page moves between a device pool and its pinned host tier: the
// data plane of the serving engine's spill and restore
// (kernels/page_copy.py).
//
// Replaces no TPU kernel: JAX's repro/serving/pager.py:copy_pages is a jnp
// gather and scatter that XLA keeps on the device.  Here the host tier is
// pinned host memory and the (src, dst) page ids are computed on the
// device, so one launch a pool reads the id pairs from device memory,
// skips the sentinels (an id at or past the pool's real page count), and
// copies whole pages through the pinned pool's UVA device address.
//
// Bound by bytes: by the host link (PCIe) where one side is pinned, by
// device memory where both are on the card.  Design: a block per (page
// pair, stack, slice of the page), so every page of every layer slab is in
// flight at once and a sentinel pair costs one id load; each thread moves
// vectors of the widest width (16, 8, 4, 2 or 1 bytes) that the page size
// and both base addresses allow, kUnroll of them loaded before the first
// store.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxSlices = 4096;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    page_copy_kernel(const V* __restrict__ src, V* __restrict__ dst,
                     const long long* __restrict__ src_ids,
                     const long long* __restrict__ dst_ids, long long n_src,
                     long long n_dst, long long page_vecs,
                     long long src_stack_vecs, long long dst_stack_vecs) {
  const long long a = src_ids[blockIdx.y];
  const long long b = dst_ids[blockIdx.y];
  if (a < 0 || a >= n_src || b < 0 || b >= n_dst) return;
  const V* sp = src + (long long)blockIdx.z * src_stack_vecs + a * page_vecs;
  V* dp = dst + (long long)blockIdx.z * dst_stack_vecs + b * page_vecs;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v0 = (long long)blockIdx.x * kThreads + threadIdx.x;
       v0 < page_vecs; v0 += step * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * step;
      if (v < page_vecs) buf[u] = sp[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * step;
      if (v < page_vecs) dp[v] = buf[u];
    }
  }
}

// the address the device reads p through: device memory as it is, pinned
// host memory through its mapped pointer; NULL for pageable memory
char* device_address(const void* p) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess) {
    cudaGetLastError();  // clear the sticky-free error of the query
    return nullptr;
  }
  if (attr.type == cudaMemoryTypeDevice || attr.type == cudaMemoryTypeManaged)
    return static_cast<char*>(const_cast<void*>(p));
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return nullptr;
  // the mapped address of p itself, whether the query reported the
  // allocation's base or p's own address (under UVA the two coincide)
  const char* host = static_cast<const char*>(attr.hostPointer);
  char* dev = static_cast<char*>(attr.devicePointer);
  return host ? dev + (static_cast<const char*>(p) - host) : dev;
}

template <typename V>
cudaError_t launch(const char* src, char* dst, const long long* src_ids,
                   const long long* dst_ids, long long n_pairs,
                   long long stacks, long long page_bytes, long long n_src,
                   long long n_dst, long long src_stack_bytes,
                   long long dst_stack_bytes, cudaStream_t s) {
  const long long w = sizeof(V);
  const long long page_vecs = page_bytes / w;
  long long slices = (page_vecs + (long long)kThreads * kUnroll - 1) /
                     ((long long)kThreads * kUnroll);
  if (slices > kMaxSlices) slices = kMaxSlices;
  const dim3 grid((unsigned)slices, (unsigned)n_pairs, (unsigned)stacks);
  page_copy_kernel<V><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const V*>(src), reinterpret_cast<V*>(dst), src_ids,
      dst_ids, n_src, n_dst, page_vecs, src_stack_bytes / w,
      dst_stack_bytes / w);
  return cudaGetLastError();
}

}  // namespace

// src, dst (pool bases: device memory or pinned host memory), src_ids,
// dst_ids (int64 on the device), n_pairs, stacks, page_bytes, n_src, n_dst
// (real pages of each pool), src_stack_bytes, dst_stack_bytes, stream
extern "C" int repro_page_copy(const void* src, void* dst,
                               const void* src_ids, const void* dst_ids,
                               long long n_pairs, long long stacks,
                               long long page_bytes, long long n_src,
                               long long n_dst, long long src_stack_bytes,
                               long long dst_stack_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pairs < 1 || n_pairs > 65535 || stacks < 1 || stacks > 65535 ||
      page_bytes < 1)
    return (int)cudaErrorInvalidValue;
  const char* sp = device_address(src);
  char* dp = device_address(dst);
  if (sp == nullptr || dp == nullptr) return (int)cudaErrorInvalidHostPointer;
  const auto* si = static_cast<const long long*>(src_ids);
  const auto* di = static_cast<const long long*>(dst_ids);
  // the widest vector every page start of both pools is aligned to
  const unsigned long long align = (unsigned long long)page_bytes |
                                   (unsigned long long)(uintptr_t)sp |
                                   (unsigned long long)(uintptr_t)dp | 16ull;
  const unsigned long long w = align & (~align + 1);  // lowest set bit
  if (w >= 16)
    return (int)launch<uint4>(sp, dp, si, di, n_pairs, stacks, page_bytes,
                              n_src, n_dst, src_stack_bytes, dst_stack_bytes,
                              s);
  if (w == 8)
    return (int)launch<uint2>(sp, dp, si, di, n_pairs, stacks, page_bytes,
                              n_src, n_dst, src_stack_bytes, dst_stack_bytes,
                              s);
  if (w == 4)
    return (int)launch<uint32_t>(sp, dp, si, di, n_pairs, stacks, page_bytes,
                                 n_src, n_dst, src_stack_bytes,
                                 dst_stack_bytes, s);
  if (w == 2)
    return (int)launch<uint16_t>(sp, dp, si, di, n_pairs, stacks, page_bytes,
                                 n_src, n_dst, src_stack_bytes,
                                 dst_stack_bytes, s);
  return (int)launch<uint8_t>(sp, dp, si, di, n_pairs, stacks, page_bytes,
                              n_src, n_dst, src_stack_bytes, dst_stack_bytes,
                              s);
}
