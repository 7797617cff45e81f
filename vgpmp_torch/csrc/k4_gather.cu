// K4: table gather, out[i] = table[idx[i]], for 4-byte and 8-byte entries.
//
// Replaces the Pallas kernel of tools/gather_bench.py:bench_pallas (the
// `kernel` closure and its pl.pallas_call), which gathers uint32 values from
// a table held whole in the TPU's on-chip vector memory, one program per
// 1024 points. The 8-byte width is the [ncells, 2] row that the packed SDF
// lookup gathers (tools/gather_bench.py:bench_xla `row`, and K1's inner
// step). The plain PyTorch version is vgpmp_torch/ops/gather.py:gather_plain.
//
// It computes what the TPU kernel computes and is not carried over block by
// block. A block's 227 KB of shared memory hold 58 K words, fewer than the
// smallest benchmark table (262 144), so there is no on-chip copy of the
// table to gather from: tables of 1 MB and 4 MB stay resident in the 50 MB L2
// after the first touch, and a table larger than the L2 (the 111 MB and
// 222 MB industrial scene) is gathered from device memory.
//
// What bounds it on an H100: one 32-byte sector a point. The L2's rate for
// scattered sectors where the table fits in it, the device memory's rate for
// scattered sectors where it does not; the index and output streams are a
// fifth of the bytes. The instructions around a gather do not bind, and the
// threads in flight do: four or two points a thread behind one 16-byte or
// 8-byte index load, with 16-byte stores and a grid of the resident blocks
// striding over the points, measured slower at the L2-resident tables and no
// faster at the largest (PERF.md), so each thread takes one point.
//
// Design: one thread per point, neighbouring threads on neighbouring indices
// and outputs (coalesced streams), the table read through the read-only path
// (__ldg) with the entry width as a template parameter. The index and output
// streams are read and written evict-first (__ldcs/__stcs), so that they
// leave the L2 to the table. Any point count and any alignment of idx (a view
// such as idx[1:]) is taken as it is. An index outside the table is clamped
// to it, as jnp.take clamps.

#include <cuda_runtime.h>

#include "kernels.h"

namespace {

template <typename W>
__global__ void __launch_bounds__(256) gather_kernel(const W* __restrict__ table,
                                                     const int32_t* __restrict__ idx,
                                                     W* __restrict__ out, long long n,
                                                     long long ncells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long j = __ldcs(idx + i);
  j = j < 0 ? 0 : (j >= ncells ? ncells - 1 : j);
  __stcs(out + i, __ldg(table + j));
}

}  // namespace

cudaError_t k4_gather_launch(const void* table, const int32_t* idx, void* out, int64_t n,
                             int64_t ncells, int entry_bytes, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  if (ncells <= 0) return cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((unsigned)((n + block.x - 1) / block.x));
  if (entry_bytes == 4)
    gather_kernel<uint32_t><<<grid, block, 0, st>>>((const uint32_t*)table, idx, (uint32_t*)out, n, ncells);
  else if (entry_bytes == 8)
    gather_kernel<uint2><<<grid, block, 0, st>>>((const uint2*)table, idx, (uint2*)out, n, ncells);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
