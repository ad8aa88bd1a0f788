// Container kernels of the PyTorch port, written by hand for Hopper (sm_90a).
//
// They replace the two Pallas kernels of the JAX package's ops/kernels.py:
//
//   decode_block_kernel      <- kernels.py decode_block (pallas_call at :245;
//                               helpers _container_tile, _tile_slots,
//                               _pad_payload)
//   fused_row_counts_kernel  <- kernels.py fused_row_counts (pallas_call at
//                               :326)
//
// Both read the packed array/bitmap/run container streams of ops/containers.py
// for S stacked shards at once: keys/types/counts/offsets int32[S, C] (keys
// sorted ascending, padding entries key -1 / type -1 at the end), payload
// uint32[S, P].  A container covers one 2048-word tile of the flat
// [rows, words] fragment; its key is the tile's index.
//
// What bounds them on an H100: memory.  decode_block writes S*rows*words*4
// dense bytes and reads only the compressed stream, so its bound is the dense
// bytes it writes at 3.35 TB/s.  fused_row_counts writes S*rows counts; it is
// bounded by the filter bytes it reads (S*words*4) plus the payload.
//
// What the design does about it:
//   * One block per (tile, shard) for the decode and one per (row, shard) for
//     the fused count; 256 threads, each owning 8 words of the 2048-word tile
//     at stride 256, so every load and store of a warp is one coalesced
//     128-byte line.  Blocks read their container's table entries from global
//     memory (an L2 hit after the first block of a shard); the TPU kernel's
//     whole-table VMEM residency (_full_block) does not fit shared memory.
//   * Container lookup is a binary search of the sorted key table by one
//     thread (the TPU kernel's _tile_slots scatter runs outside its kernel).
//   * Only the bytes a container's form needs are read: a bitmap tile copies
//     2048 payload words; an array container stores each (slot, value) entry
//     at tile[slot] in shared memory (slots are unique within a container, so
//     the TPU's [a_bucket, 2048] one-hot compare is not needed); a run
//     container stages its [start, end) pairs in shared memory and each thread
//     ORs the runs' masks into its own 8 words, so no atomics are needed.
//   * fused_row_counts never writes decoded words: each tile is ANDed with the
//     filter in registers, popcounted with __popc, and the block loops over
//     its row's tiles before one block reduction.  A TPU grid runs in order,
//     so its kernel accumulated a row's tiles into one output block across
//     grid steps; GPU blocks run in no order, so the loop over a row's tiles
//     lives inside one block instead.
//   * A shared-memory footprint of about 10 KB per block, independent of the
//     container buckets (the TPU's 12 MB VMEM budget rule does not apply).
//
// Plain C interface, loaded with ctypes by ops/kernels.py.  Each entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileWords = 2048;                   // CONTAINER_WORDS
constexpr int kThreads = 256;
constexpr int kWordsPerThread = kTileWords / kThreads;  // 8
constexpr int kRunChunk = kThreads;                // runs staged per pass
constexpr int kTypeArray = 0;
constexpr int kTypeBitmap = 1;
constexpr int kTypeRun = 2;

struct TileSmem {
  uint32_t tile[kTileWords];  // array-form scatter target
  uint32_t run_start[kRunChunk];
  uint32_t run_end[kRunChunk];
  int typ, cnt, off;
};

// Index of the container whose key equals `key`, or -1.  Valid keys are
// sorted ascending and followed by -1 padding, so "key in [0, target)" holds
// on a prefix of the table and a lower-bound search over it is exact.
__device__ int find_container(const int32_t* keys, int C, int key) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int k = keys[mid];
    if (k >= 0 && k < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < C && keys[lo] == key) ? lo : -1;
}

__device__ __forceinline__ uint32_t low_bits(int h) {
  return h >= 32 ? 0xFFFFFFFFu : ((1u << h) - 1u);
}

// x clamped to [0, 32]: the number of a word's bits below bit offset x.
__device__ __forceinline__ int clamp_bits(long long x) {
  return x < 0 ? 0 : (x > 32 ? 32 : (int)x);
}

__device__ __forceinline__ uint32_t pay_at(const uint32_t* pay, long long P,
                                           long long i) {
  return (i >= 0 && i < P) ? pay[i] : 0u;
}

// Decodes tile `key` of one shard's stream into v[] (thread t owns words
// t + i * kThreads).  Every branch is uniform across the block (the container
// header is shared), so the barriers inside are reached by all threads.
// Returns the container type, -1 when no container covers the tile.
__device__ int decode_tile(const int32_t* keys, const int32_t* types,
                           const int32_t* counts, const int32_t* offsets,
                           const uint32_t* pay, int C, long long P, int key,
                           TileSmem& sm, uint32_t v[kWordsPerThread]) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    const int ci = find_container(keys, C, key);
    sm.typ = ci >= 0 ? types[ci] : -1;
    sm.cnt = ci >= 0 ? counts[ci] : 0;
    sm.off = ci >= 0 ? offsets[ci] : 0;
  }
  __syncthreads();
  const int typ = sm.typ;
  const int cnt = sm.cnt;
  const long long off = sm.off;
  __syncthreads();  // header read by all before a later call rewrites it

#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) v[i] = 0u;

  if (typ == kTypeBitmap) {
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) {
      v[i] = pay_at(pay, P, off + tid + i * kThreads);
    }
  } else if (typ == kTypeArray) {
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) sm.tile[tid + i * kThreads] = 0u;
    __syncthreads();
    for (int e = tid; e < cnt; e += kThreads) {
      const uint32_t slot = pay_at(pay, P, off + e);
      const uint32_t val = pay_at(pay, P, off + cnt + e);
      if (slot < kTileWords) sm.tile[slot] = val;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) v[i] = sm.tile[tid + i * kThreads];
    __syncthreads();  // tile read by all before a later call rezeroes it
  } else if (typ == kTypeRun) {
    for (int base = 0; base < cnt; base += kRunChunk) {
      const int r = base + tid;
      if (r < cnt) {
        sm.run_start[tid] = pay_at(pay, P, off + 2LL * r);
        sm.run_end[tid] = pay_at(pay, P, off + 2LL * r + 1);
      }
      __syncthreads();
      const int nr = min(kRunChunk, cnt - base);
      for (int q = 0; q < nr; ++q) {
        const long long s = sm.run_start[q];
        const long long e = sm.run_end[q];
#pragma unroll
        for (int i = 0; i < kWordsPerThread; ++i) {
          const long long w0 = 32LL * (tid + i * kThreads);
          v[i] |= low_bits(clamp_bits(e - w0)) & ~low_bits(clamp_bits(s - w0));
        }
      }
      __syncthreads();  // runs read by all before the next chunk lands
    }
  }
  return typ;
}

__global__ void __launch_bounds__(kThreads)
decode_block_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ types,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ offsets,
                    const uint32_t* __restrict__ payload,
                    uint32_t* __restrict__ out, int C, long long P,
                    int tiles) {
  __shared__ TileSmem sm;
  const int t = blockIdx.x;
  const long long s = blockIdx.y;
  uint32_t v[kWordsPerThread];
  decode_tile(keys + s * C, types + s * C, counts + s * C, offsets + s * C,
              payload + s * P, C, P, t, sm, v);
  uint32_t* o = out + (s * tiles + t) * (long long)kTileWords;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) o[threadIdx.x + i * kThreads] = v[i];
}

__global__ void __launch_bounds__(kThreads)
fused_row_counts_kernel(const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ types,
                        const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ offsets,
                        const uint32_t* __restrict__ payload,
                        const uint32_t* __restrict__ filt,
                        int32_t* __restrict__ out, int C, long long P,
                        int rows, int tiles_per_row) {
  __shared__ TileSmem sm;
  __shared__ unsigned warp_sums[kThreads / 32];
  const int row = blockIdx.x;
  const long long s = blockIdx.y;
  const long long words = (long long)tiles_per_row * kTileWords;
  unsigned acc = 0;
  for (int j = 0; j < tiles_per_row; ++j) {
    uint32_t v[kWordsPerThread];
    const int typ = decode_tile(keys + s * C, types + s * C, counts + s * C,
                                offsets + s * C, payload + s * P, C, P,
                                row * tiles_per_row + j, sm, v);
    if (typ < 0) continue;  // empty tile: nothing to AND or count
    if (filt != nullptr) {
      const uint32_t* f = filt + s * words + (long long)j * kTileWords;
#pragma unroll
      for (int i = 0; i < kWordsPerThread; ++i) v[i] &= f[threadIdx.x + i * kThreads];
    }
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) acc += __popc(v[i]);
  }
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    out[s * rows + row] = (int32_t)total;
  }
}

}  // namespace

extern "C" int decode_block_launch(const void* keys, const void* types,
                                   const void* counts, const void* offsets,
                                   const void* payload, void* out, int S,
                                   int C, long long P, int tiles,
                                   void* stream) {
  const dim3 grid(tiles, S);
  decode_block_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)types, (const int32_t*)counts,
      (const int32_t*)offsets, (const uint32_t*)payload, (uint32_t*)out, C, P,
      tiles);
  return (int)cudaGetLastError();
}

extern "C" int fused_row_counts_launch(const void* keys, const void* types,
                                       const void* counts,
                                       const void* offsets,
                                       const void* payload, const void* filt,
                                       void* out, int S, int C, long long P,
                                       int rows, int tiles_per_row,
                                       void* stream) {
  const dim3 grid(rows, S);
  fused_row_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)types, (const int32_t*)counts,
      (const int32_t*)offsets, (const uint32_t*)payload,
      (const uint32_t*)filt, (int32_t*)out, C, P, rows, tiles_per_row);
  return (int)cudaGetLastError();
}
