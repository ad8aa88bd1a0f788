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
// Input: a ragged packed stack of S shards (ops/containers.py PackedStack).
//   slots    int32[S * tiles]  container index of each 2048-word tile, or -1
//                              (the JAX package's _tile_slots map, built on
//                              the host with the stack: no key search here)
//   types    int32[N]          array 0 / bitmap 1 / run 2
//   counts   int32[N]          array entries / bitmap words / runs
//   offsets  int64[N]          absolute payload word offset, a multiple of 4
//   payload  uint32[M]         every container's words at full size
// The shards' containers are laid end to end with no pow2 padding, so one
// launch covers every shard of a stack whatever its container count.  Tile
// t of shard s is words [t*2048, (t+1)*2048) of the flat [rows, words]
// fragment; with tpr = words / 2048 tiles per row, it is row t / tpr, tile
// column t % tpr.  A tile's header is its slot-map entry and three table
// entries; every thread that needs it reads the same addresses (a
// broadcast), so a header needs no barrier.
//
// decode_block_kernel.  Bound: the dense bytes it writes (S*rows*words*4) at
// 3.35 TB/s; it reads only the compressed stream.  Design: a persistent grid
// (as many 256-thread blocks as fit on the SMs) strides over the S*tiles
// tiles, with the slot of the tile after next and the header of the next
// tile in flight while a tile is written.  Thread i owns the 16-byte quads
// i and i+256 of its tile.
//   * bitmap: two 16-byte loads and two 16-byte stores a thread;
//   * empty (no container): two 16-byte zero stores;
//   * array: the block zeroes a shared-memory tile with 16-byte stores,
//     scatters each (slot, value) entry at tile[slot] (slots are unique in a
//     container, so the TPU's [a_bucket, 2048] one-hot compare is not
//     needed), and stores the tile with 16-byte stores;
//   * run: the same shared tile; warp w takes runs w, w+8, ... and its lanes
//     stride over the run's words, ORing each word's mask in with a shared
//     atomic (two disjoint runs may share an edge word).
// Array and run tiles take two barriers.  Each thread zeroes and reads back
// only its own quads of the shared tile, so consecutive tiles need no third.
//
// fused_row_counts_kernel.  Bound: the filter it reads once (S*words*4)
// plus the stack, at 3.35 TB/s; it writes S*rows counts and never the
// decoded words.  Design: one block per (shard s, tile column j).  Each
// thread issues its two 16-byte loads of filter tile j of shard s (all ones
// when there is no filter) and then looks up the headers, and the first 32
// array entries, of its warp's first kAhead rows while they land; the tile
// goes to shared memory once, behind one barrier.  Warp w then counts rows
// w, w+8, ... of the tile column:
//   * bitmap: sum of popc(payload & filter) over 16-byte loads;
//   * array: sum of popc(value & filter[slot]) over the entries, with no
//     decoded tile (slots are unique in a container);
//   * run: each lane takes whole runs; a run [s, e) adds below(e) - below(s),
//     where below(x) counts the filter's bits under bit x from a per-word
//     prefix popcount of the filter tile.  The block builds that prefix (a
//     scan, two more barriers) only when one of its rows is a run container,
//     so a run costs the same whatever its length.
// A warp reduces its sum and lane 0 adds it to out[s, row] with atomicAdd;
// the wrapper allocates out zeroed.  Integer addition is exact in any order,
// so the result is bit-exact against the plain version whatever order the
// atomics land in.  A TPU grid runs in order, so its kernel carried a row's
// sum across grid steps; here the blocks of one row meet only in the atomic.
//
// Shared memory is 8 KB (decode) and 16 KB (fused) a block whatever the
// containers (the TPU's 12 MB VMEM budget rule does not apply).  Plain C
// interface, loaded with ctypes by ops/kernels.py.  Each entry point
// launches on the given stream and returns the first CUDA error, or 0.

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileWords = 2048;                  // CONTAINER_WORDS
constexpr int kTileQuads = kTileWords / 4;        // 512 16-byte quads
constexpr uint32_t kTileBits = 32u * kTileWords;  // 65536
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 2;  // rows a warp looks up before the filter barrier
constexpr int kTypeArray = 0;
constexpr int kTypeBitmap = 1;
constexpr int kTypeRun = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Stack {
  const int32_t* slots;
  const int32_t* types;
  const int32_t* counts;
  const long long* offsets;
  const uint32_t* payload;
};

struct Header {
  int typ;        // -1: no container covers the tile
  int cnt;
  long long off;
};

__device__ __forceinline__ Header header_of(const Stack& st, int ci) {
  Header h{-1, 0, 0};
  if (ci >= 0) {
    h.typ = __ldg(st.types + ci);
    h.cnt = __ldg(st.counts + ci);
    h.off = __ldg(st.offsets + ci);
  }
  return h;
}

__device__ __forceinline__ int slot_of(const Stack& st, long long t,
                                       long long n_tiles) {
  return t < n_tiles ? __ldg(st.slots + t) : -1;
}

__device__ __forceinline__ uint32_t low_bits(int h) {
  return h <= 0 ? 0u : (h >= 32 ? kFull : ((1u << h) - 1u));
}

// A run's [s, e) pair, clamped to the tile's bits.
__device__ __forceinline__ void run_bounds(uint2 se, uint32_t& s,
                                           uint32_t& e) {
  s = se.x < kTileBits ? se.x : kTileBits;
  e = se.y < kTileBits ? se.y : kTileBits;
}

__device__ __forceinline__ unsigned popc4(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

__device__ __forceinline__ unsigned popc_and(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

__global__ void __launch_bounds__(kThreads)
decode_block_kernel(Stack st, uint4* __restrict__ out, long long n_tiles) {
  __shared__ uint4 tile[kTileQuads];
  uint32_t* tile_words = reinterpret_cast<uint32_t*>(tile);
  const int q0 = threadIdx.x;
  const int q1 = threadIdx.x + kThreads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long step = gridDim.x;
  long long t = blockIdx.x;
  Header h = header_of(st, slot_of(st, t, n_tiles));
  int next_ci = slot_of(st, t + step, n_tiles);
  for (; t < n_tiles; t += step) {
    const int after_ci = slot_of(st, t + 2 * step, n_tiles);
    const Header next = header_of(st, next_ci);
    uint4 v0 = zero, v1 = zero;
    if (h.typ == kTypeBitmap) {
      const uint4* p = reinterpret_cast<const uint4*>(st.payload + h.off);
      v0 = __ldg(p + q0);
      v1 = __ldg(p + q1);
    } else if (h.typ == kTypeArray || h.typ == kTypeRun) {
      tile[q0] = zero;
      tile[q1] = zero;
      __syncthreads();
      if (h.typ == kTypeArray) {
        const uint32_t* p = st.payload + h.off;
        for (int e = threadIdx.x; e < h.cnt; e += kThreads) {
          const uint32_t slot = __ldg(p + e);
          if (slot < kTileWords) tile_words[slot] = __ldg(p + h.cnt + e);
        }
      } else {
        const uint2* runs =
            reinterpret_cast<const uint2*>(st.payload + h.off);
        for (int r = warp; r < h.cnt; r += kWarps) {
          uint32_t rs, re;
          run_bounds(__ldg(runs + r), rs, re);
          if (re <= rs) continue;
          for (int w = (int)(rs >> 5) + lane; w <= (int)((re - 1) >> 5);
               w += 32) {
            const int b = 32 * w;
            atomicOr(tile_words + w,
                     low_bits((int)re - b) & ~low_bits((int)rs - b));
          }
        }
      }
      __syncthreads();
      v0 = tile[q0];
      v1 = tile[q1];
    }
    uint4* o = out + t * kTileQuads;
    o[q0] = v0;
    o[q1] = v1;
    h = next;
    next_ci = after_ci;
  }
}

// A row's header and the first 32 entries of its array container, loaded
// ahead of their use.
struct RowAhead {
  Header h;
  uint32_t slot;  // kTileWords when the lane holds no entry
  uint32_t val;
};

__device__ __forceinline__ RowAhead row_ahead(const Stack& st, long long t,
                                              bool live, int lane) {
  RowAhead a{{-1, 0, 0}, (uint32_t)kTileWords, 0u};
  if (!live) return a;
  a.h = header_of(st, __ldg(st.slots + t));
  if (a.h.typ == kTypeArray && lane < a.h.cnt) {
    const uint32_t* p = st.payload + a.h.off;
    a.slot = __ldg(p + lane);
    a.val = __ldg(p + a.h.cnt + lane);
  }
  return a;
}

// Filter bits under bit x of the tile, x in [0, kTileBits].
__device__ __forceinline__ unsigned bits_below(const uint32_t* below,
                                               const uint32_t* f_words,
                                               uint32_t x) {
  const uint32_t w = x >> 5;
  const int b = x & 31;
  return below[w] + (b ? __popc(f_words[w] & low_bits(b)) : 0u);
}

// One row of one tile column: the warp's count, added to out with one
// atomic.  Uniform across the warp.
__device__ __forceinline__ void count_row(const Stack& st, const RowAhead& a,
                                          const uint4* f,
                                          const uint32_t* f_words,
                                          const uint32_t* below, int lane,
                                          int32_t* out_row) {
  const Header& h = a.h;
  if (h.typ < 0) return;
  unsigned acc = 0;
  if (h.typ == kTypeBitmap) {
    const uint4* p = reinterpret_cast<const uint4*>(st.payload + h.off);
#pragma unroll 4
    for (int q = lane; q < kTileQuads; q += 32) {
      acc += popc_and(__ldg(p + q), f[q]);
    }
  } else if (h.typ == kTypeArray) {
    if (a.slot < kTileWords) acc += __popc(a.val & f_words[a.slot]);
    const uint32_t* p = st.payload + h.off;
    for (int e = lane + 32; e < h.cnt; e += 32) {
      const uint32_t slot = __ldg(p + e);
      if (slot < kTileWords) {
        acc += __popc(__ldg(p + h.cnt + e) & f_words[slot]);
      }
    }
  } else if (h.typ == kTypeRun) {
    const uint2* runs = reinterpret_cast<const uint2*>(st.payload + h.off);
    for (int i = lane; i < h.cnt; i += 32) {
      uint32_t rs, re;
      run_bounds(__ldg(runs + i), rs, re);
      if (re > rs) {
        acc += bits_below(below, f_words, re) -
               bits_below(below, f_words, rs);
      }
    }
  }
  acc = __reduce_add_sync(kFull, acc);
  if (lane == 0 && acc != 0) atomicAdd(out_row, (int32_t)acc);
}

__global__ void __launch_bounds__(kThreads)
fused_row_counts_kernel(Stack st, const uint4* __restrict__ filt,
                        int32_t* __restrict__ out, int rows, int tpr) {
  __shared__ uint4 f[kTileQuads];
  __shared__ uint32_t below[kTileWords + 1];  // prefix popcount, runs only
  __shared__ uint32_t warp_sums[2][kWarps];
  const uint32_t* f_words = reinterpret_cast<const uint32_t*>(f);
  const long long b = blockIdx.x;  // s * tpr + j: filter tile j of shard s
  const long long s = b / tpr;
  const int j = (int)(b - s * tpr);
  const int q0 = threadIdx.x;
  const int q1 = threadIdx.x + kThreads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint4 f0 = make_uint4(kFull, kFull, kFull, kFull), f1 = f0;
  if (filt != nullptr) {
    f0 = __ldg(filt + b * kTileQuads + q0);
    f1 = __ldg(filt + b * kTileQuads + q1);
  }
  const long long first = s * rows * (long long)tpr + j;
  RowAhead ahead[kAhead];
  bool has_runs = rows > kAhead * kWarps;  // rows past the look-ahead
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int r = warp + k * kWarps;
    ahead[k] = row_ahead(st, first + (long long)r * tpr, r < rows, lane);
    has_runs |= ahead[k].h.typ == kTypeRun;
  }
  f[q0] = f0;
  f[q1] = f1;
  if (__syncthreads_or(has_runs)) {
    // below[w] = filter bits in words [0, w): a block scan over the 512
    // quads (quad q0 of every thread, then quad q1 of every thread).
    const unsigned c0 = popc4(f0), c1 = popc4(f1);
    unsigned i0 = c0, i1 = c1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u0 = __shfl_up_sync(kFull, i0, d);
      const unsigned u1 = __shfl_up_sync(kFull, i1, d);
      if (lane >= d) {
        i0 += u0;
        i1 += u1;
      }
    }
    if (lane == 31) {
      warp_sums[0][warp] = i0;
      warp_sums[1][warp] = i1;
    }
    __syncthreads();
    unsigned p0 = i0 - c0, p1 = i1 - c1;
    for (int w = 0; w < kWarps; ++w) {
      p1 += warp_sums[0][w];
      if (w < warp) {
        p0 += warp_sums[0][w];
        p1 += warp_sums[1][w];
      }
    }
    uint32_t* b0 = below + 4 * q0;
    uint32_t* b1 = below + 4 * q1;
    b0[0] = p0;
    b0[1] = p0 += __popc(f0.x);
    b0[2] = p0 += __popc(f0.y);
    b0[3] = p0 += __popc(f0.z);
    b1[0] = p1;
    b1[1] = p1 += __popc(f1.x);
    b1[2] = p1 += __popc(f1.y);
    b1[3] = p1 += __popc(f1.z);
    if (threadIdx.x == kThreads - 1) below[kTileWords] = p1 + __popc(f1.w);
    __syncthreads();
  }
  int32_t* out_s = out + s * rows;
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int r = warp + k * kWarps;
    if (r < rows) count_row(st, ahead[k], f, f_words, below, lane, out_s + r);
  }
  for (int r = warp + kAhead * kWarps; r < rows; r += kWarps) {
    count_row(st, row_ahead(st, first + (long long)r * tpr, true, lane), f,
              f_words, below, lane, out_s + r);
  }
}

// Blocks of a persistent grid for `kernel`: as many as fit on the device's
// SMs (asked once per device), and no more than `work` items.  Request
// threads launch on several cards at once, so the per-device cache is
// atomic: two threads that both miss compute and store the same value.
template <typename K>
int persistent_grid(K kernel, long long work, int* grid) {
  static std::atomic<long long> cap_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  long long cap = dev < 64 ? cap_of[dev].load(std::memory_order_relaxed) : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cap_of[dev].store(cap, std::memory_order_relaxed);
  }
  *grid = (int)(work < cap ? work : cap);
  return 0;
}

}  // namespace

extern "C" int decode_block_launch(const void* slots, const void* types,
                                   const void* counts, const void* offsets,
                                   const void* payload, void* out,
                                   long long n_tiles, void* stream) {
  int grid = 0;
  const int rc = persistent_grid(decode_block_kernel, n_tiles, &grid);
  if (rc != 0) return rc;
  const Stack st{(const int32_t*)slots, (const int32_t*)types,
                 (const int32_t*)counts, (const long long*)offsets,
                 (const uint32_t*)payload};
  decode_block_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      st, (uint4*)out, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int fused_row_counts_launch(const void* slots, const void* types,
                                       const void* counts,
                                       const void* offsets,
                                       const void* payload, const void* filt,
                                       void* out, long long S, int rows,
                                       int tpr, void* stream) {
  const Stack st{(const int32_t*)slots, (const int32_t*)types,
                 (const int32_t*)counts, (const long long*)offsets,
                 (const uint32_t*)payload};
  fused_row_counts_kernel<<<(unsigned)(S * tpr), kThreads, 0,
                            (cudaStream_t)stream>>>(
      st, (const uint4*)filt, (int32_t*)out, rows, tpr);
  return (int)cudaGetLastError();
}
