// P3 — loads against compute in the forward composite, and the in-kernel
// gather.
//
// Replaces the Pallas kernels of tools/bench_dma_overhead.py
// (_dma_only_kernel :69, launched at :197; _compute0_kernel :97, launched
// at :210; _fused4_kernel :150, launched at :224) and of
// tools/bench_inkernel_gather.py (rowdma_gather :61 over _rowdma_kernel
// :46, launched at :66; blockdma_copy :92 over _blockdma_kernel :84,
// launched at :94).
//
// What it computes (the plain versions in gsplat_tpu_torch/tools/probes.py
// define every output):
//   load_only         K1's staging (composite_fwd.cuh::stage_instances),
//                     on K1's CTAs: each tile is split as K1 splits it
//                     (fwd_split, fwd_threads: two CTAs of 128 threads at
//                     32x32), and each CTA stages the tile's batches of 128
//                     instances, their [6+C] rows through their gaussian
//                     ids and the cull masks of its own warps, into shared
//                     memory; then one add per batch and output word: word
//                     p, which the CTA's thread that owns pixel p in K1
//                     keeps, adds staged float p of the batch (row-major
//                     [nb][6+C], zero past the batch).  Output [T,
//                     TILE_PIX], the sums.  `limits` [T, split] (optional)
//                     cuts the CTA of tile t that runs warps 4 s .. 4 s + 3
//                     to its first limits[t, s] instances, the batches that
//                     CTA of K1 stages before its early exit, so the probe
//                     reads the bytes K1 reads.
//   load_only_4tiles  the same, each CTA walking its part of 4 consecutive
//                     tiles and carrying one sum: output [ceil(T / 4),
//                     TILE_PIX].
//   compute_resident  K1's variant of that name (composite_fwd.cuh): K1
//                     with each tile's first batch staged once and computed
//                     for every batch.  Output K1's [T, C+2, TILE_PIX].
//   row_gather        out[i] = table[ids[i]] for a [P, R] table, each row
//                     read by id inside the kernel (a zero row for an id
//                     outside [0, P)): the TPU's per-row indexed DMA.
//   block_copy        out = src for a contiguous [I, R] block: the
//                     pre-gathered table's copy, the baseline.
//
// Design.  load_only stages through K1's own stage_instances and
// compute_resident is K1's kernel itself, so both follow K1; both are
// compiled for C = 7 and a runtime C like P1.  block_copy, and row_gather
// at a row width R that is a multiple of 4, are grid-stride loops of 16
// bytes a thread.  Any other R (the production table's 13 floats among
// them) gathers 32 rows a warp at a time: the warp reads the 32 ids in one
// coalesced load and hands each out by shuffle, and each lane then writes
// elements lane, lane + 32, ... of the 32 rows' contiguous 32 R floats of
// output, their R loads issued from an unrolled loop before any store, so
// a lane has up to R independent loads in flight and the warp's stores are
// coalesced.  R = 13 is compiled with its width known (the division by R a
// multiply); other widths take R at run time, 8 loads in flight a lane.
//
// Bound on the H100: bytes for load_only, row_gather and block_copy (what
// they read and write once), operations for compute_resident (K1's count on
// its own walk); chip_smoke.py computes both from the run's inputs.
#include <type_traits>

#include "composite_fwd.cuh"

namespace {

constexpr int kGatherThreads = 256;

enum LoadVariant {
  kLoadOnly = 0,
  kLoadOnly4Tiles,
  kLoadComputeResident,
  kRowGather,
  kBlockCopy
};

template <int CT, int TILES>
__global__ void __launch_bounds__(kFwdCtaThreads)
probe_load_kernel(const float* __restrict__ table, int P, int C,
                  const int* __restrict__ gauss_id,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  const int* __restrict__ limits, int num_tiles, int grid_x,
                  int tile_x, int tile_y, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int row = kGeo + (CT > 0 ? CT : C);
  const int npix = tile_x * tile_y;
  float* s_rows = smem;
  unsigned* s_may = reinterpret_cast<unsigned*>(smem + kFwdBatch * row);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  // K1's split: this CTA runs warps w0 .. w0 + nwarps - 1 of its tiles
  const int split = fwd_split(npix);
  const int group = blockIdx.x / split;
  const int part = blockIdx.x - group * split;
  const int w0 = part * nwarps;
  const int pix0 = thread_pixel0(tile_x, tile_y, w0 * 32 + tid);
  float acc[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) acc[j] = 0.f;
  for (int i = 0; i < TILES; ++i) {
    const int t = group * TILES + i;
    if (t >= num_tiles) break;  // the same for the whole CTA
    const int start = starts[t];
    const int count = limits != nullptr ? min(limits[t * split + part],
                                              counts[t])
                                        : counts[t];
    for (int b0 = 0; b0 < count; b0 += kFwdBatch) {
      const int nb = min(kFwdBatch, count - b0);
      __syncthreads();  // the previous batch has been read
      stage_instances<false, false>(
          table, P, row, row, row - kGeo, gauss_id + start + b0, nb, tid,
          nthreads, (t % grid_x) * tile_x, (t / grid_x) * tile_y, tile_x,
          tile_y, npix, w0, nwarps, s_rows, s_may, nullptr);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int p = pix0 + j;
        if (p < nb * row) acc[j] += s_rows[p];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = pix0 + j;
    if (p < npix) out[static_cast<size_t>(group) * npix + p] = acc[j];
  }
}

// row_gather (ids != nullptr) or block_copy (ids == nullptr), W floats at a
// time: W = 4 needs R % 4 == 0.  Index is the type of the flat element
// index: 32-bit whenever the I * R / W elements fit, so the per-element
// division is a 32-bit one.
template <int W, typename Index>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_kernel(const float* __restrict__ src, int P, int R,
                    const int* __restrict__ ids, Index n,
                    float* __restrict__ out) {
  using Vec = typename std::conditional<W == 4, float4, float>::type;
  const Index rw = static_cast<Index>(R / W);  // vectors per row
  const Vec* s = reinterpret_cast<const Vec*>(src);
  Vec* o = reinterpret_cast<Vec*>(out);
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index e = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    if (ids == nullptr) {
      o[e] = __ldg(s + e);
    } else {
      const Index i = e / rw;
      const Index j = e - i * rw;
      const int g = __ldg(ids + i);
      Vec v;
      if (g >= 0 && g < P) {
        v = __ldg(s + static_cast<size_t>(g) * rw + j);
      } else {
        v = Vec{};
      }
      o[e] = v;
    }
  }
}

// row_gather at any R: 32 rows a warp at a time, their ids read once and
// handed out by shuffle.  RT > 0: R known at compile time, every element of
// a lane's share loaded before any is stored; RT == 0: R at run time, in
// steps of kGatherUnroll elements.
constexpr int kGatherUnroll = 8;

template <int RT>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_rows_kernel(const float* __restrict__ src, int P, int R,
                         const int* __restrict__ ids, int I,
                         float* __restrict__ out) {
  constexpr int kSteps = RT > 0 ? RT : kGatherUnroll;
  const int r = RT > 0 ? RT : R;
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kGatherThreads / 32);
  for (long long base = (static_cast<long long>(blockIdx.x) *
                             (kGatherThreads / 32) +
                         (threadIdx.x >> 5)) *
                        32;
       base < I; base += warps * 32) {
    const int nrows = static_cast<int>(min(32LL, I - base));
    const int g = lane < nrows ? __ldg(ids + base + lane) : -1;
    const unsigned n = static_cast<unsigned>(nrows * r);  // floats to write
    float* o = out + base * r;
    for (unsigned e0 = 0; e0 < n; e0 += 32u * kSteps) {
      float v[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const unsigned e = e0 + lane + 32u * j;
        const unsigned row = e / static_cast<unsigned>(r);
        const int gr = __shfl_sync(kFull, g, row & 31u);
        v[j] = (e < n && gr >= 0 && gr < P)
                   ? __ldg(src + static_cast<size_t>(gr) * r +
                           (e - row * static_cast<unsigned>(r)))
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const unsigned e = e0 + lane + 32u * j;
        if (e < n) o[e] = v[j];
      }
    }
  }
}

template <int W>
void launch_gather(const float* s, int P, int R, const int* id, long long n,
                   int blocks, float* o, cudaStream_t st) {
  if (n + static_cast<long long>(blocks) * kGatherThreads < (1LL << 32)) {
    probe_gather_kernel<W, unsigned><<<blocks, kGatherThreads, 0, st>>>(
        s, P, R, id, static_cast<unsigned>(n), o);
  } else {
    probe_gather_kernel<W, unsigned long long>
        <<<blocks, kGatherThreads, 0, st>>>(
            s, P, R, id, static_cast<unsigned long long>(n), o);
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int CT>
int launch_tiles(int variant, const float* tb, int P, int C, const int* gid,
                 const int* st, const int* ct, const int* lim, int num_tiles,
                 int grid_x, int tile_x, int tile_y, float* o,
                 cudaStream_t s) {
  // K1's CTAs: fwd_split of them a tile (or a group of 4 tiles)
  const int npix = tile_x * tile_y;
  const int threads = fwd_threads(npix);
  const int split = fwd_split(npix);
  const size_t smem = fwd_smem_bytes(C, false);
  int err;
  switch (variant) {
    case kLoadOnly:
      if ((err = set_smem(probe_load_kernel<CT, 1>, smem))) return err;
      probe_load_kernel<CT, 1><<<num_tiles * split, threads, smem, s>>>(
          tb, P, C, gid, st, ct, lim, num_tiles, grid_x, tile_x, tile_y, o);
      break;
    case kLoadOnly4Tiles:
      if ((err = set_smem(probe_load_kernel<CT, 4>, smem))) return err;
      probe_load_kernel<CT, 4><<<(num_tiles + 3) / 4 * split, threads, smem,
                                 s>>>(
          tb, P, C, gid, st, ct, lim, num_tiles, grid_x, tile_x, tile_y, o);
      break;
    default:
      return launch_forward<CT, kComputeResident>(
          tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// load_only, load_only_4tiles and compute_resident; `limits` [num_tiles,
// fwd_split] may be null (and compute_resident ignores it).
extern "C" int gsplat_probe_load(int variant, const void* table, int P,
                                 int C, const void* gauss_id,
                                 const void* starts, const void* counts,
                                 const void* limits, int num_tiles,
                                 int grid_x, int tile_x, int tile_y,
                                 void* out, void* stream) {
  if (variant < kLoadOnly || variant > kLoadComputeResident) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return 0;
  if (const int e = forward_shape_error(C, tile_x, tile_y, false)) return e;
  const float* tb = static_cast<const float*>(table);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const int* lim = static_cast<const int*>(limits);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 7) {
    return launch_tiles<7>(variant, tb, P, C, gid, st, ct, lim, num_tiles,
                           grid_x, tile_x, tile_y, o, s);
  }
  return launch_tiles<0>(variant, tb, P, C, gid, st, ct, lim, num_tiles,
                         grid_x, tile_x, tile_y, o, s);
}

// row_gather (src [P, R], ids [I]) and block_copy (src [I, R], ids null).
extern "C" int gsplat_probe_gather(int variant, const void* src, int P,
                                   int R, const void* ids, int I, void* out,
                                   void* stream) {
  if ((variant != kRowGather && variant != kBlockCopy) || R <= 0 ||
      (variant == kRowGather) != (ids != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (I <= 0) return 0;
  const float* s = static_cast<const float*>(src);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kRowGather && R % 4 != 0) {
    const long long groups = (static_cast<long long>(I) + 31) / 32;
    const long long need = (groups + kGatherThreads / 32 - 1) /
                           (kGatherThreads / 32);
    const int blocks = static_cast<int>(need < (1LL << 20) ? need
                                                            : (1LL << 20));
    if (R == 13) {
      probe_gather_rows_kernel<13><<<blocks, kGatherThreads, 0, st>>>(
          s, P, R, id, I, o);
    } else {
      probe_gather_rows_kernel<0><<<blocks, kGatherThreads, 0, st>>>(
          s, P, R, id, I, o);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = R % 4 == 0;
  const long long n = static_cast<long long>(I) * (vec ? R / 4 : R);
  const long long blocks_needed = (n + kGatherThreads - 1) / kGatherThreads;
  const int blocks = static_cast<int>(
      blocks_needed < (1LL << 20) ? blocks_needed : (1LL << 20));
  if (vec) {
    launch_gather<4>(s, P, R, id, n, blocks, o, st);
  } else {
    launch_gather<1>(s, P, R, id, n, blocks, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
