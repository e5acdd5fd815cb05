// accumulate.cu: a render pass's subpixel sum, film add and ray count as one
// CUDA kernel for Hopper (sm_90a).
//
// Replaces the pass glue around the tracer that ran as separate PyTorch
// launches (ops/trace_kernel.py::pixel_sums: a reshape and sum per channel
// and a stack; a torch.cat over row chunks; DeviceFilm.add_pass's +=; the
// int64 sum of the per-lane rays). It is the counterpart of the subpixel
// sum that the reference's jitted pass fuses with its film add
// (bendy_tpu/render.py:224-226), on the pass that runs the looped light
// sweep (kernel 1e-ii, bendy_tpu/ops/pallas_trace.py:255) and every other
// main path.
//
// One thread per pixel slot of a row chunk. The tracer's output is [n_out,
// B] f32 with B = pixels * nn lanes, each pixel's nn subpixels contiguous
// and in order, so a pixel's nn words of one channel are contiguous. The
// slots are the chunk's pixels in row-major order, or, when the pass feeds
// its lanes tile-major (the reference's tile_perm, pallas_trace.py:279), in
// that order: slot p then reads its film row from the lanes' own pixel ids,
// pix[p * nn] - pix0 (pix0 the chunk's first pixel id), which undoes the
// tiling with no table and no gather on the host (the reference undoes it
// with reshapes and a transpose, pallas_trace.py:361-384, because a gather
// cost a quarter of its pass on the TPU). For each of the three film
// channels (rows row0, row0 + step, row0 + 2 step; step 0 for depth) the
// thread adds its pixel's words in subpixel order, ((s0 + s1) + s2) + ...,
// then adds the sum to the film's float (add != 0) or stores it there.
// It also sums its pixel's nn int32 ray counts; the warp adds its threads'
// counts with shuffles, the block its warps' through shared memory, and one
// thread of the block adds the block's count to the int64 counter with one
// atomicAdd: exact, the sum is over integers, so the order of the blocks'
// atomics does not matter.
//
// Bound: bytes. Each lane word of the three rows (one for depth) and each
// ray count is read once, each film float read and written once (written
// only, in store mode): on cornell 256x256 with 2x2 subpixels 3.1 MB of
// lane words, 1.0 MB of ray counts and 1.6 MB of film, about 1.7 us at
// 3.35e12 B/s (tile-major lanes add one pixel id read per pixel, 0.26 MB).
// The design reads consecutive pixels' words in consecutive threads (a warp
// covers 32 nn contiguous words of a row per channel; tile-major, it writes
// runs of a tile's width of film rows) and keeps no intermediate in device
// memory. The library builds with
// --fmad=false; the kernel only adds. Plain version:
// ops/trace_kernel.py::accumulate_plain.
//
// On a profiled pass of a lane-loop launch (one tracer thread per lane, in
// the lanes' order) it is also given the lanes' loop iterations, `iters`,
// and counts the tracer's warp use into `loop_use` (thread iterations,
// and 32 × each warp's longest loop), as fold_kernel does for the per-item
// launches (csrc/trace_surface.cu, count_warp_item): slot p's lanes are
// the run [p·nn, (p + 1)·nn) of the launch's threads. That is the COUNT
// instantiation; a null `loop_use` launches the one without, the pass as
// it was.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ACC_THREADS = 128;

// csrc/trace_surface.cu's count_warp_item and add_warp_use, for this file's
// kernel (the library links its sources without relocatable device code)
__device__ __forceinline__ void count_warp_item(int k, int x, int r0, int run, long long left,
                                                int& wmax, long long& loop_it, long long& issued,
                                                int* warp_max) {
  if ((k | 31) >= left) return;
  loop_it += x;
  wmax = max(wmax, x);
  const bool warp_end = (k & 31) == 31;
  if (!warp_end && k != r0 + run - 1) return;
  const int w0 = k & ~31;
  if (warp_end && w0 >= r0) issued += wmax;
  else atomicMax(&warp_max[w0 / run], wmax);
  wmax = 0;
}

__device__ __forceinline__ void add_warp_use(long long loop_it, long long issued,
                                             const int* warp_max,
                                             long long (*sums)[ACC_THREADS / 32],
                                             unsigned long long* loop_use) {
  issued += warp_max[threadIdx.x];
  for (int o = 16; o > 0; o >>= 1) {
    loop_it += __shfl_down_sync(0xffffffffu, loop_it, o);
    issued += __shfl_down_sync(0xffffffffu, issued, o);
  }
  if ((threadIdx.x & 31) == 0) {
    sums[0][threadIdx.x >> 5] = loop_it;
    sums[1][threadIdx.x >> 5] = issued;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long a = 0, b = 0;
    for (int w = 0; w < ACC_THREADS / 32; ++w) {
      a += sums[0][w];
      b += sums[1][w];
    }
    if (a != 0) atomicAdd(loop_use, (unsigned long long)a);
    if (b != 0) atomicAdd(loop_use + 1, (unsigned long long)(32 * b));
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(ACC_THREADS)
    accumulate_kernel(const float* __restrict__ out, int lanes, int row0, int step,
                      const int32_t* __restrict__ rays, int pixels, int nn,
                      const int32_t* __restrict__ pix, int pix0,
                      float* __restrict__ film, bool add,
                      unsigned long long* __restrict__ ray_total,
                      const int32_t* __restrict__ iters,
                      unsigned long long* __restrict__ loop_use) {
  __shared__ long long warp_rays[ACC_THREADS / 32];
  __shared__ int warp_max[COUNT ? ACC_THREADS : 1];
  __shared__ long long warp_sums[2][ACC_THREADS / 32];
  const int p = blockIdx.x * ACC_THREADS + threadIdx.x;
  if constexpr (COUNT) {
    warp_max[threadIdx.x] = 0;
    __syncthreads();
  }
  long long r = 0, loop_it = 0, issued = 0;
  if (p < pixels) {
    const size_t l0 = (size_t)p * nn;
    const int q = pix == nullptr ? p : pix[l0] - pix0;  // the slot's film row
    for (int c = 0; c < 3 && q >= 0 && q < pixels; ++c) {  // no row outside the film
      const float* src = out + (size_t)(row0 + c * step) * lanes + l0;
      float acc = src[0];
      for (int s = 1; s < nn; ++s) acc = acc + src[s];
      float* dst = film + (size_t)q * 3 + c;
      *dst = add ? *dst + acc : acc;
    }
    for (int s = 0; s < nn; ++s) r += rays[l0 + s];
    if constexpr (COUNT) {
      const int r0 = threadIdx.x * nn;
      const long long left = (long long)lanes - (long long)blockIdx.x * ACC_THREADS * nn;
      int wmax = 0;
      for (int s = 0; s < nn; ++s)
        count_warp_item(r0 + s, iters[l0 + s], r0, nn, left, wmax, loop_it, issued, warp_max);
    }
  }
  if constexpr (COUNT) {
    __syncthreads();
    add_warp_use(loop_it, issued, warp_max, warp_sums, loop_use);
  }
  for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
  if ((threadIdx.x & 31) == 0) warp_rays[threadIdx.x >> 5] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long block = 0;
    for (int w = 0; w < ACC_THREADS / 32; ++w) block += warp_rays[w];
    if (block != 0) atomicAdd(ray_total, (unsigned long long)block);
  }
}

}  // namespace

extern "C" {

// out [n_out, lanes] f32, rays [lanes] int32, lanes = pixels * nn; film
// [pixels, 3] f32; ray_total [1] int64. Film channel c reads row row0 +
// c * step of out (step 0 or 1). pix: the lanes' [lanes] int32 pixel ids
// when they are not in row-major order (slot p's film row pix[p * nn] -
// pix0; a row outside the film is not written), else null. Returns the
// launch's CUDA error code (cudaErrorInvalidValue for arguments the kernel
// does not take). A non-null `loop_use` [2] int64 gets the tracer's thread
// iterations and the iterations its warps issued added to it, from the
// lanes' [lanes] int32 loop iterations `iters` (a lane-loop launch's).
int bendy_accumulate(const void* out, int n_out, int lanes, int row0, int step, const void* rays,
                     int pixels, int nn, const void* pix, int pix0, void* film, int add,
                     void* ray_total, const void* iters, void* loop_use, void* stream) {
  if (out == nullptr || rays == nullptr || film == nullptr || ray_total == nullptr ||
      (loop_use != nullptr && iters == nullptr) ||
      pixels < 0 || nn < 1 || (long long)pixels * nn != lanes || row0 < 0 || step < 0 ||
      row0 + 2 * step >= n_out)
    return (int)cudaErrorInvalidValue;
  if (pixels == 0) return 0;
  const auto kernel = loop_use != nullptr ? accumulate_kernel<true> : accumulate_kernel<false>;
  kernel<<<(pixels + ACC_THREADS - 1) / ACC_THREADS, ACC_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), lanes, row0, step, static_cast<const int32_t*>(rays),
      pixels, nn, static_cast<const int32_t*>(pix), pix0, static_cast<float*>(film), add != 0,
      static_cast<unsigned long long*>(ray_total), static_cast<const int32_t*>(iters),
      static_cast<unsigned long long*>(loop_use));
  return (int)cudaGetLastError();
}

}  // extern "C"
