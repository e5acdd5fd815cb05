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
// One thread per pixel of a row chunk. The tracer's output is [n_out, B]
// f32 with B = pixels * nn lanes in row-major (pixel, subpixel) order, so a
// pixel's nn words of one channel are contiguous. For each of the three
// film channels (rows row0, row0 + step, row0 + 2 step; step 0 for depth)
// the thread adds its pixel's words in subpixel order, ((s0 + s1) + s2) +
// ..., then adds the sum to the film's float (add != 0) or stores it there.
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
// 3.35e12 B/s. The design reads consecutive pixels' words in consecutive
// threads (a warp covers 32 nn contiguous words of a row per channel) and
// keeps no intermediate in device memory. The library builds with
// --fmad=false; the kernel only adds. Plain version:
// ops/trace_kernel.py::accumulate_plain.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ACC_THREADS = 128;

__global__ void __launch_bounds__(ACC_THREADS)
    accumulate_kernel(const float* __restrict__ out, int lanes, int row0, int step,
                      const int32_t* __restrict__ rays, int pixels, int nn,
                      float* __restrict__ film, bool add,
                      unsigned long long* __restrict__ ray_total) {
  __shared__ long long warp_rays[ACC_THREADS / 32];
  const int p = blockIdx.x * ACC_THREADS + threadIdx.x;
  long long r = 0;
  if (p < pixels) {
    const size_t l0 = (size_t)p * nn;
    for (int c = 0; c < 3; ++c) {
      const float* src = out + (size_t)(row0 + c * step) * lanes + l0;
      float acc = src[0];
      for (int s = 1; s < nn; ++s) acc = acc + src[s];
      float* dst = film + (size_t)p * 3 + c;
      *dst = add ? *dst + acc : acc;
    }
    for (int s = 0; s < nn; ++s) r += rays[l0 + s];
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
// c * step of out (step 0 or 1). Returns the launch's CUDA error code
// (cudaErrorInvalidValue for arguments the kernel does not take).
int bendy_accumulate(const void* out, int n_out, int lanes, int row0, int step, const void* rays,
                     int pixels, int nn, void* film, int add, void* ray_total, void* stream) {
  if (out == nullptr || rays == nullptr || film == nullptr || ray_total == nullptr ||
      pixels < 0 || nn < 1 || (long long)pixels * nn != lanes || row0 < 0 || step < 0 ||
      row0 + 2 * step >= n_out)
    return (int)cudaErrorInvalidValue;
  if (pixels == 0) return 0;
  accumulate_kernel<<<(pixels + ACC_THREADS - 1) / ACC_THREADS, ACC_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), lanes, row0, step, static_cast<const int32_t*>(rays),
      pixels, nn, static_cast<float*>(film), add != 0,
      static_cast<unsigned long long*>(ray_total));
  return (int)cudaGetLastError();
}

}  // extern "C"
