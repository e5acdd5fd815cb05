// probes.cu: the two ceiling probes as CUDA kernels for Hopper (sm_90a).
//
// 1. fp32_chain replaces tools/vpu_peak.py::_build (the pl.pallas_call at
//    vpu_peak.py:85): per element, 8 independent accumulators run
//    64/2/8 = 4 rounds of `a = a*b + c` (kind fma) or `a = (a + b) + c`
//    (kind nofma) per iteration, then the perturbation a0 += f32(i)*1e-9
//    that keeps the compiler from folding iterations, and the final sum of
//    the 8 accumulators in order. One thread per element, blocks of 128
//    threads (the tracer's geometry); the caller sizes the grid to fill the
//    132 SMs. Bound: the FP32 pipes (FFMA or FADD), no memory traffic inside
//    the loop. The library builds with --fmad=false (the tracer must round
//    as its plain version does), so a plain `a*b + c` would not fuse here:
//    the fma kind calls __fmaf_rn, the nofma kind __fadd_rn, and the
//    perturbation __fmul_rn/__fadd_rn. Plain version:
//    bendy_tpu_torch/tools/vpu_peak.py::fp32_chain_plain.
//
// 2. bf16_dot_chain replaces tools/mxu_shape_probe.py::_build (the
//    pl.pallas_call at mxu_shape_probe.py:110): acc[128, n] +=
//    bf16(tab[128, 512] + f32(i)*1e-6) . onehot[512, n] over `iters`
//    iterations, bf16 products accumulated in f32. Tensor cores through
//    mma.sync m16n8k16 (bf16 in, f32 accumulators in registers). A block
//    owns a 128 x 64 output tile and one 64-deep slice of K (split-K by 8,
//    so n = 1024 already gives 128 blocks); it stages its slice of onehot
//    (bf16), transposed (K contiguous), in shared memory once. Every
//    iteration each thread reads the f32 pairs of tab its A fragments cover
//    through the read-only path (loop-invariant loads, which the compiler
//    keeps in registers) and rounds bf16(tab + pert) afresh (the
//    perturbation changes each iteration, as in the TPU kernel), then runs
//    8 mma per warp and 16-deep step. Each block writes its f32 partial
//    [128, 64] to partial[slice]; the wrapper sums the 8 slices in a fixed
//    order (deterministic). The kernel takes tab in f32 and onehot in bf16:
//    the wrapper widens a bf16 tab (exact) and rounds the f32 control's
//    onehot to bf16, as DEFAULT precision rounds a dot's inputs, so both
//    input types run the same code. Bound:
//    the tensor cores (2*128*512*n*iters operations); the perturbation
//    (one add and a round per A element per n-tile) competes for the
//    instruction slots. A simple kernel: wgmma and TMA are later work. Plain
//    version: bendy_tpu_torch/tools/mxu_shape_probe.py::bf16_dot_chain_plain.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NACC = 8;
constexpr int OPS_PER_ITER = 64;
constexpr int REPS = OPS_PER_ITER / 2 / NACC;  // 4

template <bool FMA>
__global__ void __launch_bounds__(128) fp32_chain_kernel(const float* __restrict__ x,
                                                         float* __restrict__ out, int n,
                                                         int iters) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const float xv = x[e];
    const float b = __fmul_rn(xv, 0.9999999f);
    const float c = __fmul_rn(xv, 1e-7f);
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = __fadd_rn(xv, (float)(1e-6 * k));
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int r = 0; r < REPS; ++r) {
#pragma unroll
            for (int k = 0; k < NACC; ++k) {
                acc[k] = FMA ? __fmaf_rn(acc[k], b, c) : __fadd_rn(__fadd_rn(acc[k], b), c);
            }
        }
        acc[0] = __fadd_rn(acc[0], __fmul_rn((float)i, 1e-9f));
    }
    float s = acc[0];
#pragma unroll
    for (int k = 1; k < NACC; ++k) s = __fadd_rn(s, acc[k]);
    out[e] = s;
}

constexpr int DM = 128;       // rows of tab and of the output
constexpr int DK = 512;       // depth
constexpr int BN = 64;        // output columns per block
constexpr int KS = 64;        // depth slice per block (split-K)
constexpr int SPLIT = DK / KS;  // 8 slices
constexpr int KP = KS + 8;    // padded row of the staged onehot: conflict-free fragment loads
constexpr int DOT_THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(DOT_THREADS) bf16_dot_chain_kernel(
    const float* __restrict__ tab, const __nv_bfloat16* __restrict__ oh,
    float* __restrict__ partial, int n, int iters) {
    __shared__ __align__(16) __nv_bfloat16 sB[BN * KP];  // onehot slice, [n][k]
    const int n0 = blockIdx.x * BN;
    const int k0 = blockIdx.y * KS;
    for (int idx = threadIdx.x; idx < KS * BN; idx += DOT_THREADS) {
        const int k = idx / BN, j = idx % BN;  // coalesced over j
        sB[j * KP + k] = oh[(size_t)(k0 + k) * n + n0 + j];
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int m_base = (warp & 3) * 32, n_base = (warp >> 2) * 32;
    __syncthreads();

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

    for (int it = 0; it < iters; ++it) {
        const float p = __fmul_rn((float)it, 1e-6f);
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks) {
            const int kc = ks * 16 + 2 * tig;  // this thread's column pair in the slice
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int r0 = m_base + mt * 16 + gid;
                // fragment order: (r0, kc), (r0+8, kc), (r0, kc+8), (r0+8, kc+8)
                const int rows[4] = {r0, r0 + 8, r0, r0 + 8};
                const int cols[4] = {kc, kc, kc + 8, kc + 8};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 v = __ldg(
                        reinterpret_cast<const float2*>(tab + rows[q] * DK + k0 + cols[q]));
                    a[mt][q] = pack_bf16x2(__fadd_rn(v.x, p), __fadd_rn(v.y, p));
                }
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const __nv_bfloat16* col = &sB[(n_base + nt * 8 + gid) * KP + kc];
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 8);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
            }
        }
    }

    float* out = partial + (size_t)blockIdx.y * DM * n;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int r = m_base + mt * 16 + gid;
            const int cc = n0 + n_base + nt * 8 + 2 * tig;
            *reinterpret_cast<float2*>(&out[(size_t)r * n + cc]) =
                make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(&out[(size_t)(r + 8) * n + cc]) =
                make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
}

}  // namespace

extern "C" {

// x, out: [n] f32 on the card; fma: 1 for the fma kind, 0 for nofma.
// Returns the launch's CUDA error code (0 on success).
int bendy_fp32_chain(const float* x, float* out, int n, int iters, int fma, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fma) {
        fp32_chain_kernel<true><<<blocks, threads, 0, s>>>(x, out, n, iters);
    } else {
        fp32_chain_kernel<false><<<blocks, threads, 0, s>>>(x, out, n, iters);
    }
    return static_cast<int>(cudaGetLastError());
}

// tab [128, 512] f32, onehot [512, n] bf16; partial [8, 128, n] f32, one
// [128, n] partial per 64-deep slice of K; n a multiple of 64. Returns the
// launch's CUDA error code.
int bendy_bf16_dot_chain(const float* tab, const __nv_bfloat16* onehot, float* partial, int n,
                         int iters, void* stream) {
    const dim3 grid(n / BN, SPLIT);
    bf16_dot_chain_kernel<<<grid, DOT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, onehot, partial, n, iters);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
