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
//    iterations, bf16 products accumulated in f32. Bound: the tensor cores
//    (2*128*512*n*iters operations; no memory traffic inside the loop).
//    Hopper reaches its tensor rate only through wgmma, so each product is
//    wgmma.mma_async m64nBNk16 with A from registers and B from shared
//    memory. A block of two warpgroups (rows 0-63 and 64-127) owns a
//    128 x BN output tile and one KS-deep slice of K (split-K by 512/KS).
//    Four tiles are built: 256 x 16, 32 and 64, and 64 x 64. Where 256
//    divides n, the wrapper's plan (tools/mxu_shape_probe.py::dot_plan)
//    takes BN = 256 and the KS whose grid fills the 132 SMs best in whole
//    waves (a 256-column block needs more than half an SM's registers, so
//    an SM holds one); any other multiple of 64 takes 64 x 64. The block
//    stages its [KS, BN] slice of onehot (bf16) once, K-major in 128-byte
//    rows under the 128-byte swizzle that a wgmma descriptor reads. Each
//    thread loads the f32 tab values of its A fragments once and keeps them
//    in registers; every iteration it rounds bf16(tab + pert) afresh into
//    the register-A fragment layout (the perturbation changes every
//    iteration, as in the TPU kernel): one add per value and one conversion
//    per pair, so one conversion per 4*BN products of its warpgroup. The
//    fragments are double-buffered: the next iteration's are built while
//    this iteration's wgmma group runs (wait_group 1 before a buffer is
//    written again), and the accumulators chain across iterations. Each
//    block writes its f32 partial [128, BN] to partial[slice]; the wrapper
//    sums the slices in index order (deterministic). The kernel takes tab
//    in f32 and onehot in bf16: the wrapper widens a bf16 tab (exact) and
//    rounds the f32 control's onehot to bf16, as DEFAULT precision rounds a
//    dot's inputs, so both input types run the same code. Plain version:
//    bendy_tpu_torch/tools/mxu_shape_probe.py::bf16_dot_chain_plain.

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

constexpr int DM = 128;           // rows of tab and of the output
constexpr int DK = 512;           // depth
constexpr int DOT_THREADS = 256;  // two warpgroups: rows 0-63 and 64-127
constexpr int SW_ROW = 64;        // bf16 in one 128-byte swizzled row of the staged onehot
constexpr int SW_ATOM = 1024;     // bytes of one 8-row swizzle atom (the descriptor's SBO)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma shared-memory descriptor of a K-major operand in 128-byte
// swizzled rows: start address >> 4, leading offset 16 B (not read under a
// swizzle), stride 1024 B between 8-row atoms, layout type 1 (128-byte
// swizzle). The atom must start on a 1024-byte boundary (base offset 0).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(SW_ATOM >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

#define BENDY_D8(i)                                                                   \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define BENDY_D32(i) BENDY_D8(i), BENDY_D8(i + 8), BENDY_D8(i + 16), BENDY_D8(i + 24)
#define BENDY_WGMMA_IN : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)

// d[BN/2] += A[64 x 16] . B[16 x BN] for the warpgroup: A from registers
// (this thread's four bf16 pairs), B through its descriptor; scale-d 1,
// no negation, B K-major (no transpose). d[4c + {0,1}] is row gid, columns
// 8c + 2*tig + {0,1} of this warp's 16 rows; d[4c + {2,3}] row gid + 8.
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : BENDY_D32(0) BENDY_WGMMA_IN);
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : BENDY_D32(0), BENDY_D32(32), BENDY_D32(64), BENDY_D32(96) BENDY_WGMMA_IN);
}

#undef BENDY_WGMMA_IN
#undef BENDY_D32
#undef BENDY_D8

// This thread's A fragments of one iteration: bf16(tab + p) for each of
// its KS/16 k-steps, in the register-A order (rows gid, gid + 8; columns
// 2*tig and 2*tig + 8 of the step, two per register).
template <int KSTEPS>
__device__ __forceinline__ void build_a(uint32_t (&a)[KSTEPS][4], const float (&t)[KSTEPS][8],
                                        int it) {
    const float p = __fmul_rn(static_cast<float>(it), 1e-6f);
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
            a[s][q] = pack_bf16x2(__fadd_rn(t[s][2 * q], p), __fadd_rn(t[s][2 * q + 1], p));
}

// One iteration of the warpgroup: the KS/16 products of its k-steps as one
// wgmma group, then wait until the previous iteration's group is done, so
// that the caller may write that group's fragments again.
template <int BN, int KSTEPS>
__device__ __forceinline__ void dot_step(float (&acc)[BN / 2], const uint32_t (&a)[KSTEPS][4],
                                         uint64_t desc) {
    wgmma_fence();  // this iteration's fragments were written by plain code
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) wgmma_rs<BN>(acc, a[s], desc + 2 * s);  // +32 B a k-step
    wgmma_commit();
    wgmma_wait<1>();
}

template <int BN, int KS>
__global__ void __launch_bounds__(DOT_THREADS) bf16_dot_chain_kernel(
    const float* __restrict__ tab, const __nv_bfloat16* __restrict__ oh,
    float* __restrict__ partial, int n, int iters) {
    static_assert(KS % 16 == 0 && KS <= SW_ROW && DK % KS == 0, "KS: 16-deep steps in a row");
    static_assert(BN / 2 + KS <= 192, "accumulators + fragments + tab within the budget");
    constexpr int KSTEPS = KS / 16;
    // onehot[k0:k0+KS, n0:n0+BN] as BN rows of 128 bytes (k contiguous,
    // chunk k/8 of row j at chunk (k/8) ^ (j%8)); chunks past KS unused
    __shared__ __align__(16) unsigned char smem[BN * 2 * SW_ROW + SW_ATOM];
    const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const uint32_t base = (raw + SW_ATOM - 1) & ~static_cast<uint32_t>(SW_ATOM - 1);
    __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + (base - raw));
    const int n0 = blockIdx.x * BN;
    const int k0 = blockIdx.y * KS;
    for (int idx = threadIdx.x; idx < KS * BN; idx += DOT_THREADS) {
        const int k = idx / BN, j = idx % BN;  // coalesced over j
        sB[j * SW_ROW + (((k >> 3) ^ (j & 7)) << 3) + (k & 7)] = oh[(size_t)(k0 + k) * n + n0 + j];
    }
    // the stores above are read by the tensor cores' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = warp * 16 + (lane >> 2);  // warpgroup warp/4, rows 16*warp .. +15
    const int tig = lane & 3;
    float t[KSTEPS][8];  // this thread's tab values, loaded once
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int row = r0 + 8 * (q & 1), col = k0 + 16 * s + 2 * tig + 8 * (q >> 1);
            const float2 v = *reinterpret_cast<const float2*>(tab + row * DK + col);
            t[s][2 * q] = v.x;
            t[s][2 * q + 1] = v.y;
        }
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    const uint64_t desc = sw128_desc(base);

    uint32_t a0[KSTEPS][4], a1[KSTEPS][4];
    build_a(a0, t, 0);
    int it = 0;
    for (; it + 1 < iters; it += 2) {
        dot_step<BN>(acc, a0, desc);
        build_a(a1, t, it + 1);
        dot_step<BN>(acc, a1, desc);
        build_a(a0, t, it + 2);
    }
    if (it < iters) dot_step<BN>(acc, a0, desc);
    wgmma_wait<0>();

    float* out = partial + (size_t)blockIdx.y * DM * n;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * tig;
        *reinterpret_cast<float2*>(&out[(size_t)r0 * n + col]) =
            make_float2(acc[4 * c], acc[4 * c + 1]);
        *reinterpret_cast<float2*>(&out[(size_t)(r0 + 8) * n + col]) =
            make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
}

template <int BN, int KS>
int launch_dot_chain(const float* tab, const __nv_bfloat16* oh, float* partial, int n,
                     int iters, cudaStream_t s) {
    const dim3 grid(n / BN, DK / KS);
    bf16_dot_chain_kernel<BN, KS><<<grid, DOT_THREADS, 0, s>>>(tab, oh, partial, n, iters);
    return static_cast<int>(cudaGetLastError());
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

// tab [128, 512] f32, onehot [512, n] bf16; partial [512/ks, 128, n] f32,
// one [128, n] partial per ks-deep slice of K; (bn, ks) one of the
// instantiated tiles (256 x 16, 32 or 64, or 64 x 64; bn dividing n).
// Returns the launch's CUDA error code (cudaErrorInvalidValue for a tile
// that is not instantiated).
int bendy_bf16_dot_chain(const float* tab, const __nv_bfloat16* onehot, float* partial, int n,
                         int iters, int bn, int ks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0 || bn <= 0 || n % bn != 0) return static_cast<int>(cudaErrorInvalidValue);
#define BENDY_DOT_TILE(B, K) \
    if (bn == B && ks == K) return launch_dot_chain<B, K>(tab, onehot, partial, n, iters, s);
    BENDY_DOT_TILE(256, 64) BENDY_DOT_TILE(256, 32) BENDY_DOT_TILE(256, 16)
    BENDY_DOT_TILE(64, 64)
#undef BENDY_DOT_TILE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
