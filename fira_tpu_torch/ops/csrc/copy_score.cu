// Bahdanau copy-score forward for Hopper (sm_90a):
//
//     out[b, t, s] = sum_d w[d] * tanh(src[b, s, d] + tgt[b, t, d])
//
// Replaces the TPU kernel fira_tpu/ops/copy_score.py:_copy_scores_fwd_impl
// (pl.pallas_call at :119, body _fwd_kernel at :56-73). Like it, this file
// never writes the (B, T, S, D) tanh intermediate: it reads src and tgt and
// writes only the (B, T, S) scores. The tanh and the dot run in f32
// whatever the input type; the output is in src's type. The bias is added by
// the Python wrapper, as the JAX code adds it outside its kernel. Every sum
// runs in one thread in an order fixed by the shapes, with no atomics, so
// the same inputs give the same bits on every run.
//
// The entry point dispatches on T into two kernels, because the two shapes
// on the main path are bound by different things.
//
// T = 1, the beam step, (B, S, D) = (60, 370, 256) f32: the kernel must read
// src, 22.7 MB, and does 5.7 M tanh, so it is bound by bytes (6.8 us at
// 3.35 TB/s). It keeps the precise tanhf, so that the beam's top-k sees the
// tanh the plain version sees; at some 25 issued instructions each (the
// lanes of a warp take both of its branches), the 5.7 M tanhf need about
// 4 us of issue, which must hide under the loads. copy_score_row_kernel
// gives a warp one (b, s) row and each lane runs of d loaded 16 bytes at a
// time (neighbouring lanes on neighbouring addresses): a row is two load
// instructions a lane, all in flight together. One row a warp keeps 64
// warps an SM resident and gives the grid 2.7 waves, so one warp's tanhf
// runs while others wait on memory. Loading four rows a warp before
// reducing any measured slower on the H100 (0.0190 ms against 0.0164):
// fewer warps, and a warp waits for its slowest row.
//
// T > 1, training and dev, (170, 30, 370, 256) f32: 483 M (b, t, s, d)
// elements, each costing some 15-20 issued instructions through the
// precise tanhf: bound by the instruction issue rate, some 0.3 ms. With
// P = e^(2 src) e^(2 tgt),
//
//     tanh(src + tgt) = 1 - 2 r,   r = 1 / (P + 1),
//
// so out = sum_d w - 2 sum_d w r, and e^(2 src) is taken once per (s, d)
// and e^(2 tgt) once per (t, d) of a tile (precise expf), never per
// element. Two neighbouring d share one reciprocal:
//
//     w1 r1 + w2 r2 = (w1 b + w2 a) / (a b),   a = P1 + 1,  b = P2 + 1,
//
// which leaves, per pair of elements, two FFMAs for a and b, four FP32
// instructions for the numerator, the product and the sum, and one SFU
// reciprocal (rcp.approx, about 1 ulp): 3 FP32 issues, a quarter of a
// shared-memory load and half an SFU reciprocal an element. The SFU takes
// 16 a clock on each SM, so 483 M / 2 reciprocals need 0.058 ms at
// 1.98 GHz, and the other issues (3.25 an element at 128 a clock) 0.054
// ms. The H100's times fit the two adding up rather than overlapping, as
// if a reciprocal held its warp scheduler's issue for the 8 clocks the SFU
// takes over a warp: 0.11 ms measured, about 4x the 0.029 ms operations
// bound (which counts the tanh as one operation). Pairing halves the SFU's share
// against one reciprocal an element, and rounds no worse: the pair's
// numerator and product each round once where two separate terms round
// twice.
//
// copy_score_tile_kernel: a block of TB = 128 threads is one b and a tile
// of ts values of s, one thread an s; ts is 128, or 64 or 32 when the grid
// would not give every SM two blocks, and then the block's 128 / ts slices
// of d each sum their share and meet in shared memory, added in slice
// order. The block stages e^(2 tgt) for a tile of up to TT = 32 values of
// t in shared memory, the two d of a pair interleaved, so that a thread
// reads both d of two t with one 16-byte broadcast load. A thread loads
// its src row 8 values of d at a time (16-byte loads, the next chunk one
// step ahead), takes e^(2 src) of each, and adds each pair into its TT
// sums in registers; the sums are written coalesced across the s-threads.
// T above 32 runs in tiles of 32.
//
// The guard: for |src|, |tgt| <= GUARD = 10, P <= e^40 and a b <= e^80, a
// finite normal float whose reciprocal is normal too. A pair whose src (in
// this s) or whose tgt (anywhere in the t tile) exceeds GUARD in magnitude,
// or is not a number, takes the precise tanhf for that pair instead, with
// tgt read again from global memory (L1/L2): the result is exact to f32
// either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;              // t values a thread holds (T > 1)
constexpr int ET_LD = 2 * TT + 4;   // floats between two d pairs' staged rows
constexpr float GUARD = 10.f;       // |src|, |tgt| up to which the identity runs
constexpr int ROW_WARPS = 8;        // warps of a T = 1 block
constexpr int TB = 128;             // threads of a T > 1 block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 1 / x by the SFU's approximate reciprocal (one MUFU.RCP, about 1 ulp).
// x lies in [1, e^80] here, so flushing subnormals is moot.
__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// N consecutive values of T at p as f32, in loads of up to 16 bytes; p is
// aligned to the size of one load.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
    constexpr int MAX = 16 / (int)sizeof(T);
    constexpr int PER = MAX < N ? MAX : N;          // values a load
    constexpr int WORDS = PER * (int)sizeof(T) / 4; // 32-bit words a load
#pragma unroll
    for (int k = 0; k < N / PER; ++k) {
        const T* q = p + k * PER;
        if constexpr (WORDS == 0) {
            out[k] = to_f32(q[0]);
        } else {
            uint32_t u[WORDS];
            if constexpr (WORDS == 4) {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
                u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
            } else if constexpr (WORDS == 2) {
                const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
                u[0] = v.x; u[1] = v.y;
            } else {
                u[0] = __ldg(reinterpret_cast<const unsigned int*>(q));
            }
#pragma unroll
            for (int i = 0; i < WORDS; ++i) {
                if constexpr (sizeof(T) == 4) {
                    out[k * PER + i] = __uint_as_float(u[i]);
                } else {   // two bf16, the lower d in the low half
                    out[k * PER + 2 * i] = __uint_as_float(u[i] << 16);
                    out[k * PER + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
                }
            }
        }
    }
}

// T = 1. src (B, S, D), tgt (B, 1, D), w (D,) f32 -> out (B, 1, S).
// Grid (ceil(S / ROW_WARPS), B); warp k of block x takes the row
// s = x * ROW_WARPS + k. Lane l holds d in runs of VEC:
// d = 32 VEC i + VEC l + j, i < NV, j < VEC.
template <typename T, int D>
__global__ void __launch_bounds__(ROW_WARPS * 32)
copy_score_row_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                      const float* __restrict__ w, T* __restrict__ out,
                      int n_s) {
    constexpr int VEC = 16 / (int)sizeof(T) < D / 32 ? 16 / (int)sizeof(T) : D / 32;
    constexpr int NV = D / (32 * VEC);
    constexpr int N = NV * VEC;          // values of d a lane holds
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    const int s = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (s >= n_s) return;                // no barrier in this kernel

    // the row's loads first, all in flight together
    float sv[N], tv[N], wv[N];
    const T* row = src + ((size_t)b * n_s + s) * D + lane * VEC;
#pragma unroll
    for (int i = 0; i < NV; ++i) load_vec<T, VEC>(row + 32 * VEC * i, sv + i * VEC);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        load_vec<T, VEC>(tgt + (size_t)b * D + lane * VEC + 32 * VEC * i, tv + i * VEC);
        load_vec<float, VEC>(w + lane * VEC + 32 * VEC * i, wv + i * VEC);
    }
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc = fmaf(wv[j], tanhf(sv[j] + tv[j]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) store(out + (size_t)b * n_s + s, acc);
}

// T > 1. src (B, S, D), tgt (B, T, D), w (D,) f32 -> out (B, T, S). Grid
// (ceil(S / ts), B), block TB threads: ts values of s (128, 64 or 32) times
// TB / ts slices of d. Thread (slice, i) takes s = ts x + i over its slice
// of D / (TB / ts) values of d; with more than one slice, the slices' sums
// meet in shared memory and are added in slice order. Dynamic shared
// memory: et, (D / 2) rows of ET_LD floats, row p holding
// (e^(2 tgt[t, 2p]), e^(2 tgt[t, 2p + 1])) for the tile's t in turn (the
// slices' sums take its place once it is consumed); then the pairs'
// weights -2 w (D floats) and their guard flags (D / 2 ints).
template <typename T, int D>
__global__ void __launch_bounds__(TB, 4)
copy_score_tile_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                       const float* __restrict__ w, T* __restrict__ out,
                       int n_t, int n_s, int ts) {
    constexpr int REGION = (D / 2) * ET_LD > TB * TT ? (D / 2) * ET_LD : TB * TT;
    extern __shared__ __align__(16) float smem[];
    float* et = smem;
    float* part = smem;                  // (slices, TT, ts) sums
    float2* wn2 = reinterpret_cast<float2*>(smem + REGION);
    int* slow = reinterpret_cast<int*>(wn2 + D / 2);
    const int n_slices = TB / ts;
    const int i = threadIdx.x % ts, slice = threadIdx.x / ts;
    const int d_begin = slice * (D / n_slices), d_end = d_begin + D / n_slices;
    const int s = blockIdx.x * ts + i;
    const int b = blockIdx.y;
    const bool active = s < n_s;
    for (int p = threadIdx.x; p < D / 2; p += blockDim.x) {
        wn2[p] = make_float2(-2.f * w[2 * p], -2.f * w[2 * p + 1]);
    }
    // a thread past S's end computes on row 0 and writes nothing
    const T* row = src + ((size_t)b * n_s + (active ? s : 0)) * D;

    for (int t0 = 0; t0 < n_t; t0 += TT) {
        const int tt = min(TT, n_t - t0);
        const T* tgt_t = tgt + ((size_t)b * n_t + t0) * D;
        __syncthreads();                 // the previous tile is consumed
        // one thread a pair of d: coalesced along d, each t in turn; t past
        // the tile's end stages e^0 and its sums are never written
        for (int p = threadIdx.x; p < D / 2; p += blockDim.x) {
            bool big = false;
#pragma unroll 4
            for (int t = 0; t < TT; ++t) {
                float v[2] = {0.f, 0.f};
                if (t < tt) load_vec<T, 2>(tgt_t + (size_t)t * D + 2 * p, v);
                big = big || !(fabsf(v[0]) <= GUARD && fabsf(v[1]) <= GUARD);
                *reinterpret_cast<float2*>(et + p * ET_LD + 2 * t) =
                    make_float2(expf(2.f * v[0]), expf(2.f * v[1]));
            }
            slow[p] = big;
        }
        __syncthreads();

        float acc[TT];                   // -2 sum_d w r, per t
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[t] = 0.f;
        float wsum = 0.f;                // sum_d w, in d order
        float sv_next[8];
        load_vec<T, 8>(row + d_begin, sv_next);
#pragma unroll 1
        for (int d0 = d_begin; d0 < d_end; d0 += 8) {
            float sv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) sv[j] = sv_next[j];
            if (d0 + 8 < d_end) load_vec<T, 8>(row + d0 + 8, sv_next);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int p = d0 / 2 + q;
                const float2 wp = wn2[p];
                const float s1 = sv[2 * q], s2 = sv[2 * q + 1];
                wsum += -0.5f * wp.x;
                wsum += -0.5f * wp.y;
                if (!slow[p] && fabsf(s1) <= GUARD && fabsf(s2) <= GUARD) {
                    const float es1 = expf(2.f * s1), es2 = expf(2.f * s2);
                    const float4* e4 = reinterpret_cast<const float4*>(et + p * ET_LD);
#pragma unroll
                    for (int k = 0; k < TT / 2; ++k) {
                        const float4 e = e4[k];   // et of (2p, 2p+1) at t = 2k, 2k+1
                        const float a0 = fmaf(es1, e.x, 1.f), b0 = fmaf(es2, e.y, 1.f);
                        const float a1 = fmaf(es1, e.z, 1.f), b1 = fmaf(es2, e.w, 1.f);
                        acc[2 * k] = fmaf(fmaf(wp.x, b0, wp.y * a0),
                                          rcp_approx(a0 * b0), acc[2 * k]);
                        acc[2 * k + 1] = fmaf(fmaf(wp.x, b1, wp.y * a1),
                                              rcp_approx(a1 * b1), acc[2 * k + 1]);
                    }
                } else {
                    // precise tanhf: w (tanh - 1) = -2 w r
                    const float w1 = -0.5f * wp.x, w2 = -0.5f * wp.y;
#pragma unroll
                    for (int t = 0; t < TT; ++t) {
                        if (t < tt) {
                            float v[2];
                            load_vec<T, 2>(tgt_t + (size_t)t * D + 2 * p, v);
                            acc[t] = fmaf(w1, tanhf(s1 + v[0]) - 1.f, acc[t]);
                            acc[t] = fmaf(w2, tanhf(s2 + v[1]) - 1.f, acc[t]);
                        }
                    }
                }
            }
        }
        T* o = out + ((size_t)b * n_t + t0) * n_s + s;
        if (n_slices == 1) {
            if (active) {
#pragma unroll
                for (int t = 0; t < TT; ++t) {
                    if (t < tt) store(o + (size_t)t * n_s, wsum + acc[t]);
                }
            }
        } else {
            __syncthreads();             // every slice is done with et
#pragma unroll
            for (int t = 0; t < TT; ++t) part[(slice * TT + t) * ts + i] = wsum + acc[t];
            __syncthreads();
            // thread (slice, i) writes t = slice, slice + n_slices, ...
            for (int t = slice; t < tt && active; t += n_slices) {
                float v = part[t * ts + i];
                for (int k = 1; k < n_slices; ++k) v += part[(k * TT + t) * ts + i];
                store(o + (size_t)t * n_s, v);
            }
        }
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            n = 132;
        }
    }
    return n;
}

template <typename T, int D>
cudaError_t launch(const void* src, const void* tgt, const float* w, void* out,
                   int B, int n_t, int n_s, cudaStream_t stream) {
    if (n_t == 1) {
        const dim3 grid((n_s + ROW_WARPS - 1) / ROW_WARPS, B);
        copy_score_row_kernel<T, D><<<grid, ROW_WARPS * 32, 0, stream>>>(
            static_cast<const T*>(src), static_cast<const T*>(tgt), w,
            static_cast<T*>(out), n_s);
        return cudaGetLastError();
    }
    // the widest s tile (and fewest slices of d) that still gives every SM
    // two blocks
    int ts = TB;
    while (ts > 32 && (long)B * ((n_s + ts - 1) / ts) < 2L * sm_count()) ts /= 2;
    const size_t region = (D / 2) * ET_LD > TB * TT ? (D / 2) * ET_LD : TB * TT;
    const size_t smem = (region + D) * sizeof(float) + (D / 2) * sizeof(int);
    if (smem > 48 * 1024) {              // D = 512: above the default limit
        const cudaError_t err = cudaFuncSetAttribute(
            copy_score_tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((n_s + ts - 1) / ts, B);
    copy_score_tile_kernel<T, D><<<grid, TB, smem, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(tgt), w,
        static_cast<T*>(out), n_t, n_s, ts);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* src, const void* tgt, const float* w,
                       void* out, int B, int n_t, int n_s, int D,
                       cudaStream_t stream) {
    switch (D) {
        case 64:  return launch<T, 64>(src, tgt, w, out, B, n_t, n_s, stream);
        case 128: return launch<T, 128>(src, tgt, w, out, B, n_t, n_s, stream);
        case 256: return launch<T, 256>(src, tgt, w, out, B, n_t, n_s, stream);
        case 512: return launch<T, 512>(src, tgt, w, out, B, n_t, n_s, stream);
        default:  return cudaErrorInvalidValue;
    }
}

}  // namespace

// C entry point bound with ctypes. Pointers are device pointers to
// contiguous src (B, S, D), tgt (B, T, D), w (D,) f32 and out (B, T, S),
// src, tgt and w 16-byte aligned (the caller checks); dtype 0 = float32, 1 = bfloat16 for src,
// tgt and out. Launches on ``stream`` without synchronising and returns
// cudaGetLastError().
extern "C" int fira_copy_score_fwd(const void* src, const void* tgt,
                                   const void* w, void* out, int B, int n_t,
                                   int n_s, int D, int dtype, void* stream) {
    if (B <= 0 || n_t <= 0 || n_s <= 0) return (int)cudaErrorInvalidValue;
    if (B > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
    const float* wf = static_cast<const float*>(w);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0) {
        err = dispatch_d<float>(src, tgt, wf, out, B, n_t, n_s, D, st);
    } else if (dtype == 1) {
        err = dispatch_d<__nv_bfloat16>(src, tgt, wf, out, B, n_t, n_s, D, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return (int)err;
}
