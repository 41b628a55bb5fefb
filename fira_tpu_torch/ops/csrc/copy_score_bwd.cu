// Bahdanau copy-score backward for Hopper (sm_90a). With
//
//     x[b, t, s, d] = tanh(src[b, s, d] + tgt[b, t, d])
//     g[b, t, s, d] = (1 - x^2) * w[d] * dout[b, t, s]
//
// it writes dsrc[b, s, :] = sum_t g, dtgt[b, t, :] = sum_s g and, per
// (b, chunk of s), a partial dw = sum_{t, s} x * dout that the Python
// wrapper sums (dbias = sum dout stays in the wrapper too).
//
// Replaces the TPU kernel fira_tpu/ops/copy_score.py:_bwd_kernel (its
// pl.pallas_call in _copy_scores_bwd at :148). Like it, this kernel never
// writes the (B, T, S, D) intermediate: it recomputes x from src and tgt,
// once per element. The TPU kernel walks S in chunks on one core and
// carries dtgt and dw from chunk to chunk; here blocks run in parallel and
// nothing carries over.
//
// Layout: the backward is separable in d. Every quantity at index d
// depends only on src[.., d], tgt[.., d] and w[d], plus the scalar
// dout[b, t, s]. So one thread owns one (b, d) column over one chunk of at
// most 128 values of s (3 chunks of 124 at S = 370), and a block is one b,
// one chunk and all D values of d (D threads). A thread holds, for a tile
// of up to 32 values of t, exp(2 tgt[b, t, d]) and the matching dtgt sums
// in registers, and walks its chunk once: for each s it loads src[b, s, d]
// (neighbouring threads read neighbouring d; the next s is loaded one step
// ahead), evaluates x once for every t of the tile, adds into its dsrc,
// dtgt and dw sums, and writes dsrc[b, s, d]. dout[b, t, s] is the same
// for every d, so the block stages its (t tile x chunk) piece in shared
// memory s-major, and a thread reads four consecutive t with one 16-byte
// broadcast load. No value is summed across threads: there is no
// shared-memory reduction and no float atomic.
//
// Determinism: T above 32 is taken in tiles of 32, and for each later tile
// a thread adds into its own dsrc values, which it alone writes, in tile
// order (in bf16 it adds to the rounded value it wrote). Each block writes its dtgt sums as a partial (B, n_chunks, T, D)
// f32 and its dw sums as a partial (B, n_chunks, D) f32. A second kernel of
// this file sums the dtgt partials over the chunks in chunk order and
// writes dtgt in src's type; the wrapper sums the dw partials. Every sum
// runs in an order fixed by the shapes alone, so the same inputs give the
// same bits on every run. dw sums some 3,700 products a chunk, so it is
// summed over t first and then over s with a compensated (Kahan) sum.
//
// The tanh, once per element and cheaply: with P = e^(2 src) e^(2 tgt),
//
//     tanh(src + tgt) = 1 - 2 r,   r = 1 / (P + 1),   (1 - x^2) / 4 = r - r^2.
//
// e^(2 tgt) is computed (precise expf) once per tile, e^(2 src) once per s;
// per element that leaves one FFMA for P + 1, one SFU reciprocal
// (rcp.approx, about 1 ulp), one FFMA for x, one for
// r - r^2 and three for the sums. r - r^2 loses relative accuracy where
// x nears -1, but its absolute error (about 1e-7) is that of the plain
// version's 1 - x * x there, and only absolute errors reach the sums. The
// guard: P and P + 1 are finite normal floats while |src|, |tgt| <= 20
// (e^80 < 2^116). A thread whose t tile holds a |tgt| above 20, or an s
// whose |src| is above 20, takes the precise tanhf for that tile or that s
// instead, so the result is exact to f32 either way.
//
// What bounds it on the H100: at the training shape (B, T, S, D) =
// (170, 30, 370, 256), f32, it reads src, tgt and dout and writes dsrc and
// dtgt, about 147 MB (0.044 ms at 3.35 TB/s), and does about 8 f32
// operations on each of the 483 M (b, t, s, d) elements, 3.9 G operations
// (0.058 ms at 67 TFLOP/s) if the tanh counts as one: bound by operations.
// The tanh costs more than one: its reciprocal runs on the SFU, 16 a clock
// on each SM, so 483 M of them take 0.116 ms at 1.98 GHz, and the some 7
// instructions an element issue at 128 a clock in 0.10 ms. The SFU and the
// issue slots are both near full at about 0.12 ms, 2x the bound. At 128
// registers (at D = 256) two blocks share an SM. The dtgt partials add
// 2 x 16 MB of traffic, mostly in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;              // t values a thread holds in registers
constexpr int CHUNK_MAX = 128;      // s values a block walks
constexpr int DOUT_LD = TT + 4;     // row stride of the staged dout (floats)
constexpr float GUARD = 20.f;       // |src|, |tgt| up to which the identity runs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 1 / x by the SFU's approximate reciprocal (one MUFU.RCP, about 1 ulp).
// x lies in [1, 2^116) here, so flushing subnormals is moot.
__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// src (B, S, D), tgt (B, T, D), w (D,) f32, dout (B, T, S) -> dsrc (B, S, D)
// and the partials dtgt_part (B, n_chunks, T, D) and dw_part (B, n_chunks,
// D), both f32. Grid (n_chunks, B), block D threads; chunk c covers
// s in [c * chunk, min((c + 1) * chunk, S)).
template <typename T, int D>
__global__ void __launch_bounds__(D)
copy_score_bwd_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                      const float* __restrict__ w, const T* __restrict__ dout,
                      T* __restrict__ dsrc, float* __restrict__ dtgt_part,
                      float* __restrict__ dw_part, int n_t, int n_s,
                      int chunk) {
    __shared__ __align__(16) float dsm[CHUNK_MAX * DOUT_LD];
    const int d = threadIdx.x;
    const int c = blockIdx.x;
    const int n_c = gridDim.x;
    const int b = blockIdx.y;
    const int s0 = c * chunk;
    const int ns = min(chunk, n_s - s0);
    const float wd4 = 4.f * w[d];
    const T* src_col = src + ((size_t)b * n_s + s0) * D + d;
    T* dsrc_col = dsrc + ((size_t)b * n_s + s0) * D + d;
    // dw: a compensated (Kahan) sum over s keeps its rounding near that of
    // the plain version's product
    float dw = 0.f, dw_c = 0.f;

    for (int t0 = 0; t0 < n_t; t0 += TT) {
        const int tt = min(TT, n_t - t0);
        // t past the tile's end holds tgt 0 and dout 0: it adds 0 to every
        // sum, and its dtgt value is never written
        const T* tgt_col = tgt + ((size_t)b * n_t + t0) * D + d;
        float et[TT], acc_t[TT];
        bool tile_fast = true;
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            const float tv = t < tt ? to_f32(tgt_col[(size_t)t * D]) : 0.f;
            tile_fast = tile_fast && fabsf(tv) <= GUARD;
            et[t] = expf(2.f * tv);
            acc_t[t] = 0.f;
        }
        __syncthreads();                 // the previous tile's dout is consumed
        const T* dout_bt = dout + ((size_t)b * n_t + t0) * n_s + s0;
        for (int e = threadIdx.x; e < TT * ns; e += D) {
            const int t = e / ns, s = e - t * ns;   // coalesced along s
            dsm[s * DOUT_LD + t] =
                t < tt ? to_f32(dout_bt[(size_t)t * n_s + s]) : 0.f;
        }
        __syncthreads();

        float sv = to_f32(src_col[0]);
        for (int s = 0; s < ns; ++s) {
            const float sv_next = s + 1 < ns ? to_f32(src_col[(size_t)(s + 1) * D])
                                             : 0.f;
            const float4* drow =
                reinterpret_cast<const float4*>(dsm + s * DOUT_LD);
            // the sums over the tile's t run in 2 lanes, for the
            // instructions' overlap and for shorter chains of additions;
            // h = (1 - x^2) / 4 * dout, scaled by 4 w[d] at the end
            float acc_s[2] = {0.f, 0.f};
            float dw_s[2] = {0.f, 0.f};
            if (tile_fast && fabsf(sv) <= GUARD) {
                const float es = expf(2.f * sv);
#pragma unroll
                for (int q = 0; q < TT / 4; ++q) {
                    const float4 g4 = drow[q];
                    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int t = 4 * q + k;
                        const float r = rcp_approx(fmaf(es, et[t], 1.f));
                        const float x = fmaf(-2.f, r, 1.f);
                        const float h = fmaf(-r, r, r);   // (1 - x^2) / 4
                        acc_s[k & 1] = fmaf(h, g[k], acc_s[k & 1]);
                        acc_t[t] = fmaf(h, g[k], acc_t[t]);
                        dw_s[k & 1] = fmaf(x, g[k], dw_s[k & 1]);
                    }
                }
            } else {
                // |src| or a |tgt| of the tile above GUARD: precise tanhf,
                // with tgt read again (from L1) instead of held
#pragma unroll
                for (int q = 0; q < TT / 4; ++q) {
                    const float4 g4 = drow[q];
                    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int t = 4 * q + k;
                        const float tv =
                            t < tt ? to_f32(tgt_col[(size_t)t * D]) : 0.f;
                        const float x = tanhf(sv + tv);
                        const float h = 0.25f * fmaf(-x, x, 1.f);
                        acc_s[k & 1] = fmaf(h, g[k], acc_s[k & 1]);
                        acc_t[t] = fmaf(h, g[k], acc_t[t]);
                        dw_s[k & 1] = fmaf(x, g[k], dw_s[k & 1]);
                    }
                }
            }
            const float dw_y = (dw_s[0] + dw_s[1]) - dw_c;
            const float dw_t = dw + dw_y;
            dw_c = (dw_t - dw) - dw_y;
            dw = dw_t;
            const float v = wd4 * (acc_s[0] + acc_s[1]);
            T* o = dsrc_col + (size_t)s * D;
            store(o, t0 == 0 ? v : to_f32(*o) + v);
            sv = sv_next;
        }

        float* part = dtgt_part + (((size_t)b * n_c + c) * n_t + t0) * D + d;
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            if (t < tt) part[(size_t)t * D] = acc_t[t];
        }
    }
    dw_part[((size_t)b * n_c + c) * D + d] = dw;
}

// dtgt[b, t, d] = 4 w[d] * sum over c, in order, of dtgt_part[b, c, t, d]
// (the partials hold (1 - x^2) / 4 * dout summed over s).
template <typename T>
__global__ void __launch_bounds__(256)
copy_score_bwd_dtgt_kernel(const float* __restrict__ dtgt_part,
                           const float* __restrict__ w, T* __restrict__ dtgt,
                           int n_c, int n_t, int D, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int d = (int)(i % D);
    const int64_t bt = i / D;
    const int64_t b = bt / n_t, t = bt - b * n_t;
    const float* p = dtgt_part + ((b * n_c) * n_t + t) * D + d;
    const int64_t stride = (int64_t)n_t * D;
    float sum = 0.f;
    for (int c = 0; c < n_c; ++c) sum += p[c * stride];
    store(dtgt + i, 4.f * w[d] * sum);
}

template <typename T, int D>
cudaError_t launch(const void* src, const void* tgt, const float* w,
                   const void* dout, void* dsrc, void* dtgt, float* dtgt_part,
                   float* dw_part, int B, int n_t, int n_s, int n_c, int chunk,
                   cudaStream_t stream) {
    copy_score_bwd_kernel<T, D><<<dim3(n_c, B), D, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(tgt), w,
        static_cast<const T*>(dout), static_cast<T*>(dsrc), dtgt_part,
        dw_part, n_t, n_s, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n = (int64_t)B * n_t * D;
    copy_score_bwd_dtgt_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0,
                                    stream>>>(
        dtgt_part, w, static_cast<T*>(dtgt), n_c, n_t, D, n);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* src, const void* tgt, const float* w,
                       const void* dout, void* dsrc, void* dtgt,
                       float* dtgt_part, float* dw_part, int B, int n_t,
                       int n_s, int n_c, int chunk, int D,
                       cudaStream_t stream) {
    switch (D) {
        case 64:  return launch<T, 64>(src, tgt, w, dout, dsrc, dtgt, dtgt_part, dw_part, B, n_t, n_s, n_c, chunk, stream);
        case 128: return launch<T, 128>(src, tgt, w, dout, dsrc, dtgt, dtgt_part, dw_part, B, n_t, n_s, n_c, chunk, stream);
        case 256: return launch<T, 256>(src, tgt, w, dout, dsrc, dtgt, dtgt_part, dw_part, B, n_t, n_s, n_c, chunk, stream);
        case 512: return launch<T, 512>(src, tgt, w, dout, dsrc, dtgt, dtgt_part, dw_part, B, n_t, n_s, n_c, chunk, stream);
        default:  return cudaErrorInvalidValue;
    }
}

// s values of a chunk: the chunks are as even as CHUNK_MAX allows
int chunk_len(int n_s) {
    const int n = (n_s + CHUNK_MAX - 1) / CHUNK_MAX;
    return (n_s + n - 1) / n;
}

}  // namespace

// Number of s-chunks: the partials hold (B, this, T, D) and (B, this, D)
// f32 values.
extern "C" int fira_copy_score_bwd_chunks(int n_s) {
    if (n_s <= 0) return 0;
    const int chunk = chunk_len(n_s);
    return (n_s + chunk - 1) / chunk;
}

// C entry point bound with ctypes. Pointers are device pointers to
// contiguous src (B, S, D), tgt (B, T, D), w (D,) f32, dout (B, T, S),
// dsrc (B, S, D), dtgt (B, T, D), and the f32 partials dtgt_part
// (B, n_chunks, T, D) (scratch) and dw_part (B, n_chunks, D), n_chunks =
// fira_copy_score_bwd_chunks(S); dtype 0 = float32, 1 = bfloat16 for src,
// tgt, dout, dsrc and dtgt. Launches both kernels on ``stream`` without
// synchronising and returns cudaGetLastError().
extern "C" int fira_copy_score_bwd(const void* src, const void* tgt,
                                   const void* w, const void* dout,
                                   void* dsrc, void* dtgt, void* dtgt_part,
                                   void* dw_part, int B, int n_t, int n_s,
                                   int D, int dtype, void* stream) {
    if (B <= 0 || n_t <= 0 || n_s <= 0) return (int)cudaErrorInvalidValue;
    if (B > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
    const int chunk = chunk_len(n_s);
    const int n_c = (n_s + chunk - 1) / chunk;
    const float* wf = static_cast<const float*>(w);
    float* dtp = static_cast<float*>(dtgt_part);
    float* dwp = static_cast<float*>(dw_part);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return (int)dispatch_d<float>(src, tgt, wf, dout, dsrc, dtgt, dtp, dwp,
                                      B, n_t, n_s, n_c, chunk, D, st);
    }
    if (dtype == 1) {
        return (int)dispatch_d<__nv_bfloat16>(src, tgt, wf, dout, dsrc, dtgt,
                                              dtp, dwp, B, n_t, n_s, n_c,
                                              chunk, D, st);
    }
    return (int)cudaErrorInvalidValue;
}
