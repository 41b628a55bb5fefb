// Bahdanau copy-score backward for Hopper (sm_90a). With
//
//     x[b, t, s, d] = tanh(src[b, s, d] + tgt[b, t, d])
//     g[b, t, s, d] = (1 - x^2) * w[d] * dout[b, t, s]
//
// it writes dsrc[b, s, :] = sum_t g, dtgt[b, t, :] = sum_s g and, per
// (b, block of s), a partial dw = sum_{t, s} x * dout that the Python
// wrapper sums (dbias = sum dout stays in the wrapper too).
//
// Replaces the TPU kernel fira_tpu/ops/copy_score.py:_bwd_kernel (its
// pl.pallas_call in _copy_scores_bwd at :148). Like it, this kernel never
// writes the (B, T, S, D) intermediate: it recomputes x from src and tgt.
// The TPU kernel walks S in chunks on one core and carries dtgt and dw from
// chunk to chunk; here blocks run in parallel and nothing carries over, so
// the work is split into two passes, each of which owns its output rows:
//
//   pass A  one warp per (b, s): dsrc[b, s] and the dw partial;
//   pass B  one warp per (b, t): dtgt[b, t].
//
// Both are one kernel, copy_score_bwd_kernel: a warp holds one "row"
// (src[b, s] in pass A, tgt[b, t] in pass B) and D/32 values of w in
// registers, lane l taking d = l + 32k, and walks the other tensor, which
// the block stages in shared memory tile by tile, as the forward kernel
// stages tgt. For each staged row dout is one scalar, broadcast to the
// warp. Each lane accumulates its D/32 gradient values in registers and
// writes them once; no float atomics anywhere, so the same inputs give the
// same bits on every run. The dw partials are reduced over the block's
// warps in shared memory in a fixed order and written as one (D,) row per
// (b, block); the wrapper's sum over those rows is deterministic too.
//
// What bounds it on the H100: at the training shape (B, T, S, D) =
// (170, 30, 370, 256), f32, it reads src, tgt and dout and writes dsrc and
// dtgt, about 147 MB (0.044 ms at 3.35 TB/s), and does about 8 f32
// operations on each of the 483 M (b, t, s, d) elements, 3.9 G operations
// (0.058 ms at 67 TFLOP/s): bound by operations. The precise tanhf costs
// some 20 instructions, and the two passes compute it twice, so the kernel
// is bound by instructions well above that bound; the design accepts the
// second tanh to keep every output owned by one warp. tanh.approx.f32
// (~2^-11 relative error) would break the 5e-4 agreement with the plain
// version's autograd, so it is not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // rows per block
constexpr int SMEM_FLOATS = 8192;        // 32 KB staged tile, under the 48 KB static limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows: (B, n_i, D), one per warp; cols: (B, n_j, D), staged. dout for
// (b, i, j) is at dout + b * dout_b + i * stride_i + j * stride_j.
// drow: (B, n_i, D). With WITH_DW, dw_part: (B, gridDim.x, D) f32.
template <typename T, int DPL, bool WITH_DW>
__global__ void __launch_bounds__(WARPS * 32)
copy_score_bwd_kernel(const T* __restrict__ rows, const T* __restrict__ cols,
                      const float* __restrict__ w, const T* __restrict__ dout,
                      T* __restrict__ drow, float* __restrict__ dw_part,
                      int n_i, int n_j, int64_t dout_b, int64_t stride_i,
                      int64_t stride_j, int tile_j) {
    constexpr int D = DPL * 32;
    extern __shared__ float tile[];      // (tile_j, D) f32; then (WARPS, D)
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int i = blockIdx.x * WARPS + warp;
    const bool active = i < n_i;

    float rv[DPL], wv[DPL], acc[DPL], dwacc[DPL];
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
        wv[k] = w[lane + 32 * k];
        rv[k] = 0.f;
        acc[k] = 0.f;
        dwacc[k] = 0.f;
    }
    if (active) {
        const T* row = rows + ((size_t)b * n_i + i) * D;
#pragma unroll
        for (int k = 0; k < DPL; ++k) rv[k] = to_f32(row[lane + 32 * k]);
    }
    const T* cols_b = cols + (size_t)b * n_j * D;
    const T* dout_bi = dout + b * dout_b + (active ? i : 0) * stride_i;

    for (int j0 = 0; j0 < n_j; j0 += tile_j) {
        const int jj = min(tile_j, n_j - j0);
        __syncthreads();                 // the previous tile is consumed
        for (int e = threadIdx.x; e < jj * D; e += blockDim.x) {
            tile[e] = to_f32(cols_b[(size_t)j0 * D + e]);
        }
        __syncthreads();
        if (active) {
            for (int j = 0; j < jj; ++j) {
                const float g = to_f32(dout_bi[(j0 + j) * stride_j]);
                const float* crow = tile + j * D;
#pragma unroll
                for (int k = 0; k < DPL; ++k) {
                    const float x = tanhf(rv[k] + crow[lane + 32 * k]);
                    acc[k] += (1.f - x * x) * wv[k] * g;
                    if constexpr (WITH_DW) dwacc[k] += x * g;
                }
            }
        }
    }
    if (active) {
        T* out = drow + ((size_t)b * n_i + i) * D;
#pragma unroll
        for (int k = 0; k < DPL; ++k) store(out + lane + 32 * k, acc[k]);
    }
    if constexpr (WITH_DW) {
        __syncthreads();                 // the last tile is consumed
        float* red = tile;               // (WARPS, D); inactive warps add 0
#pragma unroll
        for (int k = 0; k < DPL; ++k) red[warp * D + lane + 32 * k] = dwacc[k];
        __syncthreads();
        float* part = dw_part + ((size_t)b * gridDim.x + blockIdx.x) * D;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < WARPS; ++r) s += red[r * D + d];
            part[d] = s;
        }
    }
}

template <typename T, int DPL, bool WITH_DW>
cudaError_t launch_pass(const void* rows, const void* cols, const float* w,
                        const void* dout, void* drow, float* dw_part, int B,
                        int n_i, int n_j, int64_t dout_b, int64_t stride_i,
                        int64_t stride_j, cudaStream_t stream) {
    constexpr int D = DPL * 32;
    const int tile_j = min(n_j, SMEM_FLOATS / D);
    // the dw reduction reuses the tile as (WARPS, D)
    const int smem_rows = WITH_DW ? max(tile_j, WARPS) : tile_j;
    const dim3 grid((n_i + WARPS - 1) / WARPS, B);
    copy_score_bwd_kernel<T, DPL, WITH_DW>
        <<<grid, WARPS * 32, (size_t)smem_rows * D * sizeof(float), stream>>>(
            static_cast<const T*>(rows), static_cast<const T*>(cols), w,
            static_cast<const T*>(dout), static_cast<T*>(drow), dw_part, n_i,
            n_j, dout_b, stride_i, stride_j, tile_j);
    return cudaGetLastError();
}

template <typename T, int DPL>
cudaError_t launch(const void* src, const void* tgt, const float* w,
                   const void* dout, void* dsrc, void* dtgt, float* dw_part,
                   int B, int n_t, int n_s, cudaStream_t stream) {
    const int64_t dout_b = (int64_t)n_t * n_s;
    // pass A: a warp per (b, s) walks t; dout[b, t, s] = s * 1 + t * n_s
    cudaError_t err = launch_pass<T, DPL, true>(
        src, tgt, w, dout, dsrc, dw_part, B, n_s, n_t, dout_b, 1, n_s, stream);
    if (err != cudaSuccess) return err;
    // pass B: a warp per (b, t) walks s; dout[b, t, s] = t * n_s + s * 1
    return launch_pass<T, DPL, false>(
        tgt, src, w, dout, dtgt, nullptr, B, n_t, n_s, dout_b, n_s, 1, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* src, const void* tgt, const float* w,
                       const void* dout, void* dsrc, void* dtgt,
                       float* dw_part, int B, int n_t, int n_s, int D,
                       cudaStream_t stream) {
    switch (D) {
        case 64:  return launch<T, 2>(src, tgt, w, dout, dsrc, dtgt, dw_part, B, n_t, n_s, stream);
        case 128: return launch<T, 4>(src, tgt, w, dout, dsrc, dtgt, dw_part, B, n_t, n_s, stream);
        case 256: return launch<T, 8>(src, tgt, w, dout, dsrc, dtgt, dw_part, B, n_t, n_s, stream);
        case 512: return launch<T, 16>(src, tgt, w, dout, dsrc, dtgt, dw_part, B, n_t, n_s, stream);
        default:  return cudaErrorInvalidValue;
    }
}

}  // namespace

// Number of s-blocks of pass A: dw_part holds (B, this, D) f32 values.
extern "C" int fira_copy_score_bwd_s_blocks(int n_s) {
    return (n_s + WARPS - 1) / WARPS;
}

// C entry point bound with ctypes. Pointers are device pointers to
// contiguous src (B, S, D), tgt (B, T, D), w (D,) f32, dout (B, T, S),
// dsrc (B, S, D), dtgt (B, T, D) and dw_part (B, s_blocks, D) f32; dtype
// 0 = float32, 1 = bfloat16 for src, tgt, dout, dsrc and dtgt. Launches
// both passes on ``stream`` without synchronising and returns
// cudaGetLastError().
extern "C" int fira_copy_score_bwd(const void* src, const void* tgt,
                                   const void* w, const void* dout,
                                   void* dsrc, void* dtgt, void* dw_part,
                                   int B, int n_t, int n_s, int D, int dtype,
                                   void* stream) {
    if (B <= 0 || n_t <= 0 || n_s <= 0) return (int)cudaErrorInvalidValue;
    if (B > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
    const float* wf = static_cast<const float*>(w);
    float* dwp = static_cast<float*>(dw_part);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return (int)dispatch_d<float>(src, tgt, wf, dout, dsrc, dtgt, dwp, B,
                                      n_t, n_s, D, st);
    }
    if (dtype == 1) {
        return (int)dispatch_d<__nv_bfloat16>(src, tgt, wf, dout, dsrc, dtgt,
                                              dwp, B, n_t, n_s, D, st);
    }
    return (int)cudaErrorInvalidValue;
}
