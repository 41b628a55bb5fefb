// Bahdanau copy-score forward for Hopper (sm_90a):
//
//     out[b, t, s] = sum_d w[d] * tanh(src[b, s, d] + tgt[b, t, d])
//
// Replaces the TPU kernel fira_tpu/ops/copy_score.py:_copy_scores_fwd_impl
// (pl.pallas_call at :119, body _fwd_kernel at :56-73). Like it, this kernel
// never writes the (B, T, S, D) tanh intermediate: it reads src and tgt once
// and writes only the (B, T, S) scores. The tanh and the dot run in f32
// whatever the input type; the output is in src's type. The bias is added by
// the Python wrapper, as the JAX code adds it outside its kernel.
//
// What bounds it on the H100: at the decode shape (B=60, T=1, S=370, D=256,
// f32) it must read src, 22.7 MB, and does 5.7 M tanh, so it is bound by
// memory (about 6.8 us at 3.35 TB/s). At the training shape (T=30) the
// tanh count grows 30-fold while the bytes barely move.
//
// Design (simple and right first): one warp per (b, s). Each lane holds
// D/32 values of src[b, s, :] and of w in registers, loaded coalesced
// (lane l takes d = l + 32k). A block of WARPS warps shares one b and stages
// tgt[b, t0:t0+tt, :] in shared memory, tile by tile over t; every warp then
// walks the tile's t, forms its D/32 partial products per lane, reduces them
// across the warp with __shfl_xor_sync, and lane 0 writes out[b, t, s].
// The ragged edge of S (370 is not a multiple of WARPS) is masked per warp;
// masked warps still take part in the block's barriers. tanhf is the
// precise libm version: tanh.approx.f32's ~2^-11 relative error would break
// the 1e-5 agreement with the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // (b, s) rows per block
constexpr int SMEM_FLOATS = 8192;        // 32 KB tgt tile, under the 48 KB static limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
copy_score_fwd_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                      const float* __restrict__ w, T* __restrict__ out,
                      int n_t, int n_s, int tile_t) {
    constexpr int D = DPL * 32;
    extern __shared__ float tgt_tile[];   // (tile_t, D) f32
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int s = blockIdx.x * WARPS + warp;
    const bool active = s < n_s;

    float sv[DPL], wv[DPL];
    if (active) {
        const T* row = src + ((size_t)b * n_s + s) * D;
#pragma unroll
        for (int k = 0; k < DPL; ++k) {
            sv[k] = to_f32(row[lane + 32 * k]);
            wv[k] = w[lane + 32 * k];
        }
    }
    const T* tgt_b = tgt + (size_t)b * n_t * D;
    T* out_b = out + (size_t)b * n_t * n_s;

    for (int t0 = 0; t0 < n_t; t0 += tile_t) {
        const int tt = min(tile_t, n_t - t0);
        __syncthreads();                 // the previous tile is consumed
        for (int i = threadIdx.x; i < tt * D; i += blockDim.x) {
            tgt_tile[i] = to_f32(tgt_b[(size_t)t0 * D + i]);
        }
        __syncthreads();
        if (active) {
            for (int t = 0; t < tt; ++t) {
                const float* trow = tgt_tile + t * D;
                float acc = 0.f;
#pragma unroll
                for (int k = 0; k < DPL; ++k) {
                    acc += wv[k] * tanhf(sv[k] + trow[lane + 32 * k]);
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    acc += __shfl_xor_sync(0xffffffffu, acc, off);
                }
                if (lane == 0) {
                    store(out_b + (size_t)(t0 + t) * n_s + s, acc);
                }
            }
        }
    }
}

template <typename T, int DPL>
cudaError_t launch(const void* src, const void* tgt, const float* w, void* out,
                   int B, int n_t, int n_s, cudaStream_t stream) {
    constexpr int D = DPL * 32;
    const int tile_t = min(n_t, SMEM_FLOATS / D);
    const dim3 grid((n_s + WARPS - 1) / WARPS, B);
    const size_t smem = (size_t)tile_t * D * sizeof(float);
    copy_score_fwd_kernel<T, DPL><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(tgt), w,
        static_cast<T*>(out), n_t, n_s, tile_t);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* src, const void* tgt, const float* w,
                       void* out, int B, int n_t, int n_s, int D,
                       cudaStream_t stream) {
    switch (D) {
        case 64:  return launch<T, 2>(src, tgt, w, out, B, n_t, n_s, stream);
        case 128: return launch<T, 4>(src, tgt, w, out, B, n_t, n_s, stream);
        case 256: return launch<T, 8>(src, tgt, w, out, B, n_t, n_s, stream);
        case 512: return launch<T, 16>(src, tgt, w, out, B, n_t, n_s, stream);
        default:  return cudaErrorInvalidValue;
    }
}

}  // namespace

// C entry point bound with ctypes. Pointers are device pointers to
// contiguous src (B, S, D), tgt (B, T, D), w (D,) f32 and out (B, T, S);
// dtype 0 = float32, 1 = bfloat16 for src, tgt and out. Launches on
// ``stream`` without synchronising and returns cudaGetLastError().
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
