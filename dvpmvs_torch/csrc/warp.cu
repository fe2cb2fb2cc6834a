// K5: the warped source field of one plane field.
//
// Replaces the TPU kernel dvpmvs/kernels/sweep_pallas.py::warp_field_pallas
// (_make_warpfield_kernel, pallas_call at sweep_pallas.py:408), which
// computes the function of dvpmvs/kernels/ncc.py::warp_field: for every
// reference pixel p = (x, y) and source view v, with the ray
// (rx, ry) = ((x - cx) / fx, (y - cy) / fy) and the plane (n, w) at p,
//   s    = (n0 rx + n1 ry + n2) / w
//   base = M_v (rx, ry, 1) - b_v s
//   (px, py) = base.xy / guard(base.z)
//   warped[v, p]  = bilinear sample of source v at (px, py), clamped to the
//                   image (a NaN coordinate reads pixel 0 and gives NaN)
//   in_view[v, p] = 0 <= px < src_w && 0 <= py < src_h && base.z > 0.
// It is the one gather of the "warp" cost backend: every plane that backend
// evaluates is warped once, and the 36 NCC taps read the field at static
// shifts.
//
// What bounds it on the H100: bytes.  Per pixel it reads the plane field
// (16 B) and writes V x (4 + 1) B; it reads the fp32 sources (19.5 MB at
// 608 x 800, V = 10, inside the 50 MB L2) at four neighbouring pixels per
// (view, pixel).  At that size the function moves ~52 MB (0.015 ms at
// 3.35 TB/s) against ~45 fp32 operations per (view, pixel), 0.22 G in all
// (0.003 ms at 67 TFLOP/s).
//
// What the design does about it: one thread per pixel forms the ray and s
// once and loops over the views, so neighbouring threads write neighbouring
// words of each view's output plane (coalesced) and gather neighbouring
// source pixels (a locally smooth warp); the per-view constants M, b and the
// source extents are read through the read-only cache.  None of the TPU
// kernel's storage workarounds is kept: no u8 packed quads, no DSPAN row
// band, no 8 x 128 tiles, no view chunks, and the plane enters as (n, w),
// not as an inverse depth, so s is formed in the plain version's order.
//
// Rounding: built with nvcc -fmad=false and IEEE divides, every product and
// sum is formed in the order of the plain PyTorch version
// (warp_fused.warp_field_plain), so the two agree bitwise.  The C entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float guard(float z) {
  return fabsf(z) < 1e-12f ? 1e-12f : z;
}

// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// bilinear sample of img [H, W] at (x, y), border-clamped; a NaN
// coordinate reads index 0 and yields NaN, as the plain version
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                         float x, float y, int H, int W) {
  x = clampf(x, 0.0f, (float)(W - 1));
  y = clampf(y, 0.0f, (float)(H - 1));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int x0i = isnan(x0) ? 0 : (int)x0;
  const int y0i = isnan(y0) ? 0 : (int)y0;
  const int x1i = min(x0i + 1, W - 1);
  const int y1i = min(y0i + 1, H - 1);
  const float i00 = __ldg(img + (size_t)y0i * W + x0i);
  const float i01 = __ldg(img + (size_t)y0i * W + x1i);
  const float i10 = __ldg(img + (size_t)y1i * W + x0i);
  const float i11 = __ldg(img + (size_t)y1i * W + x1i);
  const float top = i00 * (1.0f - fx) + i01 * fx;
  const float bot = i10 * (1.0f - fx) + i11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// mats layout (12 floats per view): M (9, row-major), b (3)
__global__ void __launch_bounds__(256)
warp_kernel(const float* __restrict__ plane,   // [H, W, 4] (n, w)
            const float* __restrict__ src,     // [V, H, W]
            const float* __restrict__ mats,    // [V, 12]
            const float* __restrict__ cam,     // [4] cx, cy, fx, fy
            const float* __restrict__ src_wh,  // [V, 2]
            float* __restrict__ warped,        // [V, H, W]
            uint8_t* __restrict__ in_view,     // [V, H, W]
            int V, int H, int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (p >= HW) return;
  const float xs = (float)(p % W);
  const float ys = (float)(p / W);
  const float rx = (xs - __ldg(cam + 0)) / __ldg(cam + 2);
  const float ry = (ys - __ldg(cam + 1)) / __ldg(cam + 3);
  const float4 pl = __ldg(reinterpret_cast<const float4*>(plane) + p);
  const float s = (pl.x * rx + pl.y * ry + pl.z) / pl.w;
  for (int v = 0; v < V; ++v) {
    const float* m = mats + v * 12;
    const float b0 = (__ldg(m + 0) * rx + __ldg(m + 1) * ry + __ldg(m + 2)) -
                     __ldg(m + 9) * s;
    const float b1 = (__ldg(m + 3) * rx + __ldg(m + 4) * ry + __ldg(m + 5)) -
                     __ldg(m + 10) * s;
    const float b2 = (__ldg(m + 6) * rx + __ldg(m + 7) * ry + __ldg(m + 8)) -
                     __ldg(m + 11) * s;
    const float cz = guard(b2);
    const float px = b0 / cz;
    const float py = b1 / cz;
    const bool iv = px >= 0.0f && px < __ldg(src_wh + 2 * v) && py >= 0.0f &&
                    py < __ldg(src_wh + 2 * v + 1) && b2 > 0.0f;
    warped[(size_t)v * HW + p] = bilinear(src + (size_t)v * HW, px, py, H, W);
    in_view[(size_t)v * HW + p] = iv ? 1 : 0;
  }
}

}  // namespace

extern "C" int launch_warp(const float* plane, const float* src,
                           const float* mats, const float* cam,
                           const float* src_wh, float* warped,
                           uint8_t* in_view, int V, int H, int W,
                           void* stream) {
  const int n = H * W;
  const int threads = 256;
  if (n == 0) return (int)cudaGetLastError();
  warp_kernel<<<(n + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(plane, src, mats, cam, src_wh,
                                        warped, in_view, V, H, W);
  return (int)cudaGetLastError();
}
