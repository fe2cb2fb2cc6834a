// K5: the warped source field of one plane field, and the "warp" cost
// backend's whole NCC of a batch of plane fields built on it.
//
// launch_warp replaces the TPU kernel
// dvpmvs/kernels/sweep_pallas.py::warp_field_pallas (_make_warpfield_kernel,
// pallas_call at sweep_pallas.py:408), which computes the function of
// dvpmvs/kernels/ncc.py::warp_field: for every reference pixel p = (x, y)
// and source view v, with the ray (rx, ry) = ((x - cx) / fx, (y - cy) / fy)
// and the plane (n, w) at p,
//   s    = (n0 rx + n1 ry + n2) / w
//   base = M_v (rx, ry, 1) - b_v s
//   (px, py) = base.xy / guard(base.z)
//   warped[v, p]  = bilinear sample of source v at (px, py), clamped to the
//                   image (a NaN coordinate reads pixel 0 and gives NaN)
//   in_view[v, p] = 0 <= px < src_w && 0 <= py < src_h && base.z > 0.
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
// launch_warp_ncc is the "warp" backend's cost of a candidate batch,
// planes [B, H, W, 4] -> cost [B, H, W, V] (or a window of rows: the
// planes and costs of image rows (y0 + i) mod H, i < Hin, the taps
// wrapping within them; the tiled pass gives its window a halo of rows, so
// that the taps of its own rows read real rows): the function of JAX's
// dvpmvs/kernels/ncc.py::_ncc_cost_warp for each plane, i.e. K5's warped
// field followed by the XLA moment sums that read it at the 36 taps' static
// integer shifts (dx_t, dy_t) of the static radius, wrapping at the image
// border (shift2), and the NCC tail:
//   s1[v, p] = sum_t w_t(p) W_v(p + d_t),  s2 = sum_t w_t(p) W_v(p + d_t)^2,
//   s3[v, p] = sum_t wref_t(p) W_v(p + d_t), summed in tap order,
//   cost = clamp(1 - NCC, 0, 2); 2 on a variance < 1e-5 or out of view.
// The tap at p + d sees the warp of the plane at p + d, not at p.
//
// What bounds it on the H100: operations.  Per (plane, pixel, view) the
// function needs the warp (~46 operations), 36 taps of 3 moment updates
// (216) and the tail (~19); the weights (288 B a pixel), the sources and the
// reference sums are shared by every plane.  At B = 17, 608 x 800, V = 10
// that is ~23 GFLOP (0.35 ms at 67 TFLOP/s) against ~630 MB of inputs and
// outputs (0.19 ms at 3.35 TB/s).  The plain version (K5, then ~250
// elementwise launches a plane, each a [V, H, W] pass through device
// memory) moves ~14 GB a plane.
//
// The design: one launch a batch; one block of 16 x 32 threads, one thread a
// pixel, per (plane, 16 x 32 tile), the planes of one tile in neighbouring
// blocks so that the tile's weights are read from device memory about once
// and from L2 by the other planes.  For a chunk of kVC = 5 views at a time
// the block warps its tile and a halo of h = max |shift| (5 at r = 5) on
// each side into shared memory, every halo pixel under its own plane and
// at its wrapped coordinates, with K5's own device functions (so the field
// is bit for bit K5's), and keeps the tile's in-view flags beside it.  Then
// each thread runs the 36 taps (unrolled: the shifts, computed once on the
// host with the plain version's int(round(g r)) and passed by value, become
// immediate offsets), loads the tap's two weights once, coalesced along x,
// and updates its 3 x kVC moment sums in registers from shared memory, each
// view's sums in tap order.  The costs of all V views wait in shared memory
// and leave as whole [32 x V] rows of the output (coalesced).  At r = 5 and
// V = 10 a block holds 21.8 KB of fields, 20.5 KB of costs and 2.5 KB of
// flags; up to 227 KB the launch opts in to dynamic shared memory, beyond it
// (at V = 10 a halo above 39) the wrapper refuses the call.
//
// -Xptxas -v: 64 registers under __launch_bounds__(512, 2), 40 bytes of
// spills (local memory, in L1), two blocks (32 warps) an SM.  Without the
// cap ptxas takes 128 registers and no spills, one block (16 warps) an SM,
// so the halo's warp (dependent gathers) of one block cannot overlap the
// taps (arithmetic) of another; the cap buys that overlap for 40 bytes of
// spills.  The halo makes the warp 2.1x the tile's own, and
// without contraction each moment update is two instructions: by a count of
// the source ~500 instructions a (plane, pixel, view) against the bound's
// 280 operations.
//
// Rounding: built with nvcc -fmad=false and IEEE divides and square root,
// every product and sum is formed in the order of the plain PyTorch versions
// (warp_fused.warp_field_plain, warp_fused.warp_ncc_plain), so the kernels
// agree with them bitwise.  Each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 36;
constexpr int kTX = 32;              // tile width (one warp a row)
constexpr int kTY = 16;              // tile height
constexpr int kPix = kTX * kTY;      // threads a block
constexpr int kVC = 5;               // views warped into shared memory at once
constexpr int kMinBlocks = 2;        // blocks an SM must hold (caps registers)
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block may have
constexpr float kCostMax = 2.0f;
constexpr float kMinVar = 1e-5f;

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

// The ray (rx, ry) of image pixel (x, y) and the plane term s of the plane
// field [., W, 4] (n, w) at its row yp.
__device__ __forceinline__ void ray_plane(const float* __restrict__ plane,
                                          const float* __restrict__ cam,
                                          int x, int y, int yp, int W,
                                          float& rx, float& ry, float& s) {
  rx = ((float)x - __ldg(cam + 0)) / __ldg(cam + 2);
  ry = ((float)y - __ldg(cam + 1)) / __ldg(cam + 3);
  const float4 pl =
      __ldg(reinterpret_cast<const float4*>(plane) + (size_t)yp * W + x);
  s = (pl.x * rx + pl.y * ry + pl.z) / pl.w;
}

// The warped value of source v at the ray (rx, ry) under the plane term s,
// and its in-view flag.  mats layout (12 floats per view): M (9, row-major),
// b (3).
__device__ __forceinline__ float warp_view(const float* __restrict__ src,
                                           const float* __restrict__ mats,
                                           const float* __restrict__ src_wh,
                                           int v, float rx, float ry,
                                           float s, int H, int W, bool& iv) {
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
  iv = px >= 0.0f && px < __ldg(src_wh + 2 * v) && py >= 0.0f &&
       py < __ldg(src_wh + 2 * v + 1) && b2 > 0.0f;
  return bilinear(src + (size_t)v * H * W, px, py, H, W);
}

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
  float rx, ry, s;
  ray_plane(plane, cam, p % W, p / W, p / W, W, rx, ry, s);
  for (int v = 0; v < V; ++v) {
    bool iv;
    warped[(size_t)v * HW + p] =
        warp_view(src, mats, src_wh, v, rx, ry, s, H, W, iv);
    in_view[(size_t)v * HW + p] = iv ? 1 : 0;
  }
}

// The 36 taps' integer shifts, tap t reading the field at (x + dx[t],
// y + dy[t]), and the halo they need.
struct TapShifts {
  int dx[kTaps];
  int dy[kTaps];
  int halo;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The rows are image rows (y0 + i) mod H, i < Hin (the whole image: y0 = 0,
// Hin = H).  A tap row wraps within them: the image's wrap for the whole
// image, a real neighbouring row for a window's rows that have a halo.
__global__ void __launch_bounds__(kPix, kMinBlocks)
warp_ncc_kernel(const float* __restrict__ planes,     // [B, Hin, W, 4]
                const float* __restrict__ src,        // [V, H, W]
                const float* __restrict__ mats,       // [V, 12]
                const float* __restrict__ cam,        // [4]
                const float* __restrict__ src_wh,     // [V, 2]
                const float* __restrict__ w_taps,     // [36, Hin, W]
                const float* __restrict__ wref_taps,  // [36, Hin, W]
                const float* __restrict__ sum_w,      // [Hin, W]
                const float* __restrict__ sum_wref,   // [Hin, W]
                const float* __restrict__ sum_wref2,  // [Hin, W]
                const TapShifts sh,
                float* __restrict__ out,              // [B, Hin, W, V]
                int V, int H, int W, int Hin, int y0) {
  extern __shared__ float smem[];
  const int h = sh.halo;
  const int RX = kTX + 2 * h;                 // region: tile and halo
  const int RY = kTY + 2 * h;
  const int NR = RX * RY;
  float* field = smem;                        // [kVC][RY][RX]
  float* stage = field + kVC * NR;            // [kPix][V]
  uint8_t* flags = reinterpret_cast<uint8_t*>(stage + kPix * V);  // [kVC][kPix]

  const int b = blockIdx.x;
  const int x0 = blockIdx.y * kTX;
  const int y0t = blockIdx.z * kTY;
  const int tid = threadIdx.x;
  const int lx = tid % kTX;
  const int ly = tid / kTX;
  const int x = x0 + lx;
  const int y = y0t + ly;
  const bool active = x < W && y < Hin;
  const int HW = Hin * W;
  const int p = active ? y * W + x : 0;
  const float* plane = planes + (size_t)b * Hin * W * 4;

  // the reference side of the NCC, in the plain version's order
  const float inv = 1.0f / sum_w[p];
  const float m_ref = sum_wref[p] * inv;
  const float m_ref2 = sum_wref2[p] * inv;
  const float var_ref = m_ref2 - m_ref * m_ref;

  for (int v0 = 0; v0 < V; v0 += kVC) {
    const int nv = min(kVC, V - v0);
    // warp the region: every pixel under its own plane, wrapped as shift2
    for (int i = tid; i < NR; i += kPix) {
      const int ry_ = i / RX;
      const int rx_ = i - ry_ * RX;
      float rx, ry, s;
      const int yp = wrap(y0t - h + ry_, Hin);
      ray_plane(plane, cam, wrap(x0 - h + rx_, W), wrap(y0 + yp, H), yp, W,
                rx, ry, s);
      const int ty = ry_ - h;
      const int tx = rx_ - h;
      const bool center = ty >= 0 && ty < kTY && tx >= 0 && tx < kTX;
      for (int j = 0; j < nv; ++j) {
        bool iv;
        field[j * NR + i] =
            warp_view(src, mats, src_wh, v0 + j, rx, ry, s, H, W, iv);
        if (center) flags[j * kPix + ty * kTX + tx] = iv ? 1 : 0;
      }
    }
    __syncthreads();

    if (active) {
      float s1[kVC], s2[kVC], s3[kVC];
#pragma unroll
      for (int j = 0; j < kVC; ++j) s1[j] = s2[j] = s3[j] = 0.0f;
      const float* f0 = field + (ly + h) * RX + (lx + h);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const float wt = __ldg(w_taps + (size_t)t * HW + p);
        const float wr = __ldg(wref_taps + (size_t)t * HW + p);
        const float* f = f0 + sh.dy[t] * RX + sh.dx[t];
#pragma unroll
        for (int j = 0; j < kVC; ++j) {
          // a view past V reads a stale slot; its sums are never used
          const float val = f[j * NR];
          const float wv = wt * val;
          s1[j] = s1[j] + wv;
          s2[j] = s2[j] + wv * val;
          s3[j] = s3[j] + wr * val;
        }
      }
#pragma unroll
      for (int j = 0; j < kVC; ++j) {
        if (j >= nv) break;
        const float m_src = s1[j] * inv;
        const float m_src2 = s2[j] * inv;
        const float m_refsrc = s3[j] * inv;
        const float var_src = m_src2 - m_src * m_src;
        const float covar = m_refsrc - m_ref * m_src;
        float vp = var_ref * var_src;
        vp = __fsqrt_rn(vp < 0.0f ? 0.0f : vp);
        const float ncc = covar / (vp < 1e-30f ? 1e-30f : vp);
        float cost = clampf(1.0f - ncc, 0.0f, kCostMax);
        if (var_ref < kMinVar || var_src < kMinVar || !flags[j * kPix + tid])
          cost = kCostMax;
        stage[tid * V + v0 + j] = cost;
      }
    }
    __syncthreads();
  }

  // each tile row's [32, V] costs are one contiguous run of out
  const int run = kTX * V;
  float* o = out + (size_t)b * HW * V;
  for (int i = tid; i < kTY * run; i += kPix) {
    const int r = i / run;
    const int c = i - r * run;
    if (y0t + r < Hin && x0 + c / V < W)
      o[((size_t)(y0t + r) * W + x0) * V + c] = stage[i];
  }
}

// Shared memory of a warp_ncc_kernel block, -1 above the most a block may
// have.
int ncc_smem_bytes(int V, int halo) {
  const long long region = (long long)(kTX + 2 * halo) * (kTY + 2 * halo);
  const long long bytes = 4 * (kVC * region + (long long)kPix * V) +
                          (long long)kVC * kPix;
  return bytes > kMaxSmem ? -1 : (int)bytes;
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

// The shared memory launch_warp_ncc would give a block at V views and this
// halo, or -1 where it exceeds 227 KB and launch_warp_ncc refuses the call.
extern "C" int warp_ncc_smem_bytes(int V, int halo) {
  return ncc_smem_bytes(V, halo);
}

// shifts_host: the taps' [2, 36] integer shifts (dx row, then dy row) in
// host memory, passed by value to the kernel
extern "C" int launch_warp_ncc(const float* planes, const float* src,
                               const float* mats, const float* cam,
                               const float* src_wh, const float* w_taps,
                               const float* wref_taps, const float* sum_w,
                               const float* sum_wref, const float* sum_wref2,
                               const int32_t* shifts_host, float* out, int B,
                               int V, int H, int W, int Hin, int y0,
                               void* stream) {
  TapShifts sh;
  sh.halo = 0;
  for (int t = 0; t < kTaps; ++t) {
    sh.dx[t] = shifts_host[t];
    sh.dy[t] = shifts_host[kTaps + t];
    sh.halo = max(sh.halo, max(abs(sh.dx[t]), abs(sh.dy[t])));
  }
  const int bytes = ncc_smem_bytes(V, sh.halo);
  if (V < 1 || H < 1 || W < 1 || B < 0 || bytes < 0 || Hin < 1 ||
      Hin > H || y0 <= -H || y0 >= H)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  static bool ready = false;   // the attribute is set once, to the most
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_ncc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(B, (W + kTX - 1) / kTX, (Hin + kTY - 1) / kTY);
  warp_ncc_kernel<<<grid, kPix, bytes, (cudaStream_t)stream>>>(
      planes, src, mats, cam, src_wh, w_taps, wref_taps, sum_w, sum_wref,
      sum_wref2, sh, out, V, H, W, Hin, y0);
  return (int)cudaGetLastError();
}
