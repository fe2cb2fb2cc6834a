// K6: the gather microbenchmark, seven kernels.
//
// Replaces the TPU kernels of scripts/bench_gather_variants.py (quad8_kernel,
// p2x5_kernel and prim_kernel_factory(op) for op in roll, gather, select,
// repeat, vshift; pallas_call in run(), bench_gather_variants.py:204).  Each
// computes, for every output pixel (y, x) of a [Hd, Wd] grid tiled in 8 x 128
// tiles (sublane s = y % 8, lane l = x % 128), a loop of PV = 17 x TAPS = 36
// steps over the source words quads [64, 256] int32, offset per step by
// taps [36, 2] int32 and per pixel by dj and loc [Hd, Wd] int32.  The TPU
// kernels reach their word through chains of roll / select / lane gather;
// the index each chain finally reads is derived here as plain index
// arithmetic (pltpu.roll is jnp.roll, pltpu.repeat is jnp.tile, an
// out-of-range lane gather reads INT32_MIN, as interpret mode gives them):
//
//   quad8:  dj = clip(dj0 + T0, 0, 7), loc = clip(loc0 + T1, 0, 255),
//           up = T1 mod 7 + 1, n = s + dj, u = n / 8, r = n % 8,
//           row = 8 T0 + 8 (u + [r >= 8 - up]) + (r - up) mod 8,
//           g = quads[row, loc];  acc += b0 0.3 + b1 0.2 + b2 0.25 + b3 0.25
//           over the bytes b0..b3 of g (f32, in that order)
//   p2x5:   dj, loc as quad8, m0 = T1 mod 3, j = dj / 2 - m0 + 1,
//           row = 8 T0 + (s + 2 j) mod 8, gA = quads[row, loc],
//           gB = quads[row, min(loc + 1, 255)] (both 0 unless 0 <= j <= 3),
//           each shifted right (logically) by 8 (dj & 1); bytes 0 and 1 of gA
//           and gB weigh 0.3, 0.25 and 0.2, 0.25
//   prim_*: loc = clip(loc0 + T1, 0, 127), blk[r] = quads[8 T0 + r, 0:128];
//           8 inner steps j; int32 sums that wrap, cast to f32 at the end:
//           roll   += blk[(s - S_j) mod 8, l], S_j = 1, 3, 6, 10, 15, 21, 28, 29
//           gather += blk[s, loc + j] (INT32_MIN past lane 127)
//           select  = blk[s, l] (the step j = loc & 7 overwrites the sum)
//           repeat += blk[s, l]
//           vshift += blk[s, l] >>> 8 ((loc + j) & 3)
//
// What bounds it on the H100: operations (integer ones for the prim
// kernels): ~25-50 per step, 612 steps per pixel, against 4 B read and 4 B
// written per pixel (plus 64 KB of quads).  At 304 x 512 that is ~2-5 G
// operations (0.03-0.07 ms at 67 TFLOP/s, counted as fp32) against 1.9 MB
// (0.0006 ms).
//
// What the design does about it: one thread per output pixel; the 64 KB of
// quads (the TPU kernel's VMEM block) are staged in shared memory once per
// block, so every step's gather is one shared-memory load.  The taps (the
// TPU kernel's SMEM scalars) travel by value in the kernel's parameters and
// are copied to shared memory beside the quads.  Above 48 KB of dynamic
// shared memory the launch opts in with cudaFuncSetAttribute.
//
// Rounding: built with nvcc -fmad=false, the f32 sums of quad8 and p2x5 run
// in the order of the plain PyTorch version (bench/gather_variants.py) and
// of the JAX kernels.  The C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPV = 17;
constexpr int kTaps = 36;
constexpr int kQuadRows = 64;
constexpr int kQuadCols = 256;
constexpr int kQuadWords = kQuadRows * kQuadCols;
constexpr int kThreads = 512;
constexpr size_t kSmem = (kQuadWords + 2 * kTaps) * sizeof(int32_t);

enum Variant { QUAD8 = 0, P2X5, ROLL, GATHER, SELECT, REPEAT, VSHIFT };

struct Taps {
  int32_t v[2 * kTaps];
};

__device__ __forceinline__ int mod_floor(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float byte_f(uint32_t g, int i) {
  return (float)((g >> (8 * i)) & 0xFFu);
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Taps taps_p,                    // [36, 2]
              const int32_t* __restrict__ djs,      // [Hd, Wd]
              const int32_t* __restrict__ locs,     // [Hd, Wd]
              const int32_t* __restrict__ quads_g,  // [64, 256]
              float* __restrict__ out,              // [Hd, Wd]
              int Hd, int Wd) {
  extern __shared__ int32_t smem[];
  int32_t* quads = smem;
  int32_t* taps = smem + kQuadWords;
  for (int i = threadIdx.x; i < kQuadWords; i += blockDim.x)
    quads[i] = __ldg(quads_g + i);
  for (int i = threadIdx.x; i < 2 * kTaps; i += blockDim.x)
    taps[i] = taps_p.v[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Hd * Wd) return;
  const int s = (p / Wd) & 7;
  const int l = (p % Wd) & 127;
  const int dj0 = __ldg(djs + p);
  const int loc0 = __ldg(locs + p);

  if (VARIANT == QUAD8 || VARIANT == P2X5) {
    float acc = 0.0f;
    for (int pv = 0; pv < kPV; ++pv) {
      for (int t = 0; t < kTaps; ++t) {
        const int T0 = taps[2 * t];
        const int T1 = taps[2 * t + 1];
        const int dj = clampi(dj0 + T0, 0, 7);
        const int loc = clampi(loc0 + T1, 0, 255);
        float val;
        if (VARIANT == QUAD8) {
          const int up = mod_floor(T1, 7) + 1;
          const int n = s + dj;
          const int r = n & 7;
          const int hi = r >= 8 - mod_floor(up, 8) ? 1 : 0;
          const int row = 8 * T0 + 8 * ((n >> 3) + hi) + mod_floor(r - up, 8);
          const uint32_t g = (uint32_t)quads[row * kQuadCols + loc];
          val = byte_f(g, 0) * 0.3f + byte_f(g, 1) * 0.2f;
          val = val + byte_f(g, 2) * 0.25f;
          val = val + byte_f(g, 3) * 0.25f;
        } else {
          const int j = (dj >> 1) - mod_floor(T1, 3) + 1;
          const bool ok = j >= 0 && j <= 3;
          const int row = 8 * T0 + ((s + 2 * j) & 7);
          const int locb = min(loc + 1, 255);
          const int sh = (dj & 1) << 3;
          const uint32_t ga =
              ok ? (uint32_t)quads[row * kQuadCols + loc] >> sh : 0u;
          const uint32_t gb =
              ok ? (uint32_t)quads[row * kQuadCols + locb] >> sh : 0u;
          // i00 = byte 0 of gA, i01 = byte 0 of gB, i10 and i11 byte 1
          val = byte_f(ga, 0) * 0.3f + byte_f(gb, 0) * 0.2f;
          val = val + byte_f(ga, 1) * 0.25f;
          val = val + byte_f(gb, 1) * 0.25f;
        }
        acc = acc + val;
      }
    }
    out[p] = acc;
    return;
  }

  constexpr int kRollShift[8] = {1, 3, 6, 10, 15, 21, 28, 29};
  uint32_t acc = 0u;
  for (int pv = 0; pv < kPV; ++pv) {
    for (int t = 0; t < kTaps; ++t) {
      const int T0 = taps[2 * t];
      const int loc = clampi(loc0 + taps[2 * t + 1], 0, 127);
      const int32_t* blk = quads + 8 * T0 * kQuadCols;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (VARIANT == ROLL) {
          acc += (uint32_t)blk[((s - kRollShift[j]) & 7) * kQuadCols + l];
        } else if (VARIANT == GATHER) {
          const int c = loc + j;
          acc += c <= 127 ? (uint32_t)blk[s * kQuadCols + c] : 0x80000000u;
        } else if (VARIANT == SELECT) {
          if ((loc & 7) == j) acc = (uint32_t)blk[s * kQuadCols + l];
        } else if (VARIANT == REPEAT) {
          acc += (uint32_t)blk[s * kQuadCols + l];
        } else {
          acc += (uint32_t)blk[s * kQuadCols + l] >> (((loc + j) & 3) << 3);
        }
      }
    }
  }
  out[p] = (float)(int32_t)acc;
}

template <int VARIANT>
int launch(const Taps& taps, const int32_t* djs, const int32_t* locs,
           const int32_t* quads, float* out, int Hd, int Wd,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_kernel<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n = Hd * Wd;
  gather_kernel<VARIANT><<<(n + kThreads - 1) / kThreads, kThreads, kSmem,
                           stream>>>(taps, djs, locs, quads, out, Hd, Wd);
  return (int)cudaGetLastError();
}

}  // namespace

// taps_host: the [36, 2] taps in host memory, passed by value to the kernel
extern "C" int launch_gather_bench(int variant, const int32_t* taps_host,
                                   const int32_t* djs, const int32_t* locs,
                                   const int32_t* quads, float* out, int Hd,
                                   int Wd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hd * Wd == 0) return (int)cudaGetLastError();
  Taps taps;
  for (int i = 0; i < 2 * kTaps; ++i) taps.v[i] = taps_host[i];
  switch (variant) {
    case QUAD8: return launch<QUAD8>(taps, djs, locs, quads, out, Hd, Wd, st);
    case P2X5: return launch<P2X5>(taps, djs, locs, quads, out, Hd, Wd, st);
    case ROLL: return launch<ROLL>(taps, djs, locs, quads, out, Hd, Wd, st);
    case GATHER: return launch<GATHER>(taps, djs, locs, quads, out, Hd, Wd, st);
    case SELECT: return launch<SELECT>(taps, djs, locs, quads, out, Hd, Wd, st);
    case REPEAT: return launch<REPEAT>(taps, djs, locs, quads, out, Hd, Wd, st);
    case VSHIFT: return launch<VSHIFT>(taps, djs, locs, quads, out, Hd, Wd, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
