// K6: the gather microbenchmark, seven kernels.
//
// Replaces the TPU kernels of scripts/bench_gather_variants.py (quad8_kernel,
// p2x5_kernel and prim_kernel_factory(op) for op in roll, gather, select,
// repeat, vshift; pallas_call in run(), bench_gather_variants.py:204).  Each
// computes, for every output pixel (y, x) of a [Hd, Wd] grid tiled in 8 x 128
// tiles (sublane s = y % 8, lane l = x % 128), a loop of PV = 17 x TAPS = 36
// steps over the source words quads [64, 256] int32, offset per step by
// taps [36, 2] int32 (in [0, 4)) and per pixel by dj and loc [Hd, Wd] int32.
// The TPU kernels reach their word through chains of roll / select / lane
// gather; the index each chain finally reads is derived here as plain index
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
// The 17 passes are not folded: the benchmark times the gather machinery
// of 612 steps a pixel, as the TPU kernel's fori_loops run it.  Every pass
// adds pass x `zero` (a kernel argument, always 0) to the per-pixel inputs,
// so neither nvcc nor ptxas can hoist a step's chain or load out of the
// pass loop (an empty asm stops nvcc, not ptxas); no two pixels share a
// chain, and prim_select runs all its selects.
//
// What bounds it on the H100: the per-step chain, not memory (4 B read and
// 4 B written a pixel, 612 steps).  A warp of 32 pixels of one row runs
// 612 warp steps: 2,976,768 at 304 x 512, ~22,551 an SM.  By the SASS
// (gather_variants.floors, which gives each variant's floor from its
// SASS and its inputs' addresses): quad8 and p2x5 are bound by issue (~29
// and ~36 instructions a step, four a clock an SM); vshift by the integer
// pipe (64 lanes a clock an SM: clamp, shifts, adds); roll, select and
// repeat by shared memory (one wavefront a clock: 7, 8 and 1 conflict-free
// loads a step); gather by its bank conflicts (random columns: ~2.3
// wavefronts a load, 8 loads a step).
//
// What the design does about it:
// - A persistent, balanced grid of 320-thread blocks: blocks = SMs x the
//   blocks an SM that fit (occupancy API, at most 48 registers for 4), or
//   fewer where the warp units fill fewer; every block is resident at
//   once.  Warp units of 32 pixels are dealt round-robin over the blocks
//   (unit u to block u mod B), so every SM holds the same number of units
//   within one and no block waits for a second wave.  A unit's row is
//   u / (Wd / 32) by a multiply (no integer divide, whose I2F / F2I would
//   use the conversion pipe).  Each block stages its rows once.
// - Each variant stages only the rows it reads, with 16-byte loads: quad8
//   rows 0-47 (48 KB: 8 T0 + 8 (u + hi) + 7 <= 47 for T0 < 4, u + hi <= 2),
//   p2x5 rows 0-31 (32 KB), the prims rows 0-31 of columns 0-127 (16 KB,
//   plus 8 words that prim_gather's discarded reads past lane 127 may
//   touch).  No variant needs more than 48 KB, so none opts in.  Staged
//   words are addressed in bytes, so a load is [register + uniform
//   register].
// - The per-tap scalars (the TPU kernel's SMEM scalars) come from a table
//   built on the host (gather_variants.tap_table) and passed in the kernel's
//   parameter block: T0, T1, the block's byte offset 4 x 8 T0 x stride, and
//   for quad8 up and 8 - up mod 8, for p2x5 2 (1 - T1 mod 3) and, for each
//   dj, the low byte of its PRMT selector (bytes 0x50 + (dj & 1), or 0x54
//   where j falls outside 0..3).  The tap loop is unrolled, so every entry
//   is a constant-bank operand: no thread computes a modulo or loads a tap.
// - Bytes to f32 without the conversion pipe (16 lanes a clock): PRMT puts
//   byte i of g into the low byte of 0x4B000000 (2^23 + b exactly), and one
//   fma(f, c, -2^23 c) gives b c rounded once, the bits of the plain
//   version's product (f c - 2^23 c = b c exactly; -2^23 c is exact).
//
// Rounding: built with nvcc -fmad=false; the f32 sums of quad8 and p2x5 run
// in the order of the plain PyTorch version (bench/gather_variants.py) and
// of the JAX kernels.  The C entries return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPV = 17;
constexpr int kTaps = 36;
constexpr int kFields = 6;       // columns of gather_variants.tap_table
constexpr int kQuadCols = 256;
constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;    // 40 warps an SM (~37 units), 48 registers
constexpr int kGatherPad = 8;    // words past the prims' block

enum Variant { QUAD8 = 0, P2X5, ROLL, GATHER, SELECT, REPEAT, VSHIFT };
// BASE: the byte offset of the tap's 8-row block; A, B, C: per variant
enum Field { T0 = 0, T1, BASE, A, B, C };

struct TapTable {
  int32_t v[kTaps][kFields];
};

// rows and columns of quads each variant stages (its stride is kCols)
template <int V> struct Staged {
  static constexpr int kRows = V == QUAD8 ? 48 : 32;
  static constexpr int kCols = V <= P2X5 ? kQuadCols : 128;
  static constexpr int kPad = V <= P2X5 ? 0 : kGatherPad;
  static constexpr size_t kBytes = (kRows * kCols + kPad) * sizeof(int32_t);
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// PRMT selectors: byte i of g, or (kZeroByte) a zero byte, under 0x4B
constexpr int kByte0 = 0x7650;
constexpr int kZeroByte = 0x7654;

// PRMT: byte i of d is byte (sel >> 4 i) & 7 of b:a (every selector here
// has the nibbles' top bits clear; __byte_perm would mask them each time)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, int sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the byte of g that `sel` selects, times c, rounded once: the PRMT gives
// the f32 2^23 + b exactly
__device__ __forceinline__ float byte_times(uint32_t g, int sel, float c) {
  const float f = __uint_as_float(prmt(g, 0x4B000000u, sel));
  return __fmaf_rn(f, c, -8388608.0f * c);
}

// the word `bytes` past p (staged quads are addressed in bytes)
__device__ __forceinline__ uint32_t word_at(const char* p, int bytes) {
  return *reinterpret_cast<const uint32_t*>(p + bytes);
}

template <int V>
__device__ __forceinline__ float float_pixel(const TapTable& tab,
                                             const char* q, int zero,
                                             int s0, int dj00, int loc00) {
  // taps lie in [0, 4): the limits change no clamp and keep the sums in int
  dj00 = clampi(dj00, -8, 8);
  loc00 = clampi(loc00, -4, 256);
  float acc = 0.0f;
#pragma unroll 1
  for (int pv = 0, off = 0; pv < kPV; ++pv, off += zero) {
    const int s = s0 + off, dj0 = dj00 + off, loc0 = loc00 + off;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int32_t* tp = tab.v[t];
      int dj = clampi(dj0 + tp[T0], 0, 7);
      const int loc = clampi(loc0 + tp[T1], 0, 255);
      // dj as a value of its own: nvcc would rebuild dj & ~1 from the clamp
      asm("" : "+r"(dj));
      float val;
      if (V == QUAD8) {
        const int n = s + dj;
        const int r = n & 7;
        const int hi = r >= tp[B] ? 1 : 0;           // B = 8 - up mod 8
        const int row = 8 * ((n >> 3) + hi) + ((r - tp[A]) & 7);  // A = up
        const uint32_t g = word_at(q + tp[BASE], (row << 10) + (loc << 2));
        val = byte_times(g, kByte0, 0.3f) + byte_times(g, kByte0 + 1, 0.2f);
        val = val + byte_times(g, kByte0 + 2, 0.25f);
        val = val + byte_times(g, kByte0 + 3, 0.25f);
      } else {
        // (s + 2 j) mod 8, j = dj / 2 - m0 + 1: A = 2 (1 - m0)
        const int row = (s + (dj & ~1) + tp[A]) & 7;
        const char* w = q + tp[BASE] + (row << 10);
        const uint32_t ga = word_at(w, loc << 2);
        const uint32_t gb = word_at(w, min(loc + 1, 255) << 2);
        // bytes 0, 1 of g >> 8 (dj & 1) are bytes (dj & 1) + 0, 1 of g; a
        // word outside 0 <= j <= 3 counts as 0: its selectors pick 0 bytes.
        // B, C hold the selector's low byte for dj = 0..7 (one PRMT)
        const int sel = 0x7600 | (prmt(tp[B], tp[C], dj) & 0xFF);
        val = byte_times(ga, sel, 0.3f) + byte_times(gb, sel, 0.2f);
        val = val + byte_times(ga, sel + 1, 0.25f);
        val = val + byte_times(gb, sel + 1, 0.25f);
      }
      acc = acc + val;
    }
  }
  return acc;
}

template <int V>
__device__ __forceinline__ float int_pixel(const TapTable& tab,
                                           const char* q, int zero,
                                           int s0, int l0, int loc00) {
  constexpr int kRollShift[8] = {1, 3, 6, 10, 15, 21, 28, 29};
  loc00 = clampi(loc00, -4, 256);
  uint32_t acc = 0u;
#pragma unroll 1
  for (int pv = 0, off = 0; pv < kPV; ++pv, off += zero) {
    const int s = (s0 + off) & 7, l = (l0 + off) & 127, loc0 = loc00 + off;
    const char* row = q + (s << 9);                // the pixel's row
    const char* pix = row + (l << 2);              // and its word
    const char* rolled[8];                         // its rolled rows' words
#pragma unroll
    for (int j = 0; j < 8; ++j)
      rolled[j] = q + ((((s - kRollShift[j]) & 7) * 128 + l) << 2);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int32_t* tp = tab.v[t];
      const int base = tp[BASE];                   // 4 x 8 T0 x 128
      const int loc = clampi(loc0 + tp[T1], 0, 127);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (V == ROLL) {
          acc += word_at(rolled[j], base);
        } else if (V == GATHER) {
          const uint32_t w = word_at(row, base + ((loc + j) << 2));
          acc += loc <= 127 - j ? w : 0x80000000u;
        } else if (V == SELECT) {
          // a load under each step's condition: with one load a tap, nvcc
          // sees that some step always writes it and keeps the last tap
          if ((loc & 7) == j) acc = word_at(pix, base);
        } else if (V == REPEAT) {
          acc += word_at(pix, base);
        } else {
          acc += word_at(pix, base) >> (((loc + j) & 3) << 3);
        }
      }
    }
  }
  return (float)(int32_t)acc;
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_kernel(const TapTable tab,
              const int32_t* __restrict__ djs,      // [Hd, Wd]
              const int32_t* __restrict__ locs,     // [Hd, Wd]
              const int32_t* __restrict__ quads_g,  // [64, 256]
              float* __restrict__ out,              // [Hd, Wd]
              int units, uint32_t row_magic, int zero) {
  using S = Staged<V>;
  extern __shared__ int4 smem4[];
  int32_t* q = reinterpret_cast<int32_t*>(smem4);
  constexpr int kVecs = S::kCols / 4;               // int4 a staged row
  for (int i = threadIdx.x; i < S::kRows * kVecs; i += kThreads)
    smem4[i] = __ldg(reinterpret_cast<const int4*>(
        quads_g + (i / kVecs) * kQuadCols) + i % kVecs);
  if (S::kPad > 0 && threadIdx.x < S::kPad)
    q[S::kRows * S::kCols + threadIdx.x] = 0;
  __syncthreads();

  // warp unit u (32 pixels of one row: Wd is a multiple of 128) goes to
  // block u mod gridDim.x, so every SM gets its share within one unit; its
  // row is u / units_per_row by a multiply (row_magic), x % 128 = p % 128
  const int lane = threadIdx.x & 31;
  for (int u = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; u < units;
       u += gridDim.x * kWarps) {
    const int p = u * 32 + lane;
    const int s = __umulhi((uint32_t)u, row_magic) & 7;
    float v;
    const char* qb = reinterpret_cast<const char*>(q);
    if (V == QUAD8 || V == P2X5)
      v = float_pixel<V>(tab, qb, zero, s, __ldg(djs + p), __ldg(locs + p));
    else
      v = int_pixel<V>(tab, qb, zero, s, p & 127, __ldg(locs + p));
    out[p] = v;
  }
}

__global__ void empty_kernel() {}

// resident blocks an SM at the variant's block size and shared memory, SMs
// (CUDA sizes each launch's shared memory carveout for occupancy)
template <int V>
cudaError_t grid_of(int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, gather_kernel<V>, kThreads, Staged<V>::kBytes);
  return err;
}

// blocks an SM: as many as fit (the occupancy API's answer), but no more
// than the units fill with a warp each, so that no block only stages
int blocks_per_sm(int fit, int sms, uint64_t units) {
  const uint64_t warps = (uint64_t)sms * kWarps;
  return (int)min((uint64_t)fit, (units + warps - 1) / warps);
}

template <int V>
int launch(const TapTable& tab, const int32_t* djs, const int32_t* locs,
           const int32_t* quads, float* out, int Hd, int Wd,
           cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_of<V>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // u / units_per_row = umulhi(u, ceil(2^32 / units_per_row)) holds for
  // u * units_per_row < 2^32
  const uint64_t upr = (uint64_t)Wd / 32, units = (uint64_t)Hd * Wd / 32;
  if (units * upr >= (1ull << 32)) return (int)cudaErrorInvalidValue;
  const uint32_t magic = (uint32_t)(((1ull << 32) + upr - 1) / upr);
  const int blocks = sms * blocks_per_sm(per_sm, sms, units);
  gather_kernel<V><<<blocks, kThreads, Staged<V>::kBytes, stream>>>(
      tab, djs, locs, quads, out, (int)units, magic, 0);
  return (int)cudaGetLastError();
}

template <int V>
int info(int units, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = grid_of<V>(out + 6, out + 1);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, gather_kernel<V>);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks_per_sm(out[6], out[1], (uint64_t)units);
  out[2] = attr.numRegs;
  out[3] = (int)Staged<V>::kBytes;
  out[4] = (int)attr.localSizeBytes;
  out[5] = kThreads;
  return 0;
}

}  // namespace

// table_host: gather_variants.tap_table(variant, taps), [36, 6] int32 in
// host memory, passed by value in the kernel's parameter block.  Hd * Wd
// is a multiple of 32 (the wrapper checks the 8 x 128 tiling).
extern "C" int launch_gather_bench(int variant, const int32_t* table_host,
                                   const int32_t* djs, const int32_t* locs,
                                   const int32_t* quads, float* out, int Hd,
                                   int Wd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hd * Wd == 0) return (int)cudaGetLastError();
  TapTable tab;
  for (int i = 0; i < kTaps * kFields; ++i) tab.v[i / kFields][i % kFields] =
      table_host[i];
  switch (variant) {
    case QUAD8: return launch<QUAD8>(tab, djs, locs, quads, out, Hd, Wd, st);
    case P2X5: return launch<P2X5>(tab, djs, locs, quads, out, Hd, Wd, st);
    case ROLL: return launch<ROLL>(tab, djs, locs, quads, out, Hd, Wd, st);
    case GATHER: return launch<GATHER>(tab, djs, locs, quads, out, Hd, Wd, st);
    case SELECT: return launch<SELECT>(tab, djs, locs, quads, out, Hd, Wd, st);
    case REPEAT: return launch<REPEAT>(tab, djs, locs, quads, out, Hd, Wd, st);
    case VSHIFT: return launch<VSHIFT>(tab, djs, locs, quads, out, Hd, Wd, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[7] for a launch over `units` warp units: blocks an SM it launches,
// SMs, registers a thread, dynamic shared memory a block (bytes), local
// memory a thread (bytes), threads a block, blocks an SM that fit
extern "C" int gather_bench_info(int variant, int units, int* out) {
  switch (variant) {
    case QUAD8: return info<QUAD8>(units, out);
    case P2X5: return info<P2X5>(units, out);
    case ROLL: return info<ROLL>(units, out);
    case GATHER: return info<GATHER>(units, out);
    case SELECT: return info<SELECT>(units, out);
    case REPEAT: return info<REPEAT>(units, out);
    case VSHIFT: return info<VSHIFT>(units, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// an empty kernel on `blocks` blocks of the K6 block size: the launch floor
extern "C" int launch_gather_bench_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
