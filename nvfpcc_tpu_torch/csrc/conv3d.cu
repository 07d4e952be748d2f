// Direct stride-1 3-D convolution (torch semantics: a cross-correlation
// with zero padding, NDHWC activations, DHWIO kernel, one group, dilation
// 1), f32, for Hopper (sm_90a). On the card it runs the forward of every
// f32 direct conv of the port: the decoder's conv1 and conv2 (k4 valid,
// 8 -> 8), conv2_cls (k3 same, 8 -> 1) and, in f32 training, the aux heads;
// the latent generator (k1); the ctx predictor's masked convs (k3 same on
// the 2^3 latent, the mask already folded into the kernel).
//
// Replaces no TPU kernel: the JAX package left these convs to XLA. It was
// added because cuDNN ran the f32 forward (deterministic, TF32 off, as the
// decode needs for encode == decode bit for bit) as
// `implicit_convolveNd_sgemm` at about 4% of the card's f32 FFMA rate: 71%
// of a vox10 decode's wall time and 74% of a vox11 decode's.
//
// What bounds it on this card. conv2 does 134.2 M multiply-adds a block and
// moves 2.4 MB (35^3 x 8 in, 32^3 x 8 out, f32): at 128 blocks 0.513 ms of
// FFMA at 67 TFLOP/s against 0.092 ms of bytes at 3.35 TB/s. The FFMA pipe
// bounds it, so the design keeps the pipe issuing and loads out of the
// inner loop.
//
// The design:
//   - register blocking: a thread owns a strip of R outputs along W for
//     every output channel of its tile (COT): R x COT f32 sums in
//     registers. For each (kd, ci, kh) it loads the strip's R + k - 1
//     inputs once, as float4s from shared memory, and reuses each across
//     the k kw taps and all COT channels: at R = 8, k = 4, COT = 8 three
//     loads of 16 bytes and 8 weight loads feed 256 FFMAs.
//   - uniform weights: every thread of a CTA walks the same tap sequence,
//     so a weight load is a broadcast float4 from shared memory (one
//     wavefront a warp, no bank conflict). Weights in the constant bank
//     would need every tap unrolled to an immediate offset (conv2: 32 K
//     FFMAs of straight code a thread, far past the instruction cache), so
//     shared memory it is.
//   - input tile: a CTA takes a tile of TD x TH output rows of SW strips,
//     one tile of COT output channels, and one block, or TN blocks where one
//     tile covers a block (the 2^3 latent's convs), so that their weights
//     are staged once for many blocks. It stages each block's input halo
//     ((TD + k - 1) x (TH + k - 1) x (SW R + k - 1)) in shared memory,
//     channel-planar, rows padded to RS floats with RS / 4 odd, so that the
//     8 threads of a 16-byte load phase (4 strips x 2 rows) hit distinct
//     banks; and the weights of its channel tile, [kd][ci][kh][kw][COT].
//     Cin that does not fit the budget is staged in chunks. The launch
//     bound holds a thread to 128 registers, so that four CTAs of 128
//     threads (16 warps) share an SM and hide each other's staging.
//   - shapes: four instantiations, chosen by the wrapper from (k, Cout):
//     k4 with COT 8, R 8 (conv1, conv2, and any k4 plan); k3 with Cout 1,
//     COT 1, R 8 (the k3 heads); k3 with COT 4, R 1 (the ctx convs); and a
//     generic one with k at run time, COT 4, R 1 (the latent generator, any
//     other shape). The R 1 ones stage only the weights and read each
//     tap's input from device memory: a 2^3 block's halo would be 8 times
//     its inputs, all of which stay in L1, and with few outputs a block the
//     sums are spread over many threads, each a short chain. Stride is 1:
//     the wrapper refuses others.
//   - arithmetic: f32 FFMA with an f32 sum; the f32 bias is added in the
//     epilogue. Each output's sum runs in one fixed order (Cin chunk, kd,
//     ci, kh, kw), with no atomics and no split over CTAs; the plan depends
//     on the layer's shape only, never on the batch, so a block's output
//     bits do not depend on the other blocks of the call or on the process.
// The host entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kStageBatch = 4;  // halo loads a thread has in flight

struct Params {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  long long n;
  int cin, cout, k, pad;
  int din, hin, win, dout, hout, wout;
  int tn, td, th, sw;  // a CTA's outputs: tn blocks x td planes x th rows x sw strips of R along W
  int ntd, nth, ntw;   // tiles along D, H, W
  int cic;             // Cin staged at once
  int hd, hh, rs;      // a block's staged halo: planes, rows, row stride (floats)
  int wsz;             // floats of the staged weights, a multiple of 4
  int vec;             // Cin rows can be staged as float4s
};

// Stage the halos of blocks [n0, n0 + tn) for Cin chunk [ci0, ci0 + cic),
// each from (gd0, gh0, gw0) on, zero outside the input and past the last
// block, channel-planar, V channels a load. A thread walks the halo in
// steps of the CTA's threads, its (block, plane, row, column) advanced
// digit by digit (no division in the loop), and issues kStageBatch loads
// before it stores them, so that they are in flight together.
template <int V>
__device__ __forceinline__ void stage_halo(const Params& p, float* xs, long long n0, int gd0, int gh0, int gw0,
                                           int ci0, int cic) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rs = p.rs, hh = p.hh, hd = p.hd;
  const int plane = hh * rs, bplane = hd * plane, cplane = p.tn * bplane;
  const int sw = nthr % rs, sh = nthr / rs % hh, sd = nthr / plane % hd, sb = nthr / bplane;
  for (int c = 0; c < cic; c += V) {
    int iw = tid % rs, ih = tid / rs % hh, id = tid / plane % hd, ib = tid / bplane;
    for (int v0 = tid; v0 < cplane; v0 += kStageBatch * nthr) {
      Vec q[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const long long n = n0 + ib;
        const int gd = gd0 + id, gh = gh0 + ih, gw = gw0 + iw;
        const bool ok = v0 + u * nthr < cplane && n < p.n && gd >= 0 && gd < p.din && gh >= 0 && gh < p.hin &&
                        gw >= 0 && gw < p.win;
        const float* src = p.x + (((n * p.din + gd) * p.hin + gh) * p.win + gw) * p.cin + ci0 + c;
        q[u] = Vec{};
        if (ok) q[u] = __ldg(reinterpret_cast<const Vec*>(src));
        iw += sw;
        int carry = iw >= rs;
        iw -= carry ? rs : 0;
        ih += sh + carry;
        carry = ih >= hh;
        ih -= carry ? hh : 0;
        id += sd + carry;
        carry = id >= hd;
        id -= carry ? hd : 0;
        ib += sb + carry;
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int v = v0 + u * nthr;
        float* dst = xs + c * cplane + v;
        if (v < cplane) {
          if constexpr (V == 4) {
            dst[0] = q[u].x;
            dst[cplane] = q[u].y;
            dst[2 * cplane] = q[u].z;
            dst[3 * cplane] = q[u].w;
          } else {
            dst[0] = q[u];
          }
        }
      }
    }
  }
}

// Stage Cin chunk [ci0, ci0 + cic): the weights of the chunk and of
// channels [co0, co0 + COT), zero past Cout; and, for the instantiations
// whose threads own strips (HALO), the blocks' input halos.
template <bool HALO, int COT>
__device__ __forceinline__ void stage(const Params& p, float* xs, float* ws, long long n0, int gd0,
                                      int gh0, int gw0, int co0, int ci0, int cic, int k) {
  if constexpr (HALO) {
    if (p.vec && cic % 4 == 0)
      stage_halo<4>(p, xs, n0, gd0, gh0, gw0, ci0, cic);
    else
      stage_halo<1>(p, xs, n0, gd0, gh0, gw0, ci0, cic);
  }
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nco = min(COT, p.cout - co0);
  for (int r = tid; r < k * k * k * cic; r += nthr) {
    const int kw = r % k, kh = (r / k) % k, ci = (r / (k * k)) % cic, kd = r / (k * k * cic);
    const float* src = p.w + ((long long)((kd * k + kh) * k + kw) * p.cin + ci0 + ci) * p.cout + co0;
    float* dst = ws + r * COT;
#pragma unroll
    for (int c = 0; c < COT; ++c) dst[c] = c < nco ? __ldg(src + c) : 0.f;
  }
}

template <int COT>
__device__ __forceinline__ void load_weights(float (&wv)[COT], const float* wp) {
  if constexpr (COT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < COT; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(wp + c);
      wv[c] = q.x;
      wv[c + 1] = q.y;
      wv[c + 2] = q.z;
      wv[c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < COT; ++c) wv[c] = wp[c];
  }
}

// One (kd, ci, kh) row of taps from shared memory: acc[r][c] += x[r + kw]
// * w[kw][c] for kw in order. xr: the strip's first input of the row (16-byte
// aligned); wr: the row's K x COT weights.
template <int K, int COT, int R>
__device__ __forceinline__ void row_taps(float (&acc)[R][COT], const float* xr, const float* wr) {
  constexpr int NX = (R + K - 1 + 3) / 4 * 4;
  float xv[NX];
#pragma unroll
  for (int i = 0; i < NX; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(xr + i);
    xv[i] = q.x;
    xv[i + 1] = q.y;
    xv[i + 2] = q.z;
    xv[i + 3] = q.w;
  }
#pragma unroll
  for (int kw = 0; kw < K; ++kw) {
    float wv[COT];
    load_weights<COT>(wv, wr + kw * COT);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < COT; ++c) acc[r][c] = fmaf(xv[r + kw], wv[c], acc[r][c]);
  }
}

template <int K, int COT, int R>
__global__ void __launch_bounds__(kMaxThreads, 4) conv3d_kernel(const __grid_constant__ Params p) {
  constexpr bool kHalo = R > 1;  // strips read a staged halo; single outputs read device memory
  static_assert(!kHalo || K > 0, "a strip's taps are unrolled");
  extern __shared__ __align__(16) float smem[];
  const int k = K > 0 ? K : p.k;
  float* ws = smem;           // [kd][ci][kh][kw][COT]
  float* xs = smem + p.wsz;   // [ci][tn][hd][hh][rs], kHalo only
  const int plane = p.hh * p.rs, bplane = p.hd * plane, cplane = p.tn * bplane;

  const int tiles = p.ntd * p.nth * p.ntw;
  const long long n0 = (long long)(blockIdx.x / tiles) * p.tn;
  const int t = blockIdx.x % tiles;
  const int od0 = t / (p.nth * p.ntw) * p.td, oh0 = (t / p.ntw) % p.nth * p.th, ow0 = t % p.ntw * p.sw * R;
  const int co0 = blockIdx.y * COT;
  const int tid = threadIdx.x;
  const int s = tid % p.sw, lh = tid / p.sw % p.th, ld = tid / (p.sw * p.th) % p.td, lb = tid / (p.sw * p.th * p.td);
  const long long n = n0 + lb;
  const int od = od0 + ld, oh = oh0 + lh, ow = ow0 + s * R;
  const bool active = n < p.n && od < p.dout && oh < p.hout && ow < p.wout;

  float acc[R][COT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < COT; ++c) acc[r][c] = 0.f;

  const float* xt = xs + lb * bplane + (ld * p.hh + lh) * p.rs + s * R;  // the strip's staged input at kd = kh = ci = 0
  for (int ci0 = 0; ci0 < p.cin; ci0 += p.cic) {
    const int cic = min(p.cic, p.cin - ci0);
    if (ci0 > 0) __syncthreads();
    stage<kHalo, COT>(p, xs, ws, n0, od0 - p.pad, oh0 - p.pad, ow0 - p.pad, co0, ci0, cic, k);
    __syncthreads();
    if (!active) continue;
    if constexpr (kHalo) {
#pragma unroll 1
      for (int kd = 0; kd < K; ++kd) {
        for (int ci = 0; ci < cic; ++ci) {
          const float* xr = xt + ci * cplane + kd * plane;
          const float* wr = ws + (kd * cic + ci) * K * K * COT;
#pragma unroll
          for (int kh = 0; kh < K; ++kh) row_taps<K, COT, R>(acc, xr + kh * p.rs, wr + kh * K * COT);
        }
      }
    } else {
      // one output a thread: each input straight from device memory (a
      // small block's inputs stay in L1), zero outside the input; a (kd, ci)
      // step's k^2 loads issued together where k is known
      for (int kd = 0; kd < k; ++kd) {
        const int gd = od - p.pad + kd;
        for (int ci = 0; ci < cic; ++ci) {
          const float* wr = ws + (kd * cic + ci) * k * k * COT;
#pragma unroll
          for (int kh = 0; kh < (K > 0 ? K : k); ++kh) {
            const int gh = oh - p.pad + kh;
            const bool row = gd >= 0 && gd < p.din && gh >= 0 && gh < p.hin;
            const float* xr = p.x + ((n * p.din + gd) * p.hin + gh) * p.win * p.cin + ci0 + ci;
#pragma unroll
            for (int kw = 0; kw < (K > 0 ? K : k); ++kw) {
              float wv[COT];
              load_weights<COT>(wv, wr + (kh * k + kw) * COT);
              const int gw = ow - p.pad + kw;
              const float xv = row && gw >= 0 && gw < p.win ? __ldg(xr + (long long)gw * p.cin) : 0.f;
#pragma unroll
              for (int c = 0; c < COT; ++c) acc[0][c] = fmaf(xv, wv[c], acc[0][c]);
            }
          }
        }
      }
    }
  }
  if (!active) return;

  const int nco = min(COT, p.cout - co0);
  if (p.bias != nullptr) {
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      const float b = c < nco ? p.bias[co0 + c] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][c] += b;
    }
  }
  float* op = p.out + (((n * p.dout + od) * p.hout + oh) * p.wout + ow) * p.cout + co0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* o = op + (long long)r * p.cout;
    if (ow + r < p.wout && COT % 4 == 0 && p.cout % 4 == 0) {
#pragma unroll
      for (int c = 0; c < COT; c += 4)
        if (c < nco) *reinterpret_cast<float4*>(o + c) = make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    } else if (ow + r < p.wout) {
#pragma unroll
      for (int c = 0; c < COT; ++c)
        if (c < nco) o[c] = acc[r][c];
    }
  }
}

template <int K, int COT, int R>
cudaError_t launch(const Params& p, int threads, size_t smem, unsigned grid_x, unsigned grid_y, cudaStream_t st) {
  auto kernel = conv3d_kernel<K, COT, R>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(grid_x, grid_y), threads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (N, D, H, W, Cin) f32; w: (k, k, k, Cin, Cout) f32; bias: Cout f32 or
// null; out: (N, Do, Ho, Wo, Cout) f32, Do = D + 2 pad - k + 1; all
// contiguous on the current device. geom: din, hin, win, dout, hout, wout,
// tn, td, th, sw, ntd, nth, ntw, cic, hd, hh, rs (the halo 0, 0, 0 when r
// is 1: single outputs stage no inputs). (kt, cot, r): the instantiation,
// (4, 8, 8), (3, 1, 8), (3, 4, 1) or (0, 4, 1), kt = 0 taking k at run
// time.
int nvfpcc_conv3d(const float* x, const float* w, const float* bias, float* out, long long n, int cin,
                  int cout, int k, int padding, const int32_t* geom, int kt, int cot, int r, void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.out = out;
  p.n = n;
  p.cin = cin;
  p.cout = cout;
  p.k = k;
  p.pad = padding;
  int* dst[17] = {&p.din, &p.hin, &p.win, &p.dout, &p.hout, &p.wout, &p.tn,  &p.td, &p.th,
                  &p.sw,  &p.ntd, &p.nth, &p.ntw,  &p.cic,  &p.hd,   &p.hh, &p.rs};
  for (int i = 0; i < 17; ++i) *dst[i] = geom[i];
  const bool halo_ok = r == 1 ? p.hd == 0 && p.hh == 0 && p.rs == 0
                                : p.rs % 4 == 0 && p.rs >= p.sw * r + k - 1 && p.hd == p.td + k - 1 &&
                                      p.hh == p.th + k - 1;
  if (n < 1 || cin < 1 || cout < 1 || k < 1 || padding < 0 || (kt != 0 && kt != k) || p.cic < 1 ||
      p.cic > cin || p.tn < 1 || p.td < 1 || p.th < 1 || p.sw < 1 || !halo_ok ||
      p.dout != p.din + 2 * padding - k + 1 || p.hout != p.hin + 2 * padding - k + 1 ||
      p.wout != p.win + 2 * padding - k + 1 || p.dout < 1 || p.hout < 1 || p.wout < 1 ||
      p.ntd != (p.dout + p.td - 1) / p.td || p.nth != (p.hout + p.th - 1) / p.th ||
      p.ntw != (p.wout + p.sw * r - 1) / (p.sw * r))
    return (int)cudaErrorInvalidValue;
  const int threads = p.tn * p.td * p.th * p.sw;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  p.wsz = (k * k * k * p.cic * cot + 3) / 4 * 4;
  p.vec = cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const size_t smem = sizeof(float) * ((size_t)p.wsz + (size_t)p.cic * p.tn * p.hd * p.hh * p.rs);
  const long long gx = (n + p.tn - 1) / p.tn * p.ntd * p.nth * p.ntw, gy = (cout + cot - 1) / cot;
  if (gx >= (1LL << 31) || gy > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kt == 4 && cot == 8 && r == 8) return (int)launch<4, 8, 8>(p, threads, smem, (unsigned)gx, (unsigned)gy, st);
  if (kt == 3 && cot == 1 && r == 8) return (int)launch<3, 1, 8>(p, threads, smem, (unsigned)gx, (unsigned)gy, st);
  if (kt == 3 && cot == 4 && r == 1) return (int)launch<3, 4, 1>(p, threads, smem, (unsigned)gx, (unsigned)gy, st);
  if (kt == 0 && cot == 4 && r == 1) return (int)launch<0, 4, 1>(p, threads, smem, (unsigned)gx, (unsigned)gy, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
