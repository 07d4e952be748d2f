// Transposed 3-D convolution (torch semantics, NDHWC activations, DHWIO
// kernel, one group, dilation 1) for Hopper (sm_90a). On the card it runs
// the forward of the codec decoder's four upsampling layers (up0, conv0,
// up1, up2: k5 s2) and the input gradient of every direct conv (conv1,
// conv2: k4; the k3 heads; the 1x1 latent generator), which is the
// transposed conv of the output gradient at the conv's stride.
//
// Replaces no TPU kernel: the JAX package left these convs to XLA. It was
// added because cuDNN ran both as `dgrad2d_grouped_direct_kernel`, at
// about 0.2% of the card's f32 FFMA rate: 81% of a decode's device time
// (the f32 forward) and 55% of a training epoch's (the bf16 input
// gradients of conv2 and conv1).
//
// What bounds it on this card. At the flagship widths (8,16,8,8) a block's
// four transposed layers do 41.6 M useful multiply-adds (up2 79%) and write
// 1.4 MB of f32 output (up2's 35^3 x 8): 1.24 us of FFMA at 67 TFLOP/s
// against 0.42 us of bytes at 3.35 TB/s; conv2's input gradient is 134 M
// multiply-adds a block for 1.4 MB. The FFMA pipe bounds both.
//
// The design:
//   - sub-pixel split: with stride s, output o along an axis meets only the
//     taps t = (o + pad) mod s + s*j, each with input i = ib(o) - j; so an
//     output of phase class o mod s is a small stride-1 correlation over the
//     input (3 or 2 of the 5 taps per axis here, 8 to 27 per voxel instead
//     of 125). The wrapper hands per-axis tables (first tap t0, ib, and the
//     valid range [jlo, jhi) of j where the input exists) by value; the
//     kernel multiplies no inserted zero and no padding: its multiply-adds
//     are exactly the useful ones.
//   - tiles: a CTA takes one block n, one box of B_d x B_h x B_w sub-grid
//     positions (the same box in every phase class) and one tile of up to
//     COT output channels. It stages the box's input halo (every phase
//     class's inputs: B + 2 per axis for k5 s2) in shared memory channel-
//     planar, as f32, and the layer's weights for its channel tile and for the
//     taps its phase classes meet ([tap][ci][co], co padded to COT; all k^3
//     taps when it walks all classes). Then it walks the classes of its group; in each, every thread owns one output voxel and keeps its
//     COT sums in registers. All threads of a CTA share a phase class and
//     so a tap sequence: each weight load is a broadcast float4 from shared
//     memory, each input load one word per thread on consecutive addresses.
//     Cin that does not fit the shared-memory budget is walked in chunks,
//     restaged per chunk; Cout beyond COT is a grid axis; when the blocks
//     and boxes give too few CTAs, the phase classes are split over the grid.
//   - arithmetic: f32 FFMA with an f32 sum for f32 and bf16 operands (bf16
//     is widened when staged); the sum is rounded once to the output dtype.
//     An f32 bias is added in the epilogue (the bf16 caller adds its bias
//     after the rounded result, outside the kernel).
//   - deterministic and independent of the batch: each output's sum runs in
//     one fixed order (Cin chunk, j_d, j_h, j_w, ci) with no atomics and no
//     split over CTAs, so a block's output bits do not depend on the other
//     blocks of the call or on the process.
// The host entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxEdge = 128;  // largest output edge along an axis
constexpr int kMaxThreads = 512;

struct Axis {
  int n_in, n_out;
  int box;   // sub-grid positions of a box along the axis
  int nbox;  // boxes along the axis
  int lo;    // box b stages inputs [b * box + lo, b * box + lo + halo)
  int halo;
};

struct Params {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  long long n;
  int cin, cout, k, s, pad;
  int cic;             // Cin chunk staged at once
  int phases_per_cta;  // phase classes a CTA walks (grid.z splits the rest)
  Axis ax[3];
  int16_t tab[3][4][kMaxEdge];  // per axis and output: t0, ib, jlo, jhi
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// The taps a CTA's phase classes meet along one axis: all k when its
// classes differ along the axis, else the one residue's taps t0 + s*j. A
// tap t is staged at index (t - base) / step; a thread's tap j of first tap
// t0 at u0 + us * j.
struct TapSet {
  int base, step, count;
};

__device__ __forceinline__ TapSet tap_set(bool single, int first_q, int pad, int k, int s) {
  if (!single) return {0, 1, k};
  const int r = (first_q + pad) % s;
  return {r, s, (k - r + s - 1) / s};
}

// Stage Cin chunk [ci0, ci0 + cic): the box's input halo, widened to f32,
// channel-planar, and the weights of the staged taps, [u][ci][COT]. Each
// thread takes whole voxels of the halo (cic contiguous loads) and whole
// (tap, ci) rows of the weights (COT contiguous loads).
template <typename T, int COT>
__device__ __forceinline__ void stage(const Params& p, const T* __restrict__ x, const T* __restrict__ w,
                                      float* xs, float* ws, long long n, int h0d, int h0h, int h0w,
                                      int co0, int ci0, int cic, const TapSet (&ts)[3]) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int Lh = p.ax[1].halo, Lw = p.ax[2].halo;
  const int plane = p.ax[0].halo * Lh * Lw;
  const int Din = p.ax[0].n_in, Hin = p.ax[1].n_in, Win = p.ax[2].n_in;
  for (int v = tid; v < plane; v += nthr) {
    const int iw = v % Lw, ih = (v / Lw) % Lh, id = v / (Lw * Lh);
    const int gd = h0d + id, gh = h0h + ih, gw = h0w + iw;
    float* dst = xs + v;
    if (gd >= 0 && gd < Din && gh >= 0 && gh < Hin && gw >= 0 && gw < Win) {
      const T* src = x + (((n * Din + gd) * Hin + gh) * Win + gw) * p.cin + ci0;
      for (int ci = 0; ci < cic; ++ci) dst[ci * plane] = to_f32(src[ci]);
    } else {
      for (int ci = 0; ci < cic; ++ci) dst[ci * plane] = 0.f;
    }
  }
  const int k = p.k, uh = ts[1].count, uw = ts[2].count;
  const int nco = min(COT, p.cout - co0);
  for (int r = tid; r < ts[0].count * uh * uw * cic; r += nthr) {
    const int ci = r % cic, u = r / cic;
    const int td = ts[0].base + ts[0].step * (u / (uh * uw));
    const int th = ts[1].base + ts[1].step * ((u / uw) % uh);
    const int tw = ts[2].base + ts[2].step * (u % uw);
    const T* src = w + ((long long)((td * k + th) * k + tw) * p.cin + ci0 + ci) * p.cout + co0;
    float* dst = ws + r * COT;
#pragma unroll
    for (int co = 0; co < COT; ++co) dst[co] = co < nco ? to_f32(src[co]) : 0.f;
  }
}

template <typename T, int COT>
__global__ void __launch_bounds__(kMaxThreads, 2)
    conv_transpose3d_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int k = p.k, s = p.s;
  const int Lh = p.ax[1].halo, Lw = p.ax[2].halo;
  const int plane = p.ax[0].halo * Lh * Lw;
  float* ws = smem;                            // [u][ci][COT], at most k^3 taps
  float* xs = ws + k * k * k * p.cic * COT;    // [ci][Ld][Lh][Lw]
  int16_t* tab = reinterpret_cast<int16_t*>(xs + plane * p.cic);  // [3][4][kMaxEdge]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nbox_h = p.ax[1].nbox, nbox_w = p.ax[2].nbox;
  const int boxes = p.ax[0].nbox * nbox_h * nbox_w;
  const long long n = blockIdx.x / boxes;
  const int box = blockIdx.x % boxes;
  const int bd = box / (nbox_h * nbox_w), bh = (box / nbox_w) % nbox_h, bw = box % nbox_w;
  const int co0 = blockIdx.y * COT;
  const int h0d = bd * p.ax[0].box + p.ax[0].lo;
  const int h0h = bh * p.ax[1].box + p.ax[1].lo;
  const int h0w = bw * p.ax[2].box + p.ax[2].lo;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);

  for (int e = tid; e < 3 * 4 * kMaxEdge; e += nthr) {
    const int a = e / (4 * kMaxEdge), o = e % kMaxEdge;
    if (o < p.ax[a].n_out) tab[e] = (&p.tab[0][0][0])[e];
  }

  // the phase classes of this CTA, and the taps they meet
  const int nph = s * s * s;
  const int ph0 = blockIdx.z * p.phases_per_cta, ph1 = min(nph, ph0 + p.phases_per_cta);
  const TapSet ts[3] = {tap_set(ph0 / (s * s) == (ph1 - 1) / (s * s), ph0 / (s * s), p.pad, k, s),
                        tap_set(ph0 / s == (ph1 - 1) / s, (ph0 / s) % s, p.pad, k, s),
                        tap_set(ph0 == ph1 - 1, ph0 % s, p.pad, k, s)};
  const int uh = ts[1].count, uw = ts[2].count;

  // the thread's position in the box
  const int Bh = p.ax[1].box, Bw = p.ax[2].box;
  const int lw = tid % Bw, lh = (tid / Bw) % Bh, ld = tid / (Bw * Bh);
  const bool in_box = ld < p.ax[0].box;
  const int md = bd * p.ax[0].box + ld, mh = bh * Bh + lh, mw = bw * Bw + lw;

  const int nchunks = (p.cin + p.cic - 1) / p.cic;
  if (nchunks == 1) stage<T, COT>(p, x, w, xs, ws, n, h0d, h0h, h0w, co0, 0, p.cin, ts);
  __syncthreads();

  const int Dout = p.ax[0].n_out, Hout = p.ax[1].n_out, Wout = p.ax[2].n_out;
  for (int ph = ph0; ph < ph1; ++ph) {
    const int od = ph / (s * s) + s * md, oh = (ph / s) % s + s * mh, ow = ph % s + s * mw;
    const bool active = in_box && od < Dout && oh < Hout && ow < Wout;
    // per axis: first staged tap index u0, its step per j, input index at
    // j = 0 in the halo, and the valid j range
    int u0d = 0, usd = 0, ibd = 0, jd0 = 0, jd1 = 0, u0h = 0, ush = 0, ibh = 0, jh0 = 0, jh1 = 0;
    int u0w = 0, usw = 0, ibw = 0, jw0 = 0, jw1 = 0;
    if (active) {
      const int16_t* td_ = tab;
      const int16_t* th_ = tab + 4 * kMaxEdge;
      const int16_t* tw_ = tab + 8 * kMaxEdge;
      usd = ts[0].step == 1 ? s : 1;
      ush = ts[1].step == 1 ? s : 1;
      usw = ts[2].step == 1 ? s : 1;
      u0d = ts[0].step == 1 ? td_[od] : 0;
      u0h = ts[1].step == 1 ? th_[oh] : 0;
      u0w = ts[2].step == 1 ? tw_[ow] : 0;
      ibd = td_[kMaxEdge + od] - h0d; jd0 = td_[2 * kMaxEdge + od]; jd1 = td_[3 * kMaxEdge + od];
      ibh = th_[kMaxEdge + oh] - h0h; jh0 = th_[2 * kMaxEdge + oh]; jh1 = th_[3 * kMaxEdge + oh];
      ibw = tw_[kMaxEdge + ow] - h0w; jw0 = tw_[2 * kMaxEdge + ow]; jw1 = tw_[3 * kMaxEdge + ow];
    }
    float acc[COT];
#pragma unroll
    for (int c = 0; c < COT; ++c) acc[c] = 0.f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int ci0 = chunk * p.cic, cic = min(p.cic, p.cin - ci0);
      if (nchunks > 1) {
        __syncthreads();
        stage<T, COT>(p, x, w, xs, ws, n, h0d, h0h, h0w, co0, ci0, cic, ts);
        __syncthreads();
      }
      if (!active) continue;
      for (int jd = jd0; jd < jd1; ++jd) {
        const int ud = (u0d + usd * jd) * uh, id = ibd - jd;
        for (int jh = jh0; jh < jh1; ++jh) {
          const int udh = (ud + u0h + ush * jh) * uw, row = (id * Lh + ibh - jh) * Lw;
          for (int jw = jw0; jw < jw1; ++jw) {
            const float* xp = xs + row + ibw - jw;
            const float4* wp = reinterpret_cast<const float4*>(ws + (udh + u0w + usw * jw) * cic * COT);
#pragma unroll 4
            for (int ci = 0; ci < cic; ++ci) {
              const float xv = xp[ci * plane];
#pragma unroll
              for (int c4 = 0; c4 < COT / 4; ++c4) {
                const float4 wv = wp[ci * (COT / 4) + c4];
                acc[4 * c4 + 0] = fmaf(xv, wv.x, acc[4 * c4 + 0]);
                acc[4 * c4 + 1] = fmaf(xv, wv.y, acc[4 * c4 + 1]);
                acc[4 * c4 + 2] = fmaf(xv, wv.z, acc[4 * c4 + 2]);
                acc[4 * c4 + 3] = fmaf(xv, wv.w, acc[4 * c4 + 3]);
              }
            }
          }
        }
      }
    }
    if (!active) continue;
    const int nco = min(COT, p.cout - co0);
    if (p.bias != nullptr) {
#pragma unroll
      for (int c = 0; c < COT; ++c)
        if (c < nco) acc[c] += p.bias[co0 + c];
    }
    T* op = static_cast<T*>(p.out) + (((n * Dout + od) * Hout + oh) * Wout + ow) * p.cout + co0;
    if (p.cout % 4 == 0) {
#pragma unroll
      for (int c = 0; c < COT; c += 4)
        if (c < nco) store4(op + c, acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < COT; ++c)
        if (c < nco) store1(op + c, acc[c]);
    }
  }
}

template <typename T, int COT>
cudaError_t launch(const Params& p, int threads, size_t smem, unsigned grid_x, unsigned grid_y,
                   unsigned grid_z, cudaStream_t st) {
  auto kernel = conv_transpose3d_kernel<T, COT>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(grid_x, grid_y, grid_z), threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cot(int cot, const Params& p, int threads, size_t smem, unsigned gx, unsigned gy,
                       unsigned gz, cudaStream_t st) {
  switch (cot) {
    case 4: return launch<T, 4>(p, threads, smem, gx, gy, gz, st);
    case 8: return launch<T, 8>(p, threads, smem, gx, gy, gz, st);
    case 16: return launch<T, 16>(p, threads, smem, gx, gy, gz, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (N, D, H, W, Cin) f32 or bf16; w: (k, k, k, Cin, Cout) same dtype;
// bias: Cout f32 or null; out: (N, Do, Ho, Wo, Cout) x's dtype; all
// contiguous on the current device. axes: per axis (n_in, n_out, box, nbox,
// lo, halo); tables: per axis (t0, ib, jlo, jhi), each kMaxEdge int16 of
// which the first n_out are read. cic: Cin chunk; cot: 4, 8 or 16 output
// channels a CTA; phase_groups: grid.z, splitting the s^3 phase classes.
int nvfpcc_conv_transpose3d(const void* x, const void* w, const float* bias, void* out, int bf16,
                            long long n, int cin, int cout, int k, int stride, int padding,
                            const int32_t* axes,
                            const int16_t* tables, int cic, int cot, int phase_groups,
                            void* stream) {
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
  p.s = stride;
  p.pad = padding;
  p.cic = cic;
  long long boxes = 1, box_voxels = 1, plane = 1;
  for (int a = 0; a < 3; ++a) {
    Axis& ax = p.ax[a];
    ax.n_in = axes[6 * a + 0];
    ax.n_out = axes[6 * a + 1];
    ax.box = axes[6 * a + 2];
    ax.nbox = axes[6 * a + 3];
    ax.lo = axes[6 * a + 4];
    ax.halo = axes[6 * a + 5];
    if (ax.n_out < 1 || ax.n_out > kMaxEdge || ax.box < 1 || ax.nbox < 1 || ax.halo < 1)
      return (int)cudaErrorInvalidValue;
    boxes *= ax.nbox;
    box_voxels *= ax.box;
    plane *= ax.halo;
  }
  memcpy(p.tab, tables, sizeof(p.tab));
  const int nph = stride * stride * stride;
  if (n < 1 || cin < 1 || cout < 1 || k < 1 || stride < 1 || cic < 1 || cic > cin ||
      padding < 0 || phase_groups < 1 || phase_groups > nph || box_voxels > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  p.phases_per_cta = (nph + phase_groups - 1) / phase_groups;
  const int threads = (int)((box_voxels + 31) / 32 * 32);
  const size_t smem = sizeof(float) * ((size_t)k * k * k * cic * cot + (size_t)plane * cic) +
                      sizeof(int16_t) * 3 * 4 * kMaxEdge;
  const long long gx = n * boxes, gy = (cout + cot - 1) / cot;
  if (gx >= (1LL << 31) || gy > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_cot<__nv_bfloat16>(cot, p, threads, smem, (unsigned)gx, (unsigned)gy,
                                          (unsigned)phase_groups, st);
  return (int)launch_cot<float>(cot, p, threads, smem, (unsigned)gx, (unsigned)gy,
                                (unsigned)phase_groups, st);
}

}  // extern "C"
