// Exact windowed squared Euclidean distance transform of a 3-D occupancy
// grid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nvfpcc_tpu/ops/pallas/edt_pallas.py:
// squared_edt_3d_pallas (_make_pass / _pass_kernel / _minplus_dir). Same
// contract: occupancy (D, H, W) bytes -> int32 squared distance to the
// nearest occupied voxel, saturated at cap = R^2 + 1; by definition three
// separable 1-D passes (along W, then H, then D) of
//     out[i] = min(cap, min_{|d| <= R} f[i + d] + d^2)
// over the 0/cap occupancy map, with cap outside the grid.
//
// What bounds it on this card. The function reads 1 byte and writes 4 per
// voxel: 1.63 GB at 688^3, 0.49 ms at 3.35 TB/s. The three passes as
// written above do 2R+1 min-plus terms per voxel each (R = 55 for 32^3
// blocks, 63 for D1): 110 shared-memory loads and ~220 integer ops per
// voxel per pass, which bound a direct translation at ~15 ms, 30x off the
// bytes. The design cuts the work per voxel, not the bytes; what is left
// bounds it: (2R+1)/2 DPX add-min instructions per voxel in each strided
// pass (566 M warp instructions per pass at 688^3 R=55), far above the
// 13 bytes per voxel the three passes move. The design:
//   - pass 1 (contiguous W axis) is O(1) per voxel. Over a 0/cap line the
//     windowed pass is exactly `d <= R ? d^2 : cap`, d the distance to the
//     nearest occupied voxel of the row (terms with |d| > R are
//     >= (R+1)^2 > cap). One warp per row packs the row into 32-bit
//     occupancy words (one lane per word), carries the nearest occupied
//     position across words with a warp prefix-max and suffix-min, finds
//     within-word neighbours with __clz/__ffs, and writes 8 outputs a lane.
//   - passes 2 and 3 (strided H and D axes) keep the min-plus window, cut
//     three ways: (a) packed lanes: after pass 1 every value is <= cap and
//     every term <= 2R^2 + 1, which fits int16 for R <= 127, so a 32-bit
//     word holds two neighbouring columns and a warp covers 64 columns, one
//     128-byte line per tile row; (b) register blocking: each thread owns
//     kK = 16 consecutive outputs along the pass axis, so each staged value
//     is read from shared memory once and folded into all 16 accumulators
//     (16 beat 8 and 32 on the card; a block covers 256 positions, which
//     also cuts the re-staged halo);
//     (c) Hopper's DPX add-min (__viaddmin_s16x2: per-halfword min(a + b, c)
//     in one instruction) folds one term into two outputs. For R = 55 and 63
//     the window loop is unrolled at compile time, so d^2 are immediates;
//     every other R runs one generic instantiation.
//   - lane type by radius: int16x2 words for 2R^2 + 1 <= 32767 (R <= 127:
//     pass 1 writes int16 into the bytes of `out`, pass 2 writes the int16
//     scratch, pass 3 widens to int32 `out`); int32 words above (R = 128 up
//     to the shared-tile limit: the same kernels, one column per word,
//     __viaddmin_s32).
// Peak device memory per call: occ + out (int32) + scratch (int16, or
// int32 above R = 127).
//
// The TPU kernel's (8, SEG, 128) VMEM blocking and its shift-propagation
// recurrence are not carried over: blocks here run in parallel in any order
// and each stages its own halo. Offsets are 64-bit: a vox10 bounding grid
// can hold ~1.5e9 voxels. The host entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after each launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;    // rows (one warp each) per block of the row pass
constexpr int kWords = 32;      // 32-bit words per tile row of a strided pass (128 bytes)
constexpr int kTy = 16;         // blockDim.y of a strided pass
constexpr int kK = 16;          // outputs per thread along the pass axis
constexpr int kSeg = kTy * kK;  // outputs per block along the pass axis
constexpr int kFar = 1 << 29;   // position of "no occupied voxel" on either side

// Pass 1, along the contiguous axis W, from occupancy bytes. One warp per
// row (d * H + h), in three sweeps over the row's 32-voxel words, kept in
// shared memory: (1) one lane per word packs its 32 bytes into a word and
// a warp prefix-max gives the last occupied position before each word;
// (2) a warp suffix-min gives the first occupied position after each word;
// (3) one lane per 8 voxels writes their outputs, 16 or 32 contiguous bytes
// a lane.
template <typename OutT>
struct Out8;
template <>
struct Out8<int16_t> {
  static __device__ __forceinline__ void store(int16_t* p, const int (&o)[8]) {
    uint4 v;
    v.x = (uint32_t)o[0] | ((uint32_t)o[1] << 16);
    v.y = (uint32_t)o[2] | ((uint32_t)o[3] << 16);
    v.z = (uint32_t)o[4] | ((uint32_t)o[5] << 16);
    v.w = (uint32_t)o[6] | ((uint32_t)o[7] << 16);
    *reinterpret_cast<uint4*>(p) = v;
  }
};
template <>
struct Out8<int32_t> {
  static __device__ __forceinline__ void store(int32_t* p, const int (&o)[8]) {
    reinterpret_cast<int4*>(p)[0] = make_int4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(o[4], o[5], o[6], o[7]);
  }
};

template <typename OutT>
__global__ void __launch_bounds__(32 * kRowWarps)
edt_pass_rows(const uint8_t* __restrict__ occ, OutT* __restrict__ out, long long rows, int W,
              int radius, int cap) {
  extern __shared__ uint32_t smem[];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + warp;
  if (row >= rows) return;  // warp-uniform
  const int chunks = (W + 31) >> 5;
  uint32_t* words = smem + (size_t)warp * 3 * chunks;
  int* left_of = reinterpret_cast<int*>(words + chunks);
  int* right_of = left_of + chunks;
  const uint8_t* src = occ + row * W;
  OutT* dst = out + row * W;

  int carry = -kFar;  // last occupied position before this group of words
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // W is a multiple of 8: 8 bytes at a time
      const int w = (c << 5) + (q << 3);
      if (w < W) {
        const uint2 v = *reinterpret_cast<const uint2*>(src + w);
        const uint32_t lo = __vcmpne4(v.x, 0u) & 0x01010101u;
        const uint32_t hi = __vcmpne4(v.y, 0u) & 0x01010101u;
        word |= (((lo * 0x01020408u) >> 24) | (((hi * 0x01020408u) >> 24) << 4)) << (q << 3);
      }
    }
    int last = word ? (c << 5) + 31 - __clz((int)word) : -kFar;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int t = __shfl_up_sync(full, last, k);
      if (lane >= k) last = max(last, t);
    }
    const int before = __shfl_up_sync(full, last, 1);
    if (c < chunks) {
      words[c] = word;
      left_of[c] = lane ? max(carry, before) : carry;
    }
    carry = max(carry, __shfl_sync(full, last, 31));
  }
  __syncwarp();
  carry = kFar;  // first occupied position after this group of words
  for (int c0 = (chunks - 1) & ~31; c0 >= 0; c0 -= 32) {
    const int c = c0 + lane;
    const uint32_t word = c < chunks ? words[c] : 0u;
    int first = word ? (c << 5) + __ffs((int)word) - 1 : kFar;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int t = __shfl_down_sync(full, first, k);
      if (lane + k < 32) first = min(first, t);
    }
    const int after = __shfl_down_sync(full, first, 1);
    if (c < chunks) right_of[c] = lane < 31 ? min(carry, after) : carry;
    carry = min(carry, __shfl_sync(full, first, 0));
  }
  __syncwarp();
  for (int p = lane; p < (W >> 3); p += 32) {
    const int c = p >> 2, w0 = p << 3, sub = (p & 3) << 3;
    const uint32_t word = words[c];
    const int left0 = left_of[c], right0 = right_of[c];
    int o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b = sub + k;
      const uint32_t below = word & (0xffffffffu >> (31 - b));  // bits 0..b
      const uint32_t above = word & (0xffffffffu << b);         // bits b..31
      const int left = below ? (c << 5) + 31 - __clz((int)below) : left0;
      const int right = above ? (c << 5) + __ffs((int)above) - 1 : right0;
      const int d = min(w0 + k - left, right - w0 - k);
      o[k] = d <= radius ? d * d : cap;
    }
    Out8<OutT>::store(dst + w0, o);
  }
}

template <bool kPacked>
struct Lanes;

template <>
struct Lanes<true> {  // two int16 columns per word
  static __device__ __forceinline__ uint32_t splat(int v) { return (uint32_t)v * 0x10001u; }
  static __device__ __forceinline__ uint32_t addmin(uint32_t a, uint32_t b, uint32_t c) {
    return __viaddmin_s16x2(a, b, c);
  }
};

template <>
struct Lanes<false> {  // one int32 column per word
  static __device__ __forceinline__ uint32_t splat(int v) { return (uint32_t)v; }
  static __device__ __forceinline__ uint32_t addmin(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)__viaddmin_s32((int)a, (int)b, (int)c);
  }
};

// Pass along a strided axis of length L, the grid viewed as (outer, L,
// inner) 32-bit words with inner contiguous. Block: 32 word columns x kTy
// thread rows; it stages a (kSeg + 2R) x 32-word tile of the pass axis
// (cap outside the grid) and each thread folds the 2R + kK staged values of
// its column into its kK accumulators. Grid: x = segment + nseg * column
// tile (neighbouring segments, which share halo rows, run together), z =
// outer. kR > 0 fixes the radius at compile time; kR = 0 reads it from the
// argument. kWiden writes each int16 pair as two int32 (the last pass).
template <bool kPacked, int kR, bool kWiden>
__global__ void __launch_bounds__(kWords * kTy)
edt_pass_strided(const uint32_t* __restrict__ in, void* __restrict__ out, long long L,
                 long long inner, int nseg, int radius_arg, int cap) {
  using Ln = Lanes<kPacked>;
  extern __shared__ uint32_t tile[];  // [kSeg + 2R][kWords]
  const int R = kR > 0 ? kR : radius_arg;
  const long long l0 = (long long)(blockIdx.x % nseg) * kSeg;
  const long long col = (long long)(blockIdx.x / nseg) * kWords + threadIdx.x;
  const long long base = (long long)blockIdx.z * L * inner;
  const bool col_ok = col < inner;
  const uint32_t capw = Ln::splat(cap);
  const int span = kSeg + 2 * R;
  for (int j = threadIdx.y; j < span; j += kTy) {
    const long long l = l0 - R + j;
    uint32_t v = capw;
    if (col_ok && l >= 0 && l < L) v = in[base + l * inner + col];
    tile[j * kWords + threadIdx.x] = v;
  }
  __syncthreads();
  const int p0 = threadIdx.y * kK;
  if (!col_ok || l0 + p0 >= L) return;

  uint32_t acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = capw;
  // tile row p0 + j holds pass-axis position l0 + p0 - R + j: output k
  // takes it at offset d = j - k - R
  const uint32_t* t = tile + p0 * kWords + threadIdx.x;
  if constexpr (kR > 0) {
#pragma unroll
    for (int j = 0; j < 2 * kR + kK; ++j) {
      const uint32_t v = t[j * kWords];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int d = j - k - kR;
        if (d >= -kR && d <= kR) acc[k] = Ln::addmin(v, Ln::splat(d * d), acc[k]);
      }
    }
  } else {
    // the same terms in offset order e = d + R: a ring of kK registers holds
    // rows e .. e + kK - 1 (row j in r[j % kK]), and unrolling e by kK keeps
    // the ring's indices static; one multiply per offset serves kK outputs
    uint32_t r[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) r[k] = t[k * kWords];
    for (int e0 = 0; e0 <= 2 * R; e0 += kK) {
#pragma unroll
      for (int s = 0; s < kK; ++s) {
        const int e = e0 + s;
        if (e > 2 * R) break;
        const uint32_t dd = Ln::splat((e - R) * (e - R));
#pragma unroll
        for (int k = 0; k < kK; ++k) acc[k] = Ln::addmin(r[(s + k) % kK], dd, acc[k]);
        if (e < 2 * R) r[s] = t[(e + kK) * kWords];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const long long l = l0 + p0 + k;
    if (l >= L) break;
    const long long i = base + l * inner + col;
    if constexpr (kWiden) {
      static_cast<int2*>(out)[i] = make_int2((int)(acc[k] & 0xffffu), (int)(acc[k] >> 16));
    } else {
      static_cast<uint32_t*>(out)[i] = acc[k];
    }
  }
}

template <typename OutT>
cudaError_t launch_rows(const uint8_t* occ, OutT* out, long long rows, long long W, int radius,
                        int cap, cudaStream_t st) {
  const size_t smem = (size_t)kRowWarps * 3 * ((W + 31) / 32) * sizeof(uint32_t);
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  if (W >= (1LL << 28) || blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(edt_pass_rows<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  edt_pass_rows<OutT><<<(unsigned)blocks, 32 * kRowWarps, smem, st>>>(occ, out, rows, (int)W,
                                                                       radius, cap);
  return cudaGetLastError();
}

template <bool kPacked, int kR, bool kWiden>
cudaError_t launch_strided(const uint32_t* in, void* out, long long outer, long long L,
                           long long inner, int radius, int cap, cudaStream_t st) {
  const size_t smem = (size_t)(kSeg + 2 * radius) * kWords * sizeof(uint32_t);
  const long long nseg = (L + kSeg - 1) / kSeg, ntiles = (inner + kWords - 1) / kWords;
  if (nseg * ntiles >= (1LL << 31) || outer > 65535) return cudaErrorInvalidValue;
  auto kernel = edt_pass_strided<kPacked, kR, kWiden>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(nseg * ntiles), 1u, (unsigned)outer);
  kernel<<<grid, dim3(kWords, kTy), smem, st>>>(in, out, L, inner, (int)nseg, radius, cap);
  return cudaGetLastError();
}

// int16x2 lanes, with the hot radii (32^3 blocks, D1) unrolled
template <bool kWiden>
cudaError_t launch_strided16(const uint32_t* in, void* out, long long outer, long long L,
                             long long inner, int radius, int cap, cudaStream_t st) {
  switch (radius) {
    case 55: return launch_strided<true, 55, kWiden>(in, out, outer, L, inner, radius, cap, st);
    case 63: return launch_strided<true, 63, kWiden>(in, out, outer, L, inner, radius, cap, st);
    default: return launch_strided<true, 0, kWiden>(in, out, outer, L, inner, radius, cap, st);
  }
}

}  // namespace

extern "C" {

// occ: (D, H, W) uint8/bool, out: (D, H, W) int32, scratch: (D, H, W) int16
// for lane_bits 16 (needs 2R^2 + 1 <= 32767) or int32 for lane_bits 32; all
// contiguous on the current device. The result lands in out.
int nvfpcc_edt3d(const uint8_t* occ, int32_t* out, void* scratch, long long D, long long H,
                 long long W, int radius, int lane_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cap = radius * radius + 1;
  const long long hw = H * W;
  cudaError_t err;
  if (radius < 1 || (W & 1)) return (int)cudaErrorInvalidValue;
  if (lane_bits == 16) {
    if (2 * radius * radius + 1 > 32767) return (int)cudaErrorInvalidValue;
    int16_t* rows = reinterpret_cast<int16_t*>(out);  // pass 1 into out's first half
    if ((err = launch_rows<int16_t>(occ, rows, D * H, W, radius, cap, st))) return (int)err;
    if ((err = launch_strided16<false>(reinterpret_cast<const uint32_t*>(rows), scratch, D, H,
                                       W / 2, radius, cap, st)))
      return (int)err;
    return (int)launch_strided16<true>(static_cast<const uint32_t*>(scratch), out, 1, D, hw / 2,
                                       radius, cap, st);
  }
  if (lane_bits == 32) {
    if ((err = launch_rows<int32_t>(occ, out, D * H, W, radius, cap, st))) return (int)err;
    if ((err = launch_strided<false, 0, false>(reinterpret_cast<const uint32_t*>(out), scratch, D,
                                               H, W, radius, cap, st)))
      return (int)err;
    return (int)launch_strided<false, 0, false>(static_cast<const uint32_t*>(scratch), out, 1, D,
                                                hw, radius, cap, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* nvfpcc_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
