// K4: fused per-block window extraction + bilinear resample.
//
// Replaces the TPU kernel moonrtx_tpu/ops/extract.py::
// resample_group_windows_tpu (_make_resample_kernel): per block, fetch
// and decode the (wh, ww) = (40, 184) window from the block's level,
// take its mean over the exact window, and sample it bilinearly at
// (wy, wx) on bf16 mean-centered residuals with bf16 column weights and
// f32 row weights, adding the mean back. The TPU formed the bilinear as
// one-hot MXU contractions; here each sample reads its four texels.
//
// Bound on Hopper: instruction throughput, L2 bytes close behind. A
// block reads 7,360 window texels for 512 samples. Neighbouring windows
// overlap, so the distinct texels are few (the byte bound of a height
// launch counts 5 MB of them beside 75 MB of coordinates and output), but
// every block reads its whole window again from L2 for the mean (181 MB
// a launch). The first design paid ~70 instructions a texel (a division,
// four 64-bit clamps, a dtype switch, a second pass rounding every
// residual). Design:
//  - one 256-thread block per scan block, templated on the source type
//    (no per-texel branch; scale and offset always apply, x*1+0 is exact;
//    the row tile of the coordinate frame is a constant);
//  - the window is streamed by rows, a warp a row, lanes across columns.
//    A window inside its level (almost all are) takes one 16-byte load a
//    lane (8 int16, 4 f32, 16 uint8) from the aligned chunks that lie
//    wholly inside [c0, c0 + ww), the row loop stepping its addresses by
//    additions; the ragged ends of all rows are read afterwards, one
//    thread per row end, so nothing outside the window is read and the
//    row loop has no masks. A window that crosses an edge takes the
//    clamped texel-by-texel path;
//  - the raw texels go to shared memory as they came, one 16-byte store a
//    chunk, each row shifted so that its aligned chunks stay aligned (15
//    KB for int16, so eight blocks share an SM);
//  - the mean needs every texel once: int16 and uint8 texels are summed
//    as integers, two or four to an instruction (dp2a, dp4a), which is
//    exact, and the mean is decoded once (mean(raw) * scale + offset: the
//    mean of the decoded window up to rounding, as a changed summation
//    order is); f32 texels are decoded and summed in f32;
//  - the decode and bf16(v - mean) are formed only at the four taps of
//    each sample: 2,048 texels a block instead of 7,360, the same
//    arithmetic, no second pass over the window.
// The loads are not pipelined further (rows batched in registers,
// cp.async double buffering in persistent blocks): the kernel retires
// close to three instructions a cycle per SM, so what such a scheme adds
// in instructions costs more than the waiting it hides (measured).
#include <type_traits>

#include "common.cuh"

#define MAX_LEVELS 4
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_SMEM (227 * 1024 - 64)

struct ResampleArgs {
  const void* tex[MAX_LEVELS];
  long long rows[MAX_LEVELS];
  long long cols[MAX_LEVELS];
  const int* lvl;
  const int* r0;
  const int* c0;
  const float* wy;
  const float* wx;
  float* out;
  float scale, offset;
  int nblk, b, n_levels, wh, ww, src_dtype;
};

// elements of one shared-memory row: the window's row after up to one
// chunk of lead, rounded up to whole 16-byte chunks
template <typename T>
__host__ __device__ constexpr int row_stride(int ww) {
  constexpr int E = 16 / (int)sizeof(T);
  return (ww + 2 * E - 1) / E * E;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
resample_kernel(const ResampleArgs a) {
  constexpr int E = 16 / (int)sizeof(T);   // texels of a 16-byte chunk
  extern __shared__ uint4 smem[];
  T* win = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x;
  int k = a.lvl[blk];
  k = k < 0 ? 0 : (k >= a.n_levels ? a.n_levels - 1 : k);
  const T* tex = static_cast<const T*>(a.tex[k]);
  const long long H = a.rows[k], W = a.cols[k];
  const int r0 = a.r0[blk], c0 = a.c0[blk];
  const int wh = a.wh, ww = a.ww;
  const int rs = row_stride<T>(ww);
  const float scale = a.scale, offset = a.offset;

  // texels of window row r before its first 16-byte boundary in global
  // memory; the row sits in shared memory at win + r*rs + E - lead(r), so
  // that boundary falls on a chunk boundary there too
  const unsigned a0 = (unsigned)(
      (reinterpret_cast<unsigned long long>(tex) +
       (unsigned long long)(((long long)r0 * W + c0) * (long long)sizeof(T)))
      & 15ull);
  const unsigned wb = (unsigned)((W * (long long)sizeof(T)) & 15ll);
  auto lead_of = [&](int r) -> int {
    return (int)(((0u - (a0 + (unsigned)r * wb)) & 15u) / sizeof(T));
  };

  const long long s0 = (long long)blk * a.b;
  const bool inside = r0 >= 0 && c0 >= 0 && (long long)r0 + wh <= H &&
                      (long long)c0 + ww <= W;
  // this thread's share of the window's sum: raw integers, or decoded f32
  constexpr bool kInt = !std::is_same<T, float>::value;
  typename std::conditional<kInt, int, float>::type part = 0;
  auto add = [&](T raw) {
    if constexpr (kInt) part += (int)raw;
    else part = __fadd_rn(part, __fadd_rn(__fmul_rn(raw, scale), offset));
  };
  if (inside) {
    // the row loop steps its addresses and its alignment by additions
    const T* grow = tex + ((long long)r0 + warp) * W + c0 + lane * E;
    const long long gstep = (long long)WARPS * W;
    T* srow = win + warp * rs + E + lane * E;
    unsigned al = a0 + (unsigned)warp * wb;
    for (int r = warp; r < wh;
         r += WARPS, grow += gstep, srow += WARPS * rs, al += WARPS * wb) {
      const int lead = (int)(((0u - al) & 15u) / sizeof(T));
      const int nfull = (ww - lead) / E;      // <= 0: no whole chunk
#pragma unroll 1
      for (int ch = lane; ch < nfull; ch += 32) {
        const int o = lead + (ch - lane) * E;
        const uint4 v = *reinterpret_cast<const uint4*>(grow + o);
        *reinterpret_cast<uint4*>(srow + o - lead) = v;
        if constexpr (std::is_same<T, int16_t>::value) {
          part = __dp2a_lo((int)v.x, 0x0101, part);
          part = __dp2a_lo((int)v.y, 0x0101, part);
          part = __dp2a_lo((int)v.z, 0x0101, part);
          part = __dp2a_lo((int)v.w, 0x0101, part);
        } else if constexpr (std::is_same<T, uint8_t>::value) {
          part = (int)__dp4a(v.x, 0x01010101u, (unsigned)part);
          part = (int)__dp4a(v.y, 0x01010101u, (unsigned)part);
          part = (int)__dp4a(v.z, 0x01010101u, (unsigned)part);
          part = (int)__dp4a(v.w, 0x01010101u, (unsigned)part);
        } else {
          add(__uint_as_float(v.x));
          add(__uint_as_float(v.y));
          add(__uint_as_float(v.z));
          add(__uint_as_float(v.w));
        }
      }
    }
    // the ragged ends: a thread per row and side, at most E - 1 texels
    for (int e = threadIdx.x; e < 2 * wh; e += THREADS) {
      const int r = e >> 1;
      const int lead = min(lead_of(r), ww);
      const int tail0 = lead + (ww - lead) / E * E;
      const int c_lo = (e & 1) ? tail0 : 0, c_hi = (e & 1) ? ww : lead;
      const T* gend = tex + ((long long)r0 + r) * W + c0 + c_lo;
      T* send = win + r * rs + E - lead_of(r) + c_lo;
#pragma unroll
      for (int i = 0; i < E - 1; ++i) {
        if (c_lo + i < c_hi) {
          const T raw = gend[i];
          send[i] = raw;
          add(raw);
        }
      }
    }
  } else {
    for (int r = warp; r < wh; r += WARPS) {
      long long rr = (long long)r0 + r;
      rr = rr < 0 ? 0 : (rr >= H ? H - 1 : rr);
      const T* grow = tex + rr * W;
      T* srow = win + r * rs + E - lead_of(r);
      for (int c = lane; c < ww; c += 32) {
        long long cc = (long long)c0 + c;
        cc = cc < 0 ? 0 : (cc >= W ? W - 1 : cc);
        const T raw = grow[cc];
        srow[c] = raw;
        add(raw);
      }
    }
  }
  float mean;
  if constexpr (kInt) {
    __shared__ int warp_sum[WARPS];
    part = __reduce_add_sync(0xffffffffu, part);
    if (lane == 0) warp_sum[warp] = part;
    __syncthreads();
    int total = 0;
    for (int i = 0; i < WARPS; ++i) total += warp_sum[i];
    mean = __fadd_rn(__fmul_rn(__fdiv_rn((float)total, (float)(wh * ww)),
                               scale), offset);
  } else {
    __shared__ float warp_sum[WARPS];
    for (int s = 16; s > 0; s >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, s));
    if (lane == 0) warp_sum[warp] = part;
    __syncthreads();
    float total = 0.0f;
    for (int i = 0; i < WARPS; ++i) total = __fadd_rn(total, warp_sum[i]);
    mean = __fdiv_rn(total, (float)(wh * ww));
  }

  // fractional coordinates are formed in the tile-aligned frame of the
  // TPU kernel (origin rounded down to the dtype's row tile, (8, 128) for
  // f32, 16 rows for 16-bit, 32 for 8-bit texels, and to 128 columns), so
  // they round exactly as it does
  constexpr int kRowTile = 8 * (4 / (int)sizeof(T));
  const int offr = r0 & (kRowTile - 1), offc = c0 & 127;
  const float ymax = (float)(wh - 1.001), xmax = (float)(ww - 1.001);
  auto tap = [&](const T* p) -> float {
    const float v = __fadd_rn(__fmul_rn((float)*p, scale), offset);
    return mrtx_bf16(__fsub_rn(v, mean));
  };
  auto sample = [&](int j, float wy_in, float wx_in) {
    const float wy = __fadd_rn(fminf(fmaxf(wy_in, 0.0f), ymax), (float)offr);
    const float wx = __fadd_rn(fminf(fmaxf(wx_in, 0.0f), xmax), (float)offc);
    const float y0 = floorf(wy), x0 = floorf(wx);
    const float fy = __fsub_rn(wy, y0), fx = __fsub_rn(wx, x0);
    const int ly = (int)y0 - offr, lx = (int)x0 - offc;
    const float wc0 = mrtx_bf16(__fsub_rn(1.0f, fx)), wc1 = mrtx_bf16(fx);
    const T* p0 = win + ly * rs + E - lead_of(ly) + lx;
    const T* p1 = win + (ly + 1) * rs + E - lead_of(ly + 1) + lx;
    const float m0 = __fadd_rn(__fmul_rn(tap(p0), wc0),
                               __fmul_rn(tap(p0 + 1), wc1));
    const float m1 = __fadd_rn(__fmul_rn(tap(p1), wc0),
                               __fmul_rn(tap(p1 + 1), wc1));
    const float v = __fadd_rn(__fmul_rn(m0, __fsub_rn(1.0f, fy)),
                              __fmul_rn(m1, fy));
    a.out[s0 + j] = __fadd_rn(v, mean);
  };
  for (int j = threadIdx.x; j < a.b; j += THREADS)
    sample(j, a.wy[s0 + j], a.wx[s0 + j]);
}

template <typename T>
static int launch(const ResampleArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.wh * row_stride<T>(a.ww) * sizeof(T);
  // shared memory, and an int32 sum of 16-bit texels
  if (smem > MAX_SMEM || (long long)a.wh * a.ww > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  resample_kernel<T><<<a.nblk, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

MRTX_EXPORT int mrtx_resample_group_windows(const ResampleArgs* a,
                                            cudaStream_t stream) {
  if (a->wh <= 0 || a->ww <= 0) return (int)cudaErrorInvalidValue;
  if (a->nblk == 0) return 0;
  switch (a->src_dtype) {
    case MRTX_F32: return launch<float>(*a, stream);
    case MRTX_I16: return launch<int16_t>(*a, stream);
    case MRTX_U8: return launch<uint8_t>(*a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

MRTX_ERROR_STRING_FN
