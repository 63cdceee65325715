// Per-block window extraction with affine decode: K1 (grouped, multi-map,
// packed march layout) and K5 (one window per block, any block count,
// strided levels).
//
// K1 replaces the TPU kernel moonrtx_tpu/ops/extract.py::
// extract_group_windows_tpu (_make_group_kernel); K5 replaces
// extract_level_windows_tpu / extract_windows_tpu (_extract_impl,
// _make_kernel). The TPU kernels DMA a tile-aligned superwindow per block
// into VMEM and recompact it with one-hot MXU contractions because the
// TPU has no gather hardware; none of that comes across.
//
// Bound on Hopper: memory. Each output texel is one load, one multiply,
// one add and one store; at 1080p the pose windows read ~0.1-0.2 GB and
// write ~0.2-0.5 GB against 3.35 TB/s. Design: one thread block per
// window (K1: per (block, map)) copies the block's (wh, ww) window row by
// row with neighbouring threads on neighbouring columns, so loads and
// stores coalesce; nothing is staged, nothing is read twice. The decode is
// float(raw) * scale, then + offset, each separately rounded
// (__fmul_rn/__fadd_rn), which keeps the result bit-exact against the
// plain PyTorch version.
#include "common.cuh"

#define MAX_MAPS 4
#define MAX_LEVELS 4

struct ExtractArgs {
  const void* tex[MAX_MAPS * MAX_LEVELS];   // map-major: [m * n_levels + k]
  long long rows[MAX_MAPS * MAX_LEVELS];
  long long cols[MAX_MAPS * MAX_LEVELS];    // also the row stride
  float scale[MAX_MAPS];
  float offset[MAX_MAPS];
  const int* lvl;
  const int* r0;
  const int* c0;
  void* out;
  int nblk, n_maps, n_levels, wh, ww, group, src_dtype, out_bf16;
};

__global__ void extract_group_kernel(const ExtractArgs a) {
  const int b = blockIdx.x;
  const int m = blockIdx.y;
  int k = a.lvl[b];
  k = k < 0 ? 0 : (k >= a.n_levels ? a.n_levels - 1 : k);
  const int slot = m * a.n_levels + k;
  const void* tex = a.tex[slot];
  const long long H = a.rows[slot], W = a.cols[slot];
  const long long r0 = a.r0[b], c0 = a.c0[b];
  const float scale = a.scale[m], offset = a.offset[m];
  const int g = b % a.group;
  const long long out_w = (long long)a.n_maps * a.ww;
  const long long out_row0 = (long long)(b / a.group) * a.group * a.wh
                             + (long long)g * a.wh;
  const int n = a.wh * a.ww;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / a.ww, c = e - r * a.ww;
    // callers pre-clamp origins; the clamp only keeps a bad origin from
    // reading outside the level
    long long rr = r0 + r, cc = c0 + c;
    rr = rr < 0 ? 0 : (rr >= H ? H - 1 : rr);
    cc = cc < 0 ? 0 : (cc >= W ? W - 1 : cc);
    float v = mrtx_load_f32(tex, rr * W + cc, a.src_dtype);
    if (scale != 1.0f) v = __fmul_rn(v, scale);
    if (offset != 0.0f) v = __fadd_rn(v, offset);
    const long long o = (out_row0 + r) * out_w + (long long)m * a.ww + c;
    if (a.out_bf16)
      ((__nv_bfloat16*)a.out)[o] = __float2bfloat16_rn(v);
    else
      ((float*)a.out)[o] = v;
  }
}

MRTX_EXPORT int mrtx_extract_group_windows(const ExtractArgs* a,
                                           cudaStream_t stream) {
  if (a->nblk == 0) return 0;
  dim3 grid(a->nblk, a->n_maps);
  extract_group_kernel<<<grid, 256, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// ---- K5: one window per block from the block's own level -----------------
//
// out[b] = levels[lvl[b]][r0[b]:r0[b]+wh, c0[b]:c0[b]+ww], decoded, as
// (nblk, wh, ww) f32. A level is addressed through a row stride and an
// element stride (in elements), so one channel plane of an (H, W, 3)
// uint8 level is read in place; such a plane cannot coalesce (three
// bytes between neighbouring texels), which is the map's layout. Texels
// outside the level (a level smaller than the window, or an origin the
// caller did not clamp) read as raw 0, as the zero padding of the TPU
// kernel's levels gives them; no address outside the level is formed.

struct LevelArgs {
  const void* tex[MAX_LEVELS];
  long long rows[MAX_LEVELS];
  long long cols[MAX_LEVELS];
  long long row_stride[MAX_LEVELS];    // elements between rows
  long long elem_stride[MAX_LEVELS];   // elements between columns
  const int* lvl;
  const int* r0;
  const int* c0;
  float* out;
  float scale, offset;
  int nblk, n_levels, wh, ww, src_dtype;
};

__global__ void extract_level_kernel(const LevelArgs a) {
  const int b = blockIdx.x;
  int k = a.lvl[b];
  k = k < 0 ? 0 : (k >= a.n_levels ? a.n_levels - 1 : k);
  const void* tex = a.tex[k];
  const long long H = a.rows[k], W = a.cols[k];
  const long long rs = a.row_stride[k], es = a.elem_stride[k];
  const long long r0 = a.r0[b], c0 = a.c0[b];
  const float scale = a.scale, offset = a.offset;
  const int n = a.wh * a.ww;
  float* out = a.out + (long long)b * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / a.ww, c = e - r * a.ww;
    const long long rr = r0 + r, cc = c0 + c;
    float v = 0.0f;
    if (rr >= 0 && rr < H && cc >= 0 && cc < W)
      v = mrtx_load_f32(tex, rr * rs + cc * es, a.src_dtype);
    if (scale != 1.0f) v = __fmul_rn(v, scale);
    if (offset != 0.0f) v = __fadd_rn(v, offset);
    out[e] = v;
  }
}

MRTX_EXPORT int mrtx_extract_level_windows(const LevelArgs* a,
                                           cudaStream_t stream) {
  if (a->nblk == 0) return 0;
  extract_level_kernel<<<a->nblk, 256, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

MRTX_ERROR_STRING_FN
