// Per-block window extraction with affine decode: K1 (grouped, multi-map,
// packed march layout, edges clamp) and K5 (one window per block, any
// block count, texels outside the level read as raw 0).
//
// K1 replaces the TPU kernel moonrtx_tpu/ops/extract.py::
// extract_group_windows_tpu (_make_group_kernel); K5 replaces
// extract_level_windows_tpu / extract_windows_tpu (_extract_impl,
// _make_kernel). The TPU kernels DMA a tile-aligned superwindow per block
// into VMEM and recompact it with one-hot MXU contractions because the
// TPU has no gather hardware; none of that comes across.
//
// Bound on Hopper: memory, the windows' writes above all (a 1080p pose
// writes 166 MB of f32 height windows, 498 MB of albedo, 199 MB of
// shadow|bounce; the distinct texels read are a tenth of that). The first
// design (a thread per texel and step) was bound by instruction issue
// instead: a run-time division per texel, 64-bit index and clamp
// arithmetic, a switch on the source type and one on the output type,
// one 1-4 byte load and one 2-4 byte store each. Design:
//  - templated on the source type, the output type, the vector width and
//    the edge rule: nothing in the row loop switches at run time;
//  - one thread block per window; thread (x, y, z) owns the 16-byte
//    output chunk x of segment y (a map, or a map's channel) in rows
//    z, z + blockDim.z, ... (about four rows a thread): no division in the
//    loop. Its V source columns, clamped or flagged as inside the level,
//    become 32-bit offsets once; each row costs a 64-bit row base, V
//    loads (adjacent ones off one address where all V columns lie inside
//    the level), V decodes and one 16-byte store, neighbouring threads on
//    neighbouring chunks;
//  - a map may hold its channels interleaved, an (H, W, C) level read as
//    whole texels in place. K1 writes channel c of map m as segment
//    m*C + c (the march kernel's channel-blocked columns), each thread
//    reading its texels' channel at a stride; K5 keeps the source's own
//    order, so its wrapper hands the level over as an (H, W*C) row of
//    bytes and the window as ww*C columns from c0*C: a plain copy with
//    conversion. Several maps (shadow|bounce) share one launch, side by
//    side in the output row;
//  - the decode is float(raw) * scale, then + offset, each separately
//    rounded (__fmul_rn/__fadd_rn, -fmad=false), identity steps skipped
//    (-0.0 stays -0.0): bit-exact against the plain PyTorch version.
// Loads stay scalar: a window row starts at any byte phase of its level,
// and one vector load where a thread's run happens to sit on its
// alignment gained on no launch but the bf16 one (measured); with the
// instructions above per texel the loop no longer limits.
#include <string.h>
#include <type_traits>

#include "common.cuh"

#define MAX_MAPS 4
#define MAX_LEVELS 4
#define MAX_BLOCK 1024

struct ExtractArgs {
  const void* tex[MAX_MAPS * MAX_LEVELS];   // map-major: [m * n_levels + k]
  long long rows[MAX_MAPS * MAX_LEVELS];
  long long cols[MAX_MAPS * MAX_LEVELS];
  long long row_stride[MAX_MAPS * MAX_LEVELS];    // elements
  long long col_stride[MAX_MAPS * MAX_LEVELS];    // elements
  long long chan_stride[MAX_MAPS * MAX_LEVELS];   // elements
  float scale[MAX_MAPS];
  float offset[MAX_MAPS];
  const int* lvl;
  const int* r0;
  const int* c0;
  void* out;
  // n_chan: channels per map, each its own output segment (K1); cmul
  // scales c0 (K5's interleaved levels, handed over as rows of W*C)
  int nblk, n_maps, n_chan, n_levels, wh, ww, cmul, src_dtype, out_bf16,
      rows_per_thread;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v) { return (float)v; }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V decoded values to V consecutive outputs (16 bytes when V > 1)
template <typename Tout, int V>
__device__ __forceinline__ void store(Tout* dst, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<Tout, float>::value) *dst = v[0];
    else *dst = __float2bfloat16_rn(v[0]);
  } else if constexpr (std::is_same<Tout, float>::value) {
    static_assert(V == 4, "16-byte f32 chunks");
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(V == 8, "16-byte bf16 chunks");
    __nv_bfloat162 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    uint4 u;
    memcpy(&u, h, sizeof(u));
    *reinterpret_cast<uint4*>(dst) = u;
  }
}

template <typename Tin, typename Tout, int V, bool ZERO>
__device__ __forceinline__ void extract_window(const ExtractArgs& a) {
  const int b = blockIdx.x;
  const int x = threadIdx.x, y = threadIdx.y;
  int k = a.lvl[b];
  k = k < 0 ? 0 : (k >= a.n_levels ? a.n_levels - 1 : k);
  const int m = a.n_chan == 1 ? y : y / a.n_chan;
  const int ch = y - m * a.n_chan;
  const int slot = m * a.n_levels + k;
  const Tin* tex = static_cast<const Tin*>(a.tex[slot]);
  const long long H = a.rows[slot];
  const int W = (int)a.cols[slot];   // the wrapper keeps offsets in int32
  const long long rs = a.row_stride[slot];
  const int cs = (int)a.col_stride[slot];
  const int chs = ch * (int)a.chan_stride[slot];
  const float scale = a.scale[m], offset = a.offset[m];
  const int r0 = a.r0[b];
  const int cfirst = a.c0[b] * a.cmul + x * V;
  // this thread's columns: offsets inside a row (clamped into the level
  // for K1; 0 for a column outside it for K5, never read) and which lie
  // inside the level
  int off[V];
  unsigned inside = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    int cc = cfirst + i;
    const bool in = cc >= 0 && cc < W;
    inside |= (unsigned)in << i;
    if constexpr (ZERO) cc = in ? cc : 0;
    else cc = cc < 0 ? 0 : (cc >= W ? W - 1 : cc);
    off[i] = cc * cs + chs;
  }
  // all columns inside and adjacent: V consecutive texels from off[0]
  const bool run = inside == (1u << V) - 1u && cs == 1;
  const int row_len = a.n_maps * a.n_chan * a.ww;
  Tout* dst = static_cast<Tout*>(a.out) + (long long)b * a.wh * row_len
              + y * a.ww + x * V;
  for (int r = threadIdx.z; r < a.wh; r += blockDim.z) {
    long long rr = (long long)r0 + r;
    bool row_in = true;
    if constexpr (ZERO) {
      row_in = rr >= 0 && rr < H;
      if (!row_in) rr = 0;
    } else {
      rr = rr < 0 ? 0 : (rr >= H ? H - 1 : rr);
    }
    const Tin* src = tex + rr * rs;
    float v[V];
    if (run && row_in) {
      const Tin* p = src + off[0];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        v[i] = (row_in && (!ZERO || ((inside >> i) & 1u)))
                   ? to_f32(src[off[i]]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (scale != 1.0f) v[i] = __fmul_rn(v[i], scale);
      if (offset != 0.0f) v[i] = __fadd_rn(v[i], offset);
    }
    store<Tout, V>(dst + r * row_len, v);
  }
}

// K1: edges clamp into the level; f32 or bf16 out
template <typename Tin, typename Tout, int V>
__global__ void extract_group_kernel(const __grid_constant__ ExtractArgs a) {
  extract_window<Tin, Tout, V, false>(a);
}

// K5: texels outside the level are raw 0; f32 out
template <typename Tin, int V>
__global__ void extract_level_kernel(const __grid_constant__ ExtractArgs a) {
  extract_window<Tin, float, V, true>(a);
}

// Threads (ww/V, segments, rows): each thread walks a.rows_per_thread
// rows of the window (its set-up paid once for them), or as close to it
// as the 1,024 threads of a block allow, all threads the same number.
static int block_of(const ExtractArgs& a, int v, dim3* block) {
  const int x = a.ww / v, segs = a.n_maps * a.n_chan;
  if (x * segs > MAX_BLOCK) return (int)cudaErrorInvalidValue;
  const int cap = MAX_BLOCK / (x * segs) < 64 ? MAX_BLOCK / (x * segs) : 64;
  int rz = (a.wh + a.rows_per_thread - 1) / a.rows_per_thread;
  rz = rz > cap ? cap : rz;
  const int iters = (a.wh + rz - 1) / rz;
  *block = dim3(x, segs, (a.wh + iters - 1) / iters);
  return 0;
}

template <typename Tin, typename Tout, bool ZERO>
static int launch(const ExtractArgs& a, cudaStream_t stream) {
  constexpr int VV = 16 / (int)sizeof(Tout);
  const bool vec = a.ww % VV == 0;
  dim3 block;
  const int err = block_of(a, vec ? VV : 1, &block);
  if (err) return err;
  if constexpr (ZERO) {
    if (vec) extract_level_kernel<Tin, VV><<<a.nblk, block, 0, stream>>>(a);
    else extract_level_kernel<Tin, 1><<<a.nblk, block, 0, stream>>>(a);
  } else {
    if (vec)
      extract_group_kernel<Tin, Tout, VV><<<a.nblk, block, 0, stream>>>(a);
    else
      extract_group_kernel<Tin, Tout, 1><<<a.nblk, block, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename Tout, bool ZERO>
static int dispatch(const ExtractArgs& a, cudaStream_t stream) {
  switch (a.src_dtype) {
    case MRTX_F32: return launch<float, Tout, ZERO>(a, stream);
    case MRTX_I16: return launch<int16_t, Tout, ZERO>(a, stream);
    case MRTX_U8: return launch<uint8_t, Tout, ZERO>(a, stream);
    case MRTX_BF16:
      if constexpr (!ZERO) return launch<__nv_bfloat16, Tout, ZERO>(a, stream);
      [[fallthrough]];
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool bad_shape(const ExtractArgs* a) {
  return a->wh <= 0 || a->ww <= 0 || a->n_maps < 1 || a->n_maps > MAX_MAPS
         || a->n_levels < 1 || a->n_levels > MAX_LEVELS || a->n_chan < 1
         || a->n_maps * a->n_chan > MAX_BLOCK || a->rows_per_thread < 1;
}

MRTX_EXPORT int mrtx_extract_group_windows(const ExtractArgs* a,
                                           cudaStream_t stream) {
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (a->nblk == 0) return 0;
  return a->out_bf16 ? dispatch<__nv_bfloat16, false>(*a, stream)
                     : dispatch<float, false>(*a, stream);
}

MRTX_EXPORT int mrtx_extract_level_windows(const ExtractArgs* a,
                                           cudaStream_t stream) {
  if (bad_shape(a) || a->out_bf16) return (int)cudaErrorInvalidValue;
  if (a->nblk == 0) return 0;
  return dispatch<float, true>(*a, stream);
}

MRTX_ERROR_STRING_FN
