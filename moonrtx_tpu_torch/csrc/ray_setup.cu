// The ray setup of an accumulation sample (KR): engine/blocked.py::
// block_rays in one launch (moonrtx_tpu_torch/ops/ray_setup.py).
//
// Replaces no TPU kernel: the JAX package's block_rays
// (moonrtx_tpu/engine/blocked.py:199) is jnp code that XLA fuses; run op
// by op in plain torch it is about a hundred launches on 2M-ray planes,
// each issued by the host. One 128-thread block per 8x16-pixel block, a
// thread a ray, in the block layout of engine/blocked.py::to_blocks. Each
// thread builds its jittered image-plane direction (written to the (H, W,
// 3) scene-frame plane when the caller wants it), rotates it into the body
// frame, and intersects the outer shell and the inner sphere. Without a
// cached chord bound but with the dilated coarse max map, the block's 16
// sampled rays (every 8th) give 6 chord fractions each; one thread takes
// one of the 96 points and reads the max map there, and the block's
// maximum through shared memory is its bound. Each ray's chord is then
// clipped to the local-max sphere, and the rays without a chord collapse
// to the mean entry of the block's live rays (0 when it has none).
//
// Every operation follows the plain version's float32 arithmetic as torch
// computes it on the card, built with -fmad=false: a division by a host
// number is a product with its float32 reciprocal; a 3-element sum adds
// (x0 + x2) + x1; remainder is fmodf plus the divisor where the signs
// differ; torch.linspace's fractions and rad2deg's constant come as
// torch makes them; asinf and atan2f are the card's own; the mean's sum
// is torch's nansum over 128 values on the card (see block_nansum). So
// the kernel gives the plain version's rays bit for bit, as long as torch
// keeps those orders. Bound: its writes, ~33 bytes a ray.
#include "common.cuh"

#define BH 8               // block rows (engine/blocked.py BLOCK_H)
#define BW 16              // block columns (BLOCK_W)
#define NRAY (BH * BW)     // rays of a block, one thread each
#define NSAMP 16           // chord-sampled rays of a block: every 8th
#define NFRAC 6            // chord fractions of a sampled ray
#define NCAM 22            // eye | forward | right | up | tan_half_fov |
                           // rotation (row-major)

struct RaySetupArgs {
  const float* eye;        // (3,) scene-frame eye
  const float* forward;    // (3,) camera basis
  const float* right;
  const float* up;
  const float* tan_half_fov;  // one number
  const float* rotation;   // (3, 3) body to scene, row-major
  const float* jitter;     // (2,) (row, column) sub-pixel offset, or null
  const float* maxmap;     // (mh, mw) dilated coarse max heights, or null
  const float* hbound_in;  // (nblk,) a cached chord bound, or null
  float* dirs;             // (height, width, 3) scene-frame rays, or null
  float* db;               // (nblk, 128, 3) body-frame rays
  float* ob;               // (3,) body-frame eye
  float* t_enter;          // (nblk, 128)
  float* t_end;            // (nblk, 128)
  uint8_t* hit_outer;      // (nblk, 128) bool
  float* hbound_out;       // (nblk,) the bound computed here, or null
  float frac[NFRAC];       // torch.linspace(0, 1, 6) in float32
  float row_offset, inv_fh, inv_width, w_over_fh;
  float moon_r, r2_outer, r2_inner, rad2deg, inv_180, inv_360, mh_f, mw_f,
      margin;
  int mh, mw, width, wbk, nblk;
};

// torch.sum over three elements on the card: two threads, the first adds
// elements 0 and 2, then the second's element 1
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

// torch's nansum over one block's 128 values (the first warp's result in
// its lane 0): the reduction kernel gives each output one warp, a lane a
// vector of four neighbouring values, each added to zero, then summed in
// order, and folds the lanes by shuffles of halving offsets.
__device__ __forceinline__ float block_nansum(const float* x, int lane) {
  float s = (((0.0f + x[4 * lane]) + (0.0f + x[4 * lane + 1]))
             + (0.0f + x[4 * lane + 2])) + (0.0f + x[4 * lane + 3]);
  for (int off = 16; off > 0; off >>= 1)
    s = s + __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __launch_bounds__(NRAY)
    ray_setup_kernel(const RaySetupArgs a) {
  __shared__ float cam[NCAM];
  __shared__ float sdb[NSAMP][3], ste[NSAMP], stn[NSAMP];
  __shared__ float vals[NRAY];
  __shared__ float wmax[NRAY / 32];
  __shared__ float smean;
  const int blk = blockIdx.x;
  const int t = threadIdx.x;
  if (t < NCAM) {
    cam[t] = t < 3 ? a.eye[t]
           : t < 6 ? a.forward[t - 3]
           : t < 9 ? a.right[t - 6]
           : t < 12 ? a.up[t - 9]
           : t == 12 ? a.tan_half_fov[0]
           : a.rotation[t - 13];
  }
  __syncthreads();
  const float* M = cam + 13;

  // the body-frame eye: transpose(rotation) times eye
  const float obx = cam[0] * M[0] + cam[1] * M[3] + cam[2] * M[6];
  const float oby = cam[0] * M[1] + cam[1] * M[4] + cam[2] * M[7];
  const float obz = cam[0] * M[2] + cam[1] * M[5] + cam[2] * M[8];
  if (blk == 0 && t == 0) {
    a.ob[0] = obx;
    a.ob[1] = oby;
    a.ob[2] = obz;
  }

  // the jittered direction of the ray's pixel, normalised
  const int y = (blk / a.wbk) * BH + t / BW;
  const int x = (blk % a.wbk) * BW + t % BW;
  const float jy = a.jitter ? a.jitter[0] : 0.0f;
  const float jx = a.jitter ? a.jitter[1] : 0.0f;
  const float v =
      1.0f - 2.0f * ((((float)y + a.row_offset) + 0.5f) + jy) * a.inv_fh;
  const float u =
      (2.0f * (((float)x + 0.5f) + jx) * a.inv_width - 1.0f) * a.w_over_fh;
  float d0 = cam[3] + cam[12] * (u * cam[6] + v * cam[9]);
  float d1 = cam[4] + cam[12] * (u * cam[7] + v * cam[10]);
  float d2 = cam[5] + cam[12] * (u * cam[8] + v * cam[11]);
  const float nrm = sqrtf(fmaxf(sum3(d0 * d0, d1 * d1, d2 * d2), 1e-20f));
  d0 = d0 / nrm;
  d1 = d1 / nrm;
  d2 = d2 / nrm;
  if (a.dirs) {
    float* o = a.dirs + ((long long)y * a.width + x) * 3;
    o[0] = d0;
    o[1] = d1;
    o[2] = d2;
  }
  const float dbx = d0 * M[0] + d1 * M[3] + d2 * M[6];
  const float dby = d0 * M[1] + d1 * M[4] + d2 * M[7];
  const float dbz = d0 * M[2] + d1 * M[5] + d2 * M[8];

  // chords through the outer shell and to the inner sphere
  const float oo = sum3(obx * obx, oby * oby, obz * obz);
  const float bb = sum3(obx * dbx, oby * dby, obz * dbz);
  const float disc = bb * bb - (oo - a.r2_outer);
  bool hit = disc > 0.0f;
  const float so = sqrtf(fmaxf(disc, 0.0f));
  float te = fmaxf(-bb - so, 0.0f);
  const float disc_in = bb * bb - (oo - a.r2_inner);
  const float t_in = -bb - sqrtf(fmaxf(disc_in, 0.0f));
  float tn = (disc_in > 0.0f && t_in > 0.0f) ? t_in : -bb + so;

  // the block's local height bound: cached, or from the max map at 6
  // fractions of the chords of every 8th ray
  float hb = 0.0f;
  const bool bounded = a.hbound_in != nullptr || a.maxmap != nullptr;
  if (a.hbound_in) {
    hb = a.hbound_in[blk];
  } else if (a.maxmap) {
    if ((t & 7) == 0) {
      const int s = t >> 3;
      sdb[s][0] = dbx;
      sdb[s][1] = dby;
      sdb[s][2] = dbz;
      ste[s] = te;
      stn[s] = tn;
    }
    __syncthreads();
    float m = -3.4e38f;         // below every height
    if (t < NSAMP * NFRAC) {
      const int s = t / NFRAC, f = t % NFRAC;
      const float ts = ste[s] + (stn[s] - ste[s]) * a.frac[f];
      const float px = obx + ts * sdb[s][0];
      const float py = oby + ts * sdb[s][1];
      const float pz = obz + ts * sdb[s][2];
      const float r = sqrtf(sum3(px * px, py * py, pz * pz));
      const float lat = asinf(fminf(fmaxf(pz / r, -1.0f), 1.0f)) * a.rad2deg;
      const float lon = atan2f(px, -py) * a.rad2deg;
      const int row = min(max((int)((90.0f - lat) * a.inv_180 * a.mh_f), 0),
                          a.mh - 1);
      float rem = fmodf(lon + 180.0f, 360.0f);
      if (rem != 0.0f && rem < 0.0f) rem += 360.0f;
      const int col = min(max((int)(rem * a.inv_360 * a.mw_f), 0),
                          a.mw - 1);
      m = a.maxmap[row * a.mw + col];
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((t & 31) == 0) wmax[t >> 5] = m;
    __syncthreads();
    hb = fmaxf(fmaxf(wmax[0], wmax[1]), fmaxf(wmax[2], wmax[3])) + a.margin;
    if (t == 0) a.hbound_out[blk] = hb;
  }
  if (bounded) {
    // the chord clipped to the segment inside the local-max sphere
    const float r_bound = a.moon_r * fminf(hb, 1.0f);
    const float dc = bb * bb - (oo - r_bound * r_bound);
    const bool crosses = dc > 0.0f;
    const float sq = sqrtf(fmaxf(dc, 0.0f));
    te = fmaxf(te, crosses ? -bb - sq : te);
    tn = fminf(tn, crosses ? -bb + sq : tn);
    hit = hit && crosses && tn > te;
  }

  // rays without a chord collapse to the mean entry of the live ones
  vals[t] = hit ? te : 0.0f;
  const int live = __syncthreads_count(hit);
  if (t < 32) {
    const float s = block_nansum(vals, t);
    if (t == 0) smean = live > 0 ? s / (float)live : 0.0f;
  }
  __syncthreads();
  if (!hit) {
    te = smean;
    tn = smean;
  }

  const long long ray = (long long)blk * NRAY + t;
  a.db[3 * ray] = dbx;
  a.db[3 * ray + 1] = dby;
  a.db[3 * ray + 2] = dbz;
  a.t_enter[ray] = te;
  a.t_end[ray] = tn;
  a.hit_outer[ray] = hit ? 1 : 0;
}

MRTX_EXPORT int mrtx_ray_setup(const RaySetupArgs* a, cudaStream_t stream) {
  if (a->wbk < 1 || (a->maxmap && (a->mh < 1 || a->mw < 1)))
    return (int)cudaErrorInvalidValue;
  if (a->nblk == 0) return 0;
  ray_setup_kernel<<<a->nblk, NRAY, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

MRTX_ERROR_STRING_FN
