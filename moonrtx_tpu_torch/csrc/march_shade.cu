// K2: fused per-ray march + shade, one accumulation sample per launch.
//
// Replaces the TPU kernel moonrtx_tpu/ops/pallas_march.py::
// march_shade_pallas (_make_kernel). The TPU kernel turned every
// bilinear fetch into one-hot MXU contractions over per-block windows
// because the TPU has no gather hardware; here each sample reads its four
// texels. The rounding points are the TPU kernel's: window values and one
// axis of hat weights in bf16, the other axis in f32, sums in f32,
// atan2 by the kernel's polynomial (atan2_poly.cuh); built with
// -fmad=false so products and sums round separately.
//
// Bound on Hopper: memory at the bound's count (~1 GB per 1080p launch:
// the ray planes, scal and the three window tensors read once, 8 output
// planes written), but the march itself is ~20 dependent field
// evaluations per ray, so a first version is latency-bound on that chain.
// Design: one 1024-thread block per 8x128-ray strip, one thread per ray.
// The strip's eight height windows (the only data every field evaluation
// reads) are staged once in shared memory as bf16 (40 KB); albedo and
// shadow|bounce windows are read from global memory by the few taps that
// shading needs. The warm-start vote is __syncthreads_or over all 1024
// rays of the strip, the same decision as the TPU kernel's strip sum, so
// warm samples pick the same brackets. Strips with no active ray, and
// strips where no ray found a hit, write zeros and stop (bit-identical:
// every output is masked by the hit flag). The burst kernel at the end of
// the file runs the warm samples of an accumulation on the same device code.
#include "common.cuh"
#include "atan2_poly.cuh"

#define G 8
#define B 128
#define NRAY (G * B)
#define WH 40
#define WW 64
#define AH 40
#define AW 64
#define SH 32
#define SW 48
#define NSCAL 10
#define NPAR 27
#define MAX_COARSE 32

struct MarchArgs {
  const float* params;
  const float* dbx;
  const float* dby;
  const float* dbz;
  const float* t0;
  const float* t1;
  const float* act;
  const float* tprev;
  const float* fprev;
  const float* scal;
  const float* hwin;
  const float* awin;
  const __nv_bfloat16* swin;
  float* out[8];
  float frac[MAX_COARSE];
  float frac_prev[MAX_COARSE];
  float h_f, w_f, h_over_180, w_over_360, h_over_pi, pi_over_h, inv_n_coarse;
  int ns, n_coarse, n_bisect, use_shadow, use_earth, warm;
};

constexpr float kRad2Deg = (float)(180.0 / 3.141592653589793);
constexpr float kPi = 3.141592653589793f;
constexpr float kMoonR = 10.0f;   // constants.MOON_RADIUS

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float hat(float j, float x) {
  return fmaxf(0.0f, 1.0f - fabsf(j - x));
}

__device__ __forceinline__ float ldv(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ldv(const float* p, int i) {
  return mrtx_bf16(p[i]);   // the TPU kernel casts windows to bf16
}

// bf16 column weights, f32 row weights (pallas_march._bsample)
template <typename T>
__device__ __forceinline__ float sample_colbf(const T* win, int stride,
                                              int nh, int nw, float wy,
                                              float wx) {
  wy = clipf(wy, 0.0f, (float)(nh - 1.001));
  wx = clipf(wx, 0.0f, (float)(nw - 1.001));
  const float y0 = floorf(wy), x0 = floorf(wx);
  const float r0 = hat(y0, wy), r1 = hat(y0 + 1.0f, wy);
  const float c0 = mrtx_bf16(hat(x0, wx)), c1 = mrtx_bf16(hat(x0 + 1.0f, wx));
  const int o = (int)y0 * stride + (int)x0;
  const float m0 = ldv(win, o) * c0 + ldv(win, o + 1) * c1;
  const float m1 = ldv(win, o + stride) * c0 + ldv(win, o + stride + 1) * c1;
  return m0 * r0 + m1 * r1;
}

// bf16 row weights, f32 column weights (the row-first contractions)
template <typename T>
__device__ __forceinline__ float sample_rowbf(const T* win, int stride,
                                              int nh, int nw, float wy,
                                              float wx) {
  wy = clipf(wy, 0.0f, (float)(nh - 1.001));
  wx = clipf(wx, 0.0f, (float)(nw - 1.001));
  const float y0 = floorf(wy), x0 = floorf(wx);
  const float r0 = mrtx_bf16(hat(y0, wy)), r1 = mrtx_bf16(hat(y0 + 1.0f, wy));
  const float c0 = hat(x0, wx), c1 = hat(x0 + 1.0f, wx);
  const int o = (int)y0 * stride + (int)x0;
  const float m0 = ldv(win, o) * r0 + ldv(win, o + stride) * r1;
  const float m1 = ldv(win, o + 1) * r0 + ldv(win, o + stride + 1) * r1;
  return m0 * c0 + m1 * c1;
}

struct Ray {
  float obx, oby, obz, dbx, dby, dbz;
  float r0, c0, hmean, q;
  float h180, w360, w_f;
  const __nv_bfloat16* hw;   // this block's height window (shared memory)
};

__device__ __forceinline__ void latlon(float px, float py, float pz,
                                       float& lat, float& lon) {
  lat = mrtx_atan2(pz, sqrtf(fmaxf(px * px + py * py, 1e-20f)));
  lon = mrtx_atan2(px, -py);
}

__device__ __forceinline__ void hcoords(const Ray& R, float lat, float lon,
                                        float& wy, float& wx) {
  float row = (90.0f - lat * kRad2Deg) * R.h180 - 0.5f;
  float lon_w = lon * kRad2Deg + 180.0f;
  lon_w = lon_w - 360.0f * floorf(lon_w / 360.0f);
  float col = lon_w * R.w360 - 0.5f;
  col = col < 0.0f ? col + R.w_f : col;
  row = (row + 0.5f) / R.q - 0.5f;
  col = (col + 0.5f) / R.q - 0.5f;
  col = col < R.c0 - 0.5f ? col + R.w_f / R.q : col;
  wy = row - R.r0;
  wx = col - R.c0;
}

__device__ __forceinline__ float field(const Ray& R, float t) {
  const float px = R.obx + t * R.dbx;
  const float py = R.oby + t * R.dby;
  const float pz = R.obz + t * R.dbz;
  float lat, lon, wy, wx;
  latlon(px, py, pz, lat, lon);
  hcoords(R, lat, lon, wy, wx);
  const float r = sqrtf(px * px + py * py + pz * pz);
  return r - kMoonR * (sample_colbf(R.hw, WW, WH, WW, wy, wx) + R.hmean);
}

__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }

// The strip's eight height windows, as bf16, into shared memory.
__device__ __forceinline__ void stage_heights(const float* hwin, int s,
                                              int tid, __nv_bfloat16* hw) {
  const float* hsrc = hwin + (long long)s * G * WH * WW;
  for (int e = tid; e < G * WH * WW; e += NRAY)
    hw[e] = __float2bfloat16_rn(hsrc[e]);
}

// A ray's fixed part: the eye, its block's window origins and level.
__device__ __forceinline__ Ray strip_ray(const MarchArgs& a, const float* P,
                                         const float* sc,
                                         const __nv_bfloat16* hw) {
  Ray R;
  R.obx = P[0]; R.oby = P[1]; R.obz = P[2];
  R.r0 = sc[0 * NRAY]; R.c0 = sc[1 * NRAY]; R.hmean = sc[2 * NRAY];
  R.q = sc[3 * NRAY];
  R.h180 = a.h_over_180; R.w360 = a.w_over_360; R.w_f = a.w_f;
  R.hw = hw;
  return R;
}

struct Bracket {
  float found, t_lo, t_hi, f_lo, f_hi;
};

// The bracket of the surface on [t_enter, t_end]. Warm: t_prev +- one
// coarse step, kept only if EVERY active ray of the strip brackets its
// previous hit; otherwise (and cold) the coarse march. Every thread of
// the block calls it (the vote is a barrier).
__device__ __forceinline__ Bracket bracket(const MarchArgs& a, const Ray& R,
                                           float t_enter, float t_end,
                                           float activef, bool warm,
                                           float tp, float fp) {
  const float span = t_end - t_enter;
  Bracket b = {0.0f, t_enter, t_end, 1.0f, -1.0f};
  bool cold = true;
  if (warm) {
    const float delta = span * a.inv_n_coarse;
    const float ta = fmaxf(tp - delta, t_enter);
    const float tb = fminf(tp + delta, t_end);
    const float fa = field(R, ta), fb = field(R, tb);
    const float good = (fa > 0.0f ? 1.0f : 0.0f) * (fb < 0.0f ? 1.0f : 0.0f)
                       * fp;
    if (!__syncthreads_or(activef * (1.0f - good) != 0.0f)) {
      cold = false;
      b = {activef, ta, tb, fa, fb};
    }
  }
  if (cold) {
    float f_back = field(R, t_enter);
    for (int k = 0; k <= a.n_coarse; ++k) {
      const float t_k = t_enter + span * a.frac[k];
      const float f_k = field(R, t_k);
      const float newly = (1.0f - b.found) * (f_k < 0.0f ? 1.0f : 0.0f)
                          * activef;
      const float t_pk = t_enter + span * a.frac_prev[k];
      if (newly > 0.5f) {
        b.t_lo = t_pk; b.t_hi = t_k; b.f_lo = f_back; b.f_hi = f_k;
      }
      b.found = fmaxf(b.found, newly);
      f_back = f_k;
    }
  }
  return b;
}

// Illinois false position on the bracket; the hit distance.
__device__ __forceinline__ float refine(const Ray& R, int n_iter, Bracket b) {
  for (int it = 0; it < n_iter; ++it) {
    const float denom = fminf(b.f_hi - b.f_lo, -1e-30f);
    const float t_m = clipf(b.t_lo - b.f_lo * (b.t_hi - b.t_lo) / denom,
                            b.t_lo, b.t_hi);
    const float f_m = field(R, t_m);
    if (f_m > 0.0f) {
      b.t_lo = t_m; b.f_lo = f_m; b.f_hi = 0.5f * b.f_hi;
    } else {
      b.t_hi = t_m; b.f_hi = f_m; b.f_lo = 0.5f * b.f_lo;
    }
  }
  const float den2 = fminf(b.f_hi - b.f_lo, -1e-30f);
  return clipf(b.t_lo - b.f_lo * (b.t_hi - b.t_lo) / den2, b.t_lo, b.t_hi);
}

// Normal, albedo, shadow and bounce, lighting, eclipse and earthshine at
// the hit: the 8 outputs (r, g, b, hit, t_hit, px, py, pz), masked by hitf.
__device__ __forceinline__ void shade(const MarchArgs& a, const float* P,
                                      const Ray& R, const float* sc, int s,
                                      int g, float t_hit, bool hitf,
                                      float* o) {
  const float px = R.obx + t_hit * R.dbx;
  const float py = R.oby + t_hit * R.dby;
  const float pz = R.obz + t_hit * R.dbz;
  float lat, lon;
  latlon(px, py, pz, lat, lon);

  // normal: central differences with a footprint-matched per-ray step
  const float inv_p = rsq(fmaxf(px * px + py * py + pz * pz, 1e-20f));
  const float cosv = fmaxf(fabsf((px * R.dbx + py * R.dby + pz * R.dbz)
                                 * inv_p), 0.05f);
  const float arc = t_hit * P[16] / (kMoonR * cosv);
  const float step = clipf(0.5f * arc * a.h_over_pi / R.q, 0.5f, 3.0f);
  const float dlat = a.pi_over_h * R.q * step;
  const float coslat = fmaxf(cosf(lat), 0.05f);
  const float dlon = dlat / coslat;

  float wy_c, wx_e, wy_t, wx_w, wy_n, wx_c, wy_s, wx_t;
  hcoords(R, lat, lon + dlon, wy_c, wx_e);
  hcoords(R, lat, lon - dlon, wy_t, wx_w);
  hcoords(R, lat + dlat, lon, wy_n, wx_c);
  hcoords(R, lat - dlat, lon, wy_s, wx_t);
  const float h_e = sample_rowbf(R.hw, WW, WH, WW, wy_c, wx_e) + R.hmean;
  const float h_w = sample_rowbf(R.hw, WW, WH, WW, wy_c, wx_w) + R.hmean;
  const float h_n = sample_colbf(R.hw, WW, WH, WW, wy_n, wx_c) + R.hmean;
  const float h_s = sample_colbf(R.hw, WW, WH, WW, wy_s, wx_c) + R.hmean;
  float ex, ey, ez, wx_, wy_, wz_, nx_, ny_, nz_, sx_, sy_, sz_;
  {
    float rr = kMoonR * h_e, cl = cosf(lat), lo = lon + dlon;
    ex = rr * cl * sinf(lo); ey = -rr * cl * cosf(lo); ez = rr * sinf(lat);
    rr = kMoonR * h_w; lo = lon - dlon;
    wx_ = rr * cl * sinf(lo); wy_ = -rr * cl * cosf(lo); wz_ = rr * sinf(lat);
    float la = lat + dlat;
    rr = kMoonR * h_n; cl = cosf(la);
    nx_ = rr * cl * sinf(lon); ny_ = -rr * cl * cosf(lon); nz_ = rr * sinf(la);
    la = lat - dlat;
    rr = kMoonR * h_s; cl = cosf(la);
    sx_ = rr * cl * sinf(lon); sy_ = -rr * cl * cosf(lon); sz_ = rr * sinf(la);
  }
  const float ax = ex - wx_, ay = ey - wy_, az = ez - wz_;
  const float bx = nx_ - sx_, by = ny_ - sy_, bz = nz_ - sz_;
  float nX = ay * bz - az * by;
  float nY = az * bx - ax * bz;
  float nZ = ax * by - ay * bx;
  const float inv = rsq(fmaxf(nX * nX + nY * nY + nZ * nZ, 1e-20f));
  nX = nX * inv; nY = nY * inv; nZ = nZ * inv;
  const float sgn = (nX * px + nY * py + nZ * pz < 0.0f) ? -1.0f : 1.0f;
  nX = nX * sgn; nY = nY * sgn; nZ = nZ * sgn;

  // albedo: channel-major window columns R|G|B at the albedo level
  const float ah2 = P[17], aw2 = P[18];
  float arow = (90.0f - lat * kRad2Deg) * (ah2 / 180.0f) - 0.5f;
  float lon_w = lon * kRad2Deg + 180.0f;
  lon_w = lon_w - 360.0f * floorf(lon_w / 360.0f);
  float acol = lon_w * (aw2 / 360.0f) - 0.5f;
  acol = acol < 0.0f ? acol + aw2 : acol;
  arow = (arow + 0.5f) / R.q - 0.5f;
  acol = (acol + 0.5f) / R.q - 0.5f;
  const float ac0 = sc[5 * NRAY];
  acol = acol < ac0 - 0.5f ? acol + aw2 / R.q : acol;
  const float awy = arow - sc[4 * NRAY], awx = acol - ac0;
  const float* aw = a.awin + ((long long)s * G + g) * AH * 3 * AW;
  const float alb_r = sample_rowbf(aw, 3 * AW, AH, AW, awy, awx);
  const float alb_g = sample_rowbf(aw + AW, 3 * AW, AH, AW, awy, awx);
  const float alb_b = sample_rowbf(aw + 2 * AW, 3 * AW, AH, AW, awy, awx);

  float shadow = 1.0f, bounce = 0.0f;
  if (a.use_shadow) {
    const float rows_c = P[7], rows_f = P[8], n_phi = P[9];
    const float szx = P[10], szy = P[11], szz = P[12];
    const float sxx = P[13], sxy = P[14], sxz = P[15];
    const float syx = szy * sxz - szz * sxy;
    const float syy = szz * sxx - szx * sxz;
    const float syz = szx * sxy - szy * sxx;
    const float zc = px * szx + py * szy + pz * szz;
    const float xc = px * sxx + py * sxy + pz * sxz;
    const float yc = px * syx + py * syy + pz * syz;
    const float rho = sqrtf(fmaxf(xc * xc + yc * yc, 1e-20f));
    const float theta = mrtx_atan2(rho, zc) * kRad2Deg;
    float phi = mrtx_atan2(yc, xc);
    phi = phi < 0.0f ? phi + (float)(2.0 * 3.141592653589793) : phi;
    float srow = theta < 75.0f
        ? theta * (rows_c / 75.0f)
        : rows_c + (theta - 75.0f) * ((rows_f - 1.0f) / 30.0f);
    srow = fminf(srow, rows_c + rows_f - 1.001f);
    float scol = phi * (n_phi / (float)(2.0 * 3.141592653589793)) - 0.5f;
    scol = scol < 0.0f ? scol + n_phi : scol;
    const float sq = sc[8 * NRAY], sr0 = sc[6 * NRAY], sc0 = sc[7 * NRAY];
    srow = (srow + 0.5f) / sq - 0.5f;
    scol = (scol + 0.5f) / sq - 0.5f;
    scol = scol < sc0 - 0.5f ? scol + n_phi / sq : scol;
    const __nv_bfloat16* sw = a.swin + ((long long)s * G + g) * SH * 2 * SW;
    shadow = sample_rowbf(sw, 2 * SW, SH, SW, srow - sr0, scol - sc0);
    bounce = sample_rowbf(sw + SW, 2 * SW, SH, SW, srow - sr0, scol - sc0);
    const bool night = theta * 1.0f >= 105.0f;
    shadow = night ? 0.0f : clipf(shadow, 0.0f, 1.0f);
    bounce = night ? 0.0f : fmaxf(bounce, 0.0f);
  }

  // Lambert with the LOD roughness term (engine.render.soft_ndotl)
  const float sigma = sc[9 * NRAY];
  const float tlx = P[3] - px, tly = P[4] - py, tlz = P[5] - pz;
  const float inv_l = rsq(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f));
  const float mu = (nX * tlx + nY * tly + nZ * tlz) * inv_l;
  const float s_eff = sigma * sqrtf(fmaxf(1.0f - mu * mu, 0.0f)) + 1e-6f;
  const float xs = mu / s_eff;
  const float cdf = 1.0f / (1.0f + expf(clipf(-1.702f * xs, -60.0f, 60.0f)));
  const float pdf = 0.39894228f * expf(-0.5f * fminf(xs * xs, 120.0f));
  const float soft = fmaxf(mu * cdf + s_eff * pdf, 0.0f);
  float ndotl = sigma > 1e-6f ? soft : fmaxf(mu, 0.0f);
  const float lblend = P[19];
  const float mu_e = fmaxf(-(nX * R.dbx + nY * R.dby + nZ * R.dbz), 0.02f);
  const float ls = 2.0f * ndotl / (ndotl + mu_e + 1e-6f);
  ndotl = lblend * ls + (1.0f - lblend) * ndotl;
  const float irr = P[6];
  const float lum = hitf ? irr * (ndotl * shadow + bounce) : 0.0f;

  float tint0 = 1.0f, tint1 = 1.0f, tint2 = 1.0f, lum_es = 0.0f;
  if (a.use_earth) {
    const float edist = P[23], e_ang = P[24], s_ang = P[25];
    const float evx = P[20] * edist - px;
    const float evy = P[21] * edist - py;
    const float evz = P[22] * edist - pz;
    const float inv_e = rsq(fmaxf(evx * evx + evy * evy + evz * evz, 1e-20f));
    const float ex_ = evx * inv_e, ey_ = evy * inv_e, ez_ = evz * inv_e;
    const float lxp = P[3], lyp = P[4], lzp = P[5];
    const float inv_lc = rsq(fmaxf(lxp * lxp + lyp * lyp + lzp * lzp, 1e-20f));
    const float lx_ = lxp * inv_lc, ly_ = lyp * inv_lc, lz_ = lzp * inv_lc;
    const float cosd = ex_ * lx_ + ey_ * ly_ + ez_ * lz_;
    const float crx = ey_ * lz_ - ez_ * ly_;
    const float cry = ez_ * lx_ - ex_ * lz_;
    const float crz = ex_ * ly_ - ey_ * lx_;
    const float sind = sqrtf(fmaxf(crx * crx + cry * cry + crz * crz, 0.0f));
    const float sep = mrtx_atan2(sind, cosd);
    const float d = clipf(sep, fabsf(e_ang - s_ang) + 1e-7f,
                          s_ang + e_ang - 1e-7f);
    const float c1 = clipf((d * d + s_ang * s_ang - e_ang * e_ang)
                           / (2.0f * d * s_ang), -1.0f, 1.0f);
    const float c2 = clipf((d * d + e_ang * e_ang - s_ang * s_ang)
                           / (2.0f * d * e_ang), -1.0f, 1.0f);
    const float tri = (-d + s_ang + e_ang) * (d + s_ang - e_ang)
                      * (d - s_ang + e_ang) * (d + s_ang + e_ang);
    const float acos1 = mrtx_atan2(sqrtf(fmaxf(1.0f - c1 * c1, 0.0f)), c1);
    const float acos2 = mrtx_atan2(sqrtf(fmaxf(1.0f - c2 * c2, 0.0f)), c2);
    const float lens = s_ang * s_ang * acos1 + e_ang * e_ang * acos2
                       - 0.5f * sqrtf(fmaxf(tri, 0.0f));
    float cov = lens / (kPi * s_ang * s_ang);
    cov = sep >= s_ang + e_ang ? 0.0f : cov;
    cov = sep <= e_ang - s_ang ? 1.0f : cov;
    cov = clipf(cov, 0.0f, 1.0f);
    const float fvis = 1.0f - cov;
    const float mu_e_dir = fmaxf(nX * ex_ + nY * ey_ + nZ * ez_, 0.0f);
    lum_es = hitf ? irr * P[26] * mu_e_dir : 0.0f;
    // constants.UMBRA_TINT
    tint0 = fvis + cov * 0.045f;
    tint1 = fvis + cov * 0.009f;
    tint2 = fvis + cov * 0.003f;
  }
  o[0] = alb_r * (lum * tint0 + lum_es);
  o[1] = alb_g * (lum * tint1 + lum_es);
  o[2] = alb_b * (lum * tint2 + lum_es);
  o[3] = hitf ? 1.0f : 0.0f;
  o[4] = hitf ? t_hit : 0.0f;
  o[5] = hitf ? px : 0.0f;
  o[6] = hitf ? py : 0.0f;
  o[7] = hitf ? pz : 0.0f;
}

__global__ void __launch_bounds__(NRAY, 1) march_kernel(const MarchArgs a) {
  __shared__ __nv_bfloat16 hw[G * WH * WW];
  __shared__ float P[NPAR];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / B;
  const long long ray = (long long)s * NRAY + tid;
  if (tid < NPAR) P[tid] = a.params[tid * NRAY];
  const float activef = a.act[ray] > 0.5f ? 1.0f : 0.0f;
  // strips with no active ray: every output is masked to zero
  if (!__syncthreads_or(activef > 0.0f)) {
    for (int i = 0; i < 8; ++i) a.out[i][ray] = 0.0f;
    return;
  }
  stage_heights(a.hwin, s, tid, hw);
  __syncthreads();

  const float* sc = a.scal + (long long)s * NSCAL * NRAY + tid;
  Ray R = strip_ray(a, P, sc, hw + g * WH * WW);
  R.dbx = a.dbx[ray]; R.dby = a.dby[ray]; R.dbz = a.dbz[ray];
  const Bracket b = bracket(a, R, a.t0[ray], a.t1[ray], activef, a.warm,
                            a.warm ? a.tprev[ray] : 0.0f,
                            a.warm ? a.fprev[ray] : 0.0f);
  const bool found = b.found > 0.5f;
  // strips where no ray found the surface: every output is zero
  if (!__syncthreads_or(found)) {
    for (int i = 0; i < 8; ++i) a.out[i][ray] = 0.0f;
    return;
  }
  // the warm variant runs one more iteration
  const float t_hit = refine(R, a.n_bisect + (a.warm ? 1 : 0), b);
  float o[8];
  shade(a, P, R, sc, s, g, t_hit, found && activef > 0.0f, o);
  for (int i = 0; i < 8; ++i) a.out[i][ray] = o[i];
}

MRTX_EXPORT int mrtx_march_shade(const MarchArgs* a, cudaStream_t stream) {
  if (a->n_coarse < 1 || a->n_coarse >= MAX_COARSE)
    return (int)cudaErrorInvalidValue;
  if (a->ns == 0) return 0;
  march_kernel<<<a->ns, NRAY, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// ---- the burst: samples 1..n-1 of an accumulation in one launch ---------
//
// Replaces no TPU kernel: the TPU runs this loop as one jitted fori_loop
// around march_shade_pallas (moonrtx_tpu/engine/blocked.py, the burst),
// which XLA fuses; run op by op in plain torch, the loop is tens of
// launches a sample around K2. Each block loops over the warm samples of
// its strip: the jittered ray in block layout
// (engine/blocked.py::_block_ray_dirs, then the rotation into the body
// frame), the outer and inner shell chords clipped against the block's
// h_bound (block_rays), K2's warm march and shade, and the running mean ar
// + (r - ar) / k, each in the order of operations of the plain version on
// the card, where a division by a host number is a product with its float
// reciprocal. The previous sample's hit distance and mask stay in
// registers; the height windows are staged once a launch, at the first
// sample with an active ray. Inactive rays keep their own chord (block_rays
// collapses it to the block's mean chord, which only tightens the pose
// program's windows): every output of an inactive ray is masked, and it
// never votes. Bound: the chain of field evaluations, ~20 a ray and sample,
// as K2's.

#define NCAM 19   // forward | right | up | tan_half_fov | rotation (3x3)

// torch.sum over three elements on the card: two threads, the first adds
// elements 0 and 2, then the second's element 1
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

struct BurstArgs {
  MarchArgs m;            // params, scal, windows, march settings; the ray
                          // planes are unused, tprev/fprev are sample 0's
  const float* jit;       // (rows, 2) jitters, sample i at row i
  const float* hbound;    // (NS * G,) chord bound of each block, or null
  const float* cam;       // NCAM floats
  const float* rgb0[3];   // sample 0's colour
  float* mean[3];         // the mean over all n_samples
  float inv_fh, inv_width, w_over_fh, r2_outer, r2_inner;  // as floats
  int wbk, n_samples;     // blocks per image row; samples (>= 2)
};

__global__ void __launch_bounds__(NRAY, 1) burst_kernel(const BurstArgs b) {
  const MarchArgs& a = b.m;
  __shared__ __nv_bfloat16 hw[G * WH * WW];
  __shared__ float P[NPAR];
  __shared__ float cam[NCAM];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / B, lane = tid % B;
  const long long ray = (long long)s * NRAY + tid;
  if (tid < NPAR) P[tid] = a.params[tid * NRAY];
  if (tid < NCAM) cam[tid] = b.cam[tid];
  __syncthreads();

  const float* sc = a.scal + (long long)s * NSCAL * NRAY + tid;
  Ray R = strip_ray(a, P, sc, hw + g * WH * WW);
  // the ray's pixel (8x16-pixel blocks in block-row-major order)
  const int blk = s * G + g;
  const float ys = (float)((blk / b.wbk) * 8 + lane / 16);
  const float xs = (float)((blk % b.wbk) * 16 + lane % 16);
  const float oo = sum3(R.obx * R.obx, R.oby * R.oby, R.obz * R.obz);
  float cc = 0.0f;
  if (b.hbound) {
    const float r_bound = kMoonR * fminf(b.hbound[blk], 1.0f);
    cc = oo - r_bound * r_bound;
  }
  float ar = b.rgb0[0][ray], ag = b.rgb0[1][ray], ab = b.rgb0[2][ray];
  float tp = a.tprev[ray], fp = a.fprev[ray];
  bool staged = false;
  for (int i = 1; i < b.n_samples; ++i) {
    // jittered direction, normalised, then transpose(rotation) times it
    const float v = 1.0f - 2.0f * ((ys + 0.5f) + b.jit[2 * i]) * b.inv_fh;
    const float u = (2.0f * ((xs + 0.5f) + b.jit[2 * i + 1]) * b.inv_width
                     - 1.0f) * b.w_over_fh;
    float d0 = cam[0] + cam[9] * (u * cam[3] + v * cam[6]);
    float d1 = cam[1] + cam[9] * (u * cam[4] + v * cam[7]);
    float d2 = cam[2] + cam[9] * (u * cam[5] + v * cam[8]);
    const float nrm = sqrtf(fmaxf(sum3(d0 * d0, d1 * d1, d2 * d2), 1e-20f));
    d0 = d0 / nrm; d1 = d1 / nrm; d2 = d2 / nrm;
    const float* M = cam + 10;
    R.dbx = d0 * M[0] + d1 * M[3] + d2 * M[6];
    R.dby = d0 * M[1] + d1 * M[4] + d2 * M[7];
    R.dbz = d0 * M[2] + d1 * M[5] + d2 * M[8];
    // chords through the outer shell and to the inner sphere
    const float bb = sum3(R.obx * R.dbx, R.oby * R.dby, R.obz * R.dbz);
    const float disc = bb * bb - (oo - b.r2_outer);
    bool hit_out = disc > 0.0f;
    const float so = sqrtf(fmaxf(disc, 0.0f));
    float t_enter = fmaxf(-bb - so, 0.0f);
    const float disc_in = bb * bb - (oo - b.r2_inner);
    const float t_in = -bb - sqrtf(fmaxf(disc_in, 0.0f));
    float t_end = (disc_in > 0.0f && t_in > 0.0f) ? t_in : -bb + so;
    if (b.hbound) {
      // clipped to the segment inside the block's local-max sphere
      const float dc = bb * bb - cc;
      const bool crosses = dc > 0.0f;
      const float sq = sqrtf(fmaxf(dc, 0.0f));
      t_enter = fmaxf(t_enter, crosses ? -bb - sq : t_enter);
      t_end = fminf(t_end, crosses ? -bb + sq : t_end);
      hit_out = hit_out && crosses && t_end > t_enter;
    }
    const float activef = hit_out ? 1.0f : 0.0f;

    float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    // as K2: a strip with no active ray, or where no ray found the
    // surface, gives zeros (every vote is the whole block's)
    if (__syncthreads_or(activef > 0.0f)) {
      if (!staged) {
        stage_heights(a.hwin, s, tid, hw);
        __syncthreads();
        staged = true;
      }
      const Bracket br = bracket(a, R, t_enter, t_end, activef, true, tp, fp);
      const bool found = br.found > 0.5f;
      if (__syncthreads_or(found)) {
        const float t_hit = refine(R, a.n_bisect + 1, br);
        shade(a, P, R, sc, s, g, t_hit, found && activef > 0.0f, o);
      }
    }
    const float inv_k = 1.0f / (float)(i + 1);
    ar = ar + (o[0] - ar) * inv_k;
    ag = ag + (o[1] - ag) * inv_k;
    ab = ab + (o[2] - ab) * inv_k;
    tp = o[4];
    fp = o[3];
  }
  b.mean[0][ray] = ar;
  b.mean[1][ray] = ag;
  b.mean[2][ray] = ab;
}

MRTX_EXPORT int mrtx_march_burst(const BurstArgs* b, cudaStream_t stream) {
  if (b->m.n_coarse < 1 || b->m.n_coarse >= MAX_COARSE || b->n_samples < 2)
    return (int)cudaErrorInvalidValue;
  if (b->m.ns == 0) return 0;
  burst_kernel<<<b->m.ns, NRAY, 0, stream>>>(*b);
  return (int)cudaGetLastError();
}

MRTX_ERROR_STRING_FN
