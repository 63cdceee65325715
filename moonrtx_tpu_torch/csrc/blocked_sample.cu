// KS: one accumulation sample of the windowed "blocked" backend in one
// launch: the march, the shadow|bounce lookup, the shading and the
// composite of engine/blocked.py::render_frame_blocked (ops/
// blocked_sample.py::blocked_sample, whose plain version is the
// four-function composition march_blocks -> lookup_shadow_windows ->
// shade_blocks -> composite_blocks).
//
// Replaces no TPU kernel: in the JAX package render_frame_blocked
// (moonrtx_tpu/engine/blocked.py:706) is jnp code that XLA fuses. As plain
// torch ops it is some 3,000 launches a 1080p sample (25 coarse and 8
// bisection field evaluations, each a chain of small ops over 2,073,600
// rays; five height samples for the normal; albedo; Lambert, eclipse and
// earthshine; the composite), whose intermediates go to device memory and
// back, and whose host issue held the default path's frame back.
//
// Bound on Hopper: the chain of field evaluations, not memory. A sample
// needs each ray's direction, chord and flag once, the height windows of
// the blocks with a live ray once and the two output planes once (about
// 200 MB at 1080p, 0.06 ms at 3.35 TB/s), but a ray that hits takes up to
// 34 dependent field evaluations, each an asinf, an atan2f, a square root,
// two IEEE divisions and a bilinear tap, and then five more height
// samples with their sines and cosines. Design: one 128-thread block per
// 8x16-ray block of the image, one thread per ray. The block's 40x64 f32
// height window is staged once in shared memory (10 KB), and every field
// evaluation of its rays reads its four taps there; the albedo and
// shadow|bounce windows are read from device memory at the taps a hit
// needs, through the read-only path. A ray stops its coarse march at its
// first crossing (the plain version's later steps leave its bracket as it
// is), a ray without an outer-shell chord does not march (it never hits),
// and only rays that hit are refined and shaded (the composite masks the
// rest); a block with no live ray skips the staging. Misses take the sun
// disk over the background in the composite, written straight into the
// (H, W, 3) image and (H, W, 4) hit buffer.
//
// Every operation follows the plain version's float32 arithmetic as torch
// computes it on the card, built with -fmad=false: a division by a host
// number is a product with its float32 reciprocal; a 3-element sum adds
// (x0 + x2) + x1, and so does the norm of torch.linalg.norm; the cross
// product of torch.linalg.cross is fma(a_i, b_j, -(a_j * b_i)); remainder
// is fmodf plus the divisor where the signs differ; a ** 2 is a * a; the
// card's own asinf, atan2f, sinf, cosf and expf. So the kernel gives the
// plain version's frame bit for bit, as long as torch keeps those orders.
#include "common.cuh"

#define BH 8                 // block rows (engine/blocked.py BLOCK_H)
#define BW 16                // block columns (BLOCK_W)
#define NRAY (BH * BW)       // rays of a block, one thread each
#define WH 40                // height and albedo windows (WIN_H, WIN_W)
#define WW 64
#define SH 32                // shadow|bounce window half (SWIN_H, SWIN_W)
#define SW 48

struct SampleArgs {
  // the block's windows and origins (WindowCache, WindowOrigins)
  const float* hwin;       // (nblk, WH, WW), mean-centred
  const float* hmean;      // (nblk,)
  const int* r0;
  const int* c0;
  const int* ar0;
  const int* ac0;
  const float* q;
  const float* sigma;
  const float* awin;       // a block's WH*WW*3 floats, either layout
  int a_row, a_col, a_chan;  // its strides
  // shadow|bounce windows (ShadowWindows), or swin null
  const void* swin;        // (nblk, SH, swin_w) f32 or bf16
  int swin_bf16, swin_w;   // swin_w: SW, or 2 * SW with the bounce half
  const int* sr0;
  const int* sc0;
  const float* sq;
  const float* axis_x;     // ShadowMapParams
  const float* axis_y;
  const float* axis_z;
  const float* smap_nc;
  const float* smap_nf;
  // rays (RayGeom)
  const float* db;         // (nblk, NRAY, 3)
  const float* ob;         // (3,)
  const float* t_enter;
  const float* t_end;
  const unsigned char* hit_outer;
  const float* dirs;       // (height, width, 3) scene-frame directions
  const float* background; // (height, width, 3), or null for black
  // camera and frame (CameraBasis, FrameParams)
  const float* eye;
  const float* tan_half_fov;
  const float* rotation;   // (3, 3) body -> scene
  const float* light_pos;
  const float* disk_center;
  const float* disk_radius;
  const float* irradiance;
  const float* sun_ang_radius;
  const float* lunar_blend;  // or null
  const float* earth;        // (6,), or null
  float* rgb;              // (height, width, 3)
  float* hitbuf;           // (height, width, 4)
  // host numbers as torch turns them into float32
  float jitter_t, inv_n_coarse, n_coarse_step;
  float h_f, w_f, ah_f, aw_f, n_phi_f;
  float inv_height, deg_per_texel, h_over_pi;
  int n_coarse, n_bisect, height, width, nblk;
};

constexpr float kRad2Deg = (float)(180.0 / 3.141592653589793);
constexpr float kDeg2Rad = (float)(3.141592653589793 / 180.0);
constexpr float kInv180 = 1.0f / 180.0f;
constexpr float kInv360 = 1.0f / 360.0f;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kInvTwoPi = 1.0f / (float)(2.0 * 3.141592653589793);
constexpr float kPi = (float)3.141592653589793;
constexpr float kMoonR = 10.0f;          // constants.MOON_RADIUS
constexpr float kSunDisk = 2.0f;         // constants.SUN_DISK_COLOR
constexpr float kBandSplit = 75.0f;      // ops/shadow_scan.py BAND_SPLIT_DEG
constexpr float kInvBand = 1.0f / 75.0f;
constexpr float kInvFine = 1.0f / 30.0f; // THETA_MAX_DEG - BAND_SPLIT_DEG

// frame constants, computed once a block into shared memory
enum {
  F_OB = 0,            // body-frame eye
  F_LB = 3,            // light in the body frame
  F_SD = 6,            // its direction
  F_EP = 9,            // earth direction x distance
  F_ROT = 12,          // rotation, row-major
  F_AX = 21,           // shadow axes x | y | z
  F_OC = 30,           // eye - sun disk centre
  F_CC,                // |oc|^2 - disk radius^2
  F_IRR, F_LBLEND, F_ES, F_RS, F_RE, F_LO, F_HI, F_RS2, F_RE2, F_RSUM,
  F_RDIF, F_PIRS2, F_NC, F_NF, F_NF1, F_TOTAL, F_PIX,
  NF
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.sum over a last dimension of three on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

__device__ __forceinline__ float dot3(const float* u, float x, float y,
                                      float z) {
  return sum3(u[0] * x, u[1] * y, u[2] * z);
}

// torch.linalg.cross's component a_i b_j - a_j b_i on the card
__device__ __forceinline__ float cross1(float ai, float bj, float aj,
                                        float bi) {
  return __fmaf_rn(ai, bj, -(aj * bi));
}

// torch.remainder(x, m) for m > 0
__device__ __forceinline__ float rem_torch(float x, float m) {
  float r = fmodf(x, m);
  return (r != 0.0f && r < 0.0f) ? r + m : r;
}

// normalize(v): v / sqrt(max(sum(v * v), 1e-20))
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n = sqrtf(fmaxf(sum3(x * x, y * y, z * z), (float)1e-20));
  x = x / n;
  y = y / n;
  z = z / n;
}

// unit_to_latlon (degrees)
__device__ __forceinline__ void latlon(float px, float py, float pz,
                                       float& lat, float& lon) {
  const float r = sqrtf(sum3(px * px, py * py, pz * pz));
  lat = asinf(clip(pz / r, -1.0f, 1.0f)) * kRad2Deg;
  lon = atan2f(px, -py) * kRad2Deg;
}

// latlon_to_unit
__device__ __forceinline__ void unit(float lat_d, float lon_d, float& x,
                                     float& y, float& z) {
  const float la = lat_d * kDeg2Rad, lo = lon_d * kDeg2Rad;
  const float cl = cosf(la);
  x = cl * sinf(lo);
  y = -cl * cosf(lo);
  z = sinf(la);
}

// window-local coordinates at the block's stride (latlon_to_rowcol, then
// _local_coords) on an (h, w) level
__device__ __forceinline__ void local_coords(float lat, float lon, float h_f,
                                             float w_f, float q, float r0f,
                                             float c0f, float& wy,
                                             float& wx) {
  float row = ((90.0f - lat) * kInv180) * h_f - 0.5f;
  float col = (rem_torch(lon + 180.0f, 360.0f) * kInv360) * w_f - 0.5f;
  col = col < 0.0f ? col + w_f : col;
  row = (row + 0.5f) / q - 0.5f;
  col = (col + 0.5f) / q - 0.5f;
  col = col < c0f - 0.5f ? col + (1.0f / q) * w_f : col;
  wy = row - r0f;
  wx = col - c0f;
}

// window_bilinear's taps: clamped coordinates, the top-left texel and the
// fractions
struct Tap {
  int y, x;
  float fy, fx;
};

__device__ __forceinline__ Tap tap(float wy, float wx, int nh, int nw) {
  wy = clip(wy, 0.0f, (float)(nh - 1.001));
  wx = clip(wx, 0.0f, (float)(nw - 1.001));
  const float y0 = floorf(wy), x0 = floorf(wx);
  return {(int)y0, (int)x0, wy - y0, wx - x0};
}

// rows first, then columns (window_bilinear's order); v01 is the next
// column, v10 the next row
__device__ __forceinline__ float mix(const Tap& t, float v00, float v01,
                                     float v10, float v11) {
  const float left = v00 * (1.0f - t.fy) + v10 * t.fy;
  const float right = v01 * (1.0f - t.fy) + v11 * t.fy;
  return left * (1.0f - t.fx) + right * t.fx;
}

// a ray's block: its height window in shared memory and its level
struct Blk {
  const float* hw;
  float hmean, q, r0f, c0f, h_f, w_f;
};

__device__ __forceinline__ float height_at(const Blk& K, float lat,
                                           float lon) {
  float wy, wx;
  local_coords(lat, lon, K.h_f, K.w_f, K.q, K.r0f, K.c0f, wy, wx);
  const Tap t = tap(wy, wx, WH, WW);
  const float* p = K.hw + t.y * WW + t.x;
  return mix(t, p[0], p[1], p[WW], p[WW + 1]) + K.hmean;
}

// march_blocks' field: |p| - R h(latlon(p)) at o + t d
__device__ __forceinline__ float field(const Blk& K, const float* o,
                                       const float* d, float t) {
  const float px = o[0] + t * d[0];
  const float py = o[1] + t * d[1];
  const float pz = o[2] + t * d[2];
  float lat, lon;
  latlon(px, py, pz, lat, lon);
  // torch.linalg.norm sums the squares as torch.sum does: the same radius
  const float r = sqrtf(sum3(px * px, py * py, pz * pz));
  return r - kMoonR * height_at(K, lat, lon);
}

// shade_blocks' spoint: the displaced surface point at (la, lo)
__device__ __forceinline__ void spoint(const Blk& K, float la, float lo,
                                       float* s) {
  const float r = kMoonR * height_at(K, la, lo);
  float x, y, z;
  unit(la, lo, x, y, z);
  s[0] = r * x;
  s[1] = r * y;
  s[2] = r * z;
}

__device__ __forceinline__ float swin_at(const SampleArgs& a, long long i) {
  return a.swin_bf16
      ? __bfloat162float(__ldg((const __nv_bfloat16*)a.swin + i))
      : __ldg((const float*)a.swin + i);
}

// sun_coverage: the share of the solar disk the Earth disk covers
__device__ __forceinline__ float coverage(const float* F, float sep) {
  const float rs = F[F_RS], re = F[F_RE];
  const float d = fminf(fmaxf(sep, F[F_LO]), F[F_HI]);
  const float c1 = clip(((d * d + F[F_RS2]) - F[F_RE2]) / ((2.0f * d) * rs),
                        -1.0f, 1.0f);
  const float c2 = clip(((d * d + F[F_RE2]) - F[F_RS2]) / ((2.0f * d) * re),
                        -1.0f, 1.0f);
  const float tri = ((((-d + rs) + re) * ((d + rs) - re)) * ((d - rs) + re))
                    * ((d + rs) + re);
  const float acos1 = atan2f(sqrtf(fmaxf(1.0f - c1 * c1, 0.0f)), c1);
  const float acos2 = atan2f(sqrtf(fmaxf(1.0f - c2 * c2, 0.0f)), c2);
  const float lens = (F[F_RS2] * acos1 + F[F_RE2] * acos2)
                     - 0.5f * sqrtf(fmaxf(tri, 0.0f));
  float cov = lens / F[F_PIRS2];
  cov = sep >= F[F_RSUM] ? 0.0f : cov;
  cov = sep <= F[F_RDIF] ? 1.0f : cov;
  return clip(cov, 0.0f, 1.0f);
}

// the frame's constants, in the plain version's order of operations
__device__ void frame_constants(const SampleArgs& a, float* F) {
  const float* R = a.rotation;
  const float* lp = a.light_pos;
  for (int i = 0; i < 3; ++i) F[F_OB + i] = a.ob[i];
  for (int i = 0; i < 9; ++i) F[F_ROT + i] = R[i];
  for (int i = 0; i < 3; ++i) {
    F[F_LB + i] = (lp[0] * R[i] + lp[1] * R[3 + i]) + lp[2] * R[6 + i];
    F[F_OC + i] = a.eye[i] - a.disk_center[i];
  }
  F[F_CC] = sum3(F[F_OC] * F[F_OC], F[F_OC + 1] * F[F_OC + 1],
                 F[F_OC + 2] * F[F_OC + 2])
            - a.disk_radius[0] * a.disk_radius[0];
  float sx = F[F_LB], sy = F[F_LB + 1], sz = F[F_LB + 2];
  normalize3(sx, sy, sz);
  F[F_SD] = sx; F[F_SD + 1] = sy; F[F_SD + 2] = sz;
  F[F_IRR] = a.irradiance[0];
  F[F_LBLEND] = a.lunar_blend ? a.lunar_blend[0] : 0.0f;
  if (a.earth) {
    for (int i = 0; i < 3; ++i) F[F_EP + i] = a.earth[i] * a.earth[3];
    const float rs = a.sun_ang_radius[0], re = a.earth[4];
    F[F_ES] = a.earth[5];
    F[F_RS] = rs;
    F[F_RE] = re;
    F[F_LO] = fabsf(re - rs) + (float)1e-7;
    F[F_HI] = (rs + re) - (float)1e-7;
    F[F_RS2] = rs * rs;
    F[F_RE2] = re * re;
    F[F_RSUM] = rs + re;
    F[F_RDIF] = re - rs;
    F[F_PIRS2] = (rs * kPi) * rs;
  }
  if (a.swin) {
    for (int i = 0; i < 3; ++i) {
      F[F_AX + i] = a.axis_x[i];
      F[F_AX + 3 + i] = a.axis_y[i];
      F[F_AX + 6 + i] = a.axis_z[i];
    }
    const float nc = a.smap_nc[0], nf = a.smap_nf[0];
    F[F_NC] = nc;
    F[F_NF] = nf;
    F[F_NF1] = nf - 1.0f;
    F[F_TOTAL] = (nc + nf) - (float)1.001;
  }
  F[F_PIX] = (a.tan_half_fov[0] * 2.0f) * a.inv_height;
}

// lookup_shadow_windows at a hit: (shadow, bounce)
__device__ __forceinline__ void shadow_at(const SampleArgs& a, const float* F,
                                          int blk, float px, float py,
                                          float pz, float& shadow,
                                          float& bounce) {
  // rowcol_of_points
  const float zc = dot3(F + F_AX + 6, px, py, pz);
  const float xc = dot3(F + F_AX, px, py, pz);
  const float yc = dot3(F + F_AX + 3, px, py, pz);
  const float rho = sqrtf(xc * xc + yc * yc);
  const float theta = atan2f(rho, zc) * kRad2Deg;
  const float phi = rem_torch(atan2f(yc, xc), kTwoPi);
  const float row_c = (theta * kInvBand) * F[F_NC];
  const float row_f = F[F_NC] + ((theta - kBandSplit) * kInvFine) * F[F_NF1];
  float row = theta < kBandSplit ? row_c : row_f;
  row = fminf(fmaxf(row, 0.0f), F[F_TOTAL]);
  float col = (phi * kInvTwoPi) * a.n_phi_f - 0.5f;
  col = col < 0.0f ? col + a.n_phi_f : col;
  // the block's window at its stride
  const float qb = a.sq[blk];
  const float sc0 = (float)a.sc0[blk];
  float rows = (row + 0.5f) / qb - 0.5f;
  float cols = (col + 0.5f) / qb - 0.5f;
  cols = cols < sc0 - 0.5f ? cols + (1.0f / qb) * a.n_phi_f : cols;
  const bool theta_ok = (rows + 0.5f) * qb - 0.5f < F[F_TOTAL];
  const Tap t = tap(rows - (float)a.sr0[blk], cols - sc0, SH, SW);
  const long long o = (long long)blk * SH * a.swin_w + t.y * a.swin_w + t.x;
  const int s = a.swin_w;
  const float val = mix(t, swin_at(a, o), swin_at(a, o + 1),
                        swin_at(a, o + s), swin_at(a, o + s + 1));
  shadow = theta_ok ? val : 0.0f;
  bounce = 0.0f;
  if (a.swin_w > SW && theta_ok) {
    const long long ob = o + SW;
    bounce = mix(t, swin_at(a, ob), swin_at(a, ob + 1), swin_at(a, ob + s),
                 swin_at(a, ob + s + 1));
  }
}

// shade_blocks at a hit: the linear colour
__device__ __forceinline__ void shade(const SampleArgs& a, const float* F,
                                      const Blk& K, int blk, const float* d,
                                      float t_hit, float px, float py,
                                      float pz, float lat, float lon,
                                      float* rgb) {
  const float hs = height_at(K, lat, lon);
  // normal_step_texels
  float ux = px, uy = py, uz = pz;
  normalize3(ux, uy, uz);
  const float cosv = fmaxf(fabsf(sum3(ux * d[0], uy * d[1], uz * d[2])),
                           (float)0.05);
  const float arc = (t_hit * F[F_PIX]) / (kMoonR * cosv);
  const float ft = arc * a.h_over_pi;
  const float step = clip((0.5f * ft) / K.q, 0.5f, 3.0f);
  const float dlat = (a.deg_per_texel * K.q) * step;
  const float coslat = fmaxf(cosf(lat * kDeg2Rad), (float)0.05);
  const float dlon = dlat / coslat;
  // the central-difference normal, outward
  float e[3], w[3], n_[3], s[3];
  spoint(K, lat, lon + dlon, e);
  spoint(K, lat, lon - dlon, w);
  spoint(K, lat + dlat, lon, n_);
  spoint(K, lat - dlat, lon, s);
  float cx, cy, cz;
  unit(lat, lon, cx, cy, cz);
  const float rc = kMoonR * hs;
  cx = rc * cx; cy = rc * cy; cz = rc * cz;
  const float ax = e[0] - w[0], ay = e[1] - w[1], az = e[2] - w[2];
  const float bx = n_[0] - s[0], by = n_[1] - s[1], bz = n_[2] - s[2];
  float nx = cross1(ay, bz, az, by);
  float ny = cross1(az, bx, ax, bz);
  float nz = cross1(ax, by, ay, bx);
  normalize3(nx, ny, nz);
  if (sum3(nx * cx, ny * cy, nz * cz) < 0.0f) {
    nx = -nx; ny = -ny; nz = -nz;
  }
  // albedo from the block's window (either layout, by strides)
  float awy, awx;
  local_coords(lat, lon, a.ah_f, a.aw_f, K.q, (float)a.ar0[blk],
               (float)a.ac0[blk], awy, awx);
  const Tap at = tap(awy, awx, WH, WW);
  const float* aw = a.awin + (long long)blk * WH * WW * 3
                    + at.y * a.a_row + at.x * a.a_col;
  float alb[3];
  for (int c = 0; c < 3; ++c) {
    const float* p = aw + c * a.a_chan;
    alb[c] = mix(at, __ldg(p), __ldg(p + a.a_col), __ldg(p + a.a_row),
                 __ldg(p + a.a_row + a.a_col));
  }
  float shadow = 1.0f, bounce = 0.0f;
  if (a.swin) shadow_at(a, F, blk, px, py, pz, shadow, bounce);
  // shade_lambert
  float lx = F[F_LB] - px, ly = F[F_LB + 1] - py, lz = F[F_LB + 2] - pz;
  normalize3(lx, ly, lz);
  const float mu = sum3(nx * lx, ny * ly, nz * lz);
  const float sigma = a.sigma[blk];
  float ndotl;
  if (sigma > (float)1e-6) {
    // soft_ndotl
    const float se = sigma * sqrtf(fmaxf(1.0f - mu * mu, 0.0f)) + (float)1e-6;
    const float xs = mu / se;
    const float cdf = 1.0f / (1.0f + expf(clip(xs * (float)-1.702, -60.0f, 60.0f)));
    const float pdf = (float)0.39894228 * expf(-0.5f * fminf(xs * xs, 120.0f));
    ndotl = fmaxf(mu * cdf + se * pdf, 0.0f);
  } else {
    ndotl = fmaxf(mu, 0.0f);
  }
  if (a.lunar_blend) {
    const float lb = F[F_LBLEND];
    const float mu_e = fmaxf(-sum3(nx * d[0], ny * d[1], nz * d[2]), (float)0.02);
    const float ls = (2.0f * ndotl) / ((ndotl + mu_e) + (float)1e-6);
    ndotl = lb * ls + (1.0f - lb) * ndotl;
  }
  float term = ndotl * shadow;
  if (a.swin) term = term + bounce;
  const float lit = F[F_IRR] * term;
  for (int c = 0; c < 3; ++c) rgb[c] = alb[c] * lit;
  if (a.earth) {
    // earth_light_terms: eclipse tint and earthshine
    float ex = F[F_EP] - px, ey = F[F_EP + 1] - py, ez = F[F_EP + 2] - pz;
    normalize3(ex, ey, ez);
    const float* sd = F + F_SD;
    const float cosd = sum3(ex * sd[0], ey * sd[1], ez * sd[2]);
    const float k0 = cross1(ey, sd[2], ez, sd[1]);
    const float k1 = cross1(ez, sd[0], ex, sd[2]);
    const float k2 = cross1(ex, sd[1], ey, sd[0]);
    const float sind = sqrtf(fmaxf(sum3(k0 * k0, k1 * k1, k2 * k2), 0.0f));
    const float cov = coverage(F, atan2f(sind, cosd));
    const float f = 1.0f - cov;
    const float tint[3] = {(float)0.045, (float)0.009,
                             (float)0.003};   // constants.UMBRA_TINT
    const float es = F[F_IRR]
        * (F[F_ES] * fmaxf(sum3(nx * ex, ny * ey, nz * ez), 0.0f));
    for (int c = 0; c < 3; ++c)
      rgb[c] = rgb[c] * (f + cov * tint[c]) + alb[c] * es;
  }
}

__global__ void __launch_bounds__(NRAY)
blocked_sample_kernel(const __grid_constant__ SampleArgs a) {
  __shared__ __align__(16) float hw[WH * WW];
  __shared__ float F[NF];
  const int blk = blockIdx.x, lane = threadIdx.x;
  const long long ray = (long long)blk * NRAY + lane;
  const int wbk = a.width / BW;
  const int y = (blk / wbk) * BH + lane / BW;
  const int x = (blk % wbk) * BW + lane % BW;
  const long long pix = (long long)y * a.width + x;
  if (lane == 0) frame_constants(a, F);
  const bool live = a.hit_outer[ray] != 0;

  bool found = false;
  float t_hit = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
  float col[3];
  // the barrier also publishes F; a block with no live ray stages nothing
  if (__syncthreads_or(live)) {
    const float4* src = (const float4*)(a.hwin + (long long)blk * WH * WW);
    for (int i = lane; i < WH * WW / 4; i += NRAY)
      ((float4*)hw)[i] = __ldg(src + i);
    __syncthreads();
    if (live) {
      const Blk K = {hw, a.hmean[blk], a.q[blk], (float)a.r0[blk],
                     (float)a.c0[blk], a.h_f, a.w_f};
      const float* o = F + F_OB;
      const float d[3] = {a.db[3 * ray], a.db[3 * ray + 1],
                          a.db[3 * ray + 2]};
      const float te = a.t_enter[ray], tn = a.t_end[ray];
      const float span = tn - te;
      float t_lo = te, t_hi = tn;
      // the jittered coarse bracket: the first crossing fixes it
      for (int k = 0; k <= a.n_coarse; ++k) {
        const float frac = (a.jitter_t + (float)k) * a.inv_n_coarse;
        const float t_k = te + span * frac;
        if (field(K, o, d, t_k) < 0.0f) {
          t_lo = te + span * fmaxf(frac - a.n_coarse_step, 0.0f);
          t_hi = t_k;
          found = true;
          break;
        }
      }
      if (found) {
        for (int i = 0; i < a.n_bisect; ++i) {
          const float t_mid = 0.5f * (t_lo + t_hi);
          if (field(K, o, d, t_mid) > 0.0f) t_lo = t_mid;
          else t_hi = t_mid;
        }
        t_hit = 0.5f * (t_lo + t_hi);
        px = o[0] + t_hit * d[0];
        py = o[1] + t_hit * d[1];
        pz = o[2] + t_hit * d[2];
        float lat, lon;
        latlon(px, py, pz, lat, lon);
        shade(a, F, K, blk, d, t_hit, px, py, pz, lat, lon, col);
      }
    }
  }

  // composite_blocks
  float* out = a.rgb + 3 * pix;
  float* hb = a.hitbuf + 4 * pix;
  if (found) {
    const float* R = F + F_ROT;
    for (int c = 0; c < 3; ++c) {
      out[c] = col[c];
      hb[c] = (px * R[3 * c] + py * R[3 * c + 1]) + pz * R[3 * c + 2];
    }
    hb[3] = t_hit;
  } else {
    const float* dv = a.dirs + 3 * pix;
    const float b = sum3(F[F_OC] * dv[0], F[F_OC + 1] * dv[1],
                         F[F_OC + 2] * dv[2]);
    const bool disk = b * b - F[F_CC] > 0.0f && b < 0.0f;
    for (int c = 0; c < 3; ++c)
      out[c] = disk ? kSunDisk
                    : (a.background ? a.background[3 * pix + c] : 0.0f);
    for (int c = 0; c < 4; ++c) hb[c] = 0.0f;
  }
}

MRTX_EXPORT int mrtx_blocked_sample(const SampleArgs* a,
                                    cudaStream_t stream) {
  if (a->width % BW || a->height % BH || a->n_coarse < 1
      || a->nblk != (a->height / BH) * (a->width / BW))
    return (int)cudaErrorInvalidValue;
  if (a->nblk == 0) return 0;
  blocked_sample_kernel<<<a->nblk, NRAY, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// blocks of the kernel resident on one SM at once (its occupancy)
MRTX_EXPORT int mrtx_blocked_sample_occupancy(void) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, blocked_sample_kernel,
                                                NRAY, 0);
  return n;
}

MRTX_ERROR_STRING_FN
