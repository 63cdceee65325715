// The one-bounce irradiance pyramid (ops/shadow_scan.py::bounce_from_parts):
// terrain n.l, the dyadic pyramid of heights and radiosity, the eight
// directional sectors' horizon (sin^2 alpha) and blocker radiosity on
// every level, and their coarse -> fine collapse into the map.
//
// Replaces no TPU kernel: in the JAX package this is plain jnp code that
// XLA fuses (moonrtx_tpu/ops/shadow_scan.py, bounce_from_parts and
// _sector_collapse). As plain torch ops (bounce_from_parts_plain, kept as
// the CPU path and the yardstick) it is some 700 launches a bounce
// (rolls, cats, wheres, stacks), each (8, 1536, 4096) sector stack written
// and read again at level 0 (201 MB apiece).
//
// Bound on Hopper: instruction issue, not memory. A level-0 cell needs
// hs, factor and albedo once and its map value written once (16 B; with
// the coarser levels' inputs 126 MB at 1536x4096, 0.038 ms at 3.35 TB/s),
// but each of its eight sectors does four IEEE divisions (two horizon
// tangents, two sin^2), which keep the plain version's rounding and so
// its choices between near and far blockers, and its radius-1 upsample
// reads 9 staged values for each of 16 planes. The plain version's cost
// was the host's issue of some 700 small launches a bounce; here the
// whole pyramid is 1 + n_levels launches a bounce from one host call.
// Design:
//   bounce_pyramid_kernel   one launch a bounce, a 64x64 level-0 tile a
//       block: n.l and the radiosity at level 0 (or albedo x the first
//       bounce's map, for the second), then the 2x2 means (heights,
//       radiosity) and maxima (heights) of every coarser level from
//       shared memory; a 7-level pyramid ends at one cell a tile.
//   bounce_collapse_kernel  one launch a level, coarsest first, a 32x32
//       tile a block: the level's radiosity (halo 6), box-blurred with
//       radius 2, and h_blk (halo 4) staged in shared memory, the eight
//       sectors computed in registers, the coarser level's collapsed
//       (8 + 8)-plane pair upsampled and blurred with radius 1 from
//       shared memory, the larger sin^2 kept; levels >= 1 write their
//       pair (16 floats a cell), level 0 sums s2 * j over the sectors
//       and writes the map alone: the level-0 stacks are never formed.
// Sums run in the plain version's order on the card (box blurs: columns
// (x + left) + right, then rows (x + down) + up, radius by radius; the
// 2x2 means and the sector sum as torch's reductions order them), its
// n.l takes rsqrtf as torch.rsqrt does, and -fmad=false rounds every
// product and sum apart: on the card the kernels give the plain
// version's map bit for bit, as long as torch keeps those orders.
#include "common.cuh"

#define NSEC 8
#define BLUR 2          // the pyramid's box-blur radius (BOUNCE_BLUR)
#define PT 64           // pyramid tile (level-0 cells a side)
#define PTHREADS 256
#define TH 32           // collapse tile rows
#define TW 32           // collapse tile columns
#define CTHREADS 256
#define RH (TH + 12)    // radiosity rows, halo 6 (shift 4 + blur 2)
#define RW (TW + 12)
#define BH (TH + 8)     // blurred radiosity and h_blk, halo 4
#define BW (TW + 8)
#define CH (TH / 2 + 2)  // the coarser level's pair, halo 1
#define CW (TW / 2 + 2)
#define MAX_LEVELS 7
// floats of one plane of a pyramid tile's levels 1..6: 32^2 + ... + 1^2
#define TILE_LEVELS 1365

struct BounceArgs {
  const float* hs;       // (nt, np) scan-grid heights
  const float* factor;   // (nt, np) shadow factor
  const float* alb;      // (nt, np) albedo luminance on the scan grid
  const float* rows;     // per-row arrays (bounce_rows in shadow_scan.py)
  float* scratch;        // mrtx_bounce_scratch floats
  float* out;            // (nt, np) the map
  int nt, np, n_levels, n_bounces;
  float scale, e_max;
};

struct Layout {
  // per level k: its rows/columns and where its planes live
  int nt[MAX_LEVELS], np[MAX_LEVELS];
  long long h[MAX_LEVELS], hx[MAX_LEVELS], rad[MAX_LEVELS], acc[MAX_LEVELS];
  long long rows[MAX_LEVELS];  // dth, dl_phi, diag of level k, nt_k each
  long long e1, total;
};

// Scratch: rad of level 0, e1 (two bounces), then per level k >= 1 its
// h, hx and rad and its collapsed pair (16 planes). Rows: level 0's
// dth0, st0, dphi * max(st0, 0.05), ct0 (4 nt), then per level its
// dth_k, dl_phi_k, diag_k (3 nt_k). Level 0's h and hx are hs itself.
static Layout layout_of(int nt, int np, int n_levels, int n_bounces) {
  Layout L;
  long long off = 0, roff = 4LL * nt;
  for (int k = 0; k < n_levels; ++k) {
    L.nt[k] = nt >> k;
    L.np[k] = np >> k;
    const long long n = (long long)L.nt[k] * L.np[k];
    L.rows[k] = roff;
    roff += 3LL * L.nt[k];
    if (k == 0) {
      L.h[0] = L.hx[0] = -1;
      L.rad[0] = off;
      off += n;
      L.e1 = n_bounces > 1 ? off : -1;
      off += n_bounces > 1 ? n : 0;
      L.acc[0] = -1;
    } else {
      L.h[k] = off;
      L.hx[k] = off + n;
      L.rad[k] = off + 2 * n;
      L.acc[k] = off + 3 * n;
      off += 19 * n;
    }
  }
  L.total = off;
  return L;
}

struct PyramidArgs {
  const float* hs;
  const float* factor;
  const float* alb;
  const float* e1;       // null for the first bounce
  const float* rows0;    // dth0, st0, dphi st, ct0
  float* h[MAX_LEVELS];
  float* hx[MAX_LEVELS];
  float* rad[MAX_LEVELS];
  int nt, np, n_levels;
};

// where level k >= 1 of a pyramid tile starts in its shared plane
__device__ __forceinline__ int lvl_off(int k) {
  int o = 0;
  for (int m = 1; m < k; ++m) o += (PT >> m) * (PT >> m);
  return o;
}

// x mod n in [0, n); the division only where x lies outside [-n, 2n)
__device__ __forceinline__ int wrap(int x, int n) {
  if (x < 0) x += n;
  else if (x >= n) x -= n;
  if (x >= 0 && x < n) return x;
  x %= n;
  return x < 0 ? x + n : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// radiosity of level-0 cell (i, j) of the first bounce: albedo x
// clamp(n.l, 0, 1) x factor, n.l from the grid slopes (torch.gradient
// along theta, wrapped central differences along phi)
__device__ __forceinline__ float radiosity0(const PyramidArgs& a, int i,
                                            int j) {
  const int nt = a.nt, np = a.np;
  const long long c = (long long)i * np + j;
  const float hc = a.hs[c];
  float dth;
  if (i == 0)
    dth = __fsub_rn(a.hs[c + np], hc);
  else if (i == nt - 1)
    dth = __fsub_rn(hc, a.hs[c - np]);
  else
    dth = __fmul_rn(__fsub_rn(a.hs[c + np], a.hs[c - np]), 0.5f);
  const float* r = a.rows0;
  const float s_th = __fdiv_rn(dth, __fmul_rn(r[i], hc));
  const long long row = (long long)i * np;
  const float hp = a.hs[row + (j + 1 == np ? 0 : j + 1)];
  const float hm = a.hs[row + (j == 0 ? np - 1 : j - 1)];
  const float dh_ph = __fmul_rn(0.5f, __fsub_rn(hp, hm));
  const float s_ph = __fdiv_rn(dh_ph, __fmul_rn(r[2 * nt + i], hc));
  const float q = __fadd_rn(__fadd_rn(1.0f, __fmul_rn(s_th, s_th)),
                            __fmul_rn(s_ph, s_ph));
  const float ndl = __fmul_rn(
      __fadd_rn(r[3 * nt + i], __fmul_rn(s_th, r[nt + i])), rsqrtf(q));
  return __fmul_rn(__fmul_rn(a.alb[c], fminf(fmaxf(ndl, 0.0f), 1.0f)),
                   a.factor[c]);
}

// the 2x2 mean as torch's reduction on the card sums it (the plain
// version's x.reshape(r, 2, c, 2).mean(dim=(1, 3))): columns first
__device__ __forceinline__ float mean4(float x00, float x01, float x10,
                                      float x11) {
  return __fmul_rn(__fadd_rn(__fadd_rn(x00, x10), __fadd_rn(x01, x11)),
                   0.25f);
}

// One PT x PT level-0 tile a block: level 0's radiosity, and the means
// and maxima of every coarser level (the tile halves n_levels - 1 times).
__global__ void __launch_bounds__(PTHREADS)
bounce_pyramid_kernel(const PyramidArgs a) {
  __shared__ float sh[TILE_LEVELS], shx[TILE_LEVELS], srad[TILE_LEVELS];
  const int i0 = blockIdx.y * PT, j0 = blockIdx.x * PT;
  const bool first = a.e1 == nullptr;
  const int np = a.np;
  // level 1 from level 0: a thread takes (PT/2)^2 / PTHREADS cells
  for (int t = threadIdx.x; t < (PT / 2) * (PT / 2); t += PTHREADS) {
    const int r1 = t / (PT / 2), c1 = t % (PT / 2);
    const int i = i0 + 2 * r1, j = j0 + 2 * c1;
    float rad[2][2], h[2][2];
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const long long c = (long long)(i + di) * np + j + dj;
        h[di][dj] = a.hs[c];
        rad[di][dj] = first ? radiosity0(a, i + di, j + dj)
                            : __fmul_rn(a.alb[c], a.e1[c]);
        a.rad[0][c] = rad[di][dj];
      }
    if (a.n_levels > 1) {
      const int o = r1 * (PT / 2) + c1;   // level 1 starts at 0
      srad[o] = mean4(rad[0][0], rad[0][1], rad[1][0], rad[1][1]);
      if (first) {
        sh[o] = mean4(h[0][0], h[0][1], h[1][0], h[1][1]);
        shx[o] = fmaxf(fmaxf(fmaxf(h[0][0], h[0][1]), h[1][0]), h[1][1]);
      }
    }
  }
  // each level's tile to device memory, then the next from it
  for (int k = 1; k < a.n_levels; ++k) {
    __syncthreads();
    const int side = PT >> k;
    const int npk = np >> k;
    const long long base = (long long)(i0 >> k) * npk + (j0 >> k);
    const int o = lvl_off(k), o1 = lvl_off(k + 1);
    for (int t = threadIdx.x; t < side * side; t += PTHREADS) {
      const int r = t / side, c = t % side;
      const long long g = base + (long long)r * npk + c;
      const int x = o + t;
      a.rad[k][g] = srad[x];
      if (first) {
        a.h[k][g] = sh[x];
        a.hx[k][g] = shx[x];
      }
      if (k + 1 < a.n_levels && r % 2 == 0 && c % 2 == 0) {
        const int y = o1 + (r / 2) * (side / 2) + c / 2;
        srad[y] = mean4(srad[x], srad[x + 1], srad[x + side],
                        srad[x + side + 1]);
        if (first) {
          sh[y] = mean4(sh[x], sh[x + 1], sh[x + side], sh[x + side + 1]);
          shx[y] = fmaxf(fmaxf(fmaxf(shx[x], shx[x + 1]), shx[x + side]),
                         shx[x + side + 1]);
        }
      }
    }
  }
}

struct CollapseArgs {
  const float* h;        // level k heights, and their block maxima
  const float* hx;
  const float* rad;      // level k radiosity
  const float* rows;     // dth_k, dl_phi_k, diag_k
  const float* acc_in;   // level k+1's pair (16, nt/2, np/2), or null
  float* acc_out;        // level k's pair (16, nt, np) (k >= 1)
  const float* e_prev;   // level 0 of the second bounce: the first's map
  float* e_out;          // level 0: the map
  int nt, np, clamp_out;
  float scale, e_max;
};

// One TH x TW tile of level k a block; FINAL at level 0 (the map),
// COARSE when a coarser level exists.
template <bool COARSE, bool FINAL>
__global__ void __launch_bounds__(CTHREADS)
bounce_collapse_kernel(const CollapseArgs a) {
  __shared__ float raw[RH * RW];   // radiosity; then its blur (BH x BW)
  __shared__ float cb[RH * BW];    // radiosity blurred along phi
  __shared__ float hb[BH * BW];    // h_blk
  __shared__ float co[COARSE ? 2 * NSEC * CH * CW : 1];
  const int nt = a.nt, np = a.np;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  // (d theta, d phi) of each sector's step, in the plain version's order;
  // sectors 0-1 divide by dth, 2-3 by dl_phi, 4-7 by the diagonal
  constexpr int SEC_DT[NSEC] = {BLUR, -BLUR, 0, 0, BLUR, BLUR, -BLUR, -BLUR};
  constexpr int SEC_DP[NSEC] = {0, 0, BLUR, -BLUR, BLUR, -BLUR, BLUR, -BLUR};

  for (int t = tid; t < RH * RW; t += CTHREADS) {
    const int r = t / RW, c = t % RW;
    raw[t] = a.rad[(long long)clampi(i0 - 6 + r, 0, nt - 1) * np
                   + wrap(j0 - 6 + c, np)];
  }
  for (int t = tid; t < BH * BW; t += CTHREADS) {
    const int r = t / BW, c = t % BW;
    const long long g = (long long)clampi(i0 - 4 + r, 0, nt - 1) * np
                        + wrap(j0 - 4 + c, np);
    hb[t] = __fmul_rn(0.5f, __fadd_rn(a.hx[g], a.h[g]));
  }
  if (COARSE) {
    const int nt1 = nt / 2, np1 = np / 2;
    const long long n1 = (long long)nt1 * np1;
    const int cr0 = i0 / 2 - 1, cc0 = j0 / 2 - 1;
    for (int t = tid; t < 2 * NSEC * CH * CW; t += CTHREADS) {
      const int q = t / (CH * CW), rc = t % (CH * CW);
      const int r = rc / CW, c = rc % CW;
      co[t] = a.acc_in[q * n1 + (long long)clampi(cr0 + r, 0, nt1 - 1) * np1
                       + wrap(cc0 + c, np1)];
    }
  }
  __syncthreads();
  // box blur, radius 2: along phi (x + left) + right, then the +-2 pair
  const float inv5 = 1.0f / (2 * BLUR + 1);
  for (int t = tid; t < RH * BW; t += CTHREADS) {
    const int r = t / BW, c = t % BW;
    const float* x = raw + r * RW + c;
    float acc = __fadd_rn(__fadd_rn(x[2], x[1]), x[3]);
    acc = __fadd_rn(__fadd_rn(acc, x[0]), x[4]);
    cb[t] = __fmul_rn(acc, inv5);
  }
  __syncthreads();
  // then along theta (x + down) + up; rows of the tile's halo outside the
  // level hold the clamped row, which the sectors never read (they clamp
  // first)
  for (int t = tid; t < BH * BW; t += CTHREADS) {
    const int r = t / BW, c = t % BW;
    const float* x = cb + r * BW + c;
    float acc = __fadd_rn(__fadd_rn(x[2 * BW], x[3 * BW]), x[BW]);
    acc = __fadd_rn(__fadd_rn(acc, x[4 * BW]), x[0]);
    raw[t] = __fmul_rn(acc, inv5);
  }
  __syncthreads();
  const float* rb = raw;   // blurred radiosity, BH x BW

  const int lj = tid % TW;
  const int j = j0 + lj;
  if (j >= np) return;
  const float inv3 = 1.0f / 3.0f;
  // the coarser pair's columns for fine columns j - 1, j, j + 1 (halo 1)
  const int cm = ((lj - 1) >> 1) + 1, cc = (lj >> 1) + 1,
            cp = ((lj + 1) >> 1) + 1;
  for (int li = tid / TW; li < TH; li += CTHREADS / TW) {
    const int i = i0 + li;
    if (i >= nt) break;
    const long long g = (long long)i * np + j;
    const float h = a.h[g];
    const float run[3] = {a.rows[i], a.rows[nt + i], a.rows[2 * nt + i]};
    const int rm = ((li - 1) >> 1) + 1, rc = (li >> 1) + 1,
              rp = ((li + 1) >> 1) + 1;
    // the sector sum as torch's reduction over dim 0 sums it on the card:
    // four accumulators (q, q + 4), then folded in order
    float e[NSEC / 2];
#pragma unroll
    for (int q = 0; q < NSEC; ++q) {
      const int dt = SEC_DT[q], dp = SEC_DP[q];
      const float rn = run[q < 2 ? 0 : (q < 4 ? 1 : 2)];
      const int r1 = clampi(i - dt, 0, nt - 1) - i0 + 4;
      const int r2 = clampi(i - 2 * dt, 0, nt - 1) - i0 + 4;
      const int c1 = lj + 4 - dp, c2 = lj + 4 - 2 * dp;
      const float t1 = __fdiv_rn(fmaxf(__fsub_rn(hb[r1 * BW + c1], h), 0.0f),
                                 __fmul_rn(2.0f, rn));
      const float t2 = __fdiv_rn(fmaxf(__fsub_rn(hb[r2 * BW + c2], h), 0.0f),
                                 __fmul_rn(4.0f, rn));
      const float s2_1 = __fdiv_rn(__fmul_rn(t1, t1),
                                   __fadd_rn(1.0f, __fmul_rn(t1, t1)));
      const float s2_2 = __fdiv_rn(__fmul_rn(t2, t2),
                                   __fadd_rn(1.0f, __fmul_rn(t2, t2)));
      const bool far = s2_2 > s2_1;
      float s2 = far ? s2_2 : s2_1;
      float jv = far ? rb[r2 * BW + c2] : rb[r1 * BW + c1];
      if (COARSE) {
        // level k+1's pair repeated 2x2, then blurred with radius 1
        float up[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* C = co + (p * NSEC + q) * CH * CW;
          float x1[3];
          const int rr[3] = {rc, rp, rm};
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const float* R = C + rr[m] * CW;
            x1[m] = __fmul_rn(__fadd_rn(__fadd_rn(R[cc], R[cm]), R[cp]),
                              inv3);
          }
          up[p] = __fmul_rn(__fadd_rn(__fadd_rn(x1[0], x1[1]), x1[2]), inv3);
        }
        const bool take = s2 > up[0];
        s2 = take ? s2 : up[0];
        jv = take ? jv : up[1];
      }
      if (FINAL) {
        const float p = __fmul_rn(s2, jv);
        e[q % 4] = q < 4 ? p : __fadd_rn(e[q % 4], p);
      } else {
        const long long n = (long long)nt * np;
        a.acc_out[q * n + g] = s2;
        a.acc_out[(NSEC + q) * n + g] = jv;
      }
    }
    if (FINAL) {
      float m = __fadd_rn(__fadd_rn(__fadd_rn(e[0], e[1]), e[2]), e[3]);
      m = __fmul_rn(a.scale, m);
      if (a.e_prev != nullptr) m = __fadd_rn(a.e_prev[g], m);
      if (a.clamp_out) m = fminf(fmaxf(m, 0.0f), a.e_max);
      a.e_out[g] = m;
    }
  }
}

template <bool COARSE, bool FINAL>
static int collapse(const CollapseArgs& c, cudaStream_t stream) {
  const dim3 grid((c.np + TW - 1) / TW, (c.nt + TH - 1) / TH);
  bounce_collapse_kernel<COARSE, FINAL><<<grid, CTHREADS, 0, stream>>>(c);
  return (int)cudaGetLastError();
}

// floats of scratch for a grid (the wrapper allocates them)
MRTX_EXPORT long long mrtx_bounce_scratch(int nt, int np, int n_levels,
                                          int n_bounces) {
  return layout_of(nt, np, n_levels, n_bounces).total;
}

// The whole map: per bounce one pyramid launch and one collapse launch a
// level. nt and np must be multiples of PT; 1 <= n_levels <= 7.
MRTX_EXPORT int mrtx_bounce(const BounceArgs* b, cudaStream_t stream) {
  const int nt = b->nt, np = b->np, nl = b->n_levels;
  if (nt % PT || np % PT || nl < 1 || nl > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(nt, np, nl, b->n_bounces);
  float* s = b->scratch;
  const int passes = b->n_bounces > 1 ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    PyramidArgs p = {};
    p.hs = b->hs;
    p.factor = b->factor;
    p.alb = b->alb;
    p.e1 = pass == 0 ? nullptr : s + L.e1;
    p.rows0 = b->rows;
    for (int k = 0; k < nl; ++k) {
      p.rad[k] = s + L.rad[k];
      p.h[k] = k ? s + L.h[k] : nullptr;
      p.hx[k] = k ? s + L.hx[k] : nullptr;
    }
    p.nt = nt;
    p.np = np;
    p.n_levels = nl;
    bounce_pyramid_kernel<<<dim3(np / PT, nt / PT), PTHREADS, 0, stream>>>(p);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    for (int k = nl - 1; k >= 0; --k) {
      CollapseArgs c = {};
      c.h = k ? s + L.h[k] : b->hs;
      c.hx = k ? s + L.hx[k] : b->hs;
      c.rad = s + L.rad[k];
      c.rows = b->rows + L.rows[k];
      c.acc_in = k + 1 < nl ? s + L.acc[k + 1] : nullptr;
      c.acc_out = k ? s + L.acc[k] : nullptr;
      c.nt = L.nt[k];
      c.np = L.np[k];
      c.scale = b->scale;
      c.e_max = b->e_max;
      if (k == 0) {
        const bool last = pass + 1 == passes;
        c.e_prev = pass ? s + L.e1 : nullptr;
        c.e_out = last ? b->out : s + L.e1;
        c.clamp_out = last;
      }
      const bool coarse = c.acc_in != nullptr;
      if (k == 0)
        rc = coarse ? collapse<true, true>(c, stream)
                    : collapse<false, true>(c, stream);
      else
        rc = coarse ? collapse<true, false>(c, stream)
                    : collapse<false, false>(c, stream);
      if (rc) return rc;
    }
  }
  return 0;
}

MRTX_ERROR_STRING_FN
