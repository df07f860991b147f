// The per-gaussian render prologue for Hopper (sm_90a), forward and
// backward, one thread per gaussian row.
//
// Replaces no TPU kernel. The JAX package writes the prologue as jnp code
// (legslam_tpu/ops/projection.py preprocess, utils/sh.py sh_to_color,
// normalize_quat and the feature concatenate of ops/rasterize.py
// render_arrays), and XLA fuses it into a few loops. Run eagerly, the
// same column arithmetic is one launch per operation: ~290 forward and
// ~650 autograd launches a mapping iteration, whose host time paced the
// step while the card idled (PERF.md section 5). The original 3DGS
// rasterizer does the same work in one launch each way (preprocessCUDA;
// BACKWARD::preprocess and computeColorFromSH's backward); so does this.
//
// Forward (prologue_fwd_kernel), per row of the whole-slab prefix `rows`:
// view z and the near cull, the twice-normalised quaternion (the plain
// version normalises once in render_arrays and again in _cov3d_cols),
// Sigma = (R S)(R S)^T, the clamped EWA cov2D with its 0.3 low-pass, the
// conic, the eigenvalue radius, the projected mean plus the optional
// offset, the mask, and, unless only the geometry is asked for (binning),
// the fused feature row [SH colour clamped at 0 or the precomputed colour,
// the language features, view z]. Rows from `rows` to n get the inert
// values of a skipped slab (mean2d -1e6, conic (1, 0, 1), depth 0, radius
// 0, mask 0, features 0) in the same launch.
//
// Exactness: every +, - and * of the forward chain goes through F, whose
// operators are the round-to-nearest intrinsics that nvcc never contracts
// into an FMA, in the plain version's order, with its correctly rounded
// division, reciprocal and square root and its rsqrtf. So radius and mask
// equal the plain version's (one PyTorch kernel an operation) bit for bit,
// and the float outputs too where PyTorch's reductions add in the order
// written here: torch.sum over a row of 4 (the quaternion's squared norm)
// adds (w^2 + y^2) + (x^2 + z^2) and over a row of 3 (the SH direction's)
// (x^2 + z^2) + y^2, the order of its lane-split reduction, as read on an
// H100 with PyTorch 2.11 (chip_smoke.py checks the result bit for bit).
//
// Backward (prologue_bwd_kernel): recomputes the forward from the saved
// inputs (3DGS's choice: inputs are saved, not intermediates) and takes
// dL/dmean2d, dL/dconic and dL/dfeats to dL/dxyz, dL/dscales, dL/dquats
// (through both normalisations), dL/dsh (zero past the active degree and
// on clamped channels) and dL/doffset = dL/dmean2d, with the gradient
// masks of the plain version's autograd: the mean and conic paths only for
// rows in front of the near plane, the determinant only where it is not 0,
// the view clamp's gradient where the clamp is inactive (bounds
// included), depth to the means only when stop_depth_grad is off. The
// language features' and a precomputed colour's gradients are slices of
// dL/dfeats, which the wrapper hands back as views. Rows past `rows` get
// zeros.
//
// What bounds it: bytes. A row reads xyz, scales, quats (40 B), SH (192 B
// at degree 3) and LF (256 B) and writes the geometry (29 B) and a
// 68-float feature row (272 B): ~0.8 KB, so ~30 us forward for a 2^17-row
// prefix at 3.35 TB/s, against the 0.50-0.63 ms of device time the
// operation-by-operation prologue took (PERF.md section 5); the backward
// reads the inputs again with 3 + 2 + 4 gradient floats and writes 12 +
// 48 floats. What it saves is the host's time to launch ~290 + ~650
// kernels, so the design is the plain one: a thread a row, its loads per
// thread (a row's SH is 1.5 cache lines, reused through L1); only the
// language features, a plain copy, are moved by the block in coalesced
// order.
#include <cuda_runtime.h>

#include <cstdint>

namespace legslam {
namespace {

constexpr int kThreads = 256;
constexpr int kCamFloats = 35;  // world_view 16, full_proj 16, centre 3

// the plain version's constants, as PyTorch casts the Python doubles
constexpr float kNearClip = static_cast<float>(0.2);
constexpr float kProjEps = static_cast<float>(1e-7);
constexpr float kLowpass = static_cast<float>(0.3);
constexpr float kEigGuard = static_cast<float>(0.1);
constexpr float kNormEps = static_cast<float>(1e-24);
constexpr float kOffscreen = static_cast<float>(-1e6);
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC2_0 = static_cast<float>(1.0925484305920792);
constexpr float kC2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_2 = static_cast<float>(0.31539156525252005);
constexpr float kC2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_4 = static_cast<float>(0.5462742152960396);
constexpr float kC3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kC3_1 = static_cast<float>(2.890611442640554);
constexpr float kC3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_3 = static_cast<float>(0.3731763325901154);
constexpr float kC3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_5 = static_cast<float>(1.445305721320277);
constexpr float kC3_6 = static_cast<float>(-0.5900435899266435);

// A float whose +, - and * round on their own, as one PyTorch elementwise
// kernel an operation does.
struct F {
  float v;
  __device__ __forceinline__ F(float x) : v(x) {}
};
__device__ __forceinline__ F operator+(F a, F b) {
  return F(__fadd_rn(a.v, b.v));
}
__device__ __forceinline__ F operator-(F a, F b) {
  return F(__fsub_rn(a.v, b.v));
}
__device__ __forceinline__ F operator*(F a, F b) {
  return F(__fmul_rn(a.v, b.v));
}
__device__ __forceinline__ F operator-(F a) { return F(-a.v); }
__device__ __forceinline__ F fdiv(F a, F b) { return F(__fdiv_rn(a.v, b.v)); }
__device__ __forceinline__ F frcp(F a) { return F(__frcp_rn(a.v)); }
__device__ __forceinline__ F fsqrt(F a) { return F(__fsqrt_rn(a.v)); }
// torch.clamp_min / torch.clamp: NaN passes through
__device__ __forceinline__ F fmax0(F a, float lo) {
  return F(a.v != a.v ? a.v : fmaxf(a.v, lo));
}
__device__ __forceinline__ F fclamp(F a, float lo, float hi) {
  return F(a.v != a.v ? a.v : fminf(fmaxf(a.v, lo), hi));
}

struct Scalars {
  int rows, n;
  float width, height, fx, fy, limx, limy, smod;
};

// Everything the forward computes for a row, kept for the backward.
struct Geo {
  float tz;                 // view-space z: the depth
  bool front;               // tz > the near clip
  float q1[4], r1, r2;      // once-normalised quaternion; both rsqrt factors
  float q2[4];              // twice normalised
  float R[9], M[9];         // rotation; R diag(s)
  float s[3];               // scales times the modifier
  float cov[6];             // xx xy xz yy yz zz
  float n1, n2;             // the squared norms both rsqrts were given
  float t[2], tzc, u[2], tc[2], inv_z, inv_z2;
  float T[6];               // J W, rows t0 and t1
  float va[3], vb[3];       // Sigma t0^T, Sigma t1^T
  float c00, c01, c11, det, di;
  bool det_ok;
  float radius_f;
  float hx, hy, pw;
  float pix[2];
};

__device__ __forceinline__ void geometry(const float* cam, const Scalars& k,
                                         const float* p, const float* q,
                                         const float* sc, Geo& g) {
  const float* wv = cam;
  const float* fp = cam + 16;
  const F x = p[0], y = p[1], z = p[2];
  const F tx = F(wv[0]) * x + F(wv[1]) * y + F(wv[2]) * z + F(wv[3]);
  const F ty = F(wv[4]) * x + F(wv[5]) * y + F(wv[6]) * z + F(wv[7]);
  const F tz = F(wv[8]) * x + F(wv[9]) * y + F(wv[10]) * z + F(wv[11]);
  g.tz = tz.v;
  g.front = tz.v > kNearClip;

  // utils/transforms.normalize_quat, then _cov3d_cols' own normalisation
  const F w0 = q[0], x0 = q[1], y0 = q[2], z0 = q[3];
  const F n1 = (w0 * w0 + y0 * y0) + (x0 * x0 + z0 * z0);
  g.n1 = n1.v;
  g.r1 = rsqrtf(fmax0(n1, kNormEps).v);
  const F w1 = w0 * g.r1, x1 = x0 * g.r1, y1 = y0 * g.r1, z1 = z0 * g.r1;
  g.q1[0] = w1.v; g.q1[1] = x1.v; g.q1[2] = y1.v; g.q1[3] = z1.v;
  const F n2 = w1 * w1 + x1 * x1 + y1 * y1 + z1 * z1;
  g.n2 = n2.v;
  g.r2 = rsqrtf(fmax0(n2, kNormEps).v);
  const F w = w1 * g.r2, qx = x1 * g.r2, qy = y1 * g.r2, qz = z1 * g.r2;
  g.q2[0] = w.v; g.q2[1] = qx.v; g.q2[2] = qy.v; g.q2[3] = qz.v;

  const F sx = F(sc[0]) * k.smod, sy = F(sc[1]) * k.smod,
          sz = F(sc[2]) * k.smod;
  g.s[0] = sx.v; g.s[1] = sy.v; g.s[2] = sz.v;
  const F r00 = F(1.f) - F(2.f) * (qy * qy + qz * qz);
  const F r01 = F(2.f) * (qx * qy - w * qz);
  const F r02 = F(2.f) * (qx * qz + w * qy);
  const F r10 = F(2.f) * (qx * qy + w * qz);
  const F r11 = F(1.f) - F(2.f) * (qx * qx + qz * qz);
  const F r12 = F(2.f) * (qy * qz - w * qx);
  const F r20 = F(2.f) * (qx * qz - w * qy);
  const F r21 = F(2.f) * (qy * qz + w * qx);
  const F r22 = F(1.f) - F(2.f) * (qx * qx + qy * qy);
  const F m00 = r00 * sx, m01 = r01 * sy, m02 = r02 * sz;
  const F m10 = r10 * sx, m11 = r11 * sy, m12 = r12 * sz;
  const F m20 = r20 * sx, m21 = r21 * sy, m22 = r22 * sz;
  g.R[0] = r00.v; g.R[1] = r01.v; g.R[2] = r02.v;
  g.R[3] = r10.v; g.R[4] = r11.v; g.R[5] = r12.v;
  g.R[6] = r20.v; g.R[7] = r21.v; g.R[8] = r22.v;
  g.M[0] = m00.v; g.M[1] = m01.v; g.M[2] = m02.v;
  g.M[3] = m10.v; g.M[4] = m11.v; g.M[5] = m12.v;
  g.M[6] = m20.v; g.M[7] = m21.v; g.M[8] = m22.v;
  const F xx = m00 * m00 + m01 * m01 + m02 * m02;
  const F xy = m00 * m10 + m01 * m11 + m02 * m12;
  const F xz = m00 * m20 + m01 * m21 + m02 * m22;
  const F yy = m10 * m10 + m11 * m11 + m12 * m12;
  const F yz = m10 * m20 + m11 * m21 + m12 * m22;
  const F zz = m20 * m20 + m21 * m21 + m22 * m22;
  g.cov[0] = xx.v; g.cov[1] = xy.v; g.cov[2] = xz.v;
  g.cov[3] = yy.v; g.cov[4] = yz.v; g.cov[5] = zz.v;

  // ops/projection._cov2d_cols
  const F tzc = g.front ? tz : F(1.f);
  const F ux = fdiv(tx, tzc), uy = fdiv(ty, tzc);
  const F txc = fclamp(ux, -k.limx, k.limx) * tzc;
  const F tyc = fclamp(uy, -k.limy, k.limy) * tzc;
  const F inv_z = frcp(tzc);
  const F inv_z2 = inv_z * inv_z;
  g.t[0] = tx.v; g.t[1] = ty.v;
  g.tzc = tzc.v; g.u[0] = ux.v; g.u[1] = uy.v; g.tc[0] = txc.v;
  g.tc[1] = tyc.v; g.inv_z = inv_z.v; g.inv_z2 = inv_z2.v;
  const F j00 = F(k.fx) * inv_z;
  const F j02 = F(-k.fx) * txc * inv_z2;
  const F j11 = F(k.fy) * inv_z;
  const F j12 = F(-k.fy) * tyc * inv_z2;
  const F t00 = j00 * wv[0] + j02 * wv[8];
  const F t01 = j00 * wv[1] + j02 * wv[9];
  const F t02 = j00 * wv[2] + j02 * wv[10];
  const F t10 = j11 * wv[4] + j12 * wv[8];
  const F t11 = j11 * wv[5] + j12 * wv[9];
  const F t12 = j11 * wv[6] + j12 * wv[10];
  g.T[0] = t00.v; g.T[1] = t01.v; g.T[2] = t02.v;
  g.T[3] = t10.v; g.T[4] = t11.v; g.T[5] = t12.v;
  const F v0a = xx * t00 + xy * t01 + xz * t02;
  const F v1a = xy * t00 + yy * t01 + yz * t02;
  const F v2a = xz * t00 + yz * t01 + zz * t02;
  const F v0b = xx * t10 + xy * t11 + xz * t12;
  const F v1b = xy * t10 + yy * t11 + yz * t12;
  const F v2b = xz * t10 + yz * t11 + zz * t12;
  g.va[0] = v0a.v; g.va[1] = v1a.v; g.va[2] = v2a.v;
  g.vb[0] = v0b.v; g.vb[1] = v1b.v; g.vb[2] = v2b.v;
  F c00 = t00 * v0a + t01 * v1a + t02 * v2a + kLowpass;
  F c01 = t10 * v0a + t11 * v1a + t12 * v2a;
  F c11 = t10 * v0b + t11 * v1b + t12 * v2b + kLowpass;

  // ops/projection.preprocess
  if (!g.front) c00 = c01 = c11 = F(1.f);
  const F det = c00 * c11 - c01 * c01;
  g.det_ok = det.v != 0.f;
  const F di = frcp(g.det_ok ? det : F(1.f));
  g.c00 = c00.v; g.c01 = c01.v; g.c11 = c11.v; g.det = det.v; g.di = di.v;
  const F mid = F(0.5f) * (c00 + c11);
  const F disc = fsqrt(fmax0(mid * mid - det, kEigGuard));
  const F lam = mid + disc;
  g.radius_f = ceilf((F(3.f) * fsqrt(fmax0(lam, 0.f))).v);

  // ops/projection.project_points and ndc2pix
  const F hx = F(fp[0]) * x + F(fp[1]) * y + F(fp[2]) * z + F(fp[3]);
  const F hy = F(fp[4]) * x + F(fp[5]) * y + F(fp[6]) * z + F(fp[7]);
  const F hw = F(fp[12]) * x + F(fp[13]) * y + F(fp[14]) * z + F(fp[15]);
  const F pw = frcp(hw + kProjEps);
  g.hx = hx.v; g.hy = hy.v; g.pw = pw.v;
  const F px = ((hx * pw + F(1.f)) * k.width - F(1.f)) * F(0.5f);
  const F py = ((hy * pw + F(1.f)) * k.height - F(1.f)) * F(0.5f);
  g.pix[0] = g.front ? px.v : kOffscreen;
  g.pix[1] = g.front ? py.v : kOffscreen;
}

// utils/sh._sh_basis at a unit direction: the (deg + 1)^2 basis values
__device__ __forceinline__ void sh_basis(int deg, F x, F y, F z, float* b) {
  b[0] = kC0;
  if (deg < 1) return;
  b[1] = (F(-kC1) * y).v;
  b[2] = (F(kC1) * z).v;
  b[3] = (F(-kC1) * x).v;
  if (deg < 2) return;
  const F xx = x * x, yy = y * y, zz = z * z;
  const F xy = x * y, yz = y * z, xz = x * z;
  b[4] = (F(kC2_0) * xy).v;
  b[5] = (F(kC2_1) * yz).v;
  b[6] = (F(kC2_2) * (F(2.f) * zz - xx - yy)).v;
  b[7] = (F(kC2_3) * xz).v;
  b[8] = (F(kC2_4) * (xx - yy)).v;
  if (deg < 3) return;
  b[9] = (F(kC3_0) * y * (F(3.f) * xx - yy)).v;
  b[10] = (F(kC3_1) * xy * z).v;
  b[11] = (F(kC3_2) * y * (F(4.f) * zz - xx - yy)).v;
  b[12] = (F(kC3_3) * z * (F(2.f) * zz - F(3.f) * xx - F(3.f) * yy)).v;
  b[13] = (F(kC3_4) * x * (F(4.f) * zz - xx - yy)).v;
  b[14] = (F(kC3_5) * z * (xx - yy)).v;
  b[15] = (F(kC3_6) * x * (xx - F(3.f) * yy)).v;
}

// utils/sh.sh_to_color's direction: (means - campos) times the guarded
// rsqrt of its squared norm; returns that factor, and d, its squared norm
// and the direction
__device__ __forceinline__ float sh_dir(const float* p, const float* campos,
                                        float* d, float& n2v, float* dir) {
  const F dx = F(p[0]) - campos[0], dy = F(p[1]) - campos[1],
          dz = F(p[2]) - campos[2];
  const F n2 = (dx * dx + dz * dz) + dy * dy;
  n2v = n2.v;
  const float r = rsqrtf(fmax0(n2, kNormEps).v);
  d[0] = dx.v; d[1] = dy.v; d[2] = dz.v;
  dir[0] = (dx * r).v; dir[1] = (dy * r).v; dir[2] = (dz * r).v;
  return r;
}

__device__ __forceinline__ void load_camera(const float* wv, const float* fp,
                                            const float* campos, float* s) {
  const int t = threadIdx.x;
  if (t < 16) {
    s[t] = wv[t];
  } else if (t < 32) {
    s[t] = fp[t - 16];
  } else if (t < kCamFloats) {
    s[t] = campos != nullptr ? campos[t - 32] : 0.f;
  }
  __syncthreads();
}

struct FwdArgs {
  const float *xyz, *scales, *quats;
  const uint8_t* valid;
  const float *sh, *colors, *lf, *offset;
  const float *wv, *fp, *campos;
  int n_coef, deg, lf_dim, n_feat;
  Scalars k;
  float *mean2d, *conic, *depth;
  int* radius;
  uint8_t* mask;
  float* feats;
};

__global__ void __launch_bounds__(kThreads) prologue_fwd_kernel(FwdArgs a) {
  __shared__ float s_cam[kCamFloats];
  load_camera(a.wv, a.fp, a.campos, s_cam);
  const int r0 = blockIdx.x * kThreads;
  const int i = r0 + threadIdx.x;
  const int C = a.n_feat;
  if (i < a.k.n && i >= a.k.rows) {
    a.mean2d[2 * i] = a.mean2d[2 * i + 1] = kOffscreen;
    a.conic[3 * i] = 1.f;
    a.conic[3 * i + 1] = 0.f;
    a.conic[3 * i + 2] = 1.f;
    a.depth[i] = 0.f;
    a.radius[i] = 0;
    a.mask[i] = 0;
    if (a.feats != nullptr) {
      const size_t o = static_cast<size_t>(i) * C;
      a.feats[o] = a.feats[o + 1] = a.feats[o + 2] = 0.f;
      a.feats[o + C - 1] = 0.f;
    }
  } else if (i < a.k.n) {
    Geo g;
    geometry(s_cam, a.k, a.xyz + 3 * i, a.quats + 4 * i, a.scales + 3 * i,
             g);
    const bool mask = a.valid[i] != 0 && g.front && g.det_ok &&
                      g.radius_f > 0.f;
    F mx = g.pix[0], my = g.pix[1];
    if (a.offset != nullptr) {
      mx = mx + a.offset[2 * i];
      my = my + a.offset[2 * i + 1];
    }
    a.mean2d[2 * i] = mx.v;
    a.mean2d[2 * i + 1] = my.v;
    a.conic[3 * i] = (F(g.c11) * g.di).v;
    a.conic[3 * i + 1] = (-F(g.c01) * g.di).v;
    a.conic[3 * i + 2] = (F(g.c00) * g.di).v;
    a.depth[i] = g.tz;
    a.radius[i] = mask ? static_cast<int>(g.radius_f) : 0;
    a.mask[i] = mask ? 1 : 0;
    if (a.feats != nullptr) {
      const size_t o = static_cast<size_t>(i) * C;
      if (a.colors != nullptr) {
        for (int c = 0; c < 3; ++c) a.feats[o + c] = a.colors[3 * i + c];
      } else {
        float d[3], n2, dir[3], b[16];
        sh_dir(a.xyz + 3 * i, s_cam + 32, d, n2, dir);
        sh_basis(a.deg, dir[0], dir[1], dir[2], b);
        const int nb = (a.deg + 1) * (a.deg + 1);
        const float* sh = a.sh + static_cast<size_t>(i) * a.n_coef * 3;
        for (int c = 0; c < 3; ++c) {
          F acc = F(b[0]) * sh[c];
          for (int kk = 1; kk < nb; ++kk) acc = acc + F(b[kk]) * sh[3 * kk + c];
          a.feats[o + c] = fmax0(acc + F(0.5f), 0.f).v;
        }
      }
      a.feats[o + C - 1] = g.tz;
    }
  }
  // the language features: the block's rows moved in coalesced order
  if (a.feats != nullptr && a.lf_dim > 0) {
    const int nr = min(kThreads, a.k.n - r0);
    const int L = a.lf_dim;
    for (int e = threadIdx.x; e < nr * L; e += kThreads) {
      const int r = r0 + e / L;
      const int c = e - (r - r0) * L;
      a.feats[static_cast<size_t>(r) * C + 3 + c] =
          r < a.k.rows ? a.lf[static_cast<size_t>(r) * L + c] : 0.f;
    }
  }
}

struct BwdArgs {
  const float *xyz, *scales, *quats, *sh;
  const float *wv, *fp, *campos;
  int n_coef, deg;
  Scalars k;
  const float *g_mean2d, *g_conic, *g_feats;
  int g_stride, depth_col, stop_depth_grad;
  float *dxyz, *dscales, *dquats, *dsh, *doffset;
};

// dL/dv of v * rsqrt(max(|v|^2, eps)) (r the rsqrt, n2 >= eps whether the
// clamp passed the norm): g r - r^3 (g . v) v, as autograd differentiates it
__device__ __forceinline__ void normalize_bwd(const float* v, float r,
                                              bool live, int n, float* g) {
  float dot = 0.f;
  for (int j = 0; j < n; ++j) dot += g[j] * v[j];
  const float s = live ? r * r * r * dot : 0.f;
  for (int j = 0; j < n; ++j) g[j] = g[j] * r - s * v[j];
}

__global__ void __launch_bounds__(kThreads) prologue_bwd_kernel(BwdArgs a) {
  __shared__ float s_cam[kCamFloats];
  load_camera(a.wv, a.fp, a.campos, s_cam);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.k.n) return;
  const int nk = a.sh != nullptr ? a.n_coef * 3 : 0;
  if (i >= a.k.rows) {
    for (int j = 0; j < 3; ++j) a.dxyz[3 * i + j] = a.dscales[3 * i + j] = 0.f;
    for (int j = 0; j < 4; ++j) a.dquats[4 * i + j] = 0.f;
    for (int j = 0; j < nk; ++j) a.dsh[static_cast<size_t>(i) * nk + j] = 0.f;
    if (a.doffset != nullptr) a.doffset[2 * i] = a.doffset[2 * i + 1] = 0.f;
    return;
  }
  const float* wv = s_cam;
  const float* fp = s_cam + 16;
  const float* p = a.xyz + 3 * i;
  const float* q = a.quats + 4 * i;
  Geo g;
  geometry(s_cam, a.k, p, q, a.scales + 3 * i, g);
  float dp[3] = {0.f, 0.f, 0.f};
  float ds[3] = {0.f, 0.f, 0.f};
  float dq[4] = {0.f, 0.f, 0.f, 0.f};
  const float gmx = a.g_mean2d[2 * i], gmy = a.g_mean2d[2 * i + 1];
  if (a.doffset != nullptr) {
    a.doffset[2 * i] = gmx;
    a.doffset[2 * i + 1] = gmy;
  }
  if (g.front) {
    // the projected mean: ndc2pix, p_w = 1 / (w + eps), the rows of P
    const float dnx = gmx * 0.5f * a.k.width;
    const float dny = gmy * 0.5f * a.k.height;
    const float dpw = dnx * g.hx + dny * g.hy;
    const float dhx = dnx * g.pw, dhy = dny * g.pw;
    const float dhw = -dpw * g.pw * g.pw;
    for (int j = 0; j < 3; ++j) {
      dp[j] += dhx * fp[j] + dhy * fp[4 + j] + dhw * fp[12 + j];
    }

    // the conic (c11, -c01, c00) / det
    const float ga = a.g_conic[3 * i], gb = a.g_conic[3 * i + 1],
                gc = a.g_conic[3 * i + 2];
    float dc00 = gc * g.di, dc11 = ga * g.di, dc01 = -gb * g.di;
    if (g.det_ok) {
      const float ddi = ga * g.c11 - gb * g.c01 + gc * g.c00;
      const float ddet = -ddi * g.di * g.di;
      dc00 += ddet * g.c11;
      dc11 += ddet * g.c00;
      dc01 -= 2.f * ddet * g.c01;
    }
    // c = T Sigma T^T: T's rows and Sigma's six entries
    const float* t0 = g.T;
    const float* t1 = g.T + 3;
    float dt0[3], dt1[3];
    for (int j = 0; j < 3; ++j) {
      dt0[j] = 2.f * dc00 * g.va[j] + dc01 * g.vb[j];
      dt1[j] = dc01 * g.va[j] + 2.f * dc11 * g.vb[j];
    }
    float dcov[6];
    const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
    for (int e = 0; e < 6; ++e) {
      const int u = ia[e], v = ib[e];
      float d = dc00 * t0[u] * t0[v] + dc01 * t1[u] * t0[v] +
                dc11 * t1[u] * t1[v];
      if (u != v) {
        d += dc00 * t0[v] * t0[u] + dc01 * t1[v] * t0[u] +
             dc11 * t1[v] * t1[u];
      }
      dcov[e] = d;
    }
    // T = J W: J's four entries
    const float dj00 = dt0[0] * wv[0] + dt0[1] * wv[1] + dt0[2] * wv[2];
    const float dj02 = dt0[0] * wv[8] + dt0[1] * wv[9] + dt0[2] * wv[10];
    const float dj11 = dt1[0] * wv[4] + dt1[1] * wv[5] + dt1[2] * wv[6];
    const float dj12 = dt1[0] * wv[8] + dt1[1] * wv[9] + dt1[2] * wv[10];
    // J = [fx/z, 0, -fx tx_c/z^2; 0, fy/z, -fy ty_c/z^2]
    const float dinv_z2 = dj02 * (-a.k.fx * g.tc[0]) + dj12 * (-a.k.fy * g.tc[1]);
    const float dinv_z = dj00 * a.k.fx + dj11 * a.k.fy + 2.f * g.inv_z * dinv_z2;
    const float dtc[2] = {dj02 * -a.k.fx * g.inv_z2, dj12 * -a.k.fy * g.inv_z2};
    float dtz = -dinv_z * g.inv_z * g.inv_z;
    const float lim[2] = {a.k.limx, a.k.limy};
    float dt[2];
    for (int j = 0; j < 2; ++j) {
      // t_c = clamp(t / z, -lim, lim) z
      const float cl = fminf(fmaxf(g.u[j], -lim[j]), lim[j]);
      dtz += dtc[j] * cl;
      const bool pass = g.u[j] >= -lim[j] && g.u[j] <= lim[j];
      const float du = pass ? dtc[j] * g.tzc : 0.f;
      dt[j] = du / g.tzc;
      dtz -= du * g.t[j] / (g.tzc * g.tzc);
    }
    for (int j = 0; j < 3; ++j) {
      dp[j] += dt[0] * wv[j] + dt[1] * wv[4 + j] + dtz * wv[8 + j];
    }
    // Sigma = M M^T, M = R diag(s)
    const float D[9] = {2.f * dcov[0], dcov[1], dcov[2],
                        dcov[1], 2.f * dcov[3], dcov[4],
                        dcov[2], dcov[4], 2.f * dcov[5]};
    float dR[9];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) {
        const float dm = D[3 * r] * g.M[c] + D[3 * r + 1] * g.M[3 + c] +
                         D[3 * r + 2] * g.M[6 + c];
        dR[3 * r + c] = dm * g.s[c];
        ds[c] += dm * g.R[3 * r + c];
      }
    }
    for (int c = 0; c < 3; ++c) ds[c] *= a.k.smod;
    // R of the twice-normalised (w, x, y, z)
    const float w = g.q2[0], x = g.q2[1], y = g.q2[2], z = g.q2[3];
    dq[0] = 2.f * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] -
                   y * dR[6] + x * dR[7]);
    dq[1] = 2.f * (y * dR[1] + z * dR[2] + y * dR[3] - 2.f * x * dR[4] -
                   w * dR[5] + z * dR[6] + w * dR[7] - 2.f * x * dR[8]);
    dq[2] = 2.f * (-2.f * y * dR[0] + x * dR[1] + w * dR[2] + x * dR[3] +
                   z * dR[5] - w * dR[6] + z * dR[7] - 2.f * y * dR[8]);
    dq[3] = 2.f * (-2.f * z * dR[0] - w * dR[1] + x * dR[2] + w * dR[3] -
                   2.f * z * dR[4] + y * dR[5] + x * dR[6] + y * dR[7]);
    // back through both normalisations
    normalize_bwd(g.q1, g.r2, g.n2 >= kNormEps, 4, dq);
    normalize_bwd(q, g.r1, g.n1 >= kNormEps, 4, dq);
  }

  const float* gf = a.g_feats != nullptr
      ? a.g_feats + static_cast<size_t>(i) * a.g_stride : nullptr;
  if (gf != nullptr && !a.stop_depth_grad) {
    const float gd = gf[a.depth_col];
    for (int j = 0; j < 3; ++j) dp[j] += gd * wv[8 + j];
  }
  if (a.sh != nullptr) {
    const float* sh = a.sh + static_cast<size_t>(i) * nk;
    float* dsh = a.dsh + static_cast<size_t>(i) * nk;
    const int nb = (a.deg + 1) * (a.deg + 1);
    float d[3], n2, dir[3], b[16];
    const float r = sh_dir(p, s_cam + 32, d, n2, dir);
    sh_basis(a.deg, dir[0], dir[1], dir[2], b);
    float dpre[3];
    for (int c = 0; c < 3; ++c) {
      // the forward's colour, for the clamp's mask (self >= 0 passes)
      F acc = F(b[0]) * sh[c];
      for (int kk = 1; kk < nb; ++kk) acc = acc + F(b[kk]) * sh[3 * kk + c];
      const float pre = (acc + F(0.5f)).v;
      const float gcol = gf != nullptr ? gf[c] : 0.f;
      dpre[c] = pre >= 0.f ? gcol : 0.f;
    }
    float db[16];
    for (int kk = 0; kk < nk / 3; ++kk) {
      const bool on = kk < nb;
      float s = 0.f;
      for (int c = 0; c < 3; ++c) {
        dsh[3 * kk + c] = on ? b[kk] * dpre[c] : 0.f;
        if (on) s += sh[3 * kk + c] * dpre[c];
      }
      if (kk < 16) db[kk] = s;
    }
    if (a.deg > 0) {
      const float x = dir[0], y = dir[1], z = dir[2];
      float gx = -kC1 * db[3], gy = -kC1 * db[1], gz = kC1 * db[2];
      if (a.deg > 1) {
        const float xx = x * x, yy = y * y, zz = z * z;
        gx += kC2_0 * y * db[4] - 2.f * kC2_2 * x * db[6] +
              kC2_3 * z * db[7] + 2.f * kC2_4 * x * db[8];
        gy += kC2_0 * x * db[4] + kC2_1 * z * db[5] -
              2.f * kC2_2 * y * db[6] - 2.f * kC2_4 * y * db[8];
        gz += kC2_1 * y * db[5] + 4.f * kC2_2 * z * db[6] +
              kC2_3 * x * db[7];
        if (a.deg > 2) {
          gx += kC3_0 * 6.f * x * y * db[9] + kC3_1 * y * z * db[10] -
                kC3_2 * 2.f * x * y * db[11] - kC3_3 * 6.f * x * z * db[12] +
                kC3_4 * (4.f * zz - 3.f * xx - yy) * db[13] +
                kC3_5 * 2.f * x * z * db[14] +
                kC3_6 * 3.f * (xx - yy) * db[15];
          gy += kC3_0 * 3.f * (xx - yy) * db[9] + kC3_1 * x * z * db[10] +
                kC3_2 * (4.f * zz - xx - 3.f * yy) * db[11] -
                kC3_3 * 6.f * y * z * db[12] - kC3_4 * 2.f * x * y * db[13] -
                kC3_5 * 2.f * y * z * db[14] - kC3_6 * 6.f * x * y * db[15];
          gz += kC3_1 * x * y * db[10] + kC3_2 * 8.f * y * z * db[11] +
                kC3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * db[12] +
                kC3_4 * 8.f * x * z * db[13] + kC3_5 * (xx - yy) * db[14];
        }
      }
      float gdir[3] = {gx, gy, gz};
      normalize_bwd(d, r, n2 >= kNormEps, 3, gdir);
      for (int j = 0; j < 3; ++j) dp[j] += gdir[j];
    }
  }
  for (int j = 0; j < 3; ++j) {
    a.dxyz[3 * i + j] = dp[j];
    a.dscales[3 * i + j] = ds[j];
  }
  for (int j = 0; j < 4; ++j) a.dquats[4 * i + j] = dq[j];
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace
}  // namespace legslam

// The C interface (ctypes, legslam_torch/ops/cuda/prologue.py). Pointers
// are device pointers to contiguous float32 rows (valid and mask one byte a
// row); sh, colors, lf, offset, cam_center and feats may be null as the
// wrapper documents. Returns a cudaError_t: 0 when the launch was taken.
extern "C" int legslam_prologue_fwd(
    const float* xyz, const float* scales, const float* quats,
    const uint8_t* valid, const float* sh, int n_coef, int deg,
    const float* colors, const float* lf, int lf_dim, const float* offset,
    const float* world_view, const float* full_proj, const float* cam_center,
    int width, int height, float focal_x, float focal_y, float lim_x,
    float lim_y, float scale_modifier, int rows, int n, float* mean2d,
    float* conic, float* depth, int* radius, uint8_t* mask, float* feats,
    int n_feat, void* stream) {
  using namespace legslam;
  if (n == 0) return 0;
  FwdArgs a{xyz, scales, quats, valid, sh, colors, lf, offset, world_view,
            full_proj, cam_center, n_coef, deg, lf_dim, n_feat,
            Scalars{rows, n, static_cast<float>(width),
                    static_cast<float>(height), focal_x, focal_y, lim_x,
                    lim_y, scale_modifier},
            mean2d, conic, depth, radius, mask, feats};
  prologue_fwd_kernel<<<blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int legslam_prologue_bwd(
    const float* xyz, const float* scales, const float* quats,
    const float* sh, int n_coef, int deg, const float* world_view,
    const float* full_proj, const float* cam_center, int width, int height,
    float focal_x, float focal_y, float lim_x, float lim_y,
    float scale_modifier, int rows, int n, const float* g_mean2d,
    const float* g_conic, const float* g_feats, int g_stride, int depth_col,
    int stop_depth_grad, float* dxyz, float* dscales, float* dquats,
    float* dsh, float* doffset, void* stream) {
  using namespace legslam;
  if (n == 0) return 0;
  BwdArgs a{xyz, scales, quats, sh, world_view, full_proj, cam_center,
            n_coef, deg,
            Scalars{rows, n, static_cast<float>(width),
                    static_cast<float>(height), focal_x, focal_y, lim_x,
                    lim_y, scale_modifier},
            g_mean2d, g_conic, g_feats, g_stride, depth_col, stop_depth_grad,
            dxyz, dscales, dquats, dsh, doffset};
  prologue_bwd_kernel<<<blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
