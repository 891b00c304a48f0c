// Per-particle physics of kernel B, one particle per thread, in registers.
//
// A scalar CUDA copy of the JAX package's component-wise ("_c") functions
// that kernel B (sparkl_tpu/fused/kernels.py:_g2p_kernel) composes:
//   svd3 ............ sparkl_tpu/math/svd.py svd3x3_c, cardano path
//                     (_cardano_trig_vals, _cardano_refined_vals,
//                     _sym_eig3x3_cardano, _svd3x3_from_eig)
//   dp_update ....... sparkl_tpu/models/plasticity.py
//                     drucker_prager_project_s_c + _update_with_svd_c
//   corotated_* ..... sparkl_tpu/models/constitutive.py
//                     corotated_kirchhoff_stress_from_svd_c,
//                     corotated_pos_energy_from_s_c,
//                     sound_speed_timestep_bound_c
//   eos_* ........... sparkl_tpu/models/constitutive.py eos_pressure,
//                     eos_kirchhoff_stress_c, eos_timestep_bound_c (with
//                     math/cmat.py pow_pos, strain_rate_c, deviatoric_c)
// The plain PyTorch versions are the same functions in
// sparkl_tpu_torch/math/svd.py and sparkl_tpu_torch/models/. Expressions
// keep the JAX package's operand order, so results differ from the plain
// versions by rounding only (the library's expf/logf/sinf, and FMA
// contraction, which the build turns off). 1/sqrtf stands for rsqrt, as
// PyTorch's and XLA's CPU backends compute it.
#pragma once

#include <math.h>

namespace sparkl {

__device__ __forceinline__ float det3(const float m[3][3]) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
         m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

__device__ __forceinline__ void cross3(const float x[3], const float y[3],
                                       float o[3]) {
  o[0] = x[1] * y[2] - x[2] * y[1];
  o[1] = x[2] * y[0] - x[0] * y[2];
  o[2] = x[0] * y[1] - x[1] * y[0];
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// cos(acos(r)/3): polynomial seed in sqrt(1 + r) and two Newton steps on
// 4x^3 - 3x = r (svd.py _cos_acos3).
__device__ __forceinline__ float cos_acos3(float r) {
  float u = sqrtf(fmaxf(r + 1.0f, 0.0f));
  float x = 0.500019159f +
            u * (0.407814278f +
                 u * (-0.0531768362f +
                      u * (0.0135525949f + u * -0.00218724162f)));
  x = clampf(x, 0.5f, 1.0f);
  for (int it = 0; it < 2; ++it) {
    float g = 4.0f * x * x * x - 3.0f * x - r;
    float gp = fmaxf(12.0f * x * x - 3.0f, 0.075f);
    x = clampf(x - g / gp, 0.5f, 1.0f);
  }
  return x;
}

// Descending eigenvalues of a scale-normalized PSD symmetric 3x3:
// trigonometric Cardano, then l2 from det and l1 from the second invariant.
__device__ __forceinline__ void cardano_refined_vals(float a00, float a01,
                                                     float a02, float a11,
                                                     float a12, float a22,
                                                     float l[3]) {
  float q = (a00 + a11 + a22) / 3.0f;
  float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  float p2 = b00 * b00 + b11 * b11 + b22 * b22 +
             2.0f * (a01 * a01 + a02 * a02 + a12 * a12);
  float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  float pinv = p > 1e-30f ? 1.0f / p : 0.0f;
  float c00 = b00 * pinv, c11 = b11 * pinv, c22 = b22 * pinv;
  float c01 = a01 * pinv, c02 = a02 * pinv, c12 = a12 * pinv;
  float detb = c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02) +
               c02 * (c01 * c12 - c11 * c02);
  float r = clampf(0.5f * detb, -1.0f, 1.0f);
  float cphi = cos_acos3(r);
  float sphi = sqrtf(fmaxf(1.0f - cphi * cphi, 0.0f));
  float l0 = q + 2.0f * p * cphi;
  float l2 = q + 2.0f * p * (-0.5f * cphi - 0.8660254037844386f * sphi);
  float l1 = 3.0f * q - l0 - l2;

  float i2 = a00 * a11 - a01 * a01 + a00 * a22 - a02 * a02 + a11 * a22 -
             a12 * a12;
  float i3 = a00 * (a11 * a22 - a12 * a12) - a01 * (a01 * a22 - a12 * a02) +
             a02 * (a01 * a12 - a11 * a02);
  const float tiny = 1e-30f;
  float l1v = fmaxf(l1, 0.0f);
  float den = l0 * l1v;
  float l2r = den > tiny ? fminf(fmaxf(i3 / den, 0.0f), l1v) : fmaxf(l2, 0.0f);
  float den1 = l0 + l2r;
  if (den1 > tiny) {
    l1 = fminf(fmaxf((i2 - l0 * l2r) / den1, l2r), l0);
  } else {
    l1 = fmaxf(l1, 0.0f);
  }
  den = l0 * l1;
  l2 = den > tiny ? fminf(fmaxf(i3 / den, 0.0f), l1) : fmaxf(l2, 0.0f);
  l[0] = l0;
  l[1] = l1;
  l[2] = l2;
}

// Max-norm cross product of rows of (A - lv I): the null direction when
// the matrix has rank 2.
__device__ __forceinline__ void row_cross_null(float a00, float a01, float a02,
                                               float a11, float a12, float a22,
                                               float lv, float best[3]) {
  float r0[3] = {a00 - lv, a01, a02};
  float r1[3] = {a01, a11 - lv, a12};
  float r2[3] = {a02, a12, a22 - lv};
  float c01[3], c02[3], c12[3];
  cross3(r0, r1, c01);
  cross3(r0, r2, c02);
  cross3(r1, r2, c12);
  float n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
  float n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2];
  float n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
  bool use02 = n02 > n01;
  float bestn = use02 ? n02 : n01;
  bool use12 = n12 > bestn;
  for (int i = 0; i < 3; ++i) {
    float b = use02 ? c02[i] : c01[i];
    best[i] = use12 ? c12[i] : b;
  }
}

__device__ __forceinline__ bool normalize_eig(const float x[3], float o[3]) {
  float n2v = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  bool good = n2v > 1e-20f;
  float inv = good ? 1.0f / sqrtf(n2v) : 0.0f;
  for (int i = 0; i < 3; ++i) o[i] = x[i] * inv;
  return good;
}

__device__ __forceinline__ bool normalize_u(const float x[3], float o[3]) {
  float n = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  bool good = n > 1e-12f;
  float inv = good ? 1.0f / n : 0.0f;
  for (int i = 0; i < 3; ++i) o[i] = x[i] * inv;
  return good;
}

// Unit vector orthogonal to `a` through the least-aligned basis axis.
template <bool kEigNorm>
__device__ __forceinline__ void ortho_fallback(const float a[3], float o[3]) {
  float au0 = fabsf(a[0]), au1 = fabsf(a[1]), au2 = fabsf(a[2]);
  bool pick0 = (au0 <= au1) && (au0 <= au2);
  bool pick1 = (!pick0) && (au1 <= au2);
  float e[3] = {pick0 ? 1.0f : 0.0f, pick1 ? 1.0f : 0.0f,
                (pick0 || pick1) ? 0.0f : 1.0f};
  float c[3];
  cross3(a, e, c);
  if (kEigNorm) {
    normalize_eig(c, o);
  } else {
    normalize_u(c, o);
  }
}

// f = u diag(s) v^T with s >= 0 descending (svd.py svd3x3_c, cardano).
__device__ __forceinline__ void svd3(const float f[3][3], float u[3][3],
                                     float s[3], float v[3][3]) {
  float a00 = f[0][0] * f[0][0] + f[1][0] * f[1][0] + f[2][0] * f[2][0];
  float a11 = f[0][1] * f[0][1] + f[1][1] * f[1][1] + f[2][1] * f[2][1];
  float a22 = f[0][2] * f[0][2] + f[1][2] * f[1][2] + f[2][2] * f[2][2];
  float a01 = f[0][0] * f[0][1] + f[1][0] * f[1][1] + f[2][0] * f[2][1];
  float a02 = f[0][0] * f[0][2] + f[1][0] * f[1][2] + f[2][0] * f[2][2];
  float a12 = f[0][1] * f[0][2] + f[1][1] * f[1][2] + f[2][1] * f[2][2];
  float scale = fmaxf(fmaxf(fmaxf(fabsf(a00), fabsf(a11)), fabsf(a22)), 1e-30f);
  float inv_scale = 1.0f / scale;
  a00 *= inv_scale; a11 *= inv_scale; a22 *= inv_scale;
  a01 *= inv_scale; a02 *= inv_scale; a12 *= inv_scale;

  float l[3];
  cardano_refined_vals(a00, a01, a02, a11, a12, a22, l);

  // Eigenvectors: anchor at the better-separated end of the spectrum.
  float cand_t[3], cand_b[3];
  row_cross_null(a00, a01, a02, a11, a12, a22, l[0], cand_t);
  row_cross_null(a00, a01, a02, a11, a12, a22, l[2], cand_b);
  bool use_top = (l[0] - l[1]) >= (l[1] - l[2]);
  float anchor_raw[3], other_raw[3], anchor[3], other[3];
  for (int i = 0; i < 3; ++i) {
    anchor_raw[i] = use_top ? cand_t[i] : cand_b[i];
    other_raw[i] = use_top ? cand_b[i] : cand_t[i];
  }
  if (!normalize_eig(anchor_raw, anchor)) {
    anchor[0] = 1.0f;
    anchor[1] = 0.0f;
    anchor[2] = 0.0f;
  }
  float dot = other_raw[0] * anchor[0] + other_raw[1] * anchor[1] +
              other_raw[2] * anchor[2];
  float other_o[3];
  for (int i = 0; i < 3; ++i) other_o[i] = other_raw[i] - dot * anchor[i];
  if (!normalize_eig(other_o, other)) ortho_fallback<true>(anchor, other);
  float ms = use_top ? -1.0f : 1.0f;
  float mid[3];
  cross3(anchor, other, mid);
  float cols[3][3];
  for (int i = 0; i < 3; ++i) {
    cols[0][i] = use_top ? anchor[i] : other[i];
    cols[1][i] = ms * mid[i];
    cols[2][i] = use_top ? other[i] : anchor[i];
  }

  // Singular values and U from F v_k with orthonormal fallbacks.
  float fv[3][3];
  for (int k = 0; k < 3; ++k) {
    s[k] = sqrtf(fmaxf(l[k], 0.0f) * scale);
    for (int i = 0; i < 3; ++i)
      fv[k][i] = f[i][0] * cols[k][0] + f[i][1] * cols[k][1] + f[i][2] * cols[k][2];
  }
  float u0[3], u1[3], u2[3];
  if (!normalize_u(fv[0], u0)) {
    u0[0] = 1.0f;
    u0[1] = 0.0f;
    u0[2] = 0.0f;
  }
  float dot01 = u0[0] * fv[1][0] + u0[1] * fv[1][1] + u0[2] * fv[1][2];
  float u1r[3];
  for (int i = 0; i < 3; ++i) u1r[i] = fv[1][i] - dot01 * u0[i];
  if (!normalize_u(u1r, u1)) ortho_fallback<false>(u0, u1);
  float u2d[3];
  cross3(u0, u1, u2d);
  float sgn = u2d[0] * fv[2][0] + u2d[1] * fv[2][1] + u2d[2] * fv[2][2];
  sgn = sgn < 0.0f ? -1.0f : 1.0f;
  for (int i = 0; i < 3; ++i) u2[i] = u2d[i] * sgn;
  for (int i = 0; i < 3; ++i) {
    u[i][0] = u0[i];
    u[i][1] = u1[i];
    u[i][2] = u2[i];
    for (int k = 0; k < 3; ++k) v[i][k] = cols[k][i];
  }
}

// u diag(s) v^T.
__device__ __forceinline__ void recompose3(const float u[3][3], const float s[3],
                                           const float v[3][3], float o[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[i][j] = u[i][0] * s[0] * v[j][0] + u[i][1] * s[1] * v[j][1] +
                u[i][2] * s[2] * v[j][2];
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 1e-20f ? a / b : 0.0f;
}

// Drucker-Prager return map with a caller-supplied SVD (plasticity.py
// drucker_prager_update_with_svd_c). pp = [h0, h1, h2, h3, lambda, mu,
// only_when_failed, vol_corr]. Updates f, pdd, ph, lvg in place and s to the
// projected singular values (so (u, s, v) stays an SVD of the new f).
__device__ __forceinline__ void dp_update(const float pp[8], float phase,
                                          float f[3][3], const float u[3][3],
                                          float s[3], const float v[3][3],
                                          float& pdd, float& ph, float& lvg) {
  const float h0 = pp[0], h1 = pp[1], h2 = pp[2], h3 = pp[3];
  const float lam = pp[4], mu = pp[5], only_when_failed = pp[6], vol_corr = pp[7];
  float angle = h0 + (h1 * ph - h3) * expf(-h2 * ph);
  float sn = sinf(angle);
  float alpha = 0.8164965809277260f * (2.0f * sn) / (3.0f - sn);

  float strain[3], dev[3];
  for (int k = 0; k < 3; ++k) strain[k] = logf(fmaxf(s[k], 1e-20f)) + lvg / 3.0f;
  float trace = strain[0] + strain[1] + strain[2];
  for (int k = 0; k < 3; ++k) dev[k] = strain[k] - trace / 3.0f;
  float dev_norm = sqrtf(dev[0] * dev[0] + dev[1] * dev[1] + dev[2] * dev[2]);
  bool case_a = (dev_norm == 0.0f) || (trace > 0.0f);
  float dq_a = sqrtf(strain[0] * strain[0] + strain[1] * strain[1] +
                     strain[2] * strain[2]);
  float gamma = dev_norm + (3.0f * lam + 2.0f * mu) / (2.0f * mu) * trace * alpha;
  bool case_b = (!case_a) && (gamma <= 0.0f);
  float new_s[3];
  for (int k = 0; k < 3; ++k)
    new_s[k] = case_a ? 1.0f : expf(strain[k] - gamma * safe_div(dev[k], dev_norm));
  float dq = case_a ? dq_a : gamma;
  bool applied = (!case_b) && ((only_when_failed == 0.0f) || (phase == 0.0f));

  float prev_det = s[0] * s[1] * s[2];
  float new_det0 = new_s[0] * new_s[1] * new_s[2];
  float diff = new_det0 - prev_det;
  float new_det = diff > 0.0f ? new_det0 : prev_det + diff * vol_corr;
  if (applied) {
    pdd = pdd * safe_div(prev_det, new_det);
    lvg = lvg + (logf(fmaxf(prev_det, 1e-30f)) - logf(fmaxf(new_det, 1e-30f)));
    ph = ph + dq;
    for (int k = 0; k < 3; ++k) s[k] = new_s[k];
    recompose3(u, s, v, f);
  }
}

// Kirchhoff stress of corotated linear elasticity from an SVD of f.
__device__ __forceinline__ void corotated_stress(float lam, float mu,
                                                 float split_on_failure,
                                                 float phase, float hardening,
                                                 const float f[3][3],
                                                 const float u[3][3],
                                                 const float s[3],
                                                 const float v[3][3],
                                                 float out[3][3]) {
  float j = det3(f);
  float pos[3], neg[3];
  for (int k = 0; k < 3; ++k) {
    pos[k] = fmaxf(s[k] - 1.0f, 0.0f);
    neg[k] = fminf(s[k] - 1.0f, 0.0f);
  }
  float rp[3][3], rn[3][3];
  recompose3(u, pos, v, rp);
  recompose3(u, neg, v, rn);
  float coeff = 2.0f * mu * hardening;
  float spherical = lam * hardening * (j - 1.0f) * j;
  bool compressed = j < 1.0f;
  float sph_pos = compressed ? 0.0f : spherical;
  float sph_neg = compressed ? spherical : 0.0f;
  float phase_coeff = (split_on_failure != 0.0f && phase == 0.0f) ? 0.0f : 1.0f;
  for (int i = 0; i < 3; ++i) {
    for (int jj = 0; jj < 3; ++jj) {
      float pd = (rp[i][0] * f[jj][0] + rp[i][1] * f[jj][1] + rp[i][2] * f[jj][2]) * coeff;
      float nd = (rn[i][0] * f[jj][0] + rn[i][1] * f[jj][1] + rn[i][2] * f[jj][2]) * coeff;
      if (i == jj) {
        pd = pd + sph_pos;
        nd = nd + sph_neg;
      }
      out[i][jj] = pd * phase_coeff + nd;
    }
  }
}

// Tensile energy from the singular values s of f.
__device__ __forceinline__ float corotated_pos_energy(float lam, float mu,
                                                      float hardening,
                                                      const float f[3][3],
                                                      const float s[3]) {
  float j = det3(f);
  float t0 = fmaxf(s[0] - 1.0f, 0.0f), t1 = fmaxf(s[1] - 1.0f, 0.0f),
        t2 = fmaxf(s[2] - 1.0f, 0.0f);
  float pos_dev = mu * hardening * (t0 * t0 + t1 * t1 + t2 * t2);
  float jm = j - 1.0f;
  float spherical = lam * hardening / 2.0f * (jm * jm);
  return j < 1.0f ? pos_dev : pos_dev + spherical;
}

// dt <= alpha h / max(|v|, c), c = sqrt((K + 4/3 G) / rho0).
__device__ __forceinline__ float sound_speed_bound(float alpha, float bulk,
                                                   float shear, float density0,
                                                   float vnorm, float h) {
  float c = sqrtf((bulk + 1.3333333333333333f * shear) / density0);
  return alpha * h / fmaxf(vnorm, c);
}

// x^p for x > 0 as exp(p log(max(x, 1e-30))), cmat.pow_pos's form (not
// powf: the EOS pressure multiplies its rounding by p0).
__device__ __forceinline__ float pow_pos(float x, float p) {
  return expf(p * logf(fmaxf(x, 1e-30f)));
}

// Monaghan SPH pressure max(p0 ((rho/rho0)^gamma - 1), -max_neg).
__device__ __forceinline__ float eos_pressure(float p0, float gamma,
                                              float max_neg, float mass,
                                              float volume0,
                                              float density_fluid) {
  float density0 = mass / volume0;
  float ratio = density_fluid / density0;
  return fmaxf(p0 * (pow_pos(ratio, gamma) - 1.0f), -max_neg);
}

// Kirchhoff stress -p J I + 2 mu_visc J dev(sym(g)) of the EOS fluid.
__device__ __forceinline__ void eos_stress(float p0, float gamma, float visc,
                                           float max_neg, float mass,
                                           float volume0, float density_fluid,
                                           float fluid_j, const float g[3][3],
                                           float out[3][3]) {
  float p = eos_pressure(p0, gamma, max_neg, mass, volume0, density_fluid);
  float sr[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) sr[i][j] = 0.5f * (g[i][j] + g[j][i]);
  float sph = (sr[0][0] + sr[1][1] + sr[2][2]) / 3.0f;
  float vcoef = visc != 0.0f ? 2.0f * visc * fluid_j : 0.0f;
  float diag = -p * fluid_j;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float dev = i == j ? sr[i][j] + (-sph) : sr[i][j];
      out[i][j] = i == j ? dev * vcoef + diag : dev * vcoef;
    }
}

// EOS dt bound: the single-particle stability bound (+inf where its
// argument is not positive or J <= 0) and the CFL bound.
__device__ __forceinline__ float eos_timestep_bound(float p0, float gamma,
                                                    float max_neg,
                                                    float fluid_j, float mass,
                                                    float volume0,
                                                    float density_fluid,
                                                    float vsq, float h) {
  float density0 = mass / volume0;
  float p = -eos_pressure(p0, gamma, max_neg, mass, volume0, density_fluid);
  float arg = safe_div(density0 * (fluid_j - 1.0f), 6.0f * p * 3.0f);
  float safe_j = fluid_j > 0.0f ? fluid_j : 1.0f;
  float single = (h / safe_j) * sqrtf(fmaxf(arg, 0.0f));
  if (!(arg > 0.0f && fluid_j > 0.0f)) single = INFINITY;
  float c_sq = fmaxf(vsq, 1.0f) / 0.1f;
  float cfl = h / sqrtf(c_sq);
  return fminf(single, cfl);
}

}  // namespace sparkl
