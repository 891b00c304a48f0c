// Per-particle physics of kernels A and B, one particle per thread, in
// registers.
//
// A scalar CUDA copy of the JAX package's component-wise ("_c") functions
// that kernels A and B (sparkl_tpu/fused/kernels.py:_p2g_kernel,
// _g2p_kernel) compose:
//   svd3 ............ sparkl_tpu/math/svd.py svd3x3_c, cardano path
//                     (_cardano_trig_vals, _cardano_refined_vals,
//                     _sym_eig3x3_cardano, _svd3x3_from_eig)
//   svd2 ............ sparkl_tpu/math/svd.py svd2x2_c (polar decomposition
//                     and one algebraic Givens rotation)
//   dp_update ....... sparkl_tpu/models/plasticity.py
//                     drucker_prager_project_s_c + _update_with_svd_c
//   rankine_update .. plasticity.py rankine_update_c
//   snow_update ..... plasticity.py snow_update_c
//   nacc_update ..... plasticity.py nacc_update_c (the reference's NACC,
//                     cases A-D, with math/cmat.py sinh_c)
//   corotated_* ..... sparkl_tpu/models/constitutive.py
//                     corotated_kirchhoff_stress_from_svd_c,
//                     corotated_pos_energy_from_s_c (2D and 3D),
//                     sound_speed_timestep_bound_c
//   maximum_stress_failed  sparkl_tpu/models/failure.py
//                     maximum_stress_failed_c (sym_eigvals2x2_c in 2D,
//                     sym_eigvals3x3_c's cardano form in 3D)
//   neo_hookean_* ... constitutive.py neo_hookean_phase_coeff,
//                     neo_hookean_kirchhoff_stress_c, neo_hookean_pos_energy_c
//                     (its dt bound is the corotated one)
//   eos_* ........... sparkl_tpu/models/constitutive.py eos_pressure,
//                     eos_kirchhoff_stress_c, eos_timestep_bound_c (with
//                     math/cmat.py pow_pos, strain_rate_c, deviatoric_c)
// The plain PyTorch versions are the same functions in
// sparkl_tpu_torch/math/svd.py and sparkl_tpu_torch/models/. Expressions
// keep the JAX package's operand order, so results differ from the plain
// versions by rounding only (the library's expf/logf/sinf, and FMA
// contraction, which the build turns off). 1/sqrtf stands for rsqrt, as
// PyTorch's and XLA's CPU backends compute it. A division by a constant
// (1/d in Drucker-Prager and the EOS trace, the EOS bound's 1/0.1) is the
// product with the f32 reciprocal, as jitted XLA rewrites the JAX
// package's (linalg.div_const in the plain versions); the Cardano SVD keeps
// its true divisions by 3 and 6 (svd.py says why). Where a difference
// cancels near F = I, neo-Hookean takes the FMAs jitted XLA forms (J^2 -
// 1, tr(F F^T) J^(-2/d) - d and the squares of tr(F F^T)) as explicit
// fmaf, as its plain version does (linalg.fma). The 2D functions, the 3D
// eigenvalues, the failure envelope and neo-Hookean are __host__
// __device__; the rest serve the kernels only (NACC calls the SVD).
#pragma once

#include <math.h>

namespace sparkl {

__host__ __device__ inline float det3(const float m[3][3]) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
         m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

__host__ __device__ inline float det(const float m[2][2]) {
  return m[0][0] * m[1][1] - m[0][1] * m[1][0];
}
__host__ __device__ inline float det(const float m[3][3]) { return det3(m); }

__device__ __forceinline__ void cross3(const float x[3], const float y[3],
                                       float o[3]) {
  o[0] = x[1] * y[2] - x[2] * y[1];
  o[1] = x[2] * y[0] - x[0] * y[2];
  o[2] = x[0] * y[1] - x[1] * y[0];
}

__host__ __device__ inline float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// cos(acos(r)/3): polynomial seed in sqrt(1 + r) and two Newton steps on
// 4x^3 - 3x = r (svd.py _cos_acos3).
__host__ __device__ inline float cos_acos3(float r) {
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

// Raw trigonometric-Cardano eigenvalues of a scale-normalized symmetric
// 3x3, descending, valid for any symmetric matrix (svd.py
// _cardano_trig_vals).
__host__ __device__ inline void cardano_trig_vals(float a00, float a01, float a02, float a11,
                                                  float a12, float a22, float l[3]) {
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
  l[0] = q + 2.0f * p * cphi;
  l[2] = q + 2.0f * p * (-0.5f * cphi - 0.8660254037844386f * sphi);
  l[1] = 3.0f * q - l[0] - l[2];
}

// Descending eigenvalues of a scale-normalized PSD symmetric 3x3:
// trigonometric Cardano, then l2 from det and l1 from the second invariant.
__device__ __forceinline__ void cardano_refined_vals(float a00, float a01,
                                                     float a02, float a11,
                                                     float a12, float a22,
                                                     float l[3]) {
  float lt[3];
  cardano_trig_vals(a00, a01, a02, a11, a12, a22, lt);
  const float l0 = lt[0];
  float l1 = lt[1], l2 = lt[2];

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

// f = u diag(s) v^T, s >= 0 unsorted (svd.py svd2x2_c): F = R S with R a
// rotation, S = G diag(l) G^T by one algebraic Givens rotation, V = G, U =
// R G, and a negative eigenvalue's sign flipped into U.
__host__ __device__ inline void svd2(const float f[2][2], float u[2][2], float s[2],
                                     float v[2][2]) {
  const float a = f[0][0], b = f[0][1], c = f[1][0], d = f[1][1];
  const float x = a + d, y = c - b;
  const float r = sqrtf(x * x + y * y);
  const bool ok = r > 1e-20f;
  const float r_safe = ok ? r : 1.0f;
  const float cr = ok ? x / r_safe : 1.0f;
  const float sr = ok ? y / r_safe : 0.0f;
  const float s00 = cr * a + sr * c;
  const float s01 = cr * b + sr * d;
  const float s11 = -sr * b + cr * d;

  const float diff = s00 - s11;
  const bool denom_ok = fabsf(s01) > 1e-30f;
  const float tau = diff / (denom_ok ? 2.0f * s01 : 1.0f);
  const float sgn = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : 0.0f);
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  if (tau == 0.0f) t = 1.0f;
  if (!denom_ok) t = 0.0f;
  const float ct = 1.0f / sqrtf(1.0f + t * t);
  const float st = t * ct;
  const float l0 = ct * ct * s00 + 2.0f * ct * st * s01 + st * st * s11;
  const float l1 = st * st * s00 - 2.0f * ct * st * s01 + ct * ct * s11;

  const float sign0 = l0 < 0.0f ? -1.0f : 1.0f;
  const float sign1 = l1 < 0.0f ? -1.0f : 1.0f;
  v[0][0] = ct;
  v[0][1] = -st;
  v[1][0] = st;
  v[1][1] = ct;
  u[0][0] = (cr * v[0][0] - sr * v[1][0]) * sign0;
  u[0][1] = (cr * v[0][1] - sr * v[1][1]) * sign1;
  u[1][0] = (sr * v[0][0] + cr * v[1][0]) * sign0;
  u[1][1] = (sr * v[0][1] + cr * v[1][1]) * sign1;
  s[0] = l0 * sign0;
  s[1] = l1 * sign1;
}

__device__ __forceinline__ void svd(const float f[2][2], float u[2][2], float s[2],
                                    float v[2][2]) {
  svd2(f, u, s, v);
}
__device__ __forceinline__ void svd(const float f[3][3], float u[3][3], float s[3],
                                    float v[3][3]) {
  svd3(f, u, s, v);
}

// u diag(s) v^T.
template <int D>
__host__ __device__ inline void recompose(const float u[D][D], const float s[D],
                                          const float v[D][D], float o[D][D]) {
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      float acc = u[i][0] * s[0] * v[j][0];
      for (int k = 1; k < D; ++k) acc = acc + u[i][k] * s[k] * v[j][k];
      o[i][j] = acc;
    }
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 1e-20f ? a / b : 0.0f;
}

// Drucker-Prager return map with a caller-supplied SVD (plasticity.py
// drucker_prager_update_with_svd_c), 2D or 3D. pp = [h0, h1, h2, h3,
// lambda, mu, only_when_failed, vol_corr]. Updates f, pdd, ph, lvg in place
// and s to the projected singular values (so (u, s, v) stays an SVD of the
// new f).
template <int D>
__device__ __forceinline__ void dp_update(const float pp[8], float phase, float f[D][D],
                                          const float u[D][D], float s[D],
                                          const float v[D][D], float& pdd, float& ph,
                                          float& lvg) {
  const float h0 = pp[0], h1 = pp[1], h2 = pp[2], h3 = pp[3];
  const float lam = pp[4], mu = pp[5], only_when_failed = pp[6], vol_corr = pp[7];
  const float d = (float)D;
  const float inv_d = 1.0f / d;
  float angle = h0 + (h1 * ph - h3) * expf(-h2 * ph);
  float sn = sinf(angle);
  float alpha = 0.8164965809277260f * (2.0f * sn) / (3.0f - sn);

  float strain[D], dev[D];
  for (int k = 0; k < D; ++k) strain[k] = logf(fmaxf(s[k], 1e-20f)) + lvg * inv_d;
  float trace = strain[0];
  for (int k = 1; k < D; ++k) trace = trace + strain[k];
  for (int k = 0; k < D; ++k) dev[k] = strain[k] - trace * inv_d;
  float dev_sq = dev[0] * dev[0], strain_sq = strain[0] * strain[0];
  for (int k = 1; k < D; ++k) {
    dev_sq = dev_sq + dev[k] * dev[k];
    strain_sq = strain_sq + strain[k] * strain[k];
  }
  float dev_norm = sqrtf(dev_sq);
  bool case_a = (dev_norm == 0.0f) || (trace > 0.0f);
  float dq_a = sqrtf(strain_sq);
  float gamma = dev_norm + (d * lam + 2.0f * mu) / (2.0f * mu) * trace * alpha;
  bool case_b = (!case_a) && (gamma <= 0.0f);
  float new_s[D];
  for (int k = 0; k < D; ++k)
    new_s[k] = case_a ? 1.0f : expf(strain[k] - gamma * safe_div(dev[k], dev_norm));
  float dq = case_a ? dq_a : gamma;
  bool applied = (!case_b) && ((only_when_failed == 0.0f) || (phase == 0.0f));

  float prev_det = s[0], new_det0 = new_s[0];
  for (int k = 1; k < D; ++k) {
    prev_det = prev_det * s[k];
    new_det0 = new_det0 * new_s[k];
  }
  float diff = new_det0 - prev_det;
  float new_det = diff > 0.0f ? new_det0 : prev_det + diff * vol_corr;
  if (applied) {
    pdd = pdd * safe_div(prev_det, new_det);
    lvg = lvg + (logf(fmaxf(prev_det, 1e-30f)) - logf(fmaxf(new_det, 1e-30f)));
    ph = ph + dq;
    for (int k = 0; k < D; ++k) s[k] = new_s[k];
    recompose<D>(u, s, v, f);
  }
}

// Rankine return map (plasticity.py rankine_update_c), 2D or 3D: caps the
// principal Hencky strains ln(s) at the softened tensile strength and
// accumulates the softening into ph. pp = [mu, lambda, tensile_strength,
// softening_rate]. The ascending order is a stable rank (ties keep the
// component order, so F = I keeps its components); in 2D the second-largest
// value aliases the smaller one (the reference's index list [0, 1, DIM-1]).
// Decomposes f itself; f is rebuilt only where the map projects.
template <int D>
__device__ __forceinline__ void rankine_update(const float pp[4], float f[D][D], float& ph) {
  const float mu = pp[0], lam = pp[1], tensile = pp[2], rate = pp[3];
  float u[D][D], s[D], v[D][D];
  svd(f, u, s, v);
  float eig[D], es[D];
  int rank[D];
  for (int k = 0; k < D; ++k) eig[k] = logf(fmaxf(s[k], 1e-20f));
  for (int i = 0; i < D; ++i) {
    int r = 0;
    for (int j = 0; j < D; ++j)
      if (j != i && (eig[j] < eig[i] || (eig[j] == eig[i] && j < i))) ++r;
    rank[i] = r;
  }
  for (int i = 0; i < D; ++i) es[rank[i]] = eig[i];
  float e_sum = eig[0];
  for (int k = 1; k < D; ++k) e_sum = e_sum + eig[k];
  const float e1 = es[D - 1], e2 = es[D - 2], e3 = es[0];
  const float soft = tensile - (ph - 1.0f);

  const bool case0 = lam * e_sum + 2.0f * mu * e1 <= soft;
  const bool cond1 = (2.0f * mu + lam) * e2 + lam * (e_sum - e1) <= soft;
  const float new_e1_c1 = (soft - lam * (e_sum - e1)) / (2.0f * mu + lam);
  const bool cond2 = D == 3 && (2.0f * mu + 3.0f * lam) * e3 <= soft;
  const float new_e12_c2 = (soft - lam * (e_sum - e1 - e2)) / (2.0f * mu + 2.0f * lam);
  const float new_e_c3 = soft / (2.0f * mu + 3.0f * lam);
  if (case0) {  // elastic: F kept, the hardening only capped
    ph = fminf(ph, tensile);
    return;
  }
  float es_new[D];
  for (int r = 0; r < D; ++r) {
    if (cond1)
      es_new[r] = r == D - 1 ? new_e1_c1 : es[r];
    else if (cond2)
      es_new[r] = r >= D - 2 ? new_e12_c2 : es[r];
    else
      es_new[r] = new_e_c3;
  }
  float delta_sq = 0.0f, ns[D];
  for (int i = 0; i < D; ++i) {
    const float e = es_new[rank[i]];
    const float de = eig[i] - e;
    delta_sq = i == 0 ? de * de : delta_sq + de * de;
    ns[i] = expf(e);
  }
  ph = fminf(ph + rate * sqrtf(delta_sq), tensile);
  recompose<D>(u, ns, v, f);
}

// Snow (plasticity.py snow_update_c), 2D or 3D: clamps the singular values
// to [1 - min_eps, 1 + max_eps], moves the clamped volume change into pdd,
// sets eh = exp(coeff (1 - pdd)) and rebuilds f from its SVD, clamped or
// not. pp = [min_epsilon, max_epsilon, hardening_coeff].
template <int D>
__device__ __forceinline__ void snow_update(const float pp[3], float f[D][D], float& eh,
                                            float& pdd) {
  float u[D][D], s[D], v[D][D], ns[D];
  svd(f, u, s, v);
  for (int k = 0; k < D; ++k) ns[k] = fminf(fmaxf(s[k], 1.0f - pp[0]), 1.0f + pp[1]);
  float prod_s = s[0], prod_new = ns[0];
  for (int k = 1; k < D; ++k) {
    prod_s = prod_s * s[k];
    prod_new = prod_new * ns[k];
  }
  pdd = pdd * safe_div(prod_s, prod_new);
  eh = expf(pp[2] * (1.0f - pdd));
  recompose<D>(u, ns, v, f);
}

// Kirchhoff stress of corotated linear elasticity from an SVD of f, 2D or
// 3D: 2 mu h (U (s-1)+ V^T F^T, U (s-1)- V^T F^T) plus the spherical part
// lam h (J-1) J on the side its sign selects, the positive part dropped
// when the particle is broken (phase 0) and split_on_failure is set.
template <int D>
__host__ __device__ inline void corotated_stress(float lam, float mu, float split_on_failure,
                                                 float phase, float hardening,
                                                 const float f[D][D], const float u[D][D],
                                                 const float s[D], const float v[D][D],
                                                 float out[D][D]) {
  float j = det(f);
  float pos[D], neg[D];
  for (int k = 0; k < D; ++k) {
    pos[k] = fmaxf(s[k] - 1.0f, 0.0f);
    neg[k] = fminf(s[k] - 1.0f, 0.0f);
  }
  float rp[D][D], rn[D][D];
  recompose<D>(u, pos, v, rp);
  recompose<D>(u, neg, v, rn);
  float coeff = 2.0f * mu * hardening;
  float spherical = lam * hardening * (j - 1.0f) * j;
  bool compressed = j < 1.0f;
  float sph_pos = compressed ? 0.0f : spherical;
  float sph_neg = compressed ? spherical : 0.0f;
  float phase_coeff = (split_on_failure != 0.0f && phase == 0.0f) ? 0.0f : 1.0f;
  for (int i = 0; i < D; ++i) {
    for (int jj = 0; jj < D; ++jj) {
      float pd = rp[i][0] * f[jj][0], nd = rn[i][0] * f[jj][0];
      for (int k = 1; k < D; ++k) {
        pd = pd + rp[i][k] * f[jj][k];
        nd = nd + rn[i][k] * f[jj][k];
      }
      pd = pd * coeff;
      nd = nd * coeff;
      if (i == jj) {
        pd = pd + sph_pos;
        nd = nd + sph_neg;
      }
      out[i][jj] = pd * phase_coeff + nd;
    }
  }
}

// Tensile energy from the singular values s of f, 2D or 3D.
template <int D>
__host__ __device__ inline float corotated_pos_energy(float lam, float mu, float hardening,
                                                      const float f[D][D], const float s[D]) {
  float j = det(f);
  float sq = 0.0f;
  for (int k = 0; k < D; ++k) {
    const float tk = fmaxf(s[k] - 1.0f, 0.0f);
    sq = sq + tk * tk;
  }
  float pos_dev = mu * hardening * sq;
  float jm = j - 1.0f;
  float spherical = lam * hardening / 2.0f * (jm * jm);
  return j < 1.0f ? pos_dev : pos_dev + spherical;
}

// Eigenvalues of a symmetric 3x3 (sym_eigvals3x3_c, the cardano backend):
// the trigonometric values of m scaled by its largest diagonal magnitude.
__host__ __device__ inline void sym_eigvals3(const float m[3][3], float l[3]) {
  const float scale =
      fmaxf(fmaxf(fmaxf(fabsf(m[0][0]), fabsf(m[1][1])), fabsf(m[2][2])), 1e-30f);
  const float inv = 1.0f / scale;
  cardano_trig_vals(m[0][0] * inv, m[0][1] * inv, m[0][2] * inv, m[1][1] * inv, m[1][2] * inv,
                    m[2][2] * inv, l);
  for (int k = 0; k < 3; ++k) l[k] = l[k] * scale;
}

// Maximum-stress failure: the eigenvalues of sym(stress) (closed form in
// 2D, sym_eigvals3 in 3D); failed where the largest exceeds max_principal or
// half their spread exceeds max_shear.
__host__ __device__ inline bool maximum_stress_failed(float max_principal, float max_shear,
                                                      const float st[2][2]) {
  const float a = 0.5f * (st[0][0] + st[0][0]);
  const float b = 0.5f * (st[0][1] + st[1][0]);
  const float c = 0.5f * (st[1][1] + st[1][1]);
  const float mean = 0.5f * (a + c);
  const float r = sqrtf(fmaxf(0.25f * ((a - c) * (a - c)) + b * b, 0.0f));
  const float e0 = mean - r, e1 = mean + r;
  const float emin = fminf(e0, e1), emax = fmaxf(e0, e1);
  return (emax > max_principal) || ((emax - emin) / 2.0f > max_shear);
}

__host__ __device__ inline bool maximum_stress_failed(float max_principal, float max_shear,
                                                      const float st[3][3]) {
  float sym[3][3], l[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) sym[i][j] = 0.5f * (st[i][j] + st[j][i]);
  sym_eigvals3(sym, l);
  const float emin = fminf(fminf(l[0], l[1]), l[2]);
  const float emax = fmaxf(fmaxf(l[0], l[1]), l[2]);
  return (emax > max_principal) || ((emax - emin) / 2.0f > max_shear);
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
__host__ __device__ inline float pow_pos(float x, float p) {
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

// Kirchhoff stress -p J I + 2 mu_visc J dev(sym(g)) of the EOS fluid, in D
// dimensions. The trace's 1/D is a product with the f32 reciprocal, as
// jitted XLA rounds the JAX package's tr / d (exact in 2D).
template <int D>
__device__ __forceinline__ void eos_stress(float p0, float gamma, float visc,
                                           float max_neg, float mass,
                                           float volume0, float density_fluid,
                                           float fluid_j, const float g[D][D],
                                           float out[D][D]) {
  float p = eos_pressure(p0, gamma, max_neg, mass, volume0, density_fluid);
  float sr[D][D];
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) sr[i][j] = 0.5f * (g[i][j] + g[j][i]);
  float tr = sr[0][0];
  for (int i = 1; i < D; ++i) tr = tr + sr[i][i];
  float sph = tr * (1.0f / (float)D);
  float vcoef = visc != 0.0f ? 2.0f * visc * fluid_j : 0.0f;
  float diag = -p * fluid_j;
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      float dev = i == j ? sr[i][j] + (-sph) : sr[i][j];
      out[i][j] = i == j ? dev * vcoef + diag : dev * vcoef;
    }
}

// EOS dt bound in D dimensions: the single-particle stability bound (+inf
// where its argument is not positive or J <= 0; k p D with k = 6 for
// quadratic splines) and the CFL bound, whose division by the density
// fluctuation 0.1 is the product with f32(1 / 0.1f) = 10, as under jit.
template <int D>
__device__ __forceinline__ float eos_timestep_bound(float p0, float gamma,
                                                    float max_neg,
                                                    float fluid_j, float mass,
                                                    float volume0,
                                                    float density_fluid,
                                                    float vsq, float h) {
  float density0 = mass / volume0;
  float p = -eos_pressure(p0, gamma, max_neg, mass, volume0, density_fluid);
  float arg = safe_div(density0 * (fluid_j - 1.0f), 6.0f * p * (float)D);
  float safe_j = fluid_j > 0.0f ? fluid_j : 1.0f;
  float single = (h / safe_j) * sqrtf(fmaxf(arg, 0.0f));
  if (!(arg > 0.0f && fluid_j > 0.0f)) single = INFINITY;
  float c_sq = fmaxf(vsq, 1.0f) * (1.0f / 0.1f);
  float cfl = h * (1.0f / sqrtf(c_sq));  // h / sqrt as jitted XLA forms it: h rsqrt
  return fminf(single, cfl);
}

// Neo-Hookean phase coefficient (1 - r) c^2 + r, r = 0.001.
__host__ __device__ inline float neo_hookean_phase_coeff(float phase) {
  return 0.999f * phase * phase + 0.001f;
}

// Kirchhoff stress of neo-Hookean elasticity, 2D or 3D: mu h J^(-2/D)
// dev(F F^T) + K/2 (J^2 - 1) I with K = (2/3 mu + lam) h; the deviatoric
// part, and the volumetric one where J >= 1, scaled by the phase
// coefficient. J^(-2/D) = 1 where J <= 0.
template <int D>
__host__ __device__ inline void neo_hookean_stress(float lam, float mu, float phase,
                                                   float hardening, const float f[D][D],
                                                   float out[D][D]) {
  const float pc = neo_hookean_phase_coeff(phase);
  const float j = det(f);
  const float k = (2.0f / 3.0f) * mu * hardening + lam * hardening;
  const float jpow = j > 0.0f ? pow_pos(j, -2.0f / (float)D) : 1.0f;
  float cg[D][D];
  for (int i = 0; i < D; ++i)
    for (int jj = 0; jj < D; ++jj) {
      float acc = f[i][0] * f[jj][0];
      for (int c = 1; c < D; ++c) acc = acc + f[i][c] * f[jj][c];
      cg[i][jj] = acc;
    }
  float tr = cg[0][0];
  for (int i = 1; i < D; ++i) tr = tr + cg[i][i];
  // The diagonal (F F^T)_ii - tr f32(1/d) as one FMA, as jitted XLA
  // contracts the JAX package's deviatoric_c.
  const float neg_inv_d = -(1.0f / (float)D);
  const float coeff = mu * hardening * jpow;
  const float vol = k / 2.0f * fmaf(j, j, -1.0f);
  const bool expanded = j >= 1.0f;
  for (int i = 0; i < D; ++i)
    for (int jj = 0; jj < D; ++jj) {
      const float dev = (i == jj ? fmaf(tr, neg_inv_d, cg[i][jj]) : cg[i][jj]) * coeff;
      const float pos = i == jj ? dev + (expanded ? vol : 0.0f) : dev;
      const float o = pos * pc;
      out[i][jj] = i == jj ? o + (expanded ? 0.0f : vol) : o;
    }
}

// Tensile energy of neo-Hookean elasticity, 2D or 3D: h mu/2 (tr(F F^T)
// J^(-2/D) - D) times the phase coefficient where J < 1; where J >= 1 with
// K/2 ((J^2 - 1)/2 - ln J) added and times the phase itself (the
// reference's quirk). tr(F F^T) per row as fma(F_i0, F_i0, F_i1^2) then
// fma(F_i2, F_i2, .), the rows summed in order.
template <int D>
__host__ __device__ inline float neo_hookean_pos_energy(float lam, float mu, float phase,
                                                        float hardening, const float f[D][D]) {
  const float pc = neo_hookean_phase_coeff(phase);
  const float j = det(f);
  const float k = (2.0f / 3.0f) * mu * hardening + lam * hardening;
  float fr = 0.0f;
  for (int i = 0; i < D; ++i) {
    float r = fmaf(f[i][0], f[i][0], f[i][1] * f[i][1]);
    for (int c = 2; c < D; ++c) r = fmaf(f[i][c], f[i][c], r);
    fr = i == 0 ? r : fr + r;
  }
  const float jpow = j > 0.0f ? pow_pos(j, -2.0f / (float)D) : 1.0f;
  const float dev = hardening * mu / 2.0f * fmaf(fr, jpow, -(float)D);
  const float safe_j = j > 0.0f ? j : 1.0f;
  const float vol = k / 2.0f * (fmaf(j, j, -1.0f) / 2.0f - logf(safe_j));
  return j < 1.0f ? dev * pc : (dev + vol) * phase;
}

// NACC case codes (plasticity.py nacc_project_c).
constexpr int NACC_TIP_MAX = 0, NACC_TIP_MIN = 1, NACC_INSIDE = 2, NACC_PROJECT = 3;

// NACC return map (plasticity.py nacc_project_c), 2D or 3D, on its own SVD
// of f: the trial pressure p_tr = -kappa/2 (J - 1/J) J and deviatoric
// stress s_tr = mu J^(-2/D) (s_k^2 - tr/D) of the elastic J and singular
// values; p0 = kappa (1e-5 + sinh(xi max(-alpha, 0))). Case A (p_tr > p0)
// and B (p_tr < -beta p0) put every singular value at the tip's J^(1/D);
// C (the yield function y < 1e-4) keeps F; D projects onto the yield
// surface along the line to its centre (p_c, 0). With hardening alpha
// gains ln(J / J_new) (in D only where p0 > 1e-4, p_tr inside the tips by
// 1e-4 and the projected J > 1e-4). pp = [mu, kappa, hardening_enabled,
// xi, beta, M]. Each lane computes only its case's branch, with the plain
// version's expressions; f is rebuilt except in case C. Returns the case.
template <int D>
__device__ __forceinline__ int nacc_update(const float pp[6], float f[D][D], float& alpha) {
  const float mu = pp[0], kappa = pp[1], xi = pp[3], beta = pp[4], m = pp[5];
  const bool hardening = pp[2] != 0.0f;
  const float d = (float)D;
  const float inv_d = 1.0f / d;  // x / d as jitted XLA rounds it
  float u[D][D], s[D], v[D][D];
  svd(f, u, s, v);
  float sq[D];
  float sq_trace = 0.0f;
  for (int k = 0; k < D; ++k) {
    sq[k] = s[k] * s[k];
    sq_trace = k == 0 ? sq[0] : sq_trace + sq[k];
  }
  const float sa = xi * fmaxf(-alpha, 0.0f);
  const float e = expf(sa);
  const float p0 = kappa * (1.0e-5f + 0.5f * (e - 1.0f / e));
  float j = s[0];
  for (int k = 1; k < D; ++k) j = j * s[k];
  const float safe_j = fmaxf(j, 1e-20f);
  const float s_tr_coeff = mu * pow_pos(safe_j, -2.0f / d);
  float s_tr[D];
  float s_tr_norm_sq = 0.0f;
  for (int k = 0; k < D; ++k) {
    s_tr[k] = s_tr_coeff * (sq[k] - sq_trace * inv_d);
    s_tr_norm_sq = k == 0 ? s_tr[0] * s_tr[0] : s_tr_norm_sq + s_tr[k] * s_tr[k];
  }
  const float psi_kappa = kappa / 2.0f * (j - 1.0f / safe_j);
  const float p_tr = -psi_kappa * j;
  const float y0 = (1.0f + 2.0f * beta) * ((6.0f - d) / 2.0f);
  const float y1 = m * m * (p_tr + beta * p0) * (p_tr - p0);
  const float y = y0 * s_tr_norm_sq + y1;

  int kase;
  float ns[D];
  if (p_tr > p0 || p_tr < -beta * p0) {  // A: the max tip; B: the min tip
    kase = p_tr > p0 ? NACC_TIP_MAX : NACC_TIP_MIN;
    const float jt = kase == NACC_TIP_MAX ? sqrtf(fmaxf(-2.0f * p0 / kappa + 1.0f, 0.0f))
                                          : sqrtf(2.0f * beta * p0 / kappa + 1.0f);
    const float st = pow_pos(fmaxf(jt, 1e-20f), 1.0f / d);
    for (int k = 0; k < D; ++k) ns[k] = st;
    if (hardening) alpha = alpha + logf(safe_j / fmaxf(jt, 1e-20f));
  } else if (y < 1.0e-4f) {  // C: inside
    return NACC_INSIDE;
  } else {  // D: the projection
    kase = NACC_PROJECT;
    const float p_c = (1.0f - beta) * p0 / 2.0f;
    const float q_tr = sqrtf((6.0f - d) / 2.0f) * sqrtf(s_tr_norm_sq);
    float dir0 = p_c - p_tr;
    float dir1 = 0.0f - q_tr;
    const float dir_norm = sqrtf(dir0 * dir0 + dir1 * dir1);
    dir0 = safe_div(dir0, dir_norm);
    dir1 = safe_div(dir1, dir_norm);
    const float c_q = m * m * (p_c + beta * p0) * (p_c - p0);
    const float b_q = m * m * dir0 * (2.0f * p_c - p0 + beta * p0);
    const float a_q = m * m * dir0 * dir0 + (1.0f + 2.0f * beta) * dir1 * dir1;
    const float discr = sqrtf(fmaxf(b_q * b_q - 4.0f * a_q * c_q, 0.0f));
    const float l1 = safe_div(-b_q + discr, 2.0f * a_q);
    const float l2 = safe_div(-b_q - discr, 2.0f * a_q);
    const float p1 = p_c + l1 * dir0;
    const float p2 = p_c + l2 * dir0;
    const float p_x = (p_tr - p_c) * (p1 - p_c) > 0.0f ? p1 : p2;
    const float j_e_x = sqrtf(fabsf(-2.0f * p_x / kappa + 1.0f));
    const bool do_hardening = hardening && (p0 > 1.0e-4f) && (p_tr < p0 - 1.0e-4f) &&
                              (p_tr > -beta * p0 + 1.0e-4f) && (j_e_x > 1.0e-4f);
    if (do_hardening) alpha = alpha + logf(safe_j / fmaxf(j_e_x, 1e-20f));
    const float s_tr_norm = sqrtf(s_tr_norm_sq);
    const float b_coeff = sqrtf(fmaxf(safe_div(-y1, y0), 0.0f)) * pow_pos(safe_j, 2.0f / d) /
                          fmaxf(mu, 1e-20f);
    for (int k = 0; k < D; ++k)
      ns[k] = sqrtf(fmaxf(b_coeff * safe_div(s_tr[k], s_tr_norm) + sq_trace * inv_d, 0.0f));
  }
  recompose<D>(u, ns, v, f);
  return kase;
}

}  // namespace sparkl
