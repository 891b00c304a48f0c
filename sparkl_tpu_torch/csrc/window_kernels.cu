// Hand-written Hopper (sm_90a) kernels of the block-sparse pipeline's two
// window transfers, each with a plain PyTorch version beside its wrapper in
// sparkl_tpu_torch/ops/transfer_kernels.py:
//
//   p2g_windows_kernel replaces sparkl_tpu/ops/transfer_kernels.py:
//                      p2g_windows_pallas (_p2g_kernel);
//   g2p_windows_kernel replaces sparkl_tpu/ops/transfer_kernels.py:
//                      g2p_windows_pallas (_g2p_kernel).
//
// Both are templates on the dimension and the chunk size, instantiated for
// (3, 128) and (2, 64); the launchers pick the instance. Layouts are the JAX
// package's (WinRows<D>): packed slot data f32 [D, NF_IN, C], in 3D NF_IN =
// 24 (rows: position 0-2, mass 3, velocity 4-6, affine 7-15 row-major,
// psi_mass 16, psi_momentum 17, zero padding), in 2D NF_IN = 16 (position
// 0-1, mass 2, velocity 3-4, affine 5-8, psi_mass 9, psi_momentum 10, zero
// padding); window images and windows in row-major region-cell order, q =
// x*64 + y*8 + z in 3D and q = x*8 + y in 2D. Padded slots hold zeros.
// Each launcher is a plain C function that enqueues on the given stream and
// returns cudaGetLastError() (cudaErrorInvalidValue for a dimension it has
// no instance for); the caller allocates every output.
//
// The TPU kernels build the dense [8^d, C] weight matrices W and the
// dpt-weighted W_j in VMEM and contract them on the MXU, so they sum every
// cell against every slot, almost all with zero weight. These kernels touch
// only the 3^d cells of each slot's stencil; the products are formed in the
// TPU's operand order ((wx*wy)*wz, ((wx*dptx)*wy)*wz, ... in 3D; wx*wy,
// (wx*dptx)*wy and wx*(wy*dpty) in 2D), so the two differ only in the order
// of the sums.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=false   (no fast math)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Packed slot rows (ops/transfer_kernels.packed_rows(D)) and region cells.
template <int D>
struct WinRows {
  static constexpr int NF_IN = D == 3 ? 24 : 16;
  static constexpr int RC = D == 3 ? 512 : 64;  // 8^D region cells
  static constexpr int MASS = D;
  static constexpr int VEL = D + 1;
  static constexpr int AFF = 2 * D + 1;
  static constexpr int PSI_M = AFF + D * D;
  static constexpr int PSI_MOM = PSI_M + 1;
};
static_assert(WinRows<3>::PSI_MOM == 17 && WinRows<2>::PSI_MOM == 10, "packed rows");

struct GridArgs {
  float origin[3];
  float h;
  float invd;  // 4 / h^2, rounded from double on the host
};

// One axis of a slot's stencil, as _axis_weights computes it: base cell
// round(x/h) - 1 (round half to even, like jnp.round; x/h the product with
// f32(1/h), as jitted XLA rounds the division by the cell width), the
// block-local base lb = base mod 4 with FLOOR semantics (the
// TPU's base - (base // 4) * 4; C++ % truncates, and a padded slot's zero
// position can give a negative base), the three weights, and the
// dpt-weighted weights w_k * ((lb + k) - (lb + fx)) * h.
__device__ __forceinline__ void axis_taps(const GridArgs& g, int ax, float pos, int& lb,
                                          float w[3], float wd[3]) {
  const float xg = (pos - g.origin[ax]) * (1.0f / g.h);
  const float bf = rintf(xg) - 1.0f;
  const int base = (int)bf;
  const float fx = xg - bf;
  lb = base & 3;  // floor mod 4 (two's complement)
  w[0] = 0.5f * ((1.5f - fx) * (1.5f - fx));
  w[1] = 0.75f - (fx - 1.0f) * (fx - 1.0f);
  w[2] = 0.5f * ((fx - 0.5f) * (fx - 0.5f));
  const float px = (float)lb + fx;
  for (int k = 0; k < 3; ++k) wd[k] = w[k] * (((float)(lb + k) - px) * g.h);
}

// ---------------------------------------------------------------------------
// P2G: slot data -> the chunk's 8^d window image [m, m*v (d), (psi_mom,
// psi_m)], momentum plus the affine columns through W_j.
//
// One C-thread CTA per chunk. Each thread stages its slot's stencil
// (block-local base, weights, dpt-weighted weights) and payload in shared
// memory; then each thread owns 8^d / C of the cells (4 of 512 in 3D, 1 of
// 64 in 2D) and sums every slot's contribution to them in ascending lane
// order, one sum per term of the TPU's contractions (base image, then the
// affine columns added in order j = 0, 1(, 2)). No atomics: the image is
// run-to-run deterministic, and in 2D bit-equal to the plain version on the
// CPU, which sums in the same order. Slots past the last one with a nonzero
// payload (the chunk's zero padding) add only zeros and are skipped, so an
// empty chunk writes zeros at once. Bound on this card: the owner loop, 8^d
// / C cells x the chunk's slots of shared-memory broadcasts and compares per
// thread, ~3^d/8^d of them hits; the slot read and the image write are
// coalesced.
// ---------------------------------------------------------------------------
template <int D, int C>
__global__ void __launch_bounds__(C) p2g_windows_kernel(const float* __restrict__ slots,
                                                        float* __restrict__ out,
                                                        int with_psi, GridArgs g) {
  using R = WinRows<D>;
  constexpr int RC = R::RC;
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  const int nf = with_psi ? D + 3 : D + 1;

  __shared__ int s_lb[D][C];
  __shared__ float s_w[D][3][C];   // per axis, per tap
  __shared__ float s_wd[D][3][C];  // per axis, per tap: w * dpt
  __shared__ float s_p0[D + 3][C]; // m, m*v, psi_mom, psi_m
  __shared__ float s_a[D * D][C];  // affine, row-major
  __shared__ int s_nlive;

  if (t == 0) s_nlive = 0;
  __syncthreads();

  const float* S = slots + (size_t)chunk * R::NF_IN * C;
#define SROW(k) S[(k) * C + t]
  const float m = SROW(R::MASS);
  bool nonzero = m != 0.0f;
  s_p0[0][t] = m;
  for (int ax = 0; ax < D; ++ax) {
    const float mv = m * SROW(R::VEL + ax);
    s_p0[1 + ax][t] = mv;
    nonzero = nonzero || mv != 0.0f;
  }
  for (int e = 0; e < D * D; ++e) {
    const float a = SROW(R::AFF + e);
    s_a[e][t] = a;
    nonzero = nonzero || a != 0.0f;
  }
  if (with_psi) {
    const float psi_mom = SROW(R::PSI_MOM), psi_m = SROW(R::PSI_M);
    s_p0[D + 1][t] = psi_mom;
    s_p0[D + 2][t] = psi_m;
    nonzero = nonzero || psi_mom != 0.0f || psi_m != 0.0f;
  }
  for (int ax = 0; ax < D; ++ax) {
    int lb;
    float w[3], wd[3];
    axis_taps(g, ax, SROW(ax), lb, w, wd);
    s_lb[ax][t] = lb;
    for (int k = 0; k < 3; ++k) {
      s_w[ax][k][t] = w[k];
      s_wd[ax][k][t] = wd[k];
    }
  }
#undef SROW
  if (nonzero) atomicMax(&s_nlive, t + 1);
  __syncthreads();
  const int nlive = s_nlive;

  float* img = out + (size_t)chunk * nf * RC;
  for (int k = 0; k < RC / C; ++k) {
    const int q = t + k * C;
    float acc_m = 0.0f, acc_pm = 0.0f, acc_ps = 0.0f;
    float acc_b[D];
    float acc_j[D][D];
    for (int i = 0; i < D; ++i) {
      acc_b[i] = 0.0f;
      for (int j = 0; j < D; ++j) acc_j[i][j] = 0.0f;
    }
    if constexpr (D == 3) {
      const int x = q >> 6, y = (q >> 3) & 7, z = q & 7;
      for (int s = 0; s < nlive; ++s) {
        const unsigned a = (unsigned)(x - s_lb[0][s]);
        const unsigned b = (unsigned)(y - s_lb[1][s]);
        const unsigned c = (unsigned)(z - s_lb[2][s]);
        if (a > 2u || b > 2u || c > 2u) continue;
        const float wx = s_w[0][a][s], wy = s_w[1][b][s], wz = s_w[2][c][s];
        const float wxy = wx * wy;
        const float w = wxy * wz;
        const float wdx = (s_wd[0][a][s] * wy) * wz;
        const float wdy = (wx * s_wd[1][b][s]) * wz;
        const float wdz = wxy * s_wd[2][c][s];
        acc_m += s_p0[0][s] * w;
        for (int i = 0; i < 3; ++i) {
          acc_b[i] += s_p0[1 + i][s] * w;
          acc_j[i][0] += s_a[i * 3 + 0][s] * wdx;
          acc_j[i][1] += s_a[i * 3 + 1][s] * wdy;
          acc_j[i][2] += s_a[i * 3 + 2][s] * wdz;
        }
        if (with_psi) {
          acc_pm += s_p0[4][s] * w;
          acc_ps += s_p0[5][s] * w;
        }
      }
    } else {
      const int x = q >> 3, y = q & 7;
      for (int s = 0; s < nlive; ++s) {
        const unsigned a = (unsigned)(x - s_lb[0][s]);
        const unsigned b = (unsigned)(y - s_lb[1][s]);
        if (a > 2u || b > 2u) continue;
        const float wx = s_w[0][a][s], wy = s_w[1][b][s];
        const float w = wx * wy;
        const float wdx = s_wd[0][a][s] * wy;
        const float wdy = wx * s_wd[1][b][s];
        acc_m += s_p0[0][s] * w;
        for (int i = 0; i < 2; ++i) {
          acc_b[i] += s_p0[1 + i][s] * w;
          acc_j[i][0] += s_a[i * 2 + 0][s] * wdx;
          acc_j[i][1] += s_a[i * 2 + 1][s] * wdy;
        }
        if (with_psi) {
          acc_pm += s_p0[3][s] * w;
          acc_ps += s_p0[4][s] * w;
        }
      }
    }
    img[q] = acc_m;
    for (int i = 0; i < D; ++i) {
      float mom = acc_b[i];
      for (int j = 0; j < D; ++j) mom = mom + acc_j[i][j];
      img[(1 + i) * RC + q] = mom;
    }
    if (with_psi) {
      img[(D + 1) * RC + q] = acc_pm;
      img[(D + 2) * RC + q] = acc_ps;
    }
  }
}

// ---------------------------------------------------------------------------
// G2P: per slot, v = sum W * win_v, grad column j = invd * sum W_j * win_v
// (rows i), and psi = sum W * win_psi, over the 3^d cells of the slot's
// stencil in ascending cell order. Output rows [vel (d), grad columns
// j-major (d*d), (psi)].
//
// One C-thread CTA per chunk, one thread per slot. The chunk's window (d or
// d + 1 channels x 8^d cells: 6-8 KB in 3D, 512-768 B in 2D) is staged in
// shared memory with coalesced reads; each thread then reads its 3^d cells
// from there. Padded slots compute a finite value from their zero position,
// which no caller reads (as on the TPU). Bound on this card: bytes (the
// window, d position rows and the output rows, each moved once).
// ---------------------------------------------------------------------------
template <int D, int C>
__global__ void __launch_bounds__(C) g2p_windows_kernel(const float* __restrict__ slots,
                                                        const float* __restrict__ windows,
                                                        float* __restrict__ out,
                                                        int with_psi, GridArgs g) {
  using R = WinRows<D>;
  constexpr int RC = R::RC;
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  const int n_win = with_psi ? D + 1 : D;
  const int nf_out = D + D * D + (with_psi ? 1 : 0);

  __shared__ float s_win[(D + 1) * RC];
  const float* W = windows + (size_t)chunk * n_win * RC;
  for (int e = t; e < n_win * RC; e += C) s_win[e] = W[e];

  const float* S = slots + (size_t)chunk * R::NF_IN * C;
  int lb[D];
  float w[D][3], wd[D][3];
  for (int ax = 0; ax < D; ++ax) axis_taps(g, ax, S[ax * C + t], lb[ax], w[ax], wd[ax]);
  __syncthreads();

  float vel[D];
  float grad[D][D];
  for (int i = 0; i < D; ++i) {
    vel[i] = 0.0f;
    for (int j = 0; j < D; ++j) grad[i][j] = 0.0f;
  }
  float psi = 0.0f;
  if constexpr (D == 3) {
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) {
        const float wxy = w[0][a] * w[1][b];
        const float wdx_y = wd[0][a] * w[1][b];
        const float wx_dy = w[0][a] * wd[1][b];
        for (int c = 0; c < 3; ++c) {
          const int q = (lb[0] + a) * 64 + (lb[1] + b) * 8 + (lb[2] + c);
          const float wz = w[2][c];
          const float wq = wxy * wz;
          const float wdx = wdx_y * wz;
          const float wdy = wx_dy * wz;
          const float wdz = wxy * wd[2][c];
          for (int i = 0; i < 3; ++i) {
            const float v = s_win[i * RC + q];
            vel[i] += v * wq;
            grad[i][0] += v * wdx;
            grad[i][1] += v * wdy;
            grad[i][2] += v * wdz;
          }
          if (with_psi) psi += s_win[3 * RC + q] * wq;
        }
      }
    }
  } else {
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) {
        const int q = (lb[0] + a) * 8 + (lb[1] + b);
        const float wq = w[0][a] * w[1][b];
        const float wdx = wd[0][a] * w[1][b];
        const float wdy = w[0][a] * wd[1][b];
        for (int i = 0; i < 2; ++i) {
          const float v = s_win[i * RC + q];
          vel[i] += v * wq;
          grad[i][0] += v * wdx;
          grad[i][1] += v * wdy;
        }
        if (with_psi) psi += s_win[2 * RC + q] * wq;
      }
    }
  }
  float* o = out + (size_t)chunk * nf_out * C + t;
  for (int i = 0; i < D; ++i) o[i * C] = vel[i];
  for (int j = 0; j < D; ++j)
    for (int i = 0; i < D; ++i) o[(D + j * D + i) * C] = g.invd * grad[i][j];
  if (with_psi) o[(D + D * D) * C] = psi;
}

GridArgs grid_args(float ox, float oy, float oz, float h, float invd) {
  GridArgs g;
  g.origin[0] = ox;
  g.origin[1] = oy;
  g.origin[2] = oz;
  g.h = h;
  g.invd = invd;
  return g;
}

}  // namespace

extern "C" {

int sparkl_p2g_windows(const float* slots, float* out, int max_chunks, int dim, int with_psi,
                       float ox, float oy, float oz, float h, float invd, void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd);
  if (dim == 3) {
    p2g_windows_kernel<3, 128><<<max_chunks, 128, 0, (cudaStream_t)stream>>>(slots, out,
                                                                            with_psi, g);
  } else if (dim == 2) {
    p2g_windows_kernel<2, 64><<<max_chunks, 64, 0, (cudaStream_t)stream>>>(slots, out,
                                                                          with_psi, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sparkl_g2p_windows(const float* slots, const float* windows, float* out,
                       int max_chunks, int dim, int with_psi, float ox, float oy, float oz,
                       float h, float invd, void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd);
  if (dim == 3) {
    g2p_windows_kernel<3, 128><<<max_chunks, 128, 0, (cudaStream_t)stream>>>(
        slots, windows, out, with_psi, g);
  } else if (dim == 2) {
    g2p_windows_kernel<2, 64><<<max_chunks, 64, 0, (cudaStream_t)stream>>>(
        slots, windows, out, with_psi, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
