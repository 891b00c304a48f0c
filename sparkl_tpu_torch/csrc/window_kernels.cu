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

#include "scatter_walk.cuh"

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
// One C-thread CTA per chunk, kernel A's lane-mask walk
// (csrc/scatter_walk.cuh). Each thread stores its slot's payload and, per
// axis, its 3 taps' weights and dpt-weighted weights at their window
// coordinates lb + k (rows of 6: lb is 0..3); the warps' ballots build the
// axis masks. The walk takes the lanes below nlive, one past the last slot
// with a nonzero payload (past it lies the chunk's zero padding, which adds
// only zeros): each cell's mask is the AND of its coordinates' axis masks
// and of that live mask. Each thread walks its cells' set lanes in
// ascending lane order (4 of 512 cells in 3D, 1 of 64 in 2D; the cells
// with a coordinate of 6 or 7 lie outside every stencil and stay zero),
// one sum per term of the TPU's contractions (base image, then the affine
// columns added in order j = 0, 1(, 2)). That is the order of a loop over
// the slots below nlive, so the image is run-to-run deterministic, and in
// 2D bit-equal to the plain version on the CPU, which sums in the same
// order. No atomics on floats. In 3D the cells go out sorted by hit count
// and the image is staged in shared memory (over the consumed slot arrays)
// and written coalesced: 1.65x faster than handing thread t cells t + k·C
// (0.2397 against 0.3955 ms at sparse sand3@1M, NVIDIA H100), and the walk
// is walk_chain's one loop. PSI is the psi channels' form, so that the form
// without them carries no psi registers or shared memory.
// Bound on this card: the walk's issue (27 hits a slot, ~20 shared loads
// and ~20 f32 operations each in 3D, a warp paying for its busiest lane);
// the slot read and the image write are coalesced.
// ---------------------------------------------------------------------------

template <int D, int C, bool PSI>
union P2GWinShared {
  static constexpr int SC = sparkl_walk::slot_cols<C>();
  static constexpr int NP0 = PSI ? D + 3 : D + 1;  // m, m*v (d)(, psi_mom, psi_m)
  struct {
    float w[D][6][SC];   // per axis and window coordinate: the 3 taps' weights
    float wd[D][6][SC];  // and w * dpt
    float p0[NP0][SC];
    float a[D * D][SC];  // affine, row-major
  } in;
  float out[NP0 * WinRows<D>::RC];  // the image, once the slot arrays are consumed (3D)
};

template <int D, int C, bool PSI>
__global__ void __launch_bounds__(C) p2g_windows_kernel(const float* __restrict__ slots,
                                                        float* __restrict__ out, GridArgs g) {
  using R = WinRows<D>;
  using Sh = P2GWinShared<D, C, PSI>;
  constexpr int RC = R::RC;
  constexpr int NF = Sh::NP0;    // image channels
  constexpr int NW = C / 32;
  constexpr int NPASS = RC / C;  // cells per thread
  constexpr bool SORT = NPASS > 1;
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;

  __shared__ Sh sh;
  __shared__ unsigned long long s_rng64[D * 8 * NW / 2];
  unsigned* s_rng = reinterpret_cast<unsigned*>(s_rng64);
  __shared__ unsigned s_nonzero[NW];  // per warp, the lanes with a nonzero payload
  __shared__ int s_bin[SORT ? C + 1 : 1];
  __shared__ unsigned short s_list[SORT ? RC : 1];

  const float* S = slots + (size_t)chunk * R::NF_IN * C;
  const int ts = sparkl_walk::slot_col(t);
#define SROW(k) S[(k) * C + t]
  const float m = SROW(R::MASS);
  bool nonzero = m != 0.0f;
  sh.in.p0[0][ts] = m;
  for (int ax = 0; ax < D; ++ax) {
    const float mv = m * SROW(R::VEL + ax);
    sh.in.p0[1 + ax][ts] = mv;
    nonzero = nonzero || mv != 0.0f;
  }
  for (int e = 0; e < D * D; ++e) {
    const float a = SROW(R::AFF + e);
    sh.in.a[e][ts] = a;
    nonzero = nonzero || a != 0.0f;
  }
  if constexpr (PSI) {
    const float psi_mom = SROW(R::PSI_MOM), psi_m = SROW(R::PSI_M);
    sh.in.p0[D + 1][ts] = psi_mom;
    sh.in.p0[D + 2][ts] = psi_m;
    nonzero = nonzero || psi_mom != 0.0f || psi_m != 0.0f;
  }
  int lb[D];
  for (int ax = 0; ax < D; ++ax) {
    float w[3], wd[3];
    axis_taps(g, ax, SROW(ax), lb[ax], w, wd);
    for (int k = 0; k < 3; ++k) {
      sh.in.w[ax][lb[ax] + k][ts] = w[k];
      sh.in.wd[ax][lb[ax] + k][ts] = wd[k];
    }
  }
#undef SROW
  sparkl_walk::axis_masks<D, C>(true, lb, s_rng);
  {
    const unsigned b = __ballot_sync(0xffffffffu, nonzero);
    if ((t & 31) == 0) s_nonzero[t >> 5] = b;
  }
  if constexpr (SORT) sparkl_walk::clear_bins<C>(s_bin);
  __syncthreads();
  // The live mask: the lanes below nlive (the highest nonzero lane + 1).
  unsigned live[NW];
  {
    int nlive = 0;
    for (int h = 0; h < NW; ++h)
      if (s_nonzero[h] != 0u) nlive = 32 * h + 32 - __clz(s_nonzero[h]);
    for (int h = 0; h < NW; ++h) {
      const int n = min(max(nlive - 32 * h, 0), 32);
      live[h] = n == 32 ? ~0u : (1u << n) - 1u;
    }
  }
  // Cell q's coordinates, row-major (x-major) in both dimensions, and mask.
  auto cell_mask = [&](int q, int& x, int& y, int& z, unsigned mk[NW]) {
    x = D == 3 ? q >> 6 : q >> 3;
    y = D == 3 ? (q >> 3) & 7 : q & 7;
    z = q & 7;
    sparkl_walk::cell_mask<D, C>(s_rng, x, y, z, mk);
    for (int h = 0; h < NW; ++h) mk[h] &= live[h];
  };
  if constexpr (SORT) {
    int hits[NPASS];
    for (int k = 0; k < NPASS; ++k) {
      int x, y, z;
      unsigned mk[NW];
      cell_mask(t + k * C, x, y, z, mk);
      hits[k] = sparkl_walk::popcount<C>(mk);
    }
    sparkl_walk::sort_cells<C, NPASS>(hits, s_bin, s_list);
  }

  float* img = out + (size_t)chunk * NF * RC;
  float res[SORT ? NPASS : 1][NF];
  int cell[SORT ? NPASS : 1];
#pragma unroll
  for (int k = 0; k < NPASS; ++k) {
    const int q = SORT ? s_list[t + k * C] : t + k * C;
    int x, y, z;
    unsigned mk[NW];
    cell_mask(q, x, y, z, mk);
    float acc_m = 0.0f, acc_pm = 0.0f, acc_ps = 0.0f;
    float acc_b[D];
    float acc_j[D][D];
    for (int i = 0; i < D; ++i) {
      acc_b[i] = 0.0f;
      for (int j = 0; j < D; ++j) acc_j[i][j] = 0.0f;
    }
    auto hit = [&](int s) {
      if constexpr (D == 3) {
        const float wx = sh.in.w[0][x][s], wy = sh.in.w[1][y][s], wz = sh.in.w[2][z][s];
        const float wxy = wx * wy;
        const float w = wxy * wz;
        const float wdx = (sh.in.wd[0][x][s] * wy) * wz;
        const float wdy = (wx * sh.in.wd[1][y][s]) * wz;
        const float wdz = wxy * sh.in.wd[2][z][s];
        acc_m += sh.in.p0[0][s] * w;
        for (int i = 0; i < 3; ++i) {
          acc_b[i] += sh.in.p0[1 + i][s] * w;
          acc_j[i][0] += sh.in.a[i * 3 + 0][s] * wdx;
          acc_j[i][1] += sh.in.a[i * 3 + 1][s] * wdy;
          acc_j[i][2] += sh.in.a[i * 3 + 2][s] * wdz;
        }
        if constexpr (PSI) {
          acc_pm += sh.in.p0[4][s] * w;
          acc_ps += sh.in.p0[5][s] * w;
        }
      } else {
        const float wx = sh.in.w[0][x][s], wy = sh.in.w[1][y][s];
        const float w = wx * wy;
        const float wdx = sh.in.wd[0][x][s] * wy;
        const float wdy = wx * sh.in.wd[1][y][s];
        acc_m += sh.in.p0[0][s] * w;
        for (int i = 0; i < 2; ++i) {
          acc_b[i] += sh.in.p0[1 + i][s] * w;
          acc_j[i][0] += sh.in.a[i * 2 + 0][s] * wdx;
          acc_j[i][1] += sh.in.a[i * 2 + 1][s] * wdy;
        }
        if constexpr (PSI) {
          acc_pm += sh.in.p0[3][s] * w;
          acc_ps += sh.in.p0[4][s] * w;
        }
      }
    };
    if constexpr (D == 3) {
      unsigned long long mk64[C / 64];
      for (int w = 0; w < C / 64; ++w) mk64[w] = mk[2 * w] | (unsigned long long)mk[2 * w + 1] << 32;
      sparkl_walk::walk_chain<C>(mk64, hit);
    } else {
      sparkl_walk::walk<C>(mk, hit);
    }
    float v[NF];
    v[0] = acc_m;
    for (int i = 0; i < D; ++i) {
      float mom = acc_b[i];
      for (int j = 0; j < D; ++j) mom = mom + acc_j[i][j];
      v[1 + i] = mom;
    }
    if constexpr (PSI) {
      v[D + 1] = acc_pm;
      v[D + 2] = acc_ps;
    }
    if constexpr (SORT) {
      for (int f = 0; f < NF; ++f) res[k][f] = v[f];
      cell[k] = q;
    } else {
      for (int f = 0; f < NF; ++f) img[f * RC + q] = v[f];
    }
  }
  if constexpr (SORT) {
    __syncthreads();  // the slot arrays are consumed: the image takes their place
#pragma unroll
    for (int k = 0; k < NPASS; ++k)
      for (int f = 0; f < NF; ++f) sh.out[f * RC + cell[k]] = res[k][f];
    __syncthreads();
    for (int e = t; e < NF * RC; e += C) img[e] = sh.out[e];
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
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3 && with_psi)
    p2g_windows_kernel<3, 128, true><<<max_chunks, 128, 0, st>>>(slots, out, g);
  else if (dim == 3)
    p2g_windows_kernel<3, 128, false><<<max_chunks, 128, 0, st>>>(slots, out, g);
  else if (dim == 2 && with_psi)
    p2g_windows_kernel<2, 64, true><<<max_chunks, 64, 0, st>>>(slots, out, g);
  else if (dim == 2)
    p2g_windows_kernel<2, 64, false><<<max_chunks, 64, 0, st>>>(slots, out, g);
  else
    return (int)cudaErrorInvalidValue;
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
