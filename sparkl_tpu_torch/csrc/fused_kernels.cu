// Hand-written Hopper (sm_90a) kernels of the fused substep.
//
// Ten kernels, each with a plain PyTorch version beside its wrapper in
// sparkl_tpu_torch/fused/kernels.py:
//
//   p2g_fused_kernel  replaces sparkl_tpu/fused/kernels.py:p2g_fused
//                     (_p2g_kernel), "kernel A";
//   merge_blocks_kernel replaces sparkl_tpu/fused/kernels.py:merge_blocks_dma
//                     (_merge_dma_kernel);
//   merge_scatter_kernel replaces the XLA scatter-add of
//                     sparkl_tpu/sparse/transfer.py:_merge_scatter (glue, not
//                     a TPU kernel), deterministically;
//   g2p_fused_kernel  replaces sparkl_tpu/fused/kernels.py:g2p_fused
//                     (_g2p_kernel), "kernel B";
//   mass_p2g_kernel   replaces sparkl_tpu/fused/kernels.py:mass_p2g_fused
//                     (_mass_p2g_kernel), the fluid volume pass's images;
//   mass_g2p_kernel   replaces sparkl_tpu/fused/kernels.py:mass_g2p_fused
//                     (_mass_g2p_kernel), its per-slot grid-mass gather;
//   src_rows_kernel   replaces sparkl_tpu/fused/kernels.py:src_rows_from_order
//                     (_src_rows_kernel), resort source rows;
//   permute_slots_kernel replaces sparkl_tpu/fused/kernels.py:
//                     permute_chunks_dma (_permute_dma_kernel), resort permute;
//   eigen_pool_kernel replaces sparkl_tpu/fused/kernels.py:eigen_pool_fused
//                     (_eigen_pool_kernel), the eigenerosion pooling;
//   permute_chunks_kernel replaces sparkl_tpu/fused/kernels.py:permute_chunks
//                     (_permute_kernel), the older resort lane router, which
//                     no path of either package calls.
//
// Layouts are the JAX package's: slots f32 [D, NF, C] and ints i32 [D,
// NI=8, C] (row offsets of sparkl_tpu/fused/layout.py Rows(d), checked
// against the Python side by the CPU tests), in 3D NF = 56 and C = 128 with
// window images and windows in z-major region-cell order q = z*64 + x*8 +
// y, in 2D NF = 40 and C = 64 with row-major cells q = x*8 + y. Kernels A
// and B, the two mass kernels and the pooling are templates on the
// dimension and the chunk size, instantiated for (3, 128) and (2, 64); A
// also on its psi channels and B on its damage form (the stress cache off:
// damage and failure scenes), so that the scenes without damage keep their
// code. The launchers pick the instance. Each launcher is
// a plain C function that enqueues on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it has no instance
// for); the caller allocates every output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false   (never --use_fast_math: the physics
//        uses expf/logf/sinf and sqrtf-based Cardano eigenvalues)

#include <cuda_runtime.h>
#include <stdint.h>

#include "particle_physics.cuh"

namespace {

constexpr int NI = 8;     // i32 rows per slot
constexpr int NTAB_F = 16;
constexpr int NTAB_I = 4;

// Rows(3) offsets (sparkl_tpu/fused/layout.py).
constexpr int NF = 56;
constexpr int ROW_POS = 0;
constexpr int ROW_VEL = 3;
constexpr int ROW_GRAD = 6;
constexpr int ROW_DEFGRAD = 15;
constexpr int ROW_MASS = 24;
constexpr int ROW_VOL0 = 25;
constexpr int ROW_PHASE = 26;
constexpr int ROW_PSI_POS = 27;
constexpr int ROW_PDD = 28;
constexpr int ROW_PH = 29;
constexpr int ROW_EH = 30;
constexpr int ROW_LVG = 31;
constexpr int ROW_NACC = 32;
constexpr int ROW_KINVEL = 33;
constexpr int ROW_CPF = 36;
constexpr int ROW_CTHR = 37;
constexpr int ROW_DTB = 38;
constexpr int ROW_FAILED = 39;
constexpr int ROW_RADIUS0 = 40;
constexpr int ROW_PAR1 = 41;
constexpr int ROW_PAR2 = 42;
constexpr int ROW_MC = 43;
constexpr int ROW_G = 44;
constexpr int ROW_DEBUG = 45;
constexpr int ROW_CUMD = 46;
constexpr int ROW_STRESS = 47;

// Rows(2) offsets.
constexpr int NF2 = 40;
constexpr int ROW2_POS = 0;
constexpr int ROW2_VEL = 2;
constexpr int ROW2_GRAD = 4;
constexpr int ROW2_DEFGRAD = 8;
constexpr int ROW2_MASS = 12;
constexpr int ROW2_VOL0 = 13;
constexpr int ROW2_PHASE = 14;
constexpr int ROW2_PSI_POS = 15;
constexpr int ROW2_PDD = 16;
constexpr int ROW2_PH = 17;
constexpr int ROW2_EH = 18;
constexpr int ROW2_LVG = 19;
constexpr int ROW2_NACC = 20;
constexpr int ROW2_KINVEL = 21;
constexpr int ROW2_CPF = 23;
constexpr int ROW2_CTHR = 24;
constexpr int ROW2_DTB = 25;
constexpr int ROW2_FAILED = 26;
constexpr int ROW2_RADIUS0 = 27;
constexpr int ROW2_PAR1 = 28;
constexpr int ROW2_PAR2 = 29;
constexpr int ROW2_MC = 30;
constexpr int ROW2_G = 31;
constexpr int ROW2_DEBUG = 32;
constexpr int ROW2_CUMD = 33;
constexpr int ROW2_STRESS = 34;

// Rows(D) by layout.py's formula; the two tables above pin both instances.
template <int D>
struct Rows {
  static constexpr int S = 2 * D + 2 * D * D;
  static constexpr int POS = 0, VEL = D, GRAD = 2 * D, DEFGRAD = 2 * D + D * D;
  static constexpr int MASS = S, VOL0 = S + 1, PHASE = S + 2, PSI_POS = S + 3, PDD = S + 4,
                       PH = S + 5, EH = S + 6, LVG = S + 7, NACC = S + 8, KINVEL = S + 9;
  static constexpr int CPF = S + 9 + D, CTHR = S + 10 + D, DTB = S + 11 + D,
                       FAILED = S + 12 + D, RADIUS0 = S + 13 + D, PAR1 = S + 14 + D,
                       PAR2 = S + 15 + D, MC = S + 16 + D, G = S + 17 + D, DEBUG = S + 18 + D,
                       CUMD = S + 19 + D, STRESS = S + 20 + D;
  static constexpr int NSTRESS = D * (D + 1) / 2;
  static constexpr int NF = (STRESS + NSTRESS + 7) / 8 * 8;
};
#define SPARKL_ROWS_AGREE(R, P)                                                          \
  static_assert(R::POS == P##POS && R::VEL == P##VEL && R::GRAD == P##GRAD &&           \
                    R::DEFGRAD == P##DEFGRAD && R::MASS == P##MASS && R::VOL0 == P##VOL0 && \
                    R::PHASE == P##PHASE && R::PSI_POS == P##PSI_POS && R::PDD == P##PDD && \
                    R::PH == P##PH && R::EH == P##EH && R::LVG == P##LVG &&              \
                    R::NACC == P##NACC && R::KINVEL == P##KINVEL && R::CPF == P##CPF &&  \
                    R::CTHR == P##CTHR && R::DTB == P##DTB && R::FAILED == P##FAILED &&  \
                    R::RADIUS0 == P##RADIUS0 && R::PAR1 == P##PAR1 &&                    \
                    R::PAR2 == P##PAR2 && R::MC == P##MC && R::G == P##G &&              \
                    R::DEBUG == P##DEBUG && R::CUMD == P##CUMD && R::STRESS == P##STRESS, \
                #R " differs from the row table")
SPARKL_ROWS_AGREE(Rows<3>, ROW_);
SPARKL_ROWS_AGREE(Rows<2>, ROW2_);
static_assert(Rows<3>::NF == NF && Rows<2>::NF == NF2, "row counts");
#undef SPARKL_ROWS_AGREE

constexpr int I_MODEL = 0;
constexpr int I_FLAGS = 1;
constexpr int I_ORIGIN = 4;
constexpr int FLAG_ACTIVE = 1;
constexpr int FLAG_STATIC = 2;
constexpr int FLAG_KINEMATIC = 4;

constexpr int COROTATED = 0;
constexpr int EOS_MONAGHAN_SPH = 2;
constexpr int DRUCKER_PRAGER = 1;
constexpr int RANKINE = 3;
constexpr int SNOW = 4;
constexpr int MAXIMUM_STRESS = 1;
constexpr int TAB_F = 12;  // failure parameter columns of the model table
constexpr float BIGF = 3.4028234663852886e38f;

// Kernel option bits the launchers pass.
constexpr int OPT_PSI = 1;           // kernel A: the psi channels
constexpr int OPT_STRESS_CACHE = 2;  // A reads the stress rows, B writes them
constexpr int OPT_CLAMP = 1;         // kernel B: the GPU velocity clamp
constexpr int OPT_SVD_REUSE = 4;     // kernel B: one SVD for DP, energy and stress
constexpr int OPT_MODIFIED = 8;      // kernel B: the modified-eigenerosion trip

// 8^d window cells.
template <int D>
__host__ __device__ constexpr int region_cells() {
  return D == 3 ? 512 : 64;
}

struct GridArgs {
  float origin[3];
  float h;
  float invd;     // 4 / h^2, rounded from double on the host
  float d_coeff;  // h^2 / 4, rounded from double on the host
  int res[3];
};

// Base cell round(x/h) - 1 (round half to even, like jnp.round) and the
// offset fx; in_bounds = the 3-node stencil lies inside the grid. x/h is the
// product with f32(1/h), as jitted XLA rounds the JAX package's division by
// the cell width.
template <int D>
__device__ __forceinline__ void base_fx(const GridArgs& g, const float pos[D], int base[D],
                                        float fx[D], bool& in_bounds) {
  in_bounds = true;
  const float inv_h = 1.0f / g.h;
  for (int ax = 0; ax < D; ++ax) {
    float xg = (pos[ax] - g.origin[ax]) * inv_h;
    float bf = rintf(xg) - 1.0f;
    base[ax] = (int)bf;
    fx[ax] = xg - bf;
    in_bounds = in_bounds && (bf >= 0.0f) && (bf + 2.0f <= (float)(g.res[ax] - 1));
  }
}

// The slot's window-relative base cell and transfer mask (active, in its
// chunk's window, stencil in the grid).
template <int D, int C>
__device__ __forceinline__ bool slot_transfer(const GridArgs& g, const float* S, const int* I,
                                              int t, int rel[D], float fx[D]) {
  float pos[D];
  for (int ax = 0; ax < D; ++ax) pos[ax] = S[(Rows<D>::POS + ax) * C + t];
  int base[D];
  bool in_bounds;
  base_fx<D>(g, pos, base, fx, in_bounds);
  bool in_window = true;
  for (int ax = 0; ax < D; ++ax) {
    rel[ax] = base[ax] - I[(I_ORIGIN + ax) * C + t];
    in_window = in_window && rel[ax] >= 0 && rel[ax] <= 5;
  }
  return ((I[I_FLAGS * C + t] & FLAG_ACTIVE) != 0) && in_window && in_bounds;
}

__device__ __forceinline__ void quadratic_weights(float f, float w[3]) {
  w[0] = 0.5f * ((1.5f - f) * (1.5f - f));
  w[1] = 0.75f - (f - 1.0f) * (f - 1.0f);
  w[2] = 0.5f * ((f - 0.5f) * (f - 0.5f));
}

// ---------------------------------------------------------------------------
// Kernel A: Kirchhoff stress + APIC affine + quadratic weights -> the
// chunk's 8^d window image: mass, momentum d, and with the psi option the
// psi momentum m·psi_pos and psi mass m of the slots that carry a crack
// (unbroken, not failed; sparkl_tpu/fused/kernels.py:466-470).
//
// The stress: with the stress-cache option, the cached rows (symmetric
// upper triangle, written by kernel B), except for EOS slots, whose stress
// comes fresh from J = F00, the mass, vol0 and the carried velocity
// gradient (kernel B leaves their rows zero); without it (damage
// and failure scenes, whose phase changes between the kernels), fresh from
// F: corotated through the SVD (2x2 closed form in 2D), with the phase
// split for broken particles. Failed debris contributes no stress. The JAX
// kernel folds the model test statically for single-type model sets; this
// one branches per slot on the model's type, so mixed sets take the same
// values.
//
// One C-thread CTA per chunk. Each thread prepares its slot's weights, tap
// offsets and payload in shared memory; then each thread owns 8^d / C of
// the window cells (4 in 3D, 1 in 2D) and sums every slot's contribution to
// them in ascending lane order. No atomics, so the image is run-to-run
// deterministic, like the JAX path. Cell order: z-major in 3D (rows (f, z),
// lanes xy), row-major in 2D (rows (f, x), lanes y), the JAX kernel's.
// Bound on this card: the owner loop is C slots x 8^d/C cells of
// shared-memory broadcasts and compares per thread (~65k per CTA in 3D, 4k
// in 2D), almost all of them misses of the 3^d footprint; the slot read is
// coalesced. A faster design scatters each slot's taps (shared-memory
// atomics, losing determinism) or sorts slots by cell first.
// ---------------------------------------------------------------------------
template <int DIM, int C, bool PSI>
__global__ void __launch_bounds__(C) p2g_fused_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ nchunks, const float* __restrict__ tab_f,
    const int* __restrict__ tab_i, int m_count, float* __restrict__ out, float dt,
    GridArgs g, int opts) {
  using R = Rows<DIM>;
  constexpr int RC = region_cells<DIM>();
  constexpr int NCH = 1 + DIM + (PSI ? 2 : 0);  // image channels
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  float* img = out + (size_t)chunk * NCH * RC;
  if (chunk >= *nchunks) {
    for (int e = t; e < NCH * RC; e += C) img[e] = 0.0f;
    return;
  }

  __shared__ int s_rel[DIM][C];
  __shared__ float s_w[DIM][3][C];    // per axis, per tap
  __shared__ float s_d[DIM][3][C];    // dpt = (tap cell - px) * h
  __shared__ float s_p0[NCH][C];      // m, m*v (, psi momentum, psi mass)
  __shared__ float s_a[DIM * DIM][C];  // contrib * affine, row-major

  const float* S = slots + (size_t)chunk * R::NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
#define SROW(k) S[(k) * C + t]
  int rel[DIM];
  float fx[DIM];
  const bool contrib = slot_transfer<DIM, C>(g, S, I, t, rel, fx);
  const float cf = contrib ? 1.0f : 0.0f;
  const bool failed = SROW(R::FAILED) != 0.0f;
  const float mass = SROW(R::MASS);
  const float vol0 = SROW(R::VOL0);
  const float phase = SROW(R::PHASE);
  float gv[DIM][DIM];
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) gv[i][j] = SROW(R::GRAD + i * DIM + j);

  float stress[DIM][DIM];
  const int mid = I[I_MODEL * C + t];
  const bool mid_ok = mid >= 0 && mid < m_count;
  const int ctype = mid_ok ? tab_i[mid * NTAB_I] : 0;
  const float* p = tab_f + (mid_ok ? mid : 0) * NTAB_F;
  if (mid_ok && ctype == EOS_MONAGHAN_SPH) {
    const float fj = SROW(R::DEFGRAD);
    const float density = (mass / fmaxf(vol0, 1e-30f)) / fmaxf(fj, 1e-20f);
    sparkl::eos_stress<DIM>(p[0], p[1], p[2], p[3], mass, vol0, density, fj, gv, stress);
  } else if (opts & OPT_STRESS_CACHE) {
    float st[R::NSTRESS];
    for (int k = 0; k < R::NSTRESS; ++k) st[k] = SROW(R::STRESS + k);
    for (int i = 0, k = 0; i < DIM; ++i)
      for (int j = i; j < DIM; ++j, ++k) stress[i][j] = stress[j][i] = st[k];
  } else {
    // Fresh stress from F (m_count > 0: the launcher passes the tables).
    for (int i = 0; i < DIM; ++i)
      for (int j = 0; j < DIM; ++j) stress[i][j] = 0.0f;
    if (ctype == COROTATED) {
      float f[DIM][DIM], u[DIM][DIM], sv[DIM], v[DIM][DIM];
      for (int i = 0; i < DIM; ++i)
        for (int j = 0; j < DIM; ++j) f[i][j] = SROW(R::DEFGRAD + i * DIM + j);
      sparkl::svd(f, u, sv, v);
      sparkl::corotated_stress<DIM>(mid_ok ? p[0] : 0.0f, mid_ok ? p[1] : 0.0f,
                                    mid_ok ? p[3] : 0.0f, phase, SROW(R::EH), f, u, sv, v,
                                    stress);
    }
  }
  const float coeff = vol0 * g.invd * dt;
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) {
      float aff = mass * gv[i][j] - (failed ? 0.0f : coeff * stress[i][j]);
      s_a[i * DIM + j][t] = contrib ? aff : 0.0f;  // an empty EOS lane's stress is NaN
    }
  const float m_c = mass * cf;
  s_p0[0][t] = m_c;
  for (int ax = 0; ax < DIM; ++ax) s_p0[1 + ax][t] = m_c * SROW(R::VEL + ax);
  if constexpr (PSI) {
    const bool cracks = phase > 0.0f && SROW(R::CPF) != 0.0f && !failed;
    const float psi_mass = cracks ? mass : 0.0f;
    s_p0[DIM + 1][t] = psi_mass * SROW(R::PSI_POS) * cf;
    s_p0[DIM + 2][t] = psi_mass * cf;
  }
  for (int ax = 0; ax < DIM; ++ax) {
    const float f = fx[ax];
    const float px = (float)rel[ax] + f;
    float w[3];
    quadratic_weights(f, w);
    for (int k = 0; k < 3; ++k) {
      s_w[ax][k][t] = w[k];
      s_d[ax][k][t] = ((float)(rel[ax] + k) - px) * g.h;
    }
    // Non-contributing slots never match a cell (their payload is zero).
    s_rel[ax][t] = contrib ? rel[ax] : -1000;
  }
#undef SROW
  __syncthreads();

  for (int k = 0; k < RC / C; ++k) {
    const int q = t + k * C;
    float acc[NCH];
    for (int f = 0; f < NCH; ++f) acc[f] = 0.0f;
    if constexpr (DIM == 3) {
      const int z = q >> 6, x = (q >> 3) & 7, y = q & 7;
      for (int s = 0; s < C; ++s) {
        const unsigned a = (unsigned)(x - s_rel[0][s]);
        const unsigned b = (unsigned)(y - s_rel[1][s]);
        const unsigned c = (unsigned)(z - s_rel[2][s]);
        if (a > 2u || b > 2u || c > 2u) continue;
        const float wx = s_w[0][a][s], wy = s_w[1][b][s], wz = s_w[2][c][s];
        const float dx = s_d[0][a][s], dy = s_d[1][b][s], dz = s_d[2][c][s];
        const float wxy = wx * wy;
        const float wdx_y = (wx * dx) * wy;
        const float wx_dy = wx * (wy * dy);
        const float wdz = wz * dz;
        acc[0] += (s_p0[0][s] * wz) * wxy;
        for (int i = 0; i < 3; ++i) {
          acc[1 + i] += (s_p0[1 + i][s] * wz) * wxy + (s_a[i * 3 + 2][s] * wdz) * wxy +
                        (s_a[i * 3 + 0][s] * wz) * wdx_y + (s_a[i * 3 + 1][s] * wz) * wx_dy;
        }
        for (int f = 4; f < NCH; ++f) acc[f] += (s_p0[f][s] * wz) * wxy;
      }
    } else {
      const int x = q >> 3, y = q & 7;
      for (int s = 0; s < C; ++s) {
        const unsigned a = (unsigned)(x - s_rel[0][s]);
        const unsigned b = (unsigned)(y - s_rel[1][s]);
        if (a > 2u || b > 2u) continue;
        const float wx = s_w[0][a][s], wy = s_w[1][b][s];
        const float wdx = wx * s_d[0][a][s], wdy = wy * s_d[1][b][s];
        acc[0] += (s_p0[0][s] * wx) * wy;
        // The affine x column rides the x taps, the y column the y taps,
        // as the JAX kernel's 2D contraction takes them.
        for (int i = 0; i < 2; ++i)
          acc[1 + i] += (s_p0[1 + i][s] * wx + s_a[i * 2 + 0][s] * wdx) * wy +
                        (s_a[i * 2 + 1][s] * wx) * wdy;
        for (int f = 3; f < NCH; ++f) acc[f] += (s_p0[f][s] * wx) * wy;
      }
    }
    for (int f = 0; f < NCH; ++f) img[f * RC + q] = acc[f];
  }
}

// ---------------------------------------------------------------------------
// Merge: per owner block, the sum of its <= kmax contiguous chunk rows in
// ascending chunk order (bit-equal to merge_blocks_dma and to the plain
// version). One CTA per block, each thread a strided set of the row's
// elements; any row width (3D: 8 corners x nf·64, 2D: 4 corners x nf·16).
// Bound on this card: bytes (each block reads its chunk rows once,
// coalesced, and writes one row).
// ---------------------------------------------------------------------------
__global__ void merge_blocks_kernel(const float* __restrict__ rows,
                                    const int* __restrict__ first,
                                    const int* __restrict__ nch,
                                    float* __restrict__ out, int width,
                                    int kmax) {
  const int b = blockIdx.x;
  const int f0 = first[b];
  const int n = min(nch[b], kmax);
  const float* src = rows + (size_t)f0 * width;
  float* dst = out + (size_t)b * width;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc += src[(size_t)k * width + e];
    dst[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// Scatter merge: node-table row g = the sum of its updates rows[order[k]],
// k in [starts[g], starts[g + 1]), in ascending k from zero. `order` holds
// the flat (chunk, corner) update ids stably sorted by destination, so each
// row sums in ascending update order: the JAX package's CPU scatter-add
// order, bit-equal to it and to the plain version, and the same from run
// to run (a float-atomic scatter is not). One CTA per node-table row, each
// thread a strided set of the row's elements. Bound on this card: bytes
// (every update row read once, coalesced; each node row written once).
// ---------------------------------------------------------------------------
__global__ void merge_scatter_kernel(const float* __restrict__ rows,
                                     const int* __restrict__ order,
                                     const int* __restrict__ starts,
                                     float* __restrict__ out, int width) {
  const int row = blockIdx.x;
  const int k0 = starts[row], k1 = starts[row + 1];
  float* dst = out + (size_t)row * width;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float acc = 0.0f;
    for (int k = k0; k < k1; ++k) acc += rows[(size_t)order[k] * width + e];
    dst[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// Mass P2G (fluid volume pass): the chunk's 8^d mass image, kernel A's
// design with one channel, a template on the dimension and chunk size like
// A. Each thread prepares its slot's weights and m·contrib in shared
// memory; then each thread owns 8^d / C of the window cells (4 of 512 in
// 3D, 1 of 64 in 2D) and sums every slot whose stencil holds the cell, in
// ascending lane order: no atomics, so the image is deterministic. The
// product per slot is the JAX kernel's factorization: (m wz)(wx wy) in 3D
// (z-major cells), (m wx) wy in 2D (row-major cells, q = x*8 + y). Dead
// chunks write zeros. Bound on this card: like kernel A, the owner loop's
// shared-memory compares (C slots per cell); the slot read is d + 1 rows
// and d + 2 int rows of 4C B.
// ---------------------------------------------------------------------------
template <int D, int C>
__global__ void __launch_bounds__(C) mass_p2g_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ nchunks, float* __restrict__ out, GridArgs g) {
  using R = Rows<D>;
  constexpr int RC = region_cells<D>();
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  float* img = out + (size_t)chunk * RC;
  if (chunk >= *nchunks) {
    for (int e = t; e < RC; e += C) img[e] = 0.0f;
    return;
  }
  __shared__ int s_rel[D][C];
  __shared__ float s_w[D][3][C];
  __shared__ float s_m[C];

  const float* S = slots + (size_t)chunk * R::NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
  int rel[D];
  float fx[D];
  const bool contrib = slot_transfer<D, C>(g, S, I, t, rel, fx);
  s_m[t] = S[R::MASS * C + t] * (contrib ? 1.0f : 0.0f);
  for (int ax = 0; ax < D; ++ax) {
    float w[3];
    quadratic_weights(fx[ax], w);
    for (int k = 0; k < 3; ++k) s_w[ax][k][t] = w[k];
    s_rel[ax][t] = contrib ? rel[ax] : -1000;
  }
  __syncthreads();

  for (int k = 0; k < RC / C; ++k) {
    const int q = t + k * C;
    float acc = 0.0f;
    if constexpr (D == 3) {
      const int z = q >> 6, x = (q >> 3) & 7, y = q & 7;
      for (int s = 0; s < C; ++s) {
        const unsigned a = (unsigned)(x - s_rel[0][s]);
        const unsigned b = (unsigned)(y - s_rel[1][s]);
        const unsigned c = (unsigned)(z - s_rel[2][s]);
        if (a > 2u || b > 2u || c > 2u) continue;
        acc += (s_m[s] * s_w[2][c][s]) * (s_w[0][a][s] * s_w[1][b][s]);
      }
    } else {
      const int x = q >> 3, y = q & 7;
      for (int s = 0; s < C; ++s) {
        const unsigned a = (unsigned)(x - s_rel[0][s]);
        const unsigned b = (unsigned)(y - s_rel[1][s]);
        if (a > 2u || b > 2u) continue;
        acc += (s_m[s] * s_w[0][a][s]) * s_w[1][b][s];
      }
    }
    img[q] = acc;
  }
}

// ---------------------------------------------------------------------------
// Mass G2P (fluid volume pass): each slot's sum of w·m over its 3^d cells
// of the chunk's mass window, masked by the transfer mask. One C-thread CTA
// per chunk: the window (2 KB in 3D, 256 B in 2D) goes to shared memory and
// each thread gathers its own slot in the JAX kernel's contraction order:
// in 3D per z tap the xy sheet first, then the z weight; in 2D per x tap
// the y taps first, then the x weight (as kernel B gathers). Dead chunks
// write zeros. Bound on this card: bytes (d + 1 slot rows and d + 2 int rows
// read, the window read and one row written per chunk) and the launch.
// ---------------------------------------------------------------------------
template <int D, int C>
__global__ void __launch_bounds__(C) mass_g2p_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const float* __restrict__ windows, const int* __restrict__ nchunks,
    float* __restrict__ out, GridArgs g) {
  using R = Rows<D>;
  constexpr int RC = region_cells<D>();
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  if (chunk >= *nchunks) {
    out[(size_t)chunk * C + t] = 0.0f;
    return;
  }
  __shared__ float win[RC];
  const float* W = windows + (size_t)chunk * RC;
  for (int e = t; e < RC; e += C) win[e] = W[e];
  __syncthreads();

  const float* S = slots + (size_t)chunk * R::NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
  int rel[D];
  float fx[D];
  float m = 0.0f;
  if (slot_transfer<D, C>(g, S, I, t, rel, fx)) {
    float w[D][3];
    for (int ax = 0; ax < D; ++ax) quadratic_weights(fx[ax], w[ax]);
    if constexpr (D == 3) {
      for (int c = 0; c < 3; ++c) {
        float tv = 0.0f;
        const int zq = (rel[2] + c) * 64;
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b)
            tv += win[zq + (rel[0] + a) * 8 + (rel[1] + b)] * (w[0][a] * w[1][b]);
        m += tv * w[2][c];
      }
    } else {
      for (int a = 0; a < 3; ++a) {
        float tv = 0.0f;
        const int xq = (rel[0] + a) * 8 + rel[1];
        for (int b = 0; b < 3; ++b) tv += win[xq + b] * w[1][b];
        m += tv * w[0][a];
      }
    }
  }
  out[(size_t)chunk * C + t] = m;
}

// ---------------------------------------------------------------------------
// Resort source rows: out[i, k] = concat(order2[i, 0], order2[i, 1])[shift_i
// + k], the destination chunk's slice of the sorted order. One CTA of C
// threads per chunk (C = 128 in 3D, 64 in 2D), one thread per lane. The TPU
// kernel routes lanes with f32 selection matmuls, exact only below 2^24
// slots; this one copies int32, so it has no such limit. Bound on this
// card: launch latency (12 B per lane).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128) src_rows_kernel(const int* __restrict__ order2,
                                                       const int* __restrict__ shifts,
                                                       int* __restrict__ out) {
  const int c = blockDim.x;
  const int i = blockIdx.x;
  const int j = threadIdx.x + shifts[i];
  const int* rows = order2 + (size_t)i * 2 * c;
  out[(size_t)i * c + threadIdx.x] = (j >= 0 && j < 2 * c) ? rows[j] : 0;
}

// ---------------------------------------------------------------------------
// Resort permute: destination slot (chunk d, lane l) takes every row of
// source slot src[d, l] (flat chunk * C + lane; -1 leaves it zero); the
// drift row is zeroed and the window-origin rows are written from the new
// structure, as the TPU kernel finalizes them. The TPU kernel fetches at
// most K = 8 whole source chunks per destination by DMA and routes lanes
// among them with selection matmuls, so its package falls back to a
// per-slot gather past K; here each thread copies its own source slot, with
// no K limit and bit-exact. One CTA of C threads per destination chunk, nf
// f32 rows per slot (3D: 56 rows, C = 128; 2D: 40, 64). Bound on this card:
// bytes. Each thread reads its source slot's nf + 8 rows, 4 B each with a
// 4C B stride; lanes of one warp mostly read neighbouring lanes of one
// source chunk (the sort is stable), so the reads coalesce, and every write
// is a full row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128) permute_slots_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ src, const int* __restrict__ origin,
    float* __restrict__ out_f, int* __restrict__ out_i, int max_chunks, int dim,
    int r_cumd, int nf) {
  const int c = blockDim.x;
  const int d = blockIdx.x;
  const int lane = threadIdx.x;
  const int s = src[(size_t)d * c + lane];
  const bool ok = s >= 0 && s < max_chunks * c;
  const int cid = ok ? s / c : 0, sl = ok ? s % c : 0;
  const float* S = slots + (size_t)cid * nf * c + sl;
  const int* I = ints + (size_t)cid * NI * c + sl;
  float* OF = out_f + (size_t)d * nf * c + lane;
  int* OI = out_i + (size_t)d * NI * c + lane;
  for (int f = 0; f < nf; ++f) OF[f * c] = (ok && f != r_cumd) ? S[f * c] : 0.0f;
  for (int r = 0; r < NI; ++r) {
    int v = ok ? I[r * c] : 0;
    if (r >= I_ORIGIN && r < I_ORIGIN + dim) v = origin[(size_t)d * dim + r - I_ORIGIN];
    OI[r * c] = v;
  }
}

// ---------------------------------------------------------------------------
// Lane router: destination lane l of chunk d takes column target[d, l] % C
// of pre-gathered source chunk target[d, l] / C, every f32 row of
// gathered [D, K, nf, C] and every int row of gathered_i [D, K, ni, C];
// target outside [0, K·C) writes zeros. The TPU kernel routes lanes with
// 0/1 selection matmuls on the MXU (ints split into exact 16-bit halves);
// here each thread copies its own lane's column, as raw 32-bit words, so the
// copy is bit-exact for any K. One CTA of C threads per destination chunk
// (C = 128 or 64). Bound on this card: bytes (every output row written
// once, coalesced; each lane reads one column of one source chunk, and
// lanes of a warp mostly read neighbouring lanes of one source).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128) permute_chunks_kernel(
    const float* __restrict__ gathered, const int* __restrict__ gathered_i,
    const int* __restrict__ target, float* __restrict__ out_f, int* __restrict__ out_i,
    int k_src, int nf, int ni) {
  const int c = blockDim.x;
  const int d = blockIdx.x;
  const int lane = threadIdx.x;
  const int t = target[(size_t)d * c + lane];
  const bool ok = t >= 0 && t < k_src * c;
  const size_t src = (size_t)d * k_src + (ok ? t / c : 0);
  const int sl = ok ? t % c : 0;
  const float* G = gathered + src * nf * c + sl;
  const int* GI = gathered_i + src * ni * c + sl;
  float* OF = out_f + (size_t)d * nf * c + lane;
  int* OI = out_i + (size_t)d * ni * c + lane;
  for (int f = 0; f < nf; ++f) OF[f * c] = ok ? G[f * c] : 0.0f;
  for (int r = 0; r < ni; ++r) OI[r * c] = ok ? GI[r * c] : 0;
}

// ---------------------------------------------------------------------------
// Kernel B: window gather, advection, F update, SVD, the plastic return map
// of the slot's model (Drucker-Prager, Rankine or Snow; the JAX kernel
// runs each present map on every lane and keeps the lane's own), guards,
// positive energy, maximum-stress failure, out-of-grid mark, next dt
// bound, drift, and with the stress-cache option the cached stress of the
// final F; written IN PLACE.
//
// The SVD sequence is the JAX kernel's (sparkl_tpu/fused/kernels.py:
// 1351-1425), since each SVD rounds F's last bits: with the SVD-reuse
// option (the stress cache on, Drucker-Prager the only plastic model) one
// SVD of the updated F serves the return map, the energy and the stress
// epilogue. Otherwise each return map decomposes the F it receives, and one
// SVD of the final, guarded F serves the energy and either the stress
// epilogue or, without the cache (damage and failure scenes), for slots
// whose model fails by maximum stress, a fresh corotated stress whose
// envelope trip sets phase = 0 (sparkl_tpu/fused/kernels.py:1435-1446);
// the stress rows are then zero. psi_pos = max(psi_pos, energy), par1 =
// psi_pos·m, par2 = m. With the modified-eigenerosion option the window's
// psi channel (the grid's psi momentum over psi mass) is gathered like a
// velocity component, and a crack slot whose cpf·h·psi exceeds its threshold
// breaks (phase 0) before the return map (sparkl_tpu/fused/kernels.py:
// 1306-1310); under plain eigenerosion the pooling trips instead and the
// psi channel is not read.
//
// The DAMAGE instance (the stress cache off: damage and failure scenes)
// compiles the psi gather and both trips; the other instance leaves them
// out, so that the scenes without damage or failure keep their code and
// registers.
//
// EOS fluid slots (branch per slot on the model's type) update only J
// = F00 by tr(grad v), take no SVD and no return map, skip the |F00|
// blowup guard (the det = 0 guard stays), bound dt with the EOS bound and
// write zero stress-cache rows: kernel A forms their stress fresh.
//
// One C-thread CTA per chunk: the chunk's velocity windows [d, 8^d] (6 KB
// in 3D, 512 B in 2D) go to shared memory, each thread gathers its 3^d
// nodes (3D: per z tap the xy sheet first; 2D: per x tap the y taps first,
// the JAX kernel's contraction orders) and runs the particle physics in
// registers (particle_physics.cuh). Each thread reads every row of its own
// slot before writing it, and no thread touches another lane, so the
// in-place update is safe. Dead chunks (>= num_chunks) return untouched.
// Bound on this card: per-thread arithmetic and registers (in 3D one
// Cardano SVD and ~3 transcendental DP steps; a Rankine or Snow lane two
// SVDs, logs and exps) at one CTA per chunk; the slot read/write is 2 x NF
// rows, coalesced.
// ---------------------------------------------------------------------------
template <int DIM, int C, bool DAMAGE>
__global__ void __launch_bounds__(C) g2p_fused_kernel(
    float* __restrict__ slots, const int* __restrict__ ints,
    const float* __restrict__ windows, const int* __restrict__ nchunks,
    const float* __restrict__ tab_f, const int* __restrict__ tab_i, int m_count,
    float dt, GridArgs g, int n_win, int opts) {
  using R = Rows<DIM>;
  constexpr int RC = region_cells<DIM>();
  constexpr int NW = DIM + (DAMAGE ? 1 : 0);  // window channels read
  const int chunk = blockIdx.x;
  if (chunk >= *nchunks) return;
  const int t = threadIdx.x;
  const bool stress_cache = (opts & OPT_STRESS_CACHE) != 0;
  const bool svd_reuse = (opts & OPT_SVD_REUSE) != 0;
  // The psi channel is read only for the modified trip.
  const bool modified = DAMAGE && (opts & OPT_MODIFIED) != 0 && n_win > DIM;

  __shared__ float win[NW * RC];
  const float* W = windows + (size_t)chunk * n_win * RC;
  for (int e = t; e < (modified ? DIM + 1 : DIM) * RC; e += C) win[e] = W[e];
  __syncthreads();

  float* S = slots + (size_t)chunk * R::NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
#define SROW(k) S[(k) * C + t]
  const int mid = I[I_MODEL * C + t];
  const int flags = I[I_FLAGS * C + t];
  const bool active = (flags & FLAG_ACTIVE) != 0;
  const bool is_static = (flags & FLAG_STATIC) != 0;
  const bool kinematic = (flags & FLAG_KINEMATIC) != 0;

  // Model table row (a model id outside the table reads zeros).
  float tf[NTAB_F];
  int ti[NTAB_I];
  const bool mid_ok = mid >= 0 && mid < m_count;
  for (int k = 0; k < NTAB_F; ++k) tf[k] = mid_ok ? tab_f[mid * NTAB_F + k] : 0.0f;
  for (int k = 0; k < NTAB_I; ++k) ti[k] = mid_ok ? tab_i[mid * NTAB_I + k] : 0;

  float pos[DIM];
  for (int ax = 0; ax < DIM; ++ax) pos[ax] = SROW(R::POS + ax);
  int rel[DIM];
  float fx[DIM];
  const bool contrib = slot_transfer<DIM, C>(g, S, I, t, rel, fx);

  // --- gather ---
  float vel[DIM], gm[DIM][DIM];
  float psi_mom = 0.0f;  // the psi channel, like a velocity component
  for (int i = 0; i < DIM; ++i) {
    vel[i] = 0.0f;
    for (int j = 0; j < DIM; ++j) gm[i][j] = 0.0f;
  }
  if (contrib) {
    float w[DIM][3], dpt[DIM][3];
    for (int ax = 0; ax < DIM; ++ax) {
      const float px = (float)rel[ax] + fx[ax];
      quadratic_weights(fx[ax], w[ax]);
      for (int k = 0; k < 3; ++k) dpt[ax][k] = ((float)(rel[ax] + k) - px) * g.h;
    }
    if constexpr (DIM == 3) {
      float sv[3] = {0.0f, 0.0f, 0.0f}, sgx[3] = {0.0f, 0.0f, 0.0f},
            sgy[3] = {0.0f, 0.0f, 0.0f}, sgz[3] = {0.0f, 0.0f, 0.0f};
      for (int c = 0; c < 3; ++c) {
        float tv[3] = {0.0f, 0.0f, 0.0f}, tx[3] = {0.0f, 0.0f, 0.0f},
              ty[3] = {0.0f, 0.0f, 0.0f};
        [[maybe_unused]] float tp = 0.0f;
        const int zq = (rel[2] + c) * 64;
        for (int a = 0; a < 3; ++a) {
          for (int b = 0; b < 3; ++b) {
            const int q = zq + (rel[0] + a) * 8 + (rel[1] + b);
            const float wxy = w[0][a] * w[1][b];
            const float wdx_y = (w[0][a] * dpt[0][a]) * w[1][b];
            const float wx_dy = w[0][a] * (w[1][b] * dpt[1][b]);
            for (int i = 0; i < 3; ++i) {
              const float v = win[i * RC + q];
              tv[i] += v * wxy;
              tx[i] += v * wdx_y;
              ty[i] += v * wx_dy;
            }
            if constexpr (DAMAGE)
              if (modified) tp += win[3 * RC + q] * wxy;
          }
        }
        const float wz = w[2][c], wdz = w[2][c] * dpt[2][c];
        for (int i = 0; i < 3; ++i) {
          sv[i] += tv[i] * wz;
          sgx[i] += tx[i] * wz;
          sgy[i] += ty[i] * wz;
          sgz[i] += tv[i] * wdz;
        }
        if constexpr (DAMAGE) psi_mom += tp * wz;
      }
      for (int i = 0; i < 3; ++i) {
        vel[i] = sv[i];
        gm[i][0] = g.invd * sgx[i];
        gm[i][1] = g.invd * sgy[i];
        gm[i][2] = g.invd * sgz[i];
      }
    } else {
      float sv[2] = {0.0f, 0.0f}, sgx[2] = {0.0f, 0.0f}, sgy[2] = {0.0f, 0.0f};
      for (int a = 0; a < 3; ++a) {
        const float wx = w[0][a], wdx = w[0][a] * dpt[0][a];
        const int xq = (rel[0] + a) * 8 + rel[1];
        for (int i = 0; i < 2; ++i) {
          float tv = 0.0f, ty = 0.0f;
          for (int b = 0; b < 3; ++b) {
            const float v = win[i * RC + xq + b];
            tv += v * w[1][b];
            ty += v * (w[1][b] * dpt[1][b]);
          }
          sv[i] += tv * wx;
          sgx[i] += tv * wdx;
          sgy[i] += ty * wx;
        }
        if constexpr (DAMAGE) {
          if (modified) {
            float tp = 0.0f;
            for (int b = 0; b < 3; ++b) tp += win[2 * RC + xq + b] * w[1][b];
            psi_mom += tp * wx;
          }
        }
      }
      for (int i = 0; i < 2; ++i) {
        vel[i] = sv[i];
        gm[i][0] = g.invd * sgx[i];
        gm[i][1] = g.invd * sgy[i];
      }
    }
  }

  // --- particle update ---
  float phase = SROW(R::PHASE);
  const bool failed = SROW(R::FAILED) != 0.0f;
  const float mass = SROW(R::MASS);
  const float vol0 = SROW(R::VOL0);
  float eh = SROW(R::EH);
  float ph = SROW(R::PH);
  float pdd = SROW(R::PDD);
  float lvg = SROW(R::LVG);
  const float nacc = SROW(R::NACC);
  float psi_pos = SROW(R::PSI_POS);
  float f[DIM][DIM];
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) f[i][j] = SROW(R::DEFGRAD + i * DIM + j);
  float kin[DIM];
  for (int ax = 0; ax < DIM; ++ax) kin[ax] = SROW(R::KINVEL + ax);
  const float cpf = SROW(R::CPF), cthr = SROW(R::CTHR), radius0 = SROW(R::RADIUS0);
  const float mcv = SROW(R::MC), gval = SROW(R::G), dbg = SROW(R::DEBUG);
  const float cumd0 = SROW(R::CUMD);

  // Modified eigenerosion: a crack slot breaks where cpf·h·psi exceeds its
  // threshold, before the return map reads the phase.
  if constexpr (DAMAGE) {
    if (modified && cpf != 0.0f && phase > 0.0f && cpf * g.h * psi_mom > cthr) phase = 0.0f;
  }

  // Advection (kinematic override + optional GPU CFL clamp).
  for (int i = 0; i < DIM; ++i) vel[i] = kinematic ? kin[i] : vel[i];
  if (opts & OPT_CLAMP) {
    bool over = false;
    for (int i = 0; i < DIM; ++i) over = over || (fabsf(vel[i]) * dt >= g.h);
    if (over)
      for (int i = 0; i < DIM; ++i)
        vel[i] = (vel[i] > 0.0f ? 1.0f : (vel[i] < 0.0f ? -1.0f : 0.0f)) * (g.h / dt);
  }
  float npos[DIM];
  for (int ax = 0; ax < DIM; ++ax) npos[ax] = pos[ax] + vel[ax] * dt;

  // F += dt * (grad v) F; fluids: F00 += tr(grad v) dt F00, the rest kept.
  const bool fluid = ti[0] == EOS_MONAGHAN_SPH;
  float fnew[DIM][DIM];
  if (fluid) {
    for (int i = 0; i < DIM; ++i)
      for (int j = 0; j < DIM; ++j) fnew[i][j] = f[i][j];
    float tr = gm[0][0];
    for (int i = 1; i < DIM; ++i) tr = tr + gm[i][i];
    fnew[0][0] = f[0][0] + tr * dt * f[0][0];
  } else {
    for (int i = 0; i < DIM; ++i)
      for (int j = 0; j < DIM; ++j) {
        float gf = gm[i][0] * f[0][j];
        for (int k = 1; k < DIM; ++k) gf = gf + gm[i][k] * f[k][j];
        fnew[i][j] = f[i][j] + dt * gf;
      }
  }

  // Plastic return map of the slot's model. Under SVD reuse one SVD of the
  // updated F serves the return map, the energy and the stress; otherwise
  // each map decomposes the F it receives and the final F is decomposed
  // again after the guards.
  float u[DIM][DIM], s[DIM], v[DIM][DIM];
  for (int i = 0; i < DIM; ++i) {
    s[i] = 1.0f;
    for (int j = 0; j < DIM; ++j) u[i][j] = v[i][j] = i == j ? 1.0f : 0.0f;
  }
  if (!fluid) {
    if (svd_reuse || ti[1] == DRUCKER_PRAGER) sparkl::svd(fnew, u, s, v);
    if (ti[1] == DRUCKER_PRAGER)
      sparkl::dp_update<DIM>(tf + 4, phase, fnew, u, s, v, pdd, ph, lvg);
    // Rankine and Snow in 3D are refused (fused.kernels.meta_unsupported):
    // the 3D instance leaves them out and keeps its registers.
    if constexpr (DIM == 2) {
      if (ti[1] == RANKINE)
        sparkl::rankine_update<DIM>(tf + 4, fnew, ph);
      else if (ti[1] == SNOW)
        sparkl::snow_update<DIM>(tf + 4, fnew, eh, pdd);
    }
  }

  // Static particles.
  if (is_static) {
    for (int i = 0; i < DIM; ++i) {
      vel[i] = 0.0f;
      for (int j = 0; j < DIM; ++j) gm[i][j] = 0.0f;
    }
  }

  // Failure guards: det(F) = 0, already failed, |F00| blowup (solids only).
  const float detf = sparkl::det(fnew);
  const bool broken = (detf == 0.0f) || failed || (!fluid && fabsf(fnew[0][0]) > 1.0e4f);
  bool failed_new = failed || broken;
  if (broken) {
    for (int i = 0; i < DIM; ++i) {
      s[i] = 1.0f;
      for (int j = 0; j < DIM; ++j) {
        fnew[i][j] = i == j ? 1.0f : 0.0f;
        gm[i][j] = 0.0f;
      }
    }
  }
  // Without SVD reuse: one SVD of the final F serves the energy and the
  // cached or the failure stress (the JAX kernel decomposes the same F for
  // each).
  if (!svd_reuse && !fluid) sparkl::svd(fnew, u, s, v);

  const float lam = tf[0], mu = tf[1], cfl = tf[2], split = tf[3];
  const bool corot = ti[0] == COROTATED;
  const float energy = corot ? sparkl::corotated_pos_energy<DIM>(lam, mu, eh, fnew, s) : 0.0f;
  psi_pos = fmaxf(psi_pos, energy);
  const float par1 = psi_pos * mass;
  const float par2 = mass;

  // Maximum-stress failure on the fresh stress of the final F.
  if constexpr (DAMAGE) {
    if (ti[2] == MAXIMUM_STRESS) {
      float st[DIM][DIM];
      for (int i = 0; i < DIM; ++i)
        for (int j = 0; j < DIM; ++j) st[i][j] = 0.0f;
      if (corot) sparkl::corotated_stress<DIM>(lam, mu, split, phase, eh, fnew, u, s, v, st);
      if (sparkl::maximum_stress_failed(tf[TAB_F], tf[TAB_F + 1], st)) phase = 0.0f;
    }
  }

  // Out-of-grid mark from the new positions.
  {
    int nb[DIM];
    float nfx[DIM];
    bool ok;
    base_fx<DIM>(g, npos, nb, nfx, ok);
    failed_new = failed_new || (active && !ok);
  }

  // Next substep's dt bound.
  float frob = 0.0f;
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) frob += gm[i][j] * gm[i][j];
  const float norm_b = g.d_coeff * sqrtf(frob);
  const float sqrt_d = DIM == 3 ? 1.7320508075688772f : 1.4142135623730951f;
  const float apic_v = norm_b * 6.0f * sqrt_d * (1.0f / g.h);  // x / h as jitted XLA rounds it
  float vsq = vel[0] * vel[0];
  for (int i = 1; i < DIM; ++i) vsq = vsq + vel[i] * vel[i];
  const float vnorm = sqrtf(vsq);
  const float vtot = vnorm + apic_v;
  const float vel_bound = vtot > 0.0f ? g.h / fmaxf(vtot, 1e-20f) : INFINITY;
  float con_bound = INFINITY;
  const float density0 = mass / fmaxf(vol0, 1e-30f);
  if (corot) {
    // lam + 2 mu / 3 as jitted XLA forms it: mu f32(2/3) contracted into one FMA
    // (an explicit fmaf: the build does not contract).
    const float bulk = fmaf(mu, 2.0f * (1.0f / 3.0f), lam) * eh;
    const float shear = mu * eh;
    con_bound = sparkl::sound_speed_bound(cfl, bulk, shear, density0, vnorm, g.h);
  } else if (fluid) {
    const float fj = fnew[0][0];
    const float density = density0 / fmaxf(fj, 1e-20f);
    con_bound = sparkl::eos_timestep_bound<DIM>(tf[0], tf[1], tf[3], fj, mass, vol0, density,
                                                vsq, g.h);
  }
  if (failed_new) con_bound = INFINITY;
  float bound = fminf(vel_bound, con_bound);
  if (!active) bound = INFINITY;
  bound = fminf(bound, BIGF);

  // Drift accumulation (lazy-resort trigger).
  float step_disp = fabsf(vel[0]) * dt;
  for (int i = 1; i < DIM; ++i) step_disp = fmaxf(step_disp, fabsf(vel[i]) * dt);
  const float cumd = cumd0 + step_disp;

  // Stress-cache epilogue from the shared SVD (zero rows without the cache).
  float st[DIM][DIM];
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) st[i][j] = 0.0f;
  if (stress_cache && corot)
    sparkl::corotated_stress<DIM>(lam, mu, split, phase, eh, fnew, u, s, v, st);

  // --- write the slot (every row of this lane was read above) ---
  for (int ax = 0; ax < DIM; ++ax) {
    SROW(R::POS + ax) = npos[ax];
    SROW(R::VEL + ax) = vel[ax];
  }
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) {
      SROW(R::GRAD + i * DIM + j) = gm[i][j];
      SROW(R::DEFGRAD + i * DIM + j) = fnew[i][j];
    }
  SROW(R::MASS) = mass;
  SROW(R::VOL0) = vol0;
  SROW(R::PHASE) = phase;
  SROW(R::PSI_POS) = psi_pos;
  SROW(R::PDD) = pdd;
  SROW(R::PH) = ph;
  SROW(R::EH) = eh;
  SROW(R::LVG) = lvg;
  SROW(R::NACC) = nacc;
  for (int ax = 0; ax < DIM; ++ax) SROW(R::KINVEL + ax) = kin[ax];
  SROW(R::CPF) = cpf;
  SROW(R::CTHR) = cthr;
  SROW(R::DTB) = bound;
  SROW(R::FAILED) = failed_new ? 1.0f : 0.0f;
  SROW(R::RADIUS0) = radius0;
  SROW(R::PAR1) = par1;
  SROW(R::PAR2) = par2;
  SROW(R::MC) = mcv;
  SROW(R::G) = gval;
  SROW(R::DEBUG) = dbg;
  SROW(R::CUMD) = cumd;
  int k = 0;
  for (int i = 0; i < DIM; ++i)
    for (int j = i; j < DIM; ++j) SROW(R::STRESS + k++) = sparkl::clampf(st[i][j], -BIGF, BIGF);
  for (int r = R::STRESS + R::NSTRESS; r < R::NF; ++r) SROW(r) = 0.0f;
#undef SROW
}

// ---------------------------------------------------------------------------
// Eigenerosion pooling: for each eligible own lane, the sums of m·psi_pos
// and m over the eligible lanes of its candidate chunks (the chunks of the
// 3^d neighbouring blocks) within squared distance r2 = h² (f32), the lane
// itself excluded where the candidate is its own chunk (ref:
// eigenerosion.rs:9-58). e [D, 8, C]: rows pos (d), m·psi_pos, m,
// eligible; cand [D, KN], D for none; out [D, 2, C].
//
// The TPU kernel gets the candidates' rows gathered by XLA ([D, KN, 8, C])
// and forms each [C, C] distance tile on the vector unit. Here one C-thread
// CTA per chunk, one thread per own lane, reads e and the candidate ids
// directly: each candidate chunk's position, m·psi, m and eligible rows go
// to shared memory, and each thread walks its lanes in ascending order,
// summing per candidate and then the candidates in ascending order (the
// TPU kernel's loop order), so two runs are bit-equal. Bound on this card:
// operations, KN·C distance tests per lane (~10 flops each), at C threads
// per CTA; the bytes are each chunk's 8 rows and its candidates' d + 3.
// ---------------------------------------------------------------------------
template <int DIM, int C>
__global__ void __launch_bounds__(C) eigen_pool_kernel(const float* __restrict__ e,
                                                       const int* __restrict__ cand,
                                                       float* __restrict__ out,
                                                       int max_chunks, int kn, float r2) {
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  constexpr int EIG_ROWS = 8;
  const float* E = e + (size_t)chunk * EIG_ROWS * C;
  float mine[DIM];
  for (int ax = 0; ax < DIM; ++ax) mine[ax] = E[ax * C + t];
  const bool eligible = E[(DIM + 2) * C + t] != 0.0f;

  __shared__ float s_pos[DIM][C];
  __shared__ float s_v0[C], s_v1[C], s_el[C];
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = 0; k < kn; ++k) {
    const int cid = cand[(size_t)chunk * kn + k];  // the same for the whole CTA
    if (cid < 0 || cid >= max_chunks) continue;
    const float* G = e + (size_t)cid * EIG_ROWS * C;
    __syncthreads();  // the previous candidate's rows are consumed
    for (int ax = 0; ax < DIM; ++ax) s_pos[ax][t] = G[ax * C + t];
    s_v0[t] = G[DIM * C + t];
    s_v1[t] = G[(DIM + 1) * C + t];
    s_el[t] = G[(DIM + 2) * C + t];
    __syncthreads();
    if (!eligible) continue;
    const int self_lane = cid == chunk ? t : -1;
    float p0 = 0.0f, p1 = 0.0f;
    for (int j = 0; j < C; ++j) {
      float d2 = 0.0f;
      for (int ax = 0; ax < DIM; ++ax) {
        const float diff = s_pos[ax][j] - mine[ax];
        d2 = ax == 0 ? diff * diff : d2 + diff * diff;
      }
      if (d2 <= r2 && s_el[j] != 0.0f && j != self_lane) {
        p0 += s_v0[j];
        p1 += s_v1[j];
      }
    }
    acc0 += p0;
    acc1 += p1;
  }
  out[(size_t)chunk * 2 * C + t] = acc0;
  out[((size_t)chunk * 2 + 1) * C + t] = acc1;
}

GridArgs grid_args(float ox, float oy, float oz, float h, float invd,
                   float d_coeff, int rx, int ry, int rz) {
  GridArgs g;
  g.origin[0] = ox;
  g.origin[1] = oy;
  g.origin[2] = oz;
  g.h = h;
  g.invd = invd;
  g.d_coeff = d_coeff;
  g.res[0] = rx;
  g.res[1] = ry;
  g.res[2] = rz;
  return g;
}

}  // namespace

extern "C" {

int sparkl_p2g_fused(const float* slots, const int* ints, const int* nchunks,
                     const float* tab_f, const int* tab_i, int m_count, float* out,
                     int max_chunks, float dt, float ox, float oy, float oz, float h,
                     float invd, float d_coeff, int rx, int ry, int rz, int dim, int opts,
                     void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz);
  const bool psi = (opts & OPT_PSI) != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3 && psi)
    p2g_fused_kernel<3, 128, true><<<max_chunks, 128, 0, st>>>(
        slots, ints, nchunks, tab_f, tab_i, m_count, out, dt, g, opts);
  else if (dim == 3)
    p2g_fused_kernel<3, 128, false><<<max_chunks, 128, 0, st>>>(
        slots, ints, nchunks, tab_f, tab_i, m_count, out, dt, g, opts);
  else if (dim == 2 && psi)
    p2g_fused_kernel<2, 64, true><<<max_chunks, 64, 0, st>>>(
        slots, ints, nchunks, tab_f, tab_i, m_count, out, dt, g, opts);
  else if (dim == 2)
    p2g_fused_kernel<2, 64, false><<<max_chunks, 64, 0, st>>>(
        slots, ints, nchunks, tab_f, tab_i, m_count, out, dt, g, opts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int sparkl_merge_scatter(const float* rows, const int* order, const int* starts,
                         float* out, int n_rows, int width, void* stream) {
  const int threads = width >= 256 ? 256 : ((width + 31) / 32) * 32;
  if (n_rows > 0)
    merge_scatter_kernel<<<n_rows, threads, 0, (cudaStream_t)stream>>>(rows, order, starts,
                                                                        out, width);
  return (int)cudaGetLastError();
}

int sparkl_mass_p2g_fused(const float* slots, const int* ints, const int* nchunks,
                          float* out, int max_chunks, float ox, float oy, float oz, float h,
                          float invd, float d_coeff, int rx, int ry, int rz, int dim,
                          void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz);
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3)
    mass_p2g_kernel<3, 128><<<max_chunks, 128, 0, st>>>(slots, ints, nchunks, out, g);
  else if (dim == 2)
    mass_p2g_kernel<2, 64><<<max_chunks, 64, 0, st>>>(slots, ints, nchunks, out, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int sparkl_mass_g2p_fused(const float* slots, const int* ints, const float* windows,
                          const int* nchunks, float* out, int max_chunks, float ox, float oy,
                          float oz, float h, float invd, float d_coeff, int rx, int ry, int rz,
                          int dim, void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz);
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3)
    mass_g2p_kernel<3, 128><<<max_chunks, 128, 0, st>>>(slots, ints, windows, nchunks, out, g);
  else if (dim == 2)
    mass_g2p_kernel<2, 64><<<max_chunks, 64, 0, st>>>(slots, ints, windows, nchunks, out, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int sparkl_merge_blocks(const float* rows, const int* first, const int* nch,
                        float* out, int max_blocks, int width, int kmax,
                        void* stream) {
  merge_blocks_kernel<<<max_blocks, 256, 0, (cudaStream_t)stream>>>(
      rows, first, nch, out, width, kmax);
  return (int)cudaGetLastError();
}

int sparkl_src_rows_from_order(const int* order2, const int* shifts, int* out,
                               int max_chunks, int c, void* stream) {
  if (c != 64 && c != 128) return (int)cudaErrorInvalidValue;
  src_rows_kernel<<<max_chunks, c, 0, (cudaStream_t)stream>>>(order2, shifts, out);
  return (int)cudaGetLastError();
}

int sparkl_permute_slots(const float* slots, const int* ints, const int* src,
                        const int* origin, float* out_f, int* out_i, int max_chunks,
                        int dim, int r_cumd, int nf, int c, void* stream) {
  if (c != 64 && c != 128) return (int)cudaErrorInvalidValue;
  permute_slots_kernel<<<max_chunks, c, 0, (cudaStream_t)stream>>>(
      slots, ints, src, origin, out_f, out_i, max_chunks, dim, r_cumd, nf);
  return (int)cudaGetLastError();
}

int sparkl_permute_chunks(const float* gathered, const int* gathered_i, const int* target,
                          float* out_f, int* out_i, int max_chunks, int k_src, int nf, int ni,
                          int c, void* stream) {
  if (c != 64 && c != 128) return (int)cudaErrorInvalidValue;
  permute_chunks_kernel<<<max_chunks, c, 0, (cudaStream_t)stream>>>(
      gathered, gathered_i, target, out_f, out_i, k_src, nf, ni);
  return (int)cudaGetLastError();
}

int sparkl_g2p_fused(float* slots, const int* ints, const float* windows,
                     const int* nchunks, const float* tab_f, const int* tab_i,
                     int m_count, int max_chunks, float dt, float ox, float oy,
                     float oz, float h, float invd, float d_coeff, int rx, int ry, int rz,
                     int dim, int n_win, int opts, void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz);
  cudaStream_t st = (cudaStream_t)stream;
  // The damage form: the stress cache off (damage and failure scenes).
  const bool damage = (opts & OPT_STRESS_CACHE) == 0;
  if (dim == 3 && damage)
    g2p_fused_kernel<3, 128, true><<<max_chunks, 128, 0, st>>>(
        slots, ints, windows, nchunks, tab_f, tab_i, m_count, dt, g, n_win, opts);
  else if (dim == 3)
    g2p_fused_kernel<3, 128, false><<<max_chunks, 128, 0, st>>>(
        slots, ints, windows, nchunks, tab_f, tab_i, m_count, dt, g, n_win, opts);
  else if (dim == 2 && damage)
    g2p_fused_kernel<2, 64, true><<<max_chunks, 64, 0, st>>>(
        slots, ints, windows, nchunks, tab_f, tab_i, m_count, dt, g, n_win, opts);
  else if (dim == 2)
    g2p_fused_kernel<2, 64, false><<<max_chunks, 64, 0, st>>>(
        slots, ints, windows, nchunks, tab_f, tab_i, m_count, dt, g, n_win, opts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int sparkl_eigen_pool(const float* e, const int* cand, float* out, int max_chunks, int kn,
                      float r2, int dim, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3)
    eigen_pool_kernel<3, 128><<<max_chunks, 128, 0, st>>>(e, cand, out, max_chunks, kn, r2);
  else if (dim == 2)
    eigen_pool_kernel<2, 64><<<max_chunks, 64, 0, st>>>(e, cand, out, max_chunks, kn, r2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
