// Hand-written Hopper (sm_90a) kernels of the fused substep.
//
// Eleven kernels, each with a plain PyTorch version beside its wrapper in
// sparkl_tpu_torch/fused/kernels.py:
//
//   p2g_fused_kernel  replaces sparkl_tpu/fused/kernels.py:p2g_fused
//                     (_p2g_kernel), "kernel A";
//   merge_blocks_kernel replaces sparkl_tpu/fused/kernels.py:merge_blocks_dma
//                     (_merge_dma_kernel) with the inverse-corner gather
//                     after it, on the window images;
//   merge_scatter_kernel replaces the XLA scatter-add of
//                     sparkl_tpu/sparse/transfer.py:_merge_scatter (glue, not
//                     a TPU kernel), deterministically, on the window images;
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
//                     (_eigen_pool_kernel), the eigenerosion pooling, with
//   eigen_box_kernel  its lane-group boxes (the same launcher runs both);
//   permute_chunks_kernel replaces sparkl_tpu/fused/kernels.py:permute_chunks
//                     (_permute_kernel), the older resort lane router, which
//                     no path of either package calls.
//
// Layouts are the JAX package's: slots f32 [D, NF, C] and ints i32 [D,
// NI=8, C] (row offsets of sparkl_tpu/fused/layout.py Rows(d), checked
// against the Python side by the CPU tests), in 3D NF = 56 and C = 128 with
// window images and windows in z-major region-cell order q = z*64 + x*8 +
// y, in 2D NF = 40 and C = 64 with row-major cells q = x*8 + y (kernel B
// reads the node table's window fields [MAX_GRID_BLOCKS + 1, n · 4^d] at
// each chunk's corner blocks instead of a window). Kernels A
// and B, the two mass kernels and the pooling are templates on the
// dimension and the chunk size, instantiated for (3, 128) and (2, 64); A
// also on its psi channels and B on its damage form (the stress cache off:
// damage and failure scenes), so that the scenes without damage keep their
// code; both also on their material form (MATS: neo-Hookean, NACC, and
// Rankine and Snow in 3D), so that the scenes without these materials keep
// their code and registers; B also on its fluid form (every model the EOS
// fluid). The launchers pick the instance. Each launcher is
// a plain C function that enqueues on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it has no instance
// for); the caller allocates every output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false   (never --use_fast_math: the physics
//        uses expf/logf/sinf and sqrtf-based Cardano eigenvalues)

#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "particle_physics.cuh"
#include "scatter_walk.cuh"

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
constexpr int NEO_HOOKEAN = 1;
constexpr int EOS_MONAGHAN_SPH = 2;
constexpr int DRUCKER_PRAGER = 1;
constexpr int NACC = 2;
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
constexpr int OPT_MATS = 16;         // kernels A and B: the material instance
constexpr int OPT_FLUID = 32;        // kernel B: every model the EOS fluid

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

// Window cell q's coordinates: z-major in 3D (q = z*64 + x*8 + y), the
// JAX kernels' order, row-major in 2D (q = x*8 + y; z unused).
template <int D>
__device__ __forceinline__ void cell_coords(int q, int& x, int& y, int& z) {
  x = D == 3 ? (q >> 3) & 7 : q >> 3;
  y = q & 7;
  z = q >> 6;
}

// 16-byte asynchronous copies from global to shared memory (cp.async, L2
// only), their commit groups, and the waits for all but the newest group or
// for all of them.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// split for broken particles, and in the MATS instance neo-Hookean in
// closed form (the cached read is the same for every model). Failed debris
// contributes no stress. The JAX
// kernel folds the model test statically for single-type model sets; this
// one branches per slot on the model's type, so mixed sets take the same
// values.
//
// One C-thread CTA per chunk. Each thread prepares its slot's payload in
// shared memory, and per axis its 3 taps' weights and offsets at their
// window coordinates (rows of 8), so that the walk reads them at its
// cell's own coordinates, with no read of the slot's base cell first.
// Cell (x, y, z) is hit by the slots whose window-relative base cell (rel
// in [0, 5]^d) lies in x-2..x, y-2..y, z-2..z, so its lane mask (C/64
// words) is the AND of one mask per axis and coordinate, which warp
// ballots build in the prologue (8·d ballots a warp; no atomics, and no
// barrier but the prologue's own; csrc/scatter_walk.cuh holds these pieces
// of the walk, which the mass P2G and the sparse P2G share, and A walks
// with its walk_chain). In 3D the 4 cells a thread are handed
// out by their hit counts (a counting sort, heaviest first), so that a
// warp's 32 cells take about as many iterations (the assignment changes
// no sum). Each thread then walks its cells' set bits in ascending lane
// order and evaluates the
// hit body of the JAX kernel's contraction for exactly those slots: every
// cell is the same left fold over the same terms as a walk over all C
// slots, so the image is run-to-run deterministic and bit-equal to the
// plain version's lane-major scatter on the CPU. No float atomics. In 3D
// the image is staged in shared memory (over the consumed slot arrays)
// and written coalesced. Cell order: z-major in 3D (rows (f, z), lanes
// xy), row-major in 2D (rows (f, x), lanes y), the JAX kernel's.
// Bound on this card: instruction issue in the walk (27·C hits a CTA, a
// warp paying for its busiest lane), then the slot prologue (coalesced
// reads); in 2D on a small grid (one wave of CTAs) the latency of the
// walk's iterations. Shared memory (ptxas): ~35 KB a CTA in 3D, ~11 KB in 2D.
// ---------------------------------------------------------------------------
// The slot arrays' rows hold slot s at sparkl_walk::slot_col(s) (see
// csrc/scatter_walk.cuh, which holds the walk's pieces).
template <int DIM, int C, int NCH>
union P2GShared {
  static constexpr int SC = sparkl_walk::slot_cols<C>();
  struct {
    float w[DIM][8][SC];    // per axis and window coordinate: the 3 taps' weights
    float d[DIM][8][SC];    // and dpt = (tap cell - px) * h (the rest never read)
    float p0[NCH][SC];      // m, m*v (, psi momentum, psi mass)
    float a[DIM * DIM][SC];  // contrib * affine, row-major
  } in;
  float out[NCH * region_cells<DIM>()];  // the image, once the slots are consumed
};

template <int DIM, int C, bool PSI, bool MATS>
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

  // Lane masks (C/64 words each): per axis and window coordinate v in
  // 0..7, the contributing lanes whose base cell lies in v-2..v. With more
  // cells than threads (3D) the cells are sorted by hit count and the image
  // is staged; in 2D each thread owns one cell and writes it.
  using Mask = unsigned long long;
  constexpr int NW = C / 64;
  constexpr int NPASS = RC / C;  // cells per thread
  constexpr bool SORT = NPASS > 1;
  __shared__ P2GShared<DIM, C, NCH> sh;
  __shared__ Mask s_rng64[DIM * 8 * NW];
  unsigned* s_rng = reinterpret_cast<unsigned*>(s_rng64);
  __shared__ int s_bin[SORT ? C + 1 : 1];          // cells per hit count, then offsets
  __shared__ unsigned short s_list[SORT ? RC : 1];  // cells, busiest first
  auto& s_w = sh.in.w;
  auto& s_d = sh.in.d;
  auto& s_p0 = sh.in.p0;
  auto& s_a = sh.in.a;
  const int ts = sparkl_walk::slot_col(t);

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
    if constexpr (MATS) {
      if (ctype == NEO_HOOKEAN) {
        float f[DIM][DIM];
        for (int i = 0; i < DIM; ++i)
          for (int j = 0; j < DIM; ++j) f[i][j] = SROW(R::DEFGRAD + i * DIM + j);
        sparkl::neo_hookean_stress<DIM>(p[0], p[1], phase, SROW(R::EH), f, stress);
      }
    }
  }
  const float coeff = vol0 * g.invd * dt;
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) {
      float aff = mass * gv[i][j] - (failed ? 0.0f : coeff * stress[i][j]);
      s_a[i * DIM + j][ts] = contrib ? aff : 0.0f;  // an empty EOS lane's stress is NaN
    }
  const float m_c = mass * cf;
  s_p0[0][ts] = m_c;
  for (int ax = 0; ax < DIM; ++ax) s_p0[1 + ax][ts] = m_c * SROW(R::VEL + ax);
  if constexpr (PSI) {
    const bool cracks = phase > 0.0f && SROW(R::CPF) != 0.0f && !failed;
    const float psi_mass = cracks ? mass : 0.0f;
    s_p0[DIM + 1][ts] = psi_mass * SROW(R::PSI_POS) * cf;
    s_p0[DIM + 2][ts] = psi_mass * cf;
  }
  for (int ax = 0; ax < DIM; ++ax) {
    const float f = fx[ax];
    const float px = (float)rel[ax] + f;
    float w[3];
    quadratic_weights(f, w);
    if (contrib)
      for (int k = 0; k < 3; ++k) {
        s_w[ax][rel[ax] + k][ts] = w[k];
        s_d[ax][rel[ax] + k][ts] = ((float)(rel[ax] + k) - px) * g.h;
      }
  }
#undef SROW
  sparkl_walk::axis_masks<DIM, C>(contrib, rel, s_rng);
  if constexpr (SORT) sparkl_walk::clear_bins<C>(s_bin);
  __syncthreads();
  if constexpr (SORT) {
    int hits[NPASS];
    for (int k = 0; k < NPASS; ++k) {
      int x, y, z;
      cell_coords<DIM>(t + k * C, x, y, z);
      unsigned mk[C / 32];
      sparkl_walk::cell_mask<DIM, C>(s_rng, x, y, z, mk);
      hits[k] = sparkl_walk::popcount<C>(mk);
    }
    sparkl_walk::sort_cells<C, NPASS>(hits, s_bin, s_list);
  }

  float res[NPASS][NCH];
  int cell[NPASS];
#pragma unroll
  for (int k = 0; k < NPASS; ++k) {
    const int q = SORT ? s_list[t + k * C] : t + k * C;
    cell[k] = q;
    int x, y, z;
    cell_coords<DIM>(q, x, y, z);
    Mask mk[NW];
    sparkl_walk::cell_mask64<DIM, C>(s_rng, x, y, z, mk);
    float acc[NCH];
    for (int f = 0; f < NCH; ++f) acc[f] = 0.0f;
    sparkl_walk::walk_chain<C>(mk, [&](int s) {
      if constexpr (DIM == 3) {
        const float wx = s_w[0][x][s], wy = s_w[1][y][s], wz = s_w[2][z][s];
        const float dx = s_d[0][x][s], dy = s_d[1][y][s], dz = s_d[2][z][s];
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
      } else {
        const float wx = s_w[0][x][s], wy = s_w[1][y][s];
        const float wdx = wx * s_d[0][x][s], wdy = wy * s_d[1][y][s];
        acc[0] += (s_p0[0][s] * wx) * wy;
        // The affine x column rides the x taps, the y column the y taps,
        // as the JAX kernel's 2D contraction takes them.
        for (int i = 0; i < 2; ++i)
          acc[1 + i] += (s_p0[1 + i][s] * wx + s_a[i * 2 + 0][s] * wdx) * wy +
                        (s_a[i * 2 + 1][s] * wx) * wdy;
        for (int f = 3; f < NCH; ++f) acc[f] += (s_p0[f][s] * wx) * wy;
      }
    });
    for (int f = 0; f < NCH; ++f) res[k][f] = acc[f];
  }
  if constexpr (!SORT) {
    for (int k = 0; k < NPASS; ++k)
      for (int f = 0; f < NCH; ++f) img[f * RC + cell[k]] = res[k][f];
    return;
  }
  __syncthreads();  // the slot arrays are consumed: the image takes their place
#pragma unroll
  for (int k = 0; k < NPASS; ++k)
    for (int f = 0; f < NCH; ++f) sh.out[f * RC + cell[k]] = res[k][f];
  __syncthreads();
  for (int e = t; e < NCH * RC; e += C) img[e] = sh.out[e];
}

// ---------------------------------------------------------------------------
// The two merges: window images [D, nf, 8^d] -> the block node table
// [n_rows = MAX_GRID_BLOCKS + 1, nf · 4^d], every row written once (rows
// past num_grid_blocks and the trash row, the last, as zeros). Each reads
// the images where the P2G kernels wrote them: z-major cells in 3D (kernel
// A and the mass P2G, q = z*64 + x*8 + y) or row-major (2D and the sparse
// path, q = x*8 + y (+ z)); corner k of a chunk's window, cx*4 + cy*2 + cz
// in 3D and cx*2 + cy in 2D, covers the cells (cx*4 + lx, cy*4 + ly, cz*4
// + lz), and node-table element f*4^d + l with l = lx*16 + ly*4 + lz (3D)
// or lx*4 + ly (2D).
//
// A node row is one group of nf·4^(d-1) threads, each holding one run of 4
// cells of one channel (16 B aligned in both cell orders: the innermost
// axis of the image, lz row-major or ly z-major, runs 4 cells from cz*4 or
// cy*4), so each thread's sums are 4 independent elements, each summed in
// the same order as a plain loop. A CTA holds a few rows: at least a warp,
// at most 1024 staged floats, and few enough that the grid has about 1024
// CTAs, so that the short tables of the fluid paths still fill the card.
// A CTA first lists its rows' sources in shared memory, with no host read
// (dead rows have none). Two ways to fetch them:
//
// - Loads (the gather form, and the scatter form on tables of about as many
//   rows as chunks): the list holds image offsets (chunk · nf · 8^d plus the
//   corner's origin, which does not depend on the thread's run: the thread
//   adds its own run's offset once), and each thread walks its row's list
//   with MERGE_RING float4 loads in flight, the next offsets read a group
//   ahead (computing each source's address in the walk was slower).
// - Boxes (the scatter form on dense tables, MERGE_DENSE chunk corners a
//   row or more: fluid blocks of up to 34 chunks give rows of ~256
//   sources): a row's updates are runs of consecutive chunks at one corner
//   (an owner block's chunks), and each run of up to MERGE_RUN comes into
//   shared memory as one TMA box (those chunks' corner sub-cubes, all nf
//   channels), issued by the row's threads into a ring of 2·half boxes;
//   while the row adds one half the other is in flight, and each half is
//   refilled after a barrier of the row's threads. There the time is the
//   chain of a row's sources: on fluids3 x4's rows thread loads (16 B a
//   thread) stayed slow whatever their depth (8 or 16 a thread) or width
//   (4, 2 or 1 floats), and a box a source paid the box's fixed cost 256
//   times a row; a box a run of chunks was the fastest of the three.
// The row is staged in shared memory (z-major runs lie across ly, element
// stride 4) and written coalesced. No atomics, so each row is the same sum
// from run to run. Bound on this card: bytes (each live source's sub-cube
// read once, every node row written once); a run of 16 B fills half of its
// 32-byte sector, whose other half is the neighbouring corner's, another
// node row's. A tensor-core form has nothing to do: there is no product,
// only ordered adds.
// ---------------------------------------------------------------------------
constexpr int MERGE_STAGE = 1024;       // floats of node rows a CTA stages
constexpr int MERGE_THREADS = 256;      // a CTA's most threads (4 floats a thread)
constexpr int MERGE_KMAX_MAX = 8;       // the gather form's chunks per owner block
constexpr int MERGE_IDS = 2048;         // sources a CTA lists at a time
constexpr int MERGE_RING = 8;           // loads in flight a thread
constexpr int MERGE_RUN = 8;            // chunks a box holds
constexpr int MERGE_HALF_MAX = 8;       // boxes in half of a row's ring, at most
constexpr int MERGE_ROW_SMEM = 32768;   // bytes of boxes a row holds, about
constexpr int MERGE_BOX_SMEM = 98304;   // bytes of boxes and their barriers a CTA holds
constexpr int MERGE_SEG_END = 1 << 30;  // offset flag: the last source of a segment sum

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Offset of corner k's origin within a chunk's channel image.
template <int D>
__device__ __forceinline__ int merge_corner(int k, bool zm) {
  if (D == 3) {
    const int cx = k >> 2, cy = (k >> 1) & 1, cz = k & 1;
    return zm ? cz * 256 + cx * 32 + cy * 4 : cx * 256 + cy * 32 + cz * 4;
  }
  return (k >> 1) * 32 + (k & 1) * 4;
}

// Offset of unit u's run of 4 cells within corner 0 (0 .. 4^(d-1) - 1),
// and (through `dst`, `step`) where its 4 elements go in the node row's
// channel: z-major u = lz*4 + lx, the run along ly; row-major u = lx*4 +
// ly, the run along lz; 2D u = lx, the run along ly. (A box holds a
// source's run u of channel f as its float4 f · 4^(d-1) + u.)
template <int D>
__device__ __forceinline__ int merge_run(int u, bool zm, int& dst, int& step) {
  if (D == 3) {
    const int a = u >> 2, b = u & 3;
    dst = zm ? b * 16 + a : a * 16 + b * 4;
    step = zm ? 4 : 1;
    return a * 64 + b * 8;
  }
  dst = u * 4;
  step = 1;
  return u * 8;
}

// Loads: sum the sources at offsets[b .. e) (from `base`, the thread's run
// in image 0) into acc in order, MERGE_RING loads in flight and the next
// offsets read a group ahead. SEGMENTS (the gather form): each source adds
// to the segment sum s, from zero, and a flagged source closes it into
// acc; else each source adds to acc.
template <bool SEGMENTS>
__device__ __forceinline__ void merge_walk_loads(const float* __restrict__ base,
                                                 const int* offsets, int b, int e,
                                                 float4& acc) {
  constexpr int RING = MERGE_RING;
  float4 v[RING];
  int cur[RING];
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    cur[j] = b + j < e ? offsets[b + j] : 0;
    if (b + j < e)
      v[j] = __ldg(reinterpret_cast<const float4*>(base + (cur[j] & ~MERGE_SEG_END)));
  }
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int k = b; k < e; k += RING) {
    int nxt[RING];
#pragma unroll
    for (int j = 0; j < RING; ++j) nxt[j] = k + RING + j < e ? offsets[k + RING + j] : 0;
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      if (k + j < e) {
        if (SEGMENTS) {
          add4(s, v[j]);
          if (cur[j] & MERGE_SEG_END) {
            add4(acc, s);
            s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        } else {
          add4(acc, v[j]);
        }
        if (k + RING + j < e)
          v[j] = __ldg(reinterpret_cast<const float4*>(base + (nxt[j] & ~MERGE_SEG_END)));
      }
    }
#pragma unroll
    for (int j = 0; j < RING; ++j) cur[j] = nxt[j];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box: MERGE_RUN chunks' corner sub-cubes (all nf channels), from
// the chunk of `id` (chunk · 2^d + corner) on, into `dst`, completing on
// `bar` (armed here with its bytes). The images' tensor: innermost first
// (y, x, z) z-major, (z, y, x) row-major, (y, x) in 2D; then channel and
// chunk (chunks past the images read as zeros).
template <int D>
__device__ __forceinline__ void merge_box(const CUtensorMap* map, void* dst, uint64_t* bar,
                                          int id, bool zm, int bytes) {
  const int c = id >> D, k = id & ((1 << D) - 1);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (D == 3) {
    const int cx = (k >> 2) * 4, cy = ((k >> 1) & 1) * 4, cz = (k & 1) * 4;
    const int c0 = zm ? cy : cz, c1 = zm ? cx : cy, c2 = zm ? cz : cx;
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(smem_u32(dst)),
        "l"(m), "r"(c0), "r"(c1), "r"(c2), "r"(0), "r"(c), "r"(smem_u32(bar))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
        "l"(m), "r"((k & 1) * 4), "r"((k >> 1) * 4), "r"(0), "r"(c), "r"(smem_u32(bar))
        : "memory");
  }
}

// A CTA row's ring of boxes and their barriers in dynamic shared memory:
// rows × (2·half slots, 2·half + 1 barriers), each row 128-byte aligned, as
// TMA boxes must be.
__host__ __device__ __forceinline__ int merge_row_bytes(int slot_bytes, int half) {
  return ((2 * half * slot_bytes + (2 * half + 1) * 8 + 127) / 128) * 128;
}

struct MergeRow {
  unsigned char* boxes;
  uint64_t* full;   // per slot: its box landed
  uint64_t* round;  // the row's threads done with a half
};

__device__ __forceinline__ MergeRow merge_row(unsigned char* dyn, int r, int slot_bytes,
                                              int half) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 127) & ~(uintptr_t)127);
  base += (size_t)r * merge_row_bytes(slot_bytes, half);
  MergeRow row;
  row.boxes = base;
  row.full = reinterpret_cast<uint64_t*>(base + 2 * half * slot_bytes);
  row.round = row.full + 2 * half;
  return row;
}

// Boxes: sum the row's runs runs[b .. e) (each `id | count << 24`: count
// <= MERGE_RUN sources of consecutive chunks at one corner, from id's) into
// acc (this thread's float4 i of each source in a box; `src_f4` float4s a
// source; the row has `group` threads) in order. q0: the runs the row took
// before (for the slots' phases); `rounds` counts the row's half barriers.
// The row's threads issue the boxes, one each, right after a barrier of
// the row (one issuing thread, its warp-mates waiting on the next box, was
// slower).
template <int D>
__device__ __forceinline__ void merge_walk_boxes(const CUtensorMap* map, const MergeRow& row,
                                                 const int* runs, int b, int e, int q0,
                                                 int& rounds, int i, int group, bool zm,
                                                 int src_f4, int slot_bytes, int half,
                                                 float4& acc) {
  const int ring = 2 * half, n = e - b;
  if (n <= 0) return;
  for (int q = q0 + i; q < q0 + min(ring, n); q += group)
    merge_box<D>(map, row.boxes + (q % ring) * slot_bytes, row.full + q % ring,
                 runs[b + q - q0] & 0xffffff, zm, MERGE_RUN * src_f4 * 16);
  for (int j = 0; j < n; ++j) {
    const int q = q0 + j, s = q % ring;
    mbar_wait(row.full + s, (q / ring) & 1);
    const float4* box = reinterpret_cast<const float4*>(row.boxes + s * slot_bytes) + i;
    const int count = runs[b + j] >> 24;
    for (int c = 0; c < count; ++c) add4(acc, box[c * src_f4]);
    if ((q + 1) % half == 0 || j == n - 1) {
      // The row's threads are done with this half: refill it.
      mbar_arrive(row.round);
      mbar_wait(row.round, rounds & 1);
      ++rounds;
      const int last = min(q + ring, q0 + n - 1);
      for (int qq = max(q - q % half, q0) + ring + i; qq <= last; qq += group)
        merge_box<D>(map, row.boxes + (qq % ring) * slot_bytes, row.full + qq % ring,
                     runs[b + qq - q0] & 0xffffff, zm, MERGE_RUN * src_f4 * 16);
    }
  }
}

// Stage the thread's 4 sums (unit u of channel f of CTA row r) in shared
// memory, then write the CTA's rows [g0, g0 + rows) coalesced.
template <int D>
__device__ __forceinline__ void merge_store(float* stage, const float4& acc, int r, int f, int u,
                                            int nf, bool zm, float* __restrict__ out, int g0,
                                            int rows, int n_rows) {
  constexpr int CPB = D == 3 ? 64 : 16;
  const int w = nf * CPB;
  int dst, step;
  merge_run<D>(u, zm, dst, step);
  float* s = stage + r * w + f * CPB + dst;
  s[0] = acc.x;
  s[step] = acc.y;
  s[2 * step] = acc.z;
  s[3 * step] = acc.w;
  __syncthreads();
  const int n_out = (min(rows, n_rows - g0) * w) >> 2;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x)
    reinterpret_cast<float4*>(out + (size_t)g0 * w)[e] = reinterpret_cast<float4*>(stage)[e];
}

// The gather form (replaces sparkl_tpu/fused/kernels.py:merge_blocks_dma
// and the inverse-corner gather after it, sparkl_tpu/sparse/transfer.py
// _merge_gather): node row g, from zero, adds for k = 0 .. 2^d - 1 the
// owner block b = owner[g, k]'s segment sum s = 0 + the corner-k runs of
// its chunks first[b] + j, j < min(nch[b], kmax), in ascending j (an absent
// owner, b = max_blocks, adds 0, and adding 0 to a sum that is never -0
// changes nothing, so it is left out). Bit-equal to the plain version:
// each element is the same sequence of f32 adds. A row has at most 2^d ·
// kmax sources: loads.
template <int D>
__global__ void __launch_bounds__(MERGE_THREADS) merge_blocks_kernel(
    const float* __restrict__ img, const int* __restrict__ first, const int* __restrict__ nch,
    const int* __restrict__ owner, const int* __restrict__ ngb, float* __restrict__ out,
    int n_rows, int max_blocks, int nf, int rows, int zm, int kmax) {
  constexpr int NC = 1 << D, PLANE = D == 3 ? 16 : 4, RC = D == 3 ? 512 : 64;
  constexpr int PER_ROW = NC * MERGE_KMAX_MAX;
  __shared__ int offsets[MERGE_IDS];  // per CTA row, its sources (PER_ROW apart)
  __shared__ int2 src[256];           // per CTA row and corner: (first chunk, count)
  __shared__ int count[64];           // per CTA row: its sources
  __shared__ __align__(16) float stage[MERGE_STAGE];
  const int group = nf * PLANE;
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * rows;
  const int live = min(*ngb, n_rows - 1);
  const int cstride = nf * RC;
  for (int e = t; e < rows * NC; e += blockDim.x) {
    const int g = g0 + e / NC;
    int2 m = make_int2(0, 0);
    if (g < live) {
      const int b = owner[(size_t)g * NC + e % NC];
      if (b >= 0 && b < max_blocks) m = make_int2(first[b], min(nch[b], kmax));
    }
    src[e] = m;
  }
  __syncthreads();
  if (t < rows) {
    int n = 0;
    for (int k = 0; k < NC; ++k) {
      const int2 m = src[t * NC + k];
      const int corner = merge_corner<D>(k, zm != 0);
      for (int j = 0; j < m.y; ++j)
        offsets[t * PER_ROW + n++] =
            ((m.x + j) * cstride + corner) | (j == m.y - 1 ? MERGE_SEG_END : 0);
    }
    count[t] = n;
  }
  __syncthreads();
  const int r = t / group, i = t % group;
  const int f = i / PLANE, u = i % PLANE;
  int dst, step;
  const float* base = img + f * RC + merge_run<D>(u, zm != 0, dst, step);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  merge_walk_loads<true>(base, offsets, r * PER_ROW, r * PER_ROW + count[r], acc);
  merge_store<D>(stage, acc, r, f, u, nf, zm != 0, out, g0, rows, n_rows);
}

// The scatter form (replaces the XLA scatter-add of
// sparkl_tpu/sparse/transfer.py:_merge_scatter, glue, not a TPU kernel):
// node row g adds, from zero, its updates order[k], k in [starts[g],
// starts[g + 1]) ascending, update id = chunk · 2^d + corner (the flat
// (chunk, corner) ids stably sorted by destination row, so each row sums
// in ascending update order: the JAX package's CPU scatter-add order). The
// CTA's rows' updates are one range of `order`, listed MERGE_IDS at a time,
// as image offsets (loads) or ids (BOXES; `map` the images' tensor).
template <int D, bool BOXES>
__global__ void __launch_bounds__(MERGE_THREADS) merge_scatter_kernel(
    const __grid_constant__ CUtensorMap map, const float* __restrict__ img,
    const int* __restrict__ order, const int* __restrict__ starts, const int* __restrict__ ngb,
    float* __restrict__ out, int n_rows, int nf, int rows, int zm, int slot_bytes, int half) {
  constexpr int NC = 1 << D, PLANE = D == 3 ? 16 : 4, RC = D == 3 ? 512 : 64;
  extern __shared__ unsigned char dyn[];
  __shared__ int list[MERGE_IDS];
  __shared__ int nruns[64];  // BOXES: per CTA row, its runs in this window
  __shared__ __align__(16) float stage[MERGE_STAGE];
  const int group = nf * PLANE;
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * rows;
  const int live = min(*ngb, n_rows - 1);
  const int cstride = nf * RC;
  const int r = t / group, i = t % group;
  const int f = i / PLANE, u = i % PLANE;
  const int g = g0 + r;
  int dst, step;
  const float* base = img + f * RC + merge_run<D>(u, zm != 0, dst, step);
  MergeRow row;
  if (BOXES) {
    row = merge_row(dyn, r, slot_bytes, half);
    if (i == 0) {
      for (int s = 0; s < 2 * half; ++s) mbar_init(row.full + s, 1);
      mbar_init(row.round, group);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // The CTA's updates [lo, hi) and this thread's row's [b, e) within them.
  const int lo = g0 < live ? starts[g0] : 0;
  const int hi = g0 < live ? starts[min(g0 + rows, live)] : 0;
  const bool mine = g < live;
  const int b = mine ? starts[g] : 0, e = mine ? starts[g + 1] : 0;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int rounds = 0, taken = 0;
  for (int w0 = lo; w0 < hi; w0 += MERGE_IDS) {
    const int n = min(MERGE_IDS, hi - w0);
    __syncthreads();  // the barriers' init, or the last window's reads
    for (int k = t; k < n; k += blockDim.x) {
      const int id = __ldg(order + w0 + k);
      list[k] = BOXES ? id : (id >> D) * cstride + merge_corner<D>(id & (NC - 1), zm != 0);
    }
    __syncthreads();
    const int wb = max(b - w0, 0), we = min(e - w0, n);
    if (BOXES) {
      // The row's updates as runs of consecutive chunks at one corner (an
      // owner block's chunks, in order), in place, by its first thread.
      if (i == 0) {
        int w = wb;
        for (int j = wb; j < we;) {
          const int id = list[j];
          int c = 1;
          while (j + c < we && c < MERGE_RUN && list[j + c] == id + c * NC) ++c;
          list[w++] = id | (c << 24);
          j += c;
        }
        nruns[r] = w - wb;
      }
      __syncthreads();
      const int m = we > wb ? nruns[r] : 0;
      merge_walk_boxes<D>(&map, row, list, wb, wb + m, taken, rounds, i, group, zm != 0,
                          cstride / (D == 3 ? 32 : 16), slot_bytes, half, acc);
      taken += m;
    } else {
      merge_walk_loads<false>(base, list, wb, we, acc);
    }
  }
  merge_store<D>(stage, acc, r, f, u, nf, zm != 0, out, g0, rows, n_rows);
}

// ---------------------------------------------------------------------------
// Mass P2G (fluid volume pass): the chunk's 8^d mass image, kernel A's
// walk with one channel (csrc/scatter_walk.cuh), a template on the
// dimension and chunk size like A. One C-thread CTA per chunk. Each
// contributing slot stores, per axis, its 3 tap weights at their window
// coordinates (rows of 8), and on the axis whose weight the JAX kernel's
// factored product takes first (z in 3D, x in 2D) the products m·w in
// their place; the warps' ballots build the axis masks of the contributing
// lanes. Each thread then walks the set lanes of its cells' masks (4 of 512
// in 3D, 1 of 64 in 2D) in ascending lane order and adds the JAX kernel's
// product, (m wz)(wx wy) in 3D (z-major cells, q = z*64 + x*8 + y), (m wx)
// wy in 2D (row-major, q = x*8 + y): each cell is the same left fold over
// the same terms as a loop over all C slots, so the image is run-to-run
// deterministic and bit-equal to the plain version's lane-major scatter on
// the CPU. No atomics on floats. In 3D the cells go out sorted by hit count
// and the image is staged in shared memory (over the consumed slot arrays)
// and written coalesced: 2.5x faster than handing thread t cells t + k·C
// (0.1106 against 0.2798 ms on fluids3 x4, NVIDIA H100, with an earlier
// form of this walk, before the m·w rows). Dead chunks write
// zeros. Bound on this card: the slot prologue (d + 1 rows and d + 2 int
// rows of 4C B, coalesced) and the walk's issue (27·C hits a CTA at most, a
// warp paying for its busiest lane).
// ---------------------------------------------------------------------------

template <int D, int C>
union MassShared {
  static constexpr int SC = sparkl_walk::slot_cols<C>();
  struct {
    float mw[8][SC];        // per window coordinate of the first axis: m·w
    float w[D - 1][8][SC];  // the other axes' tap weights (x, y in 3D; y in 2D)
  } in;
  float out[region_cells<D>()];  // the image, once the slot arrays are consumed (3D)
};

template <int D, int C>
__global__ void __launch_bounds__(C) mass_p2g_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ nchunks, float* __restrict__ out, GridArgs g) {
  using R = Rows<D>;
  constexpr int RC = region_cells<D>();
  constexpr int NW = C / 32;
  constexpr int NPASS = RC / C;  // cells per thread
  constexpr bool SORT = NPASS > 1;
  constexpr int FIRST = D == 3 ? 2 : 0;  // the axis of the m·w rows
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  float* img = out + (size_t)chunk * RC;
  if (chunk >= *nchunks) {
    for (int e = t; e < RC; e += C) img[e] = 0.0f;
    return;
  }
  __shared__ MassShared<D, C> sh;
  __shared__ unsigned s_rng[D * 8 * NW];
  __shared__ int s_bin[SORT ? C + 1 : 1];
  __shared__ unsigned short s_list[SORT ? RC : 1];

  const float* S = slots + (size_t)chunk * R::NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
  const int ts = sparkl_walk::slot_col(t);
  int rel[D];
  float fx[D];
  const bool contrib = slot_transfer<D, C>(g, S, I, t, rel, fx);
  const float m_c = S[R::MASS * C + t] * (contrib ? 1.0f : 0.0f);
  if (contrib)
    for (int ax = 0; ax < D; ++ax) {
      float w[3];
      quadratic_weights(fx[ax], w);
      for (int k = 0; k < 3; ++k) {
        if (ax == FIRST)
          sh.in.mw[rel[ax] + k][ts] = m_c * w[k];
        else
          sh.in.w[ax - (ax > FIRST)][rel[ax] + k][ts] = w[k];
      }
    }
  sparkl_walk::axis_masks<D, C>(contrib, rel, s_rng);
  if constexpr (SORT) sparkl_walk::clear_bins<C>(s_bin);
  __syncthreads();
  if constexpr (SORT) {
    int hits[NPASS];
    for (int k = 0; k < NPASS; ++k) {
      int x, y, z;
      cell_coords<D>(t + k * C, x, y, z);
      unsigned mk[NW];
      sparkl_walk::cell_mask<D, C>(s_rng, x, y, z, mk);
      hits[k] = sparkl_walk::popcount<C>(mk);
    }
    sparkl_walk::sort_cells<C, NPASS>(hits, s_bin, s_list);
  }
  float res[NPASS];
  int cell[NPASS];
#pragma unroll
  for (int k = 0; k < NPASS; ++k) {
    const int q = SORT ? s_list[t + k * C] : t + k * C;
    int x, y, z;
    cell_coords<D>(q, x, y, z);
    unsigned mk[NW];
    sparkl_walk::cell_mask<D, C>(s_rng, x, y, z, mk);
    float acc = 0.0f;
    if constexpr (D == 3) {
      const float *mz = sh.in.mw[z], *wx = sh.in.w[0][x], *wy = sh.in.w[1][y];
      sparkl_walk::walk<C>(mk, [&](int s) { acc += mz[s] * (wx[s] * wy[s]); });
    } else {
      const float *mx = sh.in.mw[x], *wy = sh.in.w[0][y];
      sparkl_walk::walk<C>(mk, [&](int s) { acc += mx[s] * wy[s]; });
    }
    res[k] = acc;
    cell[k] = q;
  }
  if constexpr (!SORT) {
    for (int k = 0; k < NPASS; ++k) img[cell[k]] = res[k];
    return;
  }
  __syncthreads();  // the slot arrays are consumed: the image takes their place
  for (int k = 0; k < NPASS; ++k) sh.out[cell[k]] = res[k];
  __syncthreads();
  for (int e = t; e < RC; e += C) img[e] = sh.out[e];
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
// + k], 0 outside the two rows: the destination chunk's slice of the sorted
// order. The TPU kernel routes lanes with two one-hot f32 selection matmuls
// per chunk, exact only below 2^24 slots; this one copies int32, so it has
// no such limit. Bound on this card: 12 B a lane (8 read, 4 written), a few
// microseconds at the main paths' sizes, so the launch and two dependent
// memory latencies (the shift, then the row it selects) set its time. So a
// block of 256 threads takes 256 / (C/4) chunks (8 at C = 128, 16 at C =
// 64; C/4 threads a chunk, four output lanes a thread), and every thread
// issues all its loads at once: its int4 of each of the chunk's two order
// rows (16-byte aligned: the wrapper checks it) and the chunk's shift. The
// chunk's 2C order ints then sit in shared memory, where the shift routes
// them (the counterpart of the selection matmuls), and each thread stores
// one int4 of the output row.
// ---------------------------------------------------------------------------
constexpr int SRC_ROWS_THREADS = 256;

template <int C>
__global__ void __launch_bounds__(SRC_ROWS_THREADS) src_rows_kernel(
    const int* __restrict__ order2, const int* __restrict__ shifts, int* __restrict__ out,
    int max_chunks) {
  constexpr int Q = C / 4;                          // threads (int4s) a chunk
  constexpr int PER_BLOCK = SRC_ROWS_THREADS / Q;   // chunks a block
  __shared__ int4 rows[PER_BLOCK][2 * Q];
  const int local = threadIdx.x / Q, q = threadIdx.x % Q;
  const int i = blockIdx.x * PER_BLOCK + local;
  const bool live = i < max_chunks;
  int4 a = make_int4(0, 0, 0, 0), b = a;
  int shift = 0;
  if (live) {
    const int4* src = reinterpret_cast<const int4*>(order2) + (size_t)i * 2 * Q;
    a = src[q];
    b = src[Q + q];
    shift = shifts[i];
  }
  rows[local][q] = a;
  rows[local][Q + q] = b;
  __syncthreads();
  if (!live) return;
  const int* r = reinterpret_cast<const int*>(rows[local]);
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long j = (long long)shift + 4 * q + k;
    v[k] = (j >= 0 && j < 2 * C) ? r[j] : 0;
  }
  reinterpret_cast<int4*>(out)[(size_t)i * Q + q] = make_int4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// Resort permute: destination slot (chunk d, lane l) takes every row of
// source slot src[d, l] (flat chunk * C + lane; -1 leaves it zero); the
// drift row is zeroed and the window-origin rows are written from the new
// structure, as the TPU kernel finalizes them. The TPU kernel fetches at
// most K = 8 whole source chunks per destination by DMA and routes lanes
// among them with selection matmuls, so its package falls back to a
// per-slot gather past K; here each lane copies its own source slot, as
// 32-bit words, with no K limit and bit-exact.
//
// Bound on this card: bytes, (NF + NI) words a slot read and written. A
// lane's rows lie 4C B apart in its source chunk, and lanes of one
// destination mostly read neighbouring lanes of a few source chunks (the
// sort is stable), so a warp's read of one row coalesces into a few
// segments and every write is a full row. What limits it is the bytes in
// flight: a block is C lanes x PERMUTE_GROUPS row groups (512 threads in
// 3D, 256 in 2D), group g takes rows g, g + G, ... of the slot's NF + NI,
// and NF is a template parameter, so each thread's 16 (3D) or 12 (2D) loads
// unroll and all issue before its first store. The source index is read
// once a lane, into shared memory. TMA and cp.async do not fit: they copy
// tiles, and each lane here gathers its own column with a 4C-byte stride.
// ---------------------------------------------------------------------------
constexpr int PERMUTE_GROUPS = 4;

template <int NF_, int C, int DIM>
__global__ void __launch_bounds__(C * PERMUTE_GROUPS) permute_slots_kernel(
    const unsigned* __restrict__ slots, const unsigned* __restrict__ ints,
    const int* __restrict__ src, const int* __restrict__ origin,
    unsigned* __restrict__ out_f, unsigned* __restrict__ out_i, int max_chunks, int r_cumd) {
  constexpr int ROWS = NF_ + NI;
  constexpr int PER = ROWS / PERMUTE_GROUPS;
  static_assert(ROWS % PERMUTE_GROUPS == 0, "rows split evenly among the groups");
  __shared__ int s_src[C];
  const int d = blockIdx.x;
  const int lane = threadIdx.x % C;
  const int g = threadIdx.x / C;
  if (g == 0) s_src[lane] = src[(size_t)d * C + lane];
  __syncthreads();
  const int s = s_src[lane];
  const bool ok = s >= 0 && (long long)s < (long long)max_chunks * C;
  const size_t cid = ok ? (size_t)(s / C) : 0;
  const int sl = ok ? s % C : 0;
  const unsigned* S = slots + cid * NF_ * C + sl;
  const unsigned* I = ints + cid * NI * C + sl;
  unsigned v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int f = g + k * PERMUTE_GROUPS;
    const bool copy = ok && f != r_cumd &&
                      !(f >= NF_ + I_ORIGIN && f < NF_ + I_ORIGIN + DIM);
    v[k] = copy ? (f < NF_ ? S[f * C] : I[(f - NF_) * C]) : 0u;
  }
  unsigned* OF = out_f + (size_t)d * NF_ * C + lane;
  unsigned* OI = out_i + (size_t)d * NI * C + lane;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int f = g + k * PERMUTE_GROUPS;
    if (f < NF_) {
      OF[f * C] = v[k];
    } else {
      const int r = f - NF_;
      OI[r * C] = (r >= I_ORIGIN && r < I_ORIGIN + DIM)
                      ? (unsigned)origin[(size_t)d * DIM + r - I_ORIGIN] : v[k];
    }
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
// registers. The MATS instance (neo-Hookean or NACC present, or Rankine or
// Snow in 3D) compiles NACC (sparkl_tpu/fused/kernels.py:1377, with the
// nacc row), neo-Hookean's energy, cached or failure stress and dt bound
// (closed form, no SVD: its slots skip the final decomposition), and in 3D
// Rankine and Snow; the instances without it are the code of the scenes
// that need none of these. Each lane runs its own model's one return map,
// in the JAX order (Drucker-Prager, NACC, Rankine, Snow).
//
// EOS fluid slots (branch per slot on the model's type) update only J
// = F00 by tr(grad v), take no SVD and no return map, skip the |F00|
// blowup guard (the det = 0 guard stays), bound dt with the EOS bound and
// write zero stress-cache rows: kernel A forms their stress fresh.
//
// One C-thread CTA per chunk, reading the node table directly: the
// prologue copies the chunk's 2^d corner blocks' rows of the window-field
// table (fields [MAX_GRID_BLOCKS + 1, n_win · 4^d]: the velocity channels
// and the psi ratio, one row a block; `corners` [D, 2^d] the chunk's rows,
// built once per structure) into shared memory by 16-byte cp.async copies
// (3D 8 × 3 × 64 f32, 6 KB, 8 KB with psi; 2D 4 × 2 × 16), kept block-major:
// window cell (x, y, z) is corner block (x>>2, y>>2, z>>2) at its cell
// (x&3, y&3, z&3) (sparkl_tpu_torch/sparse/blocks.py region_maps), so no
// window tensor is formed anywhere. The lane's ints and slot rows are
// loaded while the copies fly. Each thread then gathers its 3^d nodes (3D:
// per z tap the xy sheet first; 2D: per x tap the y taps first, the JAX
// kernel's contraction orders; only the addresses differ from a gathered
// window's) and runs the particle physics in registers
// (particle_physics.cuh).
//
// Each warp moves only the slot rows its lanes need: the row table
// SPARKL_B_ROWS below says, per field, which lane classes read it for their
// physics and which can change it. A warp ORs its lanes' classes (one warp
// reduction; after the physics the broken guard by one vote), loads a row
// where some lane reads it or may change it, and stores a row where some
// lane may change it. A row that no lane of the warp may change is one the
// kernel would write back as the bits it read, so leaving it is bit-equal,
// on live and empty lanes alike; rows the kernel computes (psi_pos, par1,
// par2, the stress rows and their zeros, the padding's zeros) are written
// on every lane. Each thread reads every row of its own slot that it
// writes, and no thread touches another lane, so the in-place update is
// safe. Dead chunks (>= num_chunks) return untouched.
//
// The FLUID instance (every model of the table the EOS fluid, no damage, no
// materials) compiles the fluid branch alone: no SVD, no return map (3D
// 117 registers against 122; 7% faster on a 2D fluid column, 1% in 3D).
// It runs every lane as a fluid, so it takes model ids within the table.
// Capping the registers for 5 or 6 CTAs an SM (__launch_bounds__(C, 5),
// (C, 6)) spills in 3D and is slower on every 3D solid state.
//
// Bound on this card: the slot rows a warp must move (3D sand3: 22 f32
// rows read and 42 written of a slot's 56; an EOS lane 17 and 31) and
// per-thread arithmetic and registers (in 3D one
// Cardano SVD and ~3 transcendental DP steps; a NACC, Rankine or Snow lane
// two SVDs, logs and exps; a neo-Hookean lane no SVD) at one CTA per chunk.
// Lanes of different models in one warp take their branches in turn: the
// slots are sorted by space, so the warps that straddle two models are the
// band edges.
// ---------------------------------------------------------------------------

// Lane classes of kernel B's row table (a lane's bits: LC_ALL, its model's
// constitutive and plastic types, its flags, the instance's trips).
constexpr int LC_NONE = 0;
constexpr int LC_ALL = 1;          // every lane
constexpr int LC_SOLID = 2;        // constitutive type not the EOS fluid
constexpr int LC_BROKEN = 4;       // the failure guard broke (det F = 0, failed, |F00|)
constexpr int LC_DP = 8;           // plastic type Drucker-Prager
constexpr int LC_NACC = 16;        // plastic type NACC
constexpr int LC_RANKINE = 32;     // plastic type Rankine
constexpr int LC_SNOW = 64;        // plastic type Snow
constexpr int LC_TRIP = 128;       // DAMAGE instance: modified, or maximum-stress failure
constexpr int LC_KINEMATIC = 256;  // the kinematic flag
constexpr int LC_MODIFIED = 512;   // DAMAGE instance under modified eigenerosion

// Kernel B's row table: X(field, the classes that read it, the classes
// whose physics can change it). sparkl_tpu_torch/fused/kernels.py B_ROWS
// holds the same table (the CPU tests parse this one against it and hold
// it to the plain version's outputs). DEFGRAD_J is F00 (a fluid's J),
// DEFGRAD_OFF the other d² - 1 entries of F, PAD the rows past the stress.
#define SPARKL_B_ROWS(X)                              \
  X(POS, LC_ALL, LC_ALL)                              \
  X(VEL, LC_NONE, LC_ALL)                             \
  X(GRAD, LC_NONE, LC_ALL)                            \
  X(DEFGRAD_J, LC_ALL, LC_ALL)                        \
  X(DEFGRAD_OFF, LC_ALL, LC_SOLID | LC_BROKEN)        \
  X(MASS, LC_ALL, LC_NONE)                            \
  X(VOL0, LC_ALL, LC_NONE)                            \
  X(PHASE, LC_SOLID | LC_MODIFIED, LC_TRIP)           \
  X(PSI_POS, LC_ALL, LC_ALL)                          \
  X(PDD, LC_DP | LC_SNOW, LC_DP | LC_SNOW)            \
  X(PH, LC_DP | LC_RANKINE, LC_DP | LC_RANKINE)       \
  X(EH, LC_SOLID, LC_SNOW)                            \
  X(LVG, LC_DP, LC_DP)                                \
  X(NACC, LC_NACC, LC_NACC)                           \
  X(KINVEL, LC_KINEMATIC, LC_NONE)                    \
  X(CPF, LC_MODIFIED, LC_NONE)                        \
  X(CTHR, LC_MODIFIED, LC_NONE)                       \
  X(DTB, LC_NONE, LC_ALL)                             \
  X(FAILED, LC_ALL, LC_ALL)                           \
  X(RADIUS0, LC_NONE, LC_NONE)                        \
  X(PAR1, LC_NONE, LC_ALL)                            \
  X(PAR2, LC_NONE, LC_ALL)                            \
  X(MC, LC_NONE, LC_NONE)                             \
  X(G, LC_NONE, LC_NONE)                              \
  X(DEBUG, LC_NONE, LC_NONE)                          \
  X(CUMD, LC_ALL, LC_ALL)                             \
  X(STRESS, LC_NONE, LC_ALL)                          \
  X(PAD, LC_NONE, LC_ALL)

enum BField {
#define SPARKL_X(name, r, w) BF_##name,
  SPARKL_B_ROWS(SPARKL_X)
#undef SPARKL_X
  BF_COUNT
};

__host__ __device__ constexpr int b_readers(int f) {
#define SPARKL_X(name, r, w) f == BF_##name ? (r) :
  return SPARKL_B_ROWS(SPARKL_X) LC_NONE;
#undef SPARKL_X
}
__host__ __device__ constexpr int b_writers(int f) {
#define SPARKL_X(name, r, w) f == BF_##name ? (w) :
  return SPARKL_B_ROWS(SPARKL_X) LC_NONE;
#undef SPARKL_X
}
// The classes for which a row is loaded: its readers, and its writers where
// not every lane writes it (such a row is read, changed on some lanes and
// written back whole; a row every lane writes is computed whole or read by
// every lane). The broken guard is known only after the physics, so a row
// it changes must be read by every lane.
__host__ __device__ constexpr int b_loaders(int f) {
  return b_readers(f) | (b_writers(f) == LC_ALL ? LC_NONE : b_writers(f) & ~LC_BROKEN);
}
__host__ __device__ constexpr bool b_table_ok() {
  for (int f = 0; f < BF_COUNT; ++f) {
    if ((b_writers(f) & LC_BROKEN) && b_readers(f) != LC_ALL) return false;
    if ((b_writers(f) & LC_ALL) && b_writers(f) != LC_ALL) return false;
  }
  return true;
}
static_assert(b_table_ok(), "kernel B's row table: a row the guard changes is read by all");

template <int DIM, int C, bool DAMAGE, bool MATS, bool FLUID>
__global__ void __launch_bounds__(C) g2p_fused_kernel(
    float* __restrict__ slots, const int* __restrict__ ints, const float* __restrict__ fields,
    const int* __restrict__ corners, const int* __restrict__ nchunks,
    const float* __restrict__ tab_f, const int* __restrict__ tab_i, int m_count, float dt,
    GridArgs g, int n_win, int opts) {
  static_assert(!(FLUID && (DAMAGE || MATS)), "the fluid instance has no damage or materials");
  using R = Rows<DIM>;
  constexpr int NW = DIM + (DAMAGE ? 1 : 0);  // window channels read
  constexpr int CPB = DIM == 3 ? 64 : 16;     // cells of a block
  constexpr int NCORNER = 1 << DIM;
  constexpr int WSTRIDE = NW * CPB;  // a corner block's channels in shared memory
  const int chunk = blockIdx.x;
  if (chunk >= *nchunks) return;
  const int t = threadIdx.x;
  const bool stress_cache = (opts & OPT_STRESS_CACHE) != 0;
  const bool svd_reuse = (opts & OPT_SVD_REUSE) != 0;
  // The psi channel is read only for the modified trip.
  const bool modified = DAMAGE && (opts & OPT_MODIFIED) != 0 && n_win > DIM;

  // --- prologue: the corner blocks' rows, asynchronously ---
  __shared__ __align__(16) float win[NCORNER * WSTRIDE];
  {
    const int pieces = (modified ? DIM + 1 : DIM) * CPB / 4;  // 16-byte pieces a corner
    const int* K = corners + (size_t)chunk * NCORNER;
    for (int e = t; e < NCORNER * pieces; e += C) {
      const int k = e / pieces, o = e - k * pieces;
      cp_async16(win + k * WSTRIDE + 4 * o, fields + (size_t)K[k] * n_win * CPB + 4 * o);
    }
    cp_async_commit();
  }

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
  const bool fluid = FLUID || ti[0] == EOS_MONAGHAN_SPH;

  // The warp's lane classes (the row table's columns).
  int cls = LC_ALL | (fluid ? LC_NONE : LC_SOLID) | (kinematic ? LC_KINEMATIC : LC_NONE);
  if (!FLUID)
    cls |= ti[1] == DRUCKER_PRAGER ? LC_DP
           : ti[1] == NACC         ? LC_NACC
           : ti[1] == RANKINE      ? LC_RANKINE
           : ti[1] == SNOW         ? LC_SNOW
                                   : LC_NONE;
  if (DAMAGE && (modified || ti[2] == MAXIMUM_STRESS)) cls |= LC_TRIP;
  if (modified) cls |= LC_MODIFIED;
  unsigned wcls = __reduce_or_sync(0xffffffffu, (unsigned)cls);
#define LOAD(f, k) ((b_loaders(BF_##f) & wcls) != 0u ? SROW(k) : 0.0f)

  float pos[DIM];
  for (int ax = 0; ax < DIM; ++ax) pos[ax] = SROW(R::POS + ax);
  int rel[DIM];
  float fx[DIM];
  const bool contrib = slot_transfer<DIM, C>(g, S, I, t, rel, fx);

  // --- the slot rows, loaded while the copies fly ---
  float phase = LOAD(PHASE, R::PHASE);
  const bool failed = SROW(R::FAILED) != 0.0f;
  const float mass = SROW(R::MASS);
  const float vol0 = SROW(R::VOL0);
  float eh = LOAD(EH, R::EH);
  float ph = LOAD(PH, R::PH);
  float pdd = LOAD(PDD, R::PDD);
  float lvg = LOAD(LVG, R::LVG);
  float nacc = LOAD(NACC, R::NACC);
  float psi_pos = SROW(R::PSI_POS);
  float f[DIM][DIM];
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) f[i][j] = SROW(R::DEFGRAD + i * DIM + j);
  float kin[DIM];
  for (int ax = 0; ax < DIM; ++ax) kin[ax] = LOAD(KINVEL, R::KINVEL + ax);
  const float cpf = LOAD(CPF, R::CPF), cthr = LOAD(CTHR, R::CTHR);
  const float cumd0 = SROW(R::CUMD);
#undef LOAD

  cp_async_wait_all();
  __syncthreads();

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
    // Per axis and tap, the shared-memory offset of its window coordinate
    // v: the corner block's part (v >> 2) and the cell's (v & 3).
    int off[DIM][3];
    for (int k = 0; k < 3; ++k) {
      if constexpr (DIM == 3) {
        const int x = rel[0] + k, y = rel[1] + k, z = rel[2] + k;
        off[0][k] = (x >> 2) * 4 * WSTRIDE + (x & 3) * 16;
        off[1][k] = (y >> 2) * 2 * WSTRIDE + (y & 3) * 4;
        off[2][k] = (z >> 2) * WSTRIDE + (z & 3);
      } else {
        const int x = rel[0] + k, y = rel[1] + k;
        off[0][k] = (x >> 2) * 2 * WSTRIDE + (x & 3) * 4;
        off[1][k] = (y >> 2) * WSTRIDE + (y & 3);
      }
    }
    if constexpr (DIM == 3) {
      float sv[3] = {0.0f, 0.0f, 0.0f}, sgx[3] = {0.0f, 0.0f, 0.0f},
            sgy[3] = {0.0f, 0.0f, 0.0f}, sgz[3] = {0.0f, 0.0f, 0.0f};
      for (int c = 0; c < 3; ++c) {
        float tv[3] = {0.0f, 0.0f, 0.0f}, tx[3] = {0.0f, 0.0f, 0.0f},
              ty[3] = {0.0f, 0.0f, 0.0f};
        [[maybe_unused]] float tp = 0.0f;
        for (int a = 0; a < 3; ++a) {
          for (int b = 0; b < 3; ++b) {
            const int q = off[2][c] + off[0][a] + off[1][b];
            const float wxy = w[0][a] * w[1][b];
            const float wdx_y = (w[0][a] * dpt[0][a]) * w[1][b];
            const float wx_dy = w[0][a] * (w[1][b] * dpt[1][b]);
            for (int i = 0; i < 3; ++i) {
              const float v = win[q + i * CPB];
              tv[i] += v * wxy;
              tx[i] += v * wdx_y;
              ty[i] += v * wx_dy;
            }
            if constexpr (DAMAGE)
              if (modified) tp += win[q + 3 * CPB] * wxy;
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
        for (int i = 0; i < 2; ++i) {
          float tv = 0.0f, ty = 0.0f;
          for (int b = 0; b < 3; ++b) {
            const float v = win[off[0][a] + i * CPB + off[1][b]];
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
            for (int b = 0; b < 3; ++b) tp += win[off[0][a] + 2 * CPB + off[1][b]] * w[1][b];
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
    if constexpr (MATS) {
      if (ti[1] == NACC) sparkl::nacc_update<DIM>(tf + 4, fnew, nacc);
    }
    // Rankine and Snow: every 2D instance, and in 3D the MATS one (the 3D
    // instance without it leaves them out and keeps its registers).
    if constexpr (DIM == 2 || MATS) {
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
  if (__any_sync(0xffffffffu, broken)) wcls |= LC_BROKEN;
  // Without SVD reuse: one SVD of the final F serves the energy and the
  // cached or the failure stress (the JAX kernel decomposes the same F for
  // each). Neo-Hookean slots need none.
  const bool corot = !FLUID && ti[0] == COROTATED;
  const bool neo = MATS && ti[0] == NEO_HOOKEAN;
  if (!svd_reuse && !fluid && !neo) sparkl::svd(fnew, u, s, v);

  const float lam = tf[0], mu = tf[1], cfl = tf[2], split = tf[3];
  float energy = corot ? sparkl::corotated_pos_energy<DIM>(lam, mu, eh, fnew, s) : 0.0f;
  if constexpr (MATS) {
    if (neo) energy = sparkl::neo_hookean_pos_energy<DIM>(lam, mu, phase, eh, fnew);
  }
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
      if constexpr (MATS) {
        if (neo) sparkl::neo_hookean_stress<DIM>(lam, mu, phase, eh, fnew, st);
      }
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
  if (corot || neo) {
    // Corotated and neo-Hookean alike. lam + 2 mu / 3 as jitted XLA forms
    // it: mu f32(2/3) contracted into one FMA (an explicit fmaf: the build
    // does not contract).
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
  if constexpr (MATS) {
    if (stress_cache && neo) sparkl::neo_hookean_stress<DIM>(lam, mu, phase, eh, fnew, st);
  }

  // --- write the rows some lane of the warp may change (each read above) ---
#define STORES(f) ((b_writers(BF_##f) & wcls) != 0u)
  for (int ax = 0; ax < DIM; ++ax) {
    SROW(R::POS + ax) = npos[ax];
    SROW(R::VEL + ax) = vel[ax];
  }
  for (int i = 0; i < DIM; ++i)
    for (int j = 0; j < DIM; ++j) SROW(R::GRAD + i * DIM + j) = gm[i][j];
  SROW(R::DEFGRAD) = fnew[0][0];
  if (STORES(DEFGRAD_OFF))
    for (int e = 1; e < DIM * DIM; ++e) SROW(R::DEFGRAD + e) = fnew[e / DIM][e % DIM];
  if (STORES(PHASE)) SROW(R::PHASE) = phase;
  SROW(R::PSI_POS) = psi_pos;
  if (STORES(PDD)) SROW(R::PDD) = pdd;
  if (STORES(PH)) SROW(R::PH) = ph;
  if (STORES(EH)) SROW(R::EH) = eh;
  if (STORES(LVG)) SROW(R::LVG) = lvg;
  if (STORES(NACC)) SROW(R::NACC) = nacc;
  SROW(R::DTB) = bound;
  SROW(R::FAILED) = failed_new ? 1.0f : 0.0f;
  SROW(R::PAR1) = par1;
  SROW(R::PAR2) = par2;
  SROW(R::CUMD) = cumd;
  int k = 0;
  for (int i = 0; i < DIM; ++i)
    for (int j = i; j < DIM; ++j) SROW(R::STRESS + k++) = sparkl::clampf(st[i][j], -BIGF, BIGF);
  for (int r = R::STRESS + R::NSTRESS; r < R::NF; ++r) SROW(r) = 0.0f;
#undef STORES
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
// and forms each [C, C] distance tile on the vector unit. Here two kernels
// in one launcher call. eigen_box_kernel writes, per 32-lane group of every
// chunk, the bounding box of its eligible lanes' positions (NaN positions
// left out: they pair with nothing), [D, C/32, 8] (lo xyz·, hi xyz·;
// +inf/-inf for none). eigen_pool_kernel runs one C-thread CTA per chunk,
// one thread per own lane, and does only the work that can find a pair:
//   - a chunk with no eligible lane writes zeros and stages nothing;
//   - a candidate is kept only where some (own group, candidate group)
//     pair of boxes lies within r2, and a warp tests only the candidate's
//     groups near its own box. The box gap is formed per axis with the
//     pair test's f32 operations in its order (candidate minus own, the
//     square, the sum over axes); rounding is monotone, so the gap² is
//     never more than any of the boxes' pairs' d2, and a culled group holds
//     no pair: it would have added +0.0 (the sums never reach -0.0);
//   - the kept candidates' d + 3 rows are staged by cp.async into two
//     shared-memory stages, the next one loading while this one is tested.
// Each thread walks its kept lanes in ascending order, summing per
// candidate and then the candidates in ascending order (the TPU kernel's
// loop order), so two runs are bit-equal and equal to the walk over every
// candidate. With `work` set, it also counts (integer atomics) the chunks
// skipped, the candidates kept and the pair tests run.
// Bound on this card: operations, the pair tests of the kept groups (~10
// flops each, at C threads per CTA); the bytes are each chunk's 8 rows,
// the boxes and the kept candidates' d + 3 rows (from L2).
// ---------------------------------------------------------------------------
constexpr int EIG_ROWS = 8;
constexpr int EIG_BOX = 8;  // floats per group box: lo x, y, z, 0, hi x, y, z, 0
constexpr int EIG_BOX_WARPS = 4;

template <int DIM, int C>
__global__ void __launch_bounds__(32 * EIG_BOX_WARPS) eigen_box_kernel(
    const float* __restrict__ e, float* __restrict__ boxes, int n_groups) {
  constexpr int G = C / 32;
  const int gid = blockIdx.x * EIG_BOX_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gid >= n_groups) return;
  const float* E = e + (size_t)(gid / G) * EIG_ROWS * C + (gid % G) * 32 + lane;
  const bool el = E[(DIM + 2) * C] != 0.0f;
  float lo[DIM], hi[DIM];
  for (int ax = 0; ax < DIM; ++ax) {
    const float x = E[ax * C];
    const bool ok = el && !isnan(x);
    lo[ax] = ok ? x : INFINITY;
    hi[ax] = ok ? x : -INFINITY;
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int ax = 0; ax < DIM; ++ax) {
      lo[ax] = fminf(lo[ax], __shfl_xor_sync(0xffffffffu, lo[ax], off));
      hi[ax] = fmaxf(hi[ax], __shfl_xor_sync(0xffffffffu, hi[ax], off));
    }
  if (lane < EIG_BOX) {
    const int ax = lane & 3;
    float v = 0.0f;
    for (int k = 0; k < DIM; ++k)
      if (k == ax) v = lane < 4 ? lo[k] : hi[k];
    boxes[(size_t)gid * EIG_BOX + lane] = v;
  }
}

// Whether boxes `c` (candidate) and `o` (own) may hold a pair within r2:
// the gap, candidate minus own per axis, squared and summed as the pair
// test forms d2 (a NaN gap keeps the pair).
template <int DIM>
__device__ __forceinline__ bool boxes_near(const float* c, const float* o, float r2) {
  float d2 = 0.0f;
  for (int ax = 0; ax < DIM; ++ax) {
    const float diff = c[ax] > o[4 + ax] ? c[ax] - o[4 + ax]
                       : c[4 + ax] < o[ax] ? c[4 + ax] - o[ax]
                                           : 0.0f;
    d2 = ax == 0 ? diff * diff : d2 + diff * diff;
  }
  return !(d2 > r2);
}

__device__ __forceinline__ float f4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}


template <int DIM, int C>
__global__ void __launch_bounds__(C) eigen_pool_kernel(const float* __restrict__ e,
                                                       const int* __restrict__ cand,
                                                       const float* __restrict__ boxes,
                                                       float* __restrict__ out,
                                                       int max_chunks, int kn, float r2,
                                                       unsigned long long* __restrict__ work) {
  constexpr int G = C / 32;     // lane groups (warps) a chunk
  constexpr int NR = DIM + 3;   // staged rows: pos, m·psi_pos, m, eligible
  const int chunk = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* E = e + (size_t)chunk * EIG_ROWS * C;
  float mine[DIM];
  for (int ax = 0; ax < DIM; ++ax) mine[ax] = E[ax * C + t];
  const bool eligible = E[(DIM + 2) * C + t] != 0.0f;
  float* o = out + (size_t)chunk * 2 * C;
  if (!__syncthreads_or(eligible)) {
    o[t] = 0.0f;
    o[C + t] = 0.0f;
    if (work != nullptr && t == 0) atomicAdd(&work[0], 1ull);
    return;
  }

  __shared__ float s_own[G][EIG_BOX];
  __shared__ __align__(16) float s_rows[2][NR * C];
  __shared__ int s_cid[C];
  __shared__ unsigned s_pairs[C];  // bit go * G + gc: own group go near candidate group gc
  __shared__ int s_count[G];
  if (t < G * EIG_BOX) s_own[t / EIG_BOX][t % EIG_BOX] = boxes[(size_t)chunk * G * EIG_BOX + t];
  __syncthreads();

  auto stage = [&](float* dst, int cid) {
    const float* src = e + (size_t)cid * EIG_ROWS * C;
    for (int i = t; i < NR * C / 4; i += C) cp_async16(dst + 4 * i, src + 4 * i);
  };
  float acc0 = 0.0f, acc1 = 0.0f;
  unsigned long long tests = 0;
  int kept = 0;
  for (int k0 = 0; k0 < kn; k0 += C) {
    // This round's candidates (up to C), one a thread, compacted in
    // ascending order where some pair of group boxes lies within r2.
    const int k = k0 + t;
    const int cid = k < kn ? cand[(size_t)chunk * kn + k] : -1;
    unsigned pairs = 0u;
    if (cid >= 0 && cid < max_chunks) {
      const float4* B = reinterpret_cast<const float4*>(boxes + (size_t)cid * G * EIG_BOX);
      for (int gc = 0; gc < G; ++gc) {
        const float4 lo = B[2 * gc], hi = B[2 * gc + 1];
        const float cb[EIG_BOX] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        for (int go = 0; go < G; ++go)
          if (boxes_near<DIM>(cb, s_own[go], r2)) pairs |= 1u << (go * G + gc);
      }
    }
    const unsigned keep = __ballot_sync(0xffffffffu, pairs != 0u);
    if (lane == 0) s_count[warp] = __popc(keep);
    __syncthreads();
    int base = 0, nk = 0;
    for (int w = 0; w < G; ++w) {
      base += w < warp ? s_count[w] : 0;
      nk += s_count[w];
    }
    if (pairs != 0u) {
      const int pos = base + __popc(keep & ((1u << lane) - 1u));
      s_cid[pos] = cid;
      s_pairs[pos] = pairs;
    }
    __syncthreads();
    kept += nk;

    if (nk > 0) stage(s_rows[0], s_cid[0]);
    cp_async_commit();
    for (int n = 0; n < nk; ++n) {
      if (n + 1 < nk) stage(s_rows[(n + 1) & 1], s_cid[n + 1]);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const float* rows = s_rows[n & 1];
      const unsigned groups = (s_pairs[n] >> (warp * G)) & ((1u << G) - 1u);
      if (groups != 0u && eligible) {
        const int self_lane = s_cid[n] == chunk ? t : -1;
        float p0 = 0.0f, p1 = 0.0f;
        for (unsigned gs = groups; gs != 0u; gs &= gs - 1u) {
          const int j0 = (__ffs(gs) - 1) * 32;
          for (int j = j0; j < j0 + 32; j += 4) {  // four lanes a load (broadcast)
            float4 pos[DIM];
            for (int ax = 0; ax < DIM; ++ax)
              pos[ax] = *reinterpret_cast<const float4*>(rows + ax * C + j);
            const float4 v0 = *reinterpret_cast<const float4*>(rows + DIM * C + j);
            const float4 v1 = *reinterpret_cast<const float4*>(rows + (DIM + 1) * C + j);
            const float4 el = *reinterpret_cast<const float4*>(rows + (DIM + 2) * C + j);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float d2 = 0.0f;
              for (int ax = 0; ax < DIM; ++ax) {
                const float diff = f4(pos[ax], u) - mine[ax];
                d2 = ax == 0 ? diff * diff : d2 + diff * diff;
              }
              if (d2 <= r2 && f4(el, u) != 0.0f && j + u != self_lane) {
                p0 += f4(v0, u);
                p1 += f4(v1, u);
              }
            }
          }
          tests += 32;
        }
        acc0 += p0;
        acc1 += p1;
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }
  o[t] = acc0;
  o[C + t] = acc1;
  if (work != nullptr) {
    for (int off = 16; off > 0; off >>= 1) tests += __shfl_xor_sync(0xffffffffu, tests, off);
    if (lane == 0 && tests != 0) atomicAdd(&work[2], tests);
    if (t == 0) atomicAdd(&work[1], (unsigned long long)kept);
  }
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

// The merges' host side. The images as a TMA tensor (the scatter form's
// boxes): 5D in 3D (the cells' three axes innermost first, channel,
// chunk), 4D in 2D; a box is one corner's 4^d cells of every channel.
// cuTensorMapEncodeTiled is looked up at run time
// (cudaGetDriverEntryPointByVersion), so the library links against the
// runtime alone.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static bool merge_image_map(CUtensorMap* map, const float* img, int max_chunks, int nf,
                            int dim) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t n = (cuuint64_t)nf, d = (cuuint64_t)max_chunks;
  const cuuint32_t box[5] = {4, 4, 4, (cuuint32_t)nf, MERGE_RUN};
  const cuuint32_t box2[4] = {4, 4, (cuuint32_t)nf, MERGE_RUN};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const cuuint64_t size[5] = {8, 8, 8, n, d}, stride[4] = {32, 256, 2048, n * 2048};
  const cuuint64_t size2[4] = {8, 8, n, d}, stride2[3] = {32, 256, n * 256};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dim == 3 ? 5 : 4, (void*)img,
                dim == 3 ? size : size2, dim == 3 ? stride : stride2, dim == 3 ? box : box2,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A table is dense, and the scatter form takes boxes, from this many chunk
// corners a node row (of the capacities: fluids3 x4 88, sand3@1M 24).
constexpr int MERGE_DENSE = 48;

// The merges' CTA: node rows of nf · 4^(d-1) threads, at least a warp, at
// most MERGE_STAGE staged floats, about n_rows / 1024 rows; with boxes,
// each row's ring of 2·half boxes of MERGE_RUN sources (about
// MERGE_ROW_SMEM bytes, half at most MERGE_HALF_MAX), the CTA's within
// MERGE_BOX_SMEM. rows 0: no shape.
struct MergeShape {
  int rows, threads, slot_bytes, half, dyn_bytes;
};

static MergeShape merge_shape(int dim, int nf, int n_rows, bool boxes) {
  MergeShape sh = {0, 0, 0, 0, 0};
  const int group = nf * (dim == 3 ? 16 : 4);
  const int width = nf * (dim == 3 ? 64 : 16);
  if (nf < 1 || width > MERGE_STAGE) return sh;
  const int most = MERGE_STAGE / width, least = (32 + group - 1) / group;
  const int want = n_rows / 1024 < most ? n_rows / 1024 : most;
  sh.rows = want > least ? want : (least < most ? least : most);
  sh.threads = sh.rows * group;
  if (boxes) {
    sh.slot_bytes = ((MERGE_RUN * width * 4 + 127) / 128) * 128;
    sh.half = MERGE_ROW_SMEM / (2 * sh.slot_bytes);
    sh.half = sh.half < 1 ? 1 : sh.half > MERGE_HALF_MAX ? MERGE_HALF_MAX : sh.half;
    while (sh.rows > 1 && sh.rows * merge_row_bytes(sh.slot_bytes, sh.half) > MERGE_BOX_SMEM)
      --sh.rows;
    if (sh.rows * merge_row_bytes(sh.slot_bytes, sh.half) > MERGE_BOX_SMEM) sh.rows = 0;
    sh.threads = sh.rows * group;
    sh.dyn_bytes = sh.rows * merge_row_bytes(sh.slot_bytes, sh.half) + 128;  // and alignment
  }
  return sh;
}

// Once per kernel: allow the boxes' dynamic shared memory past 48 KB.
template <typename K>
static bool merge_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MERGE_BOX_SMEM + 128) == cudaSuccess;
}

extern "C" {

int sparkl_p2g_fused(const float* slots, const int* ints, const int* nchunks,
                     const float* tab_f, const int* tab_i, int m_count, float* out,
                     int max_chunks, float dt, float ox, float oy, float oz, float h,
                     float invd, float d_coeff, int rx, int ry, int rz, int dim, int opts,
                     void* stream) {
  const GridArgs g = grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz);
  const bool psi = (opts & OPT_PSI) != 0;
  const bool mats = (opts & OPT_MATS) != 0;
  cudaStream_t st = (cudaStream_t)stream;
#define SPARKL_A(D, C, P, M)                                                          \
  p2g_fused_kernel<D, C, P, M><<<max_chunks, C, 0, st>>>(slots, ints, nchunks, tab_f, \
                                                         tab_i, m_count, out, dt, g, opts)
  if (dim == 3 && psi && mats)
    SPARKL_A(3, 128, true, true);
  else if (dim == 3 && psi)
    SPARKL_A(3, 128, true, false);
  else if (dim == 3 && mats)
    SPARKL_A(3, 128, false, true);
  else if (dim == 3)
    SPARKL_A(3, 128, false, false);
  else if (dim == 2 && psi && mats)
    SPARKL_A(2, 64, true, true);
  else if (dim == 2 && psi)
    SPARKL_A(2, 64, true, false);
  else if (dim == 2 && mats)
    SPARKL_A(2, 64, false, true);
  else if (dim == 2)
    SPARKL_A(2, 64, false, false);
  else
    return (int)cudaErrorInvalidValue;
#undef SPARKL_A
  return (int)cudaGetLastError();
}

int sparkl_merge_scatter(const float* img, const int* order, const int* starts, const int* ngb,
                         float* out, int n_rows, int max_chunks, int nf, int dim, int zm,
                         void* stream) {
  const bool boxes = (long long)max_chunks * (1 << dim) >= (long long)MERGE_DENSE * n_rows;
  const MergeShape sh = merge_shape(dim, nf, n_rows, boxes);
  CUtensorMap map = {};
  if (sh.rows == 0 || (dim != 3 && dim != 2) || (zm && dim != 3) ||
      (long long)max_chunks * nf * (dim == 3 ? 512 : 64) >= MERGE_SEG_END ||
      ((uintptr_t)img | (uintptr_t)out) & 15 ||
      (boxes && !merge_image_map(&map, img, max_chunks, nf, dim)))
    return (int)cudaErrorInvalidValue;
  const int ctas = (n_rows + sh.rows - 1) / sh.rows;
  cudaStream_t st = (cudaStream_t)stream;
#define SPARKL_MS(D, B)                                                                    \
  merge_scatter_kernel<D, B><<<ctas, sh.threads, sh.dyn_bytes, st>>>(                       \
      map, img, order, starts, ngb, out, n_rows, nf, sh.rows, zm, sh.slot_bytes, sh.half)
  if (boxes) {
    static const bool ok = merge_smem(merge_scatter_kernel<3, true>) &&
                           merge_smem(merge_scatter_kernel<2, true>);
    if (!ok) return (int)cudaErrorInvalidValue;
    if (dim == 3)
      SPARKL_MS(3, true);
    else
      SPARKL_MS(2, true);
  } else if (dim == 3) {
    SPARKL_MS(3, false);
  } else {
    SPARKL_MS(2, false);
  }
#undef SPARKL_MS
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

int sparkl_merge_blocks(const float* img, const int* first, const int* nch, const int* owner,
                        const int* ngb, float* out, int n_rows, int max_chunks, int max_blocks,
                        int nf, int dim, int zm, int kmax, void* stream) {
  const MergeShape sh = merge_shape(dim, nf, n_rows, false);
  if (sh.rows == 0 || (dim != 3 && dim != 2) || (zm && dim != 3) || kmax > MERGE_KMAX_MAX ||
      (long long)max_chunks * nf * (dim == 3 ? 512 : 64) >= MERGE_SEG_END ||
      ((uintptr_t)img | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  const int ctas = (n_rows + sh.rows - 1) / sh.rows;
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3)
    merge_blocks_kernel<3><<<ctas, sh.threads, 0, st>>>(img, first, nch, owner, ngb, out, n_rows,
                                                        max_blocks, nf, sh.rows, zm, kmax);
  else
    merge_blocks_kernel<2><<<ctas, sh.threads, 0, st>>>(img, first, nch, owner, ngb, out, n_rows,
                                                        max_blocks, nf, sh.rows, zm, kmax);
  return (int)cudaGetLastError();
}

int sparkl_src_rows_from_order(const int* order2, const int* shifts, int* out,
                               int max_chunks, int c, void* stream) {
  if ((((uintptr_t)order2) | ((uintptr_t)out)) & 15) return (int)cudaErrorMisalignedAddress;
  if (c != 64 && c != 128) return (int)cudaErrorInvalidValue;
  if (max_chunks <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_block = SRC_ROWS_THREADS / (c / 4);
  const int blocks = (max_chunks + per_block - 1) / per_block;
  if (c == 128)
    src_rows_kernel<128><<<blocks, SRC_ROWS_THREADS, 0, st>>>(order2, shifts, out, max_chunks);
  else
    src_rows_kernel<64><<<blocks, SRC_ROWS_THREADS, 0, st>>>(order2, shifts, out, max_chunks);
  return (int)cudaGetLastError();
}

int sparkl_permute_slots(const float* slots, const int* ints, const int* src,
                         const int* origin, float* out_f, int* out_i, int max_chunks,
                         int dim, int r_cumd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned* sf = (const unsigned*)slots;
  const unsigned* si = (const unsigned*)ints;
  unsigned* of = (unsigned*)out_f;
  unsigned* oi = (unsigned*)out_i;
  if (max_chunks <= 0) return (int)cudaSuccess;
  if (dim == 3)
    permute_slots_kernel<56, 128, 3><<<max_chunks, 128 * PERMUTE_GROUPS, 0, st>>>(
        sf, si, src, origin, of, oi, max_chunks, r_cumd);
  else if (dim == 2)
    permute_slots_kernel<40, 64, 2><<<max_chunks, 64 * PERMUTE_GROUPS, 0, st>>>(
        sf, si, src, origin, of, oi, max_chunks, r_cumd);
  else
    return (int)cudaErrorInvalidValue;
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

int sparkl_g2p_fused(float* slots, const int* ints, const float* fields, const int* corners,
                     const int* nchunks, const float* tab_f, const int* tab_i,
                     int m_count, int max_chunks, float dt, float ox, float oy,
                     float oz, float h, float invd, float d_coeff, int rx, int ry, int rz,
                     int dim, int n_win, int opts, void* stream) {
  // The prologue's 16-byte copies: the table 16-byte aligned (every row is).
  if (((uintptr_t)fields) & 15) return (int)cudaErrorMisalignedAddress;
  const GridArgs g = grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz);
  cudaStream_t st = (cudaStream_t)stream;
  // The damage form: the stress cache off (damage and failure scenes); the
  // material form: neo-Hookean or NACC, or Rankine or Snow in 3D; the fluid
  // form: every model the EOS fluid.
  const bool damage = (opts & OPT_STRESS_CACHE) == 0;
  const bool mats = (opts & OPT_MATS) != 0;
  const bool fluid = (opts & OPT_FLUID) != 0 && !damage && !mats;
#define SPARKL_B(D, C, DMG, M, FL)                                                       \
  g2p_fused_kernel<D, C, DMG, M, FL><<<max_chunks, C, 0, st>>>(                          \
      slots, ints, fields, corners, nchunks, tab_f, tab_i, m_count, dt, g, n_win, opts)
  if (dim == 3 && damage && mats)
    SPARKL_B(3, 128, true, true, false);
  else if (dim == 3 && damage)
    SPARKL_B(3, 128, true, false, false);
  else if (dim == 3 && mats)
    SPARKL_B(3, 128, false, true, false);
  else if (dim == 3 && fluid)
    SPARKL_B(3, 128, false, false, true);
  else if (dim == 3)
    SPARKL_B(3, 128, false, false, false);
  else if (dim == 2 && damage && mats)
    SPARKL_B(2, 64, true, true, false);
  else if (dim == 2 && damage)
    SPARKL_B(2, 64, true, false, false);
  else if (dim == 2 && mats)
    SPARKL_B(2, 64, false, true, false);
  else if (dim == 2 && fluid)
    SPARKL_B(2, 64, false, false, true);
  else if (dim == 2)
    SPARKL_B(2, 64, false, false, false);
  else
    return (int)cudaErrorInvalidValue;
#undef SPARKL_B
  return (int)cudaGetLastError();
}

int sparkl_eigen_boxes(const float* e, float* boxes, int max_chunks, int dim, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  const int n_groups = max_chunks * (dim == 3 ? 128 : 64) / 32;
  if (n_groups <= 0) return (int)cudaSuccess;
  const int blocks = (n_groups + EIG_BOX_WARPS - 1) / EIG_BOX_WARPS;
  if (dim == 3)
    eigen_box_kernel<3, 128><<<blocks, 32 * EIG_BOX_WARPS, 0, st>>>(e, boxes, n_groups);
  else
    eigen_box_kernel<2, 64><<<blocks, 32 * EIG_BOX_WARPS, 0, st>>>(e, boxes, n_groups);
  return (int)cudaGetLastError();
}

// The boxes, then the pooling; `work` (3 counters) may be null.
int sparkl_eigen_pool(const float* e, const int* cand, float* boxes, float* out,
                      int max_chunks, int kn, float r2, int dim, void* work, void* stream) {
  if ((((uintptr_t)e) | ((uintptr_t)boxes)) & 15) return (int)cudaErrorMisalignedAddress;
  const int err = sparkl_eigen_boxes(e, boxes, max_chunks, dim, stream);
  if (err != (int)cudaSuccess || max_chunks <= 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* w = (unsigned long long*)work;
  if (dim == 3)
    eigen_pool_kernel<3, 128><<<max_chunks, 128, 0, st>>>(e, cand, boxes, out, max_chunks, kn,
                                                          r2, w);
  else
    eigen_pool_kernel<2, 64><<<max_chunks, 64, 0, st>>>(e, cand, boxes, out, max_chunks, kn,
                                                        r2, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
