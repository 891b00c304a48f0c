// Hand-written Hopper (sm_90a) kernels of the fused sand3 substep.
//
// Eight kernels, each with a plain PyTorch version beside its wrapper in
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
//                     permute_chunks_dma (_permute_dma_kernel), resort permute.
//
// Layouts are the JAX package's: slots f32 [D, NF=56, C=128] and ints i32
// [D, NI=8, C] (row offsets of sparkl_tpu/fused/layout.py Rows(3), checked
// against the Python side by the CPU tests), window images and windows in
// z-major region-cell order q = z*64 + x*8 + y. Each launcher is a plain C
// function that enqueues on the given stream and returns
// cudaGetLastError(); the caller allocates every output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false   (never --use_fast_math: the physics
//        uses expf/logf/sinf and sqrtf-based Cardano eigenvalues)

#include <cuda_runtime.h>
#include <stdint.h>

#include "particle_physics.cuh"

namespace {

constexpr int C = 128;    // slots per chunk = threads per CTA
constexpr int NF = 56;    // f32 rows per slot
constexpr int NI = 8;     // i32 rows per slot
constexpr int RC = 512;   // 8^3 region cells
constexpr int NTAB_F = 16;
constexpr int NTAB_I = 4;

// Rows(3) offsets (sparkl_tpu/fused/layout.py).
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

constexpr int I_MODEL = 0;
constexpr int I_FLAGS = 1;
constexpr int I_ORIGIN = 4;
constexpr int FLAG_ACTIVE = 1;
constexpr int FLAG_STATIC = 2;
constexpr int FLAG_KINEMATIC = 4;

constexpr int COROTATED = 0;
constexpr int EOS_MONAGHAN_SPH = 2;
constexpr int DRUCKER_PRAGER = 1;
constexpr float BIGF = 3.4028234663852886e38f;

struct GridArgs {
  float origin[3];
  float h;
  float invd;     // 4 / h^2, rounded from double on the host
  float d_coeff;  // h^2 / 4, rounded from double on the host
  int res[3];
};

// Base cell round(x/h) - 1 (round half to even, like jnp.round) and the
// offset fx; in_bounds = the 3-node stencil lies inside the grid.
__device__ __forceinline__ void base_fx(const GridArgs& g, const float pos[3],
                                        int base[3], float fx[3],
                                        bool& in_bounds) {
  in_bounds = true;
  for (int ax = 0; ax < 3; ++ax) {
    float xg = (pos[ax] - g.origin[ax]) / g.h;
    float bf = rintf(xg) - 1.0f;
    base[ax] = (int)bf;
    fx[ax] = xg - bf;
    in_bounds = in_bounds && (bf >= 0.0f) && (bf + 2.0f <= (float)(g.res[ax] - 1));
  }
}

// ---------------------------------------------------------------------------
// Kernel A: cached stress (fresh for EOS fluids) + APIC affine + quadratic
// weights -> the chunk's 8^3 window image (mass, momentum).
//
// An EOS slot's stress comes from J = F00, its mass, vol0 and the carried
// velocity gradient, never from the cache rows (kernel B leaves those zero
// for fluids). The JAX kernel folds the fluid test statically for
// single-type model sets; this one branches per slot on the model's type,
// so mixed fluid/solid sets take the same values.
//
// One 128-thread CTA per chunk. Each thread prepares its slot's weights,
// tap offsets and payload in shared memory; then each thread owns 4 of the
// 512 cells and sums every slot's contribution to them in ascending lane
// order. No atomics, so the image is run-to-run deterministic, like the
// JAX path. Bound on this card: the owner loop is 128 slots x 4 cells of
// shared-memory broadcasts and compares per thread (~65k per CTA), almost
// all of them misses of the 3x3x3 footprint; the slot read is 56 rows x
// 512 B, coalesced. A faster design scatters each slot's 27 taps (shared
// memory atomics, losing determinism) or sorts slots by cell first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(C) p2g_fused_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ nchunks, const float* __restrict__ tab_f,
    const int* __restrict__ tab_i, int m_count, float* __restrict__ out,
    float dt, GridArgs g) {
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  float* img = out + (size_t)chunk * 4 * RC;
  if (chunk >= *nchunks) {
    for (int e = t; e < 4 * RC; e += C) img[e] = 0.0f;
    return;
  }

  __shared__ int s_rel[3][C];
  __shared__ float s_w[3][3][C];   // per axis, per tap
  __shared__ float s_d[3][3][C];   // dpt = (tap cell - px) * h
  __shared__ float s_p0[4][C];     // m, m*v
  __shared__ float s_a[9][C];      // contrib * affine, row-major

  const float* S = slots + (size_t)chunk * NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
#define SROW(k) S[(k) * C + t]
  const int flags = I[I_FLAGS * C + t];
  const bool active = (flags & FLAG_ACTIVE) != 0;
  const bool failed = SROW(ROW_FAILED) != 0.0f;
  const float mass = SROW(ROW_MASS);
  const float vol0 = SROW(ROW_VOL0);
  float pos[3];
  for (int ax = 0; ax < 3; ++ax) pos[ax] = SROW(ROW_POS + ax);
  int base[3];
  float fx[3];
  bool in_bounds;
  base_fx(g, pos, base, fx, in_bounds);
  int rel[3];
  bool in_window = true;
  for (int ax = 0; ax < 3; ++ax) {
    rel[ax] = base[ax] - I[(I_ORIGIN + ax) * C + t];
    in_window = in_window && rel[ax] >= 0 && rel[ax] <= 5;
  }
  const bool contrib = active && in_window && in_bounds;
  const float cf = contrib ? 1.0f : 0.0f;

  // Cached Kirchhoff stress (symmetric upper triangle rows), or the EOS
  // stress for fluid slots (m_count = 0: no fluid in the scene).
  float stress[3][3];
  const int mid = I[I_MODEL * C + t];
  if (mid >= 0 && mid < m_count && tab_i[mid * NTAB_I] == EOS_MONAGHAN_SPH) {
    const float* p = tab_f + mid * NTAB_F;
    float gv[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) gv[i][j] = SROW(ROW_GRAD + i * 3 + j);
    const float fj = SROW(ROW_DEFGRAD);
    const float density = (mass / fmaxf(vol0, 1e-30f)) / fmaxf(fj, 1e-20f);
    sparkl::eos_stress(p[0], p[1], p[2], p[3], mass, vol0, density, fj, gv, stress);
  } else {
    float st[6];
    for (int k = 0; k < 6; ++k) st[k] = SROW(ROW_STRESS + k);
    stress[0][0] = st[0]; stress[0][1] = st[1]; stress[0][2] = st[2];
    stress[1][0] = st[1]; stress[1][1] = st[3]; stress[1][2] = st[4];
    stress[2][0] = st[2]; stress[2][1] = st[4]; stress[2][2] = st[5];
  }
  const float coeff = vol0 * g.invd * dt;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float aff = mass * SROW(ROW_GRAD + i * 3 + j) - (failed ? 0.0f : coeff * stress[i][j]);
      s_a[i * 3 + j][t] = contrib ? aff : 0.0f;  // an empty EOS lane's stress is NaN
    }
  const float m_c = mass * cf;
  s_p0[0][t] = m_c;
  for (int ax = 0; ax < 3; ++ax) s_p0[1 + ax][t] = m_c * SROW(ROW_VEL + ax);
  for (int ax = 0; ax < 3; ++ax) {
    const float f = fx[ax];
    const float px = (float)rel[ax] + f;
    s_w[ax][0][t] = 0.5f * ((1.5f - f) * (1.5f - f));
    s_w[ax][1][t] = 0.75f - (f - 1.0f) * (f - 1.0f);
    s_w[ax][2][t] = 0.5f * ((f - 0.5f) * (f - 0.5f));
    for (int k = 0; k < 3; ++k) s_d[ax][k][t] = ((float)(rel[ax] + k) - px) * g.h;
    // Non-contributing slots never match a cell (their payload is zero).
    s_rel[ax][t] = contrib ? rel[ax] : -1000;
  }
#undef SROW
  __syncthreads();

  for (int k = 0; k < RC / C; ++k) {
    const int q = t + k * C;
    const int z = q >> 6, x = (q >> 3) & 7, y = q & 7;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
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
    }
    for (int f = 0; f < 4; ++f) img[f * RC + q] = acc[f];
  }
}

// ---------------------------------------------------------------------------
// Merge: per owner block, the sum of its <= kmax contiguous chunk rows in
// ascending chunk order (bit-equal to merge_blocks_dma and to the plain
// version). One CTA per block, each thread a strided set of the row's
// elements. Bound on this card: bytes (each block reads its 1-4 chunk rows
// of 8 KB once, coalesced, and writes 8 KB).
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
// Mass P2G (fluid volume pass): the chunk's 8^3 mass image, kernel A's
// design with one channel. Each thread prepares its slot's weights and
// m·contrib in shared memory; then each thread owns 4 of the 512 cells and
// sums (m wz)(wx wy) of every slot whose stencil holds the cell, in
// ascending lane order: no atomics, so the image is deterministic. Dead
// chunks write zeros. Bound on this card: like kernel A, the owner loop's
// shared-memory compares (128 slots x 4 cells per thread); the slot read
// is 4 rows + 4 int rows x 512 B.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(C) mass_p2g_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ nchunks, float* __restrict__ out, GridArgs g) {
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  float* img = out + (size_t)chunk * RC;
  if (chunk >= *nchunks) {
    for (int e = t; e < RC; e += C) img[e] = 0.0f;
    return;
  }
  __shared__ int s_rel[3][C];
  __shared__ float s_w[3][3][C];
  __shared__ float s_m[C];

  const float* S = slots + (size_t)chunk * NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
  const bool active = (I[I_FLAGS * C + t] & FLAG_ACTIVE) != 0;
  float pos[3];
  for (int ax = 0; ax < 3; ++ax) pos[ax] = S[(ROW_POS + ax) * C + t];
  int base[3];
  float fx[3];
  bool in_bounds;
  base_fx(g, pos, base, fx, in_bounds);
  int rel[3];
  bool in_window = true;
  for (int ax = 0; ax < 3; ++ax) {
    rel[ax] = base[ax] - I[(I_ORIGIN + ax) * C + t];
    in_window = in_window && rel[ax] >= 0 && rel[ax] <= 5;
  }
  const bool contrib = active && in_window && in_bounds;
  s_m[t] = S[ROW_MASS * C + t] * (contrib ? 1.0f : 0.0f);
  for (int ax = 0; ax < 3; ++ax) {
    const float f = fx[ax];
    s_w[ax][0][t] = 0.5f * ((1.5f - f) * (1.5f - f));
    s_w[ax][1][t] = 0.75f - (f - 1.0f) * (f - 1.0f);
    s_w[ax][2][t] = 0.5f * ((f - 0.5f) * (f - 0.5f));
    s_rel[ax][t] = contrib ? rel[ax] : -1000;
  }
  __syncthreads();

  for (int k = 0; k < RC / C; ++k) {
    const int q = t + k * C;
    const int z = q >> 6, x = (q >> 3) & 7, y = q & 7;
    float acc = 0.0f;
    for (int s = 0; s < C; ++s) {
      const unsigned a = (unsigned)(x - s_rel[0][s]);
      const unsigned b = (unsigned)(y - s_rel[1][s]);
      const unsigned c = (unsigned)(z - s_rel[2][s]);
      if (a > 2u || b > 2u || c > 2u) continue;
      acc += (s_m[s] * s_w[2][c][s]) * (s_w[0][a][s] * s_w[1][b][s]);
    }
    img[q] = acc;
  }
}

// ---------------------------------------------------------------------------
// Mass G2P (fluid volume pass): each slot's sum of w·m over its 27 cells of
// the chunk's mass window, masked by the transfer mask. One 128-thread CTA
// per chunk: the window (2 KB) goes to shared memory and each thread
// gathers its own slot, per z tap the xy sheet first, then the z weight (as
// kernel B gathers). Dead chunks write zeros. Bound on this card: bytes
// (4 slot rows + 4 int rows read, the window read and one row written per
// chunk) and the launch.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(C) mass_g2p_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const float* __restrict__ windows, const int* __restrict__ nchunks,
    float* __restrict__ out, GridArgs g) {
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

  const float* S = slots + (size_t)chunk * NF * C;
  const int* I = ints + (size_t)chunk * NI * C;
  const bool active = (I[I_FLAGS * C + t] & FLAG_ACTIVE) != 0;
  float pos[3];
  for (int ax = 0; ax < 3; ++ax) pos[ax] = S[(ROW_POS + ax) * C + t];
  int base[3];
  float fx[3];
  bool in_bounds;
  base_fx(g, pos, base, fx, in_bounds);
  int rel[3];
  bool in_window = true;
  for (int ax = 0; ax < 3; ++ax) {
    rel[ax] = base[ax] - I[(I_ORIGIN + ax) * C + t];
    in_window = in_window && rel[ax] >= 0 && rel[ax] <= 5;
  }
  float m = 0.0f;
  if (active && in_window && in_bounds) {
    float w[3][3];
    for (int ax = 0; ax < 3; ++ax) {
      const float f = fx[ax];
      w[ax][0] = 0.5f * ((1.5f - f) * (1.5f - f));
      w[ax][1] = 0.75f - (f - 1.0f) * (f - 1.0f);
      w[ax][2] = 0.5f * ((f - 0.5f) * (f - 0.5f));
    }
    for (int c = 0; c < 3; ++c) {
      float tv = 0.0f;
      const int zq = (rel[2] + c) * 64;
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)
          tv += win[zq + (rel[0] + a) * 8 + (rel[1] + b)] * (w[0][a] * w[1][b]);
      m += tv * w[2][c];
    }
  }
  out[(size_t)chunk * C + t] = m;
}

// ---------------------------------------------------------------------------
// Resort source rows: out[i, k] = concat(order2[i, 0], order2[i, 1])[shift_i
// + k], the destination chunk's slice of the sorted order. One 128-thread
// CTA per chunk, one thread per lane. The TPU kernel routes lanes with f32
// selection matmuls, exact only below 2^24 slots; this one copies int32, so
// it has no such limit. Bound on this card: launch latency (12 B per lane).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(C) src_rows_kernel(const int* __restrict__ order2,
                                                     const int* __restrict__ shifts,
                                                     int* __restrict__ out) {
  const int i = blockIdx.x;
  const int j = threadIdx.x + shifts[i];
  const int* rows = order2 + (size_t)i * 2 * C;
  out[(size_t)i * C + threadIdx.x] = (j >= 0 && j < 2 * C) ? rows[j] : 0;
}

// ---------------------------------------------------------------------------
// Resort permute: destination slot (chunk d, lane l) takes every row of
// source slot src[d, l] (flat chunk * C + lane; -1 leaves it zero); the
// drift row is zeroed and the window-origin rows are written from the new
// structure, as the TPU kernel finalizes them. The TPU kernel fetches at
// most K = 8 whole source chunks per destination by DMA and routes lanes
// among them with selection matmuls, so its package falls back to a
// per-slot gather past K; here each thread copies its own source slot, with
// no K limit and bit-exact. One 128-thread CTA per destination chunk.
// Bound on this card: bytes. Each thread reads its source slot's 64 rows,
// 4 B each with a 512 B stride; lanes of one warp mostly read neighbouring
// lanes of one source chunk (the sort is stable), so the reads coalesce,
// and every write is a full row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(C) permute_slots_kernel(
    const float* __restrict__ slots, const int* __restrict__ ints,
    const int* __restrict__ src, const int* __restrict__ origin,
    float* __restrict__ out_f, int* __restrict__ out_i, int max_chunks, int dim,
    int r_cumd) {
  const int d = blockIdx.x;
  const int lane = threadIdx.x;
  const int s = src[(size_t)d * C + lane];
  const bool ok = s >= 0 && s < max_chunks * C;
  const int cid = ok ? s / C : 0, sl = ok ? s % C : 0;
  const float* S = slots + (size_t)cid * NF * C + sl;
  const int* I = ints + (size_t)cid * NI * C + sl;
  float* OF = out_f + (size_t)d * NF * C + lane;
  int* OI = out_i + (size_t)d * NI * C + lane;
  for (int f = 0; f < NF; ++f) OF[f * C] = (ok && f != r_cumd) ? S[f * C] : 0.0f;
  for (int r = 0; r < NI; ++r) {
    int v = ok ? I[r * C] : 0;
    if (r >= I_ORIGIN && r < I_ORIGIN + dim) v = origin[(size_t)d * dim + r - I_ORIGIN];
    OI[r * C] = v;
  }
}

// ---------------------------------------------------------------------------
// Kernel B: window gather, advection, F update, one SVD shared by the
// Drucker-Prager return map, the pos-energy and the stress-cache epilogue,
// guards, out-of-grid mark, next dt bound, drift; written IN PLACE.
//
// EOS fluid slots (branch per slot on the model's type) update only J =
// F00 by tr(grad v), take no SVD and no return map, skip the |F00| blowup
// guard (the det = 0 guard stays), bound dt with the EOS bound and write
// zero stress-cache rows: kernel A forms their stress fresh.
//
// One 128-thread CTA per chunk: the chunk's windows [3, 512] (6 KB) go to
// shared memory, each thread gathers its 27 nodes and runs the particle
// physics in registers (particle_physics.cuh). Each thread reads every row
// of its own slot before writing it, and no thread touches another lane,
// so the in-place update is safe. Dead chunks (>= num_chunks) return
// untouched. Bound on this card: per-thread arithmetic and registers (one
// Cardano SVD, ~3 transcendental DP steps) at one CTA of 4 warps per
// chunk; the slot read/write is 2 x 56 rows x 512 B, coalesced.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(C) g2p_fused_kernel(
    float* __restrict__ slots, const int* __restrict__ ints,
    const float* __restrict__ windows, const int* __restrict__ nchunks,
    const float* __restrict__ tab_f, const int* __restrict__ tab_i, int m_count,
    float dt, GridArgs g, int velocity_clamp) {
  const int chunk = blockIdx.x;
  if (chunk >= *nchunks) return;
  const int t = threadIdx.x;

  __shared__ float win[3 * RC];
  const float* W = windows + (size_t)chunk * 3 * RC;
  for (int e = t; e < 3 * RC; e += C) win[e] = W[e];
  __syncthreads();

  float* S = slots + (size_t)chunk * NF * C;
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

  float pos[3];
  for (int ax = 0; ax < 3; ++ax) pos[ax] = SROW(ROW_POS + ax);
  int base[3];
  float fx[3];
  bool in_bounds;
  base_fx(g, pos, base, fx, in_bounds);
  int rel[3];
  bool in_window = true;
  for (int ax = 0; ax < 3; ++ax) {
    rel[ax] = base[ax] - I[(I_ORIGIN + ax) * C + t];
    in_window = in_window && rel[ax] >= 0 && rel[ax] <= 5;
  }
  const bool contrib = active && in_window && in_bounds;

  // --- gather (xy sheet first, then the z taps, like the JAX kernel) ---
  float vel[3] = {0.0f, 0.0f, 0.0f};
  float gm[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (contrib) {
    float w[3][3], dpt[3][3];
    for (int ax = 0; ax < 3; ++ax) {
      const float f = fx[ax];
      const float px = (float)rel[ax] + f;
      w[ax][0] = 0.5f * ((1.5f - f) * (1.5f - f));
      w[ax][1] = 0.75f - (f - 1.0f) * (f - 1.0f);
      w[ax][2] = 0.5f * ((f - 0.5f) * (f - 0.5f));
      for (int k = 0; k < 3; ++k) dpt[ax][k] = ((float)(rel[ax] + k) - px) * g.h;
    }
    float sv[3] = {0.0f, 0.0f, 0.0f}, sgx[3] = {0.0f, 0.0f, 0.0f},
          sgy[3] = {0.0f, 0.0f, 0.0f}, sgz[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 3; ++c) {
      float tv[3] = {0.0f, 0.0f, 0.0f}, tx[3] = {0.0f, 0.0f, 0.0f},
            ty[3] = {0.0f, 0.0f, 0.0f};
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
        }
      }
      const float wz = w[2][c], wdz = w[2][c] * dpt[2][c];
      for (int i = 0; i < 3; ++i) {
        sv[i] += tv[i] * wz;
        sgx[i] += tx[i] * wz;
        sgy[i] += ty[i] * wz;
        sgz[i] += tv[i] * wdz;
      }
    }
    for (int i = 0; i < 3; ++i) {
      vel[i] = sv[i];
      gm[i][0] = g.invd * sgx[i];
      gm[i][1] = g.invd * sgy[i];
      gm[i][2] = g.invd * sgz[i];
    }
  }

  // --- particle update ---
  float phase = SROW(ROW_PHASE);
  const bool failed = SROW(ROW_FAILED) != 0.0f;
  const float mass = SROW(ROW_MASS);
  const float vol0 = SROW(ROW_VOL0);
  const float eh = SROW(ROW_EH);
  float ph = SROW(ROW_PH);
  float pdd = SROW(ROW_PDD);
  float lvg = SROW(ROW_LVG);
  const float nacc = SROW(ROW_NACC);
  float psi_pos = SROW(ROW_PSI_POS);
  float f[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) f[i][j] = SROW(ROW_DEFGRAD + i * 3 + j);
  float kin[3];
  for (int ax = 0; ax < 3; ++ax) kin[ax] = SROW(ROW_KINVEL + ax);
  const float cpf = SROW(ROW_CPF), cthr = SROW(ROW_CTHR), radius0 = SROW(ROW_RADIUS0);
  const float mcv = SROW(ROW_MC), gv = SROW(ROW_G), dbg = SROW(ROW_DEBUG);
  const float cumd0 = SROW(ROW_CUMD);

  // Advection (kinematic override + optional GPU CFL clamp).
  for (int i = 0; i < 3; ++i) vel[i] = kinematic ? kin[i] : vel[i];
  if (velocity_clamp) {
    bool over = false;
    for (int i = 0; i < 3; ++i) over = over || (fabsf(vel[i]) * dt >= g.h);
    if (over)
      for (int i = 0; i < 3; ++i)
        vel[i] = (vel[i] > 0.0f ? 1.0f : (vel[i] < 0.0f ? -1.0f : 0.0f)) * (g.h / dt);
  }
  float npos[3];
  for (int ax = 0; ax < 3; ++ax) npos[ax] = pos[ax] + vel[ax] * dt;

  // F += dt * (grad v) F; fluids: F00 += tr(grad v) dt F00, the rest kept.
  const bool fluid = ti[0] == EOS_MONAGHAN_SPH;
  float fnew[3][3];
  if (fluid) {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) fnew[i][j] = f[i][j];
    const float tr = gm[0][0] + gm[1][1] + gm[2][2];
    fnew[0][0] = f[0][0] + tr * dt * f[0][0];
  } else {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        fnew[i][j] = f[i][j] + dt * (gm[i][0] * f[0][j] + gm[i][1] * f[1][j] + gm[i][2] * f[2][j]);
  }

  // One SVD serves the return map, the pos energy and the cached stress.
  float u[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  float s[3] = {1.0f, 1.0f, 1.0f};
  if (!fluid) {
    sparkl::svd3(fnew, u, s, v);
    if (ti[1] == DRUCKER_PRAGER) sparkl::dp_update(tf + 4, phase, fnew, u, s, v, pdd, ph, lvg);
  }

  // Static particles.
  if (is_static) {
    for (int i = 0; i < 3; ++i) {
      vel[i] = 0.0f;
      for (int j = 0; j < 3; ++j) gm[i][j] = 0.0f;
    }
  }

  // Failure guards: det(F) = 0, already failed, |F00| blowup (solids only).
  const float detf = sparkl::det3(fnew);
  const bool broken = (detf == 0.0f) || failed || (!fluid && fabsf(fnew[0][0]) > 1.0e4f);
  bool failed_new = failed || broken;
  if (broken) {
    for (int i = 0; i < 3; ++i) {
      s[i] = 1.0f;
      for (int j = 0; j < 3; ++j) {
        fnew[i][j] = i == j ? 1.0f : 0.0f;
        gm[i][j] = 0.0f;
      }
    }
  }

  const float lam = tf[0], mu = tf[1], cfl = tf[2], split = tf[3];
  const bool corot = ti[0] == COROTATED;
  const float energy = corot ? sparkl::corotated_pos_energy(lam, mu, eh, fnew, s) : 0.0f;
  psi_pos = fmaxf(psi_pos, energy);
  const float par1 = psi_pos * mass;
  const float par2 = mass;

  // Out-of-grid mark from the new positions.
  {
    int nb[3];
    float nfx[3];
    bool ok;
    base_fx(g, npos, nb, nfx, ok);
    failed_new = failed_new || (active && !ok);
  }

  // Next substep's dt bound.
  const float d_coeff = g.d_coeff;
  float frob = 0.0f;
  for (int i = 0; i < 3; ++i)
    frob += gm[i][0] * gm[i][0] + gm[i][1] * gm[i][1] + gm[i][2] * gm[i][2];
  const float norm_b = d_coeff * sqrtf(frob);
  const float apic_v = norm_b * 6.0f * 1.7320508075688772f / g.h;
  const float vsq = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2];
  const float vnorm = sqrtf(vsq);
  const float vtot = vnorm + apic_v;
  const float vel_bound = vtot > 0.0f ? g.h / fmaxf(vtot, 1e-20f) : INFINITY;
  float con_bound = INFINITY;
  const float density0 = mass / fmaxf(vol0, 1e-30f);
  if (corot) {
    const float bulk = (lam + 2.0f * mu / 3.0f) * eh;
    const float shear = mu * eh;
    con_bound = sparkl::sound_speed_bound(cfl, bulk, shear, density0, vnorm, g.h);
  } else if (fluid) {
    const float fj = fnew[0][0];
    const float density = density0 / fmaxf(fj, 1e-20f);
    con_bound = sparkl::eos_timestep_bound(tf[0], tf[1], tf[3], fj, mass, vol0, density, vsq,
                                           g.h);
  }
  if (failed_new) con_bound = INFINITY;
  float bound = fminf(vel_bound, con_bound);
  if (!active) bound = INFINITY;
  bound = fminf(bound, BIGF);

  // Drift accumulation (lazy-resort trigger).
  float step_disp = fabsf(vel[0]) * dt;
  step_disp = fmaxf(step_disp, fabsf(vel[1]) * dt);
  step_disp = fmaxf(step_disp, fabsf(vel[2]) * dt);
  const float cumd = cumd0 + step_disp;

  // Stress-cache epilogue from the shared SVD.
  float st[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (corot) sparkl::corotated_stress(lam, mu, split, phase, eh, fnew, u, s, v, st);

  // --- write the slot (every row of this lane was read above) ---
  for (int ax = 0; ax < 3; ++ax) {
    SROW(ROW_POS + ax) = npos[ax];
    SROW(ROW_VEL + ax) = vel[ax];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      SROW(ROW_GRAD + i * 3 + j) = gm[i][j];
      SROW(ROW_DEFGRAD + i * 3 + j) = fnew[i][j];
    }
  SROW(ROW_MASS) = mass;
  SROW(ROW_VOL0) = vol0;
  SROW(ROW_PHASE) = phase;
  SROW(ROW_PSI_POS) = psi_pos;
  SROW(ROW_PDD) = pdd;
  SROW(ROW_PH) = ph;
  SROW(ROW_EH) = eh;
  SROW(ROW_LVG) = lvg;
  SROW(ROW_NACC) = nacc;
  for (int ax = 0; ax < 3; ++ax) SROW(ROW_KINVEL + ax) = kin[ax];
  SROW(ROW_CPF) = cpf;
  SROW(ROW_CTHR) = cthr;
  SROW(ROW_DTB) = bound;
  SROW(ROW_FAILED) = failed_new ? 1.0f : 0.0f;
  SROW(ROW_RADIUS0) = radius0;
  SROW(ROW_PAR1) = par1;
  SROW(ROW_PAR2) = par2;
  SROW(ROW_MC) = mcv;
  SROW(ROW_G) = gv;
  SROW(ROW_DEBUG) = dbg;
  SROW(ROW_CUMD) = cumd;
  int k = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) SROW(ROW_STRESS + k++) = sparkl::clampf(st[i][j], -BIGF, BIGF);
  for (int r = ROW_STRESS + 6; r < NF; ++r) SROW(r) = 0.0f;
#undef SROW
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
                     float invd, float d_coeff, int rx, int ry, int rz, void* stream) {
  p2g_fused_kernel<<<max_chunks, C, 0, (cudaStream_t)stream>>>(
      slots, ints, nchunks, tab_f, tab_i, m_count, out, dt,
      grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz));
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
                          float invd, float d_coeff, int rx, int ry, int rz, void* stream) {
  mass_p2g_kernel<<<max_chunks, C, 0, (cudaStream_t)stream>>>(
      slots, ints, nchunks, out, grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz));
  return (int)cudaGetLastError();
}

int sparkl_mass_g2p_fused(const float* slots, const int* ints, const float* windows,
                          const int* nchunks, float* out, int max_chunks, float ox, float oy,
                          float oz, float h, float invd, float d_coeff, int rx, int ry, int rz,
                          void* stream) {
  mass_g2p_kernel<<<max_chunks, C, 0, (cudaStream_t)stream>>>(
      slots, ints, windows, nchunks, out, grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz));
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
                               int max_chunks, void* stream) {
  src_rows_kernel<<<max_chunks, C, 0, (cudaStream_t)stream>>>(order2, shifts, out);
  return (int)cudaGetLastError();
}

int sparkl_permute_slots(const float* slots, const int* ints, const int* src,
                        const int* origin, float* out_f, int* out_i, int max_chunks,
                        int dim, int r_cumd, void* stream) {
  permute_slots_kernel<<<max_chunks, C, 0, (cudaStream_t)stream>>>(
      slots, ints, src, origin, out_f, out_i, max_chunks, dim, r_cumd);
  return (int)cudaGetLastError();
}

int sparkl_g2p_fused(float* slots, const int* ints, const float* windows,
                     const int* nchunks, const float* tab_f, const int* tab_i,
                     int m_count, int max_chunks, float dt, float ox, float oy,
                     float oz, float h, float invd, float d_coeff, int rx, int ry, int rz,
                     int velocity_clamp, void* stream) {
  g2p_fused_kernel<<<max_chunks, C, 0, (cudaStream_t)stream>>>(
      slots, ints, windows, nchunks, tab_f, tab_i, m_count, dt,
      grid_args(ox, oy, oz, h, invd, d_coeff, rx, ry, rz), velocity_clamp);
  return (int)cudaGetLastError();
}

}  // extern "C"
