// The lane-mask walk of the scatter kernels: the mass P2G (fused_kernels.cu
// mass_p2g_kernel) and the sparse P2G windows (window_kernels.cu
// p2g_windows_kernel). Kernel A (p2g_fused_kernel) runs the same walk with
// its own copy of these pieces.
//
// A chunk's C slots each scatter into the 3^d cells of their stencil, which
// starts at a window coordinate `base` per axis. Cell (x, y, z) is hit by
// the slots whose base lies in x-2..x, y-2..y and z-2..z, so its lane mask
// is the AND of one mask per axis and coordinate. Warp ballots build those
// masks in the prologue (8·d ballots a warp; no atomics); each thread then
// walks its cells' set bits in ascending lane order, which is the order of
// a loop over all C slots, and evaluates the hit body for exactly those
// slots. Every cell is the same left fold over the same terms as that loop,
// so a kernel that walks keeps its loop's bits.
//
// A mask is C/32 words, word h the lanes of warp h (8-byte aligned, so that
// walk_chain reads them in pairs). The per-slot arrays the
// walk reads hold slot s at column slot_col(s) of rows C + C/32 + 1 long: a
// warp's lanes read different slots, and this spreads the slots 32 apart,
// and a slot's rows, over the shared-memory banks.

#pragma once

#include <cuda_runtime.h>

namespace sparkl_walk {

// Row length of the per-slot arrays, and slot s's column in them.
template <int C>
__host__ __device__ constexpr int slot_cols() {
  return C + C / 32 + 1;
}
__device__ __forceinline__ int slot_col(int s) { return s + (s >> 5); }

// The axis masks, rng[(ax * 8 + v) * (C / 32) + h]: the lanes of warp h
// with `pred` whose base[ax] lies in v-2..v, for v in 0..7. Every thread of
// the CTA calls it (the ballots take whole warps); lane ax*8 + v of each
// warp stores its warp's word. The caller's barrier publishes them.
template <int D, int C>
__device__ __forceinline__ void axis_masks(bool pred, const int base[D], unsigned* rng) {
  const int t = threadIdx.x;
  unsigned keep = 0u;
#pragma unroll
  for (int ax = 0; ax < D; ++ax)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const unsigned b = __ballot_sync(0xffffffffu, pred && (unsigned)(v - base[ax]) <= 2u);
      if ((t & 31) == ax * 8 + v) keep = b;
    }
  if ((t & 31) < D * 8) rng[(t & 31) * (C / 32) + (t >> 5)] = keep;
}

// The lane mask of cell (x, y, z) (z unused in 2D): the AND of its
// coordinates' axis masks.
template <int D, int C>
__device__ __forceinline__ void cell_mask(const unsigned* rng, int x, int y, int z,
                                          unsigned mk[C / 32]) {
  constexpr int NW = C / 32;
#pragma unroll
  for (int h = 0; h < NW; ++h) {
    mk[h] = rng[x * NW + h] & rng[(8 + y) * NW + h];
    if constexpr (D == 3) mk[h] &= rng[(16 + z) * NW + h];
  }
}

template <int C>
__device__ __forceinline__ int popcount(const unsigned mk[C / 32]) {
  int n = 0;
#pragma unroll
  for (int h = 0; h < C / 32; ++h) n += __popc(mk[h]);
  return n;
}

// Calls hit(col) for the mask's set lanes in ascending lane order, col the
// lane's column in the per-slot arrays (slot_col): a loop per word. For a
// light hit body (the mass P2G's, and the 2D window kernel's one cell a
// thread) this was the fastest walk on the card (NVIDIA H100,
// compare_kernels): the 3D mass P2G took 0.0695 ms this way against 0.1363
// with one loop whose iterations test every word, the 2D window P2G
// 0.0218 against walk_chain's 0.0248.
template <int C, typename F>
__device__ __forceinline__ void walk(const unsigned mk[C / 32], F&& hit) {
#pragma unroll
  for (int h = 0; h < C / 32; ++h)
    for (unsigned b = mk[h]; b != 0u; b &= b - 1u) hit(33 * h + __ffs(b) - 1);
}

// cell_mask with the words read in pairs: C/64 words of 64 lanes.
template <int D, int C>
__device__ __forceinline__ void cell_mask64(const unsigned* rng, int x, int y, int z,
                                            unsigned long long mk[C / 64]) {
  constexpr int NW = C / 64;
  const auto* r = reinterpret_cast<const unsigned long long*>(rng);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    mk[w] = r[x * NW + w] & r[(8 + y) * NW + w];
    if constexpr (D == 3) mk[w] &= r[(16 + z) * NW + w];
  }
}

// The same walk as one loop over 64-lane words, the hit body emitted once:
// for a heavy body over several cells a thread (kernel A; the 3D window
// P2G, 0.238 ms against walk's 0.275 on the card), as a warp then runs as
// many iterations as its busiest lane has hits.
template <int C, typename F>
__device__ __forceinline__ void walk_chain(unsigned long long mk[C / 64], F&& hit) {
  constexpr int NW = C / 64;
  static_assert(NW == 1 || NW == 2, "one or two 64-lane words a cell");
  for (;;) {
    int s;
    if (mk[0] != 0ull) {
      s = __ffsll(mk[0]) - 1;
      mk[0] &= mk[0] - 1ull;
    } else if (NW == 2 && mk[NW - 1] != 0ull) {
      s = 63 + __ffsll(mk[NW - 1]);
      mk[NW - 1] &= mk[NW - 1] - 1ull;
    } else {
      return;
    }
    hit(slot_col(s));
  }
}

// Counting sort of the CTA's RC = NPASS·C cells by hit count, busiest
// first: thread t passes the hit counts of cells t + k·C; afterwards
// list[t + k·C] is the cell that thread t walks in pass k, so that a
// warp's 32 cells of one pass take about as many iterations (the
// assignment changes no sum). bin holds C + 1 ints, which the caller has
// zeroed before a barrier (clear_bins); list holds RC. Every thread calls
// it; it ends on a barrier.
template <int C>
__device__ __forceinline__ void clear_bins(int* bin) {
  for (int i = threadIdx.x; i <= C; i += C) bin[i] = 0;
}

template <int C, int NPASS>
__device__ __forceinline__ void sort_cells(const int hits[NPASS], int* bin,
                                           unsigned short* list) {
  const int t = threadIdx.x;
  for (int k = 0; k < NPASS; ++k) atomicAdd(&bin[C - hits[k]], 1);
  __syncthreads();
  if (t < 32) {  // exclusive scan of the C + 1 bins, PER bins a lane
    constexpr int PER = (C + 1 + 31) / 32;
    int v[PER], sum = 0;
    for (int i = 0; i < PER; ++i) {
      const int j = t * PER + i;
      v[i] = j <= C ? bin[j] : 0;
      sum += v[i];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (t >= off) incl += o;
    }
    int run = incl - sum;
    for (int i = 0; i < PER; ++i) {
      const int j = t * PER + i;
      if (j <= C) bin[j] = run;
      run += v[i];
    }
  }
  __syncthreads();
  for (int k = 0; k < NPASS; ++k)
    list[atomicAdd(&bin[C - hits[k]], 1)] = (unsigned short)(t + k * C);
  __syncthreads();
}

}  // namespace sparkl_walk
