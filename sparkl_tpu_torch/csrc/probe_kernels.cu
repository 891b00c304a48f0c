// Hand-written Hopper (sm_90a) microbenchmarks: the counterparts of the JAX
// package's two TPU probe scripts, each with a plain PyTorch version beside
// its wrapper in sparkl_tpu_torch/scripts/ (vreg_probe.py, layout_probe.py).
// They are on no path of the solver; they answer two questions about the
// port's own kernels on this card.
//
//   chain_kernel<R, EXP>          replaces scripts/vreg_probe.py: probe
//                                 (_chain_kernel). A serial chain on [R, 128]
//                                 tiles: N_OPS steps of x*0.999 + 0.001, or
//                                 N_OPS/16 steps of exp(-|x|) + 0.1*x. One
//                                 block of 128 threads per tile (the TPU
//                                 grid's program), one thread per lane, so
//                                 each thread carries R independent chains:
//                                 the Hopper counterpart of the TPU's R/8
//                                 vregs per op. Bound: operations (2.1e9 f32
//                                 operations for the fma chain at 8192 x 128,
//                                 ~0.032 ms at 67 TFLOP/s); at R = 128 the
//                                 grid is 64 blocks on 132 SMs. Question:
//                                 does one thread gain from carrying more
//                                 independent chains (ILP), or does filling
//                                 the card matter more? Kernel B is one long
//                                 serial body per lane.
//   layout_read_kernel<FM>        replaces scripts/layout_probe.py: bench
//                                 (k_chunk_major, k_field_major). Per chunk d,
//                                 acc[c] = sum_{k<48} row_k[c] * f32(1 +
//                                 0.001k), rows from the chunk-major [D, NF,
//                                 C] layout or the field-major [NF, D, C].
//                                 Bound: bytes (48 rows read, one written:
//                                 ~0.050 ms at 3.35 TB/s for D = 6656).
//   layout_rw_kernel<FM>          replaces scripts/layout_probe.py: bench_w
//                                 (kw_chunk_major, kw_field_major). The same
//                                 48 rows times f32(1.001), written to [D,
//                                 48, C] or [48, D, C]. Bound: bytes (~0.098
//                                 ms). Question for both: does the port's
//                                 chunk-major slot layout cost anything
//                                 against field-major on Hopper?
//
// The layout kernels take one block of C = 128 threads per chunk, as the
// port's slot kernels are launched (fused_kernels.cu); thread c reads its
// lane of each row, so a warp reads 128 contiguous bytes of a row in either
// layout.
//
// Rounding follows the JAX kernels run under jit (XLA contracts a*b + c
// into one FMA): each step is an explicit fmaf, and -fmad=false keeps the
// compiler from contracting anything else. The weights f32(1 + 0.001k) are
// formed in double, as the Python literal is, then rounded once.
//
// Each launcher is a plain C function that enqueues on the given stream and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it has no
// instance for); the caller allocates every output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=false   (no fast math)

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int C = 128;     // lanes of a tile, slots of a chunk
constexpr int NROWS = 48;  // rows each layout kernel reads

template <int R, bool EXP>
__global__ void __launch_bounds__(C) chain_kernel(const float* __restrict__ x,
                                                   float* __restrict__ out, int n_ops) {
  const size_t base = (size_t)blockIdx.x * R * C + threadIdx.x;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = x[base + (size_t)r * C];
  if (EXP) {
    for (int s = 0; s < n_ops / 16; ++s) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = fmaf(0.1f, v[r], expf(-fabsf(v[r])));
    }
  } else {
    for (int s = 0; s < n_ops; ++s) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = fmaf(v[r], 0.999f, 0.001f);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[base + (size_t)r * C] = v[r];
}

// Row k of chunk d: [D, NF, C] chunk-major, [NF, D, C] field-major.
template <bool FIELD_MAJOR>
__device__ __forceinline__ size_t row_of(int d, int k, int d_count, int nf) {
  return FIELD_MAJOR ? (size_t)k * d_count + d : (size_t)d * nf + k;
}

template <bool FIELD_MAJOR>
__global__ void __launch_bounds__(C) layout_read_kernel(const float* __restrict__ x,
                                                         float* __restrict__ out, int d_count,
                                                         int nf) {
  const int d = blockIdx.x;
  const int c = threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < NROWS; ++k) {
    const float w = (float)(1.0 + 0.001 * (double)k);
    acc = fmaf(x[row_of<FIELD_MAJOR>(d, k, d_count, nf) * C + c], w, acc);
  }
  out[(size_t)d * C + c] = acc;
}

template <bool FIELD_MAJOR>
__global__ void __launch_bounds__(C) layout_rw_kernel(const float* __restrict__ x,
                                                       float* __restrict__ out, int d_count,
                                                       int nf) {
  const int d = blockIdx.x;
  const int c = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NROWS; ++k) {
    out[row_of<FIELD_MAJOR>(d, k, d_count, NROWS) * C + c] =
        x[row_of<FIELD_MAJOR>(d, k, d_count, nf) * C + c] * 1.001f;
  }
}

template <int R>
void launch_chain(const float* x, float* out, int rows, int n_ops, bool exp_kind,
                  cudaStream_t stream) {
  if (exp_kind) {
    chain_kernel<R, true><<<rows / R, C, 0, stream>>>(x, out, n_ops);
  } else {
    chain_kernel<R, false><<<rows / R, C, 0, stream>>>(x, out, n_ops);
  }
}

}  // namespace

extern "C" {

int sparkl_vreg_chain(const float* x, float* out, int rows, int r, int n_ops, int transcend,
                      void* stream) {
  if (rows <= 0 || r <= 0 || rows % r != 0 || n_ops < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 8: launch_chain<8>(x, out, rows, n_ops, transcend, s); break;
    case 16: launch_chain<16>(x, out, rows, n_ops, transcend, s); break;
    case 32: launch_chain<32>(x, out, rows, n_ops, transcend, s); break;
    case 64: launch_chain<64>(x, out, rows, n_ops, transcend, s); break;
    case 128: launch_chain<128>(x, out, rows, n_ops, transcend, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sparkl_layout_read(const float* x, float* out, int d_count, int nf, int field_major,
                       void* stream) {
  if (d_count <= 0 || nf < NROWS) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (field_major) {
    layout_read_kernel<true><<<d_count, C, 0, s>>>(x, out, d_count, nf);
  } else {
    layout_read_kernel<false><<<d_count, C, 0, s>>>(x, out, d_count, nf);
  }
  return (int)cudaGetLastError();
}

int sparkl_layout_rw(const float* x, float* out, int d_count, int nf, int field_major,
                     void* stream) {
  if (d_count <= 0 || nf < NROWS) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (field_major) {
    layout_rw_kernel<true><<<d_count, C, 0, s>>>(x, out, d_count, nf);
  } else {
    layout_rw_kernel<false><<<d_count, C, 0, s>>>(x, out, d_count, nf);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
