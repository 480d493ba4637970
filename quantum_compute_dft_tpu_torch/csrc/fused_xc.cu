// Fused f32 XC build (E_xc, V_xc) for Hopper (sm_90a): kernels K1 (GGA body:
// PBE, B3LYP) and K2 (LDA body: LDA, and HF through the zero functional).
//
// Replaces quantum_compute_dft_tpu/engine/pallas_xc.py::_make_kernel (entered
// through xc_step_pallas_packed / xc_step_pallas).  Same arithmetic, not the
// same block layout: per grid point g (AO planes stored transposed,
// (npad, gpad), grid axis contiguous)
//
//   phi_D = D . AO_g ;  rho = sum_mu phi_D,mu AO_mu,g
//   grad rho_k = 2 sum_mu dAO_k,mu,g phi_D,mu ;  sigma = |grad rho|^2
//   (e, vrho, vsigma) = functional (xc_functional.cuh: floors, f32 clamps)
//   E   = sum_g w e
//   B^T = w vrho AO + 2 w vsigma sum_k grad_k rho dAO_k
//   V   = AO B ;  V_out = (V + V^T) / 2
//
// What bounds it on this card.  At the in-core sizes (nao <= 64) one call
// reads the AO (+3 gradient) planes once, writes B^T once and reads it and
// the AO plane back for V: ~ (4 + 3) npad gpad 4 bytes = 155 MB at benzene
// (npad 40, 138,240 padded points), ~46 us of HBM at 3.35 TB/s.  The FLOPs
// are 2 npad^2 per point for phi_D and 2 * 64^2 for V: ~1.6 GFLOP, ~25 us of
// FP32 FMA.  So the call is bound by memory traffic and by the per-point
// functional (~300 dependent f32 ops with libm calls, no tensor cores), and
// at these sizes also by launch overhead.
//
// Design (three kernels, deterministic):
//   1. xc_point_kernel: one thread per grid point, 128 points per block.  D
//      lives in shared memory (npad^2 f32 <= 16 KB); the block's AO columns
//      are staged through shared memory ([mu][thread], conflict-free), then
//      each thread loops over mu forming phi_D,mu with plain FP32 FMA (no
//      TF32: phi_D feeds the density), accumulates rho and grad rho, runs
//      the functional in registers, writes its B^T column and reduces w e
//      over the block in a fixed tree.
//   2. xc_v_partial_kernel: V over the grid axis, split-K: one block per
//      1024-point chunk computes the full (64 x 64) partial product of the
//      AO and B^T tiles (shared-memory tiles, 4x4 register tile per thread).
//   3. xc_reduce_kernel: sums the chunk partials in chunk order and
//      symmetrizes; one extra block sums the E partials in a fixed order.
// No float atomics anywhere: every sum runs in the same order on every call,
// so SCF trajectories are reproducible run to run.  The TPU kernel's bf16
// splits, ones-row matmul reductions and (8, tile/8) subtiling are MXU and
// Mosaic devices and are not carried over.
//
// Limits: npad <= 64 (the in-core path, nao <= 64).  Density-fitting-scale
// nao needs a tiled phi_D and V, which comes with the density-fitting port.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC fused_xc.cu   (never --use_fast_math)
#include <cuda_runtime.h>

#include "xc_functional.cuh"

namespace {

constexpr int kMaxN = 64;        // largest supported npad
constexpr int kPointBlock = 128; // grid points per block in kernel 1
constexpr int kChunk = 1024;     // grid points per V partial (kernel 2)
constexpr int kTk = 32;          // grid points per shared-memory V tile
constexpr int kReduceBlock = 256;

template <int KIND>
__global__ void __launch_bounds__(kPointBlock)
xc_point_kernel(int npad, int gpad, const float* __restrict__ dm,
                const float* __restrict__ aot, const float* __restrict__ gx,
                const float* __restrict__ gy, const float* __restrict__ gz,
                const float* __restrict__ wt, float* __restrict__ bt,
                float* __restrict__ e_part) {
  constexpr bool kGrad = (KIND == 1 || KIND == 2);
  extern __shared__ float smem[];
  float* dm_s = smem;                            // [npad][npad]
  float* ao_s = smem + npad * npad;              // [npad][kPointBlock]
  float* red_s = ao_s + npad * kPointBlock;      // [kPointBlock]
  const int tid = threadIdx.x;
  const int g = blockIdx.x * kPointBlock + tid;  // gpad % kPointBlock == 0

  for (int i = tid; i < npad * npad; i += kPointBlock) dm_s[i] = dm[i];
  for (int mu = 0; mu < npad; ++mu)
    ao_s[mu * kPointBlock + tid] = aot[(size_t)mu * gpad + g];
  __syncthreads();

  float rho = 0.f, grx = 0.f, gry = 0.f, grz = 0.f;
  for (int mu = 0; mu < npad; ++mu) {
    const float* drow = dm_s + mu * npad;
    float phi = 0.f;
    for (int nu = 0; nu < npad; ++nu)
      phi = fmaf(drow[nu], ao_s[nu * kPointBlock + tid], phi);
    rho = fmaf(phi, ao_s[mu * kPointBlock + tid], rho);
    if constexpr (kGrad) {
      const size_t o = (size_t)mu * gpad + g;
      grx = fmaf(gx[o], phi, grx);
      gry = fmaf(gy[o], phi, gry);
      grz = fmaf(gz[o], phi, grz);
    }
  }
  grx *= 2.f;
  gry *= 2.f;
  grz *= 2.f;
  const float sigma = grx * grx + gry * gry + grz * grz;

  float e, vr, vs;
  xc::eval_point<KIND>(rho, sigma, &e, &vr, &vs);
  const float w = wt[g];

  // block sum of w e in a fixed tree order
  red_s[tid] = w * e;
  __syncthreads();
  for (int s = kPointBlock / 2; s > 0; s >>= 1) {
    if (tid < s) red_s[tid] += red_s[tid + s];
    __syncthreads();
  }
  if (tid == 0) e_part[blockIdx.x] = red_s[0];

  // B^T column: padded rows have AO = dAO = 0 and padded points w = 0, so
  // both contribute exact zeros to V
  const float wvr = w * vr;
  const float wvs = 2.f * w * vs;
  const float ux = wvs * grx, uy = wvs * gry, uz = wvs * grz;
  for (int mu = 0; mu < npad; ++mu) {
    const size_t o = (size_t)mu * gpad + g;
    float b = wvr * ao_s[mu * kPointBlock + tid];
    if constexpr (kGrad) b = b + ux * gx[o] + uy * gy[o] + uz * gz[o];
    bt[o] = b;
  }
}

// V_part[c] = AO[:, chunk c] . B^T[:, chunk c]^T as a kMaxN x kMaxN tile
// (rows/cols >= npad are zero).  16 x 16 threads, 4 x 4 outputs each:
// row = ty + 16 i, col = tx + 16 j.
__global__ void __launch_bounds__(256)
xc_v_partial_kernel(int npad, int gpad, const float* __restrict__ aot,
                    const float* __restrict__ bt, float* __restrict__ v_part) {
  __shared__ float a_s[kTk][kMaxN + 1];
  __shared__ float b_s[kTk][kMaxN + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int g0 = blockIdx.x * kChunk;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < kChunk; k0 += kTk) {
    // load the (kMaxN x kTk) tiles, grid index fastest (coalesced)
    for (int i = tid; i < kMaxN * kTk; i += 256) {
      const int mu = i / kTk, k = i % kTk;
      const size_t o = (size_t)mu * gpad + g0 + k0 + k;
      a_s[k][mu] = mu < npad ? aot[o] : 0.f;
      b_s[k][mu] = mu < npad ? bt[o] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTk; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = v_part + (size_t)blockIdx.x * kMaxN * kMaxN;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(ty + 16 * i) * kMaxN + tx + 16 * j] = acc[i][j];
}

// V_out (nao x nao) = sym(sum_c V_part[c]); the last block reduces E.
__global__ void __launch_bounds__(kReduceBlock)
xc_reduce_kernel(int nao, int nchunk, int npart_e,
                 const float* __restrict__ v_part,
                 const float* __restrict__ e_part, float* __restrict__ v_out,
                 float* __restrict__ e_out) {
  __shared__ float red_s[kReduceBlock];
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {
    float s = 0.f;
    for (int i = tid; i < npart_e; i += kReduceBlock) s += e_part[i];
    red_s[tid] = s;
    __syncthreads();
    for (int h = kReduceBlock / 2; h > 0; h >>= 1) {
      if (tid < h) red_s[tid] += red_s[tid + h];
      __syncthreads();
    }
    if (tid == 0) e_out[0] = red_s[0];
    return;
  }
  const int o = blockIdx.x * kReduceBlock + tid;
  if (o >= nao * nao) return;
  const int mu = o / nao, nu = o % nao;
  float a = 0.f, b = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const float* p = v_part + (size_t)c * kMaxN * kMaxN;
    a += p[mu * kMaxN + nu];
    b += p[nu * kMaxN + mu];
  }
  v_out[o] = 0.5f * (a + b);
}

template <int KIND>
__global__ void xc_eval_kernel(int n, const float* __restrict__ rho,
                               const float* __restrict__ sigma,
                               float* __restrict__ e, float* __restrict__ vr,
                               float* __restrict__ vs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  xc::eval_point<KIND>(rho[i], sigma ? sigma[i] : 0.f, e + i, vr + i, vs + i);
}

template <int KIND>
cudaError_t launch_point(int npad, int gpad, const float* dm, const float* aot,
                         const float* gx, const float* gy, const float* gz,
                         const float* wt, float* bt, float* e_part,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)npad * npad + (size_t)npad * kPointBlock + kPointBlock);
  cudaError_t err = cudaFuncSetAttribute(
      xc_point_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  xc_point_kernel<KIND><<<gpad / kPointBlock, kPointBlock, smem, stream>>>(
      npad, gpad, dm, aot, gx, gy, gz, wt, bt, e_part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): 1 <= nao <= npad <= 64,
// gpad % 1024 == 0; dm (npad, npad), aot/gx/gy/gz/bt (npad, gpad), wt (gpad),
// e_part (gpad / 128), v_part (gpad / 1024, 64, 64), v_out (nao, nao),
// e_out (1); gx/gy/gz may be null for kinds 0 and 3.  Returns the CUDA
// error code of the launches (0 on success).
int fused_xc(int kind, int nao, int npad, int gpad, const float* dm,
             const float* aot, const float* gx, const float* gy, const float* gz,
             const float* wt, float* bt, float* e_part, float* v_part,
             float* v_out, float* e_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nao < 1 || nao > npad || npad > kMaxN || gpad % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (kind) {
    case 0: err = launch_point<0>(npad, gpad, dm, aot, gx, gy, gz, wt, bt, e_part, stream); break;
    case 1: err = launch_point<1>(npad, gpad, dm, aot, gx, gy, gz, wt, bt, e_part, stream); break;
    case 2: err = launch_point<2>(npad, gpad, dm, aot, gx, gy, gz, wt, bt, e_part, stream); break;
    case 3: err = launch_point<3>(npad, gpad, dm, aot, gx, gy, gz, wt, bt, e_part, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int nchunk = gpad / kChunk;
  xc_v_partial_kernel<<<nchunk, dim3(16, 16), 0, stream>>>(npad, gpad, aot, bt, v_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (nao * nao + kReduceBlock - 1) / kReduceBlock + 1;
  xc_reduce_kernel<<<nblk, kReduceBlock, 0, stream>>>(
      nao, nchunk, gpad / kPointBlock, v_part, e_part, v_out, e_out);
  return (int)cudaGetLastError();
}

// The kernels' functional alone, elementwise over n points (the
// finiteness check over extreme (rho, sigma) runs through this entry).
int xc_functional_eval(int kind, int n, const float* rho, const float* sigma,
                       float* e, float* vr, float* vs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blk = 256, grid = (n + blk - 1) / blk;
  switch (kind) {
    case 0: xc_eval_kernel<0><<<grid, blk, 0, stream>>>(n, rho, sigma, e, vr, vs); break;
    case 1: xc_eval_kernel<1><<<grid, blk, 0, stream>>>(n, rho, sigma, e, vr, vs); break;
    case 2: xc_eval_kernel<2><<<grid, blk, 0, stream>>>(n, rho, sigma, e, vr, vs); break;
    case 3: xc_eval_kernel<3><<<grid, blk, 0, stream>>>(n, rho, sigma, e, vr, vs); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
