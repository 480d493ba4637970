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
// What bounds it on this card.  Two products of 2 npad^2 FLOPs per point
// (phi_D and V) in plain FP32 FMA: at DHA (npad 152, ~635k points) ~29
// GFLOP each, against 67 TFLOP/s of FP32 FMA outside the tensor cores; the
// planes are ~0.4 GB (AO + 3 gradients) plus phi_D / B^T written and read
// once, ~0.2 ms of HBM at 3.35 TB/s.  So at density-fitting sizes the call
// is bound by FP32 FMA throughput; at the in-core sizes (npad <= 64) by
// memory traffic, the per-point functional (~300 dependent f32 ops with
// libm calls) and launch overhead.
//
// Design (four kernels, deterministic, any npad that is a multiple of 8):
//   1. xc_phi_kernel: phi_D = D . AO as a tiled product, one 64 (mu) x 64
//      (points) output tile per block through shared-memory stages of 32
//      nu, a 4 x 4 register tile per thread; each output sums nu in order
//      with plain FP32 FMA, stage by stage (no TF32: phi_D feeds the
//      density).
//   2. xc_point_kernel: one thread per grid point reads its phi_D column,
//      forms rho and grad rho (mu in order), runs the functional in
//      registers, reduces w e over the block in a fixed tree, and writes
//      its B^T column over its phi_D column (each thread owns one column,
//      so the in-place overwrite is safe and the scratch is one plane).
//   3. xc_v_partial_kernel: V over the grid axis, split-K: a 2-D grid of
//      64 x 64 output tiles times grid chunks, each block one tile of one
//      chunk's AO . B (same register tiling as kernel 1).
//   4. xc_reduce_kernel: sums the chunk partials in chunk order and
//      symmetrizes; one extra block sums the E partials in a fixed order.
// No float atomics anywhere: every sum runs in the same order on every call,
// so SCF trajectories are reproducible run to run.  The wrapper picks the
// chunk so that tiles x chunks stays near a fixed block count, which bounds
// the partial buffer (~32 MB) whatever npad and the grid size are.  The TPU
// kernel's bf16 splits, ones-row matmul reductions, (8, tile/8) subtiling
// and npad-dependent grid tile are MXU / VMEM devices and are not carried
// over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC fused_xc.cu   (never --use_fast_math)
#include <cuda_runtime.h>

#include "xc_functional.cuh"

namespace {

constexpr int kTile = 64;         // output tile edge of both products
constexpr int kTk = 32;           // depth of one shared-memory stage
constexpr int kPointBlock = 128;  // grid points per block in kernel 2
constexpr int kPack = 1024;       // gpad granularity (the wrapper pads to it)
constexpr int kReduceBlock = 256;

// acc += a_s^T b_s over one stage: 16 x 16 threads, 4 x 4 outputs each at
// row = ty + 16 i, col = tx + 16 j.  The stage's 32 products are summed
// apart and then added to acc, so a sum over K terms carries the rounding
// of ~32 + K/32 additions rather than K (measured: a straight FMA chain
// over 2,048-point chunks left V 2.7e-5 from the f64 engine at npad 384).
__device__ __forceinline__ void stage_fma(float (*a_s)[kTile + 1],
                                          float (*b_s)[kTile + 1], int tx,
                                          int ty, float (&acc)[4][4]) {
  float s[4][4] = {};
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
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += s[i][j];
}

// phi[mu, g] = sum_nu D[mu, nu] AO[nu, g] for one 64 x 64 tile.  Rows and
// depth beyond npad read as zero (exact zeros in the FMA chain).
__global__ void __launch_bounds__(256)
xc_phi_kernel(int npad, int gpad, const float* __restrict__ dm,
              const float* __restrict__ aot, float* __restrict__ phi) {
  __shared__ float a_s[kTk][kTile + 1];  // a_s[k][m] = D[row0 + m][k0 + k]
  __shared__ float b_s[kTk][kTile + 1];  // b_s[k][n] = AO[k0 + k][col0 + n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;  // gpad % kTile == 0
  float acc[4][4] = {};
  for (int k0 = 0; k0 < npad; k0 += kTk) {
    for (int i = tid; i < kTile * kTk; i += 256) {
      // D tile: consecutive threads along nu (D is row-major)
      const int m = i / kTk, k = i % kTk;
      const int row = row0 + m, nu = k0 + k;
      a_s[k][m] = (row < npad && nu < npad) ? dm[(size_t)row * npad + nu] : 0.f;
      // AO tile: consecutive threads along the grid axis
      const int kb = i / kTile, n = i % kTile;
      const int nub = k0 + kb;
      b_s[kb][n] = nub < npad ? aot[(size_t)nub * gpad + col0 + n] : 0.f;
    }
    __syncthreads();
    stage_fma(a_s, b_s, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < npad) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        phi[(size_t)row * gpad + col0 + tx + 16 * j] = acc[i][j];
    }
  }
}

// Per-point pass: phi_bt holds phi_D on entry and B^T on exit.
template <int KIND>
__global__ void __launch_bounds__(kPointBlock)
xc_point_kernel(int npad, int gpad, const float* __restrict__ aot,
                const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gz, const float* __restrict__ wt,
                float* __restrict__ phi_bt, float* __restrict__ e_part) {
  constexpr bool kGrad = (KIND == 1 || KIND == 2);
  __shared__ float red_s[kPointBlock];
  const int tid = threadIdx.x;
  const int g = blockIdx.x * kPointBlock + tid;  // gpad % kPointBlock == 0

  float rho = 0.f, grx = 0.f, gry = 0.f, grz = 0.f;
  for (int mu = 0; mu < npad; ++mu) {
    const size_t o = (size_t)mu * gpad + g;
    const float phi = phi_bt[o];
    rho = fmaf(phi, aot[o], rho);
    if constexpr (kGrad) {
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
    float b = wvr * aot[o];
    if constexpr (kGrad) b = b + ux * gx[o] + uy * gy[o] + uz * gz[o];
    phi_bt[o] = b;
  }
}

// V_part[c] tile (row0.., col0..) = AO[rows, chunk c] . B^T[cols, chunk c]^T;
// rows/cols >= npad are written as zero.  v_part is (nchunk, ldv, ldv).
__global__ void __launch_bounds__(256)
xc_v_partial_kernel(int npad, int gpad, int chunk, int ldv,
                    const float* __restrict__ aot, const float* __restrict__ bt,
                    float* __restrict__ v_part) {
  __shared__ float a_s[kTk][kTile + 1];  // a_s[k][m] = AO[row0 + m][g0 + k]
  __shared__ float b_s[kTk][kTile + 1];  // b_s[k][n] = B^T[col0 + n][g0 + k]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int g0 = blockIdx.z * chunk;
  const int g1 = min(g0 + chunk, gpad);  // both multiples of kTk
  float acc[4][4] = {};
  for (int k0 = g0; k0 < g1; k0 += kTk) {
    // (kTile x kTk) tiles, grid index fastest (coalesced)
    for (int i = tid; i < kTile * kTk; i += 256) {
      const int m = i / kTk, k = i % kTk;
      const int ra = row0 + m, rb = col0 + m;
      a_s[k][m] = ra < npad ? aot[(size_t)ra * gpad + k0 + k] : 0.f;
      b_s[k][m] = rb < npad ? bt[(size_t)rb * gpad + k0 + k] : 0.f;
    }
    __syncthreads();
    stage_fma(a_s, b_s, tx, ty, acc);
    __syncthreads();
  }
  float* out = v_part + (size_t)blockIdx.z * ldv * ldv;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(row0 + ty + 16 * i) * ldv + col0 + tx + 16 * j] = acc[i][j];
}

// V_out (nao x nao) = sym(sum_c V_part[c]); the last block reduces E.
__global__ void __launch_bounds__(kReduceBlock)
xc_reduce_kernel(int nao, int nchunk, int ldv, int npart_e,
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
    const float* p = v_part + (size_t)c * ldv * ldv;
    a += p[(size_t)mu * ldv + nu];
    b += p[(size_t)nu * ldv + mu];
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
cudaError_t launch_point(int npad, int gpad, const float* aot, const float* gx,
                         const float* gy, const float* gz, const float* wt,
                         float* phi_bt, float* e_part, cudaStream_t stream) {
  xc_point_kernel<KIND><<<gpad / kPointBlock, kPointBlock, 0, stream>>>(
      npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): 1 <= nao <= npad,
// npad % 8 == 0, gpad % 1024 == 0, chunk a positive multiple of 1024;
// dm (npad, npad), aot/gx/gy/gz/phi_bt (npad, gpad), wt (gpad),
// e_part (gpad / 128), v_part (ceil(gpad / chunk), ldv, ldv) with
// ldv = 64 ceil(npad / 64), v_out (nao, nao), e_out (1); gx/gy/gz may be
// null for kinds 0 and 3.  Returns the CUDA error code of the launches
// (0 on success).
int fused_xc(int kind, int nao, int npad, int gpad, int chunk, const float* dm,
             const float* aot, const float* gx, const float* gy, const float* gz,
             const float* wt, float* phi_bt, float* e_part, float* v_part,
             float* v_out, float* e_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nao < 1 || nao > npad || npad % 8 != 0 || gpad % kPack != 0 ||
      chunk <= 0 || chunk % kPack != 0 || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  const int ntile = (npad + kTile - 1) / kTile;
  const int ldv = ntile * kTile;
  const int nchunk = (gpad + chunk - 1) / chunk;

  xc_phi_kernel<<<dim3(gpad / kTile, ntile), dim3(16, 16), 0, stream>>>(
      npad, gpad, dm, aot, phi_bt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (kind) {
    case 0: err = launch_point<0>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
    case 1: err = launch_point<1>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
    case 2: err = launch_point<2>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
    default: err = launch_point<3>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  xc_v_partial_kernel<<<dim3(ntile, ntile, nchunk), dim3(16, 16), 0, stream>>>(
      npad, gpad, chunk, ldv, aot, phi_bt, v_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (nao * nao + kReduceBlock - 1) / kReduceBlock + 1;
  xc_reduce_kernel<<<nblk, kReduceBlock, 0, stream>>>(
      nao, nchunk, ldv, gpad / kPointBlock, v_part, e_part, v_out, e_out);
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
