// Fused f32 XC build (E_xc, V_xc) for Hopper (sm_90a): kernels K1 (GGA body:
// PBE, B3LYP) and K2 (LDA body: LDA, and HF through the zero functional), K3
// (either body with phi_D on bf16 tensor cores, the TPU kernel's phi_split)
// and K1's ablation and reduction variants.
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
//   K3 replaces kernel 1 with xc_phi_split_kernel: the same 64 x 64 tiles,
//   but D and the AO tile are split into bf16 hi + lo while they are staged
//   and phi_D = D_h AO_h + D_h AO_l + D_l AO_h runs on the tensor cores
//   (mma.sync m16n8k16, f32 accumulation); see its note.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "xc_functional.cuh"

namespace {

constexpr int kTile = 64;         // output tile edge of both products
constexpr int kTk = 32;           // depth of one shared-memory stage
constexpr int kPointBlock = 128;  // grid points per block in kernel 2
constexpr int kPack = 1024;       // gpad granularity (the wrapper pads to it)
constexpr int kReduceBlock = 256;
constexpr int kTkSplit = kTk + 8;  // bf16 row stride of K3's split stages

// The variant word of fused_xc (engine/fused_xc.py builds it).  kPhiSplit
// and kNoPhi choose how phi_D is formed; at most one of the others changes
// the per-point pass.  kNoPhi..kNoV are ablations of the GGA body (results
// wrong by design: each removes one phase so that its time can be read off).
constexpr int kPhiSplit = 1;  // K3: phi_D as the 3-pass bf16 split
constexpr int kNoPhi = 2;     // phi_D := AO (a copy of the plane)
constexpr int kNoProd = 4;    // rho = sum phi_D, grad rho_k = 2 sum dAO_k
constexpr int kNoFunc = 8;    // e = rho, vrho = rho, vsigma = sigma
constexpr int kNoV = 16;      // no B^T, no V (V = 0); E as in K1
constexpr int kSplit2 = 32;   // row sums as sum bf16(x) + sum bf16(x - bf16(x))
constexpr int kPointBits = kNoProd | kNoFunc | kNoV | kSplit2;

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

// hi = bf16(x), lo = bf16(x - hi), both round-to-nearest-even (the TPU
// kernel's split, pallas_xc.py:142-145)
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8
// f32.  Fragments as PTX lays them out for m16n8k16 (g = lane / 4, t =
// lane % 4): a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)},
// b = {(k 2t.., n g), (k 2t + 8.., n g)}, c = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// K3: phi[mu, g] = D_h AO_h + D_h AO_l + D_l AO_h for one 64 x 64 tile,
// replacing pallas_xc.py's mm_phi (:157-161).  Each bf16 product is exact in
// f32 and the sums are f32, so the result carries the split's ~2^-16
// relative error (the dropped D_l AO_l) and not TF32's 2^-11.  What bounds
// it: 3 x 2 npad^2 FLOPs a point on the bf16 tensor cores (989 TFLOP/s)
// instead of 2 npad^2 on FP32 FMA (67), so the product is no longer the
// limit; the AO plane read and the phi_D write (8 npad bytes a point) are.
// Design: the same tiles, 32-deep stages and per-stage partial sums as
// xc_phi_kernel (stage_fma's reason).  The staging loop splits D and the AO
// tile into bf16 hi/lo in shared memory, the AO tile transposed (k
// contiguous, the layout of mma's col operand).  Eight warps, each a 16 x 32
// slab of the tile: four m16n8k16 products for each of the three passes and
// each k16 step.  Depth beyond npad stages as zeros (exact), rows of D
// beyond nao are zero in dm, so padded rows of phi_D stay exact zeros.
__global__ void __launch_bounds__(256)
xc_phi_split_kernel(int npad, int gpad, const float* __restrict__ dm,
                    const float* __restrict__ aot, float* __restrict__ phi) {
  // [hi, lo][m][k] = split(D[row0 + m][k0 + k]); [hi, lo][n][k] =
  // split(AO[k0 + k][col0 + n]); a row stride of 40 bf16 (20 words) makes
  // the fragment loads of a warp hit 32 distinct banks
  __shared__ __align__(16) __nv_bfloat16 a_s[2][kTile][kTkSplit];
  __shared__ __align__(16) __nv_bfloat16 b_s[2][kTile][kTkSplit];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 4) * 16;  // the warp's rows in the tile
  const int wn = (warp / 4) * 32;  // its columns
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;  // gpad % kTile == 0
  float acc[4][4] = {};
  for (int k0 = 0; k0 < npad; k0 += kTk) {
    for (int i = tid; i < kTile * kTk; i += 256) {
      const int m = i / kTk, k = i % kTk;  // D: consecutive threads along nu
      const int row = row0 + m, nu = k0 + k;
      const float d = (row < npad && nu < npad) ? dm[(size_t)row * npad + nu] : 0.f;
      split_bf16(d, &a_s[0][m][k], &a_s[1][m][k]);
      const int kb = i / kTile, n = i % kTile;  // AO: along the grid axis
      const int nub = k0 + kb;
      const float x = nub < npad ? aot[(size_t)nub * gpad + col0 + n] : 0.f;
      split_bf16(x, &b_s[0][n][kb], &b_s[1][n][kb]);
    }
    __syncthreads();
    float s[4][4] = {};  // this stage's partial sums
#pragma unroll
    for (int kk = 0; kk < kTk; kk += 16) {
      uint32_t a[2][4], b[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16* pa = &a_s[h][wm + g][kk + 2 * t];
        a[h][0] = ld_pair(pa);
        a[h][1] = ld_pair(pa + 8 * kTkSplit);
        a[h][2] = ld_pair(pa + 8);
        a[h][3] = ld_pair(pa + 8 * kTkSplit + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* pb = &b_s[h][wn + 8 * j + g][kk + 2 * t];
          b[h][j][0] = ld_pair(pb);
          b[h][j][1] = ld_pair(pb + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // small terms first
        mma_bf16(s[j], a[1], b[0][j]);  // D_l AO_h
        mma_bf16(s[j], a[0], b[1][j]);  // D_h AO_l
        mma_bf16(s[j], a[0], b[0][j]);  // D_h AO_h
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] += s[j][r];
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wm + g + 8 * h;
    if (row < npad) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(&phi[(size_t)row * gpad + col]) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// A sum over mu of one point's terms: plain f32, or (kSplit2) the bf16 hi
// and lo parts of each term summed apart, as the TPU kernel's 2-pass
// selector matmuls form its row sums (pallas_xc.py:187-197).
template <bool kSplit>
__device__ __forceinline__ void row_add(float x, float& hi, float& lo) {
  if constexpr (kSplit) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi += __bfloat162float(h);
    lo += __bfloat162float(__float2bfloat16_rn(x - __bfloat162float(h)));
  } else {
    hi += x;
  }
}

// Per-point pass: phi_bt holds phi_D on entry and B^T on exit.  VAR holds
// at most one of the kPointBits; VAR = 0 is K1/K2.
template <int KIND, int VAR>
__global__ void __launch_bounds__(kPointBlock)
xc_point_kernel(int npad, int gpad, const float* __restrict__ aot,
                const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gz, const float* __restrict__ wt,
                float* __restrict__ phi_bt, float* __restrict__ e_part) {
  constexpr bool kGrad = (KIND == 1 || KIND == 2);
  constexpr bool kProd = !(VAR & kNoProd);
  constexpr bool kSplit = (VAR & kSplit2) != 0;
  __shared__ float red_s[kPointBlock];
  __shared__ float red_l[kSplit ? kPointBlock : 1];
  const int tid = threadIdx.x;
  const int g = blockIdx.x * kPointBlock + tid;  // gpad % kPointBlock == 0

  float rho = 0.f, grx = 0.f, gry = 0.f, grz = 0.f;
  float rho_l = 0.f, grx_l = 0.f, gry_l = 0.f, grz_l = 0.f;
  for (int mu = 0; mu < npad; ++mu) {
    const size_t o = (size_t)mu * gpad + g;
    const float phi = phi_bt[o];
    if constexpr (kProd && !kSplit) {  // K1/K2 and the later ablations
      rho = fmaf(phi, aot[o], rho);
      if constexpr (kGrad) {
        grx = fmaf(gx[o], phi, grx);
        gry = fmaf(gy[o], phi, gry);
        grz = fmaf(gz[o], phi, grz);
      }
    } else {
      // the terms as the TPU kernel forms them: each product rounded to
      // f32 before it is split (__fmul_rn is never contracted into an fma)
      row_add<kSplit>(kProd ? __fmul_rn(phi, aot[o]) : phi, rho, rho_l);
      if constexpr (kGrad) {
        row_add<kSplit>(kProd ? __fmul_rn(gx[o], phi) : gx[o], grx, grx_l);
        row_add<kSplit>(kProd ? __fmul_rn(gy[o], phi) : gy[o], gry, gry_l);
        row_add<kSplit>(kProd ? __fmul_rn(gz[o], phi) : gz[o], grz, grz_l);
      }
    }
  }
  if constexpr (kSplit) {
    rho += rho_l;
    grx += grx_l;
    gry += gry_l;
    grz += grz_l;
  }
  grx *= 2.f;
  gry *= 2.f;
  grz *= 2.f;
  const float sigma = grx * grx + gry * gry + grz * grz;

  float e, vr, vs;
  if constexpr ((VAR & kNoFunc) != 0) {
    e = rho;
    vr = rho;
    vs = sigma;
  } else {
    xc::eval_point<KIND>(rho, sigma, &e, &vr, &vs);
  }
  const float w = wt[g];

  // block sum of w e in a fixed tree order (kSplit2: hi and lo parts apart)
  const float we = __fmul_rn(w, e);
  if constexpr (kSplit) {
    const __nv_bfloat16 h = __float2bfloat16_rn(we);
    red_s[tid] = __bfloat162float(h);
    red_l[tid] = __bfloat162float(__float2bfloat16_rn(we - __bfloat162float(h)));
  } else {
    red_s[tid] = we;
  }
  __syncthreads();
  for (int s = kPointBlock / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red_s[tid] += red_s[tid + s];
      if constexpr (kSplit) red_l[tid] += red_l[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) e_part[blockIdx.x] = kSplit ? red_s[0] + red_l[0] : red_s[0];

  if constexpr ((VAR & kNoV) == 0) {
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

template <int KIND, int VAR>
cudaError_t launch_point(int npad, int gpad, const float* aot, const float* gx,
                         const float* gy, const float* gz, const float* wt,
                         float* phi_bt, float* e_part, cudaStream_t stream) {
  xc_point_kernel<KIND, VAR><<<gpad / kPointBlock, kPointBlock, 0, stream>>>(
      npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part);
  return cudaGetLastError();
}

// The point pass for one kind and the point bits of the variant word; the
// ablations are instantiated for the GGA kinds only.
template <int KIND>
cudaError_t launch_point_var(int var, int npad, int gpad, const float* aot,
                             const float* gx, const float* gy, const float* gz,
                             const float* wt, float* phi_bt, float* e_part,
                             cudaStream_t stream) {
  switch (var & kPointBits) {
    case 0: return launch_point<KIND, 0>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream);
    case kSplit2: return launch_point<KIND, kSplit2>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream);
    default: break;
  }
  if constexpr (KIND == 1 || KIND == 2) {
    switch (var & kPointBits) {
      case kNoProd: return launch_point<KIND, kNoProd>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream);
      case kNoFunc: return launch_point<KIND, kNoFunc>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream);
      case kNoV: return launch_point<KIND, kNoV>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): 1 <= nao <= npad,
// npad % 8 == 0, gpad % 1024 == 0, chunk a positive multiple of 1024;
// dm (npad, npad), aot/gx/gy/gz/phi_bt (npad, gpad), wt (gpad),
// e_part (gpad / 128), v_part (ceil(gpad / chunk), ldv, ldv) with
// ldv = 64 ceil(npad / 64), v_out (nao, nao), e_out (1); gx/gy/gz may be
// null for kinds 0 and 3.  variant: 0 for K1/K2, else the k* bits above
// (kPhiSplit and kNoPhi exclusive, at most one point bit, the ablations
// for kinds 1 and 2 only).  Returns the CUDA error code of the launches
// (0 on success).
int fused_xc(int kind, int variant, int nao, int npad, int gpad, int chunk,
             const float* dm, const float* aot, const float* gx,
             const float* gy, const float* gz, const float* wt, float* phi_bt,
             float* e_part, float* v_part, float* v_out, float* e_out,
             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int point = variant & kPointBits;
  if (nao < 1 || nao > npad || npad % 8 != 0 || gpad % kPack != 0 ||
      chunk <= 0 || chunk % kPack != 0 || kind < 0 || kind > 3 ||
      (variant & ~(kPhiSplit | kNoPhi | kPointBits)) != 0 ||
      ((variant & kPhiSplit) && (variant & kNoPhi)) ||
      (point & (point - 1)) != 0 ||
      ((variant & (kNoPhi | kNoProd | kNoFunc | kNoV)) && kind != 1 && kind != 2))
    return (int)cudaErrorInvalidValue;
  const int ntile = (npad + kTile - 1) / kTile;
  const int ldv = ntile * kTile;
  const int nchunk = (gpad + chunk - 1) / chunk;

  cudaError_t err;
  if (variant & kNoPhi) {
    err = cudaMemcpyAsync(phi_bt, aot, sizeof(float) * npad * (size_t)gpad,
                          cudaMemcpyDeviceToDevice, stream);
  } else if (variant & kPhiSplit) {
    xc_phi_split_kernel<<<dim3(gpad / kTile, ntile), 256, 0, stream>>>(
        npad, gpad, dm, aot, phi_bt);
    err = cudaGetLastError();
  } else {
    xc_phi_kernel<<<dim3(gpad / kTile, ntile), dim3(16, 16), 0, stream>>>(
        npad, gpad, dm, aot, phi_bt);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  switch (kind) {
    case 0: err = launch_point_var<0>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
    case 1: err = launch_point_var<1>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
    case 2: err = launch_point_var<2>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
    default: err = launch_point_var<3>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  if (variant & kNoV) {  // V stays zero; the one reduce block sums E
    err = cudaMemsetAsync(v_out, 0, sizeof(float) * nao * (size_t)nao, stream);
    if (err != cudaSuccess) return (int)err;
    xc_reduce_kernel<<<1, kReduceBlock, 0, stream>>>(
        nao, nchunk, ldv, gpad / kPointBlock, v_part, e_part, v_out, e_out);
    return (int)cudaGetLastError();
  }
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
