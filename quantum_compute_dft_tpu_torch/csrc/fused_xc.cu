// Fused f32 XC build (E_xc, V_xc) for Hopper (sm_90a): kernels K1 (GGA body:
// PBE, B3LYP) and K2 (LDA body: LDA, and HF through the zero functional), K3
// (either body with phi_D as the 3-pass bf16 split, the TPU kernel's
// phi_split) and the ablations phi3 (K3's GGA body), nophi (no phi_D
// product) and nov (no V) on K1's and K2's kernels, and the ablations noprod
// and nofunc and the split2 reduction, which run on the four-kernel pipeline
// that was K1's design until it was redesigned (K1base below).
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
//   B^T = w vrho AO + c w vsigma sum_k grad_k rho dAO_k
//   V   = AO B ;  V_out = (V + V^T) / 2
//
// c = 4 (the u_scale argument of the entries) makes V_out = dE_xc/dD; the
// JAX package's kernel has c = 2, half the sigma term, which u_scale = 2
// reproduces for comparisons with it.
//
// The four-kernel pipeline: K1base (the GGA body as K1 ran it before its
// redesign, kept as the base noprod and nofunc are timed against), the
// ablations noprod and nofunc, split2, and K3 with split2.
// What bounds them on this card: two products of 2 npad^2 FLOPs per point
// (phi_D and V) in plain FP32 FMA (K3: phi_D on bf16 tensor cores): at DHA
// (npad 152, ~635k points) ~29 GFLOP each against 67 TFLOP/s of FP32 FMA;
// the planes are ~0.4 GB (AO + 3 gradients) plus phi_D / B^T written and
// read once.  Design (four kernels, deterministic, any npad that is a
// multiple of 8):
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
//   K3 with split2 replaces kernel 1 with xc_phi_split_kernel: 64 x 64 tiles,
//   but D and the AO tile are split into bf16 hi + lo while they are staged
//   and phi_D = D_h AO_h + D_h AO_l + D_l AO_h runs on the tensor cores
//   (mma.sync m16n8k16, f32 accumulation); see its note.
//
// K1 and K2 (the GGA body, pallas_xc.py:201-265, and the LDA body, :269-291;
// no variant) have a design of their own for this card.  Both ran the four
// kernels above until they measured, at DHA, 5.4-5.8 ms (K1) and 4.5-5.0 ms
// (K2), bound by FP32 FMA products at ~22 TFLOP/s (8 shared loads per 16
// FMAs), padding to 64-row tiles (ldv 192 at npad 152: 26% more phi_D work,
// 60% more V) and ~5 GB of HBM traffic (AO re-read per row tile, phi_D
// written and re-read, B^T written and re-read per V tile).  Now each body is
// two kernels and the reduce, on the tensor cores, with no phi_D or B^T
// plane in HBM (after xc_pad_dm_kernel, the f32 padded copy of the caller's
// f64 density):
//   1. xc_rho_kernel / xc_rho_res_kernel<KIND>: per 64-point column tile,
//      phi_D^T = AO^T D^T (m = points, n = mu in 8-wide tiles, so no row
//      padding; k = nu) with all npad mu in one block's registers, rho from
//      the accumulators against the staged AO tile and (K1) grad rho_k =
//      2 sum phi_D dAO_k from the accumulators against the gradient planes,
//      read once straight from HBM at the fragment positions (three gradient
//      tiles do not fit in shared memory beside D and two AO tiles at npad
//      152).
//      Then, per point (shuffles, then shared memory, fixed order), the
//      functional (xc_functional.cuh), s_g = w vrho, (K1) u_k,g = c w vsigma
//      grad_k rho, and the tile's E partial: 1 (K2) or 4 (K1) floats a
//      point where the old design wrote a phi_D plane.  AO and the gradient
//      planes are read from HBM once.  Where D fits in shared memory (npad
//      <= 176 for K2, <= 168 for K1, whose reduction scratch is larger) it
//      stays resident in a persistent block of two independent 8-warp
//      groups; above, D streams in 32-deep slabs through a cp.async ring.
//   2. V over the 32 x 32 output tiles on or above the diagonal (16 x 8
//      sub-tiles wholly below it or beyond npad skipped: npad 152 computes
//      12,800 entries, not 192^2), one tile a warp, split-K over grid chunks.
//      Both operands are rows of (npad, points) planes with the grid axis as
//      k, as the planes are stored.
//      K2, xc_lda_v_kernel: V = AO diag(s) AO^T, symmetric; one staged AO
//      slab feeds both operands, s_g AO formed at fragment load; up to 16
//      tiles a block (one tile block per chunk up to npad 160).
//      K1, xc_gga_v_kernel: V + V^T = A B^T + B A^T (A = AO, B = s AO +
//      sum_k u_k dAO_k; a syr2k over the upper tiles).  The AO and gradient
//      planes stream in 16-point slabs (four planes of 32-deep slabs would
//      not fit a ring) and one pass per slab forms B's slab in shared
//      memory, each element once, a slab ahead of the products that read
//      it: no B^T plane exists.  Up to npad 160 one block holds all 15
//      tiles; above, tile rows form groups of 3 (96 rows) and a block takes
//      the tiles of one pair of groups, staging only those rows (<= 192).
//      When every warp issued its share of the copies between its products,
//      staging four planes did not overlap with the products and took a
//      large share of the kernel's time, so one warpgroup only copies,
//      ahead of the others, through mbarriers.
//   3. xc_reduce_kernel<true, double>: sums the chunk partials in chunk
//      order and mirrors the upper triangle (K1: times 1/2, exact); E
//      partials in a fixed order; writes E and V in the caller's f64.
// Both products run as 3 x TF32 on mma.sync m16n8k8 (hi = tf32(x), lo =
// x - hi; hi.lo + lo.hi + hi.hi, f32 accumulation, per-stage partial sums):
// f32-class (~2^-22), as the TPU kernel's phi_D at HIGHEST, because a
// coarser phi_D feeds the density and was measured to cost SCF cycles
// (pallas_xc.py:131-141: benzene 25 -> 31 with the 3-pass bf16 phi_D).  V
// takes the same path (the TPU's own V was the 3-pass bf16 split).  At DHA
// (npad 152, gpad 633,856) the two products are 29.3 GFLOP each (MMA work
// three times that), and K1's inputs 1.54 GB (AO and three gradient planes,
// each read twice by this design); K2's 0.39 GB.  What bounds them (H100,
// 700 W, chip_smoke.py's profiler split, K2: rho 0.72 ms, V 0.46, reduce
// 0.04): the products run at ~120 (rho) and ~105 (V) TFLOP/s of the ~320
// that mma.sync TF32 reaches on this card with no operand traffic; the
// fragment loads and splits (shared loads, integer rounding) and the issue
// of three mma per product take the rest.  K1 (the same split): rho 1.07 ms,
// V 1.16, reduce 0.02; its rho kernel also waits on the gradient planes in
// the fold, and its V kernel moves four planes.  wgmma,
// which reads both operands from shared memory, is the next step for V
// (both operands are K-major, as tf32 wgmma needs).
//
// K3 (either body, pallas_xc.py:157-161 at :225 and :281) and phi3 (:221-
// 223) compute phi_D as mm_phi does, D_h AO_h + D_h AO_l + D_l AO_h with hi
// = bf16(x), lo = bf16(x - hi) (round to nearest) and D_l AO_l dropped, and
// everything after phi_D as K1 and K2.  On the old pipeline they wrote a
// phi_D plane, overwrote it with B^T and read it again in FP32 FMA V tiles
// (4.0-4.8 ms at DHA).  Now they are K1's and K2's kernels with the rho
// kernels' product in a second mode (template MODE, kBf16x3; fused_xc_tc's
// mode argument): xc_split_dm_kernel splits the f32 density once per call
// into bf16 hi and lo planes (in the bytes of the f32 copy), which the rho
// kernel stages as K1 stages D; the AO tile stays f32 in shared memory (the
// fold reads it) at row stride 68, and its A fragments, pairs of nu rows,
// are split at load (cvt.rn.bf16x2).  Each k16 step is three m16n8k16 bf16
// mma where 3 x TF32 takes six m16n8k8, and the B fragments are single
// 32-bit loads with no split; f32 accumulators, per-stage partial sums
// (stage_fma's reason).  A last half step (npad % 16 == 8) zeroes the upper
// fragments.  No phi_D or B^T plane exists.  The f32 V of the plain version
// is computed as K1's and K2's 3 x TF32 V.
//
// The ablations nophi (pallas_xc.py:219-220, phi_D := AO) and nov (:262, no
// B^T and no V: V = 0) exist to attribute K1's time to its two products, so
// they run K1's own kernels through fused_xc_tc's mode word: K1 - nov is
// V, and K1's rho kernel - nophi's is the phi_D product with D's staging.
// nophi is the rho kernels' third product mode, kPhiAo: no density is
// padded or staged (no xc_pad_dm_kernel, no D ring, no resident D, no k
// steps) and each pass's accumulators are filled from the staged AO tile at
// the C fragment positions the fold reads, so the fold, the functional, V
// and the reduce run as K1's.  It keeps K1's AO stride and K1's choice of
// resident or streaming kernel at each npad (without D the resident one
// would fit at any npad, but the subtraction needs one pipeline); the
// streaming kernel keeps its steps, which then only stage AO rows, since a
// second loop for one ablation is more code than its barriers cost.  What
// bounds nophi's rho kernel is reading AO and the three gradient planes
// once (1.54 GB at DHA, 0.46 ms at 3.35 TB/s).  nov (kTf32x3 | kTcNoV) is
// the pad and K1's rho kernel (it still writes s and u), then V as exact
// zeros and one reduce block for E, which sums the same partials in the
// same order as K1's, so its E is K1's bit for bit.
//
// No float atomics anywhere: every sum runs in the same order on every call,
// so SCF trajectories are reproducible run to run.  The chunks (the wrapper's
// for K1base, the variants and K2; fused_xc_tc_v_chunk's for K1) keep tiles
// x chunks near a fixed block count, which
// bounds the partial buffers (~32 MB) whatever npad and the grid size are.
// The TPU kernel's bf16 splits (but K3's), ones-row matmul reductions,
// (8, tile/8) subtiling and npad-dependent grid tile are MXU / VMEM devices
// and are not carried over.
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
// chooses how phi_D is formed; at most one of the others changes the
// per-point pass.  kNoProd and kNoFunc are ablations of the GGA body
// (results wrong by design: each removes one phase so that its time can be
// read off; nophi and nov run fused_xc_tc).
constexpr int kPhiSplit = 1;  // K3: phi_D as the 3-pass bf16 split
constexpr int kNoProd = 4;    // rho = sum phi_D, grad rho_k = 2 sum dAO_k
constexpr int kNoFunc = 8;    // e = rho, vrho = rho, vsigma = sigma
constexpr int kSplit2 = 32;   // row sums as sum bf16(x) + sum bf16(x - bf16(x))
constexpr int kPointBits = kNoProd | kNoFunc | kSplit2;

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

// ---- K1 and K2 on TF32 tensor cores (xc_rho_kernel, xc_rho_res_kernel,
// xc_lda_v_kernel, xc_gga_v_kernel; the design is in the header note) ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers in shared memory: a phase completes when its count of arrivals
// is in; waiters spin on the phase's parity.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
  (void)state;
}
// arrives on bar once this thread's cp.async copies issued so far land
// (noinc: the arrival is one of the count given at init)
__device__ __forceinline__ void mbar_cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// hi = tf32(x) rounded to nearest, ties away (cvt.rna's rounding, done on
// the bits: two integer ops instead of a conversion, which measured 0.14 ms
// of the rho kernel and 0.14 ms of the V kernel at DHA), lo = x - hi, exact
// in f32.  The tensor core reads only a tf32 operand's top 19 bits, so lo
// enters truncated to tf32.  hi lo products are exact, so hi.hi + hi.lo +
// lo.hi carries ~2^-22 of relative error (lo's truncation, the dropped
// lo.lo); finite inputs well inside the f32 range.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: m16n8k8, tf32 operands, f32 accumulation.  A product as 3 x
// TF32 is three of these into one accumulator, small terms first (hi.lo,
// lo.hi, hi.hi); the kernels issue each of the three over all of a warp's
// accumulators before the next, since back to back into one accumulator
// every mma waits out the one before (measured: ~25% of the mma.sync TF32
// rate of ~320 TFLOP/s at DHA).  Fragments (g = lane
// / 4, t = lane % 4): a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)},
// b = {(k t, n g), (k t + 4, n g)}, c = {(g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


constexpr int kRhoCols = 64;                 // grid points of a rho column tile
constexpr int kRhoColStride = kRhoCols + 8;  // AO tile row stride (floats)
// The rho kernels' product modes (fused_xc_tc's mode): 3 x TF32 on
// m16n8k8 (K1, K2), the 3-pass bf16 split on m16n8k16 (K3 and phi3:
// pallas_xc.py's mm_phi), or no product at all (the ablation nophi: phi_D
// := AO, taken from the staged AO tile; no density is read).  The bf16 A
// fragment pairs two nu rows of the AO tile, so its row stride is 68 (a
// warp's loads at rows 2t, 2t + 1 hit banks 8t + g) where TF32's single
// rows want 72; kPhiAo keeps K1's 72, so that its fold reads as K1's does.
constexpr int kTf32x3 = 0;
constexpr int kBf16x3 = 1;
constexpr int kPhiAo = 2;
// fused_xc_tc's mode word: a product mode, or kTf32x3 with this bit for the
// ablation nov (K1's rho kernel and the E sum; no V kernel, V = 0)
constexpr int kTcNoV = 4;
__host__ __device__ constexpr int rho_col_stride(int mode) {
  return mode == kBf16x3 ? kRhoCols + 4 : kRhoColStride;
}
constexpr int kRhoNb = 5;                    // n8 (mu) tiles per warp per pass
constexpr int kRhoPass = 4 * kRhoNb;         // n8 tiles per pass (four warp columns)
constexpr int kSlabStride = kTk + 4;         // row stride of 32-deep k slabs
constexpr int kVTile = 32;                   // V output tile edge (one warp)
constexpr int kVWarps = 16;                  // K2: V tiles per block
constexpr int kRhoStages = 3;                // cp.async ring depth, rho kernel
constexpr int kVStages = 4;                  // and K2's V kernel
constexpr int kResThreads = 512;             // resident-D rho kernel: 2 groups of 8 warps
// K1's V kernel: 16-point slabs at row stride 20 (a warp's fragment loads
// hit banks 20 g + t, all distinct) through a ring of 4 stages at npad
// 112-160 (gga_v_stages), else 3; all tile rows in one group up to T = 5
// tiles (npad 160), else groups of 3 tile rows
constexpr int kGSlab = 16;
constexpr int kGSlabStride = kGSlab + 4;
constexpr int kGMaxT = 5;
constexpr int kGGroupTiles = 3;
// its warps: one warpgroup of producers, and up to four of consumers (one
// tile a warp: 15 tiles a block at most), with the registers setmaxnreg
// gives each (a block's own allocation, 96 a thread at 640 threads, holds
// both)
constexpr int kGProducers = 4;
constexpr int kGVThreads = 32 * (16 + kGProducers);
constexpr int kGConsRegs = 112, kGProdRegs = 24;
// shared memory a block may take (227 KB on the H100)
constexpr size_t kBlockSmem = 232448;
// bound on K1's V chunk partials (floats, 32 MB; the wrapper's
// LDA_V_PART_FLOATS for K2)
constexpr size_t kVPartFloats = 8 << 20;

// quantities the rho pass sums per point: rho, and for the GGA kinds the
// three components of grad rho
__host__ __device__ constexpr int rho_nq(int kind) {
  return (kind == 1 || kind == 2) ? 4 : 1;
}

// the rho kernels' static scratch (red_s), per group
__host__ __device__ constexpr size_t rho_red_smem(int nq) {
  return sizeof(float) * nq * 4 * kRhoCols;
}

// n8 tiles of one rho pass: passes split the npad / 8 tiles evenly
__host__ __device__ inline int rho_pass_tiles(int npad) {
  const int ntn = npad / 8;
  const int npass = (ntn + kRhoPass - 1) / kRhoPass;
  return (ntn + npass - 1) / npass;
}

// one ring stage of the streaming rho kernel's D slabs, in floats: per * 8
// rows of 32 nu at stride 36 floats (TF32), or the hi and lo rows at stride
// 40 bf16 (20 words: a warp's B fragment pairs hit banks 20 g + t); none
// for kPhiAo
__host__ __device__ inline size_t rho_slab_floats(int npad, int mode) {
  if (mode == kPhiAo) return 0;
  return (size_t)rho_pass_tiles(npad) * 8 *
         (mode == kBf16x3 ? kTkSplit : kSlabStride);
}

// streaming rho kernel: the AO tile and a ring of D slabs
__host__ __device__ inline size_t rho_smem(int npad, int mode) {
  return sizeof(float) * ((size_t)npad * rho_col_stride(mode) +
                          kRhoStages * rho_slab_floats(npad, mode));
}

// the resident bf16 planes' row stride (bf16): (npad / 2) | 4 words, = 4 mod
// 8, so a warp's B fragment pairs hit 32 distinct banks
__host__ __device__ constexpr int rho_res_bf16_stride(int npad) {
  return 2 * ((npad / 2) | 4);
}

// the resident D's floats: D at row stride npad + 4 (= 4 mod 8: a warp's B
// fragment loads hit 32 distinct banks), or its hi and lo planes at
// rho_res_bf16_stride (as many bytes a row within 16); none for kPhiAo
__host__ __device__ inline size_t rho_res_d_floats(int npad, int mode) {
  return mode == kPhiAo    ? 0
         : mode == kBf16x3 ? (size_t)npad * rho_res_bf16_stride(npad)
                           : (size_t)npad * (npad + 4);
}

// resident-D rho kernel: the resident D and one AO tile per group
__host__ __device__ inline size_t rho_res_smem(int npad, int mode) {
  return sizeof(float) * (rho_res_d_floats(npad, mode) +
                          2 * (size_t)npad * rho_col_stride(mode));
}

__host__ __device__ inline size_t lda_v_smem(int npad) {
  const int rows = (npad + 15) / 16 * 16;
  return sizeof(float) * (kVStages * ((size_t)rows * kSlabStride + kTk));
}

// K1's V schedule: tile rows per group, and the rows a block stages at most
__host__ __device__ inline int gga_group_tiles(int T) {
  return T <= kGMaxT ? T : kGGroupTiles;
}
__host__ __device__ inline int gga_v_rows(int npad) {
  const int T = (npad + kVTile - 1) / kVTile;
  return T <= kGMaxT ? (npad + 15) / 16 * 16 : 2 * kGGroupTiles * kVTile;
}
// a ring stage: four planes' slabs, then s and u_0..2; then two B slabs
__host__ __device__ inline size_t gga_v_stage(int npad) {
  return 4 * (size_t)gga_v_rows(npad) * kGSlabStride + 4 * kGSlab;
}
__host__ __device__ inline size_t gga_v_smem(int npad, int stages) {
  return sizeof(float) * (stages * gga_v_stage(npad) +
                          2 * (size_t)gga_v_rows(npad) * kGSlabStride);
}
// 4 stages where they fit and 3 would not leave room for a second block
// on the SM anyway (npad 112-160), else 3
__host__ __device__ inline int gga_v_stages(int npad) {
  return gga_v_smem(npad, 3) > kBlockSmem / 2 &&
         gga_v_smem(npad, 4) <= kBlockSmem ? 4 : 3;
}

// barrier over one group of 256 threads (id 0 with 256 threads is the
// whole block of the streaming kernel)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id));
}

// ---- the rho body, shared by its two kernels.  A group of 8 warps owns
// one 64-point column tile of AO, staged as ao_s[nu][point] (stride 72: a
// warp's A fragment loads hit banks 8t + g, all distinct).  The mma runs
// with m = points, n = mu (n8 tiles: npad % 8 == 0, no padding) and k = nu,
// B = D[mu][nu].  Warp (wm, wn) = (warp % 2, warp / 2) owns m16 tiles 2 wm
// and 2 wm + 1 and a quarter of each pass's n8 tiles; a pass covers <= 20
// n8 tiles (160 mu); their rows are points p0 + 16 i (+ 8), p0 = 32 wm + g.
// phi_D stays in registers.

// the GGA body's gradient planes (npad, gpad); null for LDA and HF
struct GradPlanes {
  const float* g[3];
  // plane k with k not a compile-time constant (no local-memory copy)
  __device__ __forceinline__ const float* at(int k) const {
    return k == 0 ? g[0] : k == 1 ? g[1] : g[2];
  }
};

// the n8 tiles [first, first + mine) of warp column wn in a pass of cnt
__device__ __forceinline__ void pass_share(int cnt, int wn, int& first,
                                           int& mine) {
  const int q = cnt / 4, rem = cnt % 4;
  mine = q + (wn < rem ? 1 : 0);
  first = wn * q + min(wn, rem);
}

// acc += phi_D^T over one stage of kw <= 32 nu.  pa = &ao_s[k0 + t][p0];
// pb = &D[mu of the warp's first n8 tile + g][k0 + t], row stride bs.  The
// stage's products are summed apart and then added (stage_fma's reason).
__device__ __forceinline__ void rho_stage(const float* pa, const float* pb,
                                          int bs, int kw, int mine,
                                          float (&acc)[2][kRhoNb][4]) {
  float s[2][kRhoNb][4] = {};
  for (int kk = 0; kk < kw; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = pa + kk * kRhoColStride + 16 * i;
      split_tf32(a[0], ah[i][0], al[i][0]);
      split_tf32(a[8], ah[i][1], al[i][1]);
      split_tf32(a[4 * kRhoColStride], ah[i][2], al[i][2]);
      split_tf32(a[4 * kRhoColStride + 8], ah[i][3], al[i][3]);
    }
    uint32_t bh[kRhoNb][2];  // lo parts are used at once: one pass
#pragma unroll
    for (int j = 0; j < kRhoNb; ++j) {
      if (j < mine) {
        const float* b = pb + j * 8 * bs + kk;
        uint32_t bl[2];
        split_tf32(b[0], bh[j][0], bl[0]);
        split_tf32(b[4], bh[j][1], bl[1]);
        mma_tf32(s[0][j], ah[0], bl[0], bl[1]);
        mma_tf32(s[1][j], ah[1], bl[0], bl[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRhoNb; ++j)
      if (j < mine) {
        mma_tf32(s[0][j], al[0], bh[j][0], bh[j][1]);
        mma_tf32(s[1][j], al[1], bh[j][0], bh[j][1]);
      }
#pragma unroll
    for (int j = 0; j < kRhoNb; ++j)
      if (j < mine) {
        mma_tf32(s[0][j], ah[0], bh[j][0], bh[j][1]);
        mma_tf32(s[1][j], ah[1], bh[j][0], bh[j][1]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kRhoNb; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += s[i][j][r];
}

// (x0, x1) -> the bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the
// low halves, both round-to-nearest-even (cvt.rn.bf16x2: split_bf16's
// rounding, the plain version's _split); hi back in f32 is its bits << 16
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __uint_as_float(hi << 16),
                            x1 - __uint_as_float(hi & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// s += phi_D^T over one k16 step of the 3-pass bf16 split (K3, phi3),
// AO_h D_l + AO_l D_h + AO_h D_h with D_l AO_l dropped, as mm_phi: the A
// fragments (16 points x 16 nu) from the f32 AO tile split at load (pa =
// &ao_s[kk + 2t][p0], row stride CS); the B fragments, pairs along nu,
// from the split D planes (pbh / pbl = &D_h / &D_l[mu of the warp's first
// n8 tile + g][kk + 2t], row stride bs).  Each pass over all of the warp's
// tiles before the next (mma_tf32's note).  kHalf: only nu kk .. kk + 7
// are in range (the last step when npad % 16 == 8); the upper half's
// fragments are zero and nothing beyond is read.
template <int CS, bool kHalf>
__device__ __forceinline__ void rho_k16(const float* pa,
                                        const __nv_bfloat16* pbh,
                                        const __nv_bfloat16* pbl, int bs,
                                        int mine,
                                        float (&s)[2][kRhoNb][4]) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = pa + 16 * i;
    split_bf16x2(a[0], a[CS], ah[i][0], al[i][0]);
    split_bf16x2(a[8], a[CS + 8], ah[i][1], al[i][1]);
    if constexpr (kHalf) {
      ah[i][2] = al[i][2] = ah[i][3] = al[i][3] = 0u;
    } else {
      split_bf16x2(a[8 * CS], a[9 * CS], ah[i][2], al[i][2]);
      split_bf16x2(a[8 * CS + 8], a[9 * CS + 8], ah[i][3], al[i][3]);
    }
  }
  uint32_t bh[kRhoNb][2];
#pragma unroll
  for (int j = 0; j < kRhoNb; ++j) {
    if (j < mine) {
      const int o = j * 8 * bs;
      bh[j][0] = ld_pair(pbh + o);
      bh[j][1] = kHalf ? 0u : ld_pair(pbh + o + 8);
      const uint32_t bl[2] = {ld_pair(pbl + o), kHalf ? 0u : ld_pair(pbl + o + 8)};
      mma_bf16(s[0][j], ah[0], bl);
      mma_bf16(s[1][j], ah[1], bl);
    }
  }
#pragma unroll
  for (int j = 0; j < kRhoNb; ++j)
    if (j < mine) {
      mma_bf16(s[0][j], al[0], bh[j]);
      mma_bf16(s[1][j], al[1], bh[j]);
    }
#pragma unroll
  for (int j = 0; j < kRhoNb; ++j)
    if (j < mine) {
      mma_bf16(s[0][j], ah[0], bh[j]);
      mma_bf16(s[1][j], ah[1], bh[j]);
    }
}

// rho_stage's bf16 counterpart: acc += phi_D^T over one stage of kw <= 32
// nu (a multiple of 8), k16 steps and a last half step, summed apart
template <int CS>
__device__ __forceinline__ void rho_stage_bf16(const float* pa,
                                               const __nv_bfloat16* pbh,
                                               const __nv_bfloat16* pbl,
                                               int bs, int kw, int mine,
                                               float (&acc)[2][kRhoNb][4]) {
  float s[2][kRhoNb][4] = {};
  int kk = 0;
  for (; kk + 16 <= kw; kk += 16)
    rho_k16<CS, false>(pa + kk * CS, pbh + kk, pbl + kk, bs, mine, s);
  if (kk < kw) rho_k16<CS, true>(pa + kk * CS, pbh + kk, pbl + kk, bs, mine, s);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kRhoNb; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += s[i][j][r];
}

// q += the sums over a finished pass's mu, from the accumulators (fragment
// rows mu0 + 8 j, mu0 = 8 (pass base + first) + 2 t; points p0 + 16 i (+ 8)):
// q[0] of phi_D AO against the staged AO tile, and (GGA) q[1 + k] of phi_D
// dAO_k, read once from the gradient planes at the fragment positions (the
// lanes of a row group read 8 consecutive points: whole 32-byte sectors).
// go: the offset of (row 0, point p0 of the tile) in the planes.
template <int NQ, int CS>
__device__ __forceinline__ void rho_fold(const float* ao_s, int p0, int mu0,
                                         int mine,
                                         const float (&acc)[2][kRhoNb][4],
                                         GradPlanes gp, size_t go,
                                         int gpad, float (&q)[NQ][2][2]) {
#pragma unroll
  for (int j = 0; j < kRhoNb; ++j) {
    if (j < mine) {
      const float* a0 = ao_s + (size_t)(mu0 + 8 * j) * CS + p0;
      const float* a1 = a0 + CS;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        q[0][i][0] += acc[i][j][0] * a0[16 * i] + acc[i][j][1] * a1[16 * i];
        q[0][i][1] += acc[i][j][2] * a0[16 * i + 8] + acc[i][j][3] * a1[16 * i + 8];
      }
      if constexpr (NQ == 4) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* d0 = gp.g[k] + go + (size_t)(mu0 + 8 * j) * gpad;
          const float* d1 = d0 + gpad;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            q[1 + k][i][0] += acc[i][j][0] * __ldg(d0 + 16 * i) +
                              acc[i][j][1] * __ldg(d1 + 16 * i);
            q[1 + k][i][1] += acc[i][j][2] * __ldg(d0 + 16 * i + 8) +
                              acc[i][j][3] * __ldg(d1 + 16 * i + 8);
          }
        }
      }
    }
  }
}

// kPhiAo (nophi: phi_D := AO): the accumulators of a pass straight from the
// staged AO tile, at the C fragment positions rho_fold reads (rows mu0 + 8 j
// and + 1, points p0 + 16 i and + 8), in place of the product
template <int CS>
__device__ __forceinline__ void rho_phi_ao(const float* ao_s, int p0, int mu0,
                                           int mine,
                                           float (&acc)[2][kRhoNb][4]) {
#pragma unroll
  for (int j = 0; j < kRhoNb; ++j) {
    if (j < mine) {
      const float* a0 = ao_s + (size_t)(mu0 + 8 * j) * CS + p0;
      const float* a1 = a0 + CS;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][j][0] = a0[16 * i];
        acc[i][j][1] = a1[16 * i];
        acc[i][j][2] = a0[16 * i + 8];
        acc[i][j][3] = a1[16 * i + 8];
      }
    }
  }
}

// A finished pass's sums into red_s[q][wn][point]: over the four lanes of a
// row group by shuffles, then lane t == 0 stores them (first pass) or adds
// them (later passes).  Each entry has one owner, so passes need no barrier,
// and q is live only while a pass is folded.
template <int NQ>
__device__ __forceinline__ void rho_pass_store(float (&q)[NQ][2][2],
                                               float (*red_s)[4][kRhoCols],
                                               int wn, int t, int p0,
                                               bool first_pass) {
#pragma unroll
  for (int c = 0; c < NQ; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = q[c][i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) {
          float& r = red_s[c][wn][p0 + 16 * i + 8 * h];
          r = first_pass ? v : r + v;
        }
      }
}

// One pass of the rho body: fold the accumulators and store the sums (CS:
// the AO tile's row stride)
template <int NQ, int CS>
__device__ __forceinline__ void rho_pass_end(const float* ao_s, int p0,
                                             int mu0, int mine,
                                             const float (&acc)[2][kRhoNb][4],
                                             GradPlanes gp, size_t go,
                                             int gpad,
                                             float (*red_s)[4][kRhoCols],
                                             int wn, int t, bool first_pass) {
  float q[NQ][2][2] = {};
  rho_fold<NQ, CS>(ao_s, p0, mu0, mine, acc, gp, go, gpad, q);
  rho_pass_store<NQ>(q, red_s, wn, t, p0, first_pass);
}

// The tile's sums per point over the four warp columns of red_s (a fixed
// order), the functional, s_g = w vrho, (GGA) u_k,g = c w vsigma grad_k rho
// with grad_k rho = 2 sum phi_D dAO_k, and the tile's E partial (a fixed
// tree).  gtid: the thread in its group; bar: the group's barrier.
template <int KIND>
__device__ __forceinline__ void rho_finish(float (*red_s)[4][kRhoCols],
                                           int gtid, int tile, int bar,
                                           int gpad, const float* wt,
                                           float* s_out, float* u_out,
                                           float* e_part, float u_scale) {
  constexpr int NQ = rho_nq(KIND);
  bar_sync(bar);
  const int g = tile * kRhoCols + gtid;
  float we = 0.f;
  if (gtid < kRhoCols) {
    float v[NQ];
#pragma unroll
    for (int c = 0; c < NQ; ++c)
      v[c] = (red_s[c][0][gtid] + red_s[c][1][gtid]) +
             (red_s[c][2][gtid] + red_s[c][3][gtid]);
    float sigma = 0.f, gr[3] = {};
    if constexpr (NQ == 4) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gr[k] = 2.f * v[1 + k];
      sigma = gr[0] * gr[0] + gr[1] * gr[1] + gr[2] * gr[2];
    }
    float e, vr, vs;
    xc::eval_point<KIND>(v[0], sigma, &e, &vr, &vs);
    const float w = wt[g];
    s_out[g] = w * vr;
    if constexpr (NQ == 4) {
      const float wvs = u_scale * w * vs;
#pragma unroll
      for (int k = 0; k < 3; ++k) u_out[(size_t)k * gpad + g] = wvs * gr[k];
    }
    we = __fmul_rn(w, e);
  }
  bar_sync(bar);
  if (gtid < kRhoCols) red_s[0][0][gtid] = we;
  bar_sync(bar);
  for (int h = kRhoCols / 2; h > 0; h >>= 1) {
    if (gtid < h) red_s[0][0][gtid] += red_s[0][0][gtid + h];
    bar_sync(bar);
  }
  if (gtid == 0) e_part[tile] = red_s[0][0][0];
}

// xc_rho_kernel (streaming D, any npad <= 384): one block of 8 warps per
// column tile.  D streams through a ring of 3 slabs (cp.async, loads issued
// 2 stages ahead; slab rows = the pass's mu, stride 36: B fragment loads hit
// banks 4g + t; in the bf16 mode the hi and lo rows, rho_slab_floats); the
// AO rows of each 32-deep stage arrive with the first pass's slab and stay,
// for the later passes and the epilogue.  npad 384 takes 3 passes, npad <=
// 160 one.  MODE: the product (kTf32x3: dm is the f32 padded density;
// kBf16x3: dm holds its bf16 hi and lo planes, xc_split_dm_kernel; kPhiAo:
// dm is not read, the ring holds no slab and the steps only stage AO rows,
// each pass filled from the tile at its last step).
template <int KIND, int MODE = kTf32x3>
__global__ void __launch_bounds__(256, 2)
xc_rho_kernel(int npad, int gpad, const float* __restrict__ dm,
              const float* __restrict__ aot, GradPlanes gp,
              const float* __restrict__ wt, float* __restrict__ s_out,
              float* __restrict__ u_out, float* __restrict__ e_part,
              float u_scale) {
  constexpr int NQ = rho_nq(KIND);
  constexpr int CS = rho_col_stride(MODE);
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_s[NQ][4][kRhoCols];
  const int per = rho_pass_tiles(npad);
  const size_t slab = rho_slab_floats(npad, MODE);
  float* ao_s = smem;                     // [npad][CS]
  float* d_s = smem + (size_t)npad * CS;  // [3][slab]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 2, wn = warp / 2;
  const int p0 = wm * 32 + g;
  const int col0 = blockIdx.x * kRhoCols;  // gpad % 1024 == 0
  const int ntn = npad / 8;
  const int nks = (npad + kTk - 1) / kTk;
  const int nsteps = (ntn + per - 1) / per * nks;

  // one step = (pass, 32-deep k stage): its D slab, rows [base 8, +cnt 8),
  // and in the first pass the stage's AO rows
  auto stage = [&](int step) {
    const int base = step / nks * per, k0 = step % nks * kTk;
    const int rows = min(per, ntn - base) * 8;
    const int kw = min(kTk, npad - k0);
    float* dst = d_s + (step % kRhoStages) * slab;
    if constexpr (MODE == kBf16x3) {
      // [hi, lo][per * 8][40] bf16 from the two (npad, npad) planes
      const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(dm);
      __nv_bfloat16* db = reinterpret_cast<__nv_bfloat16*>(dst);
      const int kc = kw / 8, n = rows * kc;  // 16-byte pieces per plane
      for (int i = tid; i < 2 * n; i += 256) {
        const int h = i / n, r = i % n / kc, c = i % kc * 8;
        cp_async16(db + ((size_t)h * per * 8 + r) * kTkSplit + c,
                   src + (size_t)h * npad * npad +
                       (size_t)(base * 8 + r) * npad + k0 + c);
      }
    } else if constexpr (MODE == kTf32x3) {
      const int kc = kw / 4;  // 16-byte pieces per D row
      for (int i = tid; i < rows * kc; i += 256) {
        const int r = i / kc, c = i % kc * 4;
        cp_async16(dst + r * kSlabStride + c,
                   dm + (size_t)(base * 8 + r) * npad + k0 + c);
      }
    }
    if (step < nks) {
      for (int i = tid; i < kw * (kRhoCols / 4); i += 256) {
        const int r = k0 + i / (kRhoCols / 4), c = i % (kRhoCols / 4) * 4;
        cp_async16(ao_s + r * CS + c, aot + (size_t)r * gpad + col0 + c);
      }
    }
  };
  for (int p = 0; p < kRhoStages - 1; ++p) {
    if (p < nsteps) stage(p);
    cp_async_commit();
  }

  float acc[2][kRhoNb][4];
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kRhoStages - 2>();
    __syncthreads();  // this stage is in; every warp is done with step - 1
    if (step + kRhoStages - 1 < nsteps) stage(step + kRhoStages - 1);
    cp_async_commit();
    const int ks = step % nks, k0 = ks * kTk;
    const int base = step / nks * per;
    int first, mine;
    pass_share(min(per, ntn - base), wn, first, mine);
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kRhoNb; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
    const float* db = d_s + (step % kRhoStages) * slab;
    const int mu0 = (base + first) * 8 + 2 * t;
    if constexpr (MODE == kBf16x3) {
      const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(db) +
                                (first * 8 + g) * kTkSplit + 2 * t;
      rho_stage_bf16<CS>(ao_s + (size_t)(k0 + 2 * t) * CS + p0, bh,
                         bh + (size_t)per * 8 * kTkSplit, kTkSplit,
                         min(kTk, npad - k0), mine, acc);
    } else if constexpr (MODE == kTf32x3) {
      rho_stage(ao_s + (size_t)(k0 + t) * CS + p0,
                db + (first * 8 + g) * kSlabStride + t, kSlabStride,
                min(kTk, npad - k0), mine, acc);
    } else if (ks == nks - 1) {  // every AO row is in
      rho_phi_ao<CS>(ao_s, p0, mu0, mine, acc);
    }
    if (ks == nks - 1)
      rho_pass_end<NQ, CS>(ao_s, p0, mu0, mine, acc, gp, (size_t)col0 + p0,
                           gpad, red_s, wn, t, base == 0);
  }
  rho_finish<KIND>(red_s, tid, blockIdx.x, 0, gpad, wt, s_out, u_out, e_part,
                   u_scale);
}

// xc_rho_res_kernel (resident D, npad <= 176 for K2, <= 168 for K1, in
// either mode): persistent, one block of two 8-warp groups per SM.  D (or
// its bf16 hi and lo planes) is staged once per block and stays; each
// group walks its own column tiles (tile = 2 block + group, then + 2
// grid), staging the tile's AO with one cp.async wait and its own barrier,
// so no barrier or D copy sits inside the product.  Group 0's first tile
// loads with D, group 1's after, so one group's loads, fold and functional
// overlap the other's products.  Same products and sums as xc_rho_kernel
// (kPhiAo: no D is staged, and each pass is filled from the AO tile).
template <int KIND, int MODE = kTf32x3>
__global__ void __launch_bounds__(kResThreads, 1)
xc_rho_res_kernel(int npad, int gpad, const float* __restrict__ dm,
                  const float* __restrict__ aot, GradPlanes gp,
                  const float* __restrict__ wt, float* __restrict__ s_out,
                  float* __restrict__ u_out, float* __restrict__ e_part,
                  float u_scale) {
  constexpr int NQ = rho_nq(KIND);
  constexpr int CS = rho_col_stride(MODE);
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_s[2][NQ][4][kRhoCols];
  // TF32: D at [npad][npad + 4] floats; bf16: [hi, lo][npad][dsb]; kPhiAo:
  // none
  const int ds = MODE == kBf16x3 ? rho_res_bf16_stride(npad) : npad + 4;
  const float* d_s = smem;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = warp / 8, gtid = tid % 256, wl = warp % 8;
  const int g = lane / 4, t = lane % 4;
  const int wm = wl % 2, wn = wl / 2;
  const int p0 = wm * 32 + g;
  float* ao_s = smem + rho_res_d_floats(npad, MODE) + (size_t)grp * npad * CS;
  const int ntile = gpad / kRhoCols, ntn = npad / 8;
  const int per = rho_pass_tiles(npad);

  auto load_ao = [&](int tile) {
    for (int i = gtid; i < npad * (kRhoCols / 4); i += 256) {
      const int r = i / (kRhoCols / 4), c = i % (kRhoCols / 4) * 4;
      cp_async16(ao_s + r * CS + c,
                 aot + (size_t)r * gpad + (size_t)tile * kRhoCols + c);
    }
  };
  if constexpr (MODE == kBf16x3) {
    const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(dm);
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem);
    const int kc = npad / 8, n = npad * kc;  // 16-byte pieces per plane
    for (int i = tid; i < 2 * n; i += kResThreads) {
      const int h = i / n, r = i % n / kc, c = i % kc * 8;
      cp_async16(dst + ((size_t)h * npad + r) * ds + c,
                 src + (size_t)h * npad * npad + (size_t)r * npad + c);
    }
  } else if constexpr (MODE == kTf32x3) {
    for (int i = tid; i < npad * (npad / 4); i += kResThreads) {
      const int r = i / (npad / 4), c = i % (npad / 4) * 4;
      cp_async16(smem + (size_t)r * ds + c, dm + (size_t)r * npad + c);
    }
  }
  int tile = blockIdx.x * 2 + grp;
  if (grp == 0 && tile < ntile) load_ao(tile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (bool first_tile = true; tile < ntile;
       tile += 2 * gridDim.x, first_tile = false) {
    if (grp == 1 || !first_tile) {
      load_ao(tile);
      cp_async_commit();
      cp_async_wait<0>();
      bar_sync(1 + grp);
    }
    for (int base = 0; base < ntn; base += per) {
      int first, mine;
      pass_share(min(per, ntn - base), wn, first, mine);
      const int mu0 = (base + first) * 8 + 2 * t;
      float acc[2][kRhoNb][4] = {};
      if constexpr (MODE == kBf16x3) {
        const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(d_s) +
                                  (size_t)((base + first) * 8 + g) * ds + 2 * t;
        for (int k0 = 0; k0 < npad; k0 += kTk)
          rho_stage_bf16<CS>(ao_s + (size_t)(k0 + 2 * t) * CS + p0, bh + k0,
                             bh + (size_t)npad * ds + k0, ds,
                             min(kTk, npad - k0), mine, acc);
      } else if constexpr (MODE == kTf32x3) {
        for (int k0 = 0; k0 < npad; k0 += kTk)
          rho_stage(ao_s + (size_t)(k0 + t) * CS + p0,
                    d_s + (size_t)((base + first) * 8 + g) * ds + k0 + t, ds,
                    min(kTk, npad - k0), mine, acc);
      } else {
        rho_phi_ao<CS>(ao_s, p0, mu0, mine, acc);
      }
      rho_pass_end<NQ, CS>(ao_s, p0, mu0, mine, acc, gp,
                           (size_t)tile * kRhoCols + p0, gpad, red_s[grp], wn,
                           t, base == 0);
    }
    rho_finish<KIND>(red_s[grp], gtid, tile, 1 + grp, gpad, wt, s_out, u_out,
                     e_part, u_scale);
  }
}

// Entry l (l = 0, 1, ..) of the upper triangle of a T x T grid, row by row:
// K2's V tile of warp l (engine/fused_xc.py::lda_v_tiles), K1's pair of row
// groups of block l and tile of warp l within one group (gga_v_tiles)
__device__ __forceinline__ void upper_tile(int l, int T, int& r, int& c) {
  r = 0;
  while (l >= T - r) {
    l -= T - r;
    ++r;
  }
  c = r + l;
}

// which 16 x 8 sub-tiles of the 32 x 32 V tile at (m_base, n_base) a warp
// computes: inside npad and not wholly below the diagonal
__device__ __forceinline__ void upper_subtiles(bool active, int npad,
                                               int m_base, int n_base,
                                               bool (&on)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m0 = m_base + 16 * i, n0 = n_base + 8 * j;
      on[i][j] = active && m0 < npad && n0 < npad && n0 + 8 > m0;
    }
}

// st += X Y^T over one 8-deep k step for a warp's 32 x 32 tile, both
// operands rows of staged slabs ([row][point], row stride ls): x =
// &X[first row + g][kk + t], y = &Y[first column + g][kk + t]; A fragments
// from X rows + 16 i, B fragments from Y rows + 8 j.  kScale: Y scaled by
// sc0 / sc1 (points kk + t, kk + t + 4) at fragment load (K2's s AO).
// Fragments of sub-tiles that are off are not loaded (they may lie beyond
// the slab); each of the three TF32 products is issued over all sub-tiles
// before the next (mma_tf32's note).
template <bool kScale>
__device__ __forceinline__ void tile_mma3(float (&st)[2][4][4],
                                          const bool (&on)[2][4],
                                          const float* x, const float* y,
                                          int ls, float sc0, float sc1) {
  uint32_t ah[2][4] = {}, al[2][4] = {}, bh[4][2] = {}, bl[4][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(on[i][0] | on[i][1] | on[i][2] | on[i][3])) continue;
    const float* pa = x + 16 * i * ls;
    split_tf32(pa[0], ah[i][0], al[i][0]);
    split_tf32(pa[8 * ls], ah[i][1], al[i][1]);
    split_tf32(pa[4], ah[i][2], al[i][2]);
    split_tf32(pa[8 * ls + 4], ah[i][3], al[i][3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!(on[0][j] | on[1][j])) continue;
    const float* pb = y + 8 * j * ls;
    if constexpr (kScale) {
      split_tf32(__fmul_rn(sc0, pb[0]), bh[j][0], bl[j][0]);
      split_tf32(__fmul_rn(sc1, pb[4]), bh[j][1], bl[j][1]);
    } else {
      split_tf32(pb[0], bh[j][0], bl[j][0]);
      split_tf32(pb[4], bh[j][1], bl[j][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (on[i][j]) mma_tf32(st[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (on[i][j]) mma_tf32(st[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (on[i][j]) mma_tf32(st[i][j], ah[i], bh[j][0], bh[j][1]);
}

// acc += st (a slab's partial sums), and the finished tile's sub-tiles into
// one chunk's partial (ldv, ldv)
__device__ __forceinline__ void add_tile(float (&acc)[2][4][4],
                                         const float (&st)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += st[i][j][r];
}
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4],
                                           const bool (&on)[2][4], float* out,
                                           int ldv, int m_base, int n_base,
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!on[i][j]) continue;
      const int row = m_base + 16 * i + g, col = n_base + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(&out[(size_t)row * ldv + col]) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&out[(size_t)(row + 8) * ldv + col]) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// xc_lda_v_kernel (K2): V_part[chunk] = AO diag(s) AO^T over one grid chunk,
// for the 32 x 32 output tiles on or above the diagonal, one tile per warp
// (up to 16 a block).  Both operands are AO rows with the grid axis as k, so
// one staged slab ([row][point], stride 36, banks 4g + t) feeds both and
// the B operand s_g AO is formed at fragment load: no B^T plane exists.
// Slabs of 32 points stream through a ring of 4 (cp.async, loads issued 3
// slabs ahead).
// Inside a tile, 16 x 8 sub-tiles wholly below the diagonal or beyond npad
// are skipped.  v_part is (nchunk, ldv, ldv), ldv = 32 T; only the upper
// sub-tiles are written (the reduce reads nothing else).
__global__ void __launch_bounds__(kVWarps * 32, 1)
xc_lda_v_kernel(int npad, int gpad, int chunk, int ldv,
                const float* __restrict__ aot, const float* __restrict__ s_in,
                float* __restrict__ v_part) {
  extern __shared__ __align__(16) float smem[];
  const int rows = (npad + 15) / 16 * 16;
  float* a_s = smem;                                          // [4][rows][36]
  float* s_s = smem + kVStages * (size_t)rows * kSlabStride;  // [4][32]
  const int nthr = blockDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int T = ldv / kVTile;
  const int l = blockIdx.x * kVWarps + warp;
  const bool active = l < T * (T + 1) / 2;
  int tr = 0, tc = 0;
  if (active) upper_tile(l, T, tr, tc);
  const int g0 = blockIdx.y * chunk;
  const int nsl = (min(g0 + chunk, gpad) - g0) / kTk;  // chunk % 32 == 0

  // rows npad..rows of every buffer stay zero (never staged)
  for (int i = tid; i < kVStages * (rows - npad) * kSlabStride; i += nthr) {
    const int b = i / ((rows - npad) * kSlabStride);
    const int o = i % ((rows - npad) * kSlabStride);
    a_s[(size_t)b * rows * kSlabStride + (size_t)npad * kSlabStride + o] = 0.f;
  }
  auto stage = [&](int sl) {
    const int k0 = g0 + sl * kTk;
    float* dst = a_s + (size_t)(sl % kVStages) * rows * kSlabStride;
    for (int i = tid; i < npad * 8 + 8; i += nthr) {
      if (i < npad * 8) {
        const int r = i / 8, c = i % 8 * 4;
        cp_async16(dst + r * kSlabStride + c, aot + (size_t)r * gpad + k0 + c);
      } else {
        const int c = (i - npad * 8) * 4;
        cp_async16(s_s + (sl % kVStages) * kTk + c, s_in + k0 + c);
      }
    }
  };
  for (int p = 0; p < kVStages - 1; ++p) {
    if (p < nsl) stage(p);
    cp_async_commit();
  }

  const int m_base = tr * kVTile, n_base = tc * kVTile;
  bool on[2][4];
  upper_subtiles(active, npad, m_base, n_base, on);
  float acc[2][4][4] = {};
  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<kVStages - 2>();
    __syncthreads();  // this slab is in; every warp is done with sl - 1
    if (sl + kVStages - 1 < nsl) stage(sl + kVStages - 1);
    cp_async_commit();
    if (active) {
      const float* ab = a_s + (size_t)(sl % kVStages) * rows * kSlabStride;
      const float* sb = s_s + (sl % kVStages) * kTk;
      float st[2][4][4] = {};  // this slab's partial sums
#pragma unroll
      for (int kk = 0; kk < kTk; kk += 8)
        tile_mma3<true>(st, on, ab + (m_base + g) * kSlabStride + kk + t,
                        ab + (n_base + g) * kSlabStride + kk + t, kSlabStride,
                        sb[kk + t], sb[kk + t + 4]);
      add_tile(acc, st);
    }
  }
  store_tile(acc, on, v_part + (size_t)blockIdx.y * ldv * ldv, ldv, m_base,
             n_base, g, t);
}

// xc_gga_v_kernel (K1): V_part[y] = A B^T + B A^T summed over the grid
// slabs of partial y (A = AO, B = s AO + u_0 dAO_0 + u_1 dAO_1 + u_2 dAO_2,
// both (npad, points)), for the 32 x 32 tiles (r, c), r <= c, whose tile
// rows lie in one pair (ga, gb), ga <= gb, of row groups (gga_group_tiles;
// block x = the pair's index in upper_tile order), one tile a warp (warp
// l: tile l of the group's upper triangle if ga == gb, else row l / tb,
// column l % tb).  The block stages the rows of its two groups only: group
// a's first (local rows [0, na)), then group b's.  Partial y sums slabs y,
// y + nchunk, ..: the blocks running at one time read one stretch of each
// row.
// Warp-specialized: the last warpgroup produces.  Its 128 lanes stream the
// four planes' 16-point slabs and the slab's s and u through a ring of 4 or
// 3 stages (gga_v_stages) with cp.async, each lane signalling the slot's
// "full" barrier when its copies land, and refill a slot once the consumers
// release it on its "empty" barrier: they run up to a ring ahead and never
// wait on the products.  The other warps (the consumers, whole warpgroups)
// form B's slab in shared memory in one pass per slab (each element once, a
// slab ahead of the products that read it) and run the products; they
// synchronize among themselves with one named barrier per slab.  kShift
// (where shared memory holds one block an SM anyway): the consumers are
// whole warpgroups and setmaxnreg hands them the producers' registers; else
// the block stays small enough for two blocks an SM.  No B^T plane exists.
// Sub-tiles wholly below the diagonal or beyond npad are skipped.  v_part
// is (nchunk, ldv, ldv); only the upper sub-tiles are written, with V + V^T
// (the reduce halves it).
template <bool kShift>
__global__ void __launch_bounds__(kGVThreads, 1)
xc_gga_v_kernel(int npad, int gpad, int ldv, const float* __restrict__ aot,
                GradPlanes gp, const float* __restrict__ s_in,
                const float* __restrict__ u_in, float* __restrict__ v_part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full_bar[4], empty_bar[4];
  const int R = gga_v_rows(npad);
  const int nst = gga_v_stages(npad);          // ring stages, 4 or 3
  const size_t ps = gga_v_stage(npad);         // floats per ring stage
  const size_t pl = (size_t)R * kGSlabStride;  // floats per plane slab
  float* ring = smem;                          // [nst][4][R][20] + [4][16]
  float* b_s = smem + nst * ps;                // [2][R][20]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ncons = blockDim.x / 32 - kGProducers;  // consumer warps
  const int ncth = 32 * ncons;                 // consumer threads
  const int g = lane / 4, t = lane % 4;
  const int T = ldv / kVTile;
  const int GT = gga_group_tiles(T);
  const int NG = (T + GT - 1) / GT;
  int ga, gb;
  upper_tile(blockIdx.x, NG, ga, gb);
  const int ra0 = ga * GT * kVTile, rb0 = gb * GT * kVTile;
  const int na = ga == gb ? 0 : GT * kVTile;    // group a's rows (whole)
  const int vb = min(GT * kVTile, npad - rb0);  // group b's rows inside npad
  const int nv = na + vb;                       // staged rows that hold data
  const int nrow = na + (vb + 15) / 16 * 16;    // rows the sub-tiles reach
  const int nchunk = gridDim.y, nslab = gpad / kGSlab;
  const int nsl = (nslab - blockIdx.y + nchunk - 1) / nchunk;

  // rows nv..nrow of every plane slab stay zero (never staged), so B's
  // rows there are zero too
  for (int i = tid; i < nst * 4 * (nrow - nv) * kGSlabStride; i += blockDim.x) {
    const int per = (nrow - nv) * kGSlabStride;
    const int sp = i / per, o = i % per;  // (stage, plane)
    ring[(size_t)(sp / 4) * ps + (size_t)(sp % 4) * pl +
         (size_t)nv * kGSlabStride + o] = 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full_bar[i], 32 * kGProducers);  // the producers' lanes
      mbar_init(&empty_bar[i], ncons);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= ncons) {  // the producers
    if constexpr (kShift)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGProdRegs));
    for (int x = 0; x < nsl; ++x) {
      const int slot = x % nst, fill = x / nst;
      if (fill > 0) mbar_wait(&empty_bar[slot], (fill - 1) & 1);
      const size_t k0 = (size_t)(blockIdx.y + x * nchunk) * kGSlab;
      float* dst = ring + (size_t)slot * ps;
      // lane l copies pieces l, l + 32, ..: plane p, local row r, 16-byte
      // piece c of its row (stepping by 32 pieces is 8 rows)
      const int pt = (warp - ncons) * 32 + lane;
      int p = 0, r = pt / 4;
      const int c = lane % 4 * 4;
      const float* src = aot;
      while (r >= nv) {
        r -= nv;
        src = gp.at(p++);
      }
#pragma unroll 1
      for (int i = pt; i < 16 * nv; i += 32 * kGProducers) {
        const int row = r < na ? ra0 + r : rb0 + r - na;
        cp_async16(dst + p * pl + r * kGSlabStride + c,
                   src + (size_t)row * gpad + k0 + c);
        r += 8 * kGProducers;
        while (r >= nv && p < 3) {
          r -= nv;
          src = gp.at(p++);
        }
      }
      if (pt < 16) {  // s, then u_0..2
        const int q = pt / 4;
        cp_async16(dst + 4 * pl + q * kGSlab + c,
                   (q == 0 ? s_in : u_in + (size_t)(q - 1) * gpad) + k0 + c);
      }
      mbar_cp_async_arrive(&full_bar[slot]);
    }
    return;
  }

  // the consumers
  if constexpr (kShift)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGConsRegs));
  const int tb = min(GT, T - gb * GT);  // group b's tile rows
  const int ntiles = ga == gb ? tb * (tb + 1) / 2 : GT * tb;
  const bool active = warp < ntiles;
  int tr = 0, tc = 0;
  if (active) {
    if (ga == gb) {
      upper_tile(warp, tb, tr, tc);
      tr += gb * GT;
      tc += gb * GT;
    } else {
      tr = ga * GT + warp / tb;
      tc = gb * GT + warp % tb;
    }
  }
  const int m_base = tr * kVTile, n_base = tc * kVTile;
  const int lr = (ga == gb ? m_base - rb0 : m_base - ra0);  // local rows
  const int lc = na + n_base - rb0;

  // B's slab of slab x once it is in, each product rounded and the sum
  // taken left to right (the plain version's order); four points a thread
  // and step
  auto form_b = [&](int x) {
    mbar_wait(&full_bar[x % nst], (x / nst) & 1);
    const float* src = ring + (size_t)(x % nst) * ps;
    const float4* su = reinterpret_cast<const float4*>(src + 4 * pl);
    float* dst = b_s + (x % 2) * pl;
    for (int i = tid; i < nrow * (kGSlab / 4); i += ncth) {
      const int k4 = i % (kGSlab / 4);
      const size_t o = (size_t)(i / (kGSlab / 4)) * kGSlabStride + 4 * k4;
      float4 b;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 xv = *reinterpret_cast<const float4*>(src + p * pl + o);
        const float4 c = su[p * (kGSlab / 4) + k4];
        if (p == 0) {
          b = make_float4(__fmul_rn(c.x, xv.x), __fmul_rn(c.y, xv.y),
                          __fmul_rn(c.z, xv.z), __fmul_rn(c.w, xv.w));
        } else {
          b.x = __fadd_rn(b.x, __fmul_rn(c.x, xv.x));
          b.y = __fadd_rn(b.y, __fmul_rn(c.y, xv.y));
          b.z = __fadd_rn(b.z, __fmul_rn(c.z, xv.z));
          b.w = __fadd_rn(b.w, __fmul_rn(c.w, xv.w));
        }
      }
      *reinterpret_cast<float4*>(dst + o) = b;
    }
  };
  if (nsl > 0) form_b(0);
  asm volatile("bar.sync 1, %0;\n" ::"r"(ncth));  // B(0) is formed

  bool on[2][4];
  upper_subtiles(active, npad, m_base, n_base, on);
  float acc[2][4][4] = {};
  for (int x = 0; x < nsl; ++x) {
    if (active) {
      const float* ab = ring + (size_t)(x % nst) * ps;  // AO
      const float* bb = b_s + (x % 2) * pl;
      float st[2][4][4] = {};  // this slab's partial sums
#pragma unroll
      for (int kk = 0; kk < kGSlab; kk += 8) {
        const int xo = (lr + g) * kGSlabStride + kk + t;
        const int yo = (lc + g) * kGSlabStride + kk + t;
        tile_mma3<false>(st, on, ab + xo, bb + yo, kGSlabStride, 1.f, 1.f);
        tile_mma3<false>(st, on, bb + xo, ab + yo, kGSlabStride, 1.f, 1.f);
      }
      add_tile(acc, st);
    }
    if (x + 1 < nsl) form_b(x + 1);
    // slab x's slot is done with (its planes by form_b(x), its AO now)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[x % nst]);
    // B(x + 1) is formed; every consumer is done reading B(x)
    asm volatile("bar.sync 1, %0;\n" ::"r"(ncth));
  }
  store_tile(acc, on, v_part + (size_t)blockIdx.y * ldv * ldv, ldv, m_base,
             n_base, g, t);
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
// at most one of the kPointBits; VAR = 0 is K1's (and K3's) pass.
template <int KIND, int VAR>
__global__ void __launch_bounds__(kPointBlock)
xc_point_kernel(int npad, int gpad, const float* __restrict__ aot,
                const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gz, const float* __restrict__ wt,
                float* __restrict__ phi_bt, float* __restrict__ e_part,
                float u_scale) {
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

  // B^T column: padded rows have AO = dAO = 0 and padded points w = 0, so
  // both contribute exact zeros to V
  const float wvr = w * vr;
  const float wvs = u_scale * w * vs;
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
// kUpper (K1, K2): only the upper triangle of each V_part is held, which is
// mirrored and scaled by `scale` (K2 1: V itself; K1 1/2: V + V^T);
// otherwise V_out = (V + V^T) / 2.  The sums are f32; T is the type the
// caller takes them in (K1, K2: the f64 of the SCF, so no conversion
// follows).
template <bool kUpper, typename T>
__global__ void __launch_bounds__(kReduceBlock)
xc_reduce_kernel(int nao, int nchunk, int ldv, int npart_e, float scale,
                 const float* __restrict__ v_part,
                 const float* __restrict__ e_part, T* __restrict__ v_out,
                 T* __restrict__ e_out) {
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
  if constexpr (kUpper) {
    const size_t u = (size_t)min(mu, nu) * ldv + max(mu, nu);
    for (int c = 0; c < nchunk; ++c) a += v_part[(size_t)c * ldv * ldv + u];
    v_out[o] = scale * a;
  } else {
    for (int c = 0; c < nchunk; ++c) {
      const float* p = v_part + (size_t)c * ldv * ldv;
      a += p[(size_t)mu * ldv + nu];
      b += p[(size_t)nu * ldv + mu];
    }
    v_out[o] = 0.5f * (a + b);
  }
}

// dm_p (npad, npad) f32 = the f64 density (nao, nao), zero beyond nao
__global__ void xc_pad_dm_kernel(int nao, int npad,
                                 const double* __restrict__ dm,
                                 float* __restrict__ dm_p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad * npad) return;
  const int r = i / npad, c = i % npad;
  dm_p[i] = r < nao && c < nao ? (float)dm[(size_t)r * nao + c] : 0.f;
}

// K3, phi3: the f32 padded density split once per call, into dm_b's hi
// plane bf16(x) and lo plane bf16(x - hi) ((npad, npad) each, hi first; x =
// the f64 density rounded to f32, zero beyond nao): the plain version's
// _pad_dm then _split
__global__ void xc_split_dm_kernel(int nao, int npad,
                                   const double* __restrict__ dm,
                                   __nv_bfloat16* __restrict__ dm_b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad * npad) return;
  const int r = i / npad, c = i % npad;
  const float x = r < nao && c < nao ? (float)dm[(size_t)r * nao + c] : 0.f;
  split_bf16(x, dm_b + i, dm_b + (size_t)npad * npad + i);
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
                         float* phi_bt, float* e_part, float u_scale,
                         cudaStream_t stream) {
  xc_point_kernel<KIND, VAR><<<gpad / kPointBlock, kPointBlock, 0, stream>>>(
      npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale);
  return cudaGetLastError();
}

// The point pass for one kind and the point bits of the variant word; the
// ablations are instantiated for the GGA kinds only.
template <int KIND>
cudaError_t launch_point_var(int var, int npad, int gpad, const float* aot,
                             const float* gx, const float* gy, const float* gz,
                             const float* wt, float* phi_bt, float* e_part,
                             float u_scale, cudaStream_t stream) {
  switch (var & kPointBits) {
    case 0: return launch_point<KIND, 0>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream);
    case kSplit2: return launch_point<KIND, kSplit2>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream);
    default: break;
  }
  if constexpr (KIND == 1 || KIND == 2) {
    switch (var & kPointBits) {
      case kNoProd: return launch_point<KIND, kNoProd>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream);
      case kNoFunc: return launch_point<KIND, kNoFunc>(npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared memory limit on the current device, once
// for each larger size it is launched with (the call costs host time on
// every launch otherwise); done: the kernel's sizes so far, per device
cudaError_t allow_smem(const void* kernel, size_t bytes, size_t (&done)[64]) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || bytes <= done[dev]) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

// The rho pass: resident D where it fits in shared memory beside the
// kernel's static scratch (npad <= 176 for K2, <= 168 for K1, in either
// product mode), else streaming D.  kPhiAo takes K1's choice, though
// without D the resident kernel would fit at any npad: nophi is read
// against K1, so both run the same kernel at each npad.
template <int KIND, int MODE>
cudaError_t launch_rho(int npad, int gpad, const float* dm, const float* aot,
                       const GradPlanes& gp, const float* wt, float* s,
                       float* u, float* e_part, float u_scale,
                       cudaStream_t stream) {
  constexpr int NQ = rho_nq(KIND);
  const int ntile = gpad / kRhoCols;
  size_t smem = rho_res_smem(npad, MODE);
  cudaError_t err;
  if (rho_res_smem(npad, MODE == kPhiAo ? kTf32x3 : MODE) <=
      kBlockSmem - 2 * rho_red_smem(NQ)) {
    static int nsm[64] = {};
    int dev;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev < 64 && nsm[dev] == 0)
      err = cudaDeviceGetAttribute(&nsm[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    static size_t done[64] = {};
    if (err == cudaSuccess)
      err = allow_smem((const void*)xc_rho_res_kernel<KIND, MODE>, smem, done);
    if (err != cudaSuccess) return err;
    const int sms = dev < 64 ? nsm[dev] : 132;
    const int nblk = (ntile + 1) / 2 < sms ? (ntile + 1) / 2 : sms;
    xc_rho_res_kernel<KIND, MODE><<<nblk, kResThreads, smem, stream>>>(
        npad, gpad, dm, aot, gp, wt, s, u, e_part, u_scale);
    return cudaGetLastError();
  }
  smem = rho_smem(npad, MODE);
  static size_t done[64] = {};
  err = allow_smem((const void*)xc_rho_kernel<KIND, MODE>, smem, done);
  if (err != cudaSuccess) return err;
  xc_rho_kernel<KIND, MODE><<<ntile, 256, smem, stream>>>(
      npad, gpad, dm, aot, gp, wt, s, u, e_part, u_scale);
  return cudaGetLastError();
}

// launch_rho for a kind known at run time
template <int MODE>
cudaError_t launch_rho_kind(int kind, int npad, int gpad, const float* dm,
                            const float* aot, const GradPlanes& gp,
                            const float* wt, float* s, float* u,
                            float* e_part, float u_scale,
                            cudaStream_t stream) {
  switch (kind) {
    case 0: return launch_rho<0, MODE>(npad, gpad, dm, aot, gp, wt, s, u, e_part, u_scale, stream);
    case 1: return launch_rho<1, MODE>(npad, gpad, dm, aot, gp, wt, s, u, e_part, u_scale, stream);
    case 2: return launch_rho<2, MODE>(npad, gpad, dm, aot, gp, wt, s, u, e_part, u_scale, stream);
    default: return launch_rho<3, MODE>(npad, gpad, dm, aot, gp, wt, s, u, e_part, u_scale, stream);
  }
}

// K1's V chunk (grid points per partial): a multiple of kGSlab with the V
// blocks of all partials near one wave of the current device's SMs (two
// blocks an SM where shared memory holds two) and the partials (nchunk
// ldv^2 floats) within kVPartFloats.  The kernel makes ceil(gpad / chunk)
// partials and interleaves their slabs (partial y sums slabs y, y + nchunk,
// ..).
cudaError_t gga_v_chunk(int npad, int gpad, int* chunk) {
  int dev, nsm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int T = (npad + kVTile - 1) / kVTile, ldv = T * kVTile;
  const int GT = gga_group_tiles(T), NG = (T + GT - 1) / GT;
  const int per_sm =
      gga_v_smem(npad, gga_v_stages(npad)) > kBlockSmem / 2 ? 1 : 2;
  const int nslab = gpad / kGSlab;
  int nchunk = per_sm * nsm / (NG * (NG + 1) / 2);
  const int cap = (int)(kVPartFloats / ((size_t)ldv * ldv));
  if (nchunk > cap) nchunk = cap;
  if (nchunk > nslab) nchunk = nslab;
  if (nchunk < 1) nchunk = 1;
  *chunk = kGSlab * ((nslab + nchunk - 1) / nchunk);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): 1 <= nao <= npad,
// npad % 8 == 0, gpad % 1024 == 0, chunk a positive multiple of 1024;
// dm (npad, npad), aot/gx/gy/gz/phi_bt (npad, gpad), wt (gpad),
// e_part (gpad / 128), v_part (ceil(gpad / chunk), ldv, ldv) with
// ldv = 64 ceil(npad / 64), v_out (nao, nao), e_out (1); gx/gy/gz may be
// null for kinds 0 and 3.  variant: 0 for K1, else the k* bits above (at
// most one point bit, the ablations for kinds 1 and 2 only); variant 0 is
// K1base (kinds 1 and 2); K1, K2, K3 without split2, phi3, nophi and nov
// are fused_xc_tc.  u_scale: the factor c of w vsigma in B^T (header note;
// read by the GGA kinds only).
// Returns the CUDA error code of the launches (0 on success).
int fused_xc(int kind, int variant, int nao, int npad, int gpad, int chunk,
             const float* dm, const float* aot, const float* gx,
             const float* gy, const float* gz, const float* wt, float* phi_bt,
             float* e_part, float* v_part, float* v_out, float* e_out,
             float u_scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int point = variant & kPointBits;
  if (nao < 1 || nao > npad || npad % 8 != 0 || gpad % kPack != 0 ||
      chunk <= 0 || chunk % kPack != 0 || kind < 0 || kind > 3 ||
      (variant & ~(kPhiSplit | kPointBits)) != 0 ||
      (point & (point - 1)) != 0 ||
      ((variant & (kNoProd | kNoFunc)) && kind != 1 && kind != 2) ||
      (variant == 0 && (kind == 0 || kind == 3)))
    return (int)cudaErrorInvalidValue;
  const int ntile = (npad + kTile - 1) / kTile;
  const int ldv = ntile * kTile;
  const int nchunk = (gpad + chunk - 1) / chunk;

  cudaError_t err;
  if (variant & kPhiSplit) {
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
    case 0: err = launch_point_var<0>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream); break;
    case 1: err = launch_point_var<1>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream); break;
    case 2: err = launch_point_var<2>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream); break;
    default: err = launch_point_var<3>(variant, npad, gpad, aot, gx, gy, gz, wt, phi_bt, e_part, u_scale, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  xc_v_partial_kernel<<<dim3(ntile, ntile, nchunk), dim3(16, 16), 0, stream>>>(
      npad, gpad, chunk, ldv, aot, phi_bt, v_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (nao * nao + kReduceBlock - 1) / kReduceBlock + 1;
  xc_reduce_kernel<false, float><<<nblk, kReduceBlock, 0, stream>>>(
      nao, nchunk, ldv, gpad / kPointBlock, 1.f, v_part, e_part, v_out, e_out);
  return (int)cudaGetLastError();
}

// K1 (kinds 1: PBE, 2: B3LYP) and K2 (kinds 0: LDA, 3: HF) with mode
// kTf32x3; K3 (either body) and the ablation phi3 (the GGA body, the same
// computation as K3's) with mode kBf16x3, phi_D as the 3-pass bf16 split;
// the GGA body's ablations nophi with mode kPhiAo (K1's kernels, phi_D :=
// AO: no density is read, dm64 and dm may be null) and nov with mode
// kTf32x3 | kTcNoV (K1's rho kernel and E sum, no V kernel: V is written
// as exact zeros and v_part may be null).
// Shape contract (checked by the Python wrapper): 1 <= nao <= npad <= 384,
// npad % 8 == 0, gpad % 1024 == 0, chunk a positive multiple of 16 (GGA
// body: fused_xc_tc_v_chunk's) or 32 (LDA body); dm64 (nao, nao) f64 and
// the scratch dm of npad^2 floats for its f32 padded copy (mode kTf32x3)
// or the bf16 hi and lo planes of that copy (kBf16x3), aot (npad, gpad),
// wt/s (gpad), e_part (gpad / 64), v_part (ceil(gpad / chunk), ldv, ldv)
// with ldv = 32 ceil(npad / 32), v_out (nao, nao) and e_out (1) f64; the
// GGA body also the gradient planes gx/gy/gz (npad, gpad) and u (3, gpad),
// null for the LDA body; u_scale the factor c of w vsigma in u (header
// note; read by the GGA body only).  Returns the CUDA error code (0 on
// success).
int fused_xc_tc(int kind, int mode, int nao, int npad, int gpad, int chunk,
                const double* dm64, float* dm, const float* aot,
                const float* gx, const float* gy, const float* gz,
                const float* wt, float* s, float* u, float* e_part,
                float* v_part, double* v_out, double* e_out,
                float u_scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool gga = kind == 1 || kind == 2;
  const bool nov = mode == (kTf32x3 | kTcNoV);
  if (nao < 1 || nao > npad || npad % 8 != 0 || npad > 384 ||
      gpad % kPack != 0 || chunk <= 0 || kind < 0 || kind > 3 ||
      (mode != kTf32x3 && mode != kBf16x3 &&
       !(gga && (mode == kPhiAo || nov))) ||
      chunk % (gga ? kGSlab : kTk) != 0 ||
      (gga && (!gx || !gy || !gz || !u)))
    return (int)cudaErrorInvalidValue;
  const GradPlanes gp{{gx, gy, gz}};
  const int pad_blocks = (npad * npad + 255) / 256;
  cudaError_t err;
  if (mode == kBf16x3) {
    xc_split_dm_kernel<<<pad_blocks, 256, 0, stream>>>(
        nao, npad, dm64, reinterpret_cast<__nv_bfloat16*>(dm));
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_rho_kind<kBf16x3>(kind, npad, gpad, dm, aot, gp, wt, s, u,
                                     e_part, u_scale, stream);
  } else if (mode == kPhiAo) {  // the GGA kinds only (checked above)
    err = kind == 1 ? launch_rho<1, kPhiAo>(npad, gpad, nullptr, aot, gp, wt,
                                            s, u, e_part, u_scale, stream)
                    : launch_rho<2, kPhiAo>(npad, gpad, nullptr, aot, gp, wt,
                                            s, u, e_part, u_scale, stream);
  } else {
    xc_pad_dm_kernel<<<pad_blocks, 256, 0, stream>>>(nao, npad, dm64, dm);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_rho_kind<kTf32x3>(kind, npad, gpad, dm, aot, gp, wt, s, u,
                                     e_part, u_scale, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int T = (npad + kVTile - 1) / kVTile;
  const int ldv = T * kVTile;
  if (nov) {  // V = 0; one reduce block sums E as K1's last block does
    err = cudaMemsetAsync(v_out, 0, sizeof(double) * nao * (size_t)nao,
                          stream);
    if (err != cudaSuccess) return (int)err;
    xc_reduce_kernel<true, double><<<1, kReduceBlock, 0, stream>>>(
        nao, 0, ldv, gpad / kRhoCols, 0.5f, nullptr, e_part, v_out, e_out);
    return (int)cudaGetLastError();
  }
  const int nchunk = (gpad + chunk - 1) / chunk;
  if (gga) {
    const int GT = gga_group_tiles(T), NG = (T + GT - 1) / GT;
    const int warps = NG == 1 ? T * (T + 1) / 2 : GT * GT;
    const size_t smem = gga_v_smem(npad, gga_v_stages(npad));
    const bool shift = smem > kBlockSmem / 2;
    const int ncons = shift ? (warps + 3) / 4 * 4 : warps;
    const dim3 grid(NG * (NG + 1) / 2, nchunk);
    const int threads = 32 * (ncons + kGProducers);
    if (shift) {
      // setmaxnreg moves registers inside the block's own allocation: the
      // consumers' and the producers' counts must fit in what it was
      // given, or the consumers would wait for registers forever
      static int regs = 0;
      if (regs == 0) {
        cudaFuncAttributes fa;
        err = cudaFuncGetAttributes(&fa, (const void*)xc_gga_v_kernel<true>);
        if (err != cudaSuccess) return (int)err;
        regs = fa.numRegs;
      }
      if (ncons * kGConsRegs + kGProducers * kGProdRegs >
          (ncons + kGProducers) * regs)
        return (int)cudaErrorInvalidConfiguration;
      static size_t done[64] = {};
      err = allow_smem((const void*)xc_gga_v_kernel<true>, smem, done);
      if (err != cudaSuccess) return (int)err;
      xc_gga_v_kernel<true><<<grid, threads, smem, stream>>>(
          npad, gpad, ldv, aot, gp, s, u, v_part);
    } else {
      static size_t done[64] = {};
      err = allow_smem((const void*)xc_gga_v_kernel<false>, smem, done);
      if (err != cudaSuccess) return (int)err;
      xc_gga_v_kernel<false><<<grid, threads, smem, stream>>>(
          npad, gpad, ldv, aot, gp, s, u, v_part);
    }
  } else {
    const int ntiles = T * (T + 1) / 2;
    const size_t smem = lda_v_smem(npad);
    static size_t done[64] = {};
    err = allow_smem((const void*)xc_lda_v_kernel, smem, done);
    if (err != cudaSuccess) return (int)err;
    xc_lda_v_kernel<<<dim3((ntiles + kVWarps - 1) / kVWarps, nchunk),
                      32 * (ntiles < kVWarps ? ntiles : kVWarps), smem,
                      stream>>>(npad, gpad, chunk, ldv, aot, s, v_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (nao * nao + kReduceBlock - 1) / kReduceBlock + 1;
  xc_reduce_kernel<true, double><<<nblk, kReduceBlock, 0, stream>>>(
      nao, nchunk, ldv, gpad / kRhoCols, gga ? 0.5f : 1.f, v_part, e_part,
      v_out, e_out);
  return (int)cudaGetLastError();
}

// K1's V chunk for these shapes on the current device (gga_v_chunk): the
// chunk (> 0), or minus the CUDA error code.
int fused_xc_tc_v_chunk(int npad, int gpad) {
  int chunk;
  const cudaError_t err = gga_v_chunk(npad, gpad, &chunk);
  return err == cudaSuccess ? chunk : -(int)err;
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
