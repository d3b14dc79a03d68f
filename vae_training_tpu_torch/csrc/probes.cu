// The probes of the MLP kernel's design questions, for Hopper (sm_90a):
// T4, T3 and T5 (chains of dependent 104×256×256 dots, fp32 or with bf16
// operands and f32 sums) and T2 (one dot in fp32, TF32 and bf16
// tensor-core modes).
//
// Replaces the TPU probes' Pallas kernels:
//   T4 tools/probe_mlp_interleave.py:_chain_kernel (run, :62): 1, 2 or 4
//      chains of 24 dependent dots a step, each chain's weight eye·(1+1e-4c),
//      min(·, 8) after every dot;
//   T3 tools/probe_mxu_pipelining.py:make_kernel (run, :82): 1, 2 or 4 chains
//      of 8 dots with 8 distinct weights a chain, each trip renormalised by
//      max|y| of the chain;
//   T5 tools/probe_adam_overlap.py:_kernel (run, :110): 25 dependent dots over
//      5 weight buffers (5 dots each) plus Adam on the 5 buffers, in a tail
//      or interleaved with the dots;
//   T2 tools/check_precision.py:check_dot_modes (mk, :28): one
//      (128×256)·(256×256) dot in three precisions.
//
// Each probe asks the tool's question of the design the port has, not of
// Mosaic's schedule. That design is the MLP kernel's phase design: one
// cooperative launch of one 512-thread block an SM; each dependent layer is
// one phase over all SMs; grid.sync() between phases; Adam a grid-wide
// phase after the backward. chain_phase_kernel is that design on the
// probes' shapes: "chains interleaved op by op" on the TPU becomes "all
// chains' dot d in one phase", the question K6b's rows ask. What bounds it:
// latency, not the rate (a 104×256×256 dot is 13.6 MFLOP, 203 ns at
// 67 TFLOP/s fp32): each phase waits for its units' operands from L2, their
// products and the sums of their K slices, then for a grid barrier. A phase
// cuts its dot into units of 16 rows × 16 (fp32) or 32 (bf16) columns of
// one chain, K split over 8 half-warps (fp32) or warps (bf16), every
// operand of a slice fetched in one L2 round trip, the slices' partial
// tiles summed in rank order (phase_dot_fp32, phase_dot_bf16); T5's Adam
// takes tiles of 64 rows × 8 columns a CTA, each column's sum of h taken
// once a tile (adam_phase).
//
// chain_cluster_kernel is T4 on the design R1 considers in its place, as
// K6b runs a row: one thread-block cluster a chain, here of 16 CTAs cut
// into 8 row groups × 2 column slices (chain_plan), each CTA holding its
// slice of W in registers and its row group's rows of h in shared memory,
// the new rows pushed to the row group's other CTA by st.async after every
// dot, one mbarrier wait a dot and no grid or cluster barrier (see the
// kernel).
//
// chain_stream_kernel<mode, bf16> is T3 and T5 on that cluster plan: their
// weights change from dot to dot, so each warp streams its K slice of the
// next dot's weights from L2 into a ring in shared memory (cp.async.bulk
// on mbarriers; bf16: each CTA a bf16 copy of its slice of the dot after
// next, in one copy) while the current dot runs; T3's renorm meets the chain's
// 16 maxima through distributed shared memory, T5's Adam the column sums
// of h (see the kernel). chain_phase_kernel stays as T3's and T5's "phase"
// form, and as T4's.
//
// bf16 dots: T4, T3 and T5 each have a second instantiation of their
// kernels (kBf16, chosen by the entries' bf16_dots), which computes what the
// TPU tools' dots compute at precision=None, their default: both operands
// rounded to bfloat16 (round to nearest even) at every dot, the products
// summed in f32 (T2's check_dot_modes showed the TPU's default f32 dot
// equal to the explicit bf16 cast, tools/check_precision.py:3-8). The
// inputs, the outputs, h between dots and T5's master weights stay f32, as
// do the clamp, T3's renorm and T5's Adam; a dot rounds the current f32
// weights as it reads them. Every product is a tensor-core mma.sync
// m16n8k16 (mma::mma_bf16, csrc/mma_bf16.cuh), issued from a zero
// accumulator a k16 step, its partial sums added to the outputs' f32 sums
// by IEEE adds in ascending k (a sum carried through the tensor cores'
// truncating accumulator drifted in the MLP kernel, PERF.md §6). 104 rows
// are 6.5 m16 tiles: the last tile's rows 104..111 are zeros, never
// another chain's rows. The phase form cuts a dot into units of one m16
// tile × 32 columns, K split over 8 warps whose operands come from L2 in one
// round trip (phase_dot_bf16); the cluster form splits N over its warps, a
// warp's 13 rows padded to one m16 tile × 16 of its CTA's columns over the
// whole K (16 k16 steps, W's slice in registers, h in shared memory as
// bf16, read by ldmatrix); the stream form keeps T4's cut, a warp's 13 rows
// × its CTA's 128 columns as 16 n8 tiles over its 32-long K slice (two k16
// steps). What bounds the bf16 forms is not the tensor cores' rate (a dot
// is 13.6 MFLOP: 13.8 ns at 989 TFLOP/s, 114 ns on one chain's 16 SMs) but
// the loads that feed the fragments and the dependent steps around them:
// the phase form's L2 round trip, its partial tiles' sums and its grid
// barrier a dot; the cluster form's ldmatrix reads, its epilogue and the
// push and wait a dot; the stream form's A and B pairs from shared memory
// (B from a bf16 copy of the weights that the launch writes and streams,
// one copy a CTA a dot), laid out so that no access is bank-conflicted,
// then the partial tiles, the sums and the exchange as in fp32 (PERF.md §6).
//
// dot_kernel<mode> is T2: out = x·w, x (M × K) and w (K × N) fp32 and
// row-major, in three modes. Hopper has no implicit reduced-precision
// default, so the modes are: fp32, fmaf chains on the CUDA cores (the analog
// of Precision.HIGHEST; no tensor cores); tf32, wgmma with operands rounded
// by cvt.rna.tf32.f32 (nearest, ties away: explicit, so the plain version
// knows which rounding happened; a tensor core fed raw fp32 would truncate);
// bf16, wgmma with operands rounded by __float2bfloat16_rn (the tool's
// "cast"). Every mode sums in fp32. At the tool's shape, (128×256)·(256×256),
// a call is 16.8 MFLOP on 0.5 MB that L2 holds, so no rate bounds it (250 ns
// of fp32 FMAs, 157 ns of HBM bytes): latency does, that of the launch, of
// each CTA's pull of its operands from L2 and of the dependent steps inside
// a CTA. The work is cut for latency: 64 × 32 output tiles, K split over the
// CTAs of one thread-block cluster (up to 8: 128 CTAs of one warpgroup at the
// tool's shape, each with a 32-long K slice); each CTA stages its A (64 × 32)
// and B (32 × 32) slices in shared memory by cp.async, 16 bytes a lane, all
// in flight at once; tf32 and bf16 then round them in one pass into wgmma's
// K-major layout (B transposed on the way); it multiplies (fp32: 4 × 4
// outputs a thread; otherwise one wgmma m64n32 a K step) and sends each
// band of its partial tile to the CTA of the cluster that owns the band
// (st.async into distributed shared memory, counted by the owner's
// mbarrier), which sums the bands in rank order (fixed, no atomics: two
// calls give the same bits). What is left is latency: the launch, the pull
// from L2, the exchange's wait for the cluster's slowest CTA (PERF.md §6).
// The plan (tile, split, grid, shared bytes) is dot_plan's;
// kernels/probes.py:dot_plan is the same arithmetic.
//
// Pointers to buffers a launch writes are never const __restrict__ (the
// non-coherent read path can return stale data across grid.sync()).
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 104;  // the sphere sweep's batch 100, rounded to 8
constexpr int kW = 256;     // its hidden width 200, rounded to 256
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChains = 4;
constexpr float kClamp = 8.0f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kAdamLr = 1e-9f;  // the tool's learning rate

constexpr int kEpClamp = 0;   // min(y, 8) after every dot (T4, T5)
constexpr int kEpRenorm = 1;  // y / max(max|y|, 1e-6) a chain after each trip (T3)
constexpr int kAdamNone = 0;
constexpr int kAdamTail = 1;
constexpr int kAdamInterleaved = 2;

struct ChainArgs {
  float* h;                // (2, n_chains, kRows, kW) ping-pong; h[0] holds the input
  float* w;                // (n_chains, depth / dots_per_weight, kW, kW); T5 updates it
  float* m;                // T5: Adam m of chain 0's weights, else null
  float* v;                // T5: Adam v
  unsigned int* maxbits;   // T3: (2, n_chains) max|y| as float bits, zeroed by the caller
  int n_chains, n_steps, depth, dots_per_weight, epilogue, adam, t0, upto;
};

// the phase form's launch variants for the time split: every phase empty
// but for its grid barrier; every phase's work (the dots' products and
// stores, T3's scale, T5's Adam) without the barriers (a race: the result
// is not the chain's); or whole
constexpr int kPhaseUptoBarriers = 0;
constexpr int kPhaseUptoWork = 1;
constexpr int kPhaseUptoAll = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float4 clamp4(float4 v) {
  return make_float4(fminf(v.x, kClamp), fminf(v.y, kClamp), fminf(v.z, kClamp),
                     fminf(v.w, kClamp));
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float h, const float4& w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

// 16 bytes global → shared by cp.async through L2 (.cg), the caller waits
__device__ __forceinline__ void dot_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// bf16 dots: the phase form's dot is cut into units, each 16 rows (one m16
// tile) × 32 columns (four n8 tiles) of one chain, whose K is split over the
// 8 warps of one half of a CTA: warp kq (its rank) takes k [32kq, 32kq + 32),
// two k16 steps. A warp issues every load of its slice before its first mma:
// 4 float4 of h (rows g and g + 8 of both steps) and 8 float4 of W, each by
// ld.global.cg (L2: h and T5's W were written by other CTAs before the last
// grid barrier, and L1 is not coherent), so a unit waits for one L2 round
// trip. Both operands are read in a K order permuted within each k16 step:
// the lane (g, t) holds the step's fragment positions 2t, 2t + 1, 2t + 8 and
// 2t + 9, which stand for physical k 4t .. 4t + 3 of the step, one float4 of
// a row of h; W's rows 4t .. 4t + 3 are the B pairs' k. The columns too: n8
// tile r's column j is the unit's column 4j + r, so the lane's B values of
// the four tiles at a k are one float4 (columns 4g .. 4g + 3), each of W's
// rows read by 8 lanes as 128 contiguous bytes. A permutation within a step
// changes which products one mma sums, never which step a product is in, so
// each k16 step's partial is still the sum of its 16 products, taken from a
// zero accumulator and added to the lane's f32 sums by an IEEE add in
// ascending k; the 8 warps' partial tiles then go to shared memory (rows 36
// floats apart: a quarter-warp's float4 stores fall in distinct banks) and
// are summed in rank order by the half-CTA's 256 threads, 2 outputs each,
// which clamp (T4, T5), store and fold |y| into lmax (T3). The order is
// fixed and the same at every chain count; units go to CTAs slot-major (unit
// u to CTA u mod gridDim, half u / gridDim mod 2), as many rounds as the
// chains need (one up to 4 chains on 132 SMs). Rows past kRows (the last m16
// tile's 104..111) are zeros, never loaded or stored.
constexpr int kMTiles = (kRows + 15) / 16;        // 7 m16 tiles a chain, the last half zeros
constexpr int kPhaseCols = 32;                    // a unit's columns: four n8 tiles
constexpr int kPhaseKSplit = 8;                   // warps a unit, one K slice each
constexpr int kPhaseKSlice = kW / kPhaseKSplit;   // 32 k a warp: two k16 steps
constexpr int kPhaseSlots = kWarps / kPhaseKSplit;  // units a CTA a round
constexpr int kPhaseUnits = kMTiles * (kW / kPhaseCols);  // 56 a chain
constexpr int kPhasePartStride = kPhaseCols + 4;  // a partial tile's row stride (floats)
static_assert(kWarps % kPhaseKSplit == 0 && kPhaseKSlice == 32, "two k16 steps a warp");

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ void phase_dot_bf16(const ChainArgs& A, const float* in, float* out, int d,
                               float (&lmax)[kMaxChains]) {
  constexpr int per_chain = kRows * kW;
  __shared__ __align__(16) float part[kPhaseSlots][kPhaseKSplit][16 * kPhasePartStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int slot = warp / kPhaseKSplit, kq = warp % kPhaseKSplit;
  const int n_units = A.n_chains * kPhaseUnits;
  const int per_round = kPhaseSlots * static_cast<int>(gridDim.x);
  const int n_w = A.depth / A.dots_per_weight;
  for (int u0 = 0; u0 < n_units; u0 += per_round) {
    const int u = u0 + slot * static_cast<int>(gridDim.x) + static_cast<int>(blockIdx.x);
    const bool live = u < n_units;
    const int c = u / kPhaseUnits, rem = u - c * kPhaseUnits;
    const int mt = rem / (kW / kPhaseCols), nq = rem - mt * (kW / kPhaseCols);
    if (live) {
      const int k0 = kq * kPhaseKSlice, r0 = 16 * mt + g;
      const bool live1 = r0 + 8 < kRows;  // false in the last m16 tile, for every lane
      const float* h0 = in + c * per_chain + r0 * kW + k0 + 4 * t;
      const float* W = A.w + (static_cast<size_t>(c) * n_w + d / A.dots_per_weight) * kW * kW +
                       (k0 + 4 * t) * kW + kPhaseCols * nq + 4 * g;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 ha[2][2], wb[2][4];  // every load of the slice before the first mma
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        ha[s][0] = ldcg4(h0 + 16 * s);
        ha[s][1] = live1 ? ldcg4(h0 + 8 * kW + 16 * s) : zero;
#pragma unroll
        for (int i = 0; i < 4; ++i) wb[s][i] = ldcg4(W + (16 * s + i) * kW);
      }
      float acc[4][4] = {};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t a[4] = {mma::bf16x2(ha[s][0].x, ha[s][0].y),
                               mma::bf16x2(ha[s][1].x, ha[s][1].y),
                               mma::bf16x2(ha[s][0].z, ha[s][0].w),
                               mma::bf16x2(ha[s][1].z, ha[s][1].w)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma::mma_bf16(p, a, mma::bf16x2(lane4(wb[s][0], r), lane4(wb[s][1], r)),
                        mma::bf16x2(lane4(wb[s][2], r), lane4(wb[s][3], r)));
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[r][x] += p[x];
        }
      }
      // tile r's fragment columns 2t and 2t + 1 are the unit's 8t + r and 8t + 4 + r
      float* pp = part[slot][kq] + g * kPhasePartStride + 8 * t;
      *reinterpret_cast<float4*>(pp) = make_float4(acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
      *reinterpret_cast<float4*>(pp + 4) = make_float4(acc[0][1], acc[1][1], acc[2][1], acc[3][1]);
      pp += 8 * kPhasePartStride;
      *reinterpret_cast<float4*>(pp) = make_float4(acc[0][2], acc[1][2], acc[2][2], acc[3][2]);
      *reinterpret_cast<float4*>(pp + 4) = make_float4(acc[0][3], acc[1][3], acc[2][3], acc[3][3]);
    }
    __syncthreads();  // the units' partial tiles stored
    if (live) {
      const int i = threadIdx.x % (32 * kPhaseKSplit), row = i >> 4, col = 2 * (i & 15);
      const int R = 16 * mt + row;
      if (R < kRows) {
        const float* ps = part[slot][0] + row * kPhasePartStride + col;
        float2 y = *reinterpret_cast<const float2*>(ps);
#pragma unroll
        for (int w = 1; w < kPhaseKSplit; ++w) {
          const float2 v = *reinterpret_cast<const float2*>(ps + w * 16 * kPhasePartStride);
          y.x += v.x;
          y.y += v.y;
        }
        if (A.epilogue == kEpClamp) y = make_float2(fminf(y.x, kClamp), fminf(y.y, kClamp));
        *reinterpret_cast<float2*>(out + c * per_chain + R * kW + kPhaseCols * nq + col) = y;
        const float mx = fmaxf(fabsf(y.x), fabsf(y.y));
#pragma unroll
        for (int q = 0; q < kMaxChains; ++q)
          if (q == c) lmax[q] = fmaxf(lmax[q], mx);
      }
    }
    __syncthreads();  // every partial tile read before the next round stores
  }
}

// fp32 dots: the phase form's dot is cut into units, each 16 rows (one m16
// tile of the bf16 cut) × 16 columns of one chain, 112 a chain, whose K is
// split over 8 half-warps, 4 warps a unit: half-warp kq (its rank: half
// lane / 16 of the unit's warp kq / 2) takes k [32kq, 32kq + 32). It stages
// its slices of h (16 rows × 32 k, rows 36 floats apart) and W (32 k × 16
// columns) in shared memory by cp.async, 16 bytes a copy, 16 copies a lane
// all in flight (L2: h and T5's W were written by other CTAs before the last
// grid barrier), so a unit waits for one L2 round trip. Its lane (tm, tn) =
// (l / 4, l % 4), l the lane's index in the half, keeps rows 4tm .. 4tm + 3
// × columns 4tn .. 4tn + 3 of the unit: 16 fmaf chains over its 32 k in
// ascending k, fed by 8 float4 shared-memory reads every 4 k (a
// quarter-warp reads two rows 144 bytes apart and one 64-byte row of W: one
// wavefront each). The partial tile goes into the half-warp's own stage
// (rows 20 floats apart), and 64 threads of the unit sum the 8 tiles in rank
// order, one float4 each (a quarter-warp reads rows r and r + 4: one
// wavefront), clamp (T4, T5), store and fold |y| into lmax (T3). The order
// (32-long fmaf chains, then the ranks) is the same at every chain count;
// units go to CTAs slot-major (unit u to CTA u mod gridDim, slot u /
// gridDim mod 4), as many rounds as the chains need (one up to 4 chains on
// 132 SMs). Rows past kRows are never loaded (their outputs, never stored,
// are garbage) or stored.
constexpr int kPhaseColsF = 16;                            // a unit's columns
constexpr int kPhaseWarpsF = kPhaseKSplit / 2;             // 4 warps a unit
constexpr int kPhaseSlotsF = kWarps / kPhaseWarpsF;        // 4 units a CTA a round
constexpr int kPhaseUnitsF = kMTiles * (kW / kPhaseColsF);  // 112 a chain
constexpr int kPhaseHStrideF = kPhaseKSlice + 4;           // the staged h's row stride (floats)
constexpr int kPhasePartStrideF = kPhaseColsF + 4;         // a partial tile's row stride
constexpr int kPhaseStageF = 16 * kPhaseHStrideF + kPhaseKSlice * kPhaseColsF;  // a half-warp's
constexpr int kPhaseSmemF = kPhaseSlotsF * kPhaseKSplit * kPhaseStageF * 4;  // dynamic bytes
static_assert(16 * kPhasePartStrideF <= kPhaseStageF, "a partial tile fits in its stage");

__device__ void phase_dot_fp32(const ChainArgs& A, const float* in, float* out, int d,
                               float (&lmax)[kMaxChains], float* stages) {
  constexpr int per_chain = kRows * kW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, l = lane & 15;
  const int slot = warp / kPhaseWarpsF, kq = 2 * (warp % kPhaseWarpsF) + (lane >> 4);
  const int tm = l >> 2, tn = l & 3;
  float* unit_stages = stages + slot * kPhaseKSplit * kPhaseStageF;
  float* hs = unit_stages + kq * kPhaseStageF;  // 16 rows of kPhaseHStrideF
  float* ws = hs + 16 * kPhaseHStrideF;         // 32 k-rows of 16
  const int n_units = A.n_chains * kPhaseUnitsF;
  const int per_round = kPhaseSlotsF * static_cast<int>(gridDim.x);
  const int n_w = A.depth / A.dots_per_weight;
  for (int u0 = 0; u0 < n_units; u0 += per_round) {
    const int u = u0 + slot * static_cast<int>(gridDim.x) + static_cast<int>(blockIdx.x);
    const bool live = u < n_units;
    const int c = u / kPhaseUnitsF, rem = u - c * kPhaseUnitsF;
    const int mt = rem / (kW / kPhaseColsF), nq = rem - mt * (kW / kPhaseColsF);
    if (live) {
      const int k0 = kq * kPhaseKSlice;
      const float* hg = in + c * per_chain + 16 * mt * kW + k0;
      const float* wg = A.w + (static_cast<size_t>(c) * n_w + d / A.dots_per_weight) * kW * kW +
                        k0 * kW + kPhaseColsF * nq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // h: 16 rows × 8 float4, a row by 8 lanes
        const int row = 2 * j + (l >> 3), q = l & 7;
        if (16 * mt + row < kRows)
          dot_cp_async16(hs + row * kPhaseHStrideF + 4 * q, hg + row * kW + 4 * q);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // W: 32 k-rows × 4 float4, a k-row by 4 lanes
        const int k = 4 * j + (l >> 2), q = l & 3;
        dot_cp_async16(ws + k * kPhaseColsF + 4 * q, wg + k * kW + 4 * q);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      float4 acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kPhaseKSlice; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(hs + (4 * tm + i) * kPhaseHStrideF + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(ws + (k + j) * kPhaseColsF + 4 * tn);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i], lane4(a[i], kk), b[kk]);
      }
      __syncwarp();  // both halves' stages read: the partial tiles take their place
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(hs + (4 * tm + i) * kPhasePartStrideF + 4 * tn) = acc[i];
    }
    __syncthreads();  // the units' partial tiles stored
    const int i = threadIdx.x % (32 * kPhaseWarpsF);
    if (live && i < 64) {
      const int sn = i & 3, row = 4 * ((i >> 2) & 1) + ((i >> 3) & 3) + 8 * (i >> 5);
      const int R = 16 * mt + row;
      if (R < kRows) {
        const float* ps = unit_stages + row * kPhasePartStrideF + 4 * sn;
        float4 y = *reinterpret_cast<const float4*>(ps);
#pragma unroll
        for (int q = 1; q < kPhaseKSplit; ++q)
          add4(y, *reinterpret_cast<const float4*>(ps + q * kPhaseStageF));
        if (A.epilogue == kEpClamp) y = clamp4(y);
        *reinterpret_cast<float4*>(out + c * per_chain + R * kW + kPhaseColsF * nq + 4 * sn) = y;
        const float mx = fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)), fmaxf(fabsf(y.z), fabsf(y.w)));
#pragma unroll
        for (int q = 0; q < kMaxChains; ++q)
          if (q == c) lmax[q] = fmaxf(lmax[q], mx);
      }
    }
    __syncthreads();  // every partial tile read before the next round stages
  }
}

// T5's Adam: a phase's buffers [b0, b1) of chain 0's weights in tiles of 64
// rows × 8 columns (a 32-byte sector a row), 128 a buffer, tile q on CTA q
// mod gridDim, an element a thread. The gradient of element (k, j) is the
// column mean of h broadcast down the rows, so a CTA stages its tile's 8
// columns of h (104 × 8 floats, L2) and each thread sums its column in
// ascending r from 0 (the order a thread of the earlier body took for
// every element), once for the tile and all its buffers.
constexpr int kAdamCols = 8;
constexpr int kAdamRows = kThreads / kAdamCols;  // 64
constexpr int kAdamTiles = (kW / kAdamCols) * (kW / kAdamRows);

// Adam on element e of buffer b (its m, v and w loaded: m0, v0, w0), s
// the column sum of h. The gradient is the column mean ·1e-6(b + 1) (the
// tool's grad_for); the bias corrections 1 − βᵗ are the caller's, from
// double.
__device__ __forceinline__ void adam_item(const ChainArgs& A, float s, int b, int e, float bc1,
                                          float bc2, float m0, float v0, float w0) {
  const float g = (s / static_cast<float>(kRows)) * static_cast<float>(1e-6 * (b + 1));
  const size_t at = static_cast<size_t>(b) * kW * kW + e;
  const float m = kB1 * m0 + kOneMinusB1 * g;
  const float v = kB2 * v0 + kOneMinusB2 * g * g;
  const float bc2_sqrt = sqrtf(bc2);
  const float lr_t = kAdamLr * bc2_sqrt / bc1;
  A.m[at] = m;
  A.v[at] = v;
  A.w[at] = w0 - lr_t * m / (sqrtf(v) + kAdamEps * bc2_sqrt);
}

// Every thread of the CTA calls it. A thread loads its elements' m, v and w
// (up to kAdamAhead buffers) before the column sum, so their round trip
// runs beside it.
constexpr int kAdamAhead = 5;
__device__ void adam_phase(const ChainArgs& A, const float* h, int b0, int b1, float bc1,
                           float bc2) {
  __shared__ __align__(16) float hc[kRows * kAdamCols];
  const int j = threadIdx.x % kAdamCols;
  for (int q = blockIdx.x; q < kAdamTiles; q += gridDim.x) {
    const int j0 = kAdamCols * (q % (kW / kAdamCols)), r0 = kAdamRows * (q / (kW / kAdamCols));
    const int e = (r0 + static_cast<int>(threadIdx.x) / kAdamCols) * kW + j0 + j;
    float m0[kAdamAhead], v0[kAdamAhead], w0[kAdamAhead];
#pragma unroll
    for (int i = 0; i < kAdamAhead; ++i)
      if (b0 + i < b1) {
        const size_t at = static_cast<size_t>(b0 + i) * kW * kW + e;
        m0[i] = A.m[at];
        v0[i] = A.v[at];
        w0[i] = A.w[at];
      }
    if (threadIdx.x < kRows * kAdamCols / 4) {
      const int r = threadIdx.x / (kAdamCols / 4), c4 = 4 * (threadIdx.x % (kAdamCols / 4));
      *reinterpret_cast<float4*>(hc + r * kAdamCols + c4) = ldcg4(h + r * kW + j0 + c4);
    }
    __syncthreads();
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += hc[r * kAdamCols + j];
#pragma unroll
    for (int i = 0; i < kAdamAhead; ++i)
      if (b0 + i < b1) adam_item(A, s, b0 + i, e, bc1, bc2, m0[i], v0[i], w0[i]);
    for (int b = b0 + kAdamAhead; b < b1; ++b) {
      const size_t at = static_cast<size_t>(b) * kW * kW + e;
      adam_item(A, s, b, e, bc1, bc2, A.m[at], A.v[at], A.w[at]);
    }
    __syncthreads();  // hc read before the next tile stages
  }
}

// Each chain's max of its threads' lmax into maxbits[c]: a warp reduce, a
// block reduce, one atomicMax a block (|y| ≥ 0, so the float's bits order
// as the floats do). Every thread of the block calls it.
__device__ void block_max_to_global(const float lmax[kMaxChains], unsigned int* words,
                                    int n_chains) {
  __shared__ float red[kMaxChains][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxChains; ++c) {
    float x = lmax[c];
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[c][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < n_chains) {
    float x = 0.0f;
    for (int w = 0; w < kWarps; ++w) x = fmaxf(x, red[threadIdx.x][w]);
    atomicMax(words + threadIdx.x, __float_as_uint(x));
  }
  __syncthreads();
}

// T4, T3 and T5: n_steps trips of `depth` dependent dots on every chain, one
// phase a dot. T3 adds a scale phase a trip; T5 adds Adam, either as one
// phase after the last dot (tail: every gradient from the final h, as in
// K5) or as extra items of the phase of dot dpw·(b + 1) for buffer b (its
// gradient reads h after dot dpw·b + dpw − 1, the phase's own input, so it
// needs no barrier of its own), the last buffer in a phase of its own. A
// phase's dot is K-split units of 16 × 16 (fp32, phase_dot_fp32, in
// kPhaseSmemF bytes of dynamic shared memory) or 16 × 32 outputs (bf16 dots,
// kBf16: phase_dot_bf16), then Adam's tiles (adam_phase).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) chain_phase_kernel(ChainArgs A) {
  extern __shared__ __align__(16) float phase_stages[];  // fp32: the half-warps' stages
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsz = gridDim.x * blockDim.x;
  const int n_h = A.n_chains * kRows * kW;
  const int n_buf = A.depth / A.dots_per_weight;
  const bool work = A.upto != kPhaseUptoBarriers, sync = A.upto != kPhaseUptoWork;
  int cur = 0;
  for (int it = 0; it < A.n_steps; ++it) {
    float bc1 = 1.0f, bc2 = 1.0f;
    if (A.adam != kAdamNone) {
      const double t = static_cast<double>(A.t0 + it + 1);
      bc1 = static_cast<float>(1.0 - pow(0.9, t));
      bc2 = static_cast<float>(1.0 - pow(0.999, t));
    }
    for (int d = 0; d < A.depth; ++d) {
      const float* in = A.h + cur * n_h;
      float* out = A.h + (cur ^ 1) * n_h;
      const bool adam_here =
          A.adam == kAdamInterleaved && d > 0 && d % A.dots_per_weight == 0;
      float lmax[kMaxChains] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (work) {
        if constexpr (kBf16)
          phase_dot_bf16(A, in, out, d, lmax);
        else
          phase_dot_fp32(A, in, out, d, lmax, phase_stages);
        if (adam_here) {
          const int b = d / A.dots_per_weight - 1;
          adam_phase(A, in, b, b + 1, bc1, bc2);
        }
      }
      if (work && A.epilogue == kEpRenorm && d == A.depth - 1)
        block_max_to_global(lmax, A.maxbits + (it & 1) * A.n_chains, A.n_chains);
      if (sync) grid.sync();
      cur ^= 1;
    }
    float* h = A.h + cur * n_h;
    if (A.epilogue == kEpRenorm) {
      const unsigned int* words = A.maxbits + (it & 1) * A.n_chains;
      for (int i = gtid; work && i < n_h; i += gsz) {
        const float mx = __uint_as_float(__ldcg(words + i / (kRows * kW)));  // L2: atomics'
        h[i] = h[i] * (1.0f / fmaxf(mx, 1e-6f));
      }
      // the next trip's words; this trip's are read above, after a barrier
      if (gtid < A.n_chains) A.maxbits[((it + 1) & 1) * A.n_chains + gtid] = 0u;
      if (sync) grid.sync();
    }
    if (A.adam != kAdamNone) {
      if (work) adam_phase(A, h, A.adam == kAdamTail ? 0 : n_buf - 1, n_buf, bc1, bc2);
      if (sync) grid.sync();
    }
  }
}

constexpr int kDotFp32 = 0;
constexpr int kDotTf32 = 1;
constexpr int kDotBf16 = 2;
constexpr int kDotThreads = 128;    // one warpgroup a CTA
constexpr int kDotTileM = 64;       // wgmma's M; rows past M are zeros
constexpr int kDotTileN = 32;       // wgmma's N; columns past N are zeros
constexpr int kDotChunkK = 32;      // K elements staged a round
constexpr int kDotUnitK = 16;       // slices are whole units of bf16 wgmma's K
constexpr int kDotMaxSplit = 8;     // the portable cluster size
constexpr int kDotMaxBlocks = 132;  // the H100's SMs: the split fills at most one CTA an SM
constexpr int kDotRawStride = 36;   // the staged A's row stride (floats): rows 16 bytes
                                    // apart in the banks, for the rounding pass's reads
constexpr int kDotPStride = 40;     // the partial sums' row stride (floats)
// launch variants for the time split: return after the launch, after the
// staging, after the products (partial tile in shared memory), or run whole
constexpr int kUptoLaunch = 0;
constexpr int kUptoStage = 1;
constexpr int kUptoProducts = 2;
constexpr int kUptoAll = 3;

// Dynamic shared memory of a CTA: the staged fp32 slices (A 64 × 36, B
// 32 × 32), then for tf32 and bf16 the rounded operands in wgmma's layout
// (64 × 32 and 32 × 32 values), then the owner's slots of partial sums
// (64 rows of kDotPStride floats).
constexpr int dot_smem_bytes(int mode) {
  return (kDotTileM * kDotRawStride + kDotChunkK * kDotTileN) * 4 +
         (mode == kDotFp32 ? 0 : (kDotTileM + kDotTileN) * kDotChunkK * (mode == kDotBf16 ? 2 : 4)) +
         kDotTileM * kDotPStride * 4;
}

struct DotPlan {
  int tile_m, tile_n, chunk_k, split, cluster, grid_x, grid_y, smem, threads;
};

// The launch's plan (kernels/probes.py:dot_plan is the same arithmetic):
// 64 × 32 output tiles, K cut into `split` slices of whole 16-element units
// (the first units % split slices one unit longer), split the largest power
// of two ≤ 8 with at most one slice a unit and at most 132 CTAs in all; one
// cluster of `split` CTAs a tile, grid (split · tiles along N, tiles along M).
// Returns false for a shape outside the contract (M a multiple of 16, N of 8,
// K of 16) or past the grid's limits.
bool dot_plan(int M, int K, int N, int mode, DotPlan* p) {
  if (mode < kDotFp32 || mode > kDotBf16 || M < 16 || N < 8 || K < 16 || M % 16 != 0 ||
      N % 8 != 0 || K % 16 != 0)
    return false;
  const int units = K / kDotUnitK;
  const int tiles_m = (M + kDotTileM - 1) / kDotTileM;
  const int tiles_n = (N + kDotTileN - 1) / kDotTileN;
  if (tiles_m > 65535) return false;
  int split = kDotMaxSplit;
  while (split > 1 && (split > units || static_cast<long long>(tiles_m) * tiles_n * split >
                                            kDotMaxBlocks))
    split /= 2;
  if (static_cast<long long>(tiles_n) * split > 0x7fffffffLL) return false;
  *p = DotPlan{kDotTileM, kDotTileN, kDotChunkK, split,           split,
               tiles_n * split, tiles_m, dot_smem_bytes(mode), kDotThreads};
  return true;
}

struct DotArgs {
  const float* x;  // (M, K) row-major
  const float* w;  // (K, N) row-major
  float* out;      // (M, N) row-major
  int M, K, N, split, upto;
};

__device__ __forceinline__ uint32_t tf32_rna(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A wgmma shared-memory descriptor, no swizzle: the start address, the
// leading byte offset (between core matrices adjacent along K) and the
// stride byte offset (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 × 32, fp32, wgmma's accumulator layout) += A · B over one K step:
// 8 TF32 or 16 bf16 elements, both operands K-major in shared memory.
template <int kMode>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (kMode == kDotTf32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));  // scale-d 1: d += A · B
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));  // scale-d 1: d += A · B
  }
}

// One round's A rows [m0, m0 + 64) and B columns [n0, n0 + 32) over K
// [kb, kb + kc), as they are (fp32), into ra (64 rows of kDotRawStride) and
// rb (32 k-rows of 32), 16 bytes a cp.async, 8 lanes a 128-byte row piece;
// the caller waits for them. What lies past M, N or kc is left as it is:
// its products land only in outputs never stored, and the rounding pass
// writes zeros for it.
__device__ __forceinline__ void stage_raw(const DotArgs& A, float* ra, float* rb, int m0,
                                          int n0, int kb, int kc) {
#pragma unroll
  for (int j = 0; j < kDotTileM * kDotChunkK / 4 / kDotThreads; ++j) {
    const int i = threadIdx.x + j * kDotThreads;
    const int r = i >> 3, q = i & 7;
    if (4 * q < kc && m0 + r < A.M)
      dot_cp_async16(ra + r * kDotRawStride + 4 * q,
                     A.x + static_cast<size_t>(m0 + r) * A.K + kb + 4 * q);
  }
#pragma unroll
  for (int j = 0; j < kDotChunkK * kDotTileN / 4 / kDotThreads; ++j) {
    const int i = threadIdx.x + j * kDotThreads;
    const int k = i >> 3, q = i & 7;
    if (k < kc && n0 + 4 * q < A.N)
      dot_cp_async16(rb + k * kDotTileN + 4 * q,
                     A.w + static_cast<size_t>(kb + k) * A.N + n0 + 4 * q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// fp32: thread (tm, tn) = (tid / 8, tid % 8) adds the round's kK products
// to its 4 × 4 outputs (rows 4tm.., columns 4tn..), ascending k, a fmaf
// each; A read as float4 along k (a quarter-warp shares the address), B
// along n.
template <int kK>
__device__ __forceinline__ void products_fp32(float (&acc)[16], const float* ra,
                                              const float* rb) {
  const int tm = threadIdx.x >> 3, tn = threadIdx.x & 7;
#pragma unroll
  for (int k = 0; k < kK; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(ra + (4 * tm + i) * kDotRawStride + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(rb + (k + j) * kDotTileN + 4 * tn);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[4 * i + j] = fmaf(lane_of(a[i], kk), lane_of(b[kk], j), acc[4 * i + j]);
  }
}

// A 16-byte chunk of operand values, rounded as the mode says: 4 TF32
// (cvt.rna: nearest, ties away) or 8 bf16 (nearest even), lower k first.
template <int kMode>
__device__ __forceinline__ uint4 round_chunk(const float* v) {
  if constexpr (kMode == kDotTf32)
    return make_uint4(tf32_rna(v[0]), tf32_rna(v[1]), tf32_rna(v[2]), tf32_rna(v[3]));
  else
    return make_uint4(bf16x2_rn(v[0], v[1]), bf16x2_rn(v[2], v[3]), bf16x2_rn(v[4], v[5]),
                      bf16x2_rn(v[6], v[7]));
}

// tf32 and bf16: the staged round, rounded, into wgmma's K-major layout
// without swizzle (ca, cb). A 16-byte chunk holds 4 TF32 or 8 bf16 values
// of one row along K; chunk c of row r of a tile sits at byte
// ((r / 8) · chunks + c) · 128 + (r % 8) · 16 (8 × 16-byte core matrices,
// adjacent along K). A's item i (r % 8 = i % 8, c = i / 8 % chunks, r / 8 =
// i / (8 · chunks)) goes to byte 16 i: a quarter-warp fills one core matrix
// from 8 staged rows 144 bytes apart (distinct banks). B's item i (n = i %
// 32, c = i / 32) gathers w's column n at 4 or 8 consecutive k (a warp
// reads whole staged rows): B is transposed here. K past kc and rows past M
// or N are zeros.
template <int kMode>
__device__ __forceinline__ void round_tc(const DotArgs& A, const float* ra, const float* rb,
                                         unsigned char* ca, unsigned char* cb, int m0, int n0,
                                         int kc) {
  constexpr int kElems = kMode == kDotBf16 ? 8 : 4;  // values a 16-byte chunk
  constexpr int kChunks = kDotChunkK / kElems;       // chunks a row a round
  constexpr int kItemsA = kDotTileM * kChunks / kDotThreads;
  constexpr int kItemsB = kDotTileN * kChunks / kDotThreads;
  float va[kItemsA][kElems], vb[kItemsB][kElems];  // every load before the first store
#pragma unroll
  for (int j = 0; j < kItemsA; ++j) {
    const int i = threadIdx.x + j * kDotThreads;
    const int r = (i / (8 * kChunks)) * 8 + (i & 7), c = (i >> 3) % kChunks;
    const bool live = m0 + r < A.M && c * kElems < kc;
#pragma unroll
    for (int h = 0; h < kElems / 4; ++h) {
      const float4 f = live ? *reinterpret_cast<const float4*>(ra + r * kDotRawStride +
                                                               c * kElems + 4 * h)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      va[j][4 * h] = f.x; va[j][4 * h + 1] = f.y; va[j][4 * h + 2] = f.z; va[j][4 * h + 3] = f.w;
    }
  }
#pragma unroll
  for (int j = 0; j < kItemsB; ++j) {
    const int i = threadIdx.x + j * kDotThreads;
    const int n = i & 31, c = i >> 5;
    const bool live = n0 + n < A.N && c * kElems < kc;
#pragma unroll
    for (int e = 0; e < kElems; ++e) vb[j][e] = live ? rb[(c * kElems + e) * kDotTileN + n] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kItemsA; ++j)
    *reinterpret_cast<uint4*>(ca + 16 * (threadIdx.x + j * kDotThreads)) = round_chunk<kMode>(va[j]);
#pragma unroll
  for (int j = 0; j < kItemsB; ++j) {
    const int i = threadIdx.x + j * kDotThreads;
    const int n = i & 31, c = i >> 5;
    *reinterpret_cast<uint4*>(cb + ((n >> 3) * kChunks + c) * 128 + (n & 7) * 16) =
        round_chunk<kMode>(vb[j]);
  }
  // the generic proxy's stores, seen by wgmma's reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// tf32 and bf16: the round's kK / (32 bytes) wgmma steps (8 TF32 or 16
// bf16 values each) on the warpgroup's 64 × 32 accumulator, then a wait;
// with `cluster_wait`, the cluster barrier's wait runs while they do.
template <int kMode, int kK>
__device__ __forceinline__ void products_tc(float (&acc)[16], const unsigned char* ca,
                                            const unsigned char* cb, bool cluster_wait) {
  constexpr int kElems = kMode == kDotBf16 ? 8 : 4;
  constexpr int kChunks = kDotChunkK / kElems;
  const uint64_t da = wgmma_desc(ca, 128, 128 * kChunks);
  const uint64_t db = wgmma_desc(cb, 128, 128 * kChunks);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kK / (2 * kElems); ++s)
    wgmma_m64n32<kMode>(acc, da + 16 * s, db + 16 * s);  // + 256 bytes a step
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  if (cluster_wait) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 16 bytes of partial sums into the owner's slot in distributed shared
// memory; the owner's mbarrier counts them (st.async: nothing waits for the
// store here).
__device__ __forceinline__ void send4(uint32_t dst, uint32_t bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(local), "r"(rank));
  return a;
}

// T2: out = x · w. CTA (rank q of the cluster, tile) sums its K slice of a
// 64 × 32 output tile in rounds of up to 32: stage the fp32 slices
// (cp.async), round them into wgmma's layout (tf32, bf16), multiply. Rank q
// owns rows [q · R, (q + 1) · R) of the tile, R = 64 / split: every CTA
// sends its partial sums of those rows to slot (its rank) of the owner's
// shared memory by st.async, which the owner's mbarrier counts (64 · 32 · 4
// bytes from the cluster in all); the owner waits for them, sums its slots
// in rank order and writes out. The mbarrier is set up before a cluster
// barrier that every CTA arrives at once its first copies are in flight and
// waits at before it sends (tf32, bf16: while its last wgmma steps run).
template <int kMode>
__global__ void __launch_bounds__(kDotThreads) dot_kernel(DotArgs A) {
  if (A.upto == kUptoLaunch) return;
  __shared__ __align__(8) uint64_t bar;  // the owner's: the cluster's partial sums arrived
  extern __shared__ __align__(128) unsigned char dot_smem[];
  const bool whole = A.upto == kUptoAll;
  float* ra = reinterpret_cast<float*>(dot_smem);
  float* rb = ra + kDotTileM * kDotRawStride;
  unsigned char* ca = reinterpret_cast<unsigned char*>(rb + kDotChunkK * kDotTileN);
  unsigned char* cb = ca + kDotTileM * kDotChunkK * (kMode == kDotBf16 ? 2 : 4);
  float* slots = reinterpret_cast<float*>(
      kMode == kDotFp32 ? ca : cb + kDotTileN * kDotChunkK * (kMode == kDotBf16 ? 2 : 4));
  const int split = A.split;
  const int rank = static_cast<int>(blockIdx.x) % split;
  const int m0 = static_cast<int>(blockIdx.y) * kDotTileM;
  const int n0 = (static_cast<int>(blockIdx.x) / split) * kDotTileN;
  const int units = A.K / kDotUnitK;
  const int base = units / split, extra = units % split;
  const int k_begin = kDotUnitK * (rank * base + min(rank, extra));
  const int k_end = k_begin + kDotUnitK * (base + (rank < extra ? 1 : 0));
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  for (int kb = k_begin; kb < k_end; kb += kDotChunkK) {
    const int kc = min(kDotChunkK, k_end - kb);  // 32 or 16
    if (kb != k_begin) __syncthreads();  // the last round's products have read the stage
    stage_raw(A, ra, rb, m0, n0, kb, kc);
    if (whole && kb == k_begin) {  // the copies in flight: set up the mbarrier, arrive
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)));
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(&bar)),
            "r"(kDotTileM * kDotTileN * 4)
            : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncwarp();  // thread 0's fence above releases the set-up
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if constexpr (kMode == kDotFp32) {
      if (A.upto >= kUptoProducts) {
        if (kc == kDotChunkK) products_fp32<kDotChunkK>(acc, ra, rb);
        else products_fp32<kDotUnitK>(acc, ra, rb);
      }
    } else {
      round_tc<kMode>(A, ra, rb, ca, cb, m0, n0, kc);
      __syncthreads();
      if (A.upto >= kUptoProducts) {
        const bool last = whole && kb + kDotChunkK >= k_end;
        if (kc == kDotChunkK) products_tc<kMode, kDotChunkK>(acc, ca, cb, last);
        else products_tc<kMode, kDotUnitK>(acc, ca, cb, last);
      }
    }
  }
  if (A.upto == kUptoStage) return;
  // Row r of the tile goes to slot `rank`, row r % R, of its owner r / R, at
  // float (rank · R + r % R) · kDotPStride + column (the products variant:
  // into its own slots, by plain stores).
  const int R = kDotTileM / split;
  if (whole && kMode == kDotFp32)  // every CTA of the cluster runs, its mbarrier set up
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const uint32_t local_slots = smem_addr(slots);
  auto dst = [&](int r, int col) {
    return local_slots + 4 * ((rank * R + r % R) * kDotPStride + col);
  };
  if constexpr (kMode == kDotFp32) {
    const int tm = threadIdx.x >> 3, tn = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tm + i;
      const float4 v = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      if (whole)
        send4(peer_addr(dst(r, 4 * tn), r / R), peer_addr(smem_addr(&bar), r / R), v);
      else
        *reinterpret_cast<float4*>(slots + (rank * R + r % R) * kDotPStride + 4 * tn) = v;
    }
  } else {
    // wgmma's accumulator: warp v holds rows 16v.., lane (g, t) = (lane / 4,
    // lane % 4) rows 16v + g and + 8, columns 8j + 2t and + 1 of n8 block j.
    // Lanes t and t ^ 1 swap halves, so that an even lane holds 4 columns
    // 8j + 2t.. of row 16v + g and an odd lane 4 columns 8j + 2t − 2.. of
    // row 16v + g + 8: one 16-byte send each.
    const int v = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const bool odd = t & 1;
    const int r = 16 * v + g + (odd ? 8 : 0);
    const uint32_t rbar = peer_addr(smem_addr(&bar), r / R);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
      const float y1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
      const float4 q = odd ? make_float4(y0, y1, acc[4 * j + 2], acc[4 * j + 3])
                           : make_float4(acc[4 * j], acc[4 * j + 1], y0, y1);
      const int col = 8 * j + 2 * (t & 2);
      if (whole)
        send4(peer_addr(dst(r, col), r / R), rbar, q);
      else
        *reinterpret_cast<float4*>(slots + (rank * R + r % R) * kDotPStride + col) = q;
    }
  }
  if (!whole) return;
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(&bar))
        : "memory");
  for (int i = threadIdx.x; i < R * (kDotTileN / 4); i += kDotThreads) {
    const int lr = i / (kDotTileN / 4), c = 4 * (i % (kDotTileN / 4));
    const int row = m0 + rank * R + lr;
    if (row < A.M && n0 + c < A.N) {
      float4 y[kDotMaxSplit];
#pragma unroll
      for (int q = 0; q < kDotMaxSplit; ++q)
        if (q < split)
          y[q] = *reinterpret_cast<const float4*>(slots + (q * R + lr) * kDotPStride + c);
      float4 s = y[0];
#pragma unroll
      for (int q = 1; q < kDotMaxSplit; ++q)
        if (q < split) {
          s.x += y[q].x; s.y += y[q].y; s.z += y[q].z; s.w += y[q].w;
        }
      *reinterpret_cast<float4*>(A.out + static_cast<size_t>(row) * A.N + n0 + c) = s;
    }
  }
}

// T4's cluster form: one thread-block cluster of 16 CTAs a chain (a
// non-portable size), cut into 8 row groups of 13 rows × 2 column slices of
// 128. Row r of h after a dot depends on row r before it alone, so a CTA
// holds only its row group's rows of h, twice (this dot's input and the
// next's), and after a dot pushes its slice of the new rows to the row
// group's other CTA and nowhere else, by st.async, counted by the peer's
// mbarrier; every thread waits on its own CTA's mbarrier (one arrive/wait a
// dot, no cluster barrier), then a block barrier.
//
// fp32: its 8 warps split K: warp w keeps W[32w .. 32w + 32, its slice] in
// registers for the whole launch (a lane 32 × 4 values: its 4 columns), so
// a dot reads only h from shared memory, one float4 (4 k) broadcast to the
// warp a row for 16 FMAs a lane; a lane sums 13 × 4 outputs over its warp's
// 32 k as fmaf chains in ascending k. The 8 partial tiles go to shared
// memory and every thread sums 1 or 2 float4 of them in K order (warp 0's
// first), clamps, writes them into its CTA's next h and pushes them to the
// peer, 16 bytes at a time. What bounds it: a 104×256×256 dot is 6.8 M
// FMAs, on 16 SMs ≥ 1.7 µs at 128 FMAs a clock and 1980 MHz; here the
// products issue 13,312 FMA instructions a CTA a dot against 3,328
// shared-memory wavefronts of h, and the partial sums, the push and the
// wait follow.
//
// bf16 dots: its 8 warps split N: warp w owns columns [16w, 16w + 16) of
// its CTA's 128, two n8 tiles (tile r's fragment column j is the warp's
// column 2j + r, so a lane's accumulators hold the 4 adjacent columns 4t ..
// 4t + 3 of rows g and g + 8), over the whole K: 16 k16 steps, W's 256 × 16
// slice held as bf16 B fragments for the launch (64 registers a lane). h
// lives in shared memory as bf16, 16 rows a buffer (rows 13..15 zeros,
// never written), rows 512 bytes apart with each 128-byte line's 16-byte
// chunks permuted by the row (cl_h_offset), so a k16 step's A fragments
// come by one ldmatrix.x4 whose 8 × 8 matrices each read 8 rows in
// distinct banks, and the epilogue's 8-byte stores fall in distinct banks
// too (kernels/probes.py cluster_h_offset, cluster_wavefronts). Each k16
// step's mma.sync starts from a zero accumulator and its partial is added
// to the lane's f32 sums by IEEE adds in ascending k: no partial tiles, no
// cross-warp sums. A dot takes the 8 k16 steps of the CTA's own columns
// first and waits for the peer's rows only before the other 8, so the push
// and wait run beside half the products (a CTA of slice 1 keeps its own
// steps' partials until steps 0..7 are added: each slice's body is its own
// instantiation, chain_cluster_bf16<kSlice>). The epilogue clamps, rounds to
// bf16 once (the next dot rounds h to bf16 anyway: the same bits) and
// writes the CTA's own next h and the peer's, 8 bytes a lane (3,328 bytes a
// dot); the last dot's clamped f32 outputs go from the registers to out.
// What bounds it: 32 mma.sync a warp a dot (114 ns a dot on 16 SMs at the
// dense bf16 rate), 16 ldmatrix, the epilogue and its block barrier.
//
// The plan is constants (kernels/probes.py:chain_plan mirrors them): a
// launch takes only the chain count and the dot mode.
constexpr int kChainCluster = 16;
constexpr int kChainThreads = 256;
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kChainSlices = 2;                            // column slices a row group
constexpr int kChainGroups = kChainCluster / kChainSlices;  // 8 row groups
constexpr int kChainRows = kRows / kChainGroups;            // 13 rows a CTA
constexpr int kChainCols = kW / kChainSlices;               // 128 columns a CTA: a lane 4
constexpr int kChainKSlice = kW / kChainWarps;              // 32 k a warp
constexpr int kChainTile = kChainRows * kChainCols;         // floats of a CTA's tile
static_assert(kRows % kChainGroups == 0 && kChainCols == 4 * 32, "the plan's cut");
// launch variants for the time split: stop after staging W and x, after
// the products, after the store into the CTA's own next h (fp32: the
// partial tiles' sums; bf16: the clamp and rounding), or run whole (the
// push to the peer and the wait)
constexpr int kChainUptoStage = 0;
constexpr int kChainUptoProducts = 1;
constexpr int kChainUptoStore = 2;
constexpr int kChainUptoAll = 3;

// bf16 dots' cut (see above)
constexpr int kClWarpCols = kChainCols / kChainWarps;  // 16 columns a warp: two n8 tiles
constexpr int kClSteps = kW / 16;                      // k16 steps a dot
constexpr int kClHRows = 16;                           // h's rows a buffer: 13, then 3 zero rows
constexpr int kClHBuf = kClHRows * kW;                 // bf16 elements a buffer
constexpr uint32_t kClPushBytes = kChainRows * kChainCols * 2;  // what the peer sends a dot
static_assert(kClWarpCols == 16 && kChainRows <= kClHRows, "two n8 tiles a warp, one m16 tile");

// Dynamic shared memory a CTA: fp32, h twice and the 8 warps' partial tiles
// (W lives in registers); bf16, h twice as bf16.
constexpr int chain_cluster_smem(bool bf16) {
  return bf16 ? 2 * kClHBuf * 2 : (2 * kChainRows * kW + kChainWarps * kChainTile) * 4;
}

struct ChainClusterArgs {
  const float* x;  // (n_chains, kRows, kW)
  const float* w;  // (n_chains, kW, kW)
  float* out;      // (n_chains, kRows, kW)
  int n_steps, depth, upto;
};

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the mbarrier's phase of parity `parity`. A
// wait of 2^32 clocks (~2 s) means an arrival was lost: the kernel traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  }
}

// bf16 dots in the stream form's cut: a warp's 13 rows are one m16 tile,
// rows 13..15 zeros, and its CTA's 128 columns 16 n8 tiles; its K slice two
// k16 steps. The lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8
// (g + 8 < 13 for g < 5), columns 8nt + 2t and + 1 of each n8 tile nt, in
// mma.sync's accumulator fragment.
constexpr int kChainNTiles = kChainCols / 8;
static_assert(kChainRows <= 16 && kChainKSlice % 16 == 0, "one m16 tile, whole k16 steps");

// The warp's A fragment of one k16 step: rows g and g + 8 of h (row stride
// kStride floats; h at the step's first k), k 2t.. and 2t + 8.., read as
// float2 and rounded to bfloat16; the zero rows as zeros.
template <int kStride = kW>
__device__ __forceinline__ void chain_a_frag(uint32_t (&a)[4], const float* h, int g, int t) {
  const bool live1 = g + 8 < kChainRows;
  const float* p0 = h + g * kStride + 2 * t;
  const float* p1 = h + (live1 ? g + 8 : g) * kStride + 2 * t;
  a[0] = mma::bf16x2(*reinterpret_cast<const float2*>(p0));
  a[1] = live1 ? mma::bf16x2(*reinterpret_cast<const float2*>(p1)) : 0u;
  a[2] = mma::bf16x2(*reinterpret_cast<const float2*>(p0 + 8));
  a[3] = live1 ? mma::bf16x2(*reinterpret_cast<const float2*>(p1 + 8)) : 0u;
}

// The cluster form's bf16 h: chunk c (8 bf16, 16 bytes) of row r sits at
// chunk (c & ~7) | ((c & 7) ^ cl_swizzle(r mod 8)) of the row, 512 bytes a
// row. Eight rows at one chunk fill a 128-byte line's 8 chunks (ldmatrix);
// rows 4m .. 4m + 3 at chunks {2p, 2p + 1} do too (the epilogue's 8-byte
// stores of a half-warp).
__host__ __device__ constexpr int cl_swizzle(int r) { return ((r & 3) << 1) | ((r >> 2) & 1); }

// bf16 element offset of h[r][k] in a buffer
__device__ __forceinline__ int cl_h_offset(int r, int k) {
  const int c = k >> 3;
  return r * kW + ((c & ~7) | ((c & 7) ^ cl_swizzle(r & 7))) * 8 + (k & 7);
}

// The four 8 × 8 bf16 matrices whose rows the lanes address (lanes 8m ..
// 8m + 7 matrix m) into a[m]: the A fragment of mma.sync m16n8k16 for
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15).
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// 8 bytes into a CTA's shared memory in the cluster, counted by its mbarrier.
__device__ __forceinline__ void send2(uint32_t dst, uint32_t bar, uint32_t lo, uint32_t hi) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "r"(lo), "r"(hi), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void chain_cluster_fp32(const ChainClusterArgs& A) {
  constexpr uint32_t kPushBytes = kChainTile * 4;  // what the peer sends a dot
  constexpr int kQuads = kChainTile / 4;           // float4 of a tile
  __shared__ __align__(8) uint64_t bar[2];         // bar[b]: the peer's rows of h[b] arrived
  extern __shared__ __align__(16) float csmem[];
  float* hb = csmem;                        // 2 × kChainRows × kW
  float* part = hb + 2 * kChainRows * kW;   // kChainWarps × kChainTile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = rank / kChainSlices, slice = rank % kChainSlices;
  const int peer = group * kChainSlices + (slice ^ 1);
  const int chain = static_cast<int>(blockIdx.x) / kChainCluster;
  const int row0 = group * kChainRows, col0 = slice * kChainCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = warp * kChainKSlice;
  const float* xc = A.x + (static_cast<size_t>(chain) * kRows + row0) * kW;
  const float* wc = A.w + (static_cast<size_t>(chain) * kW + kb) * kW + col0 + 4 * lane;
  float4 wr[kChainKSlice];  // W[kb + k][col0 + 4 lane ..]: the lane's for the launch
#pragma unroll
  for (int k = 0; k < kChainKSlice; ++k) wr[k] = *reinterpret_cast<const float4*>(wc + k * kW);
  for (int i = threadIdx.x; i < kChainRows * kW / 4; i += kChainThreads)
    reinterpret_cast<float4*>(hb)[i] = reinterpret_cast<const float4*>(xc)[i];
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[b])));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(&bar[b])),
                   "r"(kPushBytes)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA staged, its mbarriers set up, before any push

  float* my_part = part + warp * kChainTile + 4 * lane;
  const int total = A.upto == kChainUptoStage ? 0 : A.n_steps * A.depth;
  for (int dot = 0; dot < total; ++dot) {
    const int cur = dot & 1, nxt = cur ^ 1;
    const float* h = hb + cur * kChainRows * kW + kb;
    float4 acc[kChainRows];
#pragma unroll
    for (int r = 0; r < kChainRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < kChainKSlice; k += 4) {
#pragma unroll
      for (int r = 0; r < kChainRows; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(h + r * kW + k);
        fma4(acc[r], hv.x, wr[k]);
        fma4(acc[r], hv.y, wr[k + 1]);
        fma4(acc[r], hv.z, wr[k + 2]);
        fma4(acc[r], hv.w, wr[k + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kChainRows; ++r)
      *reinterpret_cast<float4*>(my_part + r * kChainCols) = acc[r];
    __syncthreads();  // the partial tiles stored; this dot's h read by every warp
    if (A.upto == kChainUptoProducts) continue;
    float* hn = hb + nxt * kChainRows * kW + col0;
    for (int i = threadIdx.x; i < kQuads; i += kChainThreads) {
      const int r = i / (kChainCols / 4), c = 4 * (i % (kChainCols / 4));
      float4 s = *reinterpret_cast<const float4*>(part + r * kChainCols + c);
#pragma unroll
      for (int w = 1; w < kChainWarps; ++w)
        add4(s, *reinterpret_cast<const float4*>(part + w * kChainTile + r * kChainCols + c));
      const float4 y = clamp4(s);
      float* at = hn + r * kW + c;
      *reinterpret_cast<float4*>(at) = y;
      if (A.upto == kChainUptoAll)
        send4(peer_addr(smem_addr(at), peer), peer_addr(smem_addr(&bar[nxt]), peer), y);
    }
    if (A.upto == kChainUptoAll) {
      const uint32_t parity = (dot >> 1) & 1;  // bar[nxt]'s uses: every other dot
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(&bar[nxt])), "r"(parity)
            : "memory");
    }
    __syncthreads();  // the next h whole in this CTA: its own rows and the peer's
    if (A.upto == kChainUptoAll && threadIdx.x == 0)  // re-arm for its use two dots on
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(&bar[nxt])),
                   "r"(kPushBytes)
                   : "memory");
  }
  const float* hf = hb + (total & 1) * kChainRows * kW + col0;
  float* oc = A.out + (static_cast<size_t>(chain) * kRows + row0) * kW + col0;
  for (int i = threadIdx.x; i < kQuads; i += kChainThreads) {
    const int r = i / (kChainCols / 4), c = 4 * (i % (kChainCols / 4));
    *reinterpret_cast<float4*>(oc + r * kW + c) = *reinterpret_cast<const float4*>(hf + r * kW + c);
  }
  cluster.sync();  // no CTA leaves while its peer may still address its shared memory
}

// One k16 step's partials of the warp's two n8 tiles, each from a zero
// accumulator: A by ldmatrix from the buffer at shared address `h` (the
// lane's row lr, its k offset lk), B the step's pairs.
__device__ __forceinline__ void cl_step(float (&p)[2][4], uint32_t h, int lr, int lk, int s,
                                        const uint32_t (&b)[2][2]) {
  uint32_t a[4];
  ldsm_x4(a, h + 2 * cl_h_offset(lr, 16 * s + lk));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int x = 0; x < 4; ++x) p[r][x] = 0.0f;
    mma::mma_bf16(p[r], a, b[r][0], b[r][1]);
  }
}

__device__ __forceinline__ void cl_add(float (&acc)[2][4], const float (&p)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[r][x] += p[r][x];
}

// The bf16 body of a CTA of column slice kSlice; bar[b]: the peer's rows of
// h[b] arrived (the kernel's, at one address in every CTA).
template <int kSlice>
__device__ __forceinline__ void chain_cluster_bf16(const ChainClusterArgs& A,
                                                   uint64_t (&bar)[2]) {
  extern __shared__ __align__(128) unsigned char cl_smem[];
  uint16_t* hb = reinterpret_cast<uint16_t*>(cl_smem);  // 2 × kClHBuf bf16
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = rank / kChainSlices, peer = group * kChainSlices + (kSlice ^ 1);
  const int chain = static_cast<int>(blockIdx.x) / kChainCluster;
  const int row0 = group * kChainRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wc0 = kSlice * kChainCols + kClWarpCols * warp;  // the warp's first column of h
  // W[16s + 2t.., wc0 + 2g + r] as the B pairs of step s, n8 tile r
  uint32_t wb[kClSteps][2][2];
  const float* wg = A.w + (static_cast<size_t>(chain) * kW + 2 * t) * kW + wc0 + 2 * g;
#pragma unroll
  for (int s = 0; s < kClSteps; ++s)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* w = wg + 16 * s * kW + r;
      wb[s][r][0] = mma::bf16x2(w[0], w[kW]);
      wb[s][r][1] = mma::bf16x2(w[8 * kW], w[9 * kW]);
    }
  // h[0]: x's rows rounded; rows 13..15 of both buffers zeros
  const float* xc = A.x + (static_cast<size_t>(chain) * kRows + row0) * kW;
  for (int i = threadIdx.x; i < kClHRows * kW / 4; i += kChainThreads) {
    const int r = i / (kW / 4), k = 4 * (i % (kW / 4));
    const float4 v = r < kChainRows ? *reinterpret_cast<const float4*>(xc + r * kW + k)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const uint2 p = make_uint2(mma::bf16x2(v.x, v.y), mma::bf16x2(v.z, v.w));
    *reinterpret_cast<uint2*>(hb + cl_h_offset(r, k)) = p;
    if (r >= kChainRows) *reinterpret_cast<uint2*>(hb + kClHBuf + cl_h_offset(r, k)) = p;
  }
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[b])));
      mbar_expect(&bar[b], kClPushBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA staged, its mbarriers set up, before any push

  const uint32_t hs = smem_addr(hb);
  // the lane's ldmatrix row: row lr of h, k 16s + lk
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lk = 8 * (lane >> 4);
  constexpr int kHalf = kClSteps / 2;  // k16 steps of a column slice of h
  const int total = A.upto == kChainUptoStage ? 0 : A.n_steps * A.depth;
  for (int dot = 0; dot < total; ++dot) {
    const int cur = dot & 1, nxt = cur ^ 1;
    const uint32_t hc = hs + 2 * cur * kClHBuf;
    // The CTA's own columns of h first (its warps wrote them before the last
    // block barrier), then the peer's, once they arrived: slice 0 adds its
    // steps 0..7 as it goes, slice 1 keeps its steps 8..15 until steps 0..7
    // are added. Either way each output adds its 16 partials to 0 in
    // ascending k.
    float acc[2][4] = {}, p[2][4];
    float kept[kSlice ? kHalf : 1][2][4];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      if constexpr (kSlice == 0) {
        cl_step(p, hc, lr, lk, i, wb[i]);
        cl_add(acc, p);
      } else {
        cl_step(kept[i], hc, lr, lk, kHalf + i, wb[kHalf + i]);
      }
    }
    if (A.upto == kChainUptoAll && dot > 0) {  // the peer's rows of h[cur], pushed last dot
      mbar_wait(&bar[cur], ((dot - 1) >> 1) & 1);
      if (threadIdx.x == 0) mbar_expect(&bar[cur], kClPushBytes);  // its use two dots on
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int st = kSlice == 0 ? kHalf + i : i;
      cl_step(p, hc, lr, lk, st, wb[st]);
      cl_add(acc, p);
    }
    if constexpr (kSlice == 1)
#pragma unroll
      for (int i = 0; i < kHalf; ++i) cl_add(acc, kept[i]);
    // row g + 8h, columns wc0 + 4t .. + 3: tile 0's and tile 1's registers 2h, then 2h + 1
    if (dot == total - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (g + 8 * h < kChainRows)
          *reinterpret_cast<float4*>(A.out + (static_cast<size_t>(chain) * kRows + row0 + g +
                                              8 * h) * kW + wc0 + 4 * t) =
              clamp4(make_float4(acc[0][2 * h], acc[1][2 * h], acc[0][2 * h + 1],
                                 acc[1][2 * h + 1]));
      break;
    }
    if (A.upto == kChainUptoProducts) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (g + 8 * h >= kChainRows) break;
      const float4 y = clamp4(make_float4(acc[0][2 * h], acc[1][2 * h], acc[0][2 * h + 1],
                                          acc[1][2 * h + 1]));
      const uint32_t lo = mma::bf16x2(y.x, y.y), hi = mma::bf16x2(y.z, y.w);
      const int at = nxt * kClHBuf + cl_h_offset(g + 8 * h, wc0 + 4 * t);
      *reinterpret_cast<uint2*>(hb + at) = make_uint2(lo, hi);
      if (A.upto == kChainUptoAll)
        send2(peer_addr(hs + 2 * at, peer), peer_addr(smem_addr(&bar[nxt]), peer), lo, hi);
    }
    __syncthreads();  // the CTA's own rows of the next h whole
  }
  cluster.sync();  // no CTA leaves while its peer may still address its shared memory
}

template <bool kBf16>
__global__ void __launch_bounds__(kChainThreads, 1) chain_cluster_kernel(ChainClusterArgs A) {
  if constexpr (kBf16) {
    __shared__ __align__(8) uint64_t bar[2];
    if (cg::this_cluster().block_rank() % kChainSlices == 0)
      chain_cluster_bf16<0>(A, bar);
    else
      chain_cluster_bf16<1>(A, bar);
  } else {
    chain_cluster_fp32(A);
  }
}

template <bool kBf16>
cudaError_t launch_chain_cluster(const ChainClusterArgs& A, int n_chains, cudaStream_t stream) {
  constexpr int smem = chain_cluster_smem(kBf16);
  cudaError_t e = cudaFuncSetAttribute(chain_cluster_kernel<kBf16>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(chain_cluster_kernel<kBf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(n_chains * kChainCluster);
  cfg.blockDim = dim3(kChainThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kChainCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chain_cluster_kernel<kBf16>, A);
}

// T3's and T5's stream form: T4's cluster plan (16 CTAs a chain, 8 row
// groups of 13 rows × 2 column slices of 128, K over 8 warps, rows pushed
// to the row group's other CTA by st.async, h double-buffered, one mbarrier
// a buffer) with weights that change from dot to dot. T3 has 8 distinct
// weights a chain (2 MB a chain), T5 five buffers that Adam rewrites
// every step: neither fits in registers or stays in shared memory, but
// neither depends on h, so each warp streams its K slice of the next dot's
// W[:, its 128 columns] from L2 into its own ring in shared memory while
// the current dot runs: 4 stages of 8 k-rows × 128 columns (4 KB, one 2-D
// bulk tensor copy (TMA) on a tensor map of the weights' stack, completed
// on the stage's mbarrier), one dot's K slice in all, a stage refilled with
// the next dot's chunk as soon as the warp has read it. (Eight 1-D
// 512-byte cp.async.bulk copies a stage, the same bytes, streamed slower
// and hid less of the stream behind the products: the copies' count, not
// their bytes, held it.) A warp reads each stage as T4's lane reads its
// registers: a float4 of W (the warp's 512 contiguous bytes of a k-row) a
// k, a broadcast float4 of h a row for 16 FMAs; fp32 fmaf chains in
// ascending k, the 8 partial tiles summed in K order, as T4's.
//
// T3's renorm: after each trip's last dot every CTA pushes the max|y| of
// its tile to all 16 CTAs (st.async, 4 bytes each, onto an mbarrier of two
// alternating by trip); each CTA then scales its row group's whole 13 ×
// 256 rows (its own half and the half its peer pushed, unscaled) by
// 1 / max(max of the 16, 1e-6): no global atomics, no grid barrier.
//
// T5's Adam (one chain): CTA (row group q, slice s) updates rows [32q, 32q
// + 32) × its 128 columns of each buffer, m and v in device memory (L2
// holds all 7.9 MB). The gradient needs the column sums of h over all 104
// rows: each CTA sums its 13 rows of its 128 columns and pushes them to the
// 8 CTAs of its slice, which sum the 8 in row-group order (two launches
// give the same bits). Adam writes W with generic stores and the next
// step's bulk copies read it through the async proxy: every writer fences
// (fence.proxy.async.global) and arrives at a cluster barrier with release
// semantics, and a CTA issues a copy of an updated buffer only after its
// acquire wait and its own proxy fence. In the tail, the first dot of the
// next step waits for that barrier (its copies are issued after it); when
// interleaved, buffer b's next copy comes 15 or more dots later, so the
// wait is deferred to the next Adam (whose column sums must not land
// before every CTA has read the last ones).
//
// What bounds it: the products on one chain's 16 SMs (13,312 FMA
// instructions a CTA a dot, ≥ 1.68 µs at 1980 MHz), fed by 68 shared-memory
// wavefronts every 4 k a warp (16 of W, 52 of h: a warp's float4 load is
// four wavefronts, broadcast or not): the products alone take most of a
// dot (PERF.md §6). Then 128 KB a CTA a dot from L2, which the ring has a
// dot to bring in;
// T5 adds Adam's 480 KB of w, m and v a CTA a step and the column sums'
// exchange. (A lane of 8 columns with the K slice split over half-warps
// cut the wavefronts by 38% but ran the products slower, and was not
// kept.)
constexpr int kT3Depth = 8;    // distinct weights a chain, dots a trip
constexpr int kT5Bufs = 5;     // T5's weight buffers
constexpr int kT5DotsPerBuf = 5;
constexpr int kStreamT3 = 0;   // modes: T3 (renorm), T5 with Adam in a tail, interleaved
constexpr int kStreamTail = 1;
constexpr int kStreamInterleaved = 2;
constexpr int kStreamStages = 4;                             // ring stages a warp
constexpr int kStreamChunkK = kChainKSlice / kStreamStages;  // 8 k-rows a stage
constexpr int kStreamAdamRows = kW / kChainGroups;           // 32 rows of W a CTA's Adam
// launch variants for the time split: stream the weights alone (each warp
// waits for its chunks and refills them); the products and partial tiles
// alone, from the first dot's chunks (the ring filled once, no stream); the
// products with the stream; + the sums, the epilogue and the row exchange;
// or run whole (+ T3's renorm or T5's Adam)
constexpr int kStreamUptoWeights = 0;
constexpr int kStreamUptoCompute = 1;
constexpr int kStreamUptoProducts = 2;
constexpr int kStreamUptoExchange = 3;
constexpr int kStreamUptoAll = 4;
static_assert(kChainKSlice % kStreamStages == 0 && kStreamChunkK % 4 == 0, "the ring's chunks");
// bf16: the stream carries the weights' bf16 copy (StreamArgs::wb, which
// the kernel writes), half the bytes; a ring slot is two 32 KB blocks of a
// dot's 256 k-rows × 64 of the CTA's columns, swizzled 128 B (16-byte chunk
// j of line k at chunk j ^ (k mod 8)), so the ring starts on a 1 KB
// boundary. h's rows are 8 floats apart in the banks; the partial tiles'
// rows 4, their chunks swizzled too (part_offset).
constexpr int kStreamBlockCols = 64;  // bf16 columns a 128-byte line
constexpr int kStreamAlign = 1024;
template <bool kBf16>
struct StreamLayout {
  // the ring, 128 KB a CTA: fp32, 4 stages a warp of 8 k-rows × 128 columns,
  // one copy each; bf16, two slots of a whole dot's 256 k-rows, one copy each
  static constexpr int ring_words = kChainWarps * kStreamStages * kStreamChunkK * kChainCols;
  static constexpr int slots = kBf16 ? 2 : 1;  // dots the ring holds
  static constexpr int slot_words = ring_words / slots;
  static constexpr uint32_t copy_bytes = kBf16 ? 4 * slot_words : 4 * kStreamChunkK * kChainCols;
  static constexpr int h_stride = kBf16 ? kW + 8 : kW;                // floats a row of h
  static constexpr int part_stride = kBf16 ? kChainCols + 4 : kChainCols;  // of a partial tile
  static constexpr int part_tile = kChainRows * part_stride;
  static constexpr int align = kBf16 ? kStreamAlign : 0;  // bytes kept to align the ring
  // where a partial tile holds its row r, column c: bf16 flips bit 1 of the
  // 16-byte chunk index in the upper half of each 64 columns
  __host__ __device__ static constexpr int part_offset(int r, int c) {
    return r * part_stride + (kBf16 ? c ^ (((c >> 5) & 1) << 3) : c);
  }
};

// Dynamic shared memory: the warps' rings, h twice, the partial tiles, then
// T3's 2 × 16 maxima or T5's 8 × 128 column sums and 128 gradients.
template <bool kBf16>
constexpr int stream_smem_bytes(int mode) {
  using L = StreamLayout<kBf16>;
  return L::align +
         4 * (L::ring_words + 2 * kChainRows * L::h_stride +
              kChainWarps * L::part_tile +
              (mode == kStreamT3 ? 2 * kChainCluster : (kChainGroups + 1) * kChainCols));
}

struct StreamArgs {
  const float* x;  // (n_chains, kRows, kW)
  float* w;        // T3: (n_chains, kT3Depth · kW, kW); T5: (kT5Bufs, kW, kW), updated
  __nv_bfloat16* wb;  // bf16: w's bf16 copy, w's shape, written by the launch; else null
  float* m;        // T5: Adam's m and v of the buffers, updated
  float* v;
  float* out;      // (n_chains, kRows, kW)
  int n_steps, t0, upto;
};

// 4 bytes into a CTA's shared memory in the cluster, counted by its mbarrier.
__device__ __forceinline__ void send1(uint32_t dst, uint32_t bar, float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// One bulk tensor copy of the weights' stack (a dot's W rows k0.. at row
// idx · kW + k0) into the ring, columns [col0, col0 + 128), completed on
// `bar`, which lane 0 arms with the copy's bytes first. fp32: a warp's
// stage, rows [row, row + 8), a 2-D box of the weights, 8 × 128 floats
// row-major; bf16: a CTA's slot, the dot's 256 rows from `row`, a 3-D box
// of their bf16 copy, 64 columns × 256 rows × 2 column blocks, swizzled
// 128 B (stream_b8).
template <bool kBf16>
__device__ __forceinline__ void stream_issue(const CUtensorMap* map, int row, int col0,
                                             float* stage, uint64_t* bar, int lane) {
  if (lane != 0) return;
  mbar_expect(bar, StreamLayout<kBf16>::copy_bytes);
  if constexpr (kBf16)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
        "[%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(stage)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(col0 / kStreamBlockCols),
        "r"(smem_addr(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
        "[%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(stage)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(row), "r"(smem_addr(bar))
        : "memory");
}

// bf16: the 16 bytes of a swizzled slot that hold W[k][64p + 8j .. 64p +
// 8j + 7] of the dot (k < 256 its row) as bf16: block p, line k, chunk
// j ^ (k mod 8).
__device__ __forceinline__ uint4 stream_b8(const float* slot, int p, int k, int j) {
  return *reinterpret_cast<const uint4*>(slot + p * (kW * kStreamBlockCols / 2) +
                                         k * (kStreamBlockCols / 2) + 4 * (j ^ (k & 7)));
}

__device__ __forceinline__ uint32_t word4(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// bf16: the warp's partial tile into its slot (13 rows, the CTA's 128
// columns at part_offset). In the stream form n8 tile 8p + r has column j
// at the slice's column 64p + 8j + r, so the lane's fragment columns 2t and
// 2t + 1 of tiles 8p .. 8p + 7 are the 8 floats at 64p + 16t and the 8 at
// 64p + 16t + 8, two float4 each; the zero rows are dropped.
__device__ __forceinline__ void stream_store_part(float* slot, const float (&acc)[kChainNTiles][4],
                                                  int g, int t) {
  using L = StreamLayout<true>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8: fragment registers 2h, 2h + 1
    if (h == 1 && g + 8 >= kChainRows) break;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * p + 4 * e, reg = 2 * h + x;
          *reinterpret_cast<float4*>(
              slot + L::part_offset(g + 8 * h, kStreamBlockCols * p + 16 * t + 8 * x + 4 * e)) =
              make_float4(acc[n][reg], acc[n + 1][reg], acc[n + 2][reg], acc[n + 3][reg]);
        }
  }
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One Adam element group: 4 columns of a row of buffer b (the phase
// kernel's adam_item arithmetic), the gradient g the column mean times
// 1e-6(b + 1), the caller's. Returns the new weights.
__device__ __forceinline__ float4 adam4(float* w, float* m, float* v, const float (&g)[4],
                                        float bc1, float bc2) {
  const float4 wv = *reinterpret_cast<const float4*>(w), mv = *reinterpret_cast<const float4*>(m),
               vv = *reinterpret_cast<const float4*>(v);
  float wp[4] = {wv.x, wv.y, wv.z, wv.w}, mp[4] = {mv.x, mv.y, mv.z, mv.w},
        vp[4] = {vv.x, vv.y, vv.z, vv.w};
  const float bc2_sqrt = sqrtf(bc2);
  const float lr_t = kAdamLr * bc2_sqrt / bc1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mp[c] = kB1 * mp[c] + kOneMinusB1 * g[c];
    vp[c] = kB2 * vp[c] + kOneMinusB2 * g[c] * g[c];
    wp[c] -= lr_t * mp[c] / (sqrtf(vp[c]) + kAdamEps * bc2_sqrt);
  }
  *reinterpret_cast<float4*>(m) = make_float4(mp[0], mp[1], mp[2], mp[3]);
  *reinterpret_cast<float4*>(v) = make_float4(vp[0], vp[1], vp[2], vp[3]);
  const float4 nw = make_float4(wp[0], wp[1], wp[2], wp[3]);
  *reinterpret_cast<float4*>(w) = nw;
  return nw;
}

// 4 weights rounded to bf16 (nearest even) into the bf16 copy at `wb`.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* wb, const float4& v) {
  *reinterpret_cast<uint2*>(wb) = make_uint2(mma::bf16x2(v.x, v.y), mma::bf16x2(v.z, v.w));
}

// kBf16: the stream carries a bf16 copy of the weights, half the bytes:
// the cluster's 16 CTAs round the chain's weights into it once at launch
// (round to nearest even, the rounding a dot applies), and T5's Adam
// rewrites its band of it with the f32 weights; the copies wait for it as
// they wait for Adam's f32 writes (a proxy fence, a cluster barrier). The
// fp32 ring's 32 copies an SM a dot (a warp's 4 stages) took ~1 µs however
// few their bytes: the copies' count set it (the weights-alone variant).
// So a CTA takes a dot in one copy, its 256 k-rows × 128 columns (64 KB of
// bf16), into one of two ring slots (the same 128 KB as fp32's ring): the
// slot dot g read is refilled with dot g + 2's after the block barrier that
// follows the products, and in the tail the copies of the next step's
// first two dots wait for Adam's barrier. n8 tile 8p + r's column j is the
// slice's column 64p + 8j + r, so the lane (g, t) reads the bf16 of its B
// pairs of tiles 8p .. 8p + 7 as four 16-byte loads (its warp's k rows 2t,
// 2t + 1, 2t + 8, 2t + 9 of a k16 step, columns 64p + 8g ..) from the
// swizzled slot (stream_b8), the 8 lanes of a quarter-warp in distinct
// banks, and pairs them by byte permutes. h's rows are 264 floats apart, so
// a half-warp's float2 A pairs (chain_a_frag) fall in distinct banks, and
// the partial tiles' rows 132 apart with swizzled chunks (part_offset), so
// a quarter-warp's float4 stores do (stream_store_part). Each k16 step is
// one mma a tile from a zero accumulator added by an IEEE add, the 8
// partial tiles summed in K order: the fp32 form's order, which the
// permutation of columns leaves alone. Per warp and dot that is 16
// wavefronts of A pairs, 64 of B and 56 of stores (the earlier body's layout: ~780).
template <int kMode, bool kBf16>
__global__ void __launch_bounds__(kChainThreads, 1)
    chain_stream_kernel(const __grid_constant__ CUtensorMap wmap, StreamArgs A) {
  constexpr bool kT3 = kMode == kStreamT3;
  constexpr int kDepth = kT3 ? kT3Depth : kT5Bufs * kT5DotsPerBuf;
  constexpr uint32_t kPushBytes = kChainTile * 4;
  constexpr int kQuads = kChainTile / 4;
  using L = StreamLayout<kBf16>;
  constexpr int kStageFloats = kStreamChunkK * kChainCols;  // fp32: a ring stage's floats
  constexpr int kHS = L::h_stride;
  constexpr int kPT = L::part_tile;
  constexpr int kSlots = L::slots;
  // a copy landed: fp32 [warp][stage]; bf16 [0][slot]
  __shared__ __align__(8) uint64_t full[kBf16 ? 1 : kChainWarps][kBf16 ? kSlots : kStreamStages];
  __shared__ __align__(8) uint64_t bar[2];   // bar[b]: the peer's rows of h[b] arrived
  __shared__ __align__(8) uint64_t xbar[2];  // T3: trip parity's maxima arrived; T5 [0]: sums
  __shared__ float red[kChainWarps];
  extern __shared__ __align__(128) float ssmem[];
  float* ring = ssmem;  // fp32 [warp][stage][k][column]; bf16 [slot][block][k][64 columns]
  if constexpr (kBf16)
    ring += ((kStreamAlign - (smem_addr(ssmem) & (kStreamAlign - 1))) & (kStreamAlign - 1)) / 4;
  float* hb = ring + L::ring_words;           // rows kHS floats apart
  float* part = hb + 2 * kChainRows * kHS;                         // tiles at L::part_offset
  float* extra = part + kChainWarps * kPT;  // T3 maxima [2][16]; T5 sums [8][128], g [128]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = rank / kChainSlices, slice = rank % kChainSlices;
  const int peer = group * kChainSlices + (slice ^ 1);
  const int chain = static_cast<int>(blockIdx.x) / kChainCluster;
  const int row0 = group * kChainRows, col0 = slice * kChainCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // bf16: the lane's fragment row and pair
  const int kb = warp * kChainKSlice;
  float* my_ring = ring + warp * kStreamStages * kStageFloats;  // fp32
  // dot g's weight, as its first row in the stack: T3 the chain's weight g
  // mod 8; T5 buffer (g mod 25) / 5
  auto weight = [&](int g) -> int {
    const int d = g % kDepth;
    return (kT3 ? chain * kT3Depth + d : d / kT5DotsPerBuf) * kW;
  };
  const int total = A.n_steps * kDepth;

  const float* xc = A.x + (static_cast<size_t>(chain) * kRows + row0) * kW;
  for (int i = threadIdx.x; i < kChainRows * kW / 4; i += kChainThreads) {
    const int r = i / (kW / 4), c = 4 * (i % (kW / 4));
    *reinterpret_cast<float4*>(hb + r * kHS + c) =
        *reinterpret_cast<const float4*>(xc + r * kW + c);
  }
  if constexpr (kBf16) {  // the chain's weights into their bf16 copy, a 16th a CTA
    const int quads = (kT3 ? kT3Depth : kT5Bufs) * kW * kW / 4;
    const size_t base = kT3 ? static_cast<size_t>(chain) * kT3Depth * kW * kW : 0;
    for (int i = rank * kChainThreads + threadIdx.x; i < quads; i += kChainCluster * kChainThreads)
      store_bf16x4(A.wb + base + 4 * static_cast<size_t>(i),
                   reinterpret_cast<const float4*>(A.w + base)[i]);
    fence_proxy_async_global();  // for every CTA's bulk copies, after the barrier below
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < (kBf16 ? 1 : kChainWarps); ++q)
      for (int s = 0; s < (kBf16 ? kSlots : kStreamStages); ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[q][s])));
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[b])));
      mbar_expect(&bar[b], kPushBytes);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&xbar[b])));
      if (kT3) mbar_expect(&xbar[b], kChainCluster * 4);
    }
    if (!kT3) mbar_expect(&xbar[0], kChainGroups * kChainCols * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the ring's mbarriers set up before the first copies
  // dot g's weights into the ring: fp32, the warp's stage s (lane 0
  // issues); bf16, the CTA's whole chunk into slot g mod 2 (thread 0), whose
  // mbarrier completes once every other dot
  auto issue = [&](int g, int s) {
    if constexpr (kBf16)
      stream_issue<true>(&wmap, weight(g), col0, ring + (g % kSlots) * L::slot_words,
                         &full[0][g % kSlots], threadIdx.x);
    else
      stream_issue<false>(&wmap, weight(g) + kb + s * kStreamChunkK, col0,
                          my_ring + s * kStageFloats, &full[warp][s], lane);
  };
  auto issue_dot = [&](int g) {
    for (int s = 0; s < (kBf16 ? 1 : kStreamStages); ++s) issue(g, s);
  };
  auto first_copies = [&] {
    for (int g = 0; g < kSlots && g < total; ++g) issue_dot(g);
  };
  if constexpr (!kBf16) first_copies();
  // every CTA staged, its mbarriers set up (bf16: its share of the copy
  // written; release and acquire at cluster scope), before any push or copy
  cluster.sync();
  if constexpr (kBf16) {
    fence_proxy_async_global();
    first_copies();
  }

  float* my_part = part + warp * kPT + 4 * lane;
  int adams = 0;               // T5: Adam passes so far (the sums' mbarrier parity)
  bool cluster_wait = false;   // T5 interleaved: a cluster arrive not yet waited for
  for (int g = 0; g < total; ++g) {
    const int cur = g & 1, nxt = cur ^ 1;
    const int d = g % kDepth, step = g / kDepth;
    const bool whole = A.upto == kStreamUptoAll;
    const bool renorm = kT3 && whole && d == kDepth - 1;
    const bool adam = !kT3 && whole &&
                      (kMode == kStreamTail ? d == kDepth - 1
                                            : d % kT5DotsPerBuf == kT5DotsPerBuf - 1);
    // what this dot read is refilled with dot g + kSlots's weights; in the
    // tail, a dot of the next step reads a buffer this step's Adam rewrites:
    // its copies wait for the cluster barrier below
    const bool stream = A.upto != kStreamUptoCompute;
    const int next = g + kSlots;
    const bool refill = stream && next < total &&
                        !(kMode == kStreamTail && whole && next / kDepth != step);
    const uint32_t parity = (g / kSlots) & 1;  // a ring mbarrier's uses: every kSlots-th dot
    const float* h = hb + cur * kChainRows * kHS + kb;
    if constexpr (kBf16) {
      static_assert(kChainKSlice == 32 && kChainCols == 2 * kStreamBlockCols &&
                    kChainNTiles == 16, "two k16 steps a warp, 2 blocks of 8 tiles");
      if (stream || g < kSlots) mbar_wait(&full[0][g % kSlots], parity);
      if (A.upto != kStreamUptoWeights) {
        const float* sl = ring + (g % kSlots) * L::slot_words;
        float acc[kChainNTiles][4] = {};
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          uint32_t a[4];
          chain_a_frag<kHS>(a, h + 16 * st, gq, tq);
          const int k = kb + 16 * st + 2 * tq;  // the slot's rows k, k + 1, k + 8, k + 9
#pragma unroll
          for (int q = 0; q < kChainNTiles / 8; ++q) {
            const uint4 x = stream_b8(sl, q, k, gq), y = stream_b8(sl, q, k + 1, gq);
            const uint4 z = stream_b8(sl, q, k + 8, gq), u = stream_b8(sl, q, k + 9, gq);
#pragma unroll
            for (int r = 0; r < 8; ++r) {  // k's bf16 in the low half, k + 1's in the high
              const uint32_t sel = r & 1 ? 0x7632u : 0x5410u;
              float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma::mma_bf16(p, a, __byte_perm(word4(x, r / 2), word4(y, r / 2), sel),
                            __byte_perm(word4(z, r / 2), word4(u, r / 2), sel));
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[8 * q + r][e] += p[e];
            }
          }
        }
        stream_store_part(part + warp * kPT, acc, gq, tq);
      }
      __syncthreads();  // every warp has read the slot; the partial tiles stored
      if (refill) issue(next, 0);
      if (A.upto == kStreamUptoWeights) continue;
    } else {
      float4 acc[kChainRows];
#pragma unroll
      for (int r = 0; r < kChainRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
      for (int s = 0; s < kStreamStages; ++s) {
        if (stream || g < kSlots) mbar_wait(&full[warp][s], parity);
        if (A.upto != kStreamUptoWeights) {
          const float* st = my_ring + s * kStageFloats + 4 * lane;
#pragma unroll
          for (int k = 0; k < kStreamChunkK; k += 4) {
            const float4 w0 = *reinterpret_cast<const float4*>(st + k * kChainCols);
            const float4 w1 = *reinterpret_cast<const float4*>(st + (k + 1) * kChainCols);
            const float4 w2 = *reinterpret_cast<const float4*>(st + (k + 2) * kChainCols);
            const float4 w3 = *reinterpret_cast<const float4*>(st + (k + 3) * kChainCols);
#pragma unroll
            for (int r = 0; r < kChainRows; ++r) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(h + r * kHS + s * kStreamChunkK + k);
              fma4(acc[r], hv.x, w0);
              fma4(acc[r], hv.y, w1);
              fma4(acc[r], hv.z, w2);
              fma4(acc[r], hv.w, w3);
            }
          }
        }
        __syncwarp();  // every lane has read the stage: refill it with dot next's chunk
        if (refill) issue(next, s);
      }
      if (A.upto == kStreamUptoWeights) continue;
#pragma unroll
      for (int r = 0; r < kChainRows; ++r)
        *reinterpret_cast<float4*>(my_part + L::part_offset(r, 0)) = acc[r];
      __syncthreads();  // the partial tiles stored; this dot's h read by every warp
    }
    if (A.upto < kStreamUptoExchange) continue;
    float* hn = hb + nxt * kChainRows * kHS;
    float lmax = 0.0f;
    for (int i = threadIdx.x; i < kQuads; i += kChainThreads) {
      const int r = i / (kChainCols / 4), c = 4 * (i % (kChainCols / 4));
      float4 y = *reinterpret_cast<const float4*>(part + L::part_offset(r, c));
#pragma unroll
      for (int q = 1; q < kChainWarps; ++q)
        add4(y, *reinterpret_cast<const float4*>(part + q * kPT + L::part_offset(r, c)));
      if (!kT3) y = clamp4(y);
      lmax = fmaxf(lmax, fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)), fmaxf(fabsf(y.z), fabsf(y.w))));
      float* at = hn + r * kHS + col0 + c;
      *reinterpret_cast<float4*>(at) = y;
      send4(peer_addr(smem_addr(at), peer), peer_addr(smem_addr(&bar[nxt]), peer), y);
    }
    const int p = step & 1;  // T3: this trip's maxima buffer
    float* maxima = extra + p * kChainCluster;
    if (renorm) {  // the tile's max|y| to every CTA of the chain
      for (int o = 16; o > 0; o >>= 1) lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      if (lane == 0) red[warp] = lmax;
      __syncthreads();
      if (threadIdx.x < kChainCluster) {
        float mx = red[0];
        for (int q = 1; q < kChainWarps; ++q) mx = fmaxf(mx, red[q]);
        const int to = static_cast<int>(threadIdx.x);
        send1(peer_addr(smem_addr(maxima + rank), to), peer_addr(smem_addr(&xbar[p]), to), mx);
      }
    }
    mbar_wait(&bar[nxt], (g >> 1) & 1);  // bar[nxt]'s uses: every other dot
    if (renorm) mbar_wait(&xbar[p], (step >> 1) & 1);
    __syncthreads();  // the next h whole in this CTA: its own rows and the peer's
    if (threadIdx.x == 0)  // re-arm for its use two dots on
      mbar_expect(&bar[nxt], kPushBytes);
    if (renorm) {
      float mx = maxima[0];
      for (int q = 1; q < kChainCluster; ++q) mx = fmaxf(mx, maxima[q]);
      const float scale = 1.0f / fmaxf(mx, 1e-6f);
      for (int i = threadIdx.x; i < kChainRows * kW / 4; i += kChainThreads) {
        float4* q = reinterpret_cast<float4*>(hn + (i / (kW / 4)) * kHS) + i % (kW / 4);
        float4 y = *q;
        y.x *= scale; y.y *= scale; y.z *= scale; y.w *= scale;
        *q = y;
      }
      __syncthreads();  // the trip's h scaled; the maxima read
      if (threadIdx.x == 0) mbar_expect(&xbar[p], kChainCluster * 4);  // for two trips on
    }
    if (adam) {
      if (cluster_wait) {  // every CTA has read the last sums and written its last Adam
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
        fence_proxy_async_global();
        cluster_wait = false;
      }
      // this CTA's column sums of its 13 rows, its 128 columns, to slot
      // `group` of each CTA of its slice (thread: destination q, 4 columns)
      float* sums = extra;
      float* grad = extra + kChainGroups * kChainCols;
      {
        const int q = threadIdx.x >> 5, c = 4 * lane;
        const float* hc = hn + col0 + c;
        float4 s = *reinterpret_cast<const float4*>(hc);
        for (int r = 1; r < kChainRows; ++r) add4(s, *reinterpret_cast<const float4*>(hc + r * kHS));
        const int to = q * kChainSlices + slice;
        send4(peer_addr(smem_addr(sums + group * kChainCols + c), to),
              peer_addr(smem_addr(&xbar[0]), to), s);
      }
      mbar_wait(&xbar[0], adams & 1);
      ++adams;
      if (threadIdx.x < kChainCols) {
        float s = sums[threadIdx.x];
        for (int q = 1; q < kChainGroups; ++q) s += sums[q * kChainCols + threadIdx.x];
        grad[threadIdx.x] = s / static_cast<float>(kRows);
      }
      __syncthreads();  // the means in shared memory, every slot read
      if (threadIdx.x == 0) mbar_expect(&xbar[0], kChainGroups * kChainCols * 4);
      const double t = static_cast<double>(A.t0 + step + 1);
      const float bc1 = static_cast<float>(1.0 - pow(0.9, t));
      const float bc2 = static_cast<float>(1.0 - pow(0.999, t));
      const int b0 = kMode == kStreamTail ? 0 : d / kT5DotsPerBuf;
      const int b1 = kMode == kStreamTail ? kT5Bufs : b0 + 1;
      for (int b = b0; b < b1; ++b) {
        const float gs = static_cast<float>(1e-6 * (b + 1));
        float gc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gc[c] = grad[4 * lane + c] * gs;
#pragma unroll
        for (int q = 0; q < kStreamAdamRows / kChainWarps; ++q) {
          const int row = group * kStreamAdamRows + warp + kChainWarps * q;
          const size_t at = (static_cast<size_t>(b) * kW + row) * kW + col0 + 4 * lane;
          const float4 nw = adam4(A.w + at, A.m + at, A.v + at, gc, bc1, bc2);
          if constexpr (kBf16) store_bf16x4(A.wb + at, nw);
        }
      }
      fence_proxy_async_global();  // the new W (bf16: its copy), for the CTAs' bulk copies
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      if (kMode == kStreamTail) {
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
        fence_proxy_async_global();
        for (int q = g + 1; q <= g + kSlots && q < total; ++q) issue_dot(q);  // held back
      } else {
        cluster_wait = true;
      }
    }
  }
  if (cluster_wait) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const float* hf = hb + (total & 1) * kChainRows * kHS + col0;
  float* oc = A.out + (static_cast<size_t>(chain) * kRows + row0) * kW + col0;
  for (int i = threadIdx.x; i < kChainTile / 4; i += kChainThreads) {
    const int r = i / (kChainCols / 4), c = 4 * (i % (kChainCols / 4));
    *reinterpret_cast<float4*>(oc + r * kW + c) =
        *reinterpret_cast<const float4*>(hf + r * kHS + c);
  }
  cluster.sync();  // no CTA leaves while another may still address its shared memory
}

// The weights' stack (rows × kW, row-major) as a tensor map whose box is a
// ring stage. fp32: the f32 weights, 2-D, 8 rows × 128 columns, as they are.
// bf16: their bf16 copy, 3-D (64 columns, rows, kW / 64 column blocks; the
// blocks 128 bytes apart), box 64 × 256 × 2 (a dot), swizzled 128 B: two
// 32 KB blocks, line k of a block holding row k, its 16-byte chunk j at
// chunk j ^ (k mod 8).
// cuTensorMapEncodeTiled comes from the driver through the runtime (the
// build links no -lcuda).
template <bool kBf16>
cudaError_t stream_weight_map(const void* w, int rows, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  CUresult r;
  if constexpr (kBf16) {
    const cuuint64_t dims[3] = {kStreamBlockCols, static_cast<cuuint64_t>(rows),
                                kW / kStreamBlockCols};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kW) * 2, kStreamBlockCols * 2};
    const cuuint32_t box[3] = {kStreamBlockCols, kW, kChainCols / kStreamBlockCols};
    const cuuint32_t steps[3] = {1, 1, 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
               steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kW), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kW) * 4};  // bytes a row
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChainCols),
                               static_cast<cuuint32_t>(kStreamChunkK)};
    const cuuint32_t steps[2] = {1, 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w), dims, strides, box,
               steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kMode, bool kBf16>
cudaError_t launch_chain_stream(const StreamArgs& A, int n_chains, cudaStream_t stream) {
  CUtensorMap wmap;
  cudaError_t e = stream_weight_map<kBf16>(
      kBf16 ? static_cast<const void*>(A.wb) : A.w,
      (kMode == kStreamT3 ? n_chains * kT3Depth : kT5Bufs) * kW, &wmap);
  if (e != cudaSuccess) return e;
  const int smem = stream_smem_bytes<kBf16>(kMode);
  e = cudaFuncSetAttribute(chain_stream_kernel<kMode, kBf16>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(chain_stream_kernel<kMode, kBf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(n_chains * kChainCluster);
  cfg.blockDim = dim3(kChainThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kChainCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chain_stream_kernel<kMode, kBf16>, wmap, A);
}

template <bool kBf16>
cudaError_t launch_chain_stream_mode(const StreamArgs& A, int n_chains, int mode,
                                     cudaStream_t stream) {
  return mode == kStreamT3     ? launch_chain_stream<kStreamT3, kBf16>(A, n_chains, stream)
         : mode == kStreamTail ? launch_chain_stream<kStreamTail, kBf16>(A, n_chains, stream)
                               : launch_chain_stream<kStreamInterleaved, kBf16>(A, n_chains, stream);
}

template <int kMode>
cudaError_t launch_dot(const DotArgs& A, const DotPlan& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(p.grid_x, p.grid_y);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dot_kernel<kMode>, A);
}

// chain_phase_kernel's dynamic shared memory: the fp32 units' stages
constexpr int phase_smem(bool bf16) { return bf16 ? 0 : kPhaseSmemF; }

// The cooperative grid of chain_phase_kernel: one block an SM, if one fits.
template <bool kBf16>
int phase_grid(int* blocks) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && phase_smem(kBf16) > 0)
    err = cudaFuncSetAttribute(chain_phase_kernel<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, phase_smem(kBf16));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, chain_phase_kernel<kBf16>, kThreads,
                                                        phase_smem(kBf16));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms;
  return 0;
}

}  // namespace

extern "C" {

const char* probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// T4, T3, T5: see chain_phase_kernel; bf16_dots 1 takes its bf16-dot
// instantiation; `upto` < 2 runs a variant of the time split (the result is
// then not the chain's). The result is h[(n_steps·depth) % 2].
int probes_chain_phase(float* h, float* w, float* m, float* v, unsigned int* maxbits,
                       int n_chains, int n_steps, int depth, int dots_per_weight, int epilogue,
                       int adam, int t0, int bf16_dots, int upto, void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || n_steps < 1 || depth < 1 ||
      upto < kPhaseUptoBarriers || upto > kPhaseUptoAll ||
      dots_per_weight < 1 || depth % dots_per_weight != 0 ||
      (epilogue != kEpClamp && epilogue != kEpRenorm) ||
      (epilogue == kEpRenorm && maxbits == nullptr) || adam < kAdamNone ||
      adam > kAdamInterleaved ||
      (adam != kAdamNone && (n_chains != 1 || m == nullptr || v == nullptr)) ||
      (bf16_dots != 0 && bf16_dots != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int err = bf16_dots ? phase_grid<true>(&blocks) : phase_grid<false>(&blocks);
  if (err != 0) return err;
  ChainArgs A{h, w, m, v, maxbits, n_chains, n_steps, depth, dots_per_weight, epilogue,
              adam, t0, upto};
  void* params[] = {&A};
  void* kernel = bf16_dots ? reinterpret_cast<void*>(chain_phase_kernel<true>)
                           : reinterpret_cast<void*>(chain_phase_kernel<false>);
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), params,
                                                    phase_smem(bf16_dots != 0),
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// T4's cluster form: x (n_chains, kRows, kW), w (n_chains, kW, kW) → out;
// `upto` < 3 stops each dot early (the time split); bf16_dots 1 takes the
// bf16-dot instantiation. The plan is the library's constants.
int probes_chain_cluster(const float* x, const float* w, float* out, int n_chains,
                         int n_steps, int depth, int upto, int bf16_dots, void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || n_steps < 1 || depth < 1 ||
      upto < kChainUptoStage || upto > kChainUptoAll || (bf16_dots != 0 && bf16_dots != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChainClusterArgs A{x, w, out, n_steps, depth, upto};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_dots ? launch_chain_cluster<true>(A, n_chains, st)
                                  : launch_chain_cluster<false>(A, n_chains, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// T3's and T5's stream form: see chain_stream_kernel. `mode` 0 is T3 (x, w
// (n_chains, 8·kW, kW), m and v null), 1 and 2 are T5 with Adam in a tail
// or interleaved (one chain, w, m and v (5, kW, kW), updated in place, t0
// Adam's step before the launch); the result goes to out (n_chains, kRows,
// kW). `upto` < 4 stops each dot early (the time split); bf16_dots 1 takes
// the bf16-dot instantiation, which writes w's bf16 copy into wb (w's
// shape, 2 bytes an element; null in fp32).
int probes_chain_stream(const float* x, float* w, void* wb, float* m, float* v, float* out,
                        int n_chains, int n_steps, int mode, int t0, int upto, int bf16_dots,
                        void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || n_steps < 1 || mode < kStreamT3 ||
      mode > kStreamInterleaved || upto < kStreamUptoWeights || upto > kStreamUptoAll ||
      (mode != kStreamT3 && (n_chains != 1 || m == nullptr || v == nullptr)) ||
      (bf16_dots != 0 && bf16_dots != 1) || (bf16_dots == 1 && wb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamArgs A{x, w, static_cast<__nv_bfloat16*>(wb), m, v, out, n_steps, t0, upto};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_dots ? launch_chain_stream_mode<true>(A, n_chains, mode, st)
                                  : launch_chain_stream_mode<false>(A, n_chains, mode, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// T2's plan for (M, K, N, mode) into plan[9]: tile_m, tile_n, chunk_k,
// split, cluster, grid_x, grid_y, smem, threads (kernels/probes.py:dot_plan).
int probes_dot_plan(int M, int K, int N, int mode, int* plan) {
  DotPlan p;
  if (!dot_plan(M, K, N, mode, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const int v[9] = {p.tile_m, p.tile_n, p.chunk_k, p.split, p.cluster, p.grid_x, p.grid_y,
                    p.smem, p.threads};
  for (int i = 0; i < 9; ++i) plan[i] = v[i];
  return 0;
}

// T2: out (M × N) = x (M × K) · w (K × N) in `mode` (0 fp32, 1 tf32, 2 bf16)
// on the caller's plan (split, grid_x, grid_y, smem), which must be the
// library's own; `upto` < 3 stops the launch early (the time split).
int probes_dot(const float* x, const float* w, float* out, int M, int K, int N, int mode,
               int split, int grid_x, int grid_y, int smem, int upto, void* stream) {
  DotPlan p;
  if (!dot_plan(M, K, N, mode, &p) || p.split != split || p.grid_x != grid_x ||
      p.grid_y != grid_y || p.smem != smem || upto < kUptoLaunch || upto > kUptoAll)
    return static_cast<int>(cudaErrorInvalidValue);
  const DotArgs A{x, w, out, M, K, N, split, upto};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = mode == kDotFp32   ? launch_dot<kDotFp32>(A, p, st)
                        : mode == kDotTf32 ? launch_dot<kDotTf32>(A, p, st)
                                           : launch_dot<kDotBf16>(A, p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
