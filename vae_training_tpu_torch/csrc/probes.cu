// The probes of the MLP kernel's design questions, for Hopper (sm_90a):
// T4, T3 and T5 (chains of dependent 104×256×256 fp32 dots) and T2 (one
// dot in fp32, TF32 and bf16 tensor-core modes).
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
// Mosaic's schedule. That design is the MLP kernel's (csrc/mlp_vae.cu): one
// cooperative launch of one 512-thread block an SM; each dependent layer is
// one phase, a grid-stride loop in which one thread owns one output and runs
// a 256-term fmaf chain fed from L2; grid.sync() between phases; Adam a
// grid-wide phase after the backward. chain_phase_kernel is that design on
// the probes' shapes: "chains interleaved op by op" on the TPU becomes "all
// chains' dot d in one phase", the question K6b's rows ask. What bounds it:
// latency, not the fp32 rate (a 104×256×256 dot is 13.6 MFLOP, 203 ns at
// 67 TFLOP/s): each phase waits for its slowest thread's 256 dependent FMAs,
// each fed by an L2 load, then for a grid barrier. One chain fills 26,624 of
// the grid's 67,584 threads; four chains need two items a thread.
//
// chain_cluster_kernel is T4 on the design R1 considers in its place: one
// 4-CTA thread-block cluster a chain, each CTA holding a 64-column slice of W
// (64 KB) and the whole h (104 KB) in shared memory, the new h exchanged
// through distributed shared memory with two cluster barriers a dot and no
// grid barrier. Its bound is shared-memory bandwidth: 13 outputs a thread,
// h read as float4 (4 k at once) against one W value a k.
//
// dot_kernel is T2. Hopper has no implicit reduced-precision default, so the
// modes are: fp32, one thread per output and a fmaf chain (the port's
// kernels today; the analog of Precision.HIGHEST); tf32, mma.sync m16n8k8
// with operands rounded by cvt.rna.tf32.f32 (nearest, ties away: explicit,
// so the plain version knows which rounding happened); bf16, mma.sync
// m16n8k16 with operands rounded by __float2bfloat16_rn (the tool's "cast").
// Fragments are written by hand; no library GEMM.
//
// Pointers to buffers a launch writes are never const __restrict__ (the
// non-coherent read path can return stale data across grid.sync()).
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
  int n_chains, n_steps, depth, dots_per_weight, epilogue, adam, t0;
};

// Output i (chain c, row r, column j) of dot d: a 256-term fmaf chain.
__device__ __forceinline__ float dot_item(const ChainArgs& A, const float* in, int d, int i,
                                          int& c) {
  constexpr int per_chain = kRows * kW;
  c = i / per_chain;
  const int rem = i - c * per_chain;
  const int r = rem / kW;
  const int j = rem - r * kW;
  const int n_w = A.depth / A.dots_per_weight;
  const float* row = in + c * per_chain + r * kW;
  const float* W = A.w + (static_cast<size_t>(c) * n_w + d / A.dots_per_weight) * kW * kW;
  float acc = 0.0f;
  for (int k = 0; k < kW; ++k) acc = fmaf(row[k], W[k * kW + j], acc);
  return A.epilogue == kEpClamp ? fminf(acc, kClamp) : acc;
}

// Adam on element e of chain 0's weight buffer b. The gradient is the
// column mean of h broadcast down the rows, ·1e-6(b + 1) (the tool's
// grad_for); the bias corrections 1 − βᵗ are the caller's, from double.
__device__ __forceinline__ void adam_item(const ChainArgs& A, const float* h, int b, int e,
                                          float bc1, float bc2) {
  const int j = e % kW;
  float s = 0.0f;
  for (int r = 0; r < kRows; ++r) s += h[r * kW + j];
  const float g = (s / static_cast<float>(kRows)) * static_cast<float>(1e-6 * (b + 1));
  const size_t at = static_cast<size_t>(b) * kW * kW + e;
  const float m = kB1 * A.m[at] + kOneMinusB1 * g;
  const float v = kB2 * A.v[at] + kOneMinusB2 * g * g;
  const float bc2_sqrt = sqrtf(bc2);
  const float lr_t = kAdamLr * bc2_sqrt / bc1;
  A.m[at] = m;
  A.v[at] = v;
  A.w[at] -= lr_t * m / (sqrtf(v) + kAdamEps * bc2_sqrt);
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
// needs no barrier of its own), the last buffer in a phase of its own.
__global__ void __launch_bounds__(kThreads, 1) chain_phase_kernel(ChainArgs A) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsz = gridDim.x * blockDim.x;
  const int n_h = A.n_chains * kRows * kW;
  const int n_buf = A.depth / A.dots_per_weight;
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
      const int n_items = n_h + (adam_here ? kW * kW : 0);
      float lmax[kMaxChains] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = gtid; i < n_items; i += gsz) {
        if (i < n_h) {
          int c;
          const float y = dot_item(A, in, d, i, c);
          out[i] = y;
#pragma unroll
          for (int q = 0; q < kMaxChains; ++q)
            if (q == c) lmax[q] = fmaxf(lmax[q], fabsf(y));
        } else {
          adam_item(A, in, d / A.dots_per_weight - 1, i - n_h, bc1, bc2);
        }
      }
      if (A.epilogue == kEpRenorm && d == A.depth - 1)
        block_max_to_global(lmax, A.maxbits + (it & 1) * A.n_chains, A.n_chains);
      grid.sync();
      cur ^= 1;
    }
    float* h = A.h + cur * n_h;
    if (A.epilogue == kEpRenorm) {
      const unsigned int* words = A.maxbits + (it & 1) * A.n_chains;
      for (int i = gtid; i < n_h; i += gsz) {
        const float mx = __uint_as_float(__ldcg(words + i / (kRows * kW)));  // L2: atomics'
        h[i] = h[i] * (1.0f / fmaxf(mx, 1e-6f));
      }
      // the next trip's words; this trip's are read above, after a barrier
      if (gtid < A.n_chains) A.maxbits[((it + 1) & 1) * A.n_chains + gtid] = 0u;
      grid.sync();
    }
    if (A.adam != kAdamNone) {
      const int first = A.adam == kAdamTail ? 0 : n_buf - 1;
      const int n_items = (n_buf - first) * kW * kW;
      for (int i = gtid; i < n_items; i += gsz)
        adam_item(A, h, first + i / (kW * kW), i % (kW * kW), bc1, bc2);
      grid.sync();
    }
  }
}

constexpr int kCluster = 4;                             // CTAs a chain
constexpr int kSliceCols = kW / kCluster;               // 64 columns of W a CTA
constexpr int kRowGroups = kThreads / kSliceCols;       // 8
constexpr int kRowsPerThread = kRows / kRowGroups;      // 13 outputs a thread
constexpr size_t kClusterSmem = (static_cast<size_t>(kW) * kSliceCols + kRows * kW) * sizeof(float);
static_assert(kRows % kRowGroups == 0, "rows split evenly over the row groups");
static_assert(kClusterSmem <= 232448, "a CTA's slice of W and h fit 227 KB");

// T4's second form: one 4-CTA cluster a chain, W's column slice and the
// whole h in each CTA's shared memory. Per dot: each thread computes its 13
// outputs (rows rg, rg + 8, ...; column j of the CTA's slice) into
// registers, a cluster barrier (every CTA has read h), the slice written
// into every CTA's h through distributed shared memory, a cluster barrier.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    chain_cluster_kernel(const float* __restrict__ x, const float* __restrict__ w, float* out,
                         int n_steps, int depth) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                    // kW × kSliceCols
  float* h = smem + kW * kSliceCols;   // kRows × kW
  const int q = static_cast<int>(cluster.block_rank());
  const int chain = blockIdx.x / kCluster;
  const float* xc = x + static_cast<size_t>(chain) * kRows * kW;
  const float* wc = w + static_cast<size_t>(chain) * kW * kW;
  for (int i = threadIdx.x; i < kW * kSliceCols; i += kThreads) {
    const int k = i / kSliceCols;
    ws[i] = wc[k * kW + q * kSliceCols + (i - k * kSliceCols)];
  }
  for (int i = threadIdx.x; i < kRows * kW; i += kThreads) h[i] = xc[i];
  __syncthreads();
  const int j = threadIdx.x % kSliceCols;
  const int rg = threadIdx.x / kSliceCols;
  float* peers[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) peers[p] = cluster.map_shared_rank(h, p);
  const int total = n_steps * depth;
  for (int dot = 0; dot < total; ++dot) {
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;
    for (int k = 0; k < kW; k += 4) {
      const float w0 = ws[(k + 0) * kSliceCols + j];
      const float w1 = ws[(k + 1) * kSliceCols + j];
      const float w2 = ws[(k + 2) * kSliceCols + j];
      const float w3 = ws[(k + 3) * kSliceCols + j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(h + (rg + kRowGroups * i) * kW + k);
        acc[i] = fmaf(hv.x, w0, acc[i]);
        acc[i] = fmaf(hv.y, w1, acc[i]);
        acc[i] = fmaf(hv.z, w2, acc[i]);
        acc[i] = fmaf(hv.w, w3, acc[i]);
      }
    }
    cluster.sync();  // every CTA of the chain has read this dot's h
#pragma unroll
    for (int p = 0; p < kCluster; ++p) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        peers[p][(rg + kRowGroups * i) * kW + q * kSliceCols + j] = fminf(acc[i], kClamp);
    }
    cluster.sync();  // the next h is whole in every CTA
  }
  float* oc = out + static_cast<size_t>(chain) * kRows * kW;
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int at = (rg + kRowGroups * i) * kW + q * kSliceCols + j;
    oc[at] = h[at];
  }
}

constexpr int kDotFp32 = 0;
constexpr int kDotTf32 = 1;
constexpr int kDotBf16 = 2;

__device__ __forceinline__ uint32_t tf32_rna(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// T2: out = x·w, x (M × K), w (K × N), row-major. fp32: one thread an
// output. tf32 and bf16: one warp a 16 × 8 tile of out, the fragments of
// mma.sync's row.col layouts loaded by hand (groupID g = lane / 4, t =
// lane % 4): A's (row g or g + 8, col t or t + 4) for m16n8k8, (g or g + 8,
// 2t, 2t + 1, + 8) for m16n8k16; B's (k t or t + 4, col g), (k 2t, 2t + 1,
// + 8, col g); the sums' (row g or g + 8, cols 2t and 2t + 1).
__global__ void dot_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           float* out, int M, int K, int N, int mode) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == kDotFp32) {
    if (gtid >= M * N) return;
    const int r = gtid / N;
    const int c = gtid - r * N;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(x[r * K + k], w[k * N + c], acc);
    out[gtid] = acc;
    return;
  }
  const int warp = gtid >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles_n = N / 8;
  const int tm = warp / tiles_n;
  const int tn = warp - tm * tiles_n;
  if (tm * 16 >= M) return;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = tm * 16 + g;
  const int r1 = r0 + 8;
  const int cb = tn * 8 + g;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
  if (mode == kDotTf32) {
    for (int k = 0; k < K; k += 8) {
      const uint32_t a0 = tf32_rna(x[r0 * K + k + t]);
      const uint32_t a1 = tf32_rna(x[r1 * K + k + t]);
      const uint32_t a2 = tf32_rna(x[r0 * K + k + t + 4]);
      const uint32_t a3 = tf32_rna(x[r1 * K + k + t + 4]);
      const uint32_t b0 = tf32_rna(w[(k + t) * N + cb]);
      const uint32_t b1 = tf32_rna(w[(k + t + 4) * N + cb]);
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  } else {
    for (int k = 0; k < K; k += 16) {
      const int c0 = k + 2 * t;
      const uint32_t a0 = bf16x2_rn(x[r0 * K + c0], x[r0 * K + c0 + 1]);
      const uint32_t a1 = bf16x2_rn(x[r1 * K + c0], x[r1 * K + c0 + 1]);
      const uint32_t a2 = bf16x2_rn(x[r0 * K + c0 + 8], x[r0 * K + c0 + 9]);
      const uint32_t a3 = bf16x2_rn(x[r1 * K + c0 + 8], x[r1 * K + c0 + 9]);
      const uint32_t b0 = bf16x2_rn(w[c0 * N + cb], w[(c0 + 1) * N + cb]);
      const uint32_t b1 = bf16x2_rn(w[(c0 + 8) * N + cb], w[(c0 + 9) * N + cb]);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  const int cc = tn * 8 + 2 * t;
  out[r0 * N + cc] = d0;
  out[r0 * N + cc + 1] = d1;
  out[r1 * N + cc] = d2;
  out[r1 * N + cc + 1] = d3;
}

// The cooperative grid of chain_phase_kernel: one block an SM, if one fits.
int phase_grid(int* blocks) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, chain_phase_kernel, kThreads, 0);
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

// T4, T3, T5: see chain_phase_kernel. The result is h[(n_steps·depth) % 2].
int probes_chain_phase(float* h, float* w, float* m, float* v, unsigned int* maxbits,
                       int n_chains, int n_steps, int depth, int dots_per_weight,
                       int epilogue, int adam, int t0, void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || n_steps < 1 || depth < 1 ||
      dots_per_weight < 1 || depth % dots_per_weight != 0 ||
      (epilogue != kEpClamp && epilogue != kEpRenorm) ||
      (epilogue == kEpRenorm && maxbits == nullptr) || adam < kAdamNone ||
      adam > kAdamInterleaved ||
      (adam != kAdamNone && (n_chains != 1 || m == nullptr || v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int err = phase_grid(&blocks);
  if (err != 0) return err;
  ChainArgs A{h, w, m, v, maxbits, n_chains, n_steps, depth, dots_per_weight, epilogue,
              adam, t0};
  void* params[] = {&A};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chain_phase_kernel), dim3(blocks), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// T4's cluster form: x (n_chains, kRows, kW), w (n_chains, kW, kW) → out.
int probes_chain_cluster(const float* x, const float* w, float* out, int n_chains,
                         int n_steps, int depth, void* stream) {
  if (n_chains < 1 || n_steps < 1 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(chain_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kClusterSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chain_cluster_kernel<<<n_chains * kCluster, kThreads, kClusterSmem,
                         static_cast<cudaStream_t>(stream)>>>(x, w, out, n_steps, depth);
  return static_cast<int>(cudaGetLastError());
}

// T2: out (M × N) = x (M × K) · w (K × N) in `mode` (0 fp32, 1 tf32, 2 bf16).
int probes_dot(const float* x, const float* w, float* out, int M, int K, int N, int mode,
               void* stream) {
  if (mode < kDotFp32 || mode > kDotBf16 || M < 1 || N < 1 || K < 1 || M % 16 != 0 ||
      N % 8 != 0 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int work = mode == kDotFp32 ? M * N : (M / 16) * (N / 8) * 32;
  dot_kernel<<<(work + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, M, K, N, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
