// Fused multi-step linear-VAE training kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel vae_training_tpu/kernels/linear_vae.py:_make_kernel
// (launched by run_fused_chunk, linear_vae.py:678) in its two branches: K1,
// the linear_gaussian dataset (dataset_kind="linear", dual=False), and K2,
// the sigmoid dataset with the dual decoder (dataset_kind="sigmoid",
// dual=True; the kDual instantiation), each in solo mode and in grid mode
// (K6a, grid_n > 0: many sweep rows in one launch). One launch runs K
// training steps; per step:
//
//   Philox4x32-10 -> Box-Muller normals -> x = pad(n·Aᵀ) (+ obs noise)
//                                          [K2: x = [n, σ(n·a), 0]]
//   -> mu = x·We + be -> s = mu + e^{ep/2}·z1 -> y = s·Wd + bd + z2·e^{ε/2}
//                                          [K2: y += σ(s·Ws + bs)]
//   -> closed-form ELBO into losses[step] -> analytic gradients
//   -> bias-corrected Adam (optax.adam's formula)
//
// bf16 moments (K4, the bf16 branch of the TPU kernels' _adam,
// linear_vae.py:188-218; --adam_dtype bf16): with the launch-wide flag
// moments_bf16, Adam rounds each weight-matrix slot's new m and v (We, Wd
// and, dual, Ws) to bfloat16, round to nearest even, every step, and the
// update reads the rounded values; vector slots keep f32 moments. The state
// stays float32 in shared and device memory, holding values bfloat16
// represents exactly, so the wrapper's buffers and the Row table are the
// f32 mode's.
//
// K2's σ applies to every one of the D output columns, padding columns
// included, as the flax model applies it (networks.py:78-79); the TPU
// kernel's mask removes only its lanes beyond D.
//
// What bounds it on this card: latency and the shared-memory pipe, not
// FLOPs or bytes. The linear sweep's row 1 (batch 100, D=12, L=20) is 248
// kFLOP a step, and step i+1 needs step i's parameters, so the chunk is
// serial and one SM runs a row. A row's whole state (params, Adam m and v)
// and every per-step activation stay in one CTA's shared memory for the
// whole chunk: device memory is touched once a chunk. The design cuts the
// step's dependent chains and barriers:
//
// * One CTA of 1024 threads, two block barriers a step. Warps 0-24 are the
//   row warps (phase A: the per-row pass; phase B: the per-parameter pass),
//   warps 25-31 the noise warps (both phases), warp 31 also the scalars.
// * Phase A, the per-row pass: a group of 8 lanes owns a batch row b (100
//   rows in one round) and computes, with no block barrier, mu, s, y
//   (and σ(u)), r, g_y (g_u), g_s and g_mu for its row, its lanes splitting
//   L and D (outputs sub, sub+8, sub+16), __syncwarp between the stages,
//   and the row's partial sums Σmu², Σr², Σr·z2 (a fixed xor tree over the
//   8 lanes). Each output is a fmaf chain along its contraction in
//   ascending order, read as float4 from the row and from a padded copy of
//   the weight (WeT, WdT, Wd; dual WsT, Ws) whose last term is the bias, so
//   mu = x·We + be sums as the plain version does.
// * Phase B, the per-parameter pass: every gradient is a sum over the batch
//   G[r,c] = Σ_b U[b,r]·V[b,c] (g_We = xᵀ·g_mu, g_Wd = sᵀ·g_y, g_Ws =
//   sᵀ·g_u, each with the bias as one more row: x and s carry a column of
//   ones, and each bias follows its matrix in the flat layout). A team of 8
//   lanes takes a 4×4 tile of G, each lane the b ≡ lane (mod 8) slice as
//   fmaf chains in ascending b, then a fixed xor tree; each lane applies
//   Adam to two of the tile's outputs at once and writes them into the
//   padded copies. g_ep's column sums run in the same pool (tiles of 4
//   columns), and the lane that updates ep_l writes e^{ep_l/2} for the next
//   step. Matrix and bias rows differ only in one compare for K4's
//   rounding.
// * The noise is off the critical path: z1, z2 and x (the manifold draw and
//   the observation noise) do not depend on the parameters, so the noise
//   warps draw step it+1's into the other half of a double buffer while the
//   row warps run step it (the manifold, observation-noise and z1 draws in
//   phase A; x = pad(n·Aᵀ) and the z2 draws in phase B). The external-noise
//   hook fills the same buffers.
// * The KL constant (phase A), the loss, g_ε and Adam on ε (phase B) run on
//   warp 31 before its share of the draws, each sum a fixed lane order and
//   a xor tree. The bias corrections 1 − βᵗ come from a table of 256 steps
//   that all threads refill (double pow, rounded once) with one more
//   barrier every 256 steps. The launch header (the row, its plan and dims)
//   lives in shared memory, so no phase keeps it in registers.
//
// Measured on the card (chip_smoke.py phase 32 and a traced build), a step
// at linear row 1 is ~16k cycles: the per-row pass ~8k and the
// per-parameter pass ~5.5k, each bound by dependent shared-memory loads (a
// warp's float4 load is four wavefronts, and 25 warps share the pipe)
// rather than by FMAs; the noise warps' Philox and Box-Muller draws (precise
// logf/sincosf, ~2k cycles a call under load) take about as long as either
// phase, so more of them would not hide; the two barriers ~1k.
//
// The description above is the fp32 instantiation's (kBf16 = false).
//
// bf16 dots (--precision bf16 on the card; the TPU kernel's default dot
// mode, prec = None at linear_vae.py:324-345): the kBf16 instantiation runs
// every product of the step on the tensor cores, mma.sync m16n8k16 with
// bf16 operands and f32 sums (a product of two bfloat16 values is exact in
// f32, so only the order of the f32 sums differs from the reference); each
// k16 step's mma starts from zero and its partial is added to the output's
// f32 sum by an IEEE add (the tensor cores' own accumulation truncates). Its
// own plan (plan_bf16): the weights' copies hold R(W) as bfloat16 with no
// bias, the batch is padded to 16 rows and every operand row to its k16
// steps with zeros. Per step, same two block barriers:
//
// * Phase A, the per-row pass (row_pass_tc): three stages a named barrier
//   apart (mu and s; y, u, r, g_y, g_u; g_s and g_mu), each a set of 16 × 8
//   output tiles (16 batch rows × 8 columns) dealt round-robin over the row
//   warps (Roles::rw: one a tile of the largest stage, at most 24; linear
//   row 1: 21). A tile's A fragments come from shared memory (x, g_y, g_u
//   f32, rounded as packed; R(s), written by stage 1), its B fragments from
//   the copies; the elementwise work runs on the sum's fragment. The biases
//   are added to the f32 sums last and never enter a product; the row
//   partials (Σmu², Σr², Σr·z2) go out a tile at a time and the scalar warp
//   sums a row's tiles in order.
// * Phase B: the gradient products G = Uᵀ·V over the batch (K = 112 at B
//   100) as (m16, n8) tiles, one a tile warp (Roles::tw, at most 22), the
//   lane that holds an output applying Adam (K4's rounding) and writing
//   R(W) into the copies (param_pass_tc); the sums the reference keeps off
//   the matrix unit, over unrounded f32 values, in an f32 pool of teams of 8
//   lanes (pool_pass): the bias rows g_b = Σ_b V in the fp32 teams' order
//   and g_ep's column sums.
// * The warps without rows or tiles in a phase draw the next step's noise
//   (the double buffer and the external-noise hook as in fp32); z2's draws
//   go to phase A's stage where that takes fewer rounds of Philox calls a
//   lane (Roles::z2a). The manifold draw keeps its FMA chain, rounding n
//   and A (dot_op), off the critical path.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 32
// gives the split): not the products. A tile's elementwise work is a chain
// of shared-memory loads, shuffles and stores, and the tiles of a stage hit
// the shared-memory pipe together. A first body that chained each
// product's output fragments into the next product's A fragments in
// registers, one warp a block of 16 rows (7 warps at B 100), ran those
// chains serially and was slower than the fp32 body at linear row 1; dealt
// over the row warps, a stage takes about one tile's chain.
//
// Every sum has an order fixed by the algorithm (a row's chain and tree, a
// team's b slices and tree, the scalar warp's tree; in the bf16-dot mode a
// k16 step's mma and the ascending IEEE adds of the steps, a tile's quad
// tree and a row's tiles in order), independent of the launch, of the
// number of rows and of which lane or warp runs it; no atomics. So runs
// repeat bitwise, a grid row equals its solo launch, and a resumed run
// equals an uninterrupted one. The fp32 mode's products are FMA chains.
//
// Grid mode (K6a; the TPU kernel's grid_n > 0, linear_vae.py:537-696): one
// CTA per sweep row, gridDim.x = rows. Each row's pointers, dims (D, L,
// intrinsic, manifold), counters and Philox keys come from a device table
// of Row records (the TPU kernel's scalar-prefetch rows [seed, t0, dd, ld,
// id]), so rows of different dims share a launch (the mixed sweep); batch,
// step count, ε, -tdv, lr and the decoder head are uniform. Each block
// carves its shared memory from its own row's dims, and the launch asks for
// the largest row's. A solo launch is the same kernel with one row passed
// by value: solo and grid run one compiled body, so a grid row equals the
// solo launch from the same state and seeds bitwise.
//
// The TPU kernel's 128-lane padding, row/column masks, live-row slicing and
// packed lane-window noise are layout devices of the TPU and are not carried
// over: everything here works in true dimensions.
//
// The random numbers are the counters of vae_training_tpu_torch/ops/rng.py
// (philox.cuh): key = the 64-bit run seed, counter = (absolute step, row,
// draw, stream). This kernel reproduces that module's words bitwise
// (precise logf/sincosf; build without --use_fast_math).
//
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "philox.cuh"

// One sweep row of a launch. Plain data in natural alignment:
// kernels/linear_vae.py's ctypes Row mirrors it field by field, and
// linear_vae_row_bytes lets the wrapper hold the two to one size.
struct Row {
  float* p;             // params (P), updated in place
  float* m;             // Adam m (P)
  float* v;             // Adam v (P)
  float* losses;        // (n_steps) per-step losses
  const float* a;       // A (dd × id), or the sigmoid's column a (dd)
  const float* ext_x;   // external noise (n_steps × B × D), or null
  const float* ext_z1;  // (n_steps × B × L)
  const float* ext_z2;  // (n_steps × B × D)
  int D, L, id, dd;     // ambient, latent, intrinsic and manifold dims
  unsigned int step0;   // absolute step of the first step (Philox counter)
  int t0;               // Adam count before it
  unsigned int dk0, dk1, mk0, mk1;  // data and model key words
  float obs_scale;      // observation-noise sd (0: none)
};

namespace {

using namespace mma;
using namespace philox;

constexpr int kThreads = 1024;
constexpr int kRowWarps = 25;    // the per-row and per-parameter passes; the rest draw noise
constexpr int kGroup = 8;        // lanes a batch row
constexpr int kRowGroups = kRowWarps * 32 / kGroup;  // 100: rows a round
constexpr int kOut = 3;          // outputs a lane a block of kGroup·kOut
constexpr int kTeam = 8;         // lanes a gradient tile
constexpr int kTeams = kRowWarps * 32 / kTeam;
constexpr int kScalarWarp = kThreads / 32 - 1;  // the KL constant, the loss, ε
// bf16 dots (kBf16): the most warps a phase gives the tensor-core passes;
// the warps left draw the next step's noise
constexpr int kMaxRowWarps = 24;   // phase A: a warp a 16 × 8 output tile
constexpr int kMaxTileWarps = 22;  // phase B: a warp a (m16, n8) gradient tile
constexpr int kMaxPoolWarps = 7;   // phase B: the f32 pool, 4 teams of 8 lanes a warp
constexpr int kSamplerThreads = 256;        // philox_draw_kernel's blocks
constexpr int kHeader = 128;                // floats of the launch header (Hdr)
constexpr int kBcSteps = 256;               // steps of the bias-correction table
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)

// Timing variants (`skip`, 0 in training): leave a part of every step out.
constexpr int kSkipNoise = 1;   // the noise warps draw nothing
constexpr int kSkipRows = 2;    // no per-row pass
constexpr int kSkipParams = 4;  // no per-parameter pass (gradients and Adam)
constexpr int kSkipWork = 8;    // nothing but the two barriers a step
constexpr int kSkipAll = kSkipNoise | kSkipRows | kSkipParams | kSkipWork;

// Flat parameter layout (shared with kernels/linear_vae.py:param_layout):
// [We (D×L) | be (L) | Wd (L×D) | bd (D) | epsilon_p (L) | epsilon (1)]
// and, with the dual decoder only, after them [Ws (L×D) | bs (D)].
// Each bias follows its matrix, so [We; be] is one (D+1)×L matrix, [Wd; bd]
// and [Ws; bs] (L+1)×D ones.
__host__ __device__ inline int n_params(int D, int L, bool dual) {
  return 2 * D * L + 2 * L + D + 1 + (dual ? L * D + D : 0);
}

__host__ __device__ inline int quad(int n) { return (n + 3) & ~3; }
// A row stride of at least n floats, a multiple of 4 and an odd multiple of
// 4: eight rows read as float4 at the same column hit eight distinct bank
// quads, and a row starts 16-byte aligned.
__host__ __device__ inline int stride(int n) { return quad(n) + ((quad(n) & 4) ? 0 : 4); }

// Shared memory of one row, in floats, every buffer at a multiple of 4
// (16 B). The per-row pass reads weights along its contractions as float4,
// so each matrix it reads is also kept padded and, where needed,
// transposed, with its bias as the last term of the contraction: WeT (L ×
// ldx: row l = [We[:,l], be[l], 0…]), Wd (L × ldg), WdT (D × lds: row j =
// [Wd[:,j], bd[j], 0…]) and, dual, Ws and WsT. x and s carry a column of
// ones (x[D], s[L]) that meets the bias; padding is zero.
struct Smem {
  int p, m, v, a, sd, sc, bc;     // params, moments, A, e^{ep/2}, scalars, 1 − βᵗ
  int weT, wd, wdT, ws, wsT;      // the padded copies of the weights
  int x0, x1, z10, z11, z20, z21;  // the double-buffered noise
  int nz;                         // intrinsic normals of the step being drawn
  int s, gy, gu, gmu, q, part;    // s, g_y, g_u, mu→g_mu, g_s·z1, partials
  int ldx, lds, ldg, ldm;         // strides: x (D+1), s (L+1), D-wide, L-wide
  int total;
  // bf16 dots only (plan_bf16; zero in the fp32 plan): the batch padded to
  // the tiles' 16 rows; g_s·z1's f32 stride; strides in bfloat16 values:
  // the weights' copies along j (WeT, Wd, Ws) and along l (WdT, WsT), and
  // s (bfloat16 only)
  int bp, ldq, ldwd, ldwl, ldal;
};

__host__ __device__ inline Smem plan(int B, int D, int L, int id, int dd, bool dual) {
  Smem s{};
  const int P = n_params(D, L, dual);
  s.ldx = stride(D + 1);
  s.lds = stride(L + 1);
  s.ldg = stride(D);
  s.ldm = quad(L);
  int o = kHeader;
  s.p = o; o += quad(P);
  s.m = o; o += quad(P);
  s.v = o; o += quad(P);
  s.a = o; o += quad(dual ? dd : dd * id);
  s.sd = o; o += quad(L);
  s.sc = o; o += 4;  // the KL constant
  s.bc = o; o += quad(2 * kBcSteps);  // 1 − β₁ᵗ, 1 − β₂ᵗ of kBcSteps steps
  s.weT = o; o += L * s.ldx;
  s.wd = o; o += L * s.ldg;
  s.wdT = o; o += D * s.lds;
  s.ws = o; o += dual ? L * s.ldg : 0;
  s.wsT = o; o += dual ? D * s.lds : 0;
  s.x0 = o; o += B * s.ldx;
  s.x1 = o; o += B * s.ldx;
  s.z10 = o; o += quad(B * L);
  s.z11 = o; o += quad(B * L);
  s.z20 = o; o += quad(B * D);
  s.z21 = o; o += quad(B * D);
  s.nz = o; o += quad(B * id);
  s.s = o; o += B * s.lds;
  s.gy = o; o += B * s.ldg;
  s.gu = o; o += dual ? B * s.ldg : 0;
  s.gmu = o; o += B * s.ldm;
  s.q = o; o += B * s.ldm;
  s.part = o; o += quad(3 * B);
  s.total = o;
  return s;
}

// bf16 dots: k16 steps of a contraction of n, rows padded to a multiple of
// 8, and the floats that hold n bfloat16 values (a multiple of 4)
__host__ __device__ inline int slabs(int n) { return (n + 15) / 16; }
__host__ __device__ inline int oct(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int halves(int n) { return quad((n + 1) / 2); }

// bf16 dots: the gradient products' (m16, n8) tiles, [We] then [Wd] (and
// [Ws]), and the f32 pool's tiles of 4 columns: the bias rows [be | bd |
// bs] and g_ep
__host__ __device__ inline int n_mat_tiles(int D, int L, bool dual) {
  return slabs(D) * ((L + 7) / 8) + slabs(L) * ((D + 7) / 8) * (dual ? 2 : 1);
}
__host__ __device__ inline int n_pool_tiles(int D, int L, bool dual) {
  return 2 * ((L + 3) / 4) + ((D + 3) / 4) * (dual ? 2 : 1);
}

// The bf16-dot mode's plan (kBf16): the fp32 plan's state, scalars and
// noise, with other copies and activations. The weights' copies hold R(W)
// as bfloat16, no bias, each row the contraction padded with zeros to its
// k16 steps plus 8 (a row stride of 4·odd words: a warp's fragment words,
// 8 rows × 4 pairs, fall in 32 banks), oct(n) rows. The activations the
// products read have bp rows, those from B zero, and zero columns to the
// products' padded widths: x, g_y and g_u (f32) rows of 16·kd + 4 floats,
// mu→g_mu rows of oct(L) + 4, s (bfloat16 only: only products read it)
// rows of 16·kl + 4 values. Every such stride is 4·odd, so the
// per-parameter pass's pair loads (rows 2t and 2t + 1 of 8 columns) fall
// in 32 banks; the products round f32 values as they pack them. g_s·z1,
// which only the f32 pool reads, keeps B rows of quad(L). The partials
// are one a row and output tile: Σmu² a tile of L, Σr² and Σr·z2 a tile
// of D.
__host__ __device__ inline Smem plan_bf16(int B, int D, int L, int id, int dd, bool dual) {
  Smem s{};
  const int P = n_params(D, L, dual);
  const int kd = slabs(D), kl = slabs(L);
  s.bp = 16 * ((B + 15) / 16);
  s.ldx = 16 * kd + 4;
  s.ldg = 16 * kd + 4;
  s.ldm = oct(L) + 4;
  s.ldq = quad(L);
  s.ldwd = 16 * kd + 8;
  s.ldwl = 16 * kl + 8;
  s.ldal = 16 * kl + 4;
  int o = kHeader;
  s.p = o; o += quad(P);
  s.m = o; o += quad(P);
  s.v = o; o += quad(P);
  s.a = o; o += quad(dual ? dd : dd * id);
  s.sd = o; o += quad(L);
  s.sc = o; o += 4;
  s.bc = o; o += quad(2 * kBcSteps);
  s.weT = o; o += halves(oct(L) * s.ldwd);
  s.wd = o; o += halves(oct(L) * s.ldwd);
  s.wdT = o; o += halves(oct(D) * s.ldwl);
  s.ws = o; o += dual ? halves(oct(L) * s.ldwd) : 0;
  s.wsT = o; o += dual ? halves(oct(D) * s.ldwl) : 0;
  s.x0 = o; o += s.bp * s.ldx;
  s.x1 = o; o += s.bp * s.ldx;
  s.z10 = o; o += quad(B * L);
  s.z11 = o; o += quad(B * L);
  s.z20 = o; o += quad(B * D);
  s.z21 = o; o += quad(B * D);
  s.nz = o; o += quad(B * id);
  s.s = o; o += halves(s.bp * s.ldal);
  s.gy = o; o += s.bp * s.ldg;
  s.gu = o; o += dual ? s.bp * s.ldg : 0;
  s.gmu = o; o += s.bp * s.ldm;
  s.q = o; o += B * s.ldq;
  s.part = o; o += quad(B * ((L + 7) / 8 + 2 * ((D + 7) / 8)));
  s.total = o;
  return s;
}

__host__ __device__ inline Smem row_plan(int B, int D, int L, int id, int dd, bool dual,
                                         bool bf16) {
  return bf16 ? plan_bf16(B, D, L, id, dd, dual) : plan(B, D, L, id, dd, dual);
}

__device__ __forceinline__ float sigmoidf(float u) { return 1.0f / (1.0f + expf(-u)); }

// x rounded to the nearest bfloat16 (ties to even), back as a float.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A dot's operand in the launch's dot mode: rounded to bfloat16 in the
// bf16-dot instantiation, unchanged in the fp32 one.
template <bool kBf16>
__device__ __forceinline__ float dot_op(float x) {
  if constexpr (kBf16) return bf16_rn(x);
  else return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a·w over four terms, in order
__device__ __forceinline__ float dot4(float4 a, float4 w, float acc) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  return fmaf(a.w, w.w, acc);
}

// optax.adam on one slot held in registers: bias-corrected m̂/(√v̂ + eps).
// bf16 moments: m and v rounded before the update reads them (K4). A slot
// whose m and v are both zero (a padding weight's zero gradient) keeps its
// value, as the formula would (p − lr·0), without the divisions.
__device__ __forceinline__ void adam_reg(float& p, float& m, float& v, float g, float bc1,
                                         float bc2, float lr, bool round) {
  float m_ = kB1 * m + kOneMinusB1 * g;
  float v_ = kB2 * v + kOneMinusB2 * g * g;
  if (round) {
    m_ = bf16_rn(m_);
    v_ = bf16_rn(v_);
  }
  m = m_;
  v = v_;
  if (m_ == 0.0f && v_ == 0.0f) return;
  p = p - lr * ((m_ / bc1) / (sqrtf(v_ / bc2) + kAdamEps));
}

// adam_reg on slot i of the state. Returns the new value.
__device__ __forceinline__ float adam(float* p, float* m, float* v, int i, float g, float bc1,
                                      float bc2, float lr, bool round) {
  float pi = p[i], mi = m[i], vi = v[i];
  adam_reg(pi, mi, vi, g, bc1, bc2, lr, round);
  m[i] = mi;
  v[i] = vi;
  p[i] = pi;
  return pi;
}

// Everything a row's step reads that is fixed for the launch.
struct Dims {
  int B, D, L, id, dd, P;
  int o_be, o_wd, o_bd, o_ep, o_eps, o_ws, o_bs;
  int rw, tw, pw, z2a;  // bf16 dots: the warp roles (Roles)
};

// bf16 dots: the warps of each phase. Phase A: rw row warps (one a 16 × 8
// output tile of the stage with the most); phase B: tw tile warps (one a
// gradient tile), then
// pw pool warps; in each phase the warps after them (the scalar warp
// among them) draw. z2a: z2's draws go to phase A's draw (stage 0) rather
// than phase B's (stage 1) when that takes fewer rounds of Philox calls a
// lane over the two phases (the noise lanes walk their items in rounds).
struct Roles {
  int rw, tw, pw, z2a;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__host__ __device__ inline Roles roles(int B, int D, int L, int id, bool dual, bool obs) {
  Roles w;
  w.rw = imin(cdiv(B, 16) * cdiv(L > D ? L : D, 8), kMaxRowWarps);
  w.tw = imin(n_mat_tiles(D, L, dual), kMaxTileWarps);
  w.pw = imin(cdiv(n_pool_tiles(D, L, dual), 4), kMaxPoolWarps);
  const int lanes_a = kThreads - 32 * w.rw, lanes_b = kThreads - 32 * (w.tw + w.pw);
  const int calls_a = B * (cdiv(id, 4) + (obs ? cdiv(D, 4) : 0) + cdiv(L, 4));
  const int calls_z2 = B * cdiv(D, 4);
  w.z2a = cdiv(calls_a + calls_z2, lanes_a) < cdiv(calls_a, lanes_a) + cdiv(calls_z2, lanes_b);
  return w;
}

// The launch header at the start of shared memory: the block's row, its
// plan and dims, written once by thread 0. Every phase reads them from
// here, so they take no registers across the step and never spill.
struct Hdr {
  Row r;
  Smem S;
  Dims d;
};
static_assert(sizeof(Hdr) <= kHeader * sizeof(float), "the header outgrew kHeader");

// Normals 4·draw .. 4·draw+3 of one stream (philox.cuh), out of line.
__device__ __noinline__ float4 normals4v(uint32_t step, int row, int draw, uint32_t stream,
                                         uint32_t k0, uint32_t k1) {
  float n[4];
  normals4(step, row, draw, stream, k0, k1, n);
  return make_float4(n[0], n[1], n[2], n[3]);
}

// Items (b, j) of a B × n grid, lane pt of np: the first, and the step in
// rows and columns, computed once so that the walk divides nothing.
struct Walk {
  int b, j, db, dj;
  __device__ Walk(int pt, int np, int n) : b(pt / n), j(pt % n), db(np / n), dj(np % n) {}
  __device__ void next(int n) {
    j += dj;
    b += db;
    if (j >= n) {
      j -= n;
      ++b;
    }
  }
};

// The noise warps' share of drawing one step into buffer `k`: stage 0 (in
// phase A) the Philox draws of the manifold, observation-noise and z1
// streams; stage 1 (in phase B, after stage 0's barrier) the manifold
// columns of x: pad(n·Aᵀ) (+ the observation noise stage 0 left in x), or
// [n, σ(n·a)] (the padding columns stay zero), then the z2 draws. External
// noise: stage 0 copies z1, stage 1 x and z2. `pt` is the lane's index
// among `np` noise lanes. The manifold dot rounds n (and A, rounded when it
// was staged) in the bf16-dot mode; K2's identity columns stay n. In that
// mode z2's draws join stage 0 when the row's roles say so (Dims::z2a):
// the counters, not the stage, fix their bits.
template <bool kDual, bool kBf16>
__device__ __noinline__ void draw_noise(float* smem, int k, int stage, int it, uint32_t step,
                                        int pt, int np) {
  const Hdr& h = *reinterpret_cast<const Hdr*>(smem);
  const Row& r = h.r;
  const Smem& S = h.S;
  const Dims& d = h.d;
  const int B = d.B, D = d.D, L = d.L, id = d.id;
  float* x = smem + (k ? S.x1 : S.x0);
  float* z1 = smem + (k ? S.z11 : S.z10);
  float* z2 = smem + (k ? S.z21 : S.z20);
  float* nz = smem + S.nz;
  if (r.ext_x != nullptr) {
    if (stage == 0) {
      const float* e1 = r.ext_z1 + static_cast<size_t>(it) * B * L;
      for (int i = pt; i < B * L; i += np) z1[i] = e1[i];
    } else {
      const float* ex = r.ext_x + static_cast<size_t>(it) * B * D;
      const float* e2 = r.ext_z2 + static_cast<size_t>(it) * B * D;
      for (int i = pt; i < B * D; i += np) x[(i / D) * S.ldx + i % D] = ex[i];
      for (int i = pt; i < B * D; i += np) z2[i] = e2[i];
    }
    return;
  }
  const bool obs = !kDual && r.obs_scale > 0.0f;
  const bool z2a = kBf16 && d.z2a;
  if (stage == 0) {
    const int nw_int = (id + 3) / 4;
    const int nw_obs = obs ? (D + 3) / 4 : 0;
    const int nw_l = (L + 3) / 4;
    const int per_row = nw_int + nw_obs + nw_l + (z2a ? (D + 3) / 4 : 0);
    for (Walk w(pt, np, per_row); w.b < B; w.next(per_row)) {
      const int b = w.b;
      int j = w.j;
      uint32_t stream, k0, k1;
      float* dst;
      int dim;
      if (j < nw_int) {
        stream = kStreamManifold; k0 = r.dk0; k1 = r.dk1; dst = nz + b * id; dim = id;
      } else if (j < nw_int + nw_obs) {
        j -= nw_int;
        stream = kStreamObs; k0 = r.dk0; k1 = r.dk1; dst = x + b * S.ldx; dim = D;
      } else if (!z2a || j < nw_int + nw_obs + nw_l) {
        j -= nw_int + nw_obs;
        stream = kStreamZ1; k0 = r.mk0; k1 = r.mk1; dst = z1 + b * L; dim = L;
      } else {
        j -= nw_int + nw_obs + nw_l;
        stream = kStreamZ2; k0 = r.mk0; k1 = r.mk1; dst = z2 + b * D; dim = D;
      }
      const float4 v = normals4v(step, b, j, stream, k0, k1);
      const float n[4] = {v.x, v.y, v.z, v.w};
      const float scale = stream == kStreamObs ? r.obs_scale : 1.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * j + q;
        if (c < dim) dst[c] = stream == kStreamObs ? n[q] * scale : n[q];
      }
    }
    return;
  }
  const float* sA = smem + S.a;
  const int nx = kDual ? d.dd + 1 : d.dd;  // the manifold's columns of x
  for (Walk w(pt, np, nx); w.b < B; w.next(nx)) {
    const int b = w.b, j = w.j;
    const float* n = nz + b * id;
    float acc = 0.0f;
    if (kDual) {
      if (j < d.dd) {
        acc = n[j];
      } else {
        for (int c = 0; c < d.dd; ++c) acc = fmaf(dot_op<kBf16>(n[c]), sA[c], acc);
        acc = sigmoidf(acc);
      }
    } else {
      for (int c = 0; c < id; ++c) acc = fmaf(dot_op<kBf16>(n[c]), sA[j * id + c], acc);
    }
    float* xp = x + b * S.ldx + j;
    *xp = obs ? acc + *xp : acc;
  }
  if (z2a) return;
  const int nw_d = (D + 3) / 4;
  for (Walk w(pt, np, nw_d); w.b < B; w.next(nw_d)) {
    const float4 v = normals4v(step, w.b, w.j, kStreamZ2, r.mk0, r.mk1);
    const float n[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * w.j + q;
      if (c < D) z2[w.b * D + c] = n[q];
    }
  }
}

// Phase A, the per-row pass of one group of kGroup lanes over its rows:
// everything of a batch row that needs no other row. Lane `sub` owns the
// outputs sub, sub + 8, sub + 16 of each product (blocks of 24). Each output
// is a fmaf chain along the contraction in ascending order, read four terms
// at a time (float4 of the row, broadcast to the group, and of the weight's
// padded row), the bias last, as the plain version sums (x·We + be). A
// block loads weights only for the output slots some lane needs (`n_out`);
// a lane's slots past the width repeat its last row and are not stored.
// The fp32 mode's pass (row_pass_tc is the bf16-dot mode's).
template <bool kDual>
__device__ __forceinline__ void row_pass(float* smem, const Smem& S, const Dims& d, int k,
                                         int group, int sub, float noise_sd, float c_gy,
                                         float inv_b) {
  const int B = d.B, D = d.D, L = d.L;
  const int ldx = S.ldx, lds = S.lds, ldg = S.ldg, ldm = S.ldm;
  const float* sd = smem + S.sd;
  const float* weT = smem + S.weT;
  const float* wd = smem + S.wd;
  const float* wdT = smem + S.wdT;
  const float* ws = smem + S.ws;
  const float* wsT = smem + S.wsT;
  const int cx = quad(D + 1), cs = quad(L + 1), cg = quad(D);
  const unsigned mask = ((1u << kGroup) - 1) << (threadIdx.x & (32 - kGroup));
  for (int b = group; b < B; b += kRowGroups) {
    const float* xr = smem + (k ? S.x1 : S.x0) + b * ldx;
    const float* z1r = smem + (k ? S.z11 : S.z10) + b * L;
    const float* z2r = smem + (k ? S.z21 : S.z20) + b * D;
    float* sr = smem + S.s + b * lds;
    float* gyr = smem + S.gy + b * ldg;
    float* gur = smem + S.gu + b * ldg;
    float* gmr = smem + S.gmu + b * ldm;
    float* qr = smem + S.q + b * ldm;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;

    // mu = x·We + be, s = mu + e^{ep/2}·z1 (mu kept in g_mu's slot)
    for (int blk = 0; blk < L; blk += kGroup * kOut) {
      const int n_out = min(kOut, (L - blk + kGroup - 1) / kGroup);
      const float* w[kOut];
      float acc[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        w[o] = weT + min(blk + sub + kGroup * o, L - 1) * ldx;
        acc[o] = 0.0f;
      }
#pragma unroll 1
      for (int c = 0; c < cx; c += 4) {
        const float4 xv = ld4(xr + c);
#pragma unroll
        for (int o = 0; o < kOut; ++o)
          if (o < n_out) acc[o] = dot4(xv, ld4(w[o] + c), acc[o]);
      }
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int l = blk + sub + kGroup * o;
        if (l < L) {
          const float mu = acc[o];
          gmr[l] = mu;
          sr[l] = mu + sd[l] * z1r[l];
          a0 = fmaf(mu, mu, a0);
        }
      }
    }
    __syncwarp(mask);

    // y = s·Wd + bd (+ σ(s·Ws + bs)); r = y + z2·e^{ε/2} − x; g_y = r/(B·e^ε)
    // (dual: g_u = g_y·σ(u)(1 − σ(u)))
    for (int blk = 0; blk < D; blk += kGroup * kOut) {
      const int n_out = min(kOut, (D - blk + kGroup - 1) / kGroup);
      int row[kOut];
      float acc[kOut], acc_s[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        row[o] = min(blk + sub + kGroup * o, D - 1) * lds;
        acc[o] = acc_s[o] = 0.0f;
      }
#pragma unroll 1
      for (int c = 0; c < cs; c += 4) {
        const float4 sv = ld4(sr + c);
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          if (o < n_out) {
            acc[o] = dot4(sv, ld4(wdT + row[o] + c), acc[o]);
            if (kDual) acc_s[o] = dot4(sv, ld4(wsT + row[o] + c), acc_s[o]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int j = blk + sub + kGroup * o;
        if (j < D) {
          float x_hat = acc[o];
          float sig = 0.0f;
          if (kDual) {
            sig = sigmoidf(acc_s[o]);
            x_hat = sig + x_hat;
          }
          const float z2 = z2r[j];
          const float r = (x_hat + z2 * noise_sd) - xr[j];
          a1 = fmaf(r, r, a1);
          a2 = fmaf(r, z2, a2);
          const float g = r * c_gy;
          gyr[j] = g;
          if (kDual) gur[j] = g * sig * (1.0f - sig);
        }
      }
    }
    __syncwarp(mask);

    // g_s = g_y·Wdᵀ (+ g_u·Wsᵀ); g_mu = g_s + mu/B; g_s·z1 for g_ep
    for (int blk = 0; blk < L; blk += kGroup * kOut) {
      const int n_out = min(kOut, (L - blk + kGroup - 1) / kGroup);
      int row[kOut];
      float acc[kOut], acc_s[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        row[o] = min(blk + sub + kGroup * o, L - 1) * ldg;
        acc[o] = acc_s[o] = 0.0f;
      }
#pragma unroll 1
      for (int c = 0; c < cg; c += 4) {
        const float4 gv = ld4(gyr + c);
        float4 uv;
        if (kDual) uv = ld4(gur + c);
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          if (o < n_out) {
            acc[o] = dot4(gv, ld4(wd + row[o] + c), acc[o]);
            if (kDual) acc_s[o] = dot4(uv, ld4(ws + row[o] + c), acc_s[o]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int l = blk + sub + kGroup * o;
        if (l < L) {
          const float gs = kDual ? acc[o] + acc_s[o] : acc[o];
          qr[l] = gs * z1r[l];
          gmr[l] = gs + gmr[l] * inv_b;
        }
      }
    }

    // the row's partial sums: a fixed tree over the group's lanes
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(mask, a0, off);
      a1 += __shfl_xor_sync(mask, a1, off);
      a2 += __shfl_xor_sync(mask, a2, off);
    }
    if (sub == 0) {
      float* pr = smem + S.part + 3 * b;
      pr[0] = a0;
      pr[1] = a1;
      pr[2] = a2;
    }
  }
}

// Sum over a team's lanes, the same bits in every lane (xor tree; each
// level adds two values in either order, and a + b == b + a).
__device__ __forceinline__ float team_sum(float a, unsigned mask) {
#pragma unroll
  for (int off = 1; off < kTeam; off <<= 1) a += __shfl_xor_sync(mask, a, off);
  return a;
}

// Phase B, the per-parameter pass of one team of kTeam lanes: 4×4 tiles of
// the gradient matrices G = Uᵀ·V over the batch (U and V read as float4 a
// row), each output's sum in the team's fixed b slices (b ≡ lane mod kTeam,
// ascending) and tree, then Adam on it by one lane (lane t: column t % 4,
// rows 2·(t / 4) and 2·(t / 4) + 1 of the tile), which also writes the new
// value into the padded copies the per-row pass reads. Tiles are numbered
// [We; be], [Wd; bd], dual [Ws; bs], then ep (4 columns a tile). The fp32
// mode's pass (param_pass_tc and pool_pass are the bf16-dot mode's).
template <bool kDual>
__device__ __forceinline__ void param_pass(float* smem, const Smem& S, const Dims& d, int k,
                                           int team, int t, float lr, bool bf16, float bc1,
                                           float bc2) {
  static_assert(kTeam == 8, "lane t of a team updates two of a tile's 16 outputs");
  const int B = d.B, D = d.D, L = d.L;
  float* sp = smem + S.p;
  float* sm = smem + S.m;
  float* sv = smem + S.v;
  float* sd = smem + S.sd;
  const unsigned mask = ((1u << kTeam) - 1) << (threadIdx.x & (32 - kTeam));
  const int tE = ((D + 4) / 4) * ((L + 3) / 4);  // ceil((D+1)/4) · ceil(L/4)
  const int tW = ((L + 4) / 4) * ((D + 3) / 4);  // ceil((L+1)/4) · ceil(D/4)
  const int n_mat = tE + tW + (kDual ? tW : 0);
  const int n_tiles = n_mat + (L + 3) / 4;
  for (int tile = team; tile < n_tiles; tile += kTeams) {
    if (tile < n_mat) {
      int i = tile, R, C, ldu, ldv, off, ldc, ldT;
      const float *U, *V;
      float *cp, *cpT;  // the padded copies: [r·ldc + c] (r < R−1), [c·ldT + r]
      if (i < tE) {
        R = D + 1; C = L; U = smem + (k ? S.x1 : S.x0); ldu = S.ldx;
        V = smem + S.gmu; ldv = S.ldm; off = 0;
        cp = nullptr; ldc = 0; cpT = smem + S.weT; ldT = S.ldx;
      } else {
        i -= tE;
        const bool sig = kDual && i >= tW;
        if (sig) i -= tW;
        R = L + 1; C = D; U = smem + S.s; ldu = S.lds;
        V = smem + (sig ? S.gu : S.gy); ldv = S.ldg; off = sig ? d.o_ws : d.o_wd;
        cp = smem + (sig ? S.ws : S.wd); ldc = S.ldg;
        cpT = smem + (sig ? S.wsT : S.wdT); ldT = S.lds;
      }
      const int tc = (C + 3) / 4;
      const int r0 = 4 * (i / tc);
      const int c0 = 4 * (i - (i / tc) * tc);
      float a[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) a[rr][cc] = 0.0f;
      const float* u_p = U + t * ldu + r0;
      const float* v_p = V + t * ldv + c0;
#pragma unroll 2
      for (int b = t; b < B; b += kTeam) {
        const float4 u = ld4(u_p);
        const float4 w = ld4(v_p);
        u_p += kTeam * ldu;
        v_p += kTeam * ldv;
        const float uu[4] = {u.x, u.y, u.z, u.w};
        const float ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) a[rr][cc] = fmaf(uu[rr], ww[cc], a[rr][cc]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) a[rr][cc] = team_sum(a[rr][cc], mask);
      // lane t's two outputs: column t % 4, rows 2·(t / 4) and the next
      const int cc = t & 3, rh = t >> 2;
      const int c = c0 + cc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 2 * rh + h;
        float g = 0.0f;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (rr == 2 * rh + h && q == cc) g = a[rr][q];
        if (r < R && c < C) {
          const float x = adam(sp, sm, sv, off + r * C + c, g, bc1, bc2, lr, bf16 && r < R - 1);
          cpT[c * ldT + r] = x;
          if (cp != nullptr && r < R - 1) cp[r * ldc + c] = x;
        }
      }
    } else {
      const int c0 = 4 * (tile - n_mat);
      const float* q_p = smem + S.q + t * S.ldm + c0;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int b = t; b < B; b += kTeam) {
        const float4 qv = ld4(q_p);
        q_p += kTeam * S.ldm;
        a[0] += qv.x;
        a[1] += qv.y;
        a[2] += qv.z;
        a[3] += qv.w;
      }
#pragma unroll
      for (int o = 0; o < 4; ++o) a[o] = team_sum(a[o], mask);
      const int l = c0 + t;
      if (t < 4 && l < L) {
        const int i = d.o_ep + l;
        const float ep = sp[i];
        const float g = (t == 0 ? a[0] : t == 1 ? a[1] : t == 2 ? a[2] : a[3]) * 0.5f * sd[l] +
                        0.5f * (expf(ep) - 1.0f);
        sd[l] = expf(adam(sp, sm, sv, i, g, bc1, bc2, lr, false) * 0.5f);
      }
    }
  }
}

// ---- bf16 dots on the tensor cores (kBf16) ----------------------------------
//
// mma.sync m16n8k16, bf16 operands, f32 sums; g = lane / 4, t = lane % 4.
// A (16 × 16, row-major) is four registers: rows g and g + 8 at k = 2t,
// 2t + 1 (registers 0, 1) and k = 8 + 2t, 9 + 2t (2, 3); B (16 × 8) two: k =
// 2t, 2t + 1 and 8 + 2t, 9 + 2t at column g; the sum (16 × 8) four floats:
// rows g (0, 1) and g + 8 (2, 3) at columns 2t and 2t + 1. The lower k
// sits in the lower half of a register.

// x rounded to bfloat16, round to nearest even: its bits
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  const __nv_bfloat16 v = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&v);
}

// (p[0], p[ld]): two values a row apart, the first in the lower half;
// f32 values rounded as they are packed
__device__ __forceinline__ uint32_t pair(const uint16_t* p, int ld) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
}

__device__ __forceinline__ uint32_t pair(const float* p, int ld) { return bf16x2(p[0], p[ld]); }

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st32(uint16_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// acc += one k16 step's product: the mma from a zero accumulator, its
// partial added to the f32 sum by IEEE adds, round to nearest (the tensor
// cores' own accumulation truncates: a sum carried through them drifts)
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(part, a, b0, b1);
#pragma unroll
  for (int x = 0; x < 4; ++x) acc[x] += part[x];
}

// A's fragment of k16 step ks, rows r0 + g (+ 8): from a row-major f32
// buffer (each pair rounded as it is packed; one 8-byte load a pair) or a
// row-major bfloat16 copy (one 4-byte load a pair); row stride ld
__device__ __forceinline__ void afrag(uint32_t (&a)[4], const float* p, int ld, int r0, int ks,
                                      int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float2 v =
          *reinterpret_cast<const float2*>(p + (r0 + g + 8 * u) * ld + 16 * ks + 8 * h + 2 * t);
      a[2 * h + u] = bf16x2(v.x, v.y);
    }
}

__device__ __forceinline__ void afrag(uint32_t (&a)[4], const uint16_t* p, int ld, int r0,
                                      int ks, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 2; ++u) a[2 * h + u] = ld32(p + (r0 + g + 8 * u) * ld + 16 * ks + 8 * h + 2 * t);
}

// acc = the lane's quarter of the 16 × 8 output at rows r0.., columns n0..
// of A·B over nk k16 steps, in ascending steps (mma_add): A's fragments
// from A's row-major rows `as` (row stride lda), B's from a weight copy
// `w` whose rows are the output columns, k contiguous (row stride ldw):
// one 4-byte load a register.
template <typename T>
__device__ __forceinline__ void tile_sum(float (&acc)[4], int nk, const T* as, int lda, int r0,
                                         const uint16_t* w, int ldw, int n0, int g, int t) {
#pragma unroll
  for (int x = 0; x < 4; ++x) acc[x] = 0.0f;
  const uint16_t* wp = w + (n0 + g) * ldw + 2 * t;
  __syncwarp();  // the lanes parted in the last output's epilogue
  for (int ks = 0; ks < nk; ++ks) {
    uint32_t a[4];
    afrag(a, as, lda, r0, ks, g, t);
    mma_add(acc, a, ld32(wp + 16 * ks), ld32(wp + 16 * ks + 8));
  }
}

// A barrier of the first `threads` threads, named `id` (1: the row
// warps); the warps after them go on drawing
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The lane's sum over its two columns, then the quad's fixed xor tree
__device__ __forceinline__ float quad_sum(float a) {
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  return a + __shfl_xor_sync(0xffffffffu, a, 2);
}

// Phase A in the bf16-dot mode, row warp `warp` of d.rw: the row's three
// products on the tensor cores, in three stages a named barrier apart, each
// a set of 16 × 8 output tiles (a block of 16 batch rows, the last one's
// rows from B masked, × 8 columns) dealt round-robin over the row warps;
// each tile's elementwise work on its sum's fragment:
//   1. mu = x·We + be, s = mu + e^{ep/2}·z1      (x rounded as packed; R(s))
//   2. y = s·Wd + bd (dual: u = s·Ws + bs), r, g_y (g_u)
//   3. g_s = g_y·Wdᵀ (+ g_u·Wsᵀ), g_mu = g_s + mu/B, g_s·z1
// (g_y and g_u rounded as packed). The bias is added to the product's f32
// sum, last, as the plain version sums x·W + b; it never enters a product.
// The row partials Σmu², Σr², Σr·z2 of each tile (its lanes' columns in
// order, then the quad's xor tree) go to S.part, one a row and tile; the
// scalar warp sums a row's tiles in ascending order.
//
// A tile's elementwise work is a chain of shared-memory loads, shuffles
// and stores, so its code keeps that chain short: each stage reads the
// header's fields into registers once (a field read after a store to
// shared memory is a reload: the compiler must assume aliasing); a tile
// loads its elementwise operands unconditionally, before its product (the
// reads past a row's live columns or past row B land in zeroed padding or
// in other live buffers, so they are finite, and only masked lanes use
// them), selects zero for the masked ones in the partials, and guards only
// its stores.
template <bool kDual>
__device__ __forceinline__ void row_pass_tc(float* smem, const Smem& S, const Dims& d, int k,
                                            int warp, int lane, float noise_sd, float c_gy,
                                            float inv_b) {
  const int B = d.B, D = d.D, L = d.L, rw = d.rw;
  const int g = lane >> 2, t = lane & 3;
  const int kd = slabs(D), kl = slabs(L), nl8 = (L + 7) / 8, nd8 = (D + 7) / 8;
  const int np = nl8 + 2 * nd8;  // partials a row: Σmu² a tile of L, Σr², Σr·z2 a tile of D
  const int nblk = S.bp / 16;
  const int ldx = S.ldx, ldm = S.ldm, ldal = S.ldal, ldg = S.ldg;
  const float* x = smem + (k ? S.x1 : S.x0);
  const float* z1 = smem + (k ? S.z11 : S.z10);
  float* gmu = smem + S.gmu;
  float* part = smem + S.part;
  uint16_t* sb = reinterpret_cast<uint16_t*>(smem + S.s);

  // 1. mu = x·We + be (kept in g_mu's slot), s = mu + e^{ep/2}·z1; R(s)
  {
    const float* be = smem + S.p + d.o_be;
    const float* sd = smem + S.sd;
    const uint16_t* weT = reinterpret_cast<const uint16_t*>(smem + S.weT);
    const int ldw = S.ldwd;
    for (Walk w(warp, rw, nl8); w.b < nblk; w.next(nl8)) {
      const int r0 = 16 * w.b, c = 8 * w.j + 2 * t, b0 = r0 + g;
      const bool c0 = c < L, c1 = c + 1 < L;
      const float be0 = be[c], be1 = be[c + 1], sd0 = sd[c], sd1 = sd[c + 1];
      const float* zr = z1 + b0 * L + c;
      const float z00 = zr[0], z01 = zr[1], z10 = zr[8 * L], z11 = zr[8 * L + 1];
      float acc[4];
      tile_sum(acc, kd, x, ldx, r0, weT, ldw, 8 * w.j, g, t);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int b = b0 + 8 * u;
        const float m0 = acc[2 * u] + be0, m1 = acc[2 * u + 1] + be1;
        const float s0 = c0 ? m0 + sd0 * (u ? z10 : z00) : 0.0f;
        const float s1 = c1 ? m1 + sd1 * (u ? z11 : z01) : 0.0f;
        const float a0 = quad_sum(fmaf(c1 ? m1 : 0.0f, c1 ? m1 : 0.0f,
                                       fmaf(c0 ? m0 : 0.0f, c0 ? m0 : 0.0f, 0.0f)));
        if (b < B) {
          float* gm = gmu + b * ldm + c;
          if (c0) gm[0] = m0;
          if (c1) gm[1] = m1;
          if (c0) st32(sb + b * ldal + c, bf16x2(s0, s1));
          if (t == 0) part[b * np + w.j] = a0;
        }
      }
    }
  }
  bar_sync(1, 32 * rw);

  // 2. y = s·Wd + bd (+ σ(s·Ws + bs)); r = y + z2·e^{ε/2} − x; g_y = r/(B·e^ε)
  //    (dual: g_u = g_y·σ(u)(1 − σ(u)))
  {
    const float* bd = smem + S.p + d.o_bd;
    const float* bs = smem + S.p + d.o_bs;
    const float* z2 = smem + (k ? S.z21 : S.z20);
    const uint16_t* wdT = reinterpret_cast<const uint16_t*>(smem + S.wdT);
    const uint16_t* wsT = reinterpret_cast<const uint16_t*>(smem + S.wsT);
    float* gy = smem + S.gy;
    float* gu = smem + S.gu;
    const int ldw = S.ldwl;
    for (Walk w(warp, rw, nd8); w.b < nblk; w.next(nd8)) {
      const int r0 = 16 * w.b, c = 8 * w.j + 2 * t, b0 = r0 + g;
      const bool cm[2] = {c < D, c + 1 < D};
      const float bdv[2] = {bd[c], bd[c + 1]};
      float bsv[2] = {0.0f, 0.0f};
      if (kDual) {
        bsv[0] = bs[c];
        bsv[1] = bs[c + 1];
      }
      const float* zr = z2 + b0 * D + c;
      const float* xr = x + b0 * ldx + c;
      const float zz[2][2] = {{zr[0], zr[1]}, {zr[8 * D], zr[8 * D + 1]}};
      const float xv[2][2] = {{xr[0], xr[1]}, {xr[8 * ldx], xr[8 * ldx + 1]}};
      float ay[4], au[4];
      tile_sum(ay, kl, static_cast<const uint16_t*>(sb), ldal, r0, wdT, ldw, 8 * w.j, g, t);
      if (kDual)
        tile_sum(au, kl, static_cast<const uint16_t*>(sb), ldal, r0, wsT, ldw, 8 * w.j, g,
                 t);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int b = b0 + 8 * u;
        float gv[2], uv[2], a1 = 0.0f, a2 = 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x_hat = ay[2 * u + e] + bdv[e];
          float sig = 0.0f;
          if (kDual) {
            sig = sigmoidf(au[2 * u + e] + bsv[e]);
            x_hat = sig + x_hat;
          }
          const float r = cm[e] ? (x_hat + zz[u][e] * noise_sd) - xv[u][e] : 0.0f;
          a1 = fmaf(r, r, a1);
          a2 = fmaf(r, zz[u][e], a2);
          gv[e] = r * c_gy;
          uv[e] = gv[e] * sig * (1.0f - sig);
        }
        a1 = quad_sum(a1);
        a2 = quad_sum(a2);
        if (b < B) {
          float* gr = gy + b * ldg + c;
          float* ur = gu + b * ldg + c;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (cm[e]) {
              gr[e] = gv[e];
              if (kDual) ur[e] = uv[e];
            }
          }
          if (t == 0) {
            part[b * np + nl8 + w.j] = a1;
            part[b * np + nl8 + nd8 + w.j] = a2;
          }
        }
      }
    }
  }
  bar_sync(1, 32 * rw);

  // 3. g_s = g_y·Wdᵀ (+ g_u·Wsᵀ, the two sums added once); g_mu = g_s + mu/B;
  //    g_s·z1 for g_ep
  {
    const float* gy = smem + S.gy;
    const float* gu = smem + S.gu;
    const uint16_t* wd = reinterpret_cast<const uint16_t*>(smem + S.wd);
    const uint16_t* ws = reinterpret_cast<const uint16_t*>(smem + S.ws);
    float* q = smem + S.q;
    const int ldw = S.ldwd, ldq = S.ldq;
    for (Walk w(warp, rw, nl8); w.b < nblk; w.next(nl8)) {
      const int r0 = 16 * w.b, c = 8 * w.j + 2 * t, b0 = r0 + g;
      const bool cm[2] = {c < L, c + 1 < L};
      const float* zr = z1 + b0 * L + c;
      const float* mr = gmu + b0 * ldm + c;
      const float z[2][2] = {{zr[0], zr[1]}, {zr[8 * L], zr[8 * L + 1]}};
      const float mu[2][2] = {{mr[0], mr[1]}, {mr[8 * ldm], mr[8 * ldm + 1]}};
      float ag[4], as[4];
      tile_sum(ag, kd, gy, ldg, r0, wd, ldw, 8 * w.j, g, t);
      if (kDual) tile_sum(as, kd, gu, ldg, r0, ws, ldw, 8 * w.j, g, t);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int b = b0 + 8 * u;
        if (b < B) {
          float* qr = q + b * ldq + c;
          float* gm = gmu + b * ldm + c;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (cm[e]) {
              const float gs = kDual ? ag[2 * u + e] + as[2 * u + e] : ag[2 * u + e];
              qr[e] = gs * z[u][e];
              gm[e] = gs + mu[u][e] * inv_b;
            }
          }
        }
      }
    }
  }
}

// Phase B in the bf16-dot mode, tile warp `warp` of d.tw: the gradient
// products G = Uᵀ·V over the batch (K = bp, its rows from B zero) on the
// tensor cores, one (m16, n8) tile of G a warp at a time, numbered [We]
// (g_We = xᵀ·g_mu) then [Wd] (sᵀ·g_y) and, dual, [Ws] (sᵀ·g_u); x, g_mu,
// g_y and g_u are rounded as they are packed, s is R(s). A and B pair two
// batch rows, so each register is two loads a row apart. Each k16 step's
// mma starts from zero (mma_add). The lane that holds an output applies
// Adam to it (K4's rounding: every slot here is a weight matrix's), its
// four outputs' loads first, and writes R(W) into the copies the per-row
// pass reads.
template <bool kDual>
__device__ __forceinline__ void param_pass_tc(float* smem, const Smem& S, const Dims& d, int k,
                                              int warp, int lane, float lr, bool bf16, float bc1,
                                              float bc2) {
  const int D = d.D, L = d.L, tw = d.tw, o_wd = d.o_wd, o_ws = d.o_ws;
  const int g = lane >> 2, t = lane & 3;
  float* sp = smem + S.p;
  float* sm = smem + S.m;
  float* sv = smem + S.v;
  const float* x = smem + (k ? S.x1 : S.x0);
  const uint16_t* sb = reinterpret_cast<const uint16_t*>(smem + S.s);
  const int nE = (L + 7) / 8, nW = (D + 7) / 8;
  const int tE = slabs(D) * nE, tW = slabs(L) * nW;
  const int n_mat = tE + (kDual ? 2 : 1) * tW;
  const int bp = S.bp, ldx = S.ldx, ldal = S.ldal, ldg = S.ldg, ldm = S.ldm;
  const int ldwd = S.ldwd, ldwl = S.ldwl;
  const int o_gmu = S.gmu, o_gy = S.gy, o_gu = S.gu;
  const int o_weT = S.weT, o_wd_c = S.wd, o_wdT = S.wdT, o_ws_c = S.ws, o_wsT = S.wsT;
  for (int tile = warp; tile < n_mat; tile += tw) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    __syncwarp();  // the lanes parted in the last tile's Adam
    const bool we = tile < tE;
    int i = we ? tile : tile - tE;
    const bool sig = kDual && !we && i >= tW;
    if (sig) i -= tW;
    // G's rows m (j for We, l for Wd/Ws) and columns n (l, or j)
    const int nn = we ? nE : nW;
    const int m0 = 16 * (i / nn), n0 = 8 * (i % nn);
    if (we) {  // g_We[j][l] = Σ_b x[b][j]·g_mu[b][l]
      const float* up = x + 2 * t * ldx + m0 + g;
      const float* vp = smem + o_gmu + 2 * t * ldm + n0 + g;
#pragma unroll 2
      for (int b = 0; b < bp; b += 16) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) a[2 * h + u] = pair(up + (b + 8 * h) * ldx + 8 * u, ldx);
        mma_add(acc, a, pair(vp + b * ldm, ldm), pair(vp + (b + 8) * ldm, ldm));
      }
    } else {  // g_Wd[l][j] = Σ_b s[b][l]·g_y[b][j] (g_Ws: g_u)
      const uint16_t* up = sb + 2 * t * ldal + m0 + g;
      const float* vp = smem + (sig ? o_gu : o_gy) + 2 * t * ldg + n0 + g;
#pragma unroll 2
      for (int b = 0; b < bp; b += 16) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) a[2 * h + u] = pair(up + (b + 8 * h) * ldal + 8 * u, ldal);
        mma_add(acc, a, pair(vp + b * ldg, ldg), pair(vp + (b + 8) * ldg, ldg));
      }
    }
    // the lane's outputs (m0 + g + 8u, n0 + 2t + e): Adam, then R(W) into
    // the copies (We[j][l] → WeT[l][j]; W[l][j] → W[l][j] and WT[j][l])
    int idx[4], cp[4], cpT[4];
    bool ok[4];
    float pv[4], mv[4], vv[4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = 2 * u + e, r = m0 + g + 8 * u, c = n0 + 2 * t + e;
        if (we) {
          ok[o] = r < D && c < L;
          idx[o] = r * L + c;
          cp[o] = -1;
          cpT[o] = c * ldwd + r;
        } else {
          ok[o] = r < L && c < D;
          idx[o] = (sig ? o_ws : o_wd) + r * D + c;
          cp[o] = r * ldwd + c;
          cpT[o] = c * ldwl + r;
        }
        pv[o] = ok[o] ? sp[idx[o]] : 0.0f;
        mv[o] = ok[o] ? sm[idx[o]] : 0.0f;
        vv[o] = ok[o] ? sv[idx[o]] : 0.0f;
      }
#pragma unroll
    for (int o = 0; o < 4; ++o) adam_reg(pv[o], mv[o], vv[o], acc[o], bc1, bc2, lr, bf16);
    uint16_t* wcp = reinterpret_cast<uint16_t*>(smem + (we ? o_weT : sig ? o_ws_c : o_wd_c));
    uint16_t* wcpT = reinterpret_cast<uint16_t*>(smem + (we ? o_weT : sig ? o_wsT : o_wdT));
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (ok[o]) {
        sm[idx[o]] = mv[o];
        sv[idx[o]] = vv[o];
        sp[idx[o]] = pv[o];
        const uint16_t w = bf16_bits(pv[o]);
        wcpT[cpT[o]] = w;
        if (!we) wcp[cp[o]] = w;
      }
    }
  }
}

// Phase B in the bf16-dot mode, the f32 pool (team `team` of `nteams`,
// lane t of kTeam): the sums the reference keeps off the matrix unit, over
// the unrounded f32 values: the bias rows g_be = Σ_b g_mu, g_bd = Σ_b g_y
// (dual g_bs = Σ_b g_u) and g_ep's column sums Σ_b g_s·z1. A tile is 4
// columns; lane t sums the b ≡ t (mod kTeam) slice ascending, then the
// team's xor tree (the fp32 teams' order); lane t < 4 applies Adam (f32
// moments: no bias or ep slot is a matrix) to column c0 + t; the lane that
// updates ep_l writes e^{ep_l/2} for the next step. Tiles: [be | bd | bs |
// ep].
template <bool kDual>
__device__ __forceinline__ void pool_pass(float* smem, const Smem& S, const Dims& d, int team,
                                          int nteams, int t, float lr, float bc1, float bc2) {
  const int B = d.B, D = d.D, L = d.L;
  float* sp = smem + S.p;
  float* sm = smem + S.m;
  float* sv = smem + S.v;
  float* sd = smem + S.sd;
  const unsigned mask = ((1u << kTeam) - 1) << (threadIdx.x & (32 - kTeam));
  const int nl = (L + 3) / 4, nd = (D + 3) / 4;
  const int n_tiles = n_pool_tiles(D, L, kDual);
  for (int tile = team; tile < n_tiles; tile += nteams) {
    int i = tile, ld, n, off;
    const float* src;
    bool ep = false;
    if (i < nl) {
      src = smem + S.gmu; ld = S.ldm; n = L; off = d.o_be;
    } else if (i < nl + nd) {
      i -= nl; src = smem + S.gy; ld = S.ldg; n = D; off = d.o_bd;
    } else if (kDual && i < nl + 2 * nd) {
      i -= nl + nd; src = smem + S.gu; ld = S.ldg; n = D; off = d.o_bs;
    } else {
      i -= nl + (kDual ? 2 : 1) * nd; src = smem + S.q; ld = S.ldq; n = L; off = d.o_ep;
      ep = true;
    }
    const int c0 = 4 * i;
    const float* p = src + t * ld + c0;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int b = t; b < B; b += kTeam) {
      const float4 v = ld4(p);
      p += kTeam * ld;
      a[0] += v.x;
      a[1] += v.y;
      a[2] += v.z;
      a[3] += v.w;
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) a[o] = team_sum(a[o], mask);
    const int c = c0 + t;
    if (t < 4 && c < n) {
      const float s = t == 0 ? a[0] : t == 1 ? a[1] : t == 2 ? a[2] : a[3];
      if (ep) {
        const float e = sp[off + c];
        const float g = s * 0.5f * sd[c] + 0.5f * (expf(e) - 1.0f);
        sd[c] = expf(adam(sp, sm, sv, off + c, g, bc1, bc2, lr, false) * 0.5f);
      } else {
        adam(sp, sm, sv, off + c, s, bc1, bc2, lr, false);
      }
    }
  }
}

// One row's K-step chunk, run by one CTA. The only body of the kernel: solo
// and grid launches differ in where the block reads its Row, nothing else.
template <bool kDual, bool kBf16>
__device__ __forceinline__ void train_row(const Row& solo, const Row* rows, int n_steps, int B,
                                          float eps_const, int tdv, float lr, int moments_bf16,
                                          int skip) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  Hdr& hdr = *reinterpret_cast<Hdr*>(smem);
  if (tid == 0) {
    const Row r = rows != nullptr ? rows[blockIdx.x] : solo;
    Dims d;
    d.B = B; d.D = r.D; d.L = r.L; d.id = r.id; d.dd = r.dd;
    d.P = n_params(r.D, r.L, kDual);
    d.o_be = r.D * r.L;
    d.o_wd = d.o_be + r.L;
    d.o_bd = d.o_wd + r.L * r.D;
    d.o_ep = d.o_bd + r.D;
    d.o_eps = d.o_ep + r.L;
    d.o_ws = d.o_eps + 1;      // dual only
    d.o_bs = d.o_ws + r.L * r.D;  // dual only
    d.rw = d.tw = d.pw = d.z2a = 0;
    if constexpr (kBf16) {
      const Roles w = roles(B, r.D, r.L, r.id, kDual, !kDual && r.obs_scale > 0.0f);
      d.rw = w.rw; d.tw = w.tw; d.pw = w.pw; d.z2a = w.z2a;
    }
    hdr.r = r;
    hdr.S = row_plan(B, r.D, r.L, r.id, r.dd, kDual, kBf16);
    hdr.d = d;
  }
  __syncthreads();
  const Row& r = hdr.r;
  const Smem& S = hdr.S;
  const Dims& d = hdr.d;
  const int D = d.D, L = d.L;
  const int n_a = kDual ? d.dd : d.dd * d.id;

  // zero the weights' copies and the activations (their padding is read
  // and must be zero; the bf16-dot mode's passes also read past the
  // state's last slot, so there from the state on), then fill the copies
  // (and, fp32, the ones columns)
  const int z0 = kBf16 ? S.p : S.sd;
  for (int i = tid; i < S.total - z0; i += kThreads) smem[z0 + i] = 0.0f;
  if (kBf16) __syncthreads();
  for (int i = tid; i < d.P; i += kThreads) {
    smem[S.p + i] = r.p[i];
    smem[S.m + i] = r.m[i];
    smem[S.v + i] = r.v[i];
  }
  for (int i = tid; i < n_a; i += kThreads) smem[S.a + i] = dot_op<kBf16>(r.a[i]);
  __syncthreads();
  if constexpr (kBf16) {
    // R(W) as bfloat16 (the products read no bias: the passes read it from
    // the state)
    const float* sp = smem + S.p;
    uint16_t* weT = reinterpret_cast<uint16_t*>(smem + S.weT);
    uint16_t* wd = reinterpret_cast<uint16_t*>(smem + S.wd);
    uint16_t* wdT = reinterpret_cast<uint16_t*>(smem + S.wdT);
    uint16_t* ws = reinterpret_cast<uint16_t*>(smem + S.ws);
    uint16_t* wsT = reinterpret_cast<uint16_t*>(smem + S.wsT);
    for (int i = tid; i < D * L; i += kThreads) {  // We → WeT
      const int j = i / L, l = i - j * L;
      weT[l * S.ldwd + j] = bf16_bits(sp[i]);
    }
    for (int i = tid; i < L * D; i += kThreads) {  // Wd → Wd, WdT; Ws → Ws, WsT
      const int l = i / D, j = i - l * D;
      const uint16_t w = bf16_bits(sp[d.o_wd + i]);
      wd[l * S.ldwd + j] = w;
      wdT[j * S.ldwl + l] = w;
      if (kDual) {
        const uint16_t u = bf16_bits(sp[d.o_ws + i]);
        ws[l * S.ldwd + j] = u;
        wsT[j * S.ldwl + l] = u;
      }
    }
  } else {
    const float* sp = smem + S.p;
    // [We; be] → WeT, [Wd; bd] → WdT and Wd, [Ws; bs] → WsT and Ws
    for (int i = tid; i < (D + 1) * L; i += kThreads) {
      const int j = i / L, l = i - j * L;
      smem[S.weT + l * S.ldx + j] = sp[i];
    }
    for (int i = tid; i < (L + 1) * D; i += kThreads) {
      const int l = i / D, j = i - l * D;
      const float wd = sp[d.o_wd + i];
      smem[S.wdT + j * S.lds + l] = wd;
      if (l < L) smem[S.wd + l * S.ldg + j] = wd;
      if (kDual) {
        const float ws = sp[d.o_ws + i];
        smem[S.wsT + j * S.lds + l] = ws;
        if (l < L) smem[S.ws + l * S.ldg + j] = ws;
      }
    }
    for (int b = tid; b < B; b += kThreads) {
      smem[S.x0 + b * S.ldx + D] = 1.0f;
      smem[S.x1 + b * S.ldx + D] = 1.0f;
      smem[S.s + b * S.lds + L] = 1.0f;
    }
  }
  if (tid < L) smem[S.sd + tid] = expf(smem[S.p + d.o_ep + tid] * 0.5f);

  const float inv_b = 1.0f / static_cast<float>(B);
  // the warps with rows (phase A) and with tiles or the pool (phase B); the
  // rest draw: lane pt of np in each phase
  const int work_a = kBf16 ? d.rw : kRowWarps;
  const int work_b = kBf16 ? d.tw + d.pw : kRowWarps;
  const bool row_warp = warp < work_a;
  const bool param_warp = warp < work_b;
  const int pt = tid - work_a * 32;  // index among the noise lanes
  const int np = kThreads - work_a * 32;
  const int pt_b = tid - work_b * 32;
  const int np_b = kThreads - work_b * 32;
  const bool noise = !(skip & kSkipNoise) && !(skip & kSkipWork);
  const bool do_rows = !(skip & kSkipRows) && !(skip & kSkipWork);
  const bool params = !(skip & kSkipParams) && !(skip & kSkipWork);
  const bool scalars = !(skip & kSkipWork);

  // step 0's noise into buffer 0
  if (!row_warp && noise) draw_noise<kDual, kBf16>(smem, 0, 0, 0, r.step0, pt, np);
  __syncthreads();
  if (!param_warp && noise) draw_noise<kDual, kBf16>(smem, 0, 1, 0, r.step0, pt_b, np_b);
  __syncthreads();

  for (int it = 0; it < n_steps; ++it) {
    if (it % kBcSteps == 0) {
      // 1 − βᵗ of the next kBcSteps steps, in double, rounded once to float:
      // float powf(0.999f, t) carries 0.999f's rounding (~1e-5 relative in
      // 1 − β₂ᵗ at t ≈ 60), a systematic bias in every step size. A pure
      // function of t, so chunk boundaries cannot change it. One more
      // barrier every kBcSteps steps keeps the two pows off every step.
      for (int i = tid; i < 2 * kBcSteps; i += kThreads) {
        const int u = i % kBcSteps;
        if (it + u < n_steps) {
          const double t = static_cast<double>(r.t0 + it + u + 1);
          smem[S.bc + i] = static_cast<float>(1.0 - pow(i < kBcSteps ? 0.9 : 0.999, t));
        }
      }
      __syncthreads();
    }
    const float bc1 = smem[S.bc + it % kBcSteps];
    const float bc2 = smem[S.bc + kBcSteps + it % kBcSteps];
    const int k = it & 1;
    const bool ahead = it + 1 < n_steps;
    const uint32_t next = r.step0 + static_cast<uint32_t>(it + 1);
    const float eps = tdv ? smem[S.p + d.o_eps] * eps_const : eps_const;
    const float noise_sd = expf(eps * 0.5f);
    const float inv_var = expf(-eps);
    const float c_gy = inv_var * inv_b;

    // --- phase A: the per-row pass; the next step's draws; the KL constant
    if (row_warp) {
      if (do_rows) {
        if constexpr (kBf16)
          row_pass_tc<kDual>(smem, S, d, k, warp, lane, noise_sd, c_gy, inv_b);
        else
          row_pass<kDual>(smem, S, d, k, tid / kGroup, tid % kGroup, noise_sd, c_gy, inv_b);
      }
    } else {
      if (warp == kScalarWarp && scalars) {
        float kl = 0.0f;
        for (int l = lane; l < L; l += 32) {
          const float ep = smem[S.p + d.o_ep + l];
          kl += -0.5f * (1.0f + ep - expf(ep));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) kl += __shfl_xor_sync(0xffffffffu, kl, off);
        if (lane == 0) smem[S.sc] = kl;
      }
      if (ahead && noise) draw_noise<kDual, kBf16>(smem, k ^ 1, 0, it + 1, next, pt, np);
    }
    __syncthreads();

    // --- phase B: gradients fused with Adam; the loss and ε; next draws --
    if (param_warp) {
      if (params) {
        if constexpr (kBf16) {
          if (warp < d.tw)
            param_pass_tc<kDual>(smem, S, d, k, warp, lane, lr, moments_bf16 != 0, bc1, bc2);
          else
            pool_pass<kDual>(smem, S, d, (tid - 32 * d.tw) / kTeam, d.pw * 32 / kTeam,
                             tid % kTeam, lr, bc1, bc2);
        } else {
          param_pass<kDual>(smem, S, d, k, tid / kTeam, tid % kTeam, lr, moments_bf16 != 0, bc1,
                            bc2);
        }
      }
    } else {
      if (warp == kScalarWarp && scalars) {
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        if constexpr (kBf16) {  // a row's tiles in ascending order, then the row
          const int nl8 = (L + 7) / 8, nd8 = (D + 7) / 8, np = nl8 + 2 * nd8;
          for (int b = lane; b < B; b += 32) {
            const float* pr = smem + S.part + b * np;
            float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
            for (int i = 0; i < nl8; ++i) r0 += pr[i];
            for (int i = 0; i < nd8; ++i) {
              r1 += pr[nl8 + i];
              r2 += pr[nl8 + nd8 + i];
            }
            s0 += r0;
            s1 += r1;
            s2 += r2;
          }
        } else {
          for (int b = lane; b < B; b += 32) {
            const float* pr = smem + S.part + 3 * b;
            s0 += pr[0];
            s1 += pr[1];
            s2 += pr[2];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0) {
          r.losses[it] = smem[S.sc] + 0.5f * inv_b * s0 + 0.5f * inv_var * inv_b * s1 +
                         static_cast<float>(D) * (0.5f * (kLog2Pi + eps));
          // d loss / d epsilon (the learned scale) under -tdv
          const float g_eps = -0.5f * inv_var * inv_b * s1 + 0.5f * static_cast<float>(D) +
                              (c_gy * s2) * 0.5f * noise_sd;
          adam(smem + S.p, smem + S.m, smem + S.v, d.o_eps, tdv ? g_eps * eps_const : 0.0f,
               bc1, bc2, lr, false);
        }
      }
      if (ahead && noise) draw_noise<kDual, kBf16>(smem, k ^ 1, 1, it + 1, next, pt_b, np_b);
    }
    __syncthreads();
  }

  for (int i = tid; i < d.P; i += kThreads) {
    r.p[i] = smem[S.p + i];
    r.m[i] = smem[S.m + i];
    r.v[i] = smem[S.v + i];
  }
}

// Solo launches pass their one row by value (rows == nullptr); grid
// launches (K6a) pass the device table, one row per block. kBf16: the
// bf16-dot mode (the launch's bf16_dots).
template <bool kDual, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) linear_vae_chunk_kernel(
    Row solo, const Row* __restrict__ rows, int n_steps, int B, float eps_const, int tdv,
    float lr, int moments_bf16, int skip) {
  train_row<kDual, kBf16>(solo, rows, n_steps, B, eps_const, tdv, lr, moments_bf16, skip);
}

// T1's draw (replaces tools/check_kernel_rng.py:80, draw -> sample_kernel):
// (rows, n_draws, 4) normals of one stream at one step, Philox4x32-10 at
// counters (step, row, draw, stream) under the 64-bit key, then
// Box-Muller, through the same philox4x32_10 and box_muller4 as the
// training kernels' noise; with kWords also the (rows, n_draws, 4) words,
// for the bitwise check against ops/rng.py. Call i = row·n_draws + draw
// writes normals[i] as one float4 (and words[i] as one uint4): a warp
// stores 512 contiguous bytes at a time. The 8.4 MB of normals take 2.504
// µs at 3.35 TB/s; the ~220 instructions of a call (10 Philox rounds, the
// precise logf, sqrtf and sincosf twice) come, by estimate, to ~3.4 µs of
// issue over the card's 132 SMs, so the design keeps every SM's
// schedulers full: the grid is the SMs times the blocks one SM holds, each
// thread strides through several calls, and (row, draw) steps with the
// stride by an add and a compare (one division a thread, before the loop).
template <bool kWords>
__global__ void __launch_bounds__(kSamplerThreads) philox_draw_kernel(
    uint4* __restrict__ words, float4* __restrict__ normals, int rows, int n_draws,
    uint32_t step, uint32_t stream, uint32_t k0, uint32_t k1) {
  const unsigned int n = static_cast<unsigned int>(rows) * static_cast<unsigned int>(n_draws);
  const unsigned int stride = gridDim.x * blockDim.x;
  unsigned int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int nd = static_cast<unsigned int>(n_draws);
  unsigned int r = i / nd, j = i - r * nd;
  const unsigned int sr = stride / nd, sj = stride - sr * nd;
  for (; i < n; i += stride) {
    const uint4 w = philox4x32_10(make_uint4(step, r, j, stream), k0, k1);
    float v[4];
    box_muller4(w, v);
    normals[i] = make_float4(v[0], v[1], v[2], v[3]);
    if constexpr (kWords) words[i] = w;
    r += sr;
    j += sj;
    if (j >= nd) {
      j -= nd;
      ++r;
    }
  }
}

// The draw's grid: every SM filled with as many blocks as it holds, or
// fewer when the calls run out.
int draw_grid(int rows, int n_draws, bool with_words, int* blocks) {
  if (rows < 1 || n_draws < 1 || static_cast<long long>(rows) * n_draws > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, with_words ? philox_draw_kernel<true> : philox_draw_kernel<false>,
        kSamplerThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(rows) * n_draws + kSamplerThreads - 1) /
                         kSamplerThreads;
  const long long full = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(need < full ? need : full);
  return 0;
}

size_t row_smem_bytes(int B, const Row& r, bool dual, bool bf16) {
  return static_cast<size_t>(row_plan(B, r.D, r.L, r.id, r.dd, dual, bf16).total) *
         sizeof(float);
}

template <bool kDual, bool kBf16>
int launch(const Row& solo, const Row* rows, int n_rows, size_t bytes, int n_steps, int B,
           float eps_const, int tdv, float lr, int moments_bf16, int skip, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(linear_vae_chunk_kernel<kDual, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_vae_chunk_kernel<kDual, kBf16>
      <<<n_rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          solo, rows, n_steps, B, eps_const, tdv, lr, moments_bf16, skip);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const Row& solo, const Row* rows, int n_rows, size_t bytes, int n_steps,
                int B, int dual, float eps_const, int tdv, float lr, int moments_bf16,
                int bf16_dots, int skip, void* stream) {
  if (bytes > kSmemLimit || skip < 0 || skip > kSkipAll)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = dual ? (bf16_dots ? launch<true, true> : launch<true, false>)
                       : (bf16_dots ? launch<false, true> : launch<false, false>);
  return go(solo, rows, n_rows, bytes, n_steps, B, eps_const, tdv, lr, moments_bf16, skip,
            stream);
}

}  // namespace

extern "C" {

size_t linear_vae_smem_bytes(int B, int D, int L, int id, int dd, int dual, int bf16_dots) {
  return static_cast<size_t>(row_plan(B, D, L, id, dd, dual != 0, bf16_dots != 0).total) *
         sizeof(float);
}

const char* linear_vae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

size_t linear_vae_row_bytes() { return sizeof(Row); }

int linear_vae_chunk(float* p, float* m, float* v, float* losses, const float* a,
                     const float* ext_x, const float* ext_z1, const float* ext_z2,
                     int n_steps, int B, int D, int L, int id, int dd, int dual,
                     unsigned int step0, int t0, unsigned int dk0, unsigned int dk1,
                     unsigned int mk0, unsigned int mk1, float obs_scale,
                     float eps_const, int tdv, float lr, int moments_bf16, int bf16_dots,
                     void* stream) {
  const Row row{p, m, v, losses, a, ext_x, ext_z1, ext_z2, D, L, id, dd,
                step0, t0, dk0, dk1, mk0, mk1, obs_scale};
  return launch_rows(row, nullptr, 1, row_smem_bytes(B, row, dual != 0, bf16_dots != 0),
                     n_steps, B, dual, eps_const, tdv, lr, moments_bf16, bf16_dots, 0, stream);
}

// K6a: ``n_rows`` rows in one launch, one block each. ``rows_host`` and
// ``rows_dev`` hold the same table; the host copy sizes the launch's
// shared memory to its
// largest row. ``skip`` is 0 in training (timing variants otherwise).
int linear_vae_grid_chunk(const Row* rows_host, const Row* rows_dev, int n_rows, int n_steps,
                          int B, int dual, float eps_const, int tdv, float lr,
                          int moments_bf16, int bf16_dots, int skip, void* stream) {
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  for (int i = 0; i < n_rows; ++i) {
    const size_t b = row_smem_bytes(B, rows_host[i], dual != 0, bf16_dots != 0);
    if (b > bytes) bytes = b;
  }
  return launch_rows(Row{}, rows_dev, n_rows, bytes, n_steps, B, dual, eps_const, tdv, lr,
                     moments_bf16, bf16_dots, skip, stream);
}

// How many blocks of the kernel one SM can hold at ``bytes`` of dynamic
// shared memory (the grid mode asks whether rows share SMs).
int linear_vae_blocks_per_sm(int dual, size_t bytes, int* blocks) {
  const auto kernel =
      dual ? linear_vae_chunk_kernel<true, false> : linear_vae_chunk_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, bytes));
}

// T1's draw: normals (rows, n_draws, 4) float32 and, unless words is null,
// the words (rows, n_draws, 4) uint32, at counters (step, row, draw,
// stream_id) under the key (k0, k1).
int philox_draw(unsigned int* words, float* normals, int rows, int n_draws, unsigned int step,
                unsigned int stream_id, unsigned int k0, unsigned int k1, void* stream) {
  int blocks = 0;
  const int err = draw_grid(rows, n_draws, words != nullptr, &blocks);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr)
    philox_draw_kernel<true><<<blocks, kSamplerThreads, 0, st>>>(
        reinterpret_cast<uint4*>(words), reinterpret_cast<float4*>(normals), rows, n_draws,
        step, stream_id, k0, k1);
  else
    philox_draw_kernel<false><<<blocks, kSamplerThreads, 0, st>>>(
        nullptr, reinterpret_cast<float4*>(normals), rows, n_draws, step, stream_id, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
