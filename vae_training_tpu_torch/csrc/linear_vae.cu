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
// bf16 dots (--precision bf16 on the card; the TPU kernel's default dot
// mode, prec = None at linear_vae.py:324-345): the kBf16 instantiation
// rounds every dot's operands to bfloat16, round to nearest even, and keeps
// the f32 FMA chains: the manifold draw n·Aᵀ (K2: n·a into σ), mu = x·We,
// y = s·Wd (K2: s·Ws), g_s = g_y·Wdᵀ (+ g_u·Wsᵀ) and the three gradient
// products Uᵀ·V. Nothing else is rounded: the biases (the last term of the
// padded copies' chains), the bias gradients (the tiles' bias row, whose V
// stays unrounded: g_b is a plain sum), the loss sums, g_ep's column sums,
// Adam and the state. The activations stay unrounded in shared memory (r,
// g_y and mu also feed the loss and g_mu) and are rounded where a dot loads
// them; the weights' padded copies, which only the dots read, hold R(W)
// (written by Adam's lanes and at the start), the bias slots W's own. The
// fp32 instantiation (kBf16 = false) is the code of the fp32 mode, unchanged.
//
// Every sum has an order fixed by the algorithm (a row's chain and tree, a
// team's b slices and tree, the scalar warp's tree), independent of the
// launch, of the number of rows and of which lane or warp runs it; no
// atomics. So runs repeat bitwise, a grid row equals its solo launch, and a
// resumed run equals an uninterrupted one. The products are fp32 FMA chains
// (no tensor cores).
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

using namespace philox;

constexpr int kThreads = 1024;
constexpr int kRowWarps = 25;    // the per-row and per-parameter passes; the rest draw noise
constexpr int kGroup = 8;        // lanes a batch row
constexpr int kRowGroups = kRowWarps * 32 / kGroup;  // 100: rows a round
constexpr int kOut = 3;          // outputs a lane a block of kGroup·kOut
constexpr int kTeam = 8;         // lanes a gradient tile
constexpr int kTeams = kRowWarps * 32 / kTeam;
constexpr int kScalarWarp = kThreads / 32 - 1;  // the KL constant, the loss, ε
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

template <bool kBf16>
__device__ __forceinline__ float4 dot_op4(float4 v) {
  return make_float4(dot_op<kBf16>(v.x), dot_op<kBf16>(v.y), dot_op<kBf16>(v.z),
                     dot_op<kBf16>(v.w));
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

// optax.adam on one slot: bias-corrected m̂/(√v̂ + eps). bf16 moments: m
// and v rounded before the update reads them (K4). Returns the new value.
// A slot whose m and v are both zero (a padding weight's zero gradient)
// keeps its value, as the formula would (p − lr·0), without the divisions.
__device__ __forceinline__ float adam(float* p, float* m, float* v, int i, float g, float bc1,
                                      float bc2, float lr, bool round) {
  float m_ = kB1 * m[i] + kOneMinusB1 * g;
  float v_ = kB2 * v[i] + kOneMinusB2 * g * g;
  if (round) {
    m_ = bf16_rn(m_);
    v_ = bf16_rn(v_);
  }
  m[i] = m_;
  v[i] = v_;
  if (m_ == 0.0f && v_ == 0.0f) return p[i];
  const float x = p[i] - lr * ((m_ / bc1) / (sqrtf(v_ / bc2) + kAdamEps));
  p[i] = x;
  return x;
}

// Everything a row's step reads that is fixed for the launch.
struct Dims {
  int B, D, L, id, dd, P;
  int o_be, o_wd, o_bd, o_ep, o_eps, o_ws, o_bs;
};

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
// was staged) in the bf16-dot mode; K2's identity columns stay n.
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
  if (stage == 0) {
    const int nw_int = (id + 3) / 4;
    const int nw_obs = obs ? (D + 3) / 4 : 0;
    const int nw_l = (L + 3) / 4;
    const int per_row = nw_int + nw_obs + nw_l;
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
      } else {
        j -= nw_int + nw_obs;
        stream = kStreamZ1; k0 = r.mk0; k1 = r.mk1; dst = z1 + b * L; dim = L;
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
// a lane's slots past the width repeat its last row and are not stored. In
// the bf16-dot mode the row's operand (x, s, g_y, g_u) is rounded as it is
// loaded, and the padded copies hold rounded weights.
template <bool kDual, bool kBf16>
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
        const float4 xv = dot_op4<kBf16>(ld4(xr + c));
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
        const float4 sv = dot_op4<kBf16>(ld4(sr + c));
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
        const float4 gv = dot_op4<kBf16>(ld4(gyr + c));
        float4 uv;
        if (kDual) uv = dot_op4<kBf16>(ld4(gur + c));
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
// [We; be], [Wd; bd], dual [Ws; bs], then ep (4 columns a tile). In the
// bf16-dot mode U and V are rounded as they are loaded, but V in the bias
// row (r = R − 1, where U is the column of ones): g_b is a plain sum. Adam's
// lane writes R(W) into the copies, the bias as it is.
template <bool kDual, bool kBf16>
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
      bool bias_row[4];  // the tile's row that sums V unrounded (bf16 dots)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) bias_row[rr] = kBf16 && r0 + rr == R - 1;
#pragma unroll 2
      for (int b = t; b < B; b += kTeam) {
        const float4 u = dot_op4<kBf16>(ld4(u_p));
        const float4 w = ld4(v_p);
        const float4 wr = dot_op4<kBf16>(w);
        u_p += kTeam * ldu;
        v_p += kTeam * ldv;
        const float uu[4] = {u.x, u.y, u.z, u.w};
        const float ww[4] = {w.x, w.y, w.z, w.w};
        const float wwr[4] = {wr.x, wr.y, wr.z, wr.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            a[rr][cc] = fmaf(uu[rr], bias_row[rr] ? ww[cc] : wwr[cc], a[rr][cc]);
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
          cpT[c * ldT + r] = r < R - 1 ? dot_op<kBf16>(x) : x;
          if (cp != nullptr && r < R - 1) cp[r * ldc + c] = dot_op<kBf16>(x);
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
    hdr.r = r;
    hdr.S = plan(B, r.D, r.L, r.id, r.dd, kDual);
    hdr.d = d;
  }
  __syncthreads();
  const Row& r = hdr.r;
  const Smem& S = hdr.S;
  const Dims& d = hdr.d;
  const int D = d.D, L = d.L;
  const int n_a = kDual ? d.dd : d.dd * d.id;

  // zero the weights' copies and the activations (their padding is read
  // and must be zero), then fill the copies and the ones columns
  for (int i = tid; i < S.total - S.sd; i += kThreads) smem[S.sd + i] = 0.0f;
  for (int i = tid; i < d.P; i += kThreads) {
    smem[S.p + i] = r.p[i];
    smem[S.m + i] = r.m[i];
    smem[S.v + i] = r.v[i];
  }
  for (int i = tid; i < n_a; i += kThreads) smem[S.a + i] = dot_op<kBf16>(r.a[i]);
  __syncthreads();
  {
    const float* sp = smem + S.p;
    // the copies' matrix slots in the dot mode, the bias slots as they are
    for (int i = tid; i < (D + 1) * L; i += kThreads) {  // [We; be] → WeT
      const int j = i / L, l = i - j * L;
      smem[S.weT + l * S.ldx + j] = j < D ? dot_op<kBf16>(sp[i]) : sp[i];
    }
    for (int i = tid; i < (L + 1) * D; i += kThreads) {  // [Wd; bd], [Ws; bs]
      const int l = i / D, j = i - l * D;
      const float wd = sp[d.o_wd + i];
      smem[S.wdT + j * S.lds + l] = l < L ? dot_op<kBf16>(wd) : wd;
      if (l < L) smem[S.wd + l * S.ldg + j] = dot_op<kBf16>(wd);
      if (kDual) {
        const float ws = sp[d.o_ws + i];
        smem[S.wsT + j * S.lds + l] = l < L ? dot_op<kBf16>(ws) : ws;
        if (l < L) smem[S.ws + l * S.ldg + j] = dot_op<kBf16>(ws);
      }
    }
  }
  for (int b = tid; b < B; b += kThreads) {
    smem[S.x0 + b * S.ldx + D] = 1.0f;
    smem[S.x1 + b * S.ldx + D] = 1.0f;
    smem[S.s + b * S.lds + L] = 1.0f;
  }
  if (tid < L) smem[S.sd + tid] = expf(smem[S.p + d.o_ep + tid] * 0.5f);

  const float inv_b = 1.0f / static_cast<float>(B);
  const bool row_warp = warp < kRowWarps;
  const int pt = tid - kRowWarps * 32;  // index among the noise lanes
  const int np = kThreads - kRowWarps * 32;
  const bool noise = !(skip & kSkipNoise) && !(skip & kSkipWork);
  const bool do_rows = !(skip & kSkipRows) && !(skip & kSkipWork);
  const bool params = !(skip & kSkipParams) && !(skip & kSkipWork);
  const bool scalars = !(skip & kSkipWork);

  // step 0's noise into buffer 0
  if (!row_warp && noise) draw_noise<kDual, kBf16>(smem, 0, 0, 0, r.step0, pt, np);
  __syncthreads();
  if (!row_warp && noise) draw_noise<kDual, kBf16>(smem, 0, 1, 0, r.step0, pt, np);
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
      if (do_rows) row_pass<kDual, kBf16>(smem, S, d, k, tid / kGroup, tid % kGroup, noise_sd, c_gy, inv_b);
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
    if (row_warp) {
      if (params)
        param_pass<kDual, kBf16>(smem, S, d, k, tid / kTeam, tid % kTeam, lr, moments_bf16 != 0,
                                 bc1, bc2);
    } else {
      if (warp == kScalarWarp && scalars) {
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        for (int b = lane; b < B; b += 32) {
          const float* pr = smem + S.part + 3 * b;
          s0 += pr[0];
          s1 += pr[1];
          s2 += pr[2];
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
      if (ahead && noise) draw_noise<kDual, kBf16>(smem, k ^ 1, 1, it + 1, next, pt, np);
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

size_t row_smem_bytes(int B, const Row& r, bool dual) {
  return static_cast<size_t>(plan(B, r.D, r.L, r.id, r.dd, dual).total) * sizeof(float);
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

size_t linear_vae_smem_bytes(int B, int D, int L, int id, int dd, int dual) {
  return static_cast<size_t>(plan(B, D, L, id, dd, dual != 0).total) * sizeof(float);
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
  return launch_rows(row, nullptr, 1, row_smem_bytes(B, row, dual != 0), n_steps, B, dual,
                     eps_const, tdv, lr, moments_bf16, bf16_dots, 0, stream);
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
    const size_t b = row_smem_bytes(B, rows_host[i], dual != 0);
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
