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
// moments_bf16, the Adam stage rounds each weight-matrix slot's new m and v
// (We, Wd and, dual, Ws) to bfloat16, round to nearest even, every step, and
// the update reads the rounded values; vector slots keep f32 moments. The
// state stays float32 in shared and device memory, holding values bfloat16
// represents exactly, so the wrapper's buffers and the Row table are the
// f32 mode's. It adds four conversions a matrix element a step and moves no
// byte off the critical path.
//
// K2's σ applies to every one of the D output columns, padding columns
// included, as the flax model applies it (networks.py:78-79); the TPU
// kernel's mask removes only its lanes beyond D.
//
// What bounds it on this card: latency, not FLOPs or bytes. The linear
// sweep's row 1 (batch 100, D=12, L=20) is 248 kFLOP a step (five
// 48-kFLOP products, the manifold draw, 12 FLOP a parameter for Adam)
// spread over eight dependent phases, and step i+1 needs step i's
// parameters, so the chunk is serial. The design keeps a row's whole state
// (params, Adam m and v, ~6.4 KB at row 1) and every per-step activation in
// one CTA's shared memory for the whole chunk: device memory is touched
// once per chunk, and a step costs eight __syncthreads-separated phases on
// one SM. The products are FMA loops in which each thread owns output
// elements (no tensor cores), and every reduction has a fixed order (no
// atomics), so runs repeat bitwise and a resumed run equals an
// uninterrupted one.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)

// Flat parameter layout (shared with kernels/linear_vae.py:param_layout):
// [We (D×L) | be (L) | Wd (L×D) | bd (D) | epsilon_p (L) | epsilon (1)]
// and, with the dual decoder only, after them [Ws (L×D) | bs (D)].
__host__ __device__ inline int n_params(int D, int L, bool dual) {
  return 2 * D * L + 2 * L + D + 1 + (dual ? L * D + D : 0);
}

// The manifold matrix: A (dd × id) for linear_gaussian; the column a (dd)
// for the sigmoid dataset, whose intrinsic draw is id = dd wide.
__host__ __device__ inline size_t smem_floats(int B, int D, int L, int id, int dd,
                                              bool dual) {
  return 4 * static_cast<size_t>(n_params(D, L, dual))  // params, m, v, grads
         + static_cast<size_t>(dual ? dd : dd * id) + L  // A, e^{ep/2}
         + static_cast<size_t>(B) * (id + 4 * L + 3 * D)  // n, z1, z2, x, mu, s, g_y, g_s
         + (dual ? static_cast<size_t>(B) * D : 0)        // σ(u), then g_u
         + 3 * kWarps;                                   // reduction scratch
}

__device__ __forceinline__ float sigmoidf(float u) { return 1.0f / (1.0f + expf(-u)); }

// x rounded to the nearest bfloat16 (ties to even), back as a float.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One row's K-step chunk, run by one CTA. The only body of the kernel: solo
// and grid launches differ in where the block reads its Row, nothing else.
template <bool kDual>
__device__ __forceinline__ void train_row(
    float* __restrict__ g_p, float* __restrict__ g_m, float* __restrict__ g_v,
    float* __restrict__ losses, const float* __restrict__ g_a,
    const float* __restrict__ ext_x, const float* __restrict__ ext_z1,
    const float* __restrict__ ext_z2, int n_steps, int B, int D, int L, int id,
    int dd, uint32_t step0, int t0, uint32_t dk0, uint32_t dk1, uint32_t mk0,
    uint32_t mk1, float obs_scale, float eps_const, int tdv, float lr, int moments_bf16) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int P = n_params(D, L, kDual);
  const int o_be = D * L;
  const int o_wd = o_be + L;
  const int o_bd = o_wd + L * D;
  const int o_ep = o_bd + D;
  const int o_eps = o_ep + L;
  const int o_ws = o_eps + 1;   // dual only
  const int o_bs = o_ws + L * D;  // dual only
  const int n_a = kDual ? dd : dd * id;

  float* sp = smem;           // params
  float* sm = sp + P;         // Adam m
  float* sv = sm + P;         // Adam v
  float* sg = sv + P;         // gradients
  float* sA = sg + P;         // A (dd × id), or the column a (dd)
  float* sd = sA + n_a;       // e^{ep/2} (L)
  float* nz = sd + L;         // intrinsic normals (B × id)
  float* z1 = nz + B * id;    // (B × L)
  float* z2 = z1 + B * L;     // (B × D)
  float* x = z2 + B * D;      // (B × D)
  float* mu = x + B * D;      // (B × L); becomes g_mu in the backward
  float* s = mu + B * L;      // (B × L)
  float* gy = s + B * L;      // (B × D): r = y − x, then g_y
  float* gs = gy + B * D;     // (B × L)
  float* su = gs + B * L;     // dual: (B × D) σ(u), then g_u
  float* red = su + (kDual ? B * D : 0);  // 3 × kWarps partial sums

  for (int i = tid; i < P; i += kThreads) {
    sp[i] = g_p[i];
    sm[i] = g_m[i];
    sv[i] = g_v[i];
  }
  for (int i = tid; i < n_a; i += kThreads) sA[i] = g_a[i];
  __syncthreads();

  const float inv_b = 1.0f / static_cast<float>(B);
  const bool external = ext_x != nullptr;
  const bool obs = !kDual && obs_scale > 0.0f;
  const int nw_int = (id + 3) / 4;
  const int nw_l = (L + 3) / 4;
  const int nw_d = (D + 3) / 4;
  const int per_row = nw_int + nw_l + nw_d + (obs ? nw_d : 0);

  for (int it = 0; it < n_steps; ++it) {
    const uint32_t step = step0 + static_cast<uint32_t>(it);

    // --- 1. noise: n, z1, z2 (and scaled observation noise into x) ---------
    if (external) {
      const float* ex = ext_x + static_cast<size_t>(it) * B * D;
      const float* e1 = ext_z1 + static_cast<size_t>(it) * B * L;
      const float* e2 = ext_z2 + static_cast<size_t>(it) * B * D;
      for (int i = tid; i < B * D; i += kThreads) {
        x[i] = ex[i];
        z2[i] = e2[i];
      }
      for (int i = tid; i < B * L; i += kThreads) z1[i] = e1[i];
    } else {
      for (int item = tid; item < B * per_row; item += kThreads) {
        const int b = item / per_row;
        int j = item - b * per_row;
        uint32_t stream, k0, k1;
        float* dst;
        int dim;
        if (j < nw_int) {
          stream = kStreamManifold; k0 = dk0; k1 = dk1; dst = nz + b * id; dim = id;
        } else if (j < nw_int + nw_l) {
          j -= nw_int;
          stream = kStreamZ1; k0 = mk0; k1 = mk1; dst = z1 + b * L; dim = L;
        } else if (j < nw_int + nw_l + nw_d) {
          j -= nw_int + nw_l;
          stream = kStreamZ2; k0 = mk0; k1 = mk1; dst = z2 + b * D; dim = D;
        } else {
          j -= nw_int + nw_l + nw_d;
          stream = kStreamObs; k0 = dk0; k1 = dk1; dst = x + b * D; dim = D;
        }
        float n[4];
        box_muller4(philox4x32_10(make_uint4(step, static_cast<uint32_t>(b),
                                             static_cast<uint32_t>(j), stream),
                                  k0, k1),
                    n);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * j + q;
          if (k < dim) dst[k] = stream == kStreamObs ? n[q] * obs_scale : n[q];
        }
      }
    }
    if (tid < L) sd[tid] = expf(sp[o_ep + tid] * 0.5f);
    __syncthreads();

    // --- 2. manifold sample: x = pad(n·Aᵀ) (+ the noise already in x); ---
    //        dual: x = [n, σ(n·a), 0]
    if (!external) {
      for (int i = tid; i < B * D; i += kThreads) {
        const int b = i / D;
        const int j = i - b * D;
        float acc = 0.0f;
        if (kDual) {
          if (j < dd) {
            acc = nz[b * id + j];
          } else if (j == dd) {
            for (int k = 0; k < dd; ++k) acc = fmaf(nz[b * id + k], sA[k], acc);
            acc = sigmoidf(acc);
          }
        } else if (j < dd) {
          for (int k = 0; k < id; ++k) acc = fmaf(nz[b * id + k], sA[j * id + k], acc);
        }
        x[i] = obs ? acc + x[i] : acc;
      }
      __syncthreads();
    }

    // --- 3. encoder + reparameterisation -----------------------------------
    for (int i = tid; i < B * L; i += kThreads) {
      const int b = i / L;
      const int l = i - b * L;
      float acc = 0.0f;
      for (int j = 0; j < D; ++j) acc = fmaf(x[b * D + j], sp[j * L + l], acc);
      const float m_ = acc + sp[o_be + l];
      mu[i] = m_;
      s[i] = m_ + sd[l] * z1[i];
    }
    __syncthreads();

    // --- 4. decoder (+ σ(s·Ws + bs)) + output noise; residual r = y − x -----
    const float eps = tdv ? sp[o_eps] * eps_const : eps_const;
    const float noise_sd = expf(eps * 0.5f);
    const float inv_var = expf(-eps);
    for (int i = tid; i < B * D; i += kThreads) {
      const int b = i / D;
      const int j = i - b * D;
      float acc = 0.0f, acc_s = 0.0f;
      for (int l = 0; l < L; ++l) {
        acc = fmaf(s[b * L + l], sp[o_wd + l * D + j], acc);
        if (kDual) acc_s = fmaf(s[b * L + l], sp[o_ws + l * D + j], acc_s);
      }
      float x_hat = acc + sp[o_bd + j];
      if (kDual) {
        const float sig = sigmoidf(acc_s + sp[o_bs + j]);
        su[i] = sig;
        x_hat = sig + x_hat;
      }
      gy[i] = (x_hat + z2[i] * noise_sd) - x[i];
    }
    __syncthreads();

    // --- 5. Σmu², Σr², Σr·z2 (fixed order); g_y = r·inv_var/B in place; ---
    //        dual: g_u = g_y·σ(u)(1 − σ(u)) in place of σ(u)
    const float c_gy = inv_var * inv_b;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int i = tid; i < B * L; i += kThreads) a0 = fmaf(mu[i], mu[i], a0);
    for (int i = tid; i < B * D; i += kThreads) {
      const float r = gy[i];
      a1 = fmaf(r, r, a1);
      a2 = fmaf(r, z2[i], a2);
      const float g = r * c_gy;
      gy[i] = g;
      if (kDual) su[i] = g * su[i] * (1.0f - su[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_down_sync(0xffffffffu, a0, off);
      a1 += __shfl_down_sync(0xffffffffu, a1, off);
      a2 += __shfl_down_sync(0xffffffffu, a2, off);
    }
    if (lane == 0) {
      red[warp] = a0;
      red[kWarps + warp] = a1;
      red[2 * kWarps + warp] = a2;
    }
    __syncthreads();
    if (tid == 0) {
      float sum_mu2 = 0.0f, sum_r2 = 0.0f, sum_rz2 = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        sum_mu2 += red[w];
        sum_r2 += red[kWarps + w];
        sum_rz2 += red[2 * kWarps + w];
      }
      float kl_const = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float ep = sp[o_ep + l];
        kl_const += -0.5f * (1.0f + ep - expf(ep));
      }
      losses[it] = kl_const + 0.5f * inv_b * sum_mu2 +
                   0.5f * inv_var * inv_b * sum_r2 +
                   static_cast<float>(D) * (0.5f * (kLog2Pi + eps));
      // d loss / d epsilon (the learned scale) under -tdv
      const float g_eps = -0.5f * inv_var * inv_b * sum_r2 + 0.5f * static_cast<float>(D) +
                          (c_gy * sum_rz2) * 0.5f * noise_sd;
      sg[o_eps] = tdv ? g_eps * eps_const : 0.0f;
    }

    // --- 6. g_Wd = sᵀ·g_y, g_bd = Σ_b g_y, g_s = g_y·Wdᵀ (+ g_u·Wsᵀ), ----
    //        g_mu = g_s + mu/B; dual: g_Ws = sᵀ·g_u, g_bs = Σ_b g_u
    const int n6 = L * D + D + B * L + (kDual ? L * D + D : 0);
    for (int i = tid; i < n6; i += kThreads) {
      if (i < L * D) {
        const int l = i / D;
        const int j = i - l * D;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc = fmaf(s[b * L + l], gy[b * D + j], acc);
        sg[o_wd + i] = acc;
      } else if (i < L * D + D) {
        const int j = i - L * D;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc += gy[b * D + j];
        sg[o_bd + j] = acc;
      } else if (i < L * D + D + B * L) {
        const int k = i - L * D - D;
        const int b = k / L;
        const int l = k - b * L;
        float acc = 0.0f;
        for (int j = 0; j < D; ++j) acc = fmaf(gy[b * D + j], sp[o_wd + l * D + j], acc);
        if (kDual) {
          float acc_s = 0.0f;
          for (int j = 0; j < D; ++j) acc_s = fmaf(su[b * D + j], sp[o_ws + l * D + j], acc_s);
          acc = acc + acc_s;
        }
        gs[k] = acc;
        mu[k] = acc + mu[k] * inv_b;
      } else if (i < 2 * L * D + D + B * L) {
        const int k = i - L * D - D - B * L;
        const int l = k / D;
        const int j = k - l * D;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc = fmaf(s[b * L + l], su[b * D + j], acc);
        sg[o_ws + k] = acc;
      } else {
        const int j = i - 2 * L * D - D - B * L;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc += su[b * D + j];
        sg[o_bs + j] = acc;
      }
    }
    __syncthreads();

    // --- 7. g_We = xᵀ·g_mu, g_be = Σ_b g_mu, g_ep ---------------------------
    const int n7 = D * L + 2 * L;
    for (int i = tid; i < n7; i += kThreads) {
      if (i < D * L) {
        const int j = i / L;
        const int l = i - j * L;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc = fmaf(x[b * D + j], mu[b * L + l], acc);
        sg[i] = acc;
      } else if (i < D * L + L) {
        const int l = i - D * L;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc += mu[b * L + l];
        sg[o_be + l] = acc;
      } else {
        const int l = i - D * L - L;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc = fmaf(gs[b * L + l], z1[b * L + l], acc);
        const float ep = sp[o_ep + l];
        sg[o_ep + l] = acc * 0.5f * sd[l] + 0.5f * (expf(ep) - 1.0f);
      }
    }
    __syncthreads();

    // --- 8. Adam (optax.adam: bias-corrected m̂/(√v̂ + eps)) -----------------
    // bias corrections 1 − βᵗ in double, rounded once to float: float
    // powf(0.999f, t) carries 0.999f's rounding (~1e-5 relative in 1 − β₂ᵗ
    // at t ≈ 60), a systematic bias in every step size. A pure function of
    // t, so chunk boundaries cannot change it. bf16 moments: the matrix
    // slots' m and v are rounded before the update reads them (K4).
    const double t = static_cast<double>(t0 + it + 1);
    const float bc1 = static_cast<float>(1.0 - pow(0.9, t));
    const float bc2 = static_cast<float>(1.0 - pow(0.999, t));
    for (int i = tid; i < P; i += kThreads) {
      const float g = sg[i];
      float m_ = kB1 * sm[i] + kOneMinusB1 * g;
      float v_ = kB2 * sv[i] + kOneMinusB2 * g * g;
      if (moments_bf16 &&
          (i < o_be || (i >= o_wd && i < o_bd) || (kDual && i >= o_ws && i < o_bs))) {
        m_ = bf16_rn(m_);
        v_ = bf16_rn(v_);
      }
      sm[i] = m_;
      sv[i] = v_;
      sp[i] -= lr * ((m_ / bc1) / (sqrtf(v_ / bc2) + kAdamEps));
    }
    __syncthreads();
  }

  for (int i = tid; i < P; i += kThreads) {
    g_p[i] = sp[i];
    g_m[i] = sm[i];
    g_v[i] = sv[i];
  }
}

// Solo launches pass their one row by value (rows == nullptr); grid
// launches (K6a) pass the device table, one row per block.
template <bool kDual>
__global__ void __launch_bounds__(kThreads, 1) linear_vae_chunk_kernel(
    Row solo, const Row* __restrict__ rows, int n_steps, int B, float eps_const, int tdv,
    float lr, int moments_bf16) {
  const Row r = rows != nullptr ? rows[blockIdx.x] : solo;
  train_row<kDual>(r.p, r.m, r.v, r.losses, r.a, r.ext_x, r.ext_z1, r.ext_z2, n_steps, B,
                   r.D, r.L, r.id, r.dd, r.step0, r.t0, r.dk0, r.dk1, r.mk0, r.mk1,
                   r.obs_scale, eps_const, tdv, lr, moments_bf16);
}

// Raw sampler output for the bitwise check against ops/rng.py: words and
// normals at counters (step, row, draw, stream), laid out (rows, n_draws, 4).
__global__ void philox_normals_kernel(uint32_t* __restrict__ words,
                                      float* __restrict__ normals, int rows,
                                      int n_draws, uint32_t step, uint32_t stream,
                                      uint32_t k0, uint32_t k1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * n_draws) return;
  const int r = i / n_draws;
  const int j = i - r * n_draws;
  const uint4 w = philox4x32_10(
      make_uint4(step, static_cast<uint32_t>(r), static_cast<uint32_t>(j), stream), k0, k1);
  words[4 * i + 0] = w.x;
  words[4 * i + 1] = w.y;
  words[4 * i + 2] = w.z;
  words[4 * i + 3] = w.w;
  float n[4];
  box_muller4(w, n);
  for (int q = 0; q < 4; ++q) normals[4 * i + q] = n[q];
}

size_t row_smem_bytes(int B, const Row& r, bool dual) {
  return smem_floats(B, r.D, r.L, r.id, r.dd, dual) * sizeof(float);
}

template <bool kDual>
int launch(const Row& solo, const Row* rows, int n_rows, size_t bytes, int n_steps, int B,
           float eps_const, int tdv, float lr, int moments_bf16, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(linear_vae_chunk_kernel<kDual>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_vae_chunk_kernel<kDual>
      <<<n_rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          solo, rows, n_steps, B, eps_const, tdv, lr, moments_bf16);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const Row& solo, const Row* rows, int n_rows, size_t bytes, int n_steps,
                int B, int dual, float eps_const, int tdv, float lr, int moments_bf16,
                void* stream) {
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  return dual ? launch<true>(solo, rows, n_rows, bytes, n_steps, B, eps_const, tdv, lr,
                             moments_bf16, stream)
              : launch<false>(solo, rows, n_rows, bytes, n_steps, B, eps_const, tdv, lr,
                              moments_bf16, stream);
}

}  // namespace

extern "C" {

size_t linear_vae_smem_bytes(int B, int D, int L, int id, int dd, int dual) {
  return smem_floats(B, D, L, id, dd, dual != 0) * sizeof(float);
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
                     float eps_const, int tdv, float lr, int moments_bf16, void* stream) {
  const Row row{p, m, v, losses, a, ext_x, ext_z1, ext_z2, D, L, id, dd,
                step0, t0, dk0, dk1, mk0, mk1, obs_scale};
  return launch_rows(row, nullptr, 1, row_smem_bytes(B, row, dual != 0), n_steps, B, dual,
                     eps_const, tdv, lr, moments_bf16, stream);
}

// K6a: ``n_rows`` rows in one launch, one block each. ``rows_host`` and
// ``rows_dev`` hold the same table; the host copy sizes the launch's
// shared memory to its largest row.
int linear_vae_grid_chunk(const Row* rows_host, const Row* rows_dev, int n_rows, int n_steps,
                          int B, int dual, float eps_const, int tdv, float lr,
                          int moments_bf16, void* stream) {
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  for (int i = 0; i < n_rows; ++i) {
    const size_t b = row_smem_bytes(B, rows_host[i], dual != 0);
    if (b > bytes) bytes = b;
  }
  return launch_rows(Row{}, rows_dev, n_rows, bytes, n_steps, B, dual, eps_const, tdv, lr,
                     moments_bf16, stream);
}

// How many blocks of the kernel one SM can hold at ``bytes`` of dynamic
// shared memory (the grid mode asks whether rows share SMs).
int linear_vae_blocks_per_sm(int dual, size_t bytes, int* blocks) {
  const auto kernel = dual ? linear_vae_chunk_kernel<true> : linear_vae_chunk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, bytes));
}

int philox_normals(unsigned int* words, float* normals, int rows, int n_draws,
                   unsigned int step, unsigned int stream_id, unsigned int k0,
                   unsigned int k1, void* stream) {
  const int n = rows * n_draws;
  const int blocks = (n + kThreads - 1) / kThreads;
  philox_normals_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, normals, rows, n_draws, step, stream_id, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
