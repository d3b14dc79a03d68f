// Fused multi-step linear-VAE training kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel vae_training_tpu/kernels/linear_vae.py:_make_kernel
// (launched by run_fused_chunk, linear_vae.py:678) in solo mode on the
// linear_gaussian dataset (dataset_kind="linear", dual=False). One launch
// runs K training steps; per step:
//
//   Philox4x32-10 -> Box-Muller normals -> x = pad(n·Aᵀ) (+ obs noise)
//   -> mu = x·We + be -> s = mu + e^{ep/2}·z1 -> y = s·Wd + bd + z2·e^{ε/2}
//   -> closed-form ELBO into losses[step] -> analytic gradients
//   -> bias-corrected Adam (optax.adam's formula)
//
// What bounds it on this card: latency, not FLOPs or bytes. The slice's
// step (batch 100, D=12, L=20) is ~30 kFLOP spread over eight dependent
// phases, and step i+1 needs step i's parameters, so the chunk is serial.
// The design keeps the whole state (params, Adam m and v, ~6.4 KB at the
// slice's shapes) and every per-step activation in one CTA's shared memory
// for the whole chunk: device memory is touched once per chunk, and a step
// costs eight __syncthreads-separated phases on one SM. The products are
// FMA loops in which each thread owns output elements (no tensor cores),
// and every reduction has a fixed order (no atomics), so runs repeat
// bitwise and a resumed run equals an uninterrupted one. One CTA per sweep
// row (the grid mode, K6) is what will fill the other SMs.
//
// The TPU kernel's 128-lane padding, row/column masks, live-row slicing and
// packed lane-window noise are layout devices of the TPU and are not carried
// over: everything here works in true dimensions.
//
// The random numbers are the counters of vae_training_tpu_torch/ops/rng.py:
// key = the 64-bit run seed, counter = (absolute step, row, draw, stream).
// This kernel reproduces that module's words bitwise (precise logf/sincosf;
// build without --use_fast_math).
//
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv2p24 = 5.9604644775390625e-08f;

// ops/rng.py stream ids
constexpr uint32_t kStreamManifold = 0;
constexpr uint32_t kStreamZ1 = 1;
constexpr uint32_t kStreamZ2 = 2;
constexpr uint32_t kStreamObs = 3;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return (static_cast<float>(w >> 8) + 0.5f) * kInv2p24;
}

// Four normals from one word quadruple: Box-Muller on words (0,1) and (2,3).
__device__ __forceinline__ void box_muller4(uint4 w, float out[4]) {
  float sn, cs;
  float r = sqrtf(-2.0f * logf(uniform24(w.x)));
  sincosf(kTwoPi * uniform24(w.y), &sn, &cs);
  out[0] = r * cs;
  out[1] = r * sn;
  r = sqrtf(-2.0f * logf(uniform24(w.z)));
  sincosf(kTwoPi * uniform24(w.w), &sn, &cs);
  out[2] = r * cs;
  out[3] = r * sn;
}

// Flat parameter layout (shared with kernels/linear_vae.py:param_layout):
// [We (D×L) | be (L) | Wd (L×D) | bd (D) | epsilon_p (L) | epsilon (1)]
__host__ __device__ inline int n_params(int D, int L) { return 2 * D * L + 2 * L + D + 1; }

__host__ __device__ inline size_t smem_floats(int B, int D, int L, int id, int dd) {
  return 4 * static_cast<size_t>(n_params(D, L))      // params, m, v, grads
         + static_cast<size_t>(dd) * id + L            // A, e^{ep/2}
         + static_cast<size_t>(B) * (id + 4 * L + 3 * D)  // n, z1, z2, x, mu, s, g_y, g_s
         + 3 * kWarps;                                 // reduction scratch
}

__global__ void __launch_bounds__(kThreads, 1) linear_vae_chunk_kernel(
    float* __restrict__ g_p, float* __restrict__ g_m, float* __restrict__ g_v,
    float* __restrict__ losses, const float* __restrict__ g_a,
    const float* __restrict__ ext_x, const float* __restrict__ ext_z1,
    const float* __restrict__ ext_z2, int n_steps, int B, int D, int L, int id,
    int dd, uint32_t step0, int t0, uint32_t dk0, uint32_t dk1, uint32_t mk0,
    uint32_t mk1, float obs_scale, float eps_const, int tdv, float lr) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int P = n_params(D, L);
  const int o_be = D * L;
  const int o_wd = o_be + L;
  const int o_bd = o_wd + L * D;
  const int o_ep = o_bd + D;
  const int o_eps = o_ep + L;

  float* sp = smem;           // params
  float* sm = sp + P;         // Adam m
  float* sv = sm + P;         // Adam v
  float* sg = sv + P;         // gradients
  float* sA = sg + P;         // A (dd × id)
  float* sd = sA + dd * id;   // e^{ep/2} (L)
  float* nz = sd + L;         // intrinsic normals (B × id)
  float* z1 = nz + B * id;    // (B × L)
  float* z2 = z1 + B * L;     // (B × D)
  float* x = z2 + B * D;      // (B × D)
  float* mu = x + B * D;      // (B × L); becomes g_mu in the backward
  float* s = mu + B * L;      // (B × L)
  float* gy = s + B * L;      // (B × D): r = y − x, then g_y
  float* gs = gy + B * D;     // (B × L)
  float* red = gs + B * L;    // 3 × kWarps partial sums

  for (int i = tid; i < P; i += kThreads) {
    sp[i] = g_p[i];
    sm[i] = g_m[i];
    sv[i] = g_v[i];
  }
  for (int i = tid; i < dd * id; i += kThreads) sA[i] = g_a[i];
  __syncthreads();

  const float inv_b = 1.0f / static_cast<float>(B);
  const bool external = ext_x != nullptr;
  const bool obs = obs_scale > 0.0f;
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

    // --- 2. manifold sample: x = pad(n·Aᵀ) (+ the noise already in x) -------
    if (!external) {
      for (int i = tid; i < B * D; i += kThreads) {
        const int b = i / D;
        const int j = i - b * D;
        float acc = 0.0f;
        if (j < dd) {
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

    // --- 4. decoder + output noise; residual r = y − x ---------------------
    const float eps = tdv ? sp[o_eps] * eps_const : eps_const;
    const float noise_sd = expf(eps * 0.5f);
    const float inv_var = expf(-eps);
    for (int i = tid; i < B * D; i += kThreads) {
      const int b = i / D;
      const int j = i - b * D;
      float acc = 0.0f;
      for (int l = 0; l < L; ++l) acc = fmaf(s[b * L + l], sp[o_wd + l * D + j], acc);
      const float y = (acc + sp[o_bd + j]) + z2[i] * noise_sd;
      gy[i] = y - x[i];
    }
    __syncthreads();

    // --- 5. Σmu², Σr², Σr·z2 (fixed order); g_y = r·inv_var/B in place -----
    const float c_gy = inv_var * inv_b;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int i = tid; i < B * L; i += kThreads) a0 = fmaf(mu[i], mu[i], a0);
    for (int i = tid; i < B * D; i += kThreads) {
      const float r = gy[i];
      a1 = fmaf(r, r, a1);
      a2 = fmaf(r, z2[i], a2);
      gy[i] = r * c_gy;
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

    // --- 6. g_Wd = sᵀ·g_y, g_bd = Σ_b g_y, g_s = g_y·Wdᵀ, g_mu = g_s + mu/B -
    const int n6 = L * D + D + B * L;
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
      } else {
        const int k = i - L * D - D;
        const int b = k / L;
        const int l = k - b * L;
        float acc = 0.0f;
        for (int j = 0; j < D; ++j) acc = fmaf(gy[b * D + j], sp[o_wd + l * D + j], acc);
        gs[k] = acc;
        mu[k] = acc + mu[k] * inv_b;
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
    // t, so chunk boundaries cannot change it.
    const double t = static_cast<double>(t0 + it + 1);
    const float bc1 = static_cast<float>(1.0 - pow(0.9, t));
    const float bc2 = static_cast<float>(1.0 - pow(0.999, t));
    for (int i = tid; i < P; i += kThreads) {
      const float g = sg[i];
      const float m_ = kB1 * sm[i] + kOneMinusB1 * g;
      const float v_ = kB2 * sv[i] + kOneMinusB2 * g * g;
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

}  // namespace

extern "C" {

size_t linear_vae_smem_bytes(int B, int D, int L, int id, int dd) {
  return smem_floats(B, D, L, id, dd) * sizeof(float);
}

const char* linear_vae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int linear_vae_chunk(float* p, float* m, float* v, float* losses, const float* a,
                     const float* ext_x, const float* ext_z1, const float* ext_z2,
                     int n_steps, int B, int D, int L, int id, int dd,
                     unsigned int step0, int t0, unsigned int dk0, unsigned int dk1,
                     unsigned int mk0, unsigned int mk1, float obs_scale,
                     float eps_const, int tdv, float lr, void* stream) {
  const size_t bytes = linear_vae_smem_bytes(B, D, L, id, dd);
  cudaError_t err = cudaFuncSetAttribute(
      linear_vae_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_vae_chunk_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      p, m, v, losses, a, ext_x, ext_z1, ext_z2, n_steps, B, D, L, id, dd, step0,
      t0, dk0, dk1, mk0, mk1, obs_scale, eps_const, tdv, lr);
  return static_cast<int>(cudaGetLastError());
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
