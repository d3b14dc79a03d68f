// Fused multi-step MLP-VAE training kernel for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel vae_training_tpu/kernels/mlp_vae.py:_make_kernel
// (launched by run_mlp_fused_chunk, mlp_vae.py:644) in solo mode, for the
// sphere and linear_gaussian manifolds with one decoder (dual=False). One
// launch runs K training steps of a VAE whose encoder and decoder are ReLU
// stacks; per step:
//
//   Philox4x32-10 -> Box-Muller normals -> x (sphere: n·rsqrt(max(Σn², 1e-20));
//   linear_gaussian: pad(n·Aᵀ) + obs noise) -> encoder stack -> mu
//   -> s = mu + e^{ep/2}·z1 -> decoder stack -> y = x̂ + z2·e^{ε/2}
//   -> closed-form ELBO into losses[step] -> backward through every layer
//   (ReLU masks from the saved activations, a > 0) -> bias-corrected Adam
//
// What bounds it on this card: latency. At the sphere sweep's shapes
// (batch 100, 200|200|200 on both stacks, D = L = 6) a step is ~99 MFLOP in
// 16 dependent layer phases, ~1.5 µs of the card's fp32 peak, and step i+1
// needs step i's parameters. The state (p, m, v and the gradients: 4 × 166k
// floats, 2.7 MB) does not fit one SM's 227 KB of shared memory, so the
// design is one persistent cooperative launch per chunk: one block per SM,
// the state in the caller's device buffers (L2-resident: 50 MB of L2) and
// the activations in one scratch buffer, each dependent phase a grid-stride
// loop in which one thread owns one output element and runs a fixed-order
// FMA loop, phases separated by grid-wide barriers (17 a step at 3+3 hidden
// layers). Sums across the batch that feed the loss are taken by block 0
// alone in a fixed order: no atomics, and no result depends on the grid
// size, so a 40-step launch equals a 15 + 25 split bitwise and --resume is
// bitwise. Tensor cores, clusters with distributed shared memory and fewer
// barriers are later work.
//
// True dimensions throughout: the TPU kernel's 128-lane padding, masks and
// live-row slicing are layout devices of the TPU and are not carried over.
//
// Loads of the state and the scratch go through plain (coherent) global
// loads: those buffers change during the launch, so no pointer to them is
// const __restrict__ (which would allow the non-coherent read-only path).
//
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace philox;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;  // Dense layers per stack
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;

constexpr int kSphere = 0;
constexpr int kLinear = 1;

// One ReLU stack: widths[0] is its input, widths[n] its output. Parameter
// offsets index the flat state buffers; act[li] (li < n − 1) is the scratch
// offset of hidden layer li's post-ReLU output (B × widths[li + 1]).
struct Stack {
  int n;
  int widths[kMaxLayers + 1];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int act[kMaxLayers];
};

struct Args {
  float* p;
  float* m;
  float* v;
  float* losses;
  float* scratch;
  const float* a;  // linear_gaussian: A (dd × id)
  const float* ext_x;
  const float* ext_z1;
  const float* ext_z2;
  int n_steps, B, D, L, id, dd, kind;
  uint32_t step0;
  int t0;
  uint32_t dk0, dk1, mk0, mk1;
  float obs_scale, eps_const;
  int tdv;
  float lr;
  int P, o_ep, o_eps;
  Stack enc, dec;
  // scratch offsets (floats)
  int s_g, s_nz, s_x, s_z1, s_z2, s_mu, s_s, s_r, s_gs, s_gmu, s_buf[2];
};

// Fills the parameter and scratch offsets of `A` from the stacks' widths;
// returns the scratch size in floats, or −1 if an offset would overflow int.
long long plan(Args& A) {
  long long off = 0;
  Stack* stacks[2] = {&A.enc, &A.dec};
  for (Stack* st : stacks) {
    for (int li = 0; li < st->n; ++li) {
      st->w_off[li] = static_cast<int>(off);
      off += static_cast<long long>(st->widths[li]) * st->widths[li + 1];
      st->b_off[li] = static_cast<int>(off);
      off += st->widths[li + 1];
    }
  }
  A.o_ep = static_cast<int>(off);
  A.o_eps = A.o_ep + A.L;
  A.P = A.o_eps + 1;
  const long long B = A.B;
  long long s = 0;
  auto take = [&s](long long n) {
    const long long at = s;
    s += n;
    return static_cast<int>(at);
  };
  A.s_g = take(A.P);
  A.s_nz = take(B * A.id);
  A.s_x = take(B * A.D);
  A.s_z1 = take(B * A.L);
  A.s_z2 = take(B * A.D);
  long long hidden = 1;
  for (int li = 0; li + 1 < A.enc.n; ++li) {
    A.enc.act[li] = take(B * A.enc.widths[li + 1]);
    hidden = hidden > A.enc.widths[li + 1] ? hidden : A.enc.widths[li + 1];
  }
  A.s_mu = take(B * A.L);
  A.s_s = take(B * A.L);
  for (int li = 0; li + 1 < A.dec.n; ++li) {
    A.dec.act[li] = take(B * A.dec.widths[li + 1]);
    hidden = hidden > A.dec.widths[li + 1] ? hidden : A.dec.widths[li + 1];
  }
  A.s_r = take(B * A.D);
  A.s_gs = take(B * A.L);
  A.s_gmu = take(B * A.L);
  A.s_buf[0] = take(B * hidden);
  A.s_buf[1] = take(B * hidden);
  return (off > INT_MAX || s > INT_MAX) ? -1 : s;
}

// --- the per-step phases ---------------------------------------------------

// x, z1, z2 of step `it` into the scratch (the external hook copies them).
__device__ void sample_phase(const Args& A, int it, int gtid, int gsz) {
  float* S = A.scratch;
  float* x = S + A.s_x;
  float* z1 = S + A.s_z1;
  float* z2 = S + A.s_z2;
  const int B = A.B, D = A.D, L = A.L;
  if (A.ext_x != nullptr) {
    const size_t o_d = static_cast<size_t>(it) * B * D;
    const size_t o_l = static_cast<size_t>(it) * B * L;
    for (int i = gtid; i < B * D; i += gsz) {
      x[i] = A.ext_x[o_d + i];
      z2[i] = A.ext_z2[o_d + i];
    }
    for (int i = gtid; i < B * L; i += gsz) z1[i] = A.ext_z1[o_l + i];
    return;
  }
  const uint32_t step = A.step0 + static_cast<uint32_t>(it);
  const int nw_l = (L + 3) / 4;
  const int nw_d = (D + 3) / 4;
  const int n_items = B + B * (nw_l + nw_d);
  for (int item = gtid; item < n_items; item += gsz) {
    float n[4];
    if (item < B) {
      // one thread per row: the manifold draw, then that row of x
      const int b = item;
      float* nz = S + A.s_nz + b * A.id;
      for (int j = 0; 4 * j < A.id; ++j) {
        normals4(step, b, j, kStreamManifold, A.dk0, A.dk1, n);
        for (int q = 0; q < 4 && 4 * j + q < A.id; ++q) nz[4 * j + q] = n[q];
      }
      float* xr = x + b * D;
      if (A.kind == kSphere) {
        float norm2 = 0.0f;
        for (int k = 0; k < A.dd; ++k) norm2 = fmaf(nz[k], nz[k], norm2);
        const float inv = rsqrtf(fmaxf(norm2, 1e-20f));
        for (int j = 0; j < D; ++j) xr[j] = j < A.dd ? nz[j] * inv : 0.0f;
      } else {
        for (int j = 0; j < D; ++j) {
          float acc = 0.0f;
          if (j < A.dd) {
            for (int k = 0; k < A.id; ++k) acc = fmaf(nz[k], A.a[j * A.id + k], acc);
          }
          xr[j] = acc;
        }
        if (A.obs_scale > 0.0f) {
          for (int j = 0; 4 * j < D; ++j) {
            normals4(step, b, j, kStreamObs, A.dk0, A.dk1, n);
            for (int q = 0; q < 4 && 4 * j + q < D; ++q) xr[4 * j + q] += n[q] * A.obs_scale;
          }
        }
      }
    } else {
      const int k = item - B;
      const int b = k / (nw_l + nw_d);
      int j = k - b * (nw_l + nw_d);
      float* dst;
      int dim;
      uint32_t stream;
      if (j < nw_l) {
        stream = kStreamZ1; dst = z1 + b * L; dim = L;
      } else {
        j -= nw_l;
        stream = kStreamZ2; dst = z2 + b * D; dim = D;
      }
      normals4(step, b, j, stream, A.mk0, A.mk1, n);
      for (int q = 0; q < 4 && 4 * j + q < dim; ++q) dst[4 * j + q] = n[q];
    }
  }
}

// out = in·W + b over (B × dout), in (B × din). mode 0: ReLU (a hidden
// layer); mode 1: the encoder's last layer, out = mu and s = mu + e^{ep/2}·z1;
// mode 2: the decoder's last layer, out = r = (x̂ + z2·e^{ε/2}) − x.
__device__ void forward_phase(const Args& A, const float* in, int din, int w_off, int b_off,
                              float* out, int dout, int mode, float noise_sd, int gtid,
                              int gsz) {
  const float* W = A.p + w_off;
  const float* bias = A.p + b_off;
  float* S = A.scratch;
  for (int i = gtid; i < A.B * dout; i += gsz) {
    const int b = i / dout;
    const int o = i - b * dout;
    const float* row = in + b * din;
    float acc = 0.0f;
    for (int k = 0; k < din; ++k) acc = fmaf(row[k], W[k * dout + o], acc);
    const float z = acc + bias[o];
    if (mode == 0) {
      out[i] = fmaxf(z, 0.0f);
    } else if (mode == 1) {
      out[i] = z;
      S[A.s_s + i] = z + expf(A.p[A.o_ep + o] * 0.5f) * S[A.s_z1 + i];
    } else {
      out[i] = (z + S[A.s_z2 + i] * noise_sd) - S[A.s_x + i];
    }
  }
}

// One layer's backward: g_W = a_inᵀ·G, g_b = Σ_b G and, when g_in is given,
// g_in = G·Wᵀ, masked by a_in > 0 (a ReLU output) when `mask`. G is
// g_scale·g_out (g_scale turns the decoder's residual into g_y; 1 is exact
// elsewhere). With `gmu`, also gmu = g_in + mu/B (the decoder's first layer:
// g_in is g_s).
__device__ void backward_phase(const Args& A, const float* a_in, int din, int w_off, int b_off,
                               const float* g_out, float g_scale, int dout, float* g_in,
                               bool mask, float* gmu, int gtid, int gsz) {
  const int B = A.B;
  const float* W = A.p + w_off;
  float* g = A.scratch + A.s_g;
  const int n_w = din * dout;
  const int n_total = n_w + dout + (g_in != nullptr ? B * din : 0);
  for (int i = gtid; i < n_total; i += gsz) {
    if (i < n_w) {
      const int k = i / dout;
      const int o = i - k * dout;
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc = fmaf(a_in[b * din + k], g_out[b * dout + o] * g_scale, acc);
      g[w_off + i] = acc;
    } else if (i < n_w + dout) {
      const int o = i - n_w;
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc += g_out[b * dout + o] * g_scale;
      g[b_off + o] = acc;
    } else {
      const int k = i - n_w - dout;
      const int b = k / din;
      const int j = k - b * din;
      const float* grow = g_out + b * dout;
      const float* wrow = W + j * dout;
      float acc = 0.0f;
      for (int o = 0; o < dout; ++o) acc = fmaf(grow[o] * g_scale, wrow[o], acc);
      if (mask && !(a_in[k] > 0.0f)) acc = 0.0f;
      g_in[k] = acc;
      if (gmu != nullptr) gmu[k] = acc + A.scratch[A.s_mu + k] * (1.0f / static_cast<float>(B));
    }
  }
}

// Block 0: the loss of step `it` and d loss / d epsilon, from Σmu², Σr²
// and Σr·z2 taken in a fixed order (per-thread strides, then warp shuffles,
// then the warps' partials in order).
__device__ void loss_block(const Args& A, int it, float eps, float noise_sd, float inv_var) {
  __shared__ float red[3 * kWarps];
  const float* S = A.scratch;
  const int tid = threadIdx.x;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int i = tid; i < A.B * A.L; i += kThreads) a0 = fmaf(S[A.s_mu + i], S[A.s_mu + i], a0);
  for (int i = tid; i < A.B * A.D; i += kThreads) {
    const float r = S[A.s_r + i];
    a1 = fmaf(r, r, a1);
    a2 = fmaf(r, S[A.s_z2 + i], a2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a0 += __shfl_down_sync(0xffffffffu, a0, off);
    a1 += __shfl_down_sync(0xffffffffu, a1, off);
    a2 += __shfl_down_sync(0xffffffffu, a2, off);
  }
  if ((tid & 31) == 0) {
    red[tid >> 5] = a0;
    red[kWarps + (tid >> 5)] = a1;
    red[2 * kWarps + (tid >> 5)] = a2;
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
    for (int l = 0; l < A.L; ++l) {
      const float ep = A.p[A.o_ep + l];
      kl_const += -0.5f * (1.0f + ep - expf(ep));
    }
    const float inv_b = 1.0f / static_cast<float>(A.B);
    const float c_gy = inv_var * inv_b;
    A.losses[it] = kl_const + 0.5f * inv_b * sum_mu2 + 0.5f * inv_var * inv_b * sum_r2 +
                   static_cast<float>(A.D) * (0.5f * (kLog2Pi + eps));
    const float g_eps = -0.5f * inv_var * inv_b * sum_r2 + 0.5f * static_cast<float>(A.D) +
                        (c_gy * sum_rz2) * 0.5f * noise_sd;
    A.scratch[A.s_g + A.o_eps] = A.tdv ? g_eps * A.eps_const : 0.0f;
  }
}

// Adam (optax.adam: bias-corrected m̂/(√v̂ + eps)) over every parameter; the
// corrections 1 − βᵗ in double, rounded once to float, as in K1.
__device__ void adam_phase(const Args& A, int it, int gtid, int gsz) {
  const double t = static_cast<double>(A.t0 + it + 1);
  const float bc1 = static_cast<float>(1.0 - pow(0.9, t));
  const float bc2 = static_cast<float>(1.0 - pow(0.999, t));
  const float* g = A.scratch + A.s_g;
  for (int i = gtid; i < A.P; i += gsz) {
    const float gi = g[i];
    const float m_ = kB1 * A.m[i] + kOneMinusB1 * gi;
    const float v_ = kB2 * A.v[i] + kOneMinusB2 * gi * gi;
    A.m[i] = m_;
    A.v[i] = v_;
    A.p[i] -= A.lr * ((m_ / bc1) / (sqrtf(v_ / bc2) + kAdamEps));
  }
}

__global__ void __launch_bounds__(kThreads, 1) mlp_vae_chunk_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsz = gridDim.x * blockDim.x;
  float* S = A.scratch;
  const Stack& enc = A.enc;
  const Stack& dec = A.dec;
  const float inv_b = 1.0f / static_cast<float>(A.B);

  sample_phase(A, 0, gtid, gsz);
  grid.sync();
  for (int it = 0; it < A.n_steps; ++it) {
    const float eps = A.tdv ? A.p[A.o_eps] * A.eps_const : A.eps_const;
    const float noise_sd = expf(eps * 0.5f);
    const float inv_var = expf(-eps);

    // encoder forward: x → mu, s
    for (int li = 0; li < enc.n; ++li) {
      const bool last = li + 1 == enc.n;
      const float* in = li == 0 ? S + A.s_x : S + enc.act[li - 1];
      float* out = last ? S + A.s_mu : S + enc.act[li];
      forward_phase(A, in, enc.widths[li], enc.w_off[li], enc.b_off[li], out,
                    enc.widths[li + 1], last ? 1 : 0, noise_sd, gtid, gsz);
      grid.sync();
    }
    // decoder forward: s → r = y − x
    for (int li = 0; li < dec.n; ++li) {
      const bool last = li + 1 == dec.n;
      const float* in = li == 0 ? S + A.s_s : S + dec.act[li - 1];
      float* out = last ? S + A.s_r : S + dec.act[li];
      forward_phase(A, in, dec.widths[li], dec.w_off[li], dec.b_off[li], out,
                    dec.widths[li + 1], last ? 2 : 0, noise_sd, gtid, gsz);
      grid.sync();
    }
    // decoder backward from g_y = r·inv_var/B; its first layer gives g_s
    // and g_mu = g_s + mu/B. Block 0 also takes the loss.
    for (int li = dec.n - 1; li >= 0; --li) {
      const bool top = li + 1 == dec.n;
      if (top && blockIdx.x == 0) loss_block(A, it, eps, noise_sd, inv_var);
      const float* a_in = li == 0 ? S + A.s_s : S + dec.act[li - 1];
      const float* g_out = top ? S + A.s_r : S + A.s_buf[(li + 1) & 1];
      float* g_in = li == 0 ? S + A.s_gs : S + A.s_buf[li & 1];
      backward_phase(A, a_in, dec.widths[li], dec.w_off[li], dec.b_off[li], g_out,
                     top ? inv_var * inv_b : 1.0f, dec.widths[li + 1], g_in, li > 0,
                     li == 0 ? S + A.s_gmu : nullptr, gtid, gsz);
      grid.sync();
    }
    // encoder backward from g_mu; its last layer also gives g_ep
    for (int li = enc.n - 1; li >= 0; --li) {
      const bool top = li + 1 == enc.n;
      if (top) {
        for (int l = gtid; l < A.L; l += gsz) {
          float acc = 0.0f;
          for (int b = 0; b < A.B; ++b)
            acc = fmaf(S[A.s_gs + b * A.L + l], S[A.s_z1 + b * A.L + l], acc);
          const float ep = A.p[A.o_ep + l];
          S[A.s_g + A.o_ep + l] = acc * 0.5f * expf(ep * 0.5f) + 0.5f * (expf(ep) - 1.0f);
        }
      }
      const float* a_in = li == 0 ? S + A.s_x : S + enc.act[li - 1];
      const float* g_out = top ? S + A.s_gmu : S + A.s_buf[(li + 1) & 1];
      backward_phase(A, a_in, enc.widths[li], enc.w_off[li], enc.b_off[li], g_out, 1.0f,
                     enc.widths[li + 1], li > 0 ? S + A.s_buf[li & 1] : nullptr, true,
                     nullptr, gtid, gsz);
      grid.sync();
    }
    // Adam, and the next step's noise (which reads no parameter)
    adam_phase(A, it, gtid, gsz);
    if (it + 1 < A.n_steps) {
      sample_phase(A, it + 1, gtid, gsz);
      grid.sync();
    }
  }
}

bool fill_stack(Stack& st, int n, const int* widths) {
  if (n < 1 || n > kMaxLayers) return false;
  st.n = n;
  for (int i = 0; i <= n; ++i) {
    if (widths[i] < 1) return false;
    st.widths[i] = widths[i];
  }
  return true;
}

bool fill_shape(Args& A, int B, int D, int L, int id, int dd, int kind, int n_enc,
                const int* enc_widths, int n_dec, const int* dec_widths) {
  A.B = B; A.D = D; A.L = L; A.id = id; A.dd = dd; A.kind = kind;
  if (B < 1 || D < 1 || L < 1 || id < 1 || dd < 1 || dd > D ||
      (kind == kSphere && id != dd) || (kind != kSphere && kind != kLinear))
    return false;
  if (!fill_stack(A.enc, n_enc, enc_widths) || !fill_stack(A.dec, n_dec, dec_widths))
    return false;
  return A.enc.widths[0] == D && A.enc.widths[n_enc] == L && A.dec.widths[0] == L &&
         A.dec.widths[n_dec] == D;
}

}  // namespace

extern "C" {

const char* mlp_vae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scratch floats a launch at these shapes needs (−1 for shapes it refuses).
long long mlp_vae_scratch_floats(int B, int D, int L, int id, int dd, int kind, int n_enc,
                                 const int* enc_widths, int n_dec, const int* dec_widths) {
  Args A{};
  if (!fill_shape(A, B, D, L, id, dd, kind, n_enc, enc_widths, n_dec, dec_widths)) return -1;
  return plan(A);
}

// The grid of a launch on the current device: one block per SM, if the
// kernel fits one block per SM (occupancy ≥ 1) and the device takes
// cooperative launches.
int mlp_vae_grid(int* blocks, int* blocks_per_sm_max) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, mlp_vae_chunk_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms;
  *blocks_per_sm_max = occ;
  return 0;
}

int mlp_vae_chunk(float* p, float* m, float* v, float* losses, float* scratch,
                  long long scratch_floats, const float* a, const float* ext_x,
                  const float* ext_z1, const float* ext_z2, int n_steps, int B, int D, int L,
                  int id, int dd, int kind, int n_enc, const int* enc_widths, int n_dec,
                  const int* dec_widths, unsigned int step0, int t0, unsigned int dk0,
                  unsigned int dk1, unsigned int mk0, unsigned int mk1, float obs_scale,
                  float eps_const, int tdv, float lr, void* stream) {
  Args A{};
  if (!fill_shape(A, B, D, L, id, dd, kind, n_enc, enc_widths, n_dec, dec_widths))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need = plan(A);
  if (need < 0 || scratch_floats < need) return static_cast<int>(cudaErrorInvalidValue);
  A.p = p; A.m = m; A.v = v; A.losses = losses; A.scratch = scratch; A.a = a;
  A.ext_x = ext_x; A.ext_z1 = ext_z1; A.ext_z2 = ext_z2;
  A.n_steps = n_steps; A.step0 = step0; A.t0 = t0;
  A.dk0 = dk0; A.dk1 = dk1; A.mk0 = mk0; A.mk1 = mk1;
  A.obs_scale = obs_scale; A.eps_const = eps_const; A.tdv = tdv; A.lr = lr;
  int blocks = 0, occ = 0;
  const int err = mlp_vae_grid(&blocks, &occ);
  if (err != 0) return err;
  void* params[] = {&A};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mlp_vae_chunk_kernel),
                                              dim3(blocks), dim3(kThreads), params, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
