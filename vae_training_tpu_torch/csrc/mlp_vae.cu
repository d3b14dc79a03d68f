// Fused multi-step MLP-VAE training kernel for Hopper (sm_90a): K5, its
// sigmoid dual-decoder branch, and its grid mode K6b.
//
// Replaces the TPU kernel vae_training_tpu/kernels/mlp_vae.py:_make_kernel
// (launched by run_mlp_fused_chunk, mlp_vae.py:644) in all its branches: the
// sphere, linear_gaussian and sigmoid manifolds; one decoder, or the sigmoid
// dataset's dual decoder x̂ = σ(SigDecoder(s)) + Decoder(s) (dual=True,
// mlp_vae.py:308-311, 324-329, 349-352); solo, and grid mode (grid_n > 0:
// many sweep rows of mixed dims in one launch). One launch runs K training
// steps of every row of its table; per step and row:
//
//   Philox4x32-10 -> Box-Muller normals -> x (sphere: n·rsqrt(max(Σn², 1e-20));
//   linear_gaussian: pad(n·Aᵀ) + obs noise; sigmoid: [n, σ(n·a), 0])
//   -> encoder stack -> mu -> s = mu + e^{ep/2}·z1 -> decoder stack
//   [dual: + σ(SigDecoder stack), on all D output columns] -> y = x̂ + z2·e^{ε/2}
//   -> closed-form ELBO into losses[step] -> backward through every layer
//   (ReLU masks from the saved activations, a > 0; dual: g_u = g_y·σ(1 − σ),
//   g_s = g_s,dec + g_s,sig) -> bias-corrected Adam
//
// bf16 moments (K4, the bf16 branch of the TPU kernels' _adam,
// linear_vae.py:188-218, called at mlp_vae.py:373-379; --adam_dtype bf16):
// with the launch-wide flag moments_bf16, the Adam phase rounds the new m and
// v of every W slot of every stack (encoder, decoder, SigDecoder) to
// bfloat16, round to nearest even, every step, and the update reads the
// rounded values; biases, epsilon_p and epsilon keep f32 moments. The state
// stays float32 in device memory, holding values bfloat16 represents
// exactly: the kernel is latency-bound, so halving its moment bytes waits
// for the redesign that makes it fast.
//
// What bounds it on this card: latency. At the sphere sweep's shapes
// (batch 100, 200|200|200 on both stacks, D = L = 6) a step is ~100 MFLOP in
// 16 dependent layer phases, ~1.5 µs of the card's fp32 peak, and step i+1
// needs step i's parameters. A row's state (p, m, v and the gradients:
// 4 × 166k floats, 2.7 MB) does not fit one SM's 227 KB of shared memory, so
// the design is one persistent cooperative launch per chunk: one block per
// SM, the state in the caller's device buffers (L2-resident: 50 MB of L2)
// and each row's activations in its own scratch, each dependent phase a
// grid-stride loop in which one thread owns one output element and runs a
// fixed-order FMA loop, phases separated by grid-wide barriers (17 a step at
// 3+3 hidden layers).
//
// Rows (the TPU kernel's scalar-prefetch rows [seed, t0, dd, ld, id],
// mlp_vae.py:157-167): every row of the device table carries its own state,
// dims, stack offsets, counters, Philox keys and scratch; batch, step count,
// ε, -tdv, lr, the manifold kind, the decoder head, the layer counts and the
// hidden widths are the launch's. All rows therefore run the same phase
// sequence: each phase is one grid-stride loop over the concatenation of
// every row's items of that phase, and the barriers serve all rows at once.
// A solo launch (K5) is the same kernel with a one-row table. Each output
// element is computed by the same code in the same order whichever thread
// runs it, and row r's loss sums are taken by block r mod gridDim.x alone in
// a fixed order: no atomics, and no result depends on the grid size or on
// the other rows, so a grid row equals its solo launch bitwise, a 40-step
// launch equals a 15 + 25 split bitwise and --resume is bitwise. Tensor
// cores, clusters with distributed shared memory and per-row barriers in
// place of grid-wide ones are later work.
//
// True dimensions throughout: the TPU kernel's 128-lane padding, masks and
// live-row slicing are layout devices of the TPU and are not carried over.
//
// Loads of the state and the scratch go through plain (coherent) global
// loads: those buffers change during the launch, so no pointer to them is
// const __restrict__ (which would allow the non-coherent read-only path).
// The row table does not change during a launch: each block stages it in
// shared memory once, so the phases read a row's fields at shared-memory
// latency instead of through an L1 the streamed state keeps evicting.
//
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxLayers = 8;  // Dense layers per stack
constexpr int kMaxRows = 256;  // rows a launch; its table lives in shared memory

// One ReLU stack: widths[0] is its input, widths[n] its output. Parameter
// offsets index the row's flat state buffers; act[li] (li < n − 1) is the
// scratch offset of hidden layer li's post-ReLU output (B × widths[li + 1]).
struct Stack {
  int n;
  int widths[kMaxLayers + 1];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int act[kMaxLayers];
};

// One row of a launch's table. Plain data in natural alignment:
// kernels/mlp_vae.py's ctypes Row mirrors it field by field, and
// mlp_vae_row_bytes lets the wrapper hold the two to one size. The caller
// fills the fields up to obs_scale; mlp_vae_plan_row fills the rest.
struct Row {
  float* p;                  // params (P), updated in place
  float* m;                  // Adam m (P)
  float* v;                  // Adam v (P)
  float* losses;             // (n_steps) per-step losses
  float* scratch;            // the row's gradients and activations
  long long scratch_floats;  // its size
  const float* a;            // A (dd × id); the sigmoid's column a (dd); or null
  const float* ext_x;        // external noise (n_steps × B × D), or null
  const float* ext_z1;       // (n_steps × B × L)
  const float* ext_z2;       // (n_steps × B × D)
  int D, L, id, dd;          // ambient, latent, intrinsic and manifold dims
  unsigned int step0;        // absolute step of the first step (Philox counter)
  int t0;                    // Adam count before it
  unsigned int dk0, dk1, mk0, mk1;  // data and model key words
  float obs_scale;           // observation-noise sd (0: none)
  // planned: the flat layout (P floats: encoder, decoder, epsilon_p,
  // epsilon, then the SigDecoder) and the scratch offsets, in floats
  int P, o_ep, o_eps;
  Stack enc, dec, sig;  // sig.n = 0 without the dual decoder
  int s_g, s_nz, s_x, s_z1, s_z2, s_mu, s_s, s_r, s_su, s_gs, s_gmu;
  int s_buf[2], s_sbuf[2];  // ping-pong input gradients: decoder/encoder, SigDecoder
};
static_assert(sizeof(Row) % 16 == 0, "the table is staged in 16-byte words");

namespace {

using namespace philox;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;

constexpr int kSphere = 0;
constexpr int kLinear = 1;
constexpr int kSigmoid = 2;

// The launch's uniform shape: what every row shares.
struct Shape {
  int B, kind, dual, n_enc, n_dec;
  int enc_hidden[kMaxLayers];
  int dec_hidden[kMaxLayers];
};

struct Args {
  const Row* rows;  // the device table; in the kernel, its copy in shared memory
  int n_rows;
  int n_steps, B, kind, dual, n_enc, n_dec, tdv, moments_bf16;
  float eps_const, lr;
};

bool fill_stack(Stack& st, int n, int in, const int* hidden, int out) {
  if (n < 1 || n > kMaxLayers) return false;
  st = Stack{};
  st.n = n;
  st.widths[0] = in;
  for (int i = 1; i < n; ++i) {
    if (hidden[i - 1] < 1) return false;
    st.widths[i] = hidden[i - 1];
  }
  st.widths[n] = out;
  return true;
}

// Fills the planned fields of `R` from its dims and the launch's shape;
// returns the row's scratch size in floats, or −1 for shapes the kernel
// refuses or an offset that would overflow int.
long long plan(Row& R, const Shape& S) {
  const int B = S.B, D = R.D, L = R.L;
  if (B < 1 || D < 1 || L < 1 || R.id < 1 || R.dd < 1 || R.dd > D ||
      S.kind < kSphere || S.kind > kSigmoid)
    return -1;
  if (S.kind != kLinear && R.id != R.dd) return -1;  // the draw is the manifold
  if (S.kind == kSigmoid && R.dd + 1 > D) return -1;  // the σ column
  if (!fill_stack(R.enc, S.n_enc, D, S.enc_hidden, L) ||
      !fill_stack(R.dec, S.n_dec, L, S.dec_hidden, D))
    return -1;
  R.sig = Stack{};
  if (S.dual) R.sig = R.dec;  // the SigDecoder mirrors the decoder's widths
  long long off = 0;
  auto params = [&off](Stack& st) {
    for (int li = 0; li < st.n; ++li) {
      st.w_off[li] = static_cast<int>(off);
      off += static_cast<long long>(st.widths[li]) * st.widths[li + 1];
      st.b_off[li] = static_cast<int>(off);
      off += st.widths[li + 1];
    }
  };
  params(R.enc);
  params(R.dec);
  R.o_ep = static_cast<int>(off);
  R.o_eps = R.o_ep + L;
  off += L + 1;
  params(R.sig);
  R.P = static_cast<int>(off);
  const long long b = B;
  long long s = 0;
  auto take = [&s](long long n) {
    const long long at = s;
    s += n;
    return static_cast<int>(at);
  };
  long long hidden = 1;
  auto acts = [&](Stack& st) {
    for (int li = 0; li + 1 < st.n; ++li) {
      st.act[li] = take(b * st.widths[li + 1]);
      hidden = hidden > st.widths[li + 1] ? hidden : st.widths[li + 1];
    }
  };
  R.s_g = take(off);
  R.s_nz = take(b * R.id);
  R.s_x = take(b * D);
  R.s_z1 = take(b * L);
  R.s_z2 = take(b * D);
  acts(R.enc);
  R.s_mu = take(b * L);
  R.s_s = take(b * L);
  acts(R.dec);
  acts(R.sig);
  R.s_r = take(b * D);
  R.s_su = S.dual ? take(b * D) : 0;
  R.s_gs = take(b * L);
  R.s_gmu = take(b * L);
  R.s_buf[0] = take(b * hidden);
  R.s_buf[1] = take(b * hidden);
  R.s_sbuf[0] = S.dual ? take(b * hidden) : 0;
  R.s_sbuf[1] = S.dual ? take(b * hidden) : 0;
  return (off > INT_MAX || s > INT_MAX) ? -1 : s;
}

__device__ __forceinline__ float sigmoidf(float u) { return 1.0f / (1.0f + expf(-u)); }

// The decoder's log-variance ε of row R at this step (its epsilon slot
// changes only in the Adam phase).
__device__ __forceinline__ float row_eps(const Args& A, const Row& R) {
  return A.tdv ? R.p[R.o_eps] * A.eps_const : A.eps_const;
}

// Grid-stride loop over the concatenation of every row's count(R) items:
// item i of row r is global item base_r + i, run by thread
// (base_r + i) mod gsz, so the rows' work spreads over the whole grid.
template <class Count, class Body>
__device__ __forceinline__ void over_rows(const Args& A, int gtid, int gsz, Count count,
                                          Body body) {
  int base = 0;  // base_r mod gsz
  for (int r = 0; r < A.n_rows; ++r) {
    const Row& R = A.rows[r];
    const int n = count(R);
    int i = gtid - base;
    if (i < 0) i += gsz;
    for (; i < n; i += gsz) body(R, i);
    base = static_cast<int>((base + static_cast<long long>(n)) % gsz);
  }
}

// --- the per-step phases ---------------------------------------------------

// x, z1, z2 of step `it` into each row's scratch (the external hook copies
// them).
__device__ void sample_phase(const Args& A, int it, int gtid, int gsz) {
  const int B = A.B;
  over_rows(
      A, gtid, gsz,
      [&](const Row& R) {
        return R.ext_x != nullptr ? B * (R.D + R.L) : B + B * ((R.L + 3) / 4 + (R.D + 3) / 4);
      },
      [&](const Row& R, int item) {
        float* S = R.scratch;
        float* x = S + R.s_x;
        float* z1 = S + R.s_z1;
        float* z2 = S + R.s_z2;
        const int D = R.D, L = R.L;
        if (R.ext_x != nullptr) {
          if (item < B * D) {
            const size_t o = static_cast<size_t>(it) * B * D + item;
            x[item] = R.ext_x[o];
            z2[item] = R.ext_z2[o];
          } else {
            const int i = item - B * D;
            z1[i] = R.ext_z1[static_cast<size_t>(it) * B * L + i];
          }
          return;
        }
        const uint32_t step = R.step0 + static_cast<uint32_t>(it);
        const int nw_l = (L + 3) / 4;
        const int nw_d = (D + 3) / 4;
        float n[4];
        if (item < B) {
          // one thread per batch row: the manifold draw, then that row of x
          const int b = item;
          float* nz = S + R.s_nz + b * R.id;
          for (int j = 0; 4 * j < R.id; ++j) {
            normals4(step, b, j, kStreamManifold, R.dk0, R.dk1, n);
            for (int q = 0; q < 4 && 4 * j + q < R.id; ++q) nz[4 * j + q] = n[q];
          }
          float* xr = x + b * D;
          if (A.kind == kSphere) {
            float norm2 = 0.0f;
            for (int k = 0; k < R.dd; ++k) norm2 = fmaf(nz[k], nz[k], norm2);
            const float inv = rsqrtf(fmaxf(norm2, 1e-20f));
            for (int j = 0; j < D; ++j) xr[j] = j < R.dd ? nz[j] * inv : 0.0f;
          } else if (A.kind == kSigmoid) {
            // [n, σ(n·a), 0]: the sigmoid's formula of K2 (csrc/linear_vae.cu)
            float acc = 0.0f;
            for (int k = 0; k < R.dd; ++k) acc = fmaf(nz[k], R.a[k], acc);
            for (int j = 0; j < D; ++j) xr[j] = j < R.dd ? nz[j] : 0.0f;
            xr[R.dd] = sigmoidf(acc);
          } else {
            for (int j = 0; j < D; ++j) {
              float acc = 0.0f;
              if (j < R.dd) {
                for (int k = 0; k < R.id; ++k) acc = fmaf(nz[k], R.a[j * R.id + k], acc);
              }
              xr[j] = acc;
            }
            if (R.obs_scale > 0.0f) {
              for (int j = 0; 4 * j < D; ++j) {
                normals4(step, b, j, kStreamObs, R.dk0, R.dk1, n);
                for (int q = 0; q < 4 && 4 * j + q < D; ++q) xr[4 * j + q] += n[q] * R.obs_scale;
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
          normals4(step, b, j, stream, R.mk0, R.mk1, n);
          for (int q = 0; q < 4 && 4 * j + q < dim; ++q) dst[4 * j + q] = n[q];
        }
      });
}

// (in·W + b)[b, o] for one Dense layer of the flat state p; in is B × din.
__device__ __forceinline__ float dense(const float* p, const float* in, int din, int w_off,
                                       int b_off, int dout, int b, int o) {
  const float* row = in + b * din;
  const float* W = p + w_off;
  float acc = 0.0f;
  for (int k = 0; k < din; ++k) acc = fmaf(row[k], W[k * dout + o], acc);
  return acc + p[b_off + o];
}

// Encoder layer li over B × dout: ReLU on hidden layers; the last layer
// gives mu and s = mu + e^{ep/2}·z1.
__device__ void encoder_forward(const Args& A, int li, int gtid, int gsz) {
  over_rows(
      A, gtid, gsz, [&](const Row& R) { return A.B * R.enc.widths[li + 1]; },
      [&](const Row& R, int i) {
        const Stack& st = R.enc;
        float* S = R.scratch;
        const int din = st.widths[li], dout = st.widths[li + 1];
        const int b = i / dout;
        const int o = i - b * dout;
        const float* in = li == 0 ? S + R.s_x : S + st.act[li - 1];
        const float z = dense(R.p, in, din, st.w_off[li], st.b_off[li], dout, b, o);
        if (li + 1 < st.n) {
          S[st.act[li] + i] = fmaxf(z, 0.0f);
        } else {
          S[R.s_mu + i] = z;
          S[R.s_s + i] = z + expf(R.p[R.o_ep + o] * 0.5f) * S[R.s_z1 + i];
        }
      });
}

// Decoder layer li, and the SigDecoder's with the dual decoder. Hidden
// layers: the decoder's B × dout items, then the SigDecoder's. The last
// layer: one item per output (b, o), which takes both stacks' products and
// gives the residual r = (x̂ + z2·e^{ε/2}) − x, with x̂ = σ(u) + Dec(s) and
// σ(u) saved for the backward.
__device__ void decoder_forward(const Args& A, int li, int gtid, int gsz) {
  const bool last = li + 1 == A.n_dec;
  over_rows(
      A, gtid, gsz,
      [&](const Row& R) {
        const int n = A.B * R.dec.widths[li + 1];
        return !last && A.dual ? 2 * n : n;
      },
      [&](const Row& R, int i) {
        float* S = R.scratch;
        const int din = R.dec.widths[li], dout = R.dec.widths[li + 1];
        if (!last) {
          const int n = A.B * dout;
          const Stack& st = i < n ? R.dec : R.sig;
          const int k = i < n ? i : i - n;
          const int b = k / dout;
          const int o = k - b * dout;
          const float* in = li == 0 ? S + R.s_s : S + st.act[li - 1];
          S[st.act[li] + k] =
              fmaxf(dense(R.p, in, din, st.w_off[li], st.b_off[li], dout, b, o), 0.0f);
          return;
        }
        const int b = i / dout;
        const int o = i - b * dout;
        const float* in = li == 0 ? S + R.s_s : S + R.dec.act[li - 1];
        float x_hat = dense(R.p, in, din, R.dec.w_off[li], R.dec.b_off[li], dout, b, o);
        if (A.dual) {
          const float* in_s = li == 0 ? S + R.s_s : S + R.sig.act[li - 1];
          const float sg =
              sigmoidf(dense(R.p, in_s, din, R.sig.w_off[li], R.sig.b_off[li], dout, b, o));
          S[R.s_su + i] = sg;
          x_hat = sg + x_hat;
        }
        const float noise_sd = expf(row_eps(A, R) * 0.5f);
        S[R.s_r + i] = (x_hat + S[R.s_z2 + i] * noise_sd) - S[R.s_x + i];
      });
}

// Where a layer's output gradient comes from: G(b, o) = g[b·dout + o]·scale,
// and with `su` (the SigDecoder's top layer) times σ(1 − σ) of the saved
// sigmoid output. `scale` turns the decoder's residual into g_y; 1 is exact
// elsewhere.
struct Grad {
  const float* g;
  float scale;
  const float* su;
};

__device__ __forceinline__ float grad_at(const Grad& G, int idx) {
  float g = G.g[idx] * G.scale;
  if (G.su != nullptr) g = g * G.su[idx] * (1.0f - G.su[idx]);
  return g;
}

// Item i of one layer's parameter gradients: i < din·dout is
// g_W[k, o] = Σ_b a_in[b, k]·G(b, o); the next dout items g_b[o] = Σ_b G(b, o).
__device__ __forceinline__ void param_grad(const Row& R, int B, const float* a_in, int din,
                                           int dout, int w_off, int b_off, const Grad& G,
                                           int i) {
  float* g = R.scratch + R.s_g;
  const int n_w = din * dout;
  float acc = 0.0f;
  if (i < n_w) {
    const int k = i / dout;
    const int o = i - k * dout;
    for (int b = 0; b < B; ++b) acc = fmaf(a_in[b * din + k], grad_at(G, b * dout + o), acc);
    g[w_off + i] = acc;
  } else {
    const int o = i - n_w;
    for (int b = 0; b < B; ++b) acc += grad_at(G, b * dout + o);
    g[b_off + o] = acc;
  }
}

// g_in[b, j] = Σ_o G(b, o)·W[j, o] for a layer of output width dout.
__device__ __forceinline__ float input_grad(const float* W, int dout, const Grad& G, int b,
                                            int j) {
  const float* wrow = W + j * dout;
  float acc = 0.0f;
  for (int o = 0; o < dout; ++o) acc = fmaf(grad_at(G, b * dout + o), wrow[o], acc);
  return acc;
}

// The output gradient of decoder layer li (stack 0) or SigDecoder layer li
// (stack 1): at the top, g_y = r·inv_var/B (times σ(1 − σ) for the
// SigDecoder); below it, the layer above's input gradient.
__device__ __forceinline__ Grad decoder_grad(const Args& A, const Row& R, int stack, int li) {
  const float* S = R.scratch;
  if (li + 1 == A.n_dec) {
    const float inv_var = expf(-row_eps(A, R));
    return Grad{S + R.s_r, inv_var * (1.0f / static_cast<float>(A.B)),
                stack == 0 ? nullptr : S + R.s_su};
  }
  return Grad{S + (stack == 0 ? R.s_buf : R.s_sbuf)[(li + 1) & 1], 1.0f, nullptr};
}

// Block-wide: row R's loss of step `it` and d loss / d epsilon, from Σmu²,
// Σr² and Σr·z2 taken in a fixed order (per-thread strides, then warp
// shuffles, then the warps' partials in order).
__device__ void loss_block(const Args& A, const Row& R, int it) {
  __shared__ float red[3 * kWarps];
  const float* S = R.scratch;
  const int tid = threadIdx.x;
  const int B = A.B;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int i = tid; i < B * R.L; i += kThreads) a0 = fmaf(S[R.s_mu + i], S[R.s_mu + i], a0);
  for (int i = tid; i < B * R.D; i += kThreads) {
    const float r = S[R.s_r + i];
    a1 = fmaf(r, r, a1);
    a2 = fmaf(r, S[R.s_z2 + i], a2);
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
    for (int l = 0; l < R.L; ++l) {
      const float ep = R.p[R.o_ep + l];
      kl_const += -0.5f * (1.0f + ep - expf(ep));
    }
    const float eps = row_eps(A, R);
    const float noise_sd = expf(eps * 0.5f);
    const float inv_var = expf(-eps);
    const float inv_b = 1.0f / static_cast<float>(B);
    const float c_gy = inv_var * inv_b;
    R.losses[it] = kl_const + 0.5f * inv_b * sum_mu2 + 0.5f * inv_var * inv_b * sum_r2 +
                   static_cast<float>(R.D) * (0.5f * (kLog2Pi + eps));
    const float g_eps = -0.5f * inv_var * inv_b * sum_r2 + 0.5f * static_cast<float>(R.D) +
                        (c_gy * sum_rz2) * 0.5f * noise_sd;
    R.scratch[R.s_g + R.o_eps] = A.tdv ? g_eps * A.eps_const : 0.0f;
  }
  __syncthreads();  // `red` is free for the block's next row
}

// Decoder layer li's backward, and the SigDecoder's. Per row: the decoder's
// g_W and g_b (and, below the first layer, its masked input gradient), the
// same for the SigDecoder, and at the first layer g_s = g_s,dec + g_s,sig
// with g_mu = g_s + mu/B. At the top, each block also takes the loss of its
// rows (r mod gridDim.x).
__device__ void decoder_backward(const Args& A, int it, int li, int gtid, int gsz) {
  if (li + 1 == A.n_dec) {
    for (int r = blockIdx.x; r < A.n_rows; r += gridDim.x) loss_block(A, A.rows[r], it);
  }
  const int B = A.B;
  const int n_stacks = A.dual ? 2 : 1;
  over_rows(
      A, gtid, gsz,
      [&](const Row& R) {
        const int din = R.dec.widths[li], dout = R.dec.widths[li + 1];
        const int part = din * dout + dout + (li > 0 ? B * din : 0);
        return n_stacks * part + (li == 0 ? B * R.L : 0);
      },
      [&](const Row& R, int i) {
        float* S = R.scratch;
        const int din = R.dec.widths[li], dout = R.dec.widths[li + 1];
        const int n_p = din * dout + dout;
        const int part = n_p + (li > 0 ? B * din : 0);
        int k = i;
        for (int stack = 0; stack < n_stacks; ++stack) {
          if (k < part) {
            const Stack& st = stack == 0 ? R.dec : R.sig;
            const Grad G = decoder_grad(A, R, stack, li);
            const float* a_in = li == 0 ? S + R.s_s : S + st.act[li - 1];
            if (k < n_p) {
              param_grad(R, B, a_in, din, dout, st.w_off[li], st.b_off[li], G, k);
            } else {
              const int q = k - n_p;
              const int b = q / din;
              float acc = input_grad(R.p + st.w_off[li], dout, G, b, q - b * din);
              if (!(a_in[q] > 0.0f)) acc = 0.0f;  // the ReLU below
              S[(stack == 0 ? R.s_buf : R.s_sbuf)[li & 1] + q] = acc;
            }
            return;
          }
          k -= part;
        }
        // li == 0: the gradient at s, the input of both stacks
        const int b = k / R.L;
        const int j = k - b * R.L;
        float acc = input_grad(R.p + R.dec.w_off[0], dout, decoder_grad(A, R, 0, 0), b, j);
        if (A.dual) acc = acc + input_grad(R.p + R.sig.w_off[0], dout, decoder_grad(A, R, 1, 0), b, j);
        S[R.s_gs + k] = acc;
        S[R.s_gmu + k] = acc + S[R.s_mu + k] * (1.0f / static_cast<float>(B));
      });
}

// Encoder layer li's backward from g_mu (top) or the layer above's input
// gradient; the top layer's phase also takes g_ep (L items a row first).
__device__ void encoder_backward(const Args& A, int li, int gtid, int gsz) {
  const int B = A.B;
  const bool top = li + 1 == A.n_enc;
  over_rows(
      A, gtid, gsz,
      [&](const Row& R) {
        const int din = R.enc.widths[li], dout = R.enc.widths[li + 1];
        return (top ? R.L : 0) + din * dout + dout + (li > 0 ? B * din : 0);
      },
      [&](const Row& R, int i) {
        float* S = R.scratch;
        const Stack& st = R.enc;
        int k = i;
        if (top) {
          if (k < R.L) {
            float acc = 0.0f;
            for (int b = 0; b < B; ++b)
              acc = fmaf(S[R.s_gs + b * R.L + k], S[R.s_z1 + b * R.L + k], acc);
            const float ep = R.p[R.o_ep + k];
            S[R.s_g + R.o_ep + k] = acc * 0.5f * expf(ep * 0.5f) + 0.5f * (expf(ep) - 1.0f);
            return;
          }
          k -= R.L;
        }
        const int din = st.widths[li], dout = st.widths[li + 1];
        const int n_p = din * dout + dout;
        const Grad G{S + (top ? R.s_gmu : R.s_buf[(li + 1) & 1]), 1.0f, nullptr};
        const float* a_in = li == 0 ? S + R.s_x : S + st.act[li - 1];
        if (k < n_p) {
          param_grad(R, B, a_in, din, dout, st.w_off[li], st.b_off[li], G, k);
        } else {
          const int q = k - n_p;
          const int b = q / din;
          float acc = input_grad(R.p + st.w_off[li], dout, G, b, q - b * din);
          if (!(a_in[q] > 0.0f)) acc = 0.0f;
          S[R.s_buf[li & 1] + q] = acc;
        }
      });
}

// Whether flat slot i of a row lies in one of the stack's weight matrices.
__device__ __forceinline__ bool in_weights(const Stack& st, int i) {
  for (int li = 0; li < st.n; ++li) {
    if (i >= st.w_off[li] && i < st.b_off[li]) return true;
  }
  return false;
}

// x rounded to the nearest bfloat16 (ties to even), back as a float.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Adam (optax.adam: bias-corrected m̂/(√v̂ + eps)) over every parameter of
// every row; the corrections 1 − βᵗ in double, rounded once to float, as in
// K1. A row's t is its own, t0 + it + 1; each thread recomputes the
// corrections only when t changes (a pure function of t). bf16 moments: the
// weight slots' m and v are rounded before the update reads them (K4).
__device__ void adam_phase(const Args& A, int it, int gtid, int gsz) {
  int t_last = -1;
  float bc1 = 1.0f, bc2 = 1.0f;
  over_rows(
      A, gtid, gsz, [&](const Row& R) { return R.P; },
      [&](const Row& R, int i) {
        const int t = R.t0 + it + 1;
        if (t != t_last) {
          t_last = t;
          bc1 = static_cast<float>(1.0 - pow(0.9, static_cast<double>(t)));
          bc2 = static_cast<float>(1.0 - pow(0.999, static_cast<double>(t)));
        }
        const float gi = R.scratch[R.s_g + i];
        float m_ = kB1 * R.m[i] + kOneMinusB1 * gi;
        float v_ = kB2 * R.v[i] + kOneMinusB2 * gi * gi;
        if (A.moments_bf16 &&
            (in_weights(R.enc, i) || in_weights(R.dec, i) || in_weights(R.sig, i))) {
          m_ = bf16_rn(m_);
          v_ = bf16_rn(v_);
        }
        R.m[i] = m_;
        R.v[i] = v_;
        R.p[i] -= A.lr * ((m_ / bc1) / (sqrtf(v_ / bc2) + kAdamEps));
      });
}

__global__ void __launch_bounds__(kThreads, 1) mlp_vae_chunk_kernel(Args table) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsz = gridDim.x * blockDim.x;

  extern __shared__ __align__(16) uint4 table_words[];  // n_rows × sizeof(Row) bytes
  const int n_words = table.n_rows * static_cast<int>(sizeof(Row) / sizeof(uint4));
  const uint4* src = reinterpret_cast<const uint4*>(table.rows);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) table_words[i] = src[i];
  __syncthreads();
  Args A = table;
  A.rows = reinterpret_cast<const Row*>(table_words);

  sample_phase(A, 0, gtid, gsz);
  grid.sync();
  for (int it = 0; it < A.n_steps; ++it) {
    for (int li = 0; li < A.n_enc; ++li) {  // encoder forward: x → mu, s
      encoder_forward(A, li, gtid, gsz);
      grid.sync();
    }
    for (int li = 0; li < A.n_dec; ++li) {  // decoder(s) forward: s → r = y − x
      decoder_forward(A, li, gtid, gsz);
      grid.sync();
    }
    for (int li = A.n_dec - 1; li >= 0; --li) {  // decoder(s) backward → g_s, g_mu
      decoder_backward(A, it, li, gtid, gsz);
      grid.sync();
    }
    for (int li = A.n_enc - 1; li >= 0; --li) {  // encoder backward, g_ep
      encoder_backward(A, li, gtid, gsz);
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

bool fill_shape(Shape& S, int B, int kind, int dual, int n_enc, const int* enc_hidden,
                int n_dec, const int* dec_hidden) {
  S = Shape{};
  S.B = B; S.kind = kind; S.dual = dual != 0; S.n_enc = n_enc; S.n_dec = n_dec;
  if (n_enc < 1 || n_enc > kMaxLayers || n_dec < 1 || n_dec > kMaxLayers) return false;
  for (int i = 0; i + 1 < n_enc; ++i) S.enc_hidden[i] = enc_hidden[i];
  for (int i = 0; i + 1 < n_dec; ++i) S.dec_hidden[i] = dec_hidden[i];
  return true;
}

}  // namespace

extern "C" {

const char* mlp_vae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

size_t mlp_vae_row_bytes() { return sizeof(Row); }

// Plans `row` (its layout and scratch offsets, from its dims and the
// launch's shape, in place) and returns the scratch floats it needs, or −1
// for shapes the kernel refuses.
long long mlp_vae_plan_row(Row* row, int B, int kind, int dual, int n_enc,
                           const int* enc_hidden, int n_dec, const int* dec_hidden) {
  Shape S;
  if (!fill_shape(S, B, kind, dual, n_enc, enc_hidden, n_dec, dec_hidden)) return -1;
  return plan(*row, S);
}

// The grid of a launch of `n_rows` rows on the current device: one block
// per SM, if the kernel fits one block per SM (occupancy ≥ 1) with the row
// table in its shared memory and the device takes cooperative launches.
int mlp_vae_grid(int n_rows, int* blocks, int* blocks_per_sm_max) {
  if (n_rows < 1 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Row) * n_rows;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlp_vae_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, mlp_vae_chunk_kernel, kThreads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms;
  *blocks_per_sm_max = occ;
  return 0;
}

// K5 (one row) and K6b (many): `n_steps` steps of every row of the table in
// one cooperative launch. The rows are planned here, in `rows_host`, and the
// table copied in stream order to `rows_dev` (n_rows × sizeof(Row) bytes of
// device memory the caller owns); every row's scratch must hold what its
// plan needs.
int mlp_vae_chunk(Row* rows_host, void* rows_dev, int n_rows, int n_steps, int B, int kind,
                  int dual, int n_enc, const int* enc_hidden, int n_dec, const int* dec_hidden,
                  float eps_const, int tdv, float lr, int moments_bf16, void* stream) {
  Shape S;
  if (n_rows < 1 || n_rows > kMaxRows || n_steps < 1 ||
      !fill_shape(S, B, kind, dual, n_enc, enc_hidden, n_dec, dec_hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < n_rows; ++r) {
    const long long need = plan(rows_host[r], S);
    if (need < 0 || rows_host[r].scratch_floats < need || rows_host[r].scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(rows_dev, rows_host, sizeof(Row) * n_rows,
                                  cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args A{};
  A.rows = static_cast<const Row*>(rows_dev);
  A.n_rows = n_rows;
  A.n_steps = n_steps; A.B = B; A.kind = kind; A.dual = dual != 0;
  A.n_enc = n_enc; A.n_dec = n_dec; A.tdv = tdv; A.moments_bf16 = moments_bf16;
  A.eps_const = eps_const; A.lr = lr;
  int blocks = 0, occ = 0;
  const int err = mlp_vae_grid(n_rows, &blocks, &occ);
  if (err != 0) return err;
  void* params[] = {&A};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mlp_vae_chunk_kernel), dim3(blocks),
                                  dim3(kThreads), params, sizeof(Row) * n_rows, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
