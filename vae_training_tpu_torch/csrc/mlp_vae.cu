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
// with the launch-wide flag moments_bf16, the Adam stage rounds the new m
// and v of every weight matrix of every stack to bfloat16, round to nearest
// even, every step, and the update reads the rounded values; biases,
// epsilon_p and epsilon keep f32 moments. Whether a slot is a matrix's comes
// from a per-thread cursor over the layout's layers that only moves forward
// (MatrixCursor), not from a scan of every layer for every slot. The stage
// is one pass over the row's slots, bf16 or not.
// The state stays float32 in device memory, holding values bfloat16
// represents exactly.
//
// What bounds it on this card: latency and the few SMs a row gets. At the
// sphere sweep's shapes (batch 100, 200|200|200 on both stacks, D = L = 6)
// a step is 100.6 MFLOP (K5-dual 151.4) in 16 dependent layer phases, 1.5 µs
// of the card's fp32 peak; step i + 1 needs step i's parameters, and a row's
// state (p, m, v, g: 4 × 166k floats, 2.7 MB) fits no SM. A phase pays a
// stage of its operands from L2, its sums, its epilogue and a cluster
// barrier; the sums are bound by shared-memory wavefronts, the rest by
// latency (PERF.md §5). The design:
//
// - One thread-block cluster per row: of kClusterWide = 16 CTAs (a
//   non-portable size) where the card holds enough such clusters to train
//   the launch's rows in no more turns than clusters of kCluster = 8 (the
//   portable maximum) would, else of 8; mlp_vae_grid picks the size from
//   the number of rows (a solo launch: 16; the sphere sweep's 15 rows: 15
//   clusters of 8, side by side). A launch has min(rows, the clusters the
//   card holds at once) clusters; cluster k trains rows k, k + n_clusters,
//   … in turn, each for the whole chunk. The launch is a plain cluster
//   launch (cudaLaunchKernelEx with a cluster dimension): no cooperative
//   launch and no grid-wide barrier. A row's phases are separated by
//   cluster barriers (cluster.sync(), release / acquire at cluster scope),
//   17 a step at 3 + 3 hidden layers, and rows on other clusters never wait
//   for each other.
// - Each layer's products (the forward in·W, g_W = [a_in, 1]ᵀ·G with g_b as
//   its last row, and g_in = G·Wᵀ, ReLU-masked) are cut into units of
//   32 × 16 outputs, or 8 × 16 where M or N is at most 16 (the top layers,
//   the first layers' g_W), one warp a unit: 4 × 4 outputs a lane (1 × 4 in
//   a narrow unit), so that a lane loads 8 floats a k for 16 FMAs. The
//   cluster's CTAs are qm × qn over a product's m- and n-tiles (qn the
//   largest power of two up to the n-tiles, so that a narrow product spreads
//   its rows); a CTA's warps take its units in turn. With the dual decoder
//   the Decoder's and the SigDecoder's products run side by side, each on
//   half the cluster (but the residual and g_s, which take both).
// - In the fp32 mode every output is one fp32 FMA chain over the whole
//   contraction in ascending k, the order of an fp32 GEMM's thread, so that
//   the kernel follows the fp32 plain version's trajectory as closely as
//   the kernel it replaces did: ReLU pre-activations and bf16 moments within
//   rounding of a boundary fall on the same side in both. (Tensor-core sums,
//   mma.sync TF32 in 3xTF32 and in 6xTF32, were measured and parted that
//   trajectory: PERF.md §6.) The bf16-dot mode sums on the tensor cores
//   (below). In both, no output's sum is split, so no result depends on the
//   cluster size, the cut of the products or the number of rows: a grid
//   row equals its solo launch bitwise, a 40-step launch a 15 + 25 split,
//   and --resume is bitwise.
// - Where data lives: the state (p, m, v) in the caller's buffers and the
//   row's activations and gradients in its scratch, all in device memory and
//   L2-resident (the sphere sweep's 15 rows hold ~40 MB of state and ~6 MB of
//   scratch against 50 MB of L2). Each product stages what its units read
//   into shared memory by cp.async, in chunks of the contraction: the CTA's
//   rows of the row operand (the layer's input activation, or its output
//   gradient), its slice of the column operand (W's columns, W's rows for
//   g_in, G's columns for g_W), zero-padded to whole tiles, with strides
//   that keep a quarter-warp's 16-byte loads free of bank conflicts; and,
//   with the first chunk, its slice of the epilogue's inputs (biases, z1,
//   z2, x, the ReLU input, mu), so that their loads overlap the operands'.
//   The chunk kc is the largest multiple of 4 whose stage fits (tiles();
//   kernels/mlp_vae.py's planner mirrors it): the whole contraction at every
//   sweep shape. The cluster barrier orders every read of data another CTA
//   wrote. The row and the launch's arguments live in shared memory, and a
//   product's descriptors in registers, so that no phase waits on a stack
//   load after a barrier.
// - Shared memory a CTA: kHeader (1 KB: the current row, the loss partials,
//   the arguments) plus the largest stage of the row's products; the launch
//   takes the largest over its rows. Sphere row 1: 88,576 B on 16 CTAs,
//   150,016 B on 8 (a 200-wide layer's g_in); sigmoid-MLP row 1: 150,016 B
//   and 192,512 B (a stack's products on half the cluster); every sweep
//   shape fits 232,448 B.
// - The loss sums (Σmu², Σr², Σr·z2) are taken by the cluster's last CTA in
//   a fixed order; Adam is one cluster stage over the row's P slots after
//   the backward, 1 − βᵗ in double, rounded once to float.
//
// Rows (the TPU kernel's scalar-prefetch rows [seed, t0, dd, ld, id],
// mlp_vae.py:157-167): every row of the device table carries its own state,
// dims, stack offsets, counters, Philox keys and scratch; batch, step count,
// ε, -tdv, lr, the manifold kind, the decoder head, the layer counts and the
// hidden widths are the launch's. A solo launch (K5) is the same kernel
// with a one-row table. Each CTA stages the row it trains into shared
// memory.
//
// bf16 dots (--precision bf16 on the card; the TPU kernel's default dot
// mode, dotf / dot_t1 / dot_t2 with prec = None at mlp_vae.py:193-205: bf16
// operands on the matrix unit, f32 sums): the kernel's kBf16 instantiation,
// chosen by the launch's bf16_dots, computes every layer product (the
// forward in·W, g_W = [a_in, 1]ᵀ·G, g_in = G·Wᵀ, g_s) on the tensor cores,
// mma.sync m16n8k16 with bf16 operands and f32 sums. A product of two
// bfloat16 values is exact in f32, so this is the reference's arithmetic;
// only the order of the f32 sums differs: each k16 step's partial on the
// tensor cores, then one IEEE add into the output's running f32 sum, in
// ascending k16 steps. A warp still owns whole units, 32 × 16 as 2 × 2
// tiles of 16 × 8 (a narrow unit: 16 × 16, one tile high), and sums each
// over the whole contraction, padded with zeros to a multiple of 16, so the
// bitwise properties above hold as in the fp32 mode. cp.async copies bytes,
// so the stage holds the f32 values: each lane reads its fragment pairs
// from it (8-byte loads where the layout holds k contiguous, two 4-byte
// loads where not; tiles() picks strides free of bank conflicts for both)
// and rounds each pair to bfloat16, round to nearest even, as it packs it
// (tc_sums). g_b, the last row of [a_in, 1]ᵀ·G, is a plain sum in the
// reference: it stays out of the mma, and the lanes that hold that row sum
// G's unrounded f32 values in ascending b. The linear_gaussian and sigmoid
// manifold draws (tiny FMA chains) round their operands on load (dot_op).
// The biases, the ReLU masks (from the unrounded activations), the loss
// sums, g_ep, Adam and the state stay f32. The mode's plan pads the
// contraction to 16 and takes other strides (tiles()), so its shared memory
// differs a little from the fp32 mode's: sphere row 1 93,184 B on 16 CTAs
// and 157,696 B on 8, sigmoid-MLP row 1 157,696 B and 201,728 B. The fp32
// instantiation is the fp32 mode's code, unchanged.
//
// True dimensions throughout: the TPU kernel's 128-lane padding, masks and
// live-row slicing are layout devices of the TPU and are not carried over;
// the tiles' zero padding is this kernel's own, and adds exact zeros.
//
// Plain C interface for ctypes: every entry returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxLayers = 8;  // Dense layers per stack
constexpr int kMaxRows = 256;  // rows a launch

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
  int s_g, s_nz, s_x, s_z1, s_z2, s_mu, s_s, s_r, s_gy, s_gu, s_gs, s_gmu;
  int s_buf[2], s_sbuf[2];  // ping-pong input gradients: decoder/encoder, SigDecoder
};
static_assert(sizeof(Row) % 16 == 0, "a row is staged in 16-byte words");

// The CTA's shared memory: kHeader bytes (the row, the loss partials),
// then the stage of the current product's operands. A symbol, not a
// pointer handed down, so that every access compiles to a shared-memory
// load or store.
extern __shared__ __align__(16) unsigned char mlp_smem[];

namespace {

using namespace mma;
using namespace philox;

// CTAs a row: the portable maximum cluster size, or the card's largest
// (non-portable) where that runs a launch's rows in no more turns
constexpr int kCluster = 8;
constexpr int kClusterWide = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 32;          // a unit: 32 × 16 outputs, one warp's,
constexpr int kTileN = 16;          // 4 × 4 a lane;
constexpr int kTileMNarrow = 8;     // 8 × 16, 1 × 4 a lane, where M or N ≤ 16
constexpr int kKStep = 4;           // contractions run four k at a time
constexpr int kTileMNarrowBf16 = 16;  // bf16 dots: a narrow unit is one m16 tile high,
constexpr int kKStepBf16 = 16;        // and contractions run in mma's k16 steps
constexpr int kSmemMax = 232448;    // shared memory a CTA can have on sm_90
constexpr int kHeader = 1024;       // the row and the loss partials, before the stage
constexpr int kStageBytes = kSmemMax - kHeader;


// Timing variants (chip_smoke.py phase 31); 0 in training.
constexpr int kSkipMma = 1;    // no layer sums (the stages still load)
constexpr int kSkipStage = 2;  // no staging of operands
constexpr int kSkipAdam = 4;   // no Adam stage
constexpr int kSkipWork = 8;   // nothing but the phases' cluster barriers

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
  const Row* rows;  // the device table
  int n_rows;
  int n_steps, B, kind, dual, n_enc, n_dec, tdv, moments_bf16, skip;
  float eps_const, lr;
};

// The shared-memory header: the current row, the loss partials, the
// launch's arguments (read by every phase: in shared memory, not on the
// stack, so that no phase waits on a local-memory load).
constexpr int kRedOffset = sizeof(Row);
constexpr int kArgsOffset = kRedOffset + 3 * kWarps * sizeof(float);
static_assert(kArgsOffset + sizeof(Args) <= kHeader, "the header fits");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// x rounded to the nearest bfloat16 (ties to even), back as a float.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A manifold draw's operand in the launch's dot mode: rounded to bfloat16
// in the bf16-dot instantiation, unchanged in the fp32 one.
template <bool kBf16>
__device__ __forceinline__ float dot_op(float x) {
  if constexpr (kBf16) return bf16_rn(x);
  else return x;
}

// The tile plan of one product out (M × N) = A (M × K) · B (K × N), `np`
// products of one shape side by side (the dual decoder's pairs), on a
// cluster of `cs` CTAs, with `ev` vectors (N) and `em` matrices (M × N) of
// epilogue inputs, in the fp32 or the bf16-dot mode (`bf16`). The outputs
// are cut into units of tm × kTileN (tm = kTileM, or where M or N is at
// most kTileN kTileMNarrow, in the bf16-dot mode kTileMNarrowBf16); the
// cluster's CTAs are qm × qn over the m-tiles and n-tiles (qn the largest
// power of two up to the n-tiles, so that a narrow product spreads its
// rows), mpc m-tiles and spc n-tiles a CTA. A is staged as [m][k] (a_t: as
// [k][m], its layout in device memory), B as [k][n] (b_t: [n][k]), rows and
// columns padded to whole tiles and the contraction to kKStep (bf16:
// kKStepBf16) with zeros; then the CTA's slice of the epilogue inputs. A
// stage of kc contraction columns takes 4 · (np · (alpha·kc + beta) +
// e_floats) bytes; kc is the largest multiple of the k step that fits
// kStageBytes (0: none does).
// kernels/mlp_vae.py:tiles mirrors this function.
struct Tiles {
  int tm, m_tiles, n_tiles, qn, mpc, spc, k_pad, kc, sa, sb, se, a_floats, b_floats, e_floats,
      bytes;
};

// The least 4·odd stride of at least x + 4 floats (x a multiple of 4): a
// quarter-warp's 16-byte loads along such rows fall in distinct banks.
__host__ __device__ inline int odd4(int x) { return (x / 4) % 2 == 0 ? x + 4 : x + 8; }

__host__ __device__ inline Tiles tiles(int M, int N, int K, bool a_t, bool b_t, int np, int cs,
                                       int ev, int em, bool bf16) {
  Tiles t;
  // a narrow product (the top layers', the first layers' g_W) in units of 8
  // rows (bf16 dots: 16, one mma tile): more of them, each a fraction of a
  // wide unit's latency
  t.tm = M > kTileN && N > kTileN ? kTileM : bf16 ? kTileMNarrowBf16 : kTileMNarrow;
  t.m_tiles = cdiv(M, t.tm);
  t.n_tiles = cdiv(N, kTileN);
  t.qn = 1;
  while (2 * t.qn <= cs && 2 * t.qn <= t.n_tiles) t.qn *= 2;
  t.mpc = cdiv(t.m_tiles, cs / t.qn);  // m-tiles a CTA
  t.spc = cdiv(t.n_tiles, t.qn);       // n-tiles a CTA
  const int ks = bf16 ? kKStepBf16 : kKStep;
  t.k_pad = cdiv(K, ks) * ks;
  const int mp = t.tm * t.mpc, ncp = kTileN * t.spc;
  t.se = ncp + 4;
  t.e_floats = ev * ncp + em * mp * t.se;
  // the [k][m] and [k][n] rows' padding: 8 floats (fp32: 8·odd strides for a
  // quarter-warp's 16-byte loads along m or n), 4 (bf16: 4·odd strides for
  // the fragments' 4-byte loads, 8 rows × 4 k pairs a warp)
  const int pad = bf16 ? 4 : 8;
  const int alpha = (a_t ? mp + pad : mp) + (b_t ? ncp : ncp + pad);
  const int beta = (a_t ? 0 : 8 * mp) + (b_t ? 8 * ncp : 0);
  const int per = (kStageBytes / 4 - t.e_floats) / np;
  int kc = per > beta ? (per - beta) / alpha / ks * ks : 0;
  if (kc > t.k_pad) kc = t.k_pad;
  t.kc = kc;
  // strides: [m][k] and [n][k] rows 4·odd floats (bf16: kc + 8, 8·odd, for
  // a half-warp's 8-byte fragment loads along k), [k][m] and [k][n] mp or
  // ncp + pad
  const int sk = bf16 ? t.kc + 8 : odd4(t.kc);
  t.sa = a_t ? mp + pad : sk;
  t.sb = b_t ? sk : ncp + pad;
  t.a_floats = a_t ? t.kc * t.sa : mp * t.sa;
  t.b_floats = b_t ? ncp * t.sb : t.kc * t.sb;
  t.bytes = kc > 0 ? 4 * (np * (t.a_floats + t.b_floats) + t.e_floats) : -1;
  return t;
}

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

// The shared memory a CTA of a cluster of `cs` needs for one row in the
// fp32 or the bf16-dot mode: the header and the largest stage of the row's
// products (the order of the phases: encoder forward, decoder forward,
// decoder backward, encoder backward); −1 if one does not fit.
int row_smem(const Row& R, const Shape& S, int cs, bool bf16) {
  int most = 0;
  bool fits = true;
  auto need = [&](int M, int N, int K, bool a_t, bool b_t, int np, int ev, int em, int ctas) {
    const Tiles t = tiles(M, N, K, a_t, b_t, np, ctas, ev, em, bf16);
    if (t.bytes < 0) fits = false;
    most = t.bytes > most ? t.bytes : most;
  };
  // the epilogues' inputs (epi_vecs, epi_mats): a hidden layer's bias; mu's
  // bias, epsilon_p and z1; the residual's biases, z2 and x; g_in's ReLU
  // input a_in; g_s's mu
  // (with the dual decoder, the decoder's products but the residual and g_s
  // on half the cluster: decoder_forward, decoder_backward)
  const int B = S.B, np = S.dual ? 2 : 1, half = S.dual ? cs / 2 : cs;
  for (int li = 0; li < R.enc.n; ++li) {
    const bool top = li + 1 == R.enc.n;
    need(B, R.enc.widths[li + 1], R.enc.widths[li], false, false, 1, top ? 2 : 1, top ? 1 : 0,
         cs);
  }
  for (int li = 0; li < R.dec.n; ++li) {
    const bool top = li + 1 == R.dec.n;
    need(B, R.dec.widths[li + 1], R.dec.widths[li], false, false, top ? np : 1, top ? np : 1,
         top ? 2 : 0, top ? cs : half);
  }
  for (int li = R.dec.n - 1; li >= 0; --li) {
    const int din = R.dec.widths[li], dout = R.dec.widths[li + 1];
    need(din + 1, dout, B, true, false, 1, 0, 0, half);  // [a_in, 1]ᵀ·G: g_W and g_b
    if (li > 0) need(B, din, dout, false, true, 1, 0, 1, half);
    else need(B, din, dout, false, true, np, 0, 1, cs);  // g_s
  }
  for (int li = R.enc.n - 1; li >= 0; --li) {
    const int din = R.enc.widths[li], dout = R.enc.widths[li + 1];
    need(din + 1, dout, B, true, false, 1, 0, 0, cs);
    if (li > 0) need(B, din, dout, false, true, 1, 0, 1, cs);
  }
  return fits ? kHeader + most : -1;
}

// Fills the planned fields of `R` from its dims and the launch's shape;
// returns the row's scratch size in floats, or −1 for shapes the kernel
// refuses, an offset that would overflow int, or a stage that would not fit.
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
  auto take = [&s](long long n) {  // 16-byte aligned, for the stages' vector loads
    const long long at = s;
    s += (n + 3) / 4 * 4;
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
  R.s_gy = take(b * D);
  R.s_gu = S.dual ? take(b * D) : 0;
  R.s_gs = take(b * L);
  R.s_gmu = take(b * L);
  R.s_buf[0] = take(b * hidden);
  R.s_buf[1] = take(b * hidden);
  R.s_sbuf[0] = S.dual ? take(b * hidden) : 0;
  R.s_sbuf[1] = S.dual ? take(b * hidden) : 0;
  // a stage on the wide cluster is never larger than on the portable one;
  // a launch checks its dot mode's too
  if (off > INT_MAX || s > INT_MAX || row_smem(R, S, kCluster, false) < 0) return -1;
  return s;
}

__device__ __forceinline__ float sigmoidf(float u) { return 1.0f / (1.0f + expf(-u)); }

// The decoder's log-variance ε of row R at this step (its epsilon slot
// changes only in the Adam stage).
__device__ __forceinline__ float row_eps(const Args& A, const Row& R) {
  return A.tdv ? R.p[R.o_eps] * A.eps_const : A.eps_const;
}

// A product's operand: a row-major matrix in device memory with row stride
// ld. `ones` ≥ 0 names a column past the matrix's last that reads as 1
// (the bias row of g_W = [a_in, 1]ᵀ·G, whose last row is g_b = Σ_b G(b, ·)).
struct Operand {
  const float* src;
  int ld;
  int ones;  // AT stages only: the staged column (m) that reads as 1
};

__device__ __forceinline__ Operand plain_operand(const float* src, int ld_) {
  return Operand{src, ld_, -1};
}

constexpr int kBatch = 8;  // loads a thread keeps in flight in its sums


// Asynchronous copies into shared memory (cp.async): `bytes` of them read
// from src, the rest of the 4 or 16 written as zeros.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}

// Rows [r0, r0 + nr_pad) × columns [c0, c0 + nc_pad) of op's matrix into
// dst (row stride `stride`) by cp.async, which the caller waits for;
// elements past nr live rows or nc live columns (counted from r0, c0; nc
// always reaches the matrix's row end) are 0. Warp w copies rows w,
// w + kWarps, …, its lanes along the row; where the rows and the block are
// 16-byte aligned (the scratch's activations and gradients) each copy moves
// 16 bytes.
__device__ void stage_block(float* dst, int stride, const Operand& op, int r0, int c0, int nr,
                            int nc, int nr_pad, int nc_pad) {
  const bool vec = (reinterpret_cast<uintptr_t>(op.src) & 15) == 0 &&
                   ((op.ld | c0 | nc_pad | stride) & 3) == 0;
  const int w = vec ? 4 : 1;  // floats a copy
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr_pad; r += kWarps) {
    const float* src = op.src + (r0 + r) * op.ld + c0;
    float* d = dst + r * stride;
    for (int c = w * lane; c < nc_pad; c += 32 * w) {
      const bool live = r < nr && c < nc;
      if (vec) cp_async16(d + c, live ? src + c : op.src, live ? 16 : 0);
      else cp_async4(d + c, live ? src + c : op.src, live ? 4 : 0);
    }
  }
}

// The cluster's threads: CTA q of cs; thread gt of gs, for the phases'
// elementwise items.
struct Team {
  int q, cs, gt, gs;
};

// The epilogues, one per kind of product; what each reads and writes.
enum EpiKind { kEpiHidden, kEpiMu, kEpiResidual, kEpiParamGrad, kEpiInputGrad, kEpiGradS };

// The epilogue's inputs: vectors over the product's columns and matrices
// of its shape, staged with the operands (row_smem() counts them so).
template <EpiKind KIND, int NP>
__host__ __device__ constexpr int epi_vecs() {
  return KIND == kEpiHidden ? 1 : KIND == kEpiMu ? 2 : KIND == kEpiResidual ? NP : 0;
}
template <EpiKind KIND>
__host__ __device__ constexpr int epi_mats() {
  return KIND == kEpiMu || KIND == kEpiInputGrad || KIND == kEpiGradS ? 1
         : KIND == kEpiResidual ? 2 : 0;
}

struct Epi {
  int ld;                 // the output's and the input matrices' row stride
  const float* vec[2];    // read at n
  const float* mat[2];    // read at (m, n)
  float* out[3];          // written at (m, n), by kind
  float c0, c1;           // constants, by kind
};

// Output (m, n), its sums v[p] (NP of them) and the staged inputs vec[j]
// (at n) and mat[j] (at (m, n)) through the epilogue `e`:
// kEpiHidden: out0 = max(v + vec0, 0) (vec0: the bias).
// kEpiMu: mu = out0 = v + vec0; s = out1 = mu + e^{vec1/2}·mat0 (bias,
//   epsilon_p, z1).
// kEpiResidual: x̂ = v₀ + vec0 (+ σ(v₁ + vec1) with the dual decoder),
//   r = (x̂ + mat0·c0) − mat1 (z2, x; c0 = e^{ε/2}) into out0, g_y = r·c1
//   into out1 (c1 = e^{−ε}/B), g_u = g_y·σ(1 − σ) into out2.
// kEpiParamGrad: rows m < c0 (din) of [a_in, 1]ᵀ·G into out0 (g_W, stride
//   ld), the last into out1[n] (g_b).
// kEpiInputGrad: out0 = v where mat0 (the ReLU's input a_in) > 0, else 0.
// kEpiGradS: g_s = v₀ (+ v₁) into out0, g_mu = g_s + mat0·c0 into out1.
template <EpiKind KIND, int NP>
__device__ __forceinline__ void epilogue(const Epi& e, int m, int n, const float (&v)[NP],
                                         const float (&vec)[2], const float (&mat)[2]) {
  const int i = m * e.ld + n;
  if constexpr (KIND == kEpiHidden) {
    e.out[0][i] = fmaxf(v[0] + vec[0], 0.0f);
  } else if constexpr (KIND == kEpiMu) {
    const float z = v[0] + vec[0];
    e.out[0][i] = z;
    e.out[1][i] = z + expf(vec[1] * 0.5f) * mat[0];
  } else if constexpr (KIND == kEpiResidual) {
    float x_hat = v[0] + vec[0];
    float sg = 0.0f;
    if (NP == 2) {
      sg = sigmoidf(v[NP - 1] + vec[1]);
      x_hat = sg + x_hat;
    }
    const float r = (x_hat + mat[0] * e.c0) - mat[1];
    const float gy = r * e.c1;
    e.out[0][i] = r;
    e.out[1][i] = gy;
    if (NP == 2) e.out[2][i] = gy * sg * (1.0f - sg);
  } else if constexpr (KIND == kEpiParamGrad) {
    if (m < static_cast<int>(e.c0)) e.out[0][i] = v[0];
    else e.out[1][n] = v[0];
  } else if constexpr (KIND == kEpiInputGrad) {
    e.out[0][i] = mat[0] > 0.0f ? v[0] : 0.0f;
  } else {  // kEpiGradS
    float acc = v[0];
    if (NP == 2) acc = acc + v[NP - 1];
    e.out[0][i] = acc;
    e.out[1][i] = acc + mat[0] * e.c0;
  }
}

// A lane's share of a unit: rows r0 + RPL·g + i, i < RPL (RPL = 4 in a
// unit of kTileM rows, 1 in a narrow one), and columns col(j), j < 4
// (g = lane / 4, t = lane % 4): c0 + 4t + j where B is staged [k][n],
// c0 + t + 4j where it is staged [n][k], so that a quarter-warp's 16-byte
// loads fall in distinct banks.
template <bool BT>
__device__ __forceinline__ int lane_col(int c0, int t, int j) {
  return BT ? c0 + t + 4 * j : c0 + 4 * t + j;
}

// Four contraction columns k … k + 3 of a lane's operands, in registers:
// x[i][u] = A(r + i, k + u), y[u][j] = B(k + u, col(j)), in 16-byte loads
// along k or along the rows and columns, whichever the layout holds
// contiguous (strides and k are multiples of 4).
template <bool AT, bool BT, int RPL>
struct LaneBlock {
  float x[RPL][4], y[4][4];
  __device__ __forceinline__ void load(const float* As, const float* Bs, int sa, int sb, int r,
                                       int c0, int t, int k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (AT && RPL == 4) {  // x[·][q]: rows r … r + 3 at k + q
        const float4 z = *reinterpret_cast<const float4*>(As + (k + q) * sa + r);
        x[0][q] = z.x; x[RPL > 1 ? 1 : 0][q] = z.y; x[RPL > 2 ? 2 : 0][q] = z.z;
        x[RPL - 1][q] = z.w;
      } else if (AT) {       // x[0][q]: row r at k + q
        x[0][q] = As[(k + q) * sa + r];
      } else if (q < RPL) {  // x[q][·]: row r + q at k … k + 3
        const float4 z = *reinterpret_cast<const float4*>(As + (r + q) * sa + k);
        x[q][0] = z.x; x[q][1] = z.y; x[q][2] = z.z; x[q][3] = z.w;
      }
      if (BT) {  // y[·][q]: column col(q) at k … k + 3
        const float4 z = *reinterpret_cast<const float4*>(Bs + lane_col<BT>(c0, t, q) * sb + k);
        y[0][q] = z.x; y[1][q] = z.y; y[2][q] = z.z; y[3][q] = z.w;
      } else {   // y[q][·]: columns col(0) … col(3) at k + q
        const float4 z = *reinterpret_cast<const float4*>(Bs + (k + q) * sb + lane_col<BT>(c0, t, 0));
        y[q][0] = z.x; y[q][1] = z.y; y[q][2] = z.z; y[q][3] = z.w;
      }
    }
  }
  // acc[i][j] += Σ_u x[i][u]·y[u][j], each output's FMAs in ascending k
  __device__ __forceinline__ void fma(float (&acc)[4][4]) const {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < RPL; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i][u], y[u][j], acc[i][j]);
  }
};

// A lane's sums over a stage's kcp contraction columns: acc[i][j] is
// (r + i, col(j)), i < RPL. Each output's FMA chain runs in ascending k,
// the order of an fp32 GEMM's thread.
template <bool AT, bool BT, int RPL>
__device__ __forceinline__ void lane_sums(float (&acc)[4][4], const float* As, const float* Bs,
                                          int sa, int sb, int r, int c0, int t, int kcp) {
  for (int k = 0; k < kcp; k += 4) {
    LaneBlock<AT, BT, RPL> blk;
    blk.load(As, Bs, sa, sb, r, c0, t, k);
    blk.fma(acc);
  }
}

// A warp's bf16-dot sums over a stage's kcp contraction columns (kcp a
// multiple of 16, the padding zeros): its unit's MT × 2 tiles of 16 × 8,
// rows r + 16·mi, columns c0 + 8·ni; acc[mi][ni] is the lane's quarter of
// tile (mi, ni) in mma.sync's accumulator fragment (rows g, g + 8, columns
// 2t, 2t + 1; g = lane / 4, t = lane % 4). Each k16 step reads the lane's
// fragment pairs, which lie along k, from the f32 stage: 8-byte loads where
// the layout holds k contiguous ([m][k], [n][k]; rows 8·odd floats apart, so
// that a half-warp's loads fall in distinct banks), two 4-byte loads where
// it does not ([k][m], [k][n]; 4·odd floats apart: a warp's 8 rows × 4 k
// pairs in distinct banks); rounds each pair to bfloat16 as it packs it;
// and issues the unit's MT × 2 mma, each from a zero accumulator: the step's
// partial sums are added to the outputs' running f32 sums by IEEE adds,
// round to nearest. (The tensor cores' own accumulation truncates: a sum
// carried through an output's 7-13 mma drifted toward zero enough to hold a
// K6b row's m at ρ 0.104-0.126 from the bf16 plain version, against
// 0.027-0.049 this way; PERF.md §6.) An output's sum runs over the k16
// steps in ascending order, whatever the chunk kc (a multiple of 16).
template <bool AT, bool BT, int MT>
__device__ __forceinline__ void tc_sums(float (&acc)[MT][2][4], const float* As, const float* Bs,
                                        int sa, int sb, int r, int c0, int g, int t, int kcp) {
#pragma unroll 2
  for (int k = 0; k < kcp; k += 16) {
    uint32_t fa[MT][4], fb[2][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)  // k + 2t (h = 0) or k + 8 + 2t (h = 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // row g (u = 0) or g + 8 (u = 1)
          const int row = r + 16 * mi + 8 * u + g, kk = k + 8 * h + 2 * t;
          fa[mi][2 * h + u] =
              AT ? bf16x2(As[kk * sa + row], As[(kk + 1) * sa + row])
                 : bf16x2(*reinterpret_cast<const float2*>(As + row * sa + kk));
        }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 8 * ni + g, kk = k + 8 * h + 2 * t;
        fb[ni][h] = BT ? bf16x2(*reinterpret_cast<const float2*>(Bs + col * sb + kk))
                       : bf16x2(Bs[kk * sb + col], Bs[(kk + 1) * sb + col]);
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, fa[mi], fb[ni][0], fb[ni][1]);
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mi][ni][x] += part[x];
      }
  }
}

// An int as a type, to pick a template instance by a runtime value.
template <int V>
struct IntTag {
  static constexpr int value = V;
};

// One cluster phase's product, NP of them side by side (the same shape;
// their sums reach the epilogue together): out (M × N) = A·B over K, A(m, k)
// = a[p] at m·ld + k (AT: k·ld + m), B(k, n) = b[p] at k·ld + n (BT:
// n·ld + k), then the epilogue KIND with `e`. CTA q of the cluster's cs
// takes m-tiles [(q / qn)·mpc, …) and n-tiles [(q % qn)·spc, …) and stages
// their operands and epilogue inputs together; its warp w computes units
// w, w + kWarps, … (a unit: an m-tile × an n-tile), each output's sum over
// the whole contraction in ascending k (the fp32 mode: one FMA chain; the
// bf16-dot mode, kBf16: one mma.sync accumulator over the k16 steps), so
// that no result depends on the cut.
template <bool AT, bool BT, int NP, EpiKind KIND, bool kBf16>
__device__ __forceinline__ void gemm(int M, int N, int K, const Operand* a, const Operand* b,
                                  Team tm, int skip, const Epi& e) {
  constexpr int NV = epi_vecs<KIND, NP>(), NM = epi_mats<KIND>();
  float* const stage = reinterpret_cast<float*>(mlp_smem + kHeader);
  const Tiles T = tiles(M, N, K, AT, BT, NP, tm.cs, NV, NM, kBf16);
  const int q = tm.q;
  const int mt_lo = (q / T.qn) * T.mpc, nt_lo = (q % T.qn) * T.spc;
  const int mt_n = min(T.mpc, T.m_tiles - mt_lo), nt_n = min(T.spc, T.n_tiles - nt_lo);
  const int mp = T.tm * T.mpc, ncp = kTileN * T.spc;
  const int m_lo = mt_lo * T.tm, n_lo = nt_lo * kTileN;
  const int units = mt_n > 0 && nt_n > 0 ? mt_n * nt_n : 0;
  const int n_chunks = cdiv(T.k_pad, T.kc);
  float* const Es = stage + NP * (T.a_floats + T.b_floats);  // the epilogue's inputs
  // One stage of contraction columns [k0, k0 + kcp) of every operand pair
  // (and, with the first, the epilogue's inputs).
  auto stage_chunk = [&](int k0, int kcp) {
    __syncthreads();  // the stage's last readers are done
    if (!(skip & kSkipStage)) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float* As = stage + p * (T.a_floats + T.b_floats);
        float* Bs = As + T.a_floats;
        if (AT)
          stage_block(As, T.sa, a[p], k0, m_lo, K - k0, (a[p].ones < 0 ? M : a[p].ones) - m_lo,
                      kcp, mp);
        else stage_block(As, T.sa, a[p], m_lo, k0, M - m_lo, K - k0, mp, kcp);
        if (BT) stage_block(Bs, T.sb, b[p], n_lo, k0, N - n_lo, K - k0, ncp, kcp);
        else stage_block(Bs, T.sb, b[p], k0, n_lo, K - k0, N - n_lo, kcp, ncp);
      }
      if (k0 == 0) {
#pragma unroll
        for (int j = 0; j < NV; ++j)
          stage_block(Es + j * ncp, ncp, Operand{e.vec[j], N, -1}, 0, n_lo, 1, N - n_lo, 1, ncp);
#pragma unroll
        for (int j = 0; j < NM; ++j)
          stage_block(Es + NV * ncp + j * mp * T.se, T.se, Operand{e.mat[j], e.ld, -1}, m_lo,
                      n_lo, M - m_lo, N - n_lo, mp, ncp);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // [a_in, 1]: after the copies' zeros have landed (the bf16-dot mode
      // sums the bias row apart, from G alone)
      const int ones = a[0].ones - m_lo;
      if (!kBf16 && AT && a[0].ones >= 0 && ones >= 0 && ones < mp) {
        __syncthreads();
        for (int r = threadIdx.x; r < kcp; r += kThreads) stage[r * T.sa + ones] = 1.0f;
      }
    }
    __syncthreads();
  };
  if (units == 0) return;  // uniform over the CTA
  if (n_chunks == 1) stage_chunk(0, T.k_pad);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kBf16) {
    // a unit is MT × 2 mma tiles of 16 × 8 (MT = 2 in a unit of kTileM rows,
    // 1 in a narrow one); the lane holds rows g, g + 8 and columns 2t, 2t + 1
    // of each
    auto run = [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      for (int s0 = 0; s0 < units; s0 += kWarps) {
        const int s = s0 + warp;
        const bool mine = s < units;       // uniform over the warp
        const int r = (s % mt_n) * T.tm;   // the unit's first row, in the CTA's rows
        const int c0 = (s / mt_n) * kTileN;  // its first column, in the CTA's
        // the unit's row that is [a_in, 1]'s bias row, or −1: g_b = Σ_b G(b, n)
        // is no product of rounded operands but G's f32 sum, in ascending b,
        // by the lanes that hold that row (4 columns each)
        const int bias = AT && a[0].ones >= 0 ? a[0].ones - m_lo - r : -1;
        const bool sums_bias = bias >= 0 && bias < T.tm && (bias & 7) == g;
        float acc[NP][MT][2][4], gb[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
              for (int x = 0; x < 4; ++x) acc[p][mi][ni][x] = 0.0f;
        for (int c = 0; c < n_chunks; ++c) {
          const int k0 = c * T.kc;
          const int kcp = min(T.kc, T.k_pad - k0);
          if (n_chunks > 1) stage_chunk(k0, kcp);  // every warp, unit or not
          if (!mine || (skip & kSkipMma)) continue;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const float* As = stage + p * (T.a_floats + T.b_floats);
            tc_sums<AT, BT, MT>(acc[p], As, As + T.a_floats, T.sa, T.sb, r, c0, g, t, kcp);
          }
          if (AT && sums_bias) {
            const float* Gs = stage + T.a_floats;  // G staged [k][n]
            for (int k = 0; k < min(kcp, K - k0); ++k)
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int x = 0; x < 2; ++x) gb[ni][x] += Gs[k * T.sb + c0 + 8 * ni + 2 * t + x];
          }
        }
        if (!mine) continue;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int rl = r + 16 * mi + 8 * u + g, m = m_lo + rl;  // rl: in the CTA's rows
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int cl = c0 + 8 * ni + 2 * t + x, n = n_lo + cl;
                if (m >= M || n >= N) continue;
                float v[NP], vec[2] = {0.0f, 0.0f}, mat[2] = {0.0f, 0.0f};
#pragma unroll
                for (int p = 0; p < NP; ++p) v[p] = acc[p][mi][ni][2 * u + x];
                if (AT && rl - r == bias) v[0] = gb[ni][x];
#pragma unroll
                for (int y = 0; y < NV; ++y) vec[y] = Es[y * ncp + cl];
#pragma unroll
                for (int y = 0; y < NM; ++y) mat[y] = Es[NV * ncp + y * mp * T.se + rl * T.se + cl];
                epilogue<KIND, NP>(e, m, n, v, vec, mat);
              }
          }
      }
    };
    if (T.tm == kTileM) run(IntTag<2>{});
    else run(IntTag<1>{});
  } else {
    auto run = [&](auto rpl) {
      constexpr int RPL = decltype(rpl)::value;
      for (int s0 = 0; s0 < units; s0 += kWarps) {
        const int s = s0 + warp;
        const bool mine = s < units;  // uniform over the warp
        const int r = (s % mt_n) * T.tm + RPL * g;  // the lane's first row, in the CTA's rows
        const int c0 = (s / mt_n) * kTileN;          // the unit's first column, in the CTA's
        float acc[NP][4][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.0f;
        for (int c = 0; c < n_chunks; ++c) {
          const int k0 = c * T.kc;
          const int kcp = min(T.kc, T.k_pad - k0);
          if (n_chunks > 1) stage_chunk(k0, kcp);  // every warp, unit or not
          if (!mine || (skip & kSkipMma)) continue;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const float* As = stage + p * (T.a_floats + T.b_floats);
            lane_sums<AT, BT, RPL>(acc[p], As, As + T.a_floats, T.sa, T.sb, r, c0, t, kcp);
          }
        }
        if (!mine) continue;
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const int m = m_lo + r + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cl = lane_col<BT>(c0, t, j), n = n_lo + cl;
            if (m >= M || n >= N) continue;
            float v[NP], vec[2] = {0.0f, 0.0f}, mat[2] = {0.0f, 0.0f};
#pragma unroll
            for (int p = 0; p < NP; ++p) v[p] = acc[p][i][j];
#pragma unroll
            for (int x = 0; x < NV; ++x) vec[x] = Es[x * ncp + cl];
#pragma unroll
            for (int x = 0; x < NM; ++x)
              mat[x] = Es[NV * ncp + x * mp * T.se + (r + i) * T.se + cl];
            epilogue<KIND, NP>(e, m, n, v, vec, mat);
          }
        }
      }
    };
    if (T.tm == kTileM) run(IntTag<4>{});
    else run(IntTag<1>{});
  }
}

// --- the per-step phases of one row ------------------------------------------

// x, z1, z2 of step `it` into the row's scratch (the external hook copies
// them).
template <bool kBf16>
__device__ __noinline__ void sample_phase(const Args& A, const Row& R, int it, Team tm) {
  const int B = A.B, D = R.D, L = R.L;
  float* S = R.scratch;
  float* x = S + R.s_x;
  float* z1 = S + R.s_z1;
  float* z2 = S + R.s_z2;
  if (R.ext_x != nullptr) {
    for (int item = tm.gt; item < B * (D + L); item += tm.gs) {
      if (item < B * D) {
        const size_t o = static_cast<size_t>(it) * B * D + item;
        x[item] = R.ext_x[o];
        z2[item] = R.ext_z2[o];
      } else {
        const int i = item - B * D;
        z1[i] = R.ext_z1[static_cast<size_t>(it) * B * L + i];
      }
    }
    return;
  }
  const uint32_t step = R.step0 + static_cast<uint32_t>(it);
  const int nw_l = (L + 3) / 4;
  const int nw_d = (D + 3) / 4;
  float n[4];
  for (int item = tm.gt; item < B + B * (nw_l + nw_d); item += tm.gs) {
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
        for (int k = 0; k < R.dd; ++k)
          acc = fmaf(dot_op<kBf16>(nz[k]), dot_op<kBf16>(R.a[k]), acc);
        for (int j = 0; j < D; ++j) xr[j] = j < R.dd ? nz[j] : 0.0f;
        xr[R.dd] = sigmoidf(acc);
      } else {
        for (int j = 0; j < D; ++j) {
          float acc = 0.0f;
          if (j < R.dd) {
            for (int k = 0; k < R.id; ++k)
              acc = fmaf(dot_op<kBf16>(nz[k]), dot_op<kBf16>(R.a[j * R.id + k]), acc);
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
  }
}

// Encoder layer li: z = in·W + b; ReLU on hidden layers; the last layer
// gives mu and s = mu + e^{ep/2}·z1.
template <bool kBf16>
__device__ __noinline__ void encoder_forward(const Args& A, const Row& R, int li,
                                             Team tm) {
  const Stack& st = R.enc;
  float* S = R.scratch;
  const int din = st.widths[li], dout = st.widths[li + 1];
  const Operand a = plain_operand(li == 0 ? S + R.s_x : S + st.act[li - 1], din);
  const Operand b = plain_operand(R.p + st.w_off[li], dout);
  Epi e{};
  e.ld = dout;
  e.vec[0] = R.p + st.b_off[li];
  if (li + 1 < st.n) {
    e.out[0] = S + st.act[li];
    gemm<false, false, 1, kEpiHidden, kBf16>(A.B, dout, din, &a, &b, tm, A.skip, e);
  } else {
    e.vec[1] = R.p + R.o_ep;
    e.mat[0] = S + R.s_z1;
    e.out[0] = S + R.s_mu;
    e.out[1] = S + R.s_s;
    gemm<false, false, 1, kEpiMu, kBf16>(A.B, dout, din, &a, &b, tm, A.skip, e);
  }
}

// With the dual decoder, the Decoder's and the SigDecoder's hidden-layer
// products (and their backward) run side by side, each on one half of the
// cluster: the stack of this CTA, and the team of its half.
__device__ __forceinline__ int stack_half(Team tm) { return tm.q / (tm.cs / 2); }
__device__ __forceinline__ Team half_team(Team tm) {
  return Team{tm.q % (tm.cs / 2), tm.cs / 2, tm.gt, tm.gs};
}

// Decoder layer li, and the SigDecoder's with the dual decoder. The last
// layer takes both stacks' sums at each output (b, o) and gives the
// residual r = (x̂ + z2·e^{ε/2}) − x, with x̂ = σ(u) + Dec(s), and the
// backward's top gradients: g_y = r·e^{−ε}/B and, with the dual decoder,
// g_u = g_y·σ(u)(1 − σ(u)).
template <bool kBf16>
__device__ __noinline__ void decoder_forward(const Args& A, const Row& R, int li,
                                             Team tm) {
  float* S = R.scratch;
  const int din = R.dec.widths[li], dout = R.dec.widths[li + 1];
  const Stack* stacks[2] = {&R.dec, &R.sig};
  Operand a[2], b[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Stack& st = *stacks[k];
    a[k] = plain_operand(li == 0 ? S + R.s_s : S + st.act[li - 1], din);
    b[k] = plain_operand(R.p + st.w_off[li], dout);
  }
  Epi e{};
  e.ld = dout;
  if (li + 1 < A.n_dec) {
    // with the dual decoder, each stack's product on its half of the cluster
    const int k = A.dual ? stack_half(tm) : 0;
    const Stack& st = k == 0 ? R.dec : R.sig;
    const Operand ak = plain_operand(li == 0 ? S + R.s_s : S + st.act[li - 1], din);
    const Operand bk = plain_operand(R.p + st.w_off[li], dout);
    e.vec[0] = R.p + st.b_off[li];
    e.out[0] = S + st.act[li];
    gemm<false, false, 1, kEpiHidden, kBf16>(A.B, dout, din, &ak, &bk,
                                             A.dual ? half_team(tm) : tm, A.skip, e);
    return;
  }
  const float eps = row_eps(A, R);
  e.vec[0] = R.p + R.dec.b_off[li];
  e.vec[1] = R.p + R.sig.b_off[li];
  e.mat[0] = S + R.s_z2;
  e.mat[1] = S + R.s_x;
  e.out[0] = S + R.s_r;
  e.out[1] = S + R.s_gy;
  e.out[2] = S + R.s_gu;
  e.c0 = expf(eps * 0.5f);
  e.c1 = expf(-eps) * (1.0f / static_cast<float>(A.B));
  if (A.dual) gemm<false, false, 2, kEpiResidual, kBf16>(A.B, dout, din, a, b, tm, A.skip, e);
  else gemm<false, false, 1, kEpiResidual, kBf16>(A.B, dout, din, a, b, tm, A.skip, e);
}

// The output gradient of decoder layer li (stack 0) or SigDecoder layer li
// (stack 1): at the top g_y (g_u), below it the layer above's input
// gradient.
__device__ __forceinline__ Operand decoder_grad(const Args& A, const Row& R, int stack, int li) {
  const float* S = R.scratch;
  const int dout = R.dec.widths[li + 1];
  if (li + 1 == A.n_dec) return plain_operand(S + (stack == 0 ? R.s_gy : R.s_gu), dout);
  return plain_operand(S + (stack == 0 ? R.s_buf : R.s_sbuf)[(li + 1) & 1], dout);
}

// This thread's fmaf chain over its share of f(i)·h(i), i < n: i = tid,
// tid + kThreads, … in turn, kBatch loads in flight at a time.
template <class F, class H>
__device__ __forceinline__ float thread_dot(int n, F f, H h) {
  float acc = 0.0f;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    float x[kBatch], y[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(i0 + u * kThreads, n - 1);
      x[u] = f(i);
      y[u] = h(i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < n) acc = fmaf(x[u], y[u], acc);
  }
  return acc;
}

// CTA-wide: the row's loss of step `it` and d loss / d epsilon, from Σmu²,
// Σr² and Σr·z2 taken in a fixed order (per-thread strides, then warp
// shuffles, then the warps' partials in order).
__device__ void loss_block(const Args& A, const Row& R, int it, float* red) {
  const float* S = R.scratch;
  const int tid = threadIdx.x;
  const int B = A.B;
  const auto mu = [&](int i) { return S[R.s_mu + i]; };
  const auto r = [&](int i) { return S[R.s_r + i]; };
  const auto z2 = [&](int i) { return S[R.s_z2 + i]; };
  float a0 = thread_dot(B * R.L, mu, mu);
  float a1 = thread_dot(B * R.D, r, r);
  float a2 = thread_dot(B * R.D, r, z2);
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
  __syncthreads();  // `red` is free again
}

// One layer's parameter gradients from its output gradient G (B × dout)
// and input activation a_in (B × din) in one product: [a_in, 1]ᵀ·G, whose
// first din rows are g_W and whose last is g_b = Σ_b G(b, ·).
template <bool kBf16>
__device__ void param_grads(const Args& A, const Row& R, const Stack& st, int li,
                            const Operand& G, const float* a_in, Team tm) {
  const int din = st.widths[li], dout = st.widths[li + 1];
  float* g = R.scratch + R.s_g;
  const Operand a{a_in, din, din};
  Epi e{};
  e.ld = dout;
  e.out[0] = g + st.w_off[li];
  e.out[1] = g + st.b_off[li];
  e.c0 = static_cast<float>(din);
  gemm<true, false, 1, kEpiParamGrad, kBf16>(din + 1, dout, A.B, &a, &G, tm, A.skip, e);
}

// The masked input gradient of layer li > 0: g_in = (G·Wᵀ)·[a_in > 0] into
// `out` (B × din).
template <bool kBf16>
__device__ void input_grad(const Args& A, const Row& R, const Stack& st, int li,
                           const Operand& G, const float* a_in, float* out, Team tm) {
  const int din = st.widths[li], dout = st.widths[li + 1];
  const Operand w = plain_operand(R.p + st.w_off[li], dout);
  Epi e{};
  e.ld = din;
  e.mat[0] = a_in;
  e.out[0] = out;
  gemm<false, true, 1, kEpiInputGrad, kBf16>(A.B, din, dout, &G, &w, tm, A.skip, e);
}

// Decoder layer li's backward, and the SigDecoder's: each stack's g_W and
// g_b and, below the first layer, its masked input gradient; at the first
// layer g_s = g_s,dec + g_s,sig with g_mu = g_s + mu/B. At the top, the
// cluster's last CTA also takes the row's loss (at 200-wide hidden layers
// it has no tile of the top layer's [a_in, 1]ᵀ·G).
template <bool kBf16>
__device__ __noinline__ void decoder_backward(const Args& A, const Row& R, int it, int li,
                                              Team tm, float* red) {
  if (li + 1 == A.n_dec && tm.q == tm.cs - 1) loss_block(A, R, it, red);
  float* S = R.scratch;
  {  // with the dual decoder, each stack's products on its half of the cluster
    const int k = A.dual ? stack_half(tm) : 0;
    const Stack& st = k == 0 ? R.dec : R.sig;
    const Operand Gk = decoder_grad(A, R, k, li);
    const Team sub = A.dual ? half_team(tm) : tm;
    const float* a_in = li == 0 ? S + R.s_s : S + st.act[li - 1];
    param_grads<kBf16>(A, R, st, li, Gk, a_in, sub);
    if (li > 0)
      input_grad<kBf16>(A, R, st, li, Gk, a_in, S + (k == 0 ? R.s_buf : R.s_sbuf)[li & 1],
                        sub);
  }
  if (li > 0) return;
  // the gradient at s, the input of both stacks, on the whole cluster
  const Operand G[2] = {decoder_grad(A, R, 0, li), decoder_grad(A, R, 1, li)};
  const Operand W[2] = {plain_operand(R.p + R.dec.w_off[li], R.dec.widths[li + 1]),
                        plain_operand(R.p + R.sig.w_off[li], R.dec.widths[li + 1])};
  Epi e{};
  e.ld = R.L;
  e.mat[0] = S + R.s_mu;
  e.out[0] = S + R.s_gs;
  e.out[1] = S + R.s_gmu;
  e.c0 = 1.0f / static_cast<float>(A.B);
  const int dout = R.dec.widths[1];
  if (A.dual) gemm<false, true, 2, kEpiGradS, kBf16>(A.B, R.L, dout, G, W, tm, A.skip, e);
  else gemm<false, true, 1, kEpiGradS, kBf16>(A.B, R.L, dout, G, W, tm, A.skip, e);
}

// The fmaf chain over b < n of f(b)·h(b), in ascending b, on one warp: the
// lanes load 32 b at a time, lane 0's chain reads them by shuffle (every
// lane ends with the sum).
template <class F, class H>
__device__ __forceinline__ float warp_dot(int n, F f, H h) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int b0 = 0; b0 < n; b0 += 32) {
    const int b = min(b0 + lane, n - 1);
    const float x = f(b), y = h(b);
    for (int k = 0; k < 32 && b0 + k < n; ++k)
      acc = fmaf(__shfl_sync(0xffffffffu, x, k), __shfl_sync(0xffffffffu, y, k), acc);
  }
  return acc;
}

// Encoder layer li's backward from g_mu (top) or the layer above's input
// gradient; the top layer's phase also takes g_ep, one latent dim a warp
// of the cluster's last CTA (as the loss, beside the top layer's tiles).
template <bool kBf16>
__device__ __noinline__ void encoder_backward(const Args& A, const Row& R, int li,
                                              Team tm) {
  float* S = R.scratch;
  const Stack& st = R.enc;
  const bool top = li + 1 == A.n_enc;
  if (top) {
    for (int k = tm.q == tm.cs - 1 ? threadIdx.x >> 5 : R.L; k < R.L; k += kWarps) {
      const float acc = warp_dot(
          A.B, [&](int b) { return S[R.s_gs + b * R.L + k]; },
          [&](int b) { return S[R.s_z1 + b * R.L + k]; });
      const float ep = R.p[R.o_ep + k];
      if ((threadIdx.x & 31) == 0)
        S[R.s_g + R.o_ep + k] = acc * 0.5f * expf(ep * 0.5f) + 0.5f * (expf(ep) - 1.0f);
    }
  }
  const Operand G = plain_operand(S + (top ? R.s_gmu : R.s_buf[(li + 1) & 1]),
                                  st.widths[li + 1]);
  const float* a_in = li == 0 ? S + R.s_x : S + st.act[li - 1];
  param_grads<kBf16>(A, R, st, li, G, a_in, tm);
  if (li > 0) input_grad<kBf16>(A, R, st, li, G, a_in, S + R.s_buf[li & 1], tm);
}

// Whether slot i of a row's layout lies in a weight matrix (bf16 moments
// round those): a cursor over the layout's layers (the encoder's, the
// decoder's, the SigDecoder's; epsilon_p and epsilon lie between the
// second and the third stack) that only moves forward, for a thread whose
// slots ascend.
struct MatrixCursor {
  const Row& R;
  int st = 0, li = 0;
  __device__ __forceinline__ const Stack& stack() const {
    return st == 0 ? R.enc : st == 1 ? R.dec : R.sig;
  }
  __device__ __forceinline__ bool matrix(int i) {
    while (st < 3) {
      const Stack& s = stack();
      if (li < s.n && i < s.b_off[li] + s.widths[li + 1]) break;  // inside layer li or before it
      if (li + 1 < s.n) {
        ++li;
      } else {
        ++st;
        li = 0;
      }
    }
    if (st == 3) return false;
    const Stack& s = stack();
    return i >= s.w_off[li] && i < s.b_off[li];
  }
};

// Adam (optax.adam: bias-corrected m̂/(√v̂ + eps)) over the row's P slots
// in one pass on the cluster's threads: slot i = gt, gt + gs, …, kBatch of
// them loaded before any is stored. With bf16 moments (K4) the new m and v
// of a weight matrix's slot are rounded before the update reads them. The
// corrections 1 − βᵗ in double, rounded once to float, as in K1;
// t = t0 + it + 1.
__device__ __noinline__ void adam_stage(const Args& A, const Row& R, int it, Team tm) {
  const int t = R.t0 + it + 1;
  const float bc1 = static_cast<float>(1.0 - pow(0.9, static_cast<double>(t)));
  const float bc2 = static_cast<float>(1.0 - pow(0.999, static_cast<double>(t)));
  const float lr = A.lr;
  const int P = R.P;
  const float* g = R.scratch + R.s_g;
  float* p = R.p;
  float* m = R.m;
  float* v = R.v;
  MatrixCursor cur{R};
  for (int i0 = tm.gt; i0 < P; i0 += tm.gs * kBatch) {
    float gv[kBatch], mv[kBatch], vv[kBatch], pv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(i0 + u * tm.gs, P - 1);
      gv[u] = g[i];
      mv[u] = m[i];
      vv[u] = v[i];
      pv[u] = p[i];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * tm.gs;
      if (i >= P) break;
      // the fp32 plain version's roundings: b1·m, then + (1 − b1)·g fused;
      // b2·v, then + ((1 − b2)·g)·g fused
      float m_ = __fmaf_rn(kOneMinusB1, gv[u], __fmul_rn(kB1, mv[u]));
      float v_ = __fmaf_rn(__fmul_rn(kOneMinusB2, gv[u]), gv[u], __fmul_rn(kB2, vv[u]));
      if (A.moments_bf16 && cur.matrix(i)) {
        m_ = bf16_rn(m_);
        v_ = bf16_rn(v_);
      }
      const float step = lr * ((m_ / bc1) / (sqrtf(v_ / bc2) + kAdamEps));
      m[i] = m_;
      v[i] = v_;
      p[i] = pv[u] - step;
    }
  }
}

// The whole chunk of one row on its cluster: 17 cluster phases a step at
// 3 + 3 hidden layers.
template <bool kBf16>
__device__ void train_row(const Args& A, const Row& R, Team tm, float* red) {
  cg::cluster_group cluster = cg::this_cluster();
  const bool work = !(A.skip & kSkipWork);
  if (work) sample_phase<kBf16>(A, R, 0, tm);
  cluster.sync();
  for (int it = 0; it < A.n_steps; ++it) {
    for (int li = 0; li < A.n_enc; ++li) {  // encoder forward: x → mu, s
      if (work) encoder_forward<kBf16>(A, R, li, tm);
      cluster.sync();
    }
    for (int li = 0; li < A.n_dec; ++li) {  // decoder(s) forward: s → r = y − x
      if (work) decoder_forward<kBf16>(A, R, li, tm);
      cluster.sync();
    }
    for (int li = A.n_dec - 1; li >= 0; --li) {  // decoder(s) backward → g_s, g_mu
      if (work) decoder_backward<kBf16>(A, R, it, li, tm, red);
      cluster.sync();
    }
    for (int li = A.n_enc - 1; li >= 0; --li) {  // encoder backward, g_ep
      if (work) encoder_backward<kBf16>(A, R, li, tm);
      cluster.sync();
    }
    // Adam, and the next step's noise (which reads no parameter)
    if (work && !(A.skip & kSkipAdam)) adam_stage(A, R, it, tm);
    if (it + 1 < A.n_steps) {
      if (work) sample_phase<kBf16>(A, R, it + 1, tm);
      cluster.sync();
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) mlp_vae_chunk_kernel(Args A) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  if (cs != kCluster && cs != kClusterWide) __trap();  // launched without its cluster
  Row* row = reinterpret_cast<Row*>(mlp_smem);
  float* red = reinterpret_cast<float*>(mlp_smem + kRedOffset);
  Args* args = reinterpret_cast<Args*>(mlp_smem + kArgsOffset);
  if (threadIdx.x == 0) *args = A;
  const int q = static_cast<int>(cluster.block_rank());
  const Team tm{q, cs, q * kThreads + static_cast<int>(threadIdx.x), cs * kThreads};
  const int n_clusters = gridDim.x / cs;
  constexpr int kWords = sizeof(Row) / sizeof(uint4);
  for (int r = blockIdx.x / cs; r < A.n_rows; r += n_clusters) {
    __syncthreads();  // the previous row's readers of `row` are done
    const uint4* src = reinterpret_cast<const uint4*>(A.rows + r);
    for (int i = threadIdx.x; i < kWords; i += kThreads) reinterpret_cast<uint4*>(row)[i] = src[i];
    __syncthreads();
    train_row<kBf16>(*args, *row, tm, red);
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

// The launch configuration: `clusters` clusters of `cs` CTAs, smem bytes
// of dynamic shared memory each.
void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int clusters, int cs,
                   size_t smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cs * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// The kernel of a dot mode: the fp32 one, or the bf16-dot one.
using KernelFn = void (*)(Args);
KernelFn kernel_of(int bf16_dots) {
  return bf16_dots ? mlp_vae_chunk_kernel<true> : mlp_vae_chunk_kernel<false>;
}

// The clusters of `cs` CTAs with `smem` bytes each that the card holds at
// once of `kernel` (0 where it holds none, or refuses the size).
cudaError_t fit_clusters(KernelFn kernel, int cs, int smem, int* most) {
  *most = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cs > 8)  // the portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, 1, cs, static_cast<size_t>(smem), nullptr);
  if (cudaOccupancyMaxActiveClusters(most, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a size the card refuses: none fit
    *most = 0;
  }
  return cudaSuccess;
}

// What the last launch used (mlp_vae_last_launch).
int g_last_clusters = 0, g_last_cluster_size = 0, g_last_smem = 0;

// mlp_vae_grid's plan for `kernel` (the dot mode's).
int grid_plan(KernelFn kernel, int n_rows, const int* smem, int request, int* clusters,
              int* cluster_size, int* max_clusters) {
  if (n_rows < 1 || n_rows > kMaxRows || (request != 0 && request != kCluster &&
                                          request != kClusterWide))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sizes[2] = {kCluster, kClusterWide};
  int most[2] = {0, 0};
  for (int k = 0; k < 2; ++k) {
    if (smem[k] < kHeader || smem[k] > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (request != 0 && request != sizes[k]) continue;
    const cudaError_t err = fit_clusters(kernel, sizes[k], smem[k], &most[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto turns = [&](int k) { return most[k] < 1 ? INT_MAX : cdiv(n_rows, most[k]); };
  const int k = request == kCluster ? 0 : request == kClusterWide ? 1 :
                turns(1) <= turns(0) ? 1 : 0;
  if (most[k] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the chosen size's attributes stand for the launch
  const cudaError_t err = fit_clusters(kernel, sizes[k], smem[k], &most[k]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *clusters = n_rows < most[k] ? n_rows : most[k];
  *cluster_size = sizes[k];
  *max_clusters = most[k];
  return 0;
}

}  // namespace

extern "C" {

const char* mlp_vae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

size_t mlp_vae_row_bytes() { return sizeof(Row); }

// The cluster sizes a launch chooses from: the portable one, the wide one.
void mlp_vae_cluster_sizes(int* sizes) {
  sizes[0] = kCluster;
  sizes[1] = kClusterWide;
}

int mlp_vae_threads() { return kThreads; }

// Plans `row` (its layout and scratch offsets, from its dims and the
// launch's shape, in place) and returns the scratch floats it needs, or −1
// for shapes the kernel refuses.
long long mlp_vae_plan_row(Row* row, int B, int kind, int dual, int n_enc,
                           const int* enc_hidden, int n_dec, const int* dec_hidden) {
  Shape S;
  if (!fill_shape(S, B, kind, dual, n_enc, enc_hidden, n_dec, dec_hidden)) return -1;
  return plan(*row, S);
}

// The shared memory a CTA of a cluster of `cs` needs for a row of dims
// (D, L) at this shape in the dot mode `bf16_dots`, or −1
// (kernels/mlp_vae.py:smem_bytes mirrors it).
int mlp_vae_smem_bytes(int B, int D, int L, int dual, int n_enc, const int* enc_hidden,
                       int n_dec, const int* dec_hidden, int cs, int bf16_dots) {
  Shape S;
  if (!fill_shape(S, B, kSphere, dual, n_enc, enc_hidden, n_dec, dec_hidden)) return -1;
  Row R{};
  R.D = D; R.L = L;
  if (!fill_stack(R.enc, S.n_enc, D, S.enc_hidden, L) ||
      !fill_stack(R.dec, S.n_dec, L, S.dec_hidden, D) || B < 1 || D < 1 || L < 1 ||
      (cs != kCluster && cs != kClusterWide))
    return -1;
  return row_smem(R, S, cs, bf16_dots != 0);
}

// The cluster plan of a launch of `n_rows` rows whose CTAs need smem[0]
// bytes of shared memory on clusters of kCluster and smem[1] on clusters
// of kClusterWide, on the current device: `clusters` clusters of
// `cluster_size` CTAs, min(n_rows, `max_clusters`, the clusters of that
// size the card holds at once). `request` 0 takes the size that trains the
// rows in the fewest turns, the wide one on a tie (a row's phases then
// spread over twice the SMs); kCluster or kClusterWide names one. The plan
// of the dot mode `bf16_dots`'s kernel, whose smem the caller gives.
int mlp_vae_grid(int n_rows, const int* smem, int request, int bf16_dots, int* clusters,
                 int* cluster_size, int* max_clusters) {
  return grid_plan(kernel_of(bf16_dots), n_rows, smem, request, clusters, cluster_size,
                   max_clusters);
}

// The clusters, their size and the shared memory of the last launch.
void mlp_vae_last_launch(int* clusters, int* cluster_size, int* smem) {
  *clusters = g_last_clusters;
  *cluster_size = g_last_cluster_size;
  *smem = g_last_smem;
}

// K5 (one row) and K6b (many): `n_steps` steps of every row of the table in
// one cluster launch. The rows are planned here, in `rows_host`, and the
// table copied in stream order to `rows_dev` (n_rows × sizeof(Row) bytes of
// device memory the caller owns); every row's scratch must hold what its
// plan needs. `cluster` is the cluster size (0: mlp_vae_grid's choice);
// `bf16_dots` picks the bf16-dot kernel; `skip` is 0 in training (timing
// variants otherwise).
int mlp_vae_chunk(Row* rows_host, void* rows_dev, int n_rows, int n_steps, int B, int kind,
                  int dual, int n_enc, const int* enc_hidden, int n_dec, const int* dec_hidden,
                  float eps_const, int tdv, float lr, int moments_bf16, int bf16_dots,
                  int cluster, int skip, void* stream) {
  Shape S;
  if (n_rows < 1 || n_rows > kMaxRows || n_steps < 1 || skip < 0 ||
      skip > (kSkipMma | kSkipStage | kSkipAdam | kSkipWork) ||
      !fill_shape(S, B, kind, dual, n_enc, enc_hidden, n_dec, dec_hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  int smem[2] = {kHeader, kHeader};
  for (int r = 0; r < n_rows; ++r) {
    const long long need = plan(rows_host[r], S);
    if (need < 0 || rows_host[r].scratch_floats < need || rows_host[r].scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int s8 = row_smem(rows_host[r], S, kCluster, bf16_dots != 0);
    const int s16 = row_smem(rows_host[r], S, kClusterWide, bf16_dots != 0);
    if (s8 < 0 || s16 < 0) return static_cast<int>(cudaErrorInvalidValue);
    smem[0] = s8 > smem[0] ? s8 : smem[0];
    smem[1] = s16 > smem[1] ? s16 : smem[1];
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
  A.skip = skip;
  A.eps_const = eps_const; A.lr = lr;
  int clusters = 0, cs = 0, most = 0;
  const KernelFn kernel = kernel_of(bf16_dots);
  const int err = grid_plan(kernel, n_rows, smem, cluster, &clusters, &cs, &most);
  if (err != 0) return err;
  const int bytes = cs == kCluster ? smem[0] : smem[1];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, clusters, cs, static_cast<size_t>(bytes), st);
  e = cudaLaunchKernelEx(&cfg, kernel, A);
  if (e != cudaSuccess) return static_cast<int>(e);
  g_last_clusters = clusters;
  g_last_cluster_size = cs;
  g_last_smem = bytes;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
