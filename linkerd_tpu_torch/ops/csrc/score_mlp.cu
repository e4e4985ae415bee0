// Fused anomaly-scoring forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas kernel linkerd_tpu/ops/scoring.py::_score_kernel
// (launched by fused_anomaly_scores). One launch computes, for the n live
// rows of a row-major float32 [rows >= n, in_dim] feature tensor:
//
//   x32    = mu ? (x - mu) * rsqrtf(var + 1e-2) : x        (float32)
//   z      = encoder(bf16(x32))             ReLU after every layer
//   recon  = decoder(z)                     ReLU except after the last
//   logit  = classifier(z)                  ReLU except after the last
//   score  = w * tanh(mean((recon - x32)^2)) + (1 - w) * sigmoid(logit)
//
// with the reference's rounding points: every layer takes the float32 sum
// of bf16 x bf16 products, rounds it to bf16, adds the bf16 bias and
// rounds again, then applies ReLU. The reconstruction error is the mean
// over the in_dim live columns, taken against the float32 x32, never its
// bf16 copy; tanh and the sigmoid run in float32.
//
// Bound on the H100 (default model 36-256-128-32 / 32-128-256-36 /
// 32-128-1): 96,384 MACs = 192,768 FLOP per row, so 0.20 GFLOP at 1024
// rows, about 0.2 us at the 989 TFLOP/s bf16 dense peak; the bytes are
// 147 KB of x, 4 KB of scores and 195 KB of bf16 weights, about 0.1 us
// at 3.35 TB/s. The kernel is bound by operations.
//
// Design. What limits a batch of this model is not the tensor cores'
// rate but one block's chain of 8 dependent layers, each of which needs
// the layer's weights streamed from L2 into the block's shared memory.
// So the design keeps that stream running ahead of the products and
// keeps the products' own chain short:
//
// - Tensor cores: each layer is a [ROWS x K] . [K x N] product on
//   mma.sync.m16n8k16 (bf16 operands, float32 accumulator), operands
//   loaded from shared memory with ldmatrix. mma.sync and not wgmma:
//   a block holds 16 rows and a layer at most 256 columns, while wgmma
//   takes a 64-row tile per warpgroup, and mma.sync's documented fragment
//   layout lets the epilogue round, add the bias and apply ReLU per
//   element in registers.
// - Weights staged asynchronously by a producer warp: pack_params
//   (ops/scoring.py) lays the model out once as one bf16 buffer: the
//   biases, then each layer's W zero-padded to [kpad][wstride] (K to a
//   multiple of 16, N to a multiple of 8, the row stride an odd number
//   of 16-byte units so ldmatrix.trans is free of bank conflicts), in
//   execution order (encoder, classifier, decoder). One lane of a ninth
//   warp streams it through a ring of STAGES shared-memory stages, one
//   TMA bulk copy (cp.async.bulk) per stage, each stage one layer's
//   K-chunk of as many 16-row steps as fit; "full" mbarriers count the
//   bytes in and "empty" mbarriers the consumer warps out, so the stream
//   runs up to STAGES chunks ahead, across layer boundaries. A ring and
//   not all weights resident: pack_params accepts 16 layers of width
//   256, far more than 227 KB. The x tile, mu and var come in by
//   cp.async (LDGSTS) while the first chunks stream.
// - Row tiles that share the staged weights: a block owns ROWS = 16 rows
//   and eight consumer warps; warp w owns the n8 tiles w, w + 8, w + 16,
//   w + 24 of each layer, with its tile count a template argument (no
//   predicated ldmatrix or mma), the next k-step's operands loading
//   while this one multiplies, and two accumulator sets where it owns
//   one tile. 16, 32 and 64 rows a block were timed on the H100
//   (chip_smoke.py --sweep; PERF.md): 16 is fastest from 1 to 1024 rows
//   and still fits two blocks on an SM for 4096.
// - Activations stay in shared memory, three bf16 [ROWS][AST] buffers
//   (the bottleneck z stays put while the classifier and then the
//   decoder ping-pong through the other two); AST = 264 keeps ldmatrix
//   free of bank conflicts. Padded weights and biases are zero, so a
//   padded output column is bf16(bf16(0) + 0) = 0 and padded K adds
//   nothing: the result is the unpadded model's. The epilogue also
//   zeroes the columns up to the next layer's 16-padded K. One named
//   barrier of the consumer warps per layer publishes its output.
// - The reconstruction error is taken over the in_dim live columns
//   against the float32 x tile kept in shared memory.
// - Ragged batches are masked, never padded: rows >= n load as zero and
//   are not stored.
//
// Built without --use_fast_math. Only the summation order inside a layer
// differs from the plain version (as it does between any two GEMMs).
// Registers, shared memory and spills from -Xptxas -v are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int ROWS = 16;         // rows per block
constexpr int MT = ROWS / 16;    // m16 row tiles per block
constexpr int WARPS = 8;         // consumer warps: the products
constexpr int THREADS = (WARPS + 1) * 32;  // and one producer warp
constexpr int MAXW = 256;        // widest layer (and in_dim) accepted
constexpr int MAX_LAYERS = 16;
constexpr int NT_PER_WARP = MAXW / 8 / WARPS;  // n8 tiles a warp owns
constexpr int AST = MAXW + 8;    // activation row stride, bf16
constexpr int STAGE = 8704;      // bf16 a stage holds (17 KB)
constexpr int MAX_BIAS = MAX_LAYERS * MAXW;
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may take
// shared memory: activations, biases, mu and var, logits, the x tile
// (float32 [ROWS][in_dim], sized per launch) and, in what is left, a
// ring of up to 4 stages and their two barriers each
constexpr int SMEM_OTHER = (3 * ROWS * AST + MAX_BIAS) * 2 +
                           (2 * MAXW + ROWS) * 4 + ROWS * MAXW * 4;
constexpr int STAGES = (SMEM_LIMIT - SMEM_OTHER) / (STAGE * 2 + 16) < 4
                           ? (SMEM_LIMIT - SMEM_OTHER) / (STAGE * 2 + 16)
                           : 4;
constexpr int SMEM_FIXED = (3 * ROWS * AST + STAGES * STAGE + MAX_BIAS) * 2 +
                           (2 * MAXW + ROWS) * 4 + 2 * STAGES * 8;
constexpr int SMEM_MAX = SMEM_FIXED + ROWS * MAXW * 4;

static_assert(ROWS % 16 == 0 && ROWS % WARPS == 0, "whole m16 tiles");
static_assert(16 * (MAXW + 8) <= STAGE, "a 16-row chunk fits a stage");
static_assert(STAGES >= 2 && SMEM_MAX <= SMEM_LIMIT, "fits one SM");

enum { RELU = 1, LOGIT = 2 };

// One layer as pack_params lays it out; offsets in bf16 elements of the
// packed buffer. in/out name activation buffers 0..2.
struct Layer {
  int w_off, b_off, kpad, npad, wstride, in, out, flags;
};

struct Table {
  Layer l[MAX_LAYERS];
  int n_layers;
  int bias_len;  // bf16 of biases at the buffer's start, a multiple of 8
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a layer's output element from its float32 sum and bf16 bias
__device__ __forceinline__ float finish(float acc, float b, bool relu) {
  const float h = round_bf16(round_bf16(acc) + b);
  return relu ? fmaxf(h, 0.f) : h;
}

// x32 of one feature: the z-score folded in when mu is given
__device__ __forceinline__ float zscore(float v, int d, bool fold,
                                        const float* mu, const float* var) {
  if (fold) v = (v - mu[d]) * rsqrtf(var[d] + 1e-2f);
  return v;
}

// the consumer warps alone (the producer takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
}

// rows of a layer's K that one stage holds: whole 16-row steps
__device__ __forceinline__ int chunk_rows(int kpad, int wstride) {
  return min(kpad, STAGE / wstride / 16 * 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the next phase of `bar` also waits for `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A fragment of a 16x16 tile of a row-major bf16 matrix
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// B fragment of a 16x8 tile of a row-major [k][n] bf16 matrix
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// the operands of one 16-deep k-step: A for every row tile, B for
// every n8 tile the warp owns
template <int TILES>
struct Frag {
  uint32_t a[MT][4], b[TILES > 0 ? TILES : 1][2];
};

template <int TILES>
__device__ __forceinline__ void load_frag(Frag<TILES>& f,
                                          const __nv_bfloat16* a,
                                          const __nv_bfloat16* b) {
#pragma unroll
  for (int i = 0; i < MT; ++i) ldmatrix_x4(f.a[i], a + i * 16 * AST);
#pragma unroll
  for (int j = 0; j < TILES; ++j) ldmatrix_x2_trans(f.b[j], b + j * WARPS * 8);
}

// accumulator sets: a warp with one n8 tile keeps two, for the even and
// the odd k-steps, so that its chain of dependent mma halves
template <int TILES>
constexpr int ACC_SETS = TILES == 1 ? 2 : (TILES > 0 ? TILES : 1);

template <int TILES>
__device__ __forceinline__ void mma_frag(float (&acc)[ACC_SETS<TILES>][MT][4],
                                         const Frag<TILES>& f, int odd) {
#pragma unroll
  for (int j = 0; j < TILES; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      mma_bf16(acc[TILES == 1 ? odd : j][i], f.a[i], f.b[j]);
}

// One warp's share of a layer: its n8 tiles warp, warp + WARPS, ...
// (TILES of them, fixed at compile time so no ldmatrix or mma is
// predicated). Consumes the layer's chunks from the ring, releasing each
// stage as it goes, then writes the layer's output buffer.
template <int TILES>
__device__ __forceinline__ void run_layer(
    const Layer& L, __nv_bfloat16* s_act, const __nv_bfloat16* s_ring,
    const __nv_bfloat16* s_bias, uint64_t* s_full, uint64_t* s_empty,
    float* s_logit, int& g, int warp, int lane) {
  const int kpad = L.kpad, npad = L.npad, wstride = L.wstride;
  const int flags = L.flags;
  const int kc = chunk_rows(kpad, wstride);
  float acc[ACC_SETS<TILES>][MT][4];
#pragma unroll
  for (int j = 0; j < ACC_SETS<TILES>; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

  const __nv_bfloat16* a_lane =
      s_act + L.in * ROWS * AST + (lane & 15) * AST + (lane >> 4) * 8;
  const int b_lane = (lane & 15) * wstride + warp * 8;
  for (int k0 = 0; k0 < kpad; k0 += kc, ++g) {
    const int stage = g % STAGES;
    mbar_wait(&s_full[stage], (g / STAGES) & 1);
    if (TILES > 0) {
      // two k-steps in flight: the next step's operands load while
      // this step's products run
      const __nv_bfloat16* a = a_lane + k0;
      const __nv_bfloat16* b = s_ring + stage * STAGE + b_lane;
      const int steps = min(kc, kpad - k0) / 16;
      Frag<TILES> f0, f1;
      load_frag(f0, a, b);
      int s = 0;
      for (; s + 2 <= steps; s += 2) {
        load_frag(f1, a + (s + 1) * 16, b + (s + 1) * 16 * wstride);
        mma_frag<TILES>(acc, f0, 0);
        if (s + 2 < steps)
          load_frag(f0, a + (s + 2) * 16, b + (s + 2) * 16 * wstride);
        mma_frag<TILES>(acc, f1, 1);
      }
      if (s < steps) mma_frag<TILES>(acc, f0, 0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s_empty[stage]);  // release the stage
  }
  if (TILES == 1)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][i][e] += acc[1][i][e];

  // epilogue on the C fragments: rows lane / 4 (+ 8), columns
  // 2 * (lane % 4) (+ 1) of each n8 tile
  __nv_bfloat16* o = s_act + L.out * ROWS * AST;
  const __nv_bfloat16* bias = s_bias + L.b_off;
  const bool relu = flags & RELU;
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
    const int col = (warp + WARPS * j) * 8 + 2 * (lane & 3);
    const __nv_bfloat162 bb =
        *reinterpret_cast<const __nv_bfloat162*>(bias + col);
    const float b0 = __low2float(bb), b1 = __high2float(bb);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = i * 16 + (lane >> 2);
      const float h0 = finish(acc[j][i][0], b0, relu);
      const float h2 = finish(acc[j][i][2], b0, relu);
      store2(o + r * AST + col, h0, finish(acc[j][i][1], b1, relu));
      store2(o + (r + 8) * AST + col, h2, finish(acc[j][i][3], b1, relu));
      if ((flags & LOGIT) && col == 0) {
        s_logit[r] = h0;
        s_logit[r + 8] = h2;
      }
    }
  }
  // the n8 tile past npad, when npad is an odd number of them: zero, as
  // the next layer's 16-padded K reads it
  const int nt = warp + WARPS * TILES;
  if (TILES < NT_PER_WARP && nt * 8 < (npad + 15) / 16 * 16) {
    const int col = nt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = i * 16 + (lane >> 2);
      store2(o + r * AST + col, 0.f, 0.f);
      store2(o + (r + 8) * AST + col, 0.f, 0.f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
score_mlp_kernel(const float* __restrict__ x, int n, int in_dim,
                 const float* __restrict__ mu, const float* __restrict__ var,
                 const __nv_bfloat16* __restrict__ packed,
                 const __grid_constant__ Table t,
                 float recon_weight, float cls_weight,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_ring = s_act + 3 * ROWS * AST;
  __nv_bfloat16* s_bias = s_ring + STAGES * STAGE;
  float* s_mu = reinterpret_cast<float*>(s_bias + MAX_BIAS);
  float* s_var = s_mu + MAXW;
  float* s_logit = s_var + MAXW;
  uint64_t* s_full = reinterpret_cast<uint64_t*>(s_logit + ROWS);
  uint64_t* s_empty = s_full + STAGES;
  float* s_x = reinterpret_cast<float*>(s_empty + STAGES);  // [ROWS][in_dim]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long row0 = (long)blockIdx.x * ROWS;
  const int live = (int)min((long)ROWS, n - row0);
  const bool fold = mu != nullptr;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], 1);       // the producer's arrival + bytes
      mbar_init(&s_empty[s], WARPS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // the producer: one lane walks the chunks of all layers in execution
    // order and sends each into its ring stage with one bulk copy, once
    // the consumers have released the chunk that stage held before
    if (lane == 0) {
      mbar_expect(&s_full[0], t.bias_len * 2);  // the biases ride along
      bulk_load(s_bias, packed, t.bias_len * 2, &s_full[0]);
      int c = 0;
      for (int li = 0; li < t.n_layers; ++li) {
        const Layer& P = t.l[li];
        const int kc = chunk_rows(P.kpad, P.wstride);
        for (int k0 = 0; k0 < P.kpad; k0 += kc, ++c) {
          const int stage = c % STAGES;
          if (c >= STAGES) mbar_wait(&s_empty[stage], (c / STAGES - 1) & 1);
          const int bytes = min(kc, P.kpad - k0) * P.wstride * 2;
          mbar_arrive_expect(&s_full[stage], bytes);
          bulk_load(s_ring + stage * STAGE, packed + P.w_off + k0 * P.wstride,
                    bytes, &s_full[stage]);
        }
      }
    }
    return;
  }

  // the x tile (float32), and mu and var, staged by cp.async; rows past
  // n are not read
  for (int i = tid; i < live * in_dim; i += WARPS * 32)
    cp_async4(s_x + i, x + row0 * in_dim + i);
  if (fold)
    for (int d = tid; d < in_dim; d += WARPS * 32) {
      cp_async4(s_mu + d, mu + d);
      cp_async4(s_var + d, var + d);
    }
  cp_async_wait_all();
  consumers_sync();

  // bf16 input with the z-score folded in, zero in the padded columns
  // and in the dead rows of the ragged tail, which are never stored
  const int kpad0 = t.l[0].kpad;
  for (int i = tid; i < ROWS * kpad0; i += WARPS * 32) {
    const int r = i / kpad0, d = i - r * kpad0;
    const float v = r < live && d < in_dim
                        ? zscore(s_x[r * in_dim + d], d, fold, s_mu, s_var)
                        : 0.f;
    s_act[r * AST + d] = __float2bfloat16_rn(v);
  }
  consumers_sync();

  int g = 0;  // chunks consumed
  for (int li = 0; li < t.n_layers; ++li) {
    const Layer& L = t.l[li];
    // n8 tiles this warp owns: warp, warp + WARPS, ...
    const int tiles = max(0, (L.npad / 8 - warp + WARPS - 1) / WARPS);
    static_assert(NT_PER_WARP == 4, "one case per tile count");
#define RUN_LAYER(T)                                                      \
  run_layer<T>(L, s_act, s_ring, s_bias, s_full, s_empty, s_logit, g, warp, \
               lane)
    switch (tiles) {
      case 0: RUN_LAYER(0); break;
      case 1: RUN_LAYER(1); break;
      case 2: RUN_LAYER(2); break;
      case 3: RUN_LAYER(3); break;
      default: RUN_LAYER(4); break;
    }
#undef RUN_LAYER
    consumers_sync();  // this layer's output is whole; its input is free
  }

  // reconstruction error: a warp per row, against the float32 input
  const __nv_bfloat16* recon = s_act + t.l[t.n_layers - 1].out * ROWS * AST;
#pragma unroll
  for (int rr = 0; rr < ROWS / WARPS; ++rr) {
    const int r = warp + WARPS * rr;
    if (r >= live) break;
    const long row = row0 + r;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < MAXW / 32; ++q) {
      const int d = lane + 32 * q;
      if (d < in_dim) {
        const float v = zscore(s_x[r * in_dim + d], d, fold, s_mu, s_var);
        const float diff = __bfloat162float(recon[r * AST + d]) - v;
        s = fmaf(diff, diff, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float err = s / (float)in_dim;
      const float cls = 1.f / (1.f + expf(-s_logit[r]));
      out[row] = recon_weight * tanhf(err) + cls_weight * cls;
    }
  }
}

std::atomic<bool> smem_ready[64];

}  // namespace

// Plain C entry point, bound with ctypes. x, mu, var, packed and out are
// device pointers; table is a host array of n_layers rows of 8 ints
// (w_off, b_off, kpad, npad, wstride, in buffer, out buffer, flags), in
// execution order, as pack_params in ops/scoring.py builds it with the
// packed buffer (biases first, bias_len bf16). mu and var are both null
// or both [in_dim]. The caller checks the model first and launches only
// for n >= 1. Raises the kernel's dynamic shared memory limit once per
// device, launches on `stream` and returns the first cudaError_t.
extern "C" int score_mlp_forward(const void* x, int n, int in_dim,
                                 const void* mu, const void* var,
                                 const void* packed, const int* table,
                                 int n_layers, int bias_len,
                                 float recon_weight, float cls_weight,
                                 void* out, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_ready[dev].load()) {
    err = cudaFuncSetAttribute(score_mlp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_ready[dev].store(true);
  }
  Table t;
  t.n_layers = n_layers;
  t.bias_len = bias_len;
  for (int i = 0; i < n_layers; ++i) {
    const int* f = table + 8 * i;
    t.l[i] = Layer{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]};
  }
  const int blocks = (n + ROWS - 1) / ROWS;
  score_mlp_kernel<<<blocks, THREADS, SMEM_FIXED + ROWS * in_dim * 4,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, in_dim, static_cast<const float*>(mu),
      static_cast<const float*>(var),
      static_cast<const __nv_bfloat16*>(packed), t, recon_weight, cls_weight,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
