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
// rounds again, then applies ReLU. The reconstruction error is taken
// against the float32 x32, never its bf16 copy; tanh and the sigmoid run
// in float32.
//
// Bound on the H100 (default model 36-256-128-32 / 32-128-256-36 /
// 32-128-1): 96,384 MACs = 192,768 FLOP per row, so 0.79 GFLOP at 4096
// rows, about 0.8 us at the 989 TFLOP/s bf16 dense peak; the bytes are
// 0.59 MB of x, 16 KB of scores and 195 KB of bf16 weights, about 0.24 us
// at 3.35 TB/s. The kernel is bound by operations.
//
// Design, simple and right first: a block owns ROWS rows and keeps their
// activations in shared memory (three bf16 [ROWS][MAXW] buffers: the
// encoder ping-pongs between two, the bottleneck z stays put while the
// classifier and then the decoder ping-pong through the other two).
// Thread j computes output column j for all ROWS rows: it reads each
// weight w[k][j] once from global memory (the 195 KB of bf16 weights stay
// resident in L2; neighbouring threads read neighbouring columns) and
// reuses it ROWS times against a broadcast shared-memory activation. FMA
// runs on the CUDA cores; wgmma, TMA and weights staged in shared memory
// are for later work. ROWS = 8 gives 128 blocks for a 1024-row batch on
// the 132 SMs and one warp per row for the reconstruction-error
// reduction. Ragged batches are masked, never padded: rows >= n load as
// zero and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;         // rows per block
constexpr int THREADS = 256;    // one thread per output column
constexpr int MAXW = 256;       // widest layer (and in_dim) accepted
constexpr int MAX_LAYERS = 16;

static_assert(THREADS >= MAXW, "a thread per output column");
static_assert(THREADS / 32 >= ROWS, "a warp per row for the error");

struct Layer {
  const __nv_bfloat16* w;  // [in, out] row-major
  const __nv_bfloat16* b;  // [out]
  int in;
  int out;
};

struct Table {
  Layer l[MAX_LAYERS];
  int n_enc, n_dec, n_cls;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// out[r][j] = act(bf16(bf16(sum_k in[r][k] * w[k][j]) + b[j])), r < ROWS
__device__ void dense(const Layer& L, const __nv_bfloat16* in,
                      __nv_bfloat16* out, bool relu) {
  const int j = threadIdx.x;
  if (j < L.out) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    const __nv_bfloat16* wj = L.w + j;
#pragma unroll 4
    for (int k = 0; k < L.in; ++k) {
      const float wv = __bfloat162float(wj[(size_t)k * L.out]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[r] = fmaf(__bfloat162float(in[r * MAXW + k]), wv, acc[r]);
    }
    const float bj = __bfloat162float(L.b[j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float h = round_bf16(round_bf16(acc[r]) + bj);
      if (relu) h = fmaxf(h, 0.f);
      out[r * MAXW + j] = __float2bfloat16_rn(h);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
score_mlp_kernel(const float* __restrict__ x, int n, int in_dim,
                 const float* __restrict__ mu, const float* __restrict__ var,
                 Table t, float recon_weight, float cls_weight,
                 float* __restrict__ out) {
  __shared__ __nv_bfloat16 s_act[3][ROWS * MAXW];
  __shared__ float s_x[ROWS * MAXW];
  __shared__ float s_logit[ROWS];
  __shared__ float s_err[ROWS];

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * ROWS;

  // tile load with the z-score folded in; dead rows of the ragged tail
  // load as zero and are never stored
  for (int i = tid; i < ROWS * in_dim; i += THREADS) {
    const int r = i / in_dim, d = i - r * in_dim;
    const long row = row0 + r;
    float v = row < n ? x[row * in_dim + d] : 0.f;
    if (mu != nullptr) v = (v - mu[d]) * rsqrtf(var[d] + 1e-2f);
    s_x[r * MAXW + d] = v;
    s_act[0][r * MAXW + d] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // encoder: buffer 0 -> 1 -> 2 -> 1 ...; z ends in buffer zi
  const __nv_bfloat16* h = s_act[0];
  int zi = 0;
  for (int i = 0; i < t.n_enc; ++i) {
    const int o = 1 + (i & 1);
    dense(t.l[i], h, s_act[o], true);
    h = s_act[o];
    zi = o;
  }
  const int a = (zi + 1) % 3, b = (zi + 2) % 3;

  // classifier from z, through the two buffers z is not in
  h = s_act[zi];
  for (int i = 0; i < t.n_cls; ++i) {
    const int o = (i & 1) ? b : a;
    dense(t.l[t.n_enc + t.n_dec + i], h, s_act[o], i < t.n_cls - 1);
    h = s_act[o];
  }
  if (tid < ROWS) s_logit[tid] = __bfloat162float(h[tid * MAXW]);
  __syncthreads();

  // decoder from z, through the same two buffers
  h = s_act[zi];
  for (int i = 0; i < t.n_dec; ++i) {
    const int o = (i & 1) ? b : a;
    dense(t.l[t.n_enc + i], h, s_act[o], i < t.n_dec - 1);
    h = s_act[o];
  }

  // reconstruction error: one warp per row, against the float32 input
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < ROWS) {
    float s = 0.f;
    for (int d = lane; d < in_dim; d += 32) {
      const float diff = __bfloat162float(h[warp * MAXW + d]) -
                         s_x[warp * MAXW + d];
      s = fmaf(diff, diff, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_err[warp] = s / (float)in_dim;
  }
  __syncthreads();

  if (tid < ROWS && row0 + tid < n) {
    const float cls = 1.f / (1.f + expf(-s_logit[tid]));
    out[row0 + tid] = recon_weight * tanhf(s_err[tid]) + cls_weight * cls;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointer arguments are device
// pointers except w, b and dims, which are host arrays of n_enc + n_dec +
// n_cls entries (dims holds (in, out) per layer). mu and var are both
// null or both [in_dim]. The caller checks the layers first (they chain
// x -> z, z -> x and z -> 1, at most MAX_LAYERS of widths <= MAXW: see
// pack_params in ops/scoring.py) and launches only for n >= 1. Launches
// on `stream` and returns the cudaError_t of the launch.
extern "C" int score_mlp_forward(const void* x, int n, int in_dim,
                                 const void* mu, const void* var,
                                 const void* const* w, const void* const* b,
                                 const int* dims, int n_enc, int n_dec,
                                 int n_cls, float recon_weight,
                                 float cls_weight, void* out, void* stream) {
  Table t;
  t.n_enc = n_enc;
  t.n_dec = n_dec;
  t.n_cls = n_cls;
  for (int i = 0; i < n_enc + n_dec + n_cls; ++i) {
    t.l[i].w = static_cast<const __nv_bfloat16*>(w[i]);
    t.l[i].b = static_cast<const __nv_bfloat16*>(b[i]);
    t.l[i].in = dims[2 * i];
    t.l[i].out = dims[2 * i + 1];
  }
  const int blocks = (n + ROWS - 1) / ROWS;
  score_mlp_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, in_dim, static_cast<const float*>(mu),
      static_cast<const float*>(var), t, recon_weight, cls_weight,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
