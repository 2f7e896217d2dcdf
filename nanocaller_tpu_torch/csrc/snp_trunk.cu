// K6 snp_trunk: the SNP CNN's convolutional trunk, from the pileup to
// fc1's input, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this trunk as XLA
// convolutions (nanocaller_tpu/models/snp.py). It replaces the port's
// cuDNN chain for inference (models/snp.py::_Trunk.trunk: a permute to
// NCHW, conv1_1, conv1_2 and conv1_3 each with a SELU pass, their
// concat, conv2 and conv3 with a SELU pass each, cuDNN's own NHWC/NCHW
// transposes between them), which wrote and re-read every intermediate
// through device memory. Its plain twin is
// nanocaller_tpu_torch/models/snp_trunk.py::snp_trunk_reference.
//
// Input x (B, 5, 41, 5) float32, NHWC as the pileup kernels write it,
// read as it lies; the packed weights of snp_trunk.py::pack_trunk_weights
// (each convolution's weight as (kh, kw, ci, co), then the biases).
// Output (B, 1728) float32: conv3's (3, 9, 64) map in (H, W, C) order,
// fc1's input as the flax model flattens it.
//   conv1_1 (1,5), conv1_2 (5,1), conv1_3 (5,5): 5 -> 16 channels each,
//     flax's symmetric SAME padding, bias, SELU; concatenated to 48;
//   conv2 (2,3) stride (1,2): 48 -> 32 on a (4, 20) map, bias, SELU;
//   conv3 (2,3) stride (1,2): 32 -> 64 on a (3, 9) map, bias, SELU.
//
// What bounds it on an H100: operations. A row is 3,286,112 FLOP
// (164,000 + 164,000 + 820,000 + 1,474,560 + 663,552) against 4,100
// bytes in and 6,912 out: 0.201 ms of the float32 FMA peak (67 TFLOP/s)
// for a 4,096-row slice, 0.013 ms of its bandwidth (3.35 TB/s). So the
// design keeps every intermediate on chip and spends the instruction slots on
// FMAs:
// - a CTA takes TB rows: it stages their input, zero-padded, as
//   channel planes in shared memory, then runs the trunk layer by layer
//   between barriers, with no intermediate in device memory;
// - a thread owns an output tile of a few positions down one column times
//   8 channels (conv1: 5 x 8; conv2: 4 x 8; conv3: 3 x 8), so each
//   activation it loads from shared memory feeds 8 FMAs and each pair of
//   16-byte weight loads feeds 24-40. The lanes of a warp take
//   neighbouring columns and share their 8 channels, so activation loads
//   hit distinct banks and weight loads are one broadcast, served by the
//   read-only cache (L1 is what two CTAs' shared memory leaves of the
//   SM's 228 KB; the weights are 98 KB, and L2 holds them);
// - conv1's three branches run one after the other through a 16-channel
//   buffer: after each, conv2 adds that branch's 16 input channels to
//   its tile's sums, which stay in registers from branch to branch. So
//   conv1's 39 KB a row never exists whole, and no concat runs;
// - conv1's and conv2's outputs are stored by column parity (even
//   columns, then odd ones), so the stride-2 columns the next layer reads
//   are neighbours in shared memory;
// - bias and SELU are each layer's epilogue (F.selu's constants, expm1f);
//   the last tile's missing rows read zeros and store nothing.
// Float32 FMAs on the CUDA cores only: no TF32, no tensor cores. No
// atomics, and each output sums its terms in one fixed order, so two
// launches on the same input give the same bits (graph replay and eager
// agree exactly).
//
// Shared memory a CTA: TB * (2,025 + 3,380 + 2,576) floats, 95,772 bytes
// at TB = 3, set with cudaFuncSetAttribute.
//
// TB and MIN_CTAS as measured (NVIDIA H100 80GB HBM3, 700 W; ms a launch
// at 4,096 / 2,704 rows): TB 2 at 2 CTAs an SM 0.652 / 0.483 (168
// registers), at 3 0.720 / 0.471 (96, spills); TB 1 at 4 0.676 / 0.490,
// at 6 0.886 / 0.573; TB 4 at 1 0.676 / 0.499; TB 3 at 2, kept: 0.594 /
// 0.385 (128 registers, 24 bytes spilled).

#include <cuda_runtime.h>

namespace {

constexpr int H = 5, W = 41, C0 = 5;  // the pileup: rows, columns, channels
constexpr int HP = H + 4, WP = W + 4;  // its zero-padded planes
constexpr int XPLANE = HP * WP;
constexpr int XS = C0 * XPLANE;  // 2,025 floats a row
constexpr int C1 = 16;           // channels of a conv1 branch
constexpr int W1H = 21;          // conv1 columns of one parity (ceil(41/2))
constexpr int C1PLANE = H * 2 * W1H;  // a channel: [h][parity][21]
// a row's conv1 buffer, 16 * 210 floats and 20 more, so that a warp's two
// rows fall on other banks
constexpr int C1S = C1 * C1PLANE + 20;
constexpr int H2 = 4, W2 = 20, CO2 = 32;  // conv2's output
constexpr int W2H = W2 / 2;
constexpr int C2PLANE = H2 * 2 * W2H;  // a channel: [h][parity][10]
constexpr int C2S = CO2 * C2PLANE + 16;
constexpr int H3 = 3, W3 = 9, CO3 = 64;  // conv3's output
constexpr int OUT = H3 * W3 * CO3;       // 1,728 floats a row

constexpr int TB = 3;  // rows a CTA
constexpr int THREADS = 2 * W * TB;  // conv1: (channel half, row, column)
constexpr int CONV2_TASKS = 4 * W2 * TB;  // (channel quarter, row, column)
constexpr int CONV3_TASKS = 8 * W3 * TB;  // (channel eighth, row, column)
constexpr int MIN_CTAS = 2;  // CTAs an SM
constexpr int SMEM = TB * (XS + C1S + C2S) * (int)sizeof(float);

// offsets in the packed weights (snp_trunk.py::pack_trunk_weights)
constexpr int W11 = 0;             // conv1_1 (1, 5, 5, 16)
constexpr int W12 = W11 + 400;     // conv1_2 (5, 1, 5, 16)
constexpr int W13 = W12 + 400;     // conv1_3 (5, 5, 5, 16)
constexpr int W2_ = W13 + 2000;    // conv2 (2, 3, 48, 32)
constexpr int W3_ = W2_ + 9216;    // conv3 (2, 3, 32, 64)
constexpr int B1 = W3_ + 12288;    // conv1_1, conv1_2, conv1_3 biases (48)
constexpr int B2 = B1 + 48;        // conv2's (32)
constexpr int B3 = B2 + 32;        // conv3's (64)
static_assert(B3 + 64 == 24448, "packed size");
static_assert(CONV2_TASKS <= THREADS && CONV3_TASKS <= THREADS, "tasks");

__device__ __forceinline__ float selu(float v) {
  // F.selu: scale * v above 0, scale * alpha * expm1(v) at or below
  constexpr float kScale = 1.0507009873554804934193349852946f;
  constexpr float kNeg = 1.6732632423543772848170429916717f * kScale;
  return v <= 0.f ? expm1f(v) * kNeg : v * kScale;
}

// 8 weights (or biases) at p, 16-byte aligned, through the read-only cache
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// The CTA's rows of x into xs, each as 5 channel planes of (5 + 4) x
// (41 + 4) with a zero border of 2; rows past B are zero.
__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        float* xs, int r0, int B, int t) {
  for (int i = t; i < TB * XS; i += THREADS) {
    const int s = i / XS;
    int r = i - s * XS;
    const int c = r / XPLANE;
    r -= c * XPLANE;
    const int h = r / WP - 2, w = r % WP - 2;
    float v = 0.f;
    if (r0 + s < B && (unsigned)h < (unsigned)H && (unsigned)w < (unsigned)W)
      v = __ldg(x + ((long long)(r0 + s) * (H * W) + h * W + w) * C0 + c);
    xs[i] = v;
  }
}

// One conv1 branch of kernel (NKH, NKW), its taps at padded offsets
// (KH0 + kh, KW0 + kw), for task t = (channel half g, row s, column w):
// the branch's channels 8g-8g+7 at the column's 5 positions, bias and
// SELU, into c1[s][channel][h][w % 2][w / 2]. wk: the branch's packed
// weights (kh, kw, ci, 16); bias: its 16 biases.
template <int KH0, int NKH, int KW0, int NKW>
__device__ __forceinline__ void conv1_branch(const float* __restrict__ wk,
                                             const float* __restrict__ bias,
                                             const float* xs, float* c1,
                                             int t) {
  const int g = t / (W * TB), rc = t - g * (W * TB);
  const int s = rc / W, w = rc - s * W;
  float acc[H][8];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[h][j] = 0.f;
  const float* xp = xs + s * XS + KH0 * WP + KW0 + w;
  const float* wp = wk + 8 * g;
#pragma unroll 1
  for (int kh = 0; kh < NKH; ++kh) {
#pragma unroll
    for (int kw = 0; kw < NKW; ++kw) {
#pragma unroll
      for (int ci = 0; ci < C0; ++ci) {
        float wv[8];
        load8(wp + ((kh * NKW + kw) * C0 + ci) * C1, wv);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float v = xp[ci * XPLANE + (h + kh) * WP + kw];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[h][j] = fmaf(v, wv[j], acc[h][j]);
        }
      }
    }
  }
  float bv[8];
  load8(bias + 8 * g, bv);
  float* o = c1 + s * C1S + 8 * g * C1PLANE + (w & 1) * W1H + (w >> 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < H; ++h)
      o[j * C1PLANE + h * 2 * W1H] = selu(acc[h][j] + bv[j]);
}

// conv2's sums over one conv1 branch's 16 channels, added to acc, for
// task t = (channel quarter q, row s, column w2): output channels
// 8q-8q+7 at the column's 4 positions. wk: conv2's packed weights from
// the branch's first input channel.
__device__ __forceinline__ void conv2_part(const float* __restrict__ wk,
                                           const float* c1,
                                           float (&acc)[H2][8], int t) {
  const int q = t / (W2 * TB), rc = t - q * (W2 * TB);
  const int s = rc / W2, w2 = rc - s * W2;
  const float* cp = c1 + s * C1S + w2;
  const float* wp = wk + 8 * q;
#pragma unroll 1
  for (int kw = 0; kw < 3; ++kw) {
    // input column 2 w2 + kw: parity kw % 2, index w2 + kw / 2
    const float* col = cp + (kw & 1) * W1H + (kw >> 1);
#pragma unroll 4
    for (int c = 0; c < C1; ++c) {
      float v[H];
#pragma unroll
      for (int h = 0; h < H; ++h) v[h] = col[c * C1PLANE + h * 2 * W1H];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        float wv[8];
        load8(wp + ((kh * 3 + kw) * 48 + c) * CO2, wv);
#pragma unroll
        for (int h = 0; h < H2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[h][j] = fmaf(v[h + kh], wv[j], acc[h][j]);
      }
    }
  }
}

// conv2's bias and SELU on task t's sums, into c2[s][channel][h][w2 % 2]
// [w2 / 2].
__device__ __forceinline__ void conv2_store(const float* __restrict__ bias,
                                            const float (&acc)[H2][8],
                                            float* c2, int t) {
  const int q = t / (W2 * TB), rc = t - q * (W2 * TB);
  const int s = rc / W2, w2 = rc - s * W2;
  float bv[8];
  load8(bias + 8 * q, bv);
  float* o = c2 + s * C2S + 8 * q * C2PLANE + (w2 & 1) * W2H + (w2 >> 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < H2; ++h)
      o[j * C2PLANE + h * 2 * W2H] = selu(acc[h][j] + bv[j]);
}

// conv3 for task t = (channel eighth e, row s, column w3): output channels
// 8e-8e+7 at the column's 3 positions, bias and SELU, stored to the
// row's (H, W, C) output unless the row is past B.
__device__ __forceinline__ void conv3(const float* __restrict__ wk,
                                      const float* __restrict__ bias,
                                      const float* c2,
                                      float* __restrict__ out, int r0, int B,
                                      int t) {
  const int e = t / (W3 * TB), rc = t - e * (W3 * TB);
  const int s = rc / W3, w3 = rc - s * W3;
  float acc[H3][8];
#pragma unroll
  for (int h = 0; h < H3; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[h][j] = 0.f;
  const float* cp = c2 + s * C2S + w3;
  const float* wp = wk + 8 * e;
#pragma unroll 1
  for (int kw = 0; kw < 3; ++kw) {
    const float* col = cp + (kw & 1) * W2H + (kw >> 1);
#pragma unroll 4
    for (int ci = 0; ci < CO2; ++ci) {
      float v[H2];
#pragma unroll
      for (int h = 0; h < H2; ++h) v[h] = col[ci * C2PLANE + h * 2 * W2H];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        float wv[8];
        load8(wp + ((kh * 3 + kw) * CO2 + ci) * CO3, wv);
#pragma unroll
        for (int h = 0; h < H3; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[h][j] = fmaf(v[h + kh], wv[j], acc[h][j]);
      }
    }
  }
  if (r0 + s >= B) return;
  float bv[8];
  load8(bias + 8 * e, bv);
  float* o = out + (long long)(r0 + s) * OUT + w3 * CO3 + 8 * e;
#pragma unroll
  for (int h = 0; h < H3; ++h) {
    float4 a, b;
    a.x = selu(acc[h][0] + bv[0]); a.y = selu(acc[h][1] + bv[1]);
    a.z = selu(acc[h][2] + bv[2]); a.w = selu(acc[h][3] + bv[3]);
    b.x = selu(acc[h][4] + bv[4]); b.y = selu(acc[h][5] + bv[5]);
    b.z = selu(acc[h][6] + bv[6]); b.w = selu(acc[h][7] + bv[7]);
    float4* p = reinterpret_cast<float4*>(o + h * W3 * CO3);
    p[0] = a;
    p[1] = b;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
snp_trunk_kernel(const float* __restrict__ x,
                 const float* __restrict__ wts, float* __restrict__ out,
                 int B) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* c1 = xs + TB * XS;
  float* c2 = c1 + TB * C1S;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * TB;
  stage_x(x, xs, r0, B, t);
  float acc2[H2][8];
#pragma unroll
  for (int h = 0; h < H2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[h][j] = 0.f;
  __syncthreads();
  // conv1_1 (1,5), padding (0,2): input row h, columns w-2 .. w+2
  conv1_branch<2, 1, 0, 5>(wts + W11, wts + B1, xs, c1, t);
  __syncthreads();
  if (t < CONV2_TASKS) conv2_part(wts + W2_, c1, acc2, t);
  __syncthreads();
  // conv1_2 (5,1), padding (2,0): rows h-2 .. h+2, column w
  conv1_branch<0, 5, 2, 1>(wts + W12, wts + B1 + C1, xs, c1, t);
  __syncthreads();
  if (t < CONV2_TASKS) conv2_part(wts + W2_ + C1 * CO2, c1, acc2, t);
  __syncthreads();
  // conv1_3 (5,5), padding (2,2)
  conv1_branch<0, 5, 0, 5>(wts + W13, wts + B1 + 2 * C1, xs, c1, t);
  __syncthreads();
  if (t < CONV2_TASKS) {
    conv2_part(wts + W2_ + 2 * C1 * CO2, c1, acc2, t);
    conv2_store(wts + B2, acc2, c2, t);
  }
  __syncthreads();
  if (t < CONV3_TASKS) conv3(wts + W3_, wts + B3, c2, out, r0, B, t);
}

}  // namespace

// x (B, 5, 41, 5), wts (24,448,) and out (B, 1728), all float32 and
// contiguous on the current device; launched on `stream`. Returns the
// launch's cudaError (0 on success). The first launch on each device sets
// the kernel's dynamic shared memory limit and carveout (before any
// graph capture: the port's first forward on a device runs eagerly).
extern "C" int snp_trunk_launch(const float* x, const float* wts,
                                float* out, int B, void* stream) {
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(snp_trunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    // shared memory for MIN_CTAS CTAs, the rest of the SM's 228 KB as L1
    // for the weights
    err = cudaFuncSetAttribute(
        snp_trunk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (MIN_CTAS * (SMEM + 1024) * 100 + 233471) / 233472);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  if (B <= 0) return 0;
  snp_trunk_kernel<<<(B + TB - 1) / TB, THREADS, SMEM,
                     (cudaStream_t)stream>>>(x, wts, out, B);
  return (int)cudaGetLastError();
}
