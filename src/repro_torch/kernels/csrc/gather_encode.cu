// Error-feedback + encode kernels for Hopper (sm_90a): the gather
// encoders of the one-shot exchange and the flat encoders of the ring.
//
// Replaces the JAX package's Pallas TPU kernels:
//   K0  repro/kernels/topk_compress.py:44   gather_ef_call   (the plumbing)
//   K1  repro/kernels/quantize.py:68        quantize_int8_gather
//   K2  repro/kernels/quantize.py:151       ef_int4_gather
//   K3  repro/kernels/sign.py:72            ef_sign_gather
//   K4  repro/kernels/topk_compress.py:159  ef_topk_gather
//   K12 repro/kernels/quantize.py:44        quantize_int8_fused
//   K13 repro/kernels/quantize.py:126       ef_int4_fused
//   K14 repro/kernels/sign.py:47            ef_sign_fused
//   K15 repro/kernels/topk_compress.py:139  ef_topk_select
//   K16 repro/kernels/quantize.py:174       dequantize_int8
//
// One row body per rung (Int8Body, Int4Body, SignBody, TopKBody) runs on
// rows that a row source hands it: GatherRows reads the rows perm[0..S)
// of the packed (NB+1, 1024) f32 grad and error-feedback buffers and forms
// ef = g + gamma * e, so the gathered bucket never exists in device memory
// (K1-K4); FlatRows reads contiguous rows of g and e (K13-K15); PlainRows
// reads contiguous rows of x that already carry the error feedback (K12).
// The gather launches of the int8, int4 and sign bodies also write
// own = ef - r, the row every receiver reconstructs; the flat launches
// write the reference's outputs only (own is null there).  K16 scales the
// int8 rows of K12's layout back to f32.
//
// Bound: device-memory bytes.  Per row the encoders read 4-8 KiB and
// write 4-9 KiB, against at most ~40 f32 operations per element (the top-k
// body's 16 bisection compares and counts): about 3 operations per byte,
// far below the H100's 20 f32 operations per byte of memory traffic.
// Design: one 256-thread block per row, each thread holding 4 contiguous
// lanes (16-byte loads and stores, neighbouring threads on neighbouring
// addresses); row reductions are warp shuffles plus a few words of shared
// memory.  No tiling or pipelining yet: a correct first version.
//
// Numerics follow the reference as XLA:CPU runs it under jit, bit for
// bit: ef is one fused multiply-add; the quantisation residual
// ef - q * scale is one fused multiply-add; absmax / 127 (or / 7) is a
// multiplication by the f32 reciprocal; ef / scale is an IEEE division;
// rounding is half to even (rintf); denormals are flushed to a zero of the
// same sign (built with -ftz=true, and flushed explicitly where a result
// can underflow).  Every operation whose rounding matters is an explicit
// _rn intrinsic, which the compiler never contracts.  The sign body sums
// |ef| in a fixed order (4 lanes per thread left to right, then a pairwise
// tree over the 256 partial sums) that the plain PyTorch version in
// kernels/ref.py repeats.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 1024;
constexpr int THREADS = 256;
constexpr int VEC = LANES / THREADS;  // 4 lanes per thread
constexpr int WARPS = THREADS / 32;
constexpr int BISECT_ITERS = 16;
constexpr float INV127 = 1.0f / 127.0f;
constexpr float INV7 = 1.0f / 7.0f;
constexpr float INV_LANES = 1.0f / 1024.0f;
constexpr float SCALE_FLOOR = 1e-30f;
constexpr float TINY = 1.17549435e-38f;  // smallest normal f32

static_assert(VEC == 4, "row bodies assume 4 lanes per thread");

struct Smem {
  float fsum[THREADS];
  float fred[WARPS];
  int ired[WARPS];
};

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < TINY ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ float block_max(float v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sm.fred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sm.fred[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, sm.fred[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_count(int v, Smem& sm) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) sm.ired[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r += sm.ired[w];
  __syncthreads();
  return r;
}

// Sum over the block in the fixed order p[:s] + p[s:2s], s = 128 .. 1.
__device__ __forceinline__ float block_sum_fixed(float v, Smem& sm) {
  const int t = threadIdx.x;
  sm.fsum[t] = v;
  __syncthreads();
  for (int s = THREADS / 2; s >= 32; s >>= 1) {
    if (t < s) sm.fsum[t] = __fadd_rn(sm.fsum[t], sm.fsum[t + s]);
    __syncthreads();
  }
  if (t < 32) {
    float r = sm.fsum[t];
    for (int o = 16; o > 0; o >>= 1)
      r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, o));
    if (t == 0) sm.fred[0] = r;
  }
  __syncthreads();
  const float r = sm.fred[0];
  __syncthreads();
  return r;
}

// Absmax quantiser shared by the int8 and int4 bodies: writes q (as f32),
// the residual and own = ef - r, returns the row scale.
__device__ __forceinline__ float absmax_quant(const float (&ef)[VEC],
                                              float inv, float qmax,
                                              float (&q)[VEC],
                                              float (&r)[VEC],
                                              float (&own)[VEC], Smem& sm) {
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(ef[j]));
  amax = block_max(amax, sm);
  const float scale = fmaxf(__fmul_rn(amax, inv), SCALE_FLOOR);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float x = rintf(__fdiv_rn(ef[j], scale));
    q[j] = fminf(fmaxf(x, -qmax), qmax);
    r[j] = ftz(__fmaf_rn(-q[j], scale, ef[j]));
    own[j] = ftz(__fsub_rn(ef[j], r[j]));
  }
  return scale;
}

__device__ __forceinline__ void store_f4(float* base, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(base)[threadIdx.x] =
      make_float4(v[0], v[1], v[2], v[3]);
}

// ---- K1: int8 ---------------------------------------------------------
struct Int8Body {
  int8_t* q;
  float* s;
  float* r;
  float* own;
  __device__ void operator()(const float (&ef)[VEC], int64_t i,
                             Smem& sm) const {
    float qf[VEC], rv[VEC], ov[VEC];
    const float scale = absmax_quant(ef, INV127, 127.0f, qf, rv, ov, sm);
    reinterpret_cast<char4*>(q + i * LANES)[threadIdx.x] =
        make_char4(static_cast<signed char>(qf[0]),
                   static_cast<signed char>(qf[1]),
                   static_cast<signed char>(qf[2]),
                   static_cast<signed char>(qf[3]));
    store_f4(r + i * LANES, rv);
    if (own) store_f4(own + i * LANES, ov);
    if (threadIdx.x == 0) s[i] = scale;
  }
};

// ---- K2: int4, offset-binary nibbles, even column in the low nibble ---
struct Int4Body {
  uint8_t* p;
  float* s;
  float* r;
  float* own;
  __device__ void operator()(const float (&ef)[VEC], int64_t i,
                             Smem& sm) const {
    float qf[VEC], rv[VEC], ov[VEC];
    const float scale = absmax_quant(ef, INV7, 7.0f, qf, rv, ov, sm);
    unsigned u[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) u[j] = static_cast<unsigned>(qf[j] + 8.0f);
    reinterpret_cast<uchar2*>(p + i * (LANES / 2))[threadIdx.x] =
        make_uchar2(static_cast<unsigned char>(u[0] | (u[1] << 4)),
                    static_cast<unsigned char>(u[2] | (u[3] << 4)));
    store_f4(r + i * LANES, rv);
    if (own) store_f4(own + i * LANES, ov);
    if (threadIdx.x == 0) s[i] = scale;
  }
};

// ---- K3: 1-bit sign with mean-|ef| scale (packing stays outside) ------
struct SignBody {
  int8_t* sg;
  float* s;
  float* r;
  float* own;
  __device__ void operator()(const float (&ef)[VEC], int64_t i,
                             Smem& sm) const {
    float part = fabsf(ef[0]);
#pragma unroll
    for (int j = 1; j < VEC; ++j) part = __fadd_rn(part, fabsf(ef[j]));
    const float scale = ftz(__fmul_rn(block_sum_fixed(part, sm), INV_LANES));
    float sv[VEC], rv[VEC], ov[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sv[j] = ef[j] >= 0.0f ? 1.0f : -1.0f;
      rv[j] = ftz(__fmaf_rn(-sv[j], scale, ef[j]));
      ov[j] = ftz(__fsub_rn(ef[j], rv[j]));
    }
    reinterpret_cast<char4*>(sg + i * LANES)[threadIdx.x] =
        make_char4(static_cast<signed char>(sv[0]),
                   static_cast<signed char>(sv[1]),
                   static_cast<signed char>(sv[2]),
                   static_cast<signed char>(sv[3]));
    store_f4(r + i * LANES, rv);
    if (own) store_f4(own + i * LANES, ov);
    if (threadIdx.x == 0) s[i] = scale;
  }
};

// ---- K4: top-k selection by a 16-step bisection on |ef| ---------------
struct TopKBody {
  float* sel;
  float* r;
  int k;
  __device__ void operator()(const float (&ef)[VEC], int64_t i,
                             Smem& sm) const {
    float mag[VEC];
    float hi = 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mag[j] = fabsf(ef[j]);
      hi = fmaxf(hi, mag[j]);
    }
    hi = block_max(hi, sm);
    float lo = 0.0f;
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float mid = ftz(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
      int c = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) c += mag[j] >= mid ? 1 : 0;
      // too many selected -> raise the threshold; too few -> lower it
      if (block_count(c, sm) > k) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const float thr = ftz(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
    float sv[VEC], rv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // the reference's ef * mask, which XLA lowers to a select: a
      // dropped entry is +0 whatever the sign of ef
      sv[j] = mag[j] >= thr ? ef[j] : 0.0f;
      rv[j] = __fsub_rn(ef[j], sv[j]);
    }
    store_f4(sel + i * LANES, sv);
    store_f4(r + i * LANES, rv);
  }
};

// ---- row sources ------------------------------------------------------
__device__ __forceinline__ void load_f4(const float* row, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(row)[threadIdx.x];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void ef_fma(const float (&g)[VEC],
                                       const float (&e)[VEC], float gamma,
                                       float (&ef)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    ef[j] = ftz(__fmaf_rn(gamma, ftz(e[j]), ftz(g[j])));
}

// K0: row perm[i] of the packed grad / error buffers, ef = g + gamma * e.
struct GatherRows {
  const float* fb;
  const float* eb;
  const int32_t* perm;
  int nbp1;
  float gamma;
  __device__ void operator()(int64_t i, float (&ef)[VEC]) const {
    const int32_t row = perm[i];
    if (row < 0 || row >= nbp1) __trap();  // a perm past the buffer
    float g[VEC], e[VEC];
    load_f4(fb + int64_t(row) * LANES, g);
    load_f4(eb + int64_t(row) * LANES, e);
    ef_fma(g, e, gamma, ef);
  }
};

// K13-K15: contiguous row i of g and e, ef = g + gamma * e.
struct FlatRows {
  const float* g;
  const float* e;
  float gamma;
  __device__ void operator()(int64_t i, float (&ef)[VEC]) const {
    float gv[VEC], ev[VEC];
    load_f4(g + i * LANES, gv);
    load_f4(e + i * LANES, ev);
    ef_fma(gv, ev, gamma, ef);
  }
};

// K12: contiguous row i of x, which already carries the error feedback.
struct PlainRows {
  const float* x;
  __device__ void operator()(int64_t i, float (&ef)[VEC]) const {
    float v[VEC];
    load_f4(x + i * LANES, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ef[j] = ftz(v[j]);
  }
};

// One block per row: the source hands the row's ef, the body encodes it.
template <class Src, class Body>
__global__ void __launch_bounds__(THREADS) encode_kernel(Src src, Body body) {
  __shared__ Smem sm;
  const int64_t i = blockIdx.x;
  float ef[VEC];
  src(i, ef);
  body(ef, i, sm);
}

template <class Src, class Body>
int launch(int rows, Src src, Body body, cudaStream_t stream) {
  if (rows <= 0) return 0;
  encode_kernel<Src, Body><<<rows, THREADS, 0, stream>>>(src, body);
  return static_cast<int>(cudaGetLastError());
}

// ---- K16: int8 rows times their scale ----------------------------------
__global__ void __launch_bounds__(THREADS)
dequant_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                    float* __restrict__ out) {
  const int64_t i = blockIdx.x;
  const char4 c = reinterpret_cast<const char4*>(q + i * LANES)[threadIdx.x];
  const float scale = s[i];
  const float v[VEC] = {
      __fmul_rn(static_cast<float>(c.x), scale),
      __fmul_rn(static_cast<float>(c.y), scale),
      __fmul_rn(static_cast<float>(c.z), scale),
      __fmul_rn(static_cast<float>(c.w), scale)};
  store_f4(out + i * LANES, v);
}

}  // namespace

// Plain C interface (bound with ctypes).  Every function returns the
// cudaError_t of its launch; the caller raises when it is not 0.
extern "C" {

int gather_ef_int8(const float* fb, const float* eb, const int32_t* perm,
                   int S, int nbp1, float gamma, int8_t* q, float* s,
                   float* r, float* own, cudaStream_t stream) {
  return launch(S, GatherRows{fb, eb, perm, nbp1, gamma},
                Int8Body{q, s, r, own}, stream);
}

int gather_ef_int4(const float* fb, const float* eb, const int32_t* perm,
                   int S, int nbp1, float gamma, uint8_t* p, float* s,
                   float* r, float* own, cudaStream_t stream) {
  return launch(S, GatherRows{fb, eb, perm, nbp1, gamma},
                Int4Body{p, s, r, own}, stream);
}

int gather_ef_sign(const float* fb, const float* eb, const int32_t* perm,
                   int S, int nbp1, float gamma, int8_t* sg, float* s,
                   float* r, float* own, cudaStream_t stream) {
  return launch(S, GatherRows{fb, eb, perm, nbp1, gamma},
                SignBody{sg, s, r, own}, stream);
}

int gather_ef_topk(const float* fb, const float* eb, const int32_t* perm,
                   int S, int nbp1, float gamma, int k, float* sel, float* r,
                   cudaStream_t stream) {
  return launch(S, GatherRows{fb, eb, perm, nbp1, gamma},
                TopKBody{sel, r, k}, stream);
}

int quantize_int8(const float* x, int rows, int8_t* q, float* s, float* r,
                  cudaStream_t stream) {
  return launch(rows, PlainRows{x}, Int8Body{q, s, r, nullptr}, stream);
}

int ef_int4(const float* g, const float* e, int rows, float gamma,
            uint8_t* p, float* s, float* r, cudaStream_t stream) {
  return launch(rows, FlatRows{g, e, gamma}, Int4Body{p, s, r, nullptr},
                stream);
}

int ef_sign(const float* g, const float* e, int rows, float gamma,
            int8_t* sg, float* s, float* r, cudaStream_t stream) {
  return launch(rows, FlatRows{g, e, gamma}, SignBody{sg, s, r, nullptr},
                stream);
}

int ef_topk(const float* g, const float* e, int rows, float gamma, int k,
            float* sel, float* r, cudaStream_t stream) {
  return launch(rows, FlatRows{g, e, gamma}, TopKBody{sel, r, k}, stream);
}

int dequant_int8(const int8_t* q, const float* s, int rows, float* out,
                 cudaStream_t stream) {
  if (rows <= 0) return 0;
  dequant_int8_kernel<<<rows, THREADS, 0, stream>>>(q, s, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
