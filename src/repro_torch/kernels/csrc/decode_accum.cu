// Decode-accumulate kernels for Hopper (sm_90a): the peer folds of the
// multi-pod exchange.
//
// Replaces the JAX package's Pallas TPU kernels of repro/kernels/decode.py:
//   K5  :100 dequant_accum_int8_fused      acc + w * (q * s)
//   K6  :122 dequant_accum_int4_fused      K5 on packed nibbles
//   K7  :146 sign_vote_accum_fused         vote + w * (+-1), mag + w * s
//   K8  :256 topk_scatter_accum_fused      acc + w * (q * s) at idx
//   K9  :185 dequant_accum_int8_fp_fused   acc_i32 + fixed_point(w * q * s)
//   K10 :209 dequant_accum_int4_fp_fused   K9 on packed nibbles
//   K11 :236 sign_vote_accum_fp_fused      vote_i32 + fixed_point(w) * (+-1),
//                                          mag_i32 + fixed_point(w * s)
//
// Each launch folds one peer's payload rows into the running aggregate:
// it reads the accumulator rows (rows, 1024) and the payload, and writes
// the new accumulator to `out`, which may be the accumulator itself (every
// element is read and written by the same thread; the top-k body stages
// its row in shared memory first).  The weight w is one f32 on the device
// (the sending pod's omega), so no launch waits on the host.
//
// Bound: device-memory bytes.  Per row the kernels read and write the 4 KiB
// accumulator and read 0.1-1 KiB of payload, against ~3 operations per
// element: far below the H100's ~20 f32 operations per byte.  Design: one
// 256-thread block per row; each thread holds 4 contiguous lanes, moved as
// one 16-byte load and store of the accumulator (neighbouring threads on
// neighbouring addresses) and one 4-, 2- or 1-byte load of payload.  The
// top-k body indexes its k kept lanes directly (one thread per kept
// entry) in a shared-memory copy of the row, instead of the TPU kernel's
// one-hot loop over all 1024 lanes.  No tiling or pipelining yet.
//
// Numerics follow the reference as XLA:CPU runs it under jit, bit for bit
// (built with -ftz=true -fmad=false; every rounding is an explicit _rn
// intrinsic): q * s is rounded, then acc + w * (q * s) and mag + w * s are
// one fused multiply-add; top-k adds the rounded w * (q * s) without an
// FMA and leaves the lanes it does not touch as they were; fixed point is
// rint(x * 2^bits) clipped to +-2147483520 before the cast; int32 adds
// wrap; denormals flush to a zero of the same sign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 1024;
constexpr int THREADS = 256;
constexpr int VEC = LANES / THREADS;  // 4 lanes per thread
constexpr float TINY = 1.17549435e-38f;  // smallest normal f32
constexpr float INT32_SAT = 2147483520.0f;

static_assert(VEC == 4, "row bodies assume 4 lanes per thread");

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < TINY ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ int32_t fixed_point(float x, float two_bits) {
  float y = rintf(__fmul_rn(ftz(x), two_bits));
  y = fminf(fmaxf(y, -INT32_SAT), INT32_SAT);
  return static_cast<int32_t>(y);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// ---- payload rows: 4 lanes of values per thread -------------------------
struct Int8Src {
  const int8_t* q;  // (rows, 1024)
  __device__ void load(int64_t row, float (&v)[VEC]) const {
    const char4 c = reinterpret_cast<const char4*>(q + row * LANES)
        [threadIdx.x];
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
  }
};

// offset-binary nibbles, the even column in the low nibble
struct Int4Src {
  const uint8_t* p;  // (rows, 512)
  __device__ void load(int64_t row, float (&v)[VEC]) const {
    const uchar2 u = reinterpret_cast<const uchar2*>(p + row * (LANES / 2))
        [threadIdx.x];
    v[0] = static_cast<float>(u.x & 0xF) - 8.0f;
    v[1] = static_cast<float>(u.x >> 4) - 8.0f;
    v[2] = static_cast<float>(u.y & 0xF) - 8.0f;
    v[3] = static_cast<float>(u.y >> 4) - 8.0f;
  }
};

// bit i of byte b is column 8b + i: a thread's 4 lanes are one nibble
__device__ __forceinline__ void load_signs(const uint8_t* p, int64_t row,
                                           int (&sg)[VEC]) {
  const unsigned byte = p[row * (LANES / 8) + (threadIdx.x >> 1)];
  const unsigned bits = byte >> ((threadIdx.x & 1) * 4);
#pragma unroll
  for (int j = 0; j < VEC; ++j) sg[j] = ((bits >> j) & 1u) ? 1 : -1;
}

// ---- K5 / K6: f32 dequant-accumulate ------------------------------------
template <class Src>
struct DequantF32 {
  const float* acc;
  Src src;
  const float* s;
  const float* w;
  float* out;
  __device__ void operator()(int64_t row) const {
    const float wv = ftz(*w);
    const float sv = ftz(s[row]);
    float q[VEC];
    src.load(row, q);
    const float4 a = reinterpret_cast<const float4*>(acc + row * LANES)
        [threadIdx.x];
    const float av[VEC] = {a.x, a.y, a.z, a.w};
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float qs = ftz(__fmul_rn(q[j], sv));
      o[j] = ftz(__fmaf_rn(wv, qs, ftz(av[j])));
    }
    reinterpret_cast<float4*>(out + row * LANES)[threadIdx.x] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
};

// ---- K9 / K10: int32 fixed-point dequant-accumulate ---------------------
template <class Src>
struct DequantFixed {
  const int32_t* acc;
  Src src;
  const float* s;
  const float* w;
  float two_bits;
  int32_t* out;
  __device__ void operator()(int64_t row) const {
    const float wv = ftz(*w);
    const float sv = ftz(s[row]);
    float q[VEC];
    src.load(row, q);
    const int4 a = reinterpret_cast<const int4*>(acc + row * LANES)
        [threadIdx.x];
    const int32_t av[VEC] = {a.x, a.y, a.z, a.w};
    int32_t o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float qs = ftz(__fmul_rn(q[j], sv));
      o[j] = wrap_add(av[j], fixed_point(__fmul_rn(wv, qs), two_bits));
    }
    reinterpret_cast<int4*>(out + row * LANES)[threadIdx.x] =
        make_int4(o[0], o[1], o[2], o[3]);
  }
};

// ---- K7: majority-vote partials in f32 ----------------------------------
struct SignF32 {
  const float* vote;
  const float* mag;
  const uint8_t* p;  // (rows, 128)
  const float* s;
  const float* w;
  float* vout;
  float* mout;
  __device__ void operator()(int64_t row) const {
    const float wv = ftz(*w);
    int sg[VEC];
    load_signs(p, row, sg);
    const float4 a = reinterpret_cast<const float4*>(vote + row * LANES)
        [threadIdx.x];
    const float av[VEC] = {a.x, a.y, a.z, a.w};
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = ftz(__fmaf_rn(wv, static_cast<float>(sg[j]), ftz(av[j])));
    reinterpret_cast<float4*>(vout + row * LANES)[threadIdx.x] =
        make_float4(o[0], o[1], o[2], o[3]);
    if (threadIdx.x == 0)
      mout[row] = ftz(__fmaf_rn(wv, ftz(s[row]), ftz(mag[row])));
  }
};

// ---- K11: integer vote counts and fixed-point magnitude -----------------
struct SignFixed {
  const int32_t* vote;
  const int32_t* mag;
  const uint8_t* p;
  const float* s;
  const float* w;
  float two_bits;
  int32_t* vout;
  int32_t* mout;
  __device__ void operator()(int64_t row) const {
    const float wv = ftz(*w);
    const int32_t wq = fixed_point(wv, two_bits);  // omega quantised once
    int sg[VEC];
    load_signs(p, row, sg);
    const int4 a = reinterpret_cast<const int4*>(vote + row * LANES)
        [threadIdx.x];
    const int32_t av[VEC] = {a.x, a.y, a.z, a.w};
    int32_t o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = wrap_add(av[j], sg[j] > 0 ? wq : -wq);
    reinterpret_cast<int4*>(vout + row * LANES)[threadIdx.x] =
        make_int4(o[0], o[1], o[2], o[3]);
    if (threadIdx.x == 0)
      mout[row] = wrap_add(
          mag[row], fixed_point(__fmul_rn(wv, ftz(s[row])), two_bits));
  }
};

// ---- K8: top-k scatter-accumulate ---------------------------------------
struct TopK {
  const float* acc;
  const int8_t* q;     // (rows, k)
  const uint16_t* idx; // (rows, k), distinct within a row
  const float* s;
  const float* w;
  int k;
  float* out;
  __device__ void operator()(int64_t row) const {
    __shared__ float4 srow[THREADS];
    float* lane = reinterpret_cast<float*>(srow);
    srow[threadIdx.x] =
        reinterpret_cast<const float4*>(acc + row * LANES)[threadIdx.x];
    __syncthreads();
    const float wv = ftz(*w);
    const float sv = ftz(s[row]);
    for (int j = threadIdx.x; j < k; j += THREADS) {
      const int64_t e = row * k + j;
      const int l = idx[e];  // uint16 widened here; < 65536
      if (l >= LANES) __trap();  // an index past the row
      const float v = ftz(__fmul_rn(static_cast<float>(q[e]), sv));
      const float term = ftz(__fmul_rn(wv, v));
      lane[l] = ftz(__fadd_rn(ftz(lane[l]), term));
    }
    __syncthreads();
    reinterpret_cast<float4*>(out + row * LANES)[threadIdx.x] =
        srow[threadIdx.x];
  }
};

template <class Body>
__global__ void __launch_bounds__(THREADS) decode_kernel(Body body) {
  body(static_cast<int64_t>(blockIdx.x));
}

template <class Body>
int launch(int rows, Body body, cudaStream_t stream) {
  if (rows <= 0) return 0;
  decode_kernel<Body><<<rows, THREADS, 0, stream>>>(body);
  return static_cast<int>(cudaGetLastError());
}

float two_pow(int bits) { return ldexpf(1.0f, bits); }

}  // namespace

// Plain C interface (bound with ctypes).  Every function returns the
// cudaError_t of its launch; the caller raises when it is not 0.
extern "C" {

int decode_accum_int8(const float* acc, const int8_t* q, const float* s,
                      const float* w, int rows, float* out,
                      cudaStream_t stream) {
  return launch(rows, DequantF32<Int8Src>{acc, {q}, s, w, out}, stream);
}

int decode_accum_int4(const float* acc, const uint8_t* p, const float* s,
                      const float* w, int rows, float* out,
                      cudaStream_t stream) {
  return launch(rows, DequantF32<Int4Src>{acc, {p}, s, w, out}, stream);
}

int sign_vote_accum(const float* vote, const float* mag, const uint8_t* p,
                    const float* s, const float* w, int rows, float* vout,
                    float* mout, cudaStream_t stream) {
  return launch(rows, SignF32{vote, mag, p, s, w, vout, mout}, stream);
}

int topk_scatter_accum(const float* acc, const int8_t* q,
                       const uint16_t* idx, const float* s, const float* w,
                       int rows, int k, float* out, cudaStream_t stream) {
  return launch(rows, TopK{acc, q, idx, s, w, k, out}, stream);
}

int decode_accum_int8_fp(const int32_t* acc, const int8_t* q,
                         const float* s, const float* w, int rows, int bits,
                         int32_t* out, cudaStream_t stream) {
  return launch(rows,
                DequantFixed<Int8Src>{acc, {q}, s, w, two_pow(bits), out},
                stream);
}

int decode_accum_int4_fp(const int32_t* acc, const uint8_t* p,
                         const float* s, const float* w, int rows, int bits,
                         int32_t* out, cudaStream_t stream) {
  return launch(rows,
                DequantFixed<Int4Src>{acc, {p}, s, w, two_pow(bits), out},
                stream);
}

int sign_vote_accum_fp(const int32_t* vote, const int32_t* mag,
                       const uint8_t* p, const float* s, const float* w,
                       int rows, int bits, int32_t* vout, int32_t* mout,
                       cudaStream_t stream) {
  return launch(rows,
                SignFixed{vote, mag, p, s, w, two_pow(bits), vout, mout},
                stream);
}

}  // extern "C"
