// Attention for the serving path: prefill (flash_attention_fwd) and
// single-token decode (decode_attention_fwd), CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` (the
// Pallas `_kernel`, pallas_call at :126) and `decode_attention` (:149).
// Semantics are those of repro_torch/kernels/ref.py::attention_ref: GQA
// (KV head = h / (Hq/Hkv)), tanh logit softcap before masking, causal
// `kpos <= q_offset[b] + qpos`, window `kpos > q_offset[b] + qpos - window`,
// `kpos < kv_len[b]`; a row with no valid key writes zeros.
//
// What bounds it on an H100: at granite-8b's prefill (B=4, S=512, Hq=32,
// Hkv=8, D=128, causal) the work is ~8.6 GFLOP against ~42 MB of q/k/v/o,
// so the bf16 tensor-core bound (~9 us) and the byte bound (~13 us) are
// close.  Decode reads the whole valid K/V cache once per step (~8.9 MB
// per layer at cache 544) and does ~2 FLOP per byte: it is bound by bytes.
//
// What the design does about it (first version: right and simple; wgmma,
// TMA and split-KV decode come later):
//  * prefill: one block per (64-row q tile, query head, batch).  The TPU's
//    sequential KV grid axis becomes a loop over 64-key tiles inside the
//    block, with the running (m, l, acc) in f32 registers.  KV tiles wholly
//    past the causal bound, before the window, or past kv_len are never
//    loaded.  Q/K/V tiles are staged in shared memory as f32 (16-byte
//    global loads, rows padded by 4 floats so the float4 reads are free of
//    bank conflicts); each of the 256 threads owns a 4x4 block of scores
//    and a 4 x (D/16) block of the output, all on FMA pipes.
//  * decode: one block per (batch, KV head) takes that head's g = Hq/Hkv
//    query heads together, so each K/V row is read from device memory once
//    for all g heads, looping over the cache only up to kv_len[b].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // prefill: query rows per block
constexpr int BK = 64;          // prefill: keys per tile
constexpr int NT = 256;         // prefill: threads per block (16 x 16)
constexpr int DK = 64;          // decode: keys per tile (two per lane)
constexpr int DNT = 128;        // decode: threads per block
constexpr int kMaxSmem = 232448;

// Load 16 bytes of T and widen to f32.
__device__ inline void load16(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ inline void load16(const float* p, float* out) {
  float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}

// Store 4 consecutive f32 values as T (8- or 16-byte aligned).
__device__ inline void store4(__nv_bfloat16* p, float a, float b, float c,
                              float d) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
}

__device__ inline void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Stage `rows` rows from row0 on of one head of a (B, S, H, D) tensor into
// shared memory as f32 times `mul`, row stride LD.  Rows at or past
// `nvalid` and columns at or past D are zero.  D is a multiple of 8, so a
// 16-byte chunk that starts below D ends at or below D.
template <typename T, int DP, int LD, int THREADS>
__device__ inline void load_tile(float* s, const T* base, int rows, int row0,
                                 int nvalid, long long row_stride, int D,
                                 float mul) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = DP / V;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * V;
    float vals[V];
    if (r < nvalid && c < D) {
      load16(base + (long long)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) s[r * LD + c + j] = vals[j] * mul;
  }
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ inline float comp(float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

template <int DP>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (DP + 4) +
                          (size_t)BQ * (BK + 4));
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          const int* __restrict__ kv_len, int kv_len_all,
          const int* __restrict__ q_off, int q_off_all, int Sq, int Skv,
          int Hq, int Hkv, int D, int causal, int has_window, int window,
          int has_softcap, float softcap, float scale) {
  constexpr int LD = DP + 4;
  constexpr int LDP = BK + 4;
  constexpr int CG = DP / 64;           // float4 output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int qoff = q_off ? q_off[b] : q_off_all;
  int kend = min(kv_len ? kv_len[b] : kv_len_all, Skv);
  if (causal) kend = min(kend, qoff + min(q0 + BQ, Sq));
  int kbeg = 0;
  if (has_window) kbeg = max(0, qoff + q0 - window + 1) / BK * BK;

  const long long qs = (long long)Hq * D;
  const long long ks = (long long)Hkv * D;
  const T* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const T* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  load_tile<T, DP, LD, NT>(sQ, q + (long long)b * Sq * qs + (long long)h * D,
                           BQ, q0, Sq - q0, qs, D, scale);

  float m[4], l[4], acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt0 = kbeg; kt0 < kend; kt0 += BK) {
    __syncthreads();
    load_tile<T, DP, LD, NT>(sK, kb, BK, kt0, kend - kt0, ks, D, 1.f);
    load_tile<T, DP, LD, NT>(sV, vb, BK, kt0, kend - kt0, ks, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qoff + q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt0 + tx + 16 * j;
        float x = s[i][j];
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        bool ok = kp < kend;
        if (causal) ok = ok && kp <= qp;
        if (has_window) ok = ok && kp > qp - window;
        s[i][j] = ok ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mnew = fmaxf(m[i], rmax);
      float alpha = 1.f, rsum = 0.f;
      if (mnew != -INFINITY) {
        alpha = expf(m[i] - mnew);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mnew);
          rsum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(kk + u) * LD + cg * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], u);
            acc[i][cg * 4 + 0] = fmaf(p, vv.x, acc[i][cg * 4 + 0]);
            acc[i][cg * 4 + 1] = fmaf(p, vv.y, acc[i][cg * 4 + 1]);
            acc[i][cg * 4 + 2] = fmaf(p, vv.z, acc[i][cg * 4 + 2]);
            acc[i][cg * 4 + 3] = fmaf(p, vv.w, acc[i][cg * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + ((long long)b * Sq + qi) * qs + (long long)h * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c = cg * 64 + tx * 4;
      if (c < D)
        store4(orow + c, acc[i][cg * 4] * inv, acc[i][cg * 4 + 1] * inv,
               acc[i][cg * 4 + 2] * inv, acc[i][cg * 4 + 3] * inv);
    }
  }
}

template <int DP>
size_t decode_smem_bytes(int g) {
  return sizeof(float) * ((size_t)g * (DP + 4) + 2 * (size_t)DK * (DP + 4) +
                          (size_t)g * DK + (size_t)g * DP + 3 * (size_t)g);
}

template <typename T, int DP>
__global__ void __launch_bounds__(DNT)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           const int* __restrict__ kv_len, int kv_len_all,
           const int* __restrict__ q_off, int q_off_all, int Skv, int Hq,
           int Hkv, int D, int causal, int has_window, int window,
           int has_softcap, float softcap, float scale) {
  constexpr int LD = DP + 4;
  const int g = Hq / Hkv;
  extern __shared__ float smem[];
  float* sQ = smem;                    // g x LD
  float* sK = sQ + g * LD;             // DK x LD
  float* sV = sK + DK * LD;            // DK x LD
  float* sS = sV + DK * LD;            // g x DK
  float* sAcc = sS + g * DK;           // g x DP
  float* sM = sAcc + g * DP;           // g
  float* sL = sM + g;                  // g
  float* sAlpha = sL + g;              // g

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int qp = q_off ? q_off[b] : q_off_all;
  int kend = min(kv_len ? kv_len[b] : kv_len_all, Skv);
  if (causal) kend = min(kend, qp + 1);
  int kbeg = 0;
  if (has_window) kbeg = max(0, qp - window + 1);

  const long long ks = (long long)Hkv * D;
  const T* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const T* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  // the g query heads of this KV head are consecutive rows of length D
  load_tile<T, DP, LD, DNT>(sQ, q + ((long long)b * Hq + (long long)hk * g) * D,
                            g, 0, g, D, D, scale);
  for (int i = threadIdx.x; i < g * DP; i += DNT) sAcc[i] = 0.f;
  for (int r = threadIdx.x; r < g; r += DNT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  for (int kt0 = kbeg; kt0 < kend; kt0 += DK) {
    __syncthreads();
    load_tile<T, DP, LD, DNT>(sK, kb, DK, kt0, kend - kt0, ks, D, 1.f);
    load_tile<T, DP, LD, DNT>(sV, vb, DK, kt0, kend - kt0, ks, D, 1.f);
    __syncthreads();

    for (int i = threadIdx.x; i < g * DK; i += DNT) {
      const int r = i / DK;
      const int j = i % DK;
      const int kp = kt0 + j;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; d += 4)
        x = dot4(*reinterpret_cast<const float4*>(&sQ[r * LD + d]),
                 *reinterpret_cast<const float4*>(&sK[j * LD + d]), x);
      if (has_softcap) x = tanhf(x / softcap) * softcap;
      bool ok = kp < kend;
      if (has_window) ok = ok && kp > qp - window;
      sS[i] = ok ? x : -INFINITY;
    }
    __syncthreads();

    for (int r = warp; r < g; r += DNT / 32) {
      float a = sS[r * DK + lane];
      float c = sS[r * DK + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mprev = sM[r];
      const float mnew = fmaxf(mprev, mx);
      float alpha = 1.f;
      if (mnew != -INFINITY) {
        alpha = expf(mprev - mnew);
        a = a == -INFINITY ? 0.f : expf(a - mnew);
        c = c == -INFINITY ? 0.f : expf(c - mnew);
      } else {
        a = 0.f;
        c = 0.f;
      }
      sS[r * DK + lane] = a;
      sS[r * DK + lane + 32] = c;
      float sum = a + c;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = mnew;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < g * DP; i += DNT) {
      const int r = i / DP;
      const int d = i % DP;
      float a = sAcc[i] * sAlpha[r];
#pragma unroll 8
      for (int j = 0; j < DK; ++j) a = fmaf(sS[r * DK + j], sV[j * LD + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < g * (D / 4); i += DNT) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    const float inv = sL[r] > 0.f ? 1.f / sL[r] : 0.f;
    const float* a = sAcc + r * DP + c;
    store4(o + ((long long)b * Hq + (long long)hk * g + r) * D + c,
           a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
  }
}

template <typename T, int DP>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const int* kv_len, int kv_len_all, const int* q_off,
                 int q_off_all, int B, int Sq, int Skv, int Hq, int Hkv,
                 int D, int causal, int has_window, int window,
                 int has_softcap, float softcap, float scale,
                 cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = flash_smem_bytes<DP>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len, kv_len_all,
      q_off, q_off_all, Sq, Skv, Hq, Hkv, D, causal, has_window, window,
      has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  const int* kv_len, int kv_len_all, const int* q_off,
                  int q_off_all, int B, int Skv, int Hq, int Hkv, int D,
                  int causal, int has_window, int window, int has_softcap,
                  float softcap, float scale, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = decode_smem_bytes<DP>(Hq / Hkv);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(Hkv, B);
  decode_fwd<T, DP><<<grid, DNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len, kv_len_all,
      q_off, q_off_all, Skv, Hq, Hkv, D, causal, has_window, window,
      has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  kv_len / q_offset: a (B,) int32
// device pointer, or null to use the scalar beside it.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    int kv_len_all, const int* q_off, int q_off_all, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, int dtype, int causal, int has_window, int window,
    int has_softcap, float softcap, float scale, void* stream) {
  if (D % 8 != 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                       \
  q, k, v, o, kv_len, kv_len_all, q_off, q_off_all, B, Sq, Skv, Hq, Hkv, D, \
      causal, has_window, window, has_softcap, softcap, scale, s
  if (dtype == 0) {
    if (D <= 64) return launch_flash<__nv_bfloat16, 64>(FLASH_ARGS);
    if (D <= 128) return launch_flash<__nv_bfloat16, 128>(FLASH_ARGS);
    return launch_flash<__nv_bfloat16, 256>(FLASH_ARGS);
  }
  if (dtype == 1) {
    if (D <= 64) return launch_flash<float, 64>(FLASH_ARGS);
    if (D <= 128) return launch_flash<float, 128>(FLASH_ARGS);
    return launch_flash<float, 256>(FLASH_ARGS);
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// q: (B, 1, Hq, D); k, v: (B, Skv, Hkv, D).  Same conventions as above.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    int kv_len_all, const int* q_off, int q_off_all, int B, int Skv, int Hq,
    int Hkv, int D, int dtype, int causal, int has_window, int window,
    int has_softcap, float softcap, float scale, void* stream) {
  if (D % 8 != 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS                                                       \
  q, k, v, o, kv_len, kv_len_all, q_off, q_off_all, B, Skv, Hq, Hkv, D,     \
      causal, has_window, window, has_softcap, softcap, scale, s
  if (dtype == 0) {
    if (D <= 64) return launch_decode<__nv_bfloat16, 64>(DECODE_ARGS);
    if (D <= 128) return launch_decode<__nv_bfloat16, 128>(DECODE_ARGS);
    return launch_decode<__nv_bfloat16, 256>(DECODE_ARGS);
  }
  if (dtype == 1) {
    if (D <= 64) return launch_decode<float, 64>(DECODE_ARGS);
    if (D <= 128) return launch_decode<float, 128>(DECODE_ARGS);
    return launch_decode<float, 256>(DECODE_ARGS);
  }
#undef DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}
